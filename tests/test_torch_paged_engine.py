"""PyTorch port, paged and int8 KV below the scheduler, against the JAX
package on the CPU: the decoder's ``forward`` over paged (f32, bf16, int8)
and dense int8 caches; EngineCore greedy tokens against the JAX core with
its Pallas paged kernels in interpret mode; and the host block allocator —
worst-case reservation, on-demand growth, starvation, preemption — call for
call against the JAX core. Same numpy weights on both sides."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tts_inference_tpu import protocol as P
from tts_inference_tpu.config import (EngineConfig, ModelConfig,
                                      SamplingConfig, tiny_config)
from tts_inference_tpu.engine.engine import EngineCore as JCore
from tts_inference_tpu.models import llama as jl
from tts_inference_tpu.ops import sampling as jS
from tts_inference_tpu_torch import weights as W
from tts_inference_tpu_torch.engine.engine import EngineCore as TCore
from tts_inference_tpu_torch.models import llama as tl
from tts_inference_tpu_torch.ops import sampling as tS
from tts_inference_tpu_torch.utils import to_numpy

from tests.torch_port_helpers import (AUDIO_RANGE, numpy_llama_tree,
                                      port_config, to_jax)

TINY_LM = ModelConfig.tiny(vocab_size=512)
BLOCK = 16


# -- model level -----------------------------------------------------------------


def _caches(mode, cfg, batch, max_seq):
    """(JAX cache, port cache) of one kind; paged tables interleaved."""
    if mode == "dense_int8":
        return (jl.init_kv_cache(cfg, batch, max_seq, int8=True),
                tl.init_kv_cache(port_config(cfg), batch, max_seq, int8=True))
    int8 = mode == "paged_int8"
    table = np.array([[3, 7, 1, 9], [2, 10, 5, 4]], np.int32)
    jc = jl.init_paged_kv_cache(cfg, batch, max_seq, num_blocks=12,
                                block_size=BLOCK, int8=int8)
    tc = tl.init_paged_kv_cache(port_config(cfg), batch, max_seq,
                                num_blocks=12, block_size=BLOCK, int8=int8)
    tc.block_table.copy_(torch.from_numpy(table))
    return jc._replace(block_table=jnp.asarray(table)), tc


def _assert_caches_match(jc, tc, paged, tol):
    # paged: row 0 is the trash block (duplicate writes, any survivor)
    rows = slice(1, None) if paged else slice(None)
    for name in ("k", "v", "k_scale", "v_scale"):
        for j, t in zip(getattr(jc, name), getattr(tc, name)):
            got, want = t.float().numpy()[rows], np.asarray(
                j, np.float32)[rows]
            if t.dtype == torch.int8:
                # one-level flips where x/scale lands on .5 between the two
                # frameworks' f32 matmuls; none expected at this size
                assert np.abs(got - want).max() <= 1
                assert (got == want).mean() >= 0.999
            else:
                np.testing.assert_allclose(got, want, atol=tol["atol"],
                                           rtol=max(tol["rtol"], 1e-5))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


@pytest.mark.parametrize("mode,dtype", [("paged", "float32"),
                                        ("paged", "bfloat16"),
                                        ("paged_int8", "float32"),
                                        ("dense_int8", "float32")])
def test_forward_prefill_and_decode_match_jax(mode, dtype):
    cfg = dataclasses.replace(TINY_LM, dtype=dtype)
    tree = numpy_llama_tree(cfg, seed=4)
    jp = to_jax(tree)
    if dtype == "bfloat16":
        jp = {k: (v.astype(jnp.bfloat16) if k != "layers" else
                  [{kk: vv.astype(jnp.bfloat16) for kk, vv in lyr.items()}
                   for lyr in v]) for k, v in jp.items()}
    tp = W.llama_params_from_jax(jp)
    # f32: 1e-5; bf16: one or two bf16 roundings apart (hidden |x| ~ 3)
    tol = (dict(atol=1e-5, rtol=0) if dtype == "float32"
           else dict(atol=2e-2, rtol=2e-2))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    jc, tc = _caches(mode, cfg, 2, 64)
    zero = np.zeros(2, np.int32)
    jh, jc = jl.forward(jp, cfg, jnp.asarray(toks), jc, jnp.asarray(zero),
                        jnp.asarray(lens), kv_window=16)
    th, tc = tl.forward(tp, port_config(cfg), torch.from_numpy(toks), tc,
                        torch.from_numpy(zero), torch.from_numpy(lens),
                        kv_window=16)
    np.testing.assert_allclose(th.float().numpy()[0],
                               np.asarray(jh, np.float32)[0], **tol)
    np.testing.assert_allclose(th.float().numpy()[1, :9],
                               np.asarray(jh, np.float32)[1, :9], **tol)
    tok = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
    for step in range(3):
        # slot 1 is frozen on the last step: its write goes to the trash
        seg = np.array([1, int(step < 2)], np.int32)
        wp = np.asarray(jc.lengths)
        jh, jc = jl.forward(jp, cfg, jnp.asarray(tok[:, None]), jc,
                            jnp.asarray(wp), jnp.asarray(seg), kv_window=32)
        th, tc = tl.forward(tp, port_config(cfg),
                            torch.from_numpy(tok[:, None]), tc,
                            tc.lengths.clone(), torch.from_numpy(seg),
                            kv_window=32)
        np.testing.assert_allclose(th.float().numpy(),
                                   np.asarray(jh, np.float32), **tol)
        tok = (tok * 7 + 3) % cfg.vocab_size
    _assert_caches_match(jc, tc, mode != "dense_int8", tol)
    assert tc.lengths.tolist() == [19, 11]


def test_paged_int4_is_not_ported():
    """The name dates from before int4 pools were ported. What stays rejected:
    int8 and int4 together, and an odd kv-head count (heads pack in pairs);
    an int4 pool itself is built (tests/test_torch_int4_kv.py holds it to the
    JAX package)."""
    with pytest.raises(ValueError, match="mutually exclusive"):
        tl.init_paged_kv_cache(port_config(TINY_LM), 2, 64, num_blocks=4,
                               block_size=BLOCK, int8=True, int4=True)
    with pytest.raises(ValueError, match="even kv-head count"):
        tl.init_paged_kv_cache(
            port_config(dataclasses.replace(TINY_LM, num_key_value_heads=1)),
            2, 64,
            num_blocks=4, block_size=BLOCK, int4=True)
    cache = tl.init_paged_kv_cache(port_config(TINY_LM), 2, 64, num_blocks=4,
                                   block_size=BLOCK, int4=True)
    assert cache.int4 and cache.k[0].shape == (4, 1, BLOCK, 16)


# -- engine level: the JAX core runs its Pallas kernels in interpret mode ------


KCFG = ModelConfig(
    vocab_size=512, hidden_size=128, intermediate_size=256,
    num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
    head_dim=128, rope_scaling_factor=None, max_position_embeddings=512,
    dtype="float32")
KENG = EngineConfig(
    max_batch_size=2, max_input_len=32, max_output_len=96,
    prefill_buckets=(16,), kv_buckets=(32, 64), decode_steps_per_call=3,
    paged_kv=True, kv_block_size=BLOCK)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_core_matches_jax_kernels(int8):
    ecfg = dataclasses.replace(KENG, kv_cache_int8=int8)
    tree = numpy_llama_tree(KCFG, seed=0)
    prompts = [[7, 8, 9, 10], [13, 14]]
    sp = SamplingConfig(greedy=True)

    def run(core, params_mod):
        spar = params_mod.SamplingParams.from_config(sp, 2)
        t0, tok, act = core.prefill_decode_launch(
            prompts, [0, 1], spar, np.zeros(2, np.int32), np.zeros(2, bool),
            n=3, reserve_extra=[24, 24])
        t1, _, _ = core.decode_steps_launch(spar, tok, act)
        return np.concatenate([np.asarray(to_numpy(t0)),
                               np.asarray(to_numpy(t1))], axis=1)

    with pltpu.force_tpu_interpret_mode():
        want = run(JCore(to_jax(tree), dataclasses.replace(
            KCFG, use_pallas_attention=True), ecfg, eos_id=511), jS)
    got = run(TCore(W.llama_params_from_jax(tree), port_config(KCFG),
                  port_config(ecfg), eos_id=511),
              tS)
    np.testing.assert_array_equal(got, want)


# -- the host block allocator, call for call --------------------------------------


SMALL = EngineConfig(
    max_batch_size=4, max_input_len=32, max_output_len=96,
    prefill_buckets=(8, 16, 32), kv_buckets=(32, 64),
    decode_steps_per_call=4, paged_kv=True, kv_block_size=BLOCK)


@pytest.fixture(scope="module")
def tiny_trees():
    tree = numpy_llama_tree(TINY_LM, seed=0)
    return to_jax(tree), W.llama_params_from_jax(tree)


def _pair(trees, cfg, ecfg):
    jp, tp = trees
    return (JCore(jp, cfg, ecfg, eos_id=5),
            TCore(tp, port_config(cfg), port_config(ecfg), eos_id=5))


def _same_allocator(jc, tc):
    assert tc._slot_blocks == jc._slot_blocks
    assert tc._free_blocks == jc._free_blocks
    np.testing.assert_array_equal(tc._table_host, jc._table_host)
    np.testing.assert_array_equal(tc.cache.block_table.numpy(),
                                  tc._table_host)
    assert tc.free_tokens() == jc.free_tokens()


def _sps(jc, tc, greedy=True, **kw):
    sc = SamplingConfig(greedy=greedy, token_range=AUDIO_RANGE, **kw)
    return (jS.SamplingParams.from_config(sc, jc.batch),
            tS.SamplingParams.from_config(port_config(sc), tc.batch))


def test_allocator_reserve_free_cycle_matches_jax(tiny_trees):
    jc, tc = _pair(tiny_trees, TINY_LM, SMALL)
    table_ptr = tc.cache.block_table.data_ptr()
    total = tc.free_tokens()
    assert total == jc.free_tokens() == (tc.cache.num_blocks - 1) * BLOCK
    jsp, tsp = _sps(jc, tc)
    for core, sp in ((jc, jsp), (tc, tsp)):
        core.prefill_slots([[7, 8, 9]], [0], sp, reserve_extra=[20])
        core.prefill_slots([[7, 8, 9, 10, 11, 12, 13, 14, 15]], [2], sp,
                           reserve_extra=[40])
    _same_allocator(jc, tc)
    # bucket 8 + 20 + slack 5 = 33 → 3 blocks; bucket 16 + 40 + 5 → 4
    assert tc.free_tokens() == total - 7 * BLOCK
    for core in (jc, tc):
        core.reset_and_seed([0])
    _same_allocator(jc, tc)
    assert tc.kv_demand(3, 20) == jc.kv_demand(3, 20) == 48
    # every table change is pushed into the same device tensor, in place
    assert tc.cache.block_table.data_ptr() == table_ptr


def test_pool_exhaustion_raises_like_jax(tiny_trees):
    small = dataclasses.replace(SMALL, kv_pool_tokens=64)   # 4 blocks + trash
    jc, tc = _pair(tiny_trees, TINY_LM, small)
    jsp, tsp = _sps(jc, tc)
    for core, sp in ((jc, jsp), (tc, tsp)):
        core.prefill_slots([[7, 8, 9]], [0], sp, reserve_extra=[40])
        with pytest.raises(RuntimeError, match="KV pool exhausted"):
            core.prefill_slots([[7, 8, 9]], [1], sp, reserve_extra=[40])
    assert tc.cache.max_seq == small.max_seq_len


def _on_demand(pool_tokens):
    cfg = tiny_config()
    return cfg.model, dataclasses.replace(
        cfg.engine, paged_kv=True, kv_on_demand=True, kv_block_size=32,
        kv_pool_tokens=pool_tokens, resume_buckets=(128, 256))


@pytest.fixture(scope="module")
def full_vocab_trees():
    tree = numpy_llama_tree(tiny_config().model, seed=0)
    return to_jax(tree), W.llama_params_from_jax(tree)


def test_on_demand_growth_starvation_preempt_match_jax(full_vocab_trees):
    """Admission reserves the prefill window only; blocks grow per decode
    launch until the next launch cannot be covered; the grow error and
    preempt_slot follow — the same allocator state as JAX at every step."""
    mcfg, ecfg = _on_demand(4 * 32)                         # 4 real blocks
    jc, tc = _pair(full_vocab_trees, mcfg, ecfg)
    jsp, tsp = _sps(jc, tc)
    prompt = [[P.TOKEN_SOS, 5, 6]]
    jtok = jc.prefill_slots(prompt, [0], jsp)
    ttok = tc.prefill_slots(prompt, [0], tsp)
    _same_allocator(jc, tc)
    assert len(tc._slot_blocks[0]) * 32 < ecfg.max_output_len
    act = np.zeros(tc.batch, bool)
    act[0] = True
    jl_, ja, tl_, ta = np.asarray(jtok), act, ttok, act
    grown = False
    for _ in range(40):
        assert tc.starved_slots(8) == jc.starved_slots(8)
        if tc.starved_slots(8):
            break
        blocks0 = len(tc._slot_blocks[0])
        _, jl_, ja = jc.decode_steps(jsp, jl_, ja, n=8)
        _, tl_, ta = (to_numpy(x) for x in tc.decode_steps_launch(
            tsp, tl_, ta, n=8))
        _same_allocator(jc, tc)
        grown |= len(tc._slot_blocks[0]) > blocks0
    assert grown and tc.starved_slots(8) == [0]
    for core in (jc, tc):
        with pytest.raises(RuntimeError, match="KV pool exhausted"):
            core._grow_blocks(8)
        core.preempt_slot(0)
        assert core.starved_slots(8) == [] and 0 not in core._slot_blocks
    _same_allocator(jc, tc)


def test_snapshot_restore_continues_exactly(full_vocab_trees):
    """A slot's sampling state survives snapshot → clobber → restore: the
    stochastic tokens that follow equal those of an untouched core."""
    mcfg, ecfg = _on_demand(320 * 4)
    _, tp = full_vocab_trees
    cores = [TCore(tp, port_config(mcfg), port_config(ecfg))
             for _ in range(2)]
    sp = tS.SamplingParams.from_config(port_config(SamplingConfig(
        token_range=AUDIO_RANGE, repetition_penalty=1.3)), cores[0].batch)
    outs = []
    for i, core in enumerate(cores):
        tok = core.prefill_slots([[P.TOKEN_SOS, 5, 6]], [0], sp, seeds=[7])
        act = np.zeros(core.batch, bool)
        act[0] = True
        _, lt, act = core.decode_steps_launch(sp, tok, act, n=8)
        if i:
            snap = core.snapshot_slot(0)
            assert snap["presence"].any() and snap["step"] == 9
            # clobber the whole chain, then restore it
            core.sampling_state = tS.init_sampling_state(
                core.batch, mcfg.vocab_size, seed=999)
            core.restore_slot(0, snap)
            assert core.snapshot_slot(0)["seed"] == snap["seed"]
        outs.append(to_numpy(core.decode_steps_launch(sp, lt, act,
                                                      n=8)[0])[0])
    np.testing.assert_array_equal(outs[0], outs[1])


def test_warmup_leaves_the_pool_free(tiny_trees):
    _, tp = tiny_trees
    core = TCore(tp, port_config(TINY_LM), port_config(SMALL), eos_id=5)
    core.warmup_graphs()
    assert core.free_tokens() == (core.cache.num_blocks - 1) * BLOCK
    assert not core._slot_blocks and not core._table_host.any()
