"""The port's int4 KV pools (``ops/paged_attention_int4.py``, the int4 paths of
``models/llama.py`` and ``engine/engine.py``) against the JAX package on the
CPU: packing and scale planes byte for byte, the plain version of K5 against
the JAX kernel (Pallas interpret mode) and its twin, ``forward`` over a paged
int4 cache, and the engine's greedy tokens with int4 weights and int4 KV.
Inputs come from numpy seeds."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tts_inference_tpu.config import EngineConfig, ModelConfig, SamplingConfig
from tts_inference_tpu.engine.engine import EngineCore as JCore
from tts_inference_tpu.models import llama as jl
from tts_inference_tpu.models import quant as jq
from tts_inference_tpu.ops import sampling as jS
from tts_inference_tpu.ops.pallas import paged_attention as jpa
from tts_inference_tpu.ops.pallas import paged_attention_int4 as jp4
from tts_inference_tpu_torch import weights as W
from tts_inference_tpu_torch.engine.engine import EngineCore as TCore
from tts_inference_tpu_torch.models import llama as tl
from tts_inference_tpu_torch.ops import paged_attention_int4 as tp4
from tts_inference_tpu_torch.ops import sampling as tS
from tts_inference_tpu_torch.utils import to_numpy

from tests.torch_port_helpers import numpy_llama_tree, port_config, to_jax

TINY_LM = ModelConfig.tiny(vocab_size=512)
BLOCK = 16


# -- packing ---------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 2, 16), (3, 5, 8, 128), (1, 6, 32)])
def test_pack_unpack_kv_bytes_equal_jax(shape):
    q = np.random.default_rng(0).integers(-7, 8, size=shape).astype(np.int32)
    packed = tp4.pack_kv_int4(torch.from_numpy(q))
    assert packed.dtype == torch.int8
    assert packed.shape == (*shape[:-2], shape[-2] // 2, shape[-1])
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jp4.pack_kv_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(tp4.unpack_kv_int4(packed).numpy(), q)
    with pytest.raises(ValueError, match="even"):
        tp4.pack_kv_int4(torch.zeros(2, 3, 8, dtype=torch.int32))


def test_scale_planes_equal_jax():
    s = np.random.default_rng(5).uniform(size=(3, 7, 8)).astype(np.float32)
    planes = tp4.scales_to_planes(torch.from_numpy(s))
    assert planes.shape == (3, 7, 2, 4)
    np.testing.assert_array_equal(
        planes.numpy(), np.asarray(jp4.scales_to_planes(jnp.asarray(s))))
    # plane 0 = low heads (2p), plane 1 = high heads (2p+1): plane-major
    np.testing.assert_array_equal(planes[..., 0, 1].numpy(), s[..., 2])
    np.testing.assert_array_equal(planes[..., 1, 3].numpy(), s[..., 7])
    np.testing.assert_array_equal(tp4.planes_to_scales(planes).numpy(), s)


@pytest.mark.parametrize("shape", [(2, 3, 4, 32), (5, 8, 128)])
def test_quantize_kv_int4_matches_jax(shape):
    """Packed bytes and scales of both quantizers; an element may land one
    step apart where ``x / scale`` sits on a rounding tie (none expected),
    and the error stays within half a step."""
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    gp, gs = tp4.quantize_kv_int4(torch.from_numpy(x))
    wp, ws = jp4.quantize_kv_int4(jnp.asarray(x))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    got = tp4.unpack_kv_int4(gp).numpy()
    want = np.asarray(jp4.unpack_kv_int4(wp, shape[-2]))
    assert np.abs(got - want).max() <= 1
    assert (got != want).sum() <= 1e-4 * got.size
    err = np.abs(got * gs.numpy()[..., None] - x)
    assert (err <= gs.numpy()[..., None] / 2 + 1e-6).all()


# -- K5: the plain version against the JAX kernel and its twin --------------------


def _pools(rng, n_blocks, bs, hkv, d):
    """Random K/V quantized by the JAX package into its storage layouts:
    packed pair-batched (N, P2, bs, D), nibble-plane scales (N, 2, P2, bs)."""
    out = []
    for _ in range(2):
        x = rng.normal(size=(n_blocks, bs, hkv, d)).astype(np.float32)
        p, s = jp4.quantize_kv_int4(jnp.asarray(x))
        out += [jnp.moveaxis(p, 1, 2),
                jnp.moveaxis(jp4.scales_to_planes(s), 1, 3)]
    kp, ks, vp, vs = out
    return kp, vp, ks, vs


def _torch(*arrays):
    return [W.tensor_from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_attention_matches_jax_kernel_and_twin(dtype):
    """f32: 2e-4 against the kernel in interpret mode (the JAX test's own
    bound; another summation order), 1e-5 against the twin. bf16 queries:
    one bf16 step of an output below 4 (2e-2)."""
    rng = np.random.default_rng(2)
    b, hkv, g, d, bs, wb, nblk = 2, 2, 3, 128, 16, 3, 8
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q = jnp.asarray(rng.normal(size=(b, hkv, g, d)).astype(np.float32), jdt)
    pools = _pools(rng, nblk, bs, hkv, d)
    table = jnp.asarray(rng.integers(1, nblk, size=(b, wb)).astype(np.int32))
    pos = jnp.asarray(np.array([37, 12], np.int32))
    kern = np.asarray(jp4.paged_decode_attention_int4(
        q, *pools, table, pos, interpret=True), np.float32)
    twin = np.asarray(jp4.paged_decode_attention_int4_reference(
        q, *pools, table, pos), np.float32)
    args = _torch(q, *pools, table, pos)
    got = tp4.paged_decode_attention_int4(*args)    # CPU: the plain version
    assert got.dtype == args[0].dtype and got.shape == (b, hkv, g, d)
    assert torch.equal(got,
                       tp4.paged_decode_attention_int4_reference(*args))
    tol = (dict(atol=2e-2, rtol=0) if dtype == "bfloat16"
           else dict(atol=1e-5, rtol=1e-5))
    np.testing.assert_allclose(got.float().numpy(), twin, **tol)
    ktol = (dict(atol=2e-2, rtol=0) if dtype == "bfloat16"
            else dict(atol=2e-4, rtol=2e-4))
    np.testing.assert_allclose(got.float().numpy(), kern, **ktol)


def test_int4_attention_multi_block_tail(monkeypatch):
    """The JAX kernel with two pool blocks per grid step over a window of
    five blocks (a clamped tail), four kv heads (two pairs), a table with
    zero entries past the shorter slot's last block: the port's plain
    version agrees with it and with the twin."""
    monkeypatch.setattr(jpa, "MAX_BLOCKS_PER_STEP", 2)
    rng = np.random.default_rng(13)
    b, hkv, g, d, bs, wb = 2, 4, 3, 128, 16, 5
    n = wb * b + 1
    q = jnp.asarray(rng.normal(size=(b, hkv, g, d)), jnp.float32)
    pools = _pools(rng, n, bs, hkv, d)
    table = rng.permutation(np.arange(1, n)).reshape(b, wb).astype(np.int32)
    pos = np.array([wb * bs - 1, wb * bs // 3], np.int32)
    table[1, pos[1] // bs + 1:] = 0        # unallocated: never read
    table, pos = jnp.asarray(table), jnp.asarray(pos)
    want = np.asarray(jp4.paged_decode_attention_int4(
        q, *pools, table, pos, interpret=True))
    twin = np.asarray(jp4.paged_decode_attention_int4_reference(
        q, *pools, table, pos))
    got = tp4.paged_decode_attention_int4(*_torch(q, *pools, table, pos))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got.numpy(), twin, atol=1e-5, rtol=1e-5)


def test_int4_attention_checks():
    q = torch.zeros(2, 4, 3, 16)
    kp = torch.zeros(5, 2, 16, 16, dtype=torch.int8)
    ks = torch.zeros(5, 2, 2, 16)
    table = torch.zeros(2, 2, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    assert tp4.paged_decode_attention_int4(q, kp, kp, ks, ks, table,
                                           pos).shape == q.shape
    with pytest.raises(ValueError, match="scale pools"):   # head-interleaved
        tp4.paged_decode_attention_int4(q, kp, kp, ks.reshape(5, 4, 16),
                                        ks.reshape(5, 4, 16), table, pos)
    with pytest.raises(ValueError, match="vs pools"):      # unpacked pools
        tp4.paged_decode_attention_int4(
            q, torch.zeros(5, 4, 16, 16, dtype=torch.int8),
            torch.zeros(5, 4, 16, 16, dtype=torch.int8), ks, ks, table, pos)
    with pytest.raises(ValueError, match="even"):
        tp4.paged_decode_attention_int4(q[:, :3], kp, kp, ks, ks, table, pos)
    with pytest.raises(TypeError, match="pools"):
        tp4.paged_decode_attention_int4(q, kp.float(), kp.float(), ks, ks,
                                        table, pos)


# -- the model -----------------------------------------------------------------------


def test_init_paged_int4_cache_shapes_and_rejections():
    cfg = port_config(TINY_LM)
    c = tl.init_paged_kv_cache(cfg, 2, 64, num_blocks=5, block_size=BLOCK,
                               int4=True)
    j = jl.init_paged_kv_cache(TINY_LM, 2, 64, num_blocks=5,
                               block_size=BLOCK, int4=True)
    assert c.int4 and c.quantized and c.block_size == BLOCK
    assert c.num_blocks == 5 and c.max_seq == 64
    for name in ("k", "v", "k_scale", "v_scale"):
        got, want = getattr(c, name), getattr(j, name)
        assert len(got) == len(want) == cfg.num_hidden_layers
        assert tuple(got[0].shape) == tuple(want[0].shape)
    assert c.k[0].dtype == torch.int8 and c.k_scale[0].dtype == torch.float32
    assert not tl.init_paged_kv_cache(cfg, 2, 64, num_blocks=5,
                                      block_size=BLOCK, int8=True).int4
    with pytest.raises(ValueError, match="mutually exclusive"):
        tl.init_paged_kv_cache(cfg, 2, 64, num_blocks=5, block_size=BLOCK,
                               int8=True, int4=True)
    odd = dataclasses.replace(cfg, num_key_value_heads=1)
    with pytest.raises(ValueError, match="even kv-head count"):
        tl.init_paged_kv_cache(odd, 2, 64, num_blocks=5, block_size=BLOCK,
                               int4=True)


@pytest.mark.parametrize("quant_bits", [None, 4])
def test_forward_paged_int4_matches_jax(quant_bits):
    """Prefill and three decode steps of the tiny f32 model over a paged
    int4 cache (and, with quant_bits, int4 weights carried across): hidden
    states within 1e-5 (2e-5 with quantized weights), pools equal up to
    one-step flips on rounding ties (none expected), scale pools equal to
    1e-6. Slot 1 is frozen on the last step: its write goes to the trash
    block."""
    cfg, tcfg = TINY_LM, port_config(TINY_LM)
    jp = to_jax(numpy_llama_tree(cfg, seed=4))
    if quant_bits:
        jp = jq.quantize_llama_params(jp, bits=quant_bits)
    tp = W.llama_params_from_jax(jp)
    atol = 2e-5 if quant_bits else 1e-5
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    table = np.array([[3, 7, 1, 9], [2, 10, 5, 4]], np.int32)
    jc = jl.init_paged_kv_cache(cfg, 2, 64, num_blocks=12, block_size=BLOCK,
                                int4=True)._replace(
                                    block_table=jnp.asarray(table))
    tc = tl.init_paged_kv_cache(tcfg, 2, 64, num_blocks=12, block_size=BLOCK,
                                int4=True)
    tc.block_table.copy_(torch.from_numpy(table))
    zero = np.zeros(2, np.int32)
    jh, jc = jl.forward(jp, cfg, jnp.asarray(toks), jc, jnp.asarray(zero),
                        jnp.asarray(lens), kv_window=16)
    th, tc = tl.forward(tp, tcfg, torch.from_numpy(toks), tc,
                        torch.from_numpy(zero), torch.from_numpy(lens),
                        kv_window=16)
    np.testing.assert_allclose(th.numpy()[0], np.asarray(jh)[0], atol=atol)
    np.testing.assert_allclose(th.numpy()[1, :9], np.asarray(jh)[1, :9],
                               atol=atol)
    tok = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
    for step in range(3):
        seg = np.array([1, int(step < 2)], np.int32)
        wp = np.asarray(jc.lengths)
        jh, jc = jl.forward(jp, cfg, jnp.asarray(tok[:, None]), jc,
                            jnp.asarray(wp), jnp.asarray(seg), kv_window=32)
        th, tc = tl.forward(tp, tcfg, torch.from_numpy(tok[:, None]), tc,
                            tc.lengths.clone(), torch.from_numpy(seg),
                            kv_window=32)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=atol)
        tok = (tok * 7 + 3) % cfg.vocab_size
    assert tc.lengths.tolist() == [19, 11]
    for name in ("k", "v"):
        for j, t in zip(getattr(jc, name), getattr(tc, name)):
            got = tp4.unpack_kv_int4(t[1:].movedim(1, 2)).numpy()
            want = np.asarray(jp4.unpack_kv_int4(
                jnp.moveaxis(j[1:], 1, 2), cfg.num_key_value_heads))
            assert np.abs(got - want).max() <= 1
            assert (got == want).mean() >= 0.999
    for name in ("k_scale", "v_scale"):
        for j, t in zip(getattr(jc, name), getattr(tc, name)):
            np.testing.assert_allclose(t.numpy()[1:], np.asarray(j)[1:],
                                       atol=1e-6, rtol=1e-5)


# -- the engine: the JAX core runs its Pallas kernel in interpret mode ----------


KCFG = ModelConfig(
    vocab_size=512, hidden_size=128, intermediate_size=256,
    num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
    head_dim=128, rope_scaling_factor=None, max_position_embeddings=512,
    dtype="float32")
KENG = EngineConfig(
    max_batch_size=2, max_input_len=32, max_output_len=96,
    prefill_buckets=(16,), kv_buckets=(32, 64), decode_steps_per_call=3,
    paged_kv=True, kv_block_size=BLOCK, kv_cache_int4=True)


@pytest.mark.parametrize("weight_bits", [None, 8, 4])
def test_int4_kv_core_matches_jax_kernels(weight_bits):
    """Greedy tokens of an admission launch and a decode launch over int4 KV
    pools — with plain, int8 or int4 weights, quantized by the JAX package
    and carried across — equal the JAX core's, whose decode steps run the
    Pallas K5 in interpret mode."""
    jp = to_jax(numpy_llama_tree(KCFG, seed=0))
    if weight_bits:
        jp = jq.quantize_llama_params(jp, bits=weight_bits)
    prompts = [[7, 8, 9, 10], [13, 14]]
    sp = SamplingConfig(greedy=True)

    def run(core, params_mod, sp):
        spar = params_mod.SamplingParams.from_config(sp, 2)
        t0, tok, act = core.prefill_decode_launch(
            prompts, [0, 1], spar, np.zeros(2, np.int32), np.zeros(2, bool),
            n=3, reserve_extra=[24, 24])
        t1, _, _ = core.decode_steps_launch(spar, tok, act)
        return np.concatenate([np.asarray(to_numpy(t0)),
                               np.asarray(to_numpy(t1))], axis=1)

    with pltpu.force_tpu_interpret_mode():
        want = run(JCore(jp, dataclasses.replace(
            KCFG, use_pallas_attention=True), KENG, eos_id=511), jS, sp)
    core = TCore(W.llama_params_from_jax(jp), port_config(KCFG),
                 port_config(KENG), eos_id=511)
    assert core.cache.int4 and core.cache.k[0].shape[1] == 2
    got = run(core, tS, port_config(sp))
    np.testing.assert_array_equal(got, want)
    assert core.prefills == 1 and core.decode_steps == 6


def test_int4_kv_engine_rejections():
    tree = W.llama_params_from_jax(numpy_llama_tree(TINY_LM, seed=0))
    cfg = port_config(TINY_LM)
    dense = port_config(dataclasses.replace(KENG, paged_kv=False))
    with pytest.raises(ValueError, match="kv_cache_int4 requires paged_kv"):
        TCore(tree, cfg, dense)
    both = port_config(dataclasses.replace(KENG, kv_cache_int8=True))
    with pytest.raises(ValueError, match="mutually exclusive"):
        TCore(tree, cfg, both)
    with pytest.raises(NotImplementedError, match="prefix cache"):
        TCore(tree, cfg, port_config(dataclasses.replace(
            KENG, prefix_cache=True)))


def test_int4_kv_snapshot_preempt_resume_unchanged():
    """Preempting a slot over int4 pools releases its blocks; the snapshot
    and restore of its sampling state are those of the other pool kinds."""
    tree = W.llama_params_from_jax(numpy_llama_tree(TINY_LM, seed=0))
    ecfg = port_config(dataclasses.replace(
        KENG, kv_on_demand=True, kv_pool_tokens=128))
    core = TCore(tree, port_config(TINY_LM), ecfg, eos_id=5)
    sp = tS.SamplingParams.from_config(
        port_config(SamplingConfig(greedy=True)), 2)
    total = core.free_tokens()
    core.prefill_slots([[7, 8, 9]], [0], sp)
    assert core.free_tokens() < total
    snap = core.snapshot_slot(0)
    core.preempt_slot(0)
    assert core.free_tokens() == total
    core.prefill_slots([[7, 8, 9]], [0], sp)
    core.restore_slot(0, snap)
    assert core.snapshot_slot(0)["step"] == snap["step"]
