"""The port's tensor- and data-parallel serving against the JAX package's
sharding (twins of tests/test_sharding.py without its training cases, of
tests/test_paged_kv.py::test_sharded_paged_matches and of
tests/test_int4_kv.py's sharded cases).

The port runs sharded on a pool of 4 gloo worker processes
(tests/torch_gloo_pool.py, one per module; workers run tests/
torch_mesh_work.py on one torch thread), at tp 2 and at dp 2 × tp 2, and
unsharded in this process; the JAX package runs its mesh engine on the
conftest's 8 virtual CPU devices. Same numpy weights on every side.
Tokens must be equal everywhere; logits within JAX's own tolerance
(atol = rtol = 1e-4).
"""

import dataclasses

import numpy as np
import pytest

from tests import torch_mesh_work as W
from tests.torch_gloo_pool import GlooPool, free_port
from tests.torch_port_helpers import numpy_llama_tree, port_config, to_jax
from tts_inference_tpu import protocol as JP
from tts_inference_tpu.config import EngineConfig, MeshConfig, ModelConfig

CFG = ModelConfig(
    vocab_size=512, hidden_size=128, intermediate_size=256,
    num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
    head_dim=16, rope_scaling_factor=None, max_position_embeddings=256,
    dtype="float32",
)
DENSE = EngineConfig(
    max_batch_size=4, max_input_len=32, max_output_len=96,
    prefill_buckets=(16, 32), kv_buckets=(32, 64), decode_steps_per_call=4,
)
QUANT = EngineConfig(
    max_batch_size=4, max_input_len=16, max_output_len=48,
    prefill_buckets=(16,), kv_buckets=(32,), decode_steps_per_call=3,
)
PREFIX = dataclasses.replace(DENSE, prefill_buckets=(8, 16, 32),
                             prefix_cache=True)
PAGED = EngineConfig(
    max_batch_size=4, max_input_len=32, max_output_len=96,
    prefill_buckets=(8, 16, 32), kv_buckets=(32, 64),
    decode_steps_per_call=4, paged_kv=True, kv_block_size=16,
)
MESHES = [(1, 2), (2, 2)]      # (dp, tp)
ids = ["tp2", "dp2xtp2"]


@pytest.fixture(scope="module")
def pool():
    p = GlooPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread, as the workers run: the CPU's convolutions and
    products round by their thread split, and the unsharded runs here are
    held to the workers' bytes."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sharded(pool, fn, **kw):
    """Rank 0's result, after checking every member rank got the same."""
    outs = [o for o in pool.run(fn, **kw) if o is not None]
    for o in outs[1:]:
        if isinstance(o, np.ndarray):
            np.testing.assert_array_equal(o, outs[0])
    return outs[0]


# ---- the JAX side ---------------------------------------------------------

_JAX = {}


def _jax_mesh():
    import jax

    from tts_inference_tpu.parallel import mesh as M

    assert jax.device_count() >= 4
    return M.make_mesh(MeshConfig(dp=2, tp=2))


def _jax_engine(ecfg, script, bits=0):
    """The JAX package's mesh engine over the same numpy weights, one of
    torch_mesh_work's scripts in its own API (memoized per module)."""
    key = (ecfg, script, bits)
    if key in _JAX:
        return _JAX[key]
    from tts_inference_tpu.config import SamplingConfig
    from tts_inference_tpu.engine.engine import EngineCore
    from tts_inference_tpu.models.quant import quantize_llama_params
    from tts_inference_tpu.ops import sampling as S

    params = to_jax(numpy_llama_tree(CFG, 0))
    if bits:
        params = quantize_llama_params(params, bits=bits, group=W.I4_GROUP)
    core = EngineCore(params, CFG, ecfg, eos_id=5, mesh=_jax_mesh())
    sp = S.SamplingParams.from_config(SamplingConfig(greedy=True), 4)
    z_tok, z_act = np.zeros(4, np.int32), np.zeros(4, bool)
    if script == "tick":
        core.seed_slots([0, 1], [1, 2])
        t0, tok, act = core.prefill_decode_launch(
            [[7, 8, 9, 10], [11, 12, 13]], [0, 1], sp, z_tok, z_act, n=3)
        t1, _, _ = core.decode_steps_launch(sp, tok, act)
        out = np.concatenate([np.asarray(t0), np.asarray(t1)], axis=1)
    elif script == "first":
        first = core.prefill_slots([[7, 8, 9]], [0], sp)
        toks, _, _ = core.decode_steps(
            sp, first, np.array([True, False, False, False]))
        out = np.concatenate([first[:1, None], toks[:1]], axis=1)
    elif script == "prefix":
        prompts = [[9] * 6 + [7, 8, 9, 10], [9] * 6 + [13, 14]]
        core.seed_slots([0, 1], [1, 2])
        t0, tok, act = core.prefill_decode_launch(prompts, [0, 1], sp,
                                                  z_tok, z_act, n=3)
        t1, _, _ = core.decode_steps(sp, tok, act)
        core.reset_slots([0, 1])
        t2, tok, act = core.prefill_decode_launch(prompts, [0, 1], sp, tok,
                                                  act, n=3)
        out = (np.concatenate([np.asarray(t0)[:2], t1[:2],
                               np.asarray(t2)[:2]], axis=1),
               core.prefix_hits)
    else:   # paged
        core.seed_slots([0, 1], [7, 7])
        t0, tok, act = core.prefill_decode_launch(
            [[7, 8, 9, 10], [13, 14]], [0, 1], sp, z_tok, z_act, n=3,
            reserve_extra=[24, 24])
        t1, tok, act = core.decode_steps_launch(sp, tok, act)
        t2, _, _ = core.decode_steps_launch(sp, tok, act)
        out = np.concatenate([np.asarray(t0), np.asarray(t1),
                              np.asarray(t2)], axis=1)[:2]
    _JAX[key] = out
    return out


# ---- cases ------------------------------------------------------------------


def test_validate_tp():
    """The JAX package's three checks with its messages, and the int4
    row-shard group check."""
    from tts_inference_tpu.parallel import mesh as JM
    from tts_inference_tpu_torch.models.quant import quantize_llama_params
    from tts_inference_tpu_torch.parallel import mesh as M

    cfg = port_config(CFG)
    M.validate_tp(cfg, 4)
    for bad in (8, dataclasses.replace(CFG, num_attention_heads=6),
                dataclasses.replace(CFG, intermediate_size=250)):
        jcfg, tp = (CFG, bad) if isinstance(bad, int) else (bad, 4)
        with pytest.raises(ValueError) as want:
            JM.validate_tp(jcfg, tp)
        with pytest.raises(ValueError) as got:
            M.validate_tp(port_config(jcfg), tp)
        assert str(got.value) == str(want.value)
    # int4 o/down rows: K 128 at group 32 is 2 groups per packed half at
    # tp 2; at tp 4 a shard's half is 16 rows, and a group of 32 is cut into
    # groups of 16 (a multiple of 8, as K4's tensor cores take)
    q = quantize_llama_params(W._params(cfg, 0), bits=4, group=W.I4_GROUP)
    M.validate_tp(cfg, 2, q)
    M.validate_tp(cfg, 4, q)
    assert M.shard_group(128, 32, 4) == 16
    # at group 4 no group that divides both 4 and a shard's half is a
    # multiple of 8
    q4 = quantize_llama_params(W._params(cfg, 0), bits=4, group=4)
    with pytest.raises(ValueError, match="no group that divides both"):
        M.validate_tp(cfg, 2, q4)
    # Orpheus-3B at tp 2 and the default group 512: o (K 3072) is cut into
    # groups of 256, down (K 8192) keeps 512
    import torch

    from tts_inference_tpu_torch.config import ModelConfig as PortConfig
    from tts_inference_tpu_torch.models.quant import quantize_linear_i4

    gen = torch.Generator().manual_seed(0)
    orpheus = {"layers": [{
        "wo": quantize_linear_i4(torch.randn(3072, 128, generator=gen), 512),
        "w_down": quantize_linear_i4(torch.randn(8192, 128, generator=gen),
                                     512)}]}
    M.validate_tp(PortConfig(), 2, orpheus)
    assert [M.shard_group(k, 512, 2) for k in (3072, 8192)] == [256, 512]


@pytest.mark.parametrize("dp,tp", MESHES, ids=ids)
def test_sharded_forward_matches(pool, dp, tp):
    """Prefill logits at tp 2 and dp 2 × tp 2 against the JAX package's mesh
    forward (dp 2 × tp 4) and against the port unsharded."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JPs

    from tts_inference_tpu.models import llama as jl
    from tts_inference_tpu.parallel import mesh as JM

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, size=(4, 24)).astype(np.int32)
    lens = np.full((4,), 24, np.int32)
    cfg = port_config(CFG)
    got = _sharded(pool, "forward_logits", cfg=cfg, tokens=tokens, lens=lens,
                   dp=dp, tp=tp)
    plain = W.forward_logits(cfg, tokens, lens)
    np.testing.assert_allclose(got, plain, atol=1e-4, rtol=1e-4)

    mesh = JM.make_mesh(MeshConfig(dp=2, tp=4))
    params = to_jax(numpy_llama_tree(CFG, 0))
    sp = JM.shard_tree(params, JM.llama_param_pspecs(CFG), mesh)
    scache = JM.shard_tree(jl.init_kv_cache(CFG, 4, 32),
                           JM.kv_cache_pspecs(CFG), mesh)
    stoks = jax.device_put(tokens, NamedSharding(mesh, JPs("dp", None)))
    slens = jax.device_put(lens, NamedSharding(mesh, JPs("dp")))
    with mesh:
        fwd = jax.jit(lambda p, t, c, n: jl.compute_logits(
            p, CFG, jl.forward(p, CFG, t, c, jnp.zeros(4, jnp.int32), n)[0]))
        want = np.asarray(fwd(sp, stoks, scache, slens))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dp,tp", MESHES, ids=ids)
def test_sharded_engine_core_matches(pool, dp, tp):
    """The serving launches (admission + decode, windowed, sampling on the
    device) under tp and dp × tp: the unsharded port's tokens and the JAX
    mesh engine's."""
    kw = dict(cfg=port_config(CFG), ecfg=port_config(DENSE), script="tick")
    got = _sharded(pool, "engine_run", dp=dp, tp=tp, **kw)
    np.testing.assert_array_equal(got, W.engine_run(**kw))
    np.testing.assert_array_equal(got, _jax_engine(DENSE, "tick"))


def test_mesh_admissions_keep_the_whole_batch_graph(pool):
    """Under dp × tp an admission prefills the whole slot batch, one graph
    per prompt bucket (the dp row split crosses any subset of rows): the
    census is the JAX core's counterparts with the admissions mapped onto
    the whole-batch graph alone. Unsharded, every row bucket's graph."""
    from tests.test_torch_graphs import _expected_captures, _stub_launches
    from tts_inference_tpu.engine.engine import EngineCore as JCore

    jcore = JCore(to_jax(numpy_llama_tree(CFG, 0)), CFG, DENSE, eos_id=5)
    _stub_launches(jcore)
    jnames = jcore.warmup_graphs(admission_ns=[27, 4])["graph_census_ms"]
    kw = dict(cfg=port_config(CFG), ecfg=port_config(DENSE))
    names, rows = _sharded(pool, "warmup_census", dp=2, tp=2, **kw)
    assert rows == [4]
    assert set(names) == _expected_captures(jnames, 4, False, 4, mesh=True)
    names, rows = W.warmup_census(**kw)
    assert rows == [1, 2, 4]
    assert set(names) == _expected_captures(jnames, 4, False, 4)


@pytest.mark.parametrize("dp,tp", MESHES, ids=ids)
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_sharded_quantized_engine_matches(pool, bits, dp, tp):
    """int8 and int4 weights under tp and dp × tp: the quantized leaves cut
    by adapt_pspecs (int4 rows unpacked, cut at group boundaries and packed
    again)."""
    kw = dict(cfg=port_config(CFG), ecfg=port_config(QUANT), script="first",
              bits=bits)
    got = _sharded(pool, "engine_run", dp=dp, tp=tp, **kw)
    np.testing.assert_array_equal(got, W.engine_run(**kw))
    np.testing.assert_array_equal(got, _jax_engine(QUANT, "first", bits))


@pytest.mark.parametrize("dp,tp", MESHES, ids=ids)
def test_sharded_prefix_cache_matches(pool, dp, tp):
    """The prefix cache under tp and dp × tp (pool rows sharded over tp, the
    build run by every rank): tokens and hits equal."""
    kw = dict(cfg=port_config(CFG), ecfg=port_config(PREFIX),
              script="prefix")
    (toks, hits) = _sharded(pool, "engine_run", dp=dp, tp=tp, **kw)
    plain, plain_hits = W.engine_run(**kw)
    jtoks, jhits = _jax_engine(PREFIX, "prefix")
    np.testing.assert_array_equal(toks, plain)
    np.testing.assert_array_equal(toks, jtoks)
    assert hits == plain_hits == jhits == 2


@pytest.mark.parametrize("dp,tp", MESHES, ids=ids)
@pytest.mark.parametrize("kv", ["bf", "int8", "int4"])
def test_sharded_paged_matches(pool, kv, dp, tp):
    """Paged KV under tp and dp × tp — full precision, int8 and int4 pools
    (int4: tp 2 divides the 2 head pairs) — against the dense port, the
    unsharded port and the JAX mesh engine (tests/test_paged_kv.py:169,
    tests/test_int4_kv.py:247)."""
    ecfg = dataclasses.replace(PAGED, kv_cache_int8=kv == "int8",
                               kv_cache_int4=kv == "int4")
    kw = dict(cfg=port_config(CFG), ecfg=port_config(ecfg), script="paged")
    got = _sharded(pool, "engine_run", dp=dp, tp=tp, **kw)
    np.testing.assert_array_equal(got, W.engine_run(**kw))
    np.testing.assert_array_equal(got, _jax_engine(ecfg, "paged"))
    if kv == "bf":
        dense = dataclasses.replace(ecfg, paged_kv=False)
        np.testing.assert_array_equal(
            got, W.engine_run(kw["cfg"], port_config(dense), "paged"))


def test_tp_must_divide_pairs(pool):
    """tests/test_int4_kv.py:284: the tiny model's 2 kv heads are one pair;
    tp 2 cannot split it."""
    cfg = port_config(ModelConfig.tiny(vocab_size=512))
    ecfg = port_config(dataclasses.replace(PAGED, kv_cache_int4=True))
    msg = _sharded(pool, "int4_kv_pairs_raise", cfg=cfg, ecfg=ecfg, dp=2,
                   tp=2)
    assert "pairs" in msg and "int4 KV under TP needs tp | kv_heads/2" in msg


def test_gloo_capture_request_raises(pool):
    """A CUDA core on a gloo group with graphs asked for raises (gloo cannot
    be captured); it never turns eager by itself."""
    msg = _sharded(pool, "gloo_graphs_raise", cfg=port_config(CFG),
                   ecfg=port_config(DENSE), dp=1, tp=2)
    assert "cannot capture gloo collectives" in msg


def test_sampling_state_pspecs_match_structure(pool):
    """The spec trees have the state's structure and cut it on dp rows."""
    from tts_inference_tpu_torch.config import SamplingConfig
    from tts_inference_tpu_torch.ops import sampling as S
    from tts_inference_tpu_torch.parallel import mesh as M

    ss = S.init_sampling_state(4, 512, seed=0)
    specs = M.sampling_state_pspecs()
    assert type(specs) is type(ss) and specs._fields == ss._fields
    sp = S.SamplingParams.from_config(SamplingConfig(), 4)
    assert M.sampling_params_pspecs()._fields == sp._fields
    mesh = M.Mesh(dp=2, tp=2, rank=3, world=4, tp_group=None, dp_group=None,
                  device="cpu")
    placed = M.shard_tree(ss, specs, mesh)
    assert placed.presence.shape == (2, 512)
    np.testing.assert_array_equal(placed.seed.numpy(), ss.seed[2:].numpy())
    placed_sp = M.shard_tree(sp, M.sampling_params_pspecs(), mesh)
    assert placed_sp.temperature.shape == (2,)
    assert M.batch_pspec() == ("dp", None)


@pytest.mark.parametrize("kv", ["dense", "dense_int8", "paged_int8",
                                "paged_int4"])
def test_shard_cache_cuts_slots_and_heads(kv):
    """weights.shard_cache: a dense cache's slots over dp and kv heads over
    tp, a paged pool's heads (int4: head pairs, and the nibble-plane scales'
    pair axis) over tp, whole over dp, its tables and lengths over dp."""
    import torch

    from tts_inference_tpu_torch import weights
    from tts_inference_tpu_torch.models import llama
    from tts_inference_tpu_torch.parallel import mesh as M

    cfg = port_config(CFG)
    int8, int4 = kv.endswith("int8"), kv.endswith("int4")
    if kv.startswith("paged"):
        cache = llama.init_paged_kv_cache(cfg, 4, 64, num_blocks=9,
                                          block_size=16, int8=int8,
                                          int4=int4)
    else:
        cache = llama.init_kv_cache(cfg, 4, 64, int8=int8)
    for leaf in [cache.lengths, *cache.k, *cache.k_scale]:
        leaf.copy_(torch.arange(leaf.numel()).reshape(leaf.shape))
    mesh = M.Mesh(dp=2, tp=2, rank=3, world=4, tp_group=None, dp_group=None,
                  device="cpu")
    got = weights.shard_cache(cache, cfg, mesh)
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  cache.lengths[2:].numpy())
    if kv.startswith("paged"):
        axis = 1 if not int4 else 2     # the scales' head (pair) axis
        assert got.k[0].shape[0] == cache.k[0].shape[0]    # whole pool
        assert got.k[0].shape[1] == cache.k[0].shape[1] // 2
        assert got.block_table.shape[0] == 2
        np.testing.assert_array_equal(
            got.k_scale[0].numpy(),
            cache.k_scale[0].chunk(2, dim=axis)[1].numpy())
    else:
        np.testing.assert_array_equal(got.k[0].numpy(),
                                      cache.k[0][2:, :, 2:].numpy())
        if int8:
            np.testing.assert_array_equal(got.k_scale[0].numpy(),
                                          cache.k_scale[0][2:, :, 2:]
                                          .numpy())


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_head_slice_partition(pool, tp):
    """Every tp rank owns ⌈28,940/tp⌉ or ⌊28,940/tp⌋ of the sliced head's
    rows (and an even share of the text rows); the gathered logits, sliced
    and whole, and the masked lookup summed over tp equal the unsharded
    ones."""
    outs = [o for o in pool.run("head_slice", vocab=156940, hidden=16, tp=tp)
            if o is not None]
    assert len(outs) == tp
    audio = 156940 - JP.HEAD_SLICE_BASE
    rows = [o["rows"] for o in outs]
    assert sorted({a for _, a in rows}) == sorted({-(-audio // tp),
                                                  audio // tp})
    assert sum(a for _, a in rows) == audio
    assert sum(t for t, _ in rows) == JP.HEAD_SLICE_BASE
    assert {o["local_rows"] for o in outs} == {
        -(-JP.HEAD_SLICE_BASE // tp) + -(-audio // tp)}
    for o in outs:
        np.testing.assert_allclose(o["sliced"], o["want_sliced"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(o["whole"], o["want_whole"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(o["embed"], o["want_embed"])


def _streams(pool, specs, dp=2, tp=2, **kw):
    kw.update(specs=specs)
    sharded = pool.run("scheduler_run", dp=dp, tp=tp, lport=free_port(),
                       **kw)
    return sharded[0], W.scheduler_run(**kw)


def test_sharded_scheduler_stream_matches_unsharded(pool):
    """Continuous batching under dp 2 × tp 2, the scheduler on rank 0 and
    its core mirrored to ranks 1-3: the same tokens and the same PCM bytes
    as the unsharded scheduler."""
    specs = [(f"stream {i}", 100 + i, 35) for i in range(3)]
    sharded, plain = _streams(pool, specs)
    for (pcm_a, tok_a, _), (pcm_b, tok_b, _) in zip(sharded["streams"],
                                                    plain["streams"]):
        assert tok_a == tok_b and len(tok_a) == 35
        assert pcm_a == pcm_b


def test_sharded_fused_admission_vocode_matches(pool):
    """The fused admission vocode stays on under lockstep (rank 0 holds the
    whole batch's token rows on its own device): the fused first chunks
    engage, and the streams equal the unsharded scheduler's, bytes
    included."""
    specs = [(f"fused {i}", 50 + i, 56) for i in range(3)]
    sharded, plain = _streams(pool, specs, admission_steps=28)
    for (pcm_a, tok_a, first_a), (pcm_b, tok_b, first_b) in zip(
            sharded["streams"], plain["streams"]):
        assert tok_a == tok_b
        assert first_a == first_b == [0.0]     # a fused first chunk
        assert pcm_a == pcm_b


@pytest.mark.parametrize("dp,tp", [(2, 2), (4, 1)],
                         ids=["dp2xtp2", "dp4"])
def test_sharded_preemption_resumes_as_unsharded(pool, dp, tp):
    """Pool pressure under dp 2 × tp 2 and dp 4 (paged int8, on demand, 5
    blocks of 32): the youngest stream, in slot 1 — rank 0's at dp 2, a
    follower's at dp 4 — is preempted (the snapshot gathered over dp from
    the rank that holds the slot, restored there) and resumes; both streams
    equal the unsharded scheduler's, bytes included."""
    engine = dict(paged_kv=True, kv_cache_int8=True, kv_on_demand=True,
                  kv_block_size=32, kv_pool_tokens=5 * 32,
                  resume_buckets=(128, 256))
    specs = [("older stream", 11, 80), ("younger stream", 12, 80)]
    sharded, plain = _streams(pool, specs, dp, tp, engine=engine,
                              stagger=True)
    assert sharded["preemptions"] == plain["preemptions"] >= 1
    for (pcm_a, tok_a, _), (pcm_b, tok_b, _) in zip(sharded["streams"],
                                                    plain["streams"]):
        assert tok_a == tok_b and len(tok_a) == 80
        assert pcm_a == pcm_b
