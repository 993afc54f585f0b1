"""The port's prefix cache (``EngineConfig.prefix_cache``, ``engine/engine.py``)
on the CPU, where the launches the card replays run eagerly.

- the nine cases of ``tests/test_prefix_cache.py`` on the port: a cached
  run gives the uncached run's greedy tokens, on a miss and on a hit;
  partial share, LRU eviction, the short-prompt bypass, int8 KV,
  ``prefill_slots``, the scheduler (PCM equal) and the warmup's graphs;
- the paged cases of ``tests/test_paged_kv.py`` (paged + int8 + prefix
  against dense, a hit frees its blocks, the reservation covers the prefix)
  and ``tests/test_int4_kv.py``'s int4 case on the port;
- parity with the JAX package for each of the five KV layouts (dense f32,
  dense int8, paged f32, paged int8 on demand, paged int4 under int4
  weights): the same prompts through the JAX ``EngineCore`` with the prefix
  cache (its jitted launches on the CPU, the jnp twins of its kernels) and
  through the port give equal greedy tokens and hit / miss counts, and
  equal pool rows after a miss — int8 / int4 bytes equal, f32 values and
  f32 scales within 1e-5 absolute or 1e-6 relative (the two frameworks' f32
  matmuls sum in another order; a scale is the absmax of such a sum);
- the two places where the reference looked wrong, each run on both sides:
  (a) the prefix branch of the fused admission grows no blocks under
  ``kv_on_demand`` and (b) the on-demand capacity gate sizes a resume
  without the prefix its re-prefill reserves.

Weights are made with numpy from a seed and carried to the port by
``weights.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tts_inference_tpu import protocol as P
from tts_inference_tpu.config import (EngineConfig, ModelConfig,
                                      SamplingConfig, StreamConfig,
                                      tiny_config)
from tts_inference_tpu.engine import scheduler as JS
from tts_inference_tpu.engine.engine import EngineCore as JCore
from tts_inference_tpu.models import quant as jq
from tts_inference_tpu.models.snac import SnacDecoder as JSnac
from tts_inference_tpu.ops import sampling as jS
from tts_inference_tpu.utils.tokenizer import ByteTokenizer
from tts_inference_tpu_torch import weights as W
from tts_inference_tpu_torch.engine import scheduler as TS
from tts_inference_tpu_torch.engine.engine import EngineCore as TCore
from tts_inference_tpu_torch.ops import sampling as tS
from tts_inference_tpu_torch.runtime import Runtime
from tts_inference_tpu_torch.utils import to_numpy

from tests.torch_port_helpers import (AUDIO_RANGE, for_side,
                                      numpy_llama_tree, numpy_snac_tree,
                                      port_config, to_jax)

CFG = ModelConfig.tiny(vocab_size=512)
BASE = EngineConfig(
    max_batch_size=4, max_input_len=32, max_output_len=96,
    prefill_buckets=(8, 16, 32), kv_buckets=(32, 64),
    decode_steps_per_call=4,
)
PREFIX = dataclasses.replace(BASE, prefix_cache=True)
PAGED = dataclasses.replace(BASE, paged_kv=True, kv_block_size=16)
VOICE_HEADER = [101, 102, 103, 104, 105, 106]  # shared "{voice}: " tokens


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its runtimes run beside
    other files' servers, which wait on starved OpenMP threads when all
    cores are taken."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    return numpy_llama_tree(CFG, seed=0)


@pytest.fixture(scope="module")
def params(tree):
    return W.llama_params_from_jax(tree)


def core(params, ecfg, **kw) -> TCore:
    return TCore(params, port_config(CFG), port_config(ecfg), eos_id=5,
                 device="cpu", **kw)


def greedy_sp(mod, batch=4):
    return mod.SamplingParams.from_config(
        for_side(mod, SamplingConfig(greedy=True)), batch)


def gen(c, prompts, slots, n_extra=2, reserve=None):
    """Admit prompts and decode a few launches; returns the (B, T) token
    matrix. Either package's core."""
    mod = tS if isinstance(c, TCore) else jS
    sp = greedy_sp(mod, c.batch)
    t0, tok, act = c.prefill_decode_launch(
        prompts, slots, sp, np.zeros(c.batch, np.int32),
        np.zeros(c.batch, bool), n=3, reserve_extra=reserve,
        seeds=[1000 + s for s in slots])
    chunks = [np.asarray(to_numpy(t0))]
    for _ in range(n_extra):
        t, tok, act = c.decode_steps_launch(sp, tok, act)
        chunks.append(np.asarray(to_numpy(t)))
    return np.concatenate(chunks, axis=1)


def reset(c, slots):
    if isinstance(c, TCore):
        c.reset_and_seed(slots)
    else:
        c.reset_slots(slots)


# -- the reference's nine cases, on the port ------------------------------------


def test_prefix_cached_matches_uncached(params):
    prompts = [VOICE_HEADER + [7, 8, 9, 10, 11], VOICE_HEADER + [13, 14, 15]]
    a = gen(core(params, PREFIX), prompts, [0, 1])
    b = gen(core(params, BASE), prompts, [0, 1])
    np.testing.assert_array_equal(a[:2], b[:2])


def test_second_request_hits_and_matches(params):
    c = core(params, PREFIX)
    prompt = [VOICE_HEADER + [7, 8, 9, 10, 11, 12]]
    first = gen(c, prompt, [0])
    assert c.prefix_misses == 1 and c.prefix_hits == 0
    reset(c, [0])
    second = gen(c, prompt, [0])
    assert c.prefix_hits == 1 and c.prefix_misses == 1
    np.testing.assert_array_equal(first[0], second[0])


def test_partial_prefix_share(params):
    """Texts sharing their first prefix_len tokens (a 40-token header)
    hit."""
    long_header = list(range(200, 240))
    c = core(params, PREFIX)
    gen(c, [long_header + [7, 8]], [0])
    reset(c, [0])
    gen(c, [long_header + [9, 10, 11]], [0])
    assert c.prefix_hits == 1


def test_lru_eviction(params):
    c = core(params, dataclasses.replace(PREFIX, prefix_entries=2))

    def p(base):
        return [[base + i for i in range(8)]]

    for base in (10, 20, 30):          # A, B, then C evicts A
        gen(c, p(base), [0])
        reset(c, [0])
    assert c.prefix_misses == 3 and list(c._prefix_map.values()) == [0, 1]
    out_evicted = gen(c, p(10), [0])   # A evicted: a miss again
    assert c.prefix_misses == 4
    want = gen(core(params, BASE), p(10), [0])
    np.testing.assert_array_equal(out_evicted[0], want[0])


def test_short_prompt_bypasses_cache(params):
    c = core(params, PREFIX)
    out = gen(c, [[7, 8, 9]], [0])     # len-1 = 2 < MIN_PREFIX
    assert c.prefix_hits == 0 and c.prefix_misses == 0
    want = gen(core(params, BASE), [[7, 8, 9]], [0])
    np.testing.assert_array_equal(out[0], want[0])


def test_prefix_with_int8_kv(params):
    i8 = dataclasses.replace(BASE, kv_cache_int8=True)
    i8p = dataclasses.replace(PREFIX, kv_cache_int8=True)
    prompts = [VOICE_HEADER + [7, 8, 9, 10]]
    c = core(params, i8p)
    a = gen(c, prompts, [0])
    assert c._pool[0][0].dtype == torch.int8 and len(c._pool[2]) == 2
    b = gen(core(params, i8), prompts, [0])
    np.testing.assert_array_equal(a[0], b[0])


def test_prefill_slots_path(params):
    c = core(params, PREFIX)
    sp = greedy_sp(tS)
    prompt = [VOICE_HEADER + [44, 45, 46, 47]]
    first_a = c.prefill_slots(prompt, [0], sp)
    assert c.prefix_misses == 1
    reset(c, [0])
    first_b = c.prefill_slots(prompt, [0], sp)
    assert c.prefix_hits == 1
    assert first_a[0] == first_b[0]
    want = core(params, BASE).prefill_slots(prompt, [0], sp)
    assert first_a[0] == want[0]


def test_scheduler_with_prefix_cache_matches():
    """Scheduler streams with the prefix cache equal those without: three
    requests of one text, the first misses and the others hit."""
    cfg = port_config(tiny_config())
    rt = Runtime.create(cfg, seed=0, device="cpu")

    def run(prefix):
        c = cfg if not prefix else dataclasses.replace(
            cfg, engine=dataclasses.replace(cfg.engine, prefix_cache=True))
        s = TS.Scheduler(rt.engine.core.params, c, rt.vocoder, rt.tokenizer,
                         device="cpu")
        reqs = [TS.TTSRequest(
            text="same text for all", force_speech=True,
            sampling=port_config(SamplingConfig(
                max_tokens=28, seed=50 + i, token_range=AUDIO_RANGE)),
            stream_cfg=port_config(StreamConfig(frames_per_chunk=2,
                                                lookahead_frames=3)))
            for i in range(3)]
        for r in reqs:
            s.submit(r)
        for _ in range(2000):
            if not s.step() and s.n_queued == 0 and not s.n_active:
                break
        s.drain_vocoder()
        out = []
        for r in reqs:
            pcm = []
            while True:
                kind, payload = r.events.get(timeout=60)
                if kind == "chunk":
                    pcm.append(payload.pcm)
                elif kind == "done":
                    out.append((b"".join(pcm), payload.tokens))
                    break
                else:
                    raise AssertionError(payload)
        hits = s.core.prefix_hits, s.core.prefix_misses
        s.stop()
        return out, hits

    with_prefix, hits = run(True)
    without, _ = run(False)
    assert hits == (2, 1)
    for (pcm_a, n_a), (pcm_b, n_b) in zip(with_prefix, without):
        assert n_a == n_b == 28
        assert pcm_a == pcm_b and len(pcm_a) == 4 * P.SAMPLES_PER_FRAME * 2


def test_warmup_captures_prefix_graphs(params):
    """The warmup's census holds the build and the prefix admission of
    every bucket; its probes share one prefix (one miss, then hits), and
    the pool keeps the entry while every slot is free again."""
    c = core(params, PREFIX)
    info = c.warmup_graphs()
    assert info["warmed_buckets"] == list(PREFIX.prefill_buckets)
    census = set(info["graph_census_ms"])
    assert "capture_prefix_build" in census
    assert {f"capture_prefill_prefix_{b}" for b in PREFIX.prefill_buckets} \
        <= census
    assert not any(n.startswith("capture_prefill_") and "prefix" not in n
                   for n in census)
    assert c.prefix_misses == 1 and c.prefix_hits == c.launches["admission"] - 1
    assert c.launches["prefix_build"] == 1 and not c._len_bounds.any()


# -- the paged and int4 cases of the reference, on the port -----------------------


@pytest.mark.parametrize("int8", [False, True])
def test_paged_prefix_matches_dense(params, int8):
    """Paged + int8 KV + prefix cache together give the plain dense
    engine's greedy tokens at the same KV precision."""
    full = dataclasses.replace(PAGED, prefix_cache=True, kv_cache_int8=int8,
                               prefix_len=8)
    dense = dataclasses.replace(BASE, kv_cache_int8=int8)
    prompts = [VOICE_HEADER + [7, 8, 9, 10, 11], VOICE_HEADER + [13, 14, 15]]
    a = gen(core(params, full), prompts, [0, 1], reserve=[24, 24])
    b = gen(core(params, dense), prompts, [0, 1], reserve=[24, 24])
    np.testing.assert_array_equal(a[:2], b[:2], err_msg=f"int8={int8}")


def test_paged_prefix_hit_matches_and_frees_blocks(params):
    c = core(params, dataclasses.replace(PAGED, prefix_cache=True,
                                         prefix_len=8))
    free0 = c.free_tokens()
    prompt = [VOICE_HEADER + [7, 8, 9, 10, 11, 12]]
    first = gen(c, prompt, [0], reserve=[24])
    assert c.prefix_misses == 1 and c.prefix_hits == 0
    reset(c, [0])
    assert c.free_tokens() == free0
    second = gen(c, prompt, [0], reserve=[24])
    assert c.prefix_hits == 1
    np.testing.assert_array_equal(first[0], second[0])
    reset(c, [0])
    assert c.free_tokens() == free0


def test_paged_prefix_reservation_covers_prefix(params):
    """prefix 8 + suffix bucket 8 + 40 + slack 5 = 61 → 4 blocks."""
    c = core(params, dataclasses.replace(PAGED, prefix_cache=True,
                                         prefix_len=8))
    c.prefill_decode_launch(
        [VOICE_HEADER + [7, 8]], [0], greedy_sp(tS),
        np.zeros(c.batch, np.int32), np.zeros(c.batch, bool), n=3,
        reserve_extra=[40])
    assert len(c._slot_blocks[0]) == 4


def test_prefix_cache_int4_bit_exact_vs_plain(params):
    """Over int4 pools the injected prefix is the bytes a plain prefill
    writes: cached and uncached greedy tokens are equal, on a miss and on
    a hit, and so are the pools' bytes."""
    i4 = dataclasses.replace(PAGED, kv_cache_int4=True)
    pfx = dataclasses.replace(i4, prefix_cache=True, prefix_len=8)
    prompts = [[101, 102, 103, 104, 105, 106, 107, 108, 30, 31, 32, 33]]
    c = core(params, pfx)
    plain = core(params, i4)
    a = gen(c, prompts, [0], reserve=[24])
    b = gen(plain, prompts, [0], reserve=[24])
    np.testing.assert_array_equal(a[:1], b[:1])
    assert c._slot_blocks == plain._slot_blocks
    for name in ("k", "v", "k_scale", "v_scale"):
        for x, y in zip(getattr(c.cache, name), getattr(plain.cache, name)):
            # every pool row but the trash block: the packed bytes equal,
            # the f32 scales to an f32 rounding (a prefill of another
            # width sums in another order)
            if x.dtype == torch.int8:
                np.testing.assert_array_equal(x[1:].numpy(), y[1:].numpy())
            else:
                np.testing.assert_allclose(x[1:].numpy(), y[1:].numpy(),
                                           rtol=1e-6, atol=0)
    reset(c, [0])
    assert c.prefix_hits == 0
    second = gen(c, prompts, [0], reserve=[24])
    assert c.prefix_hits == 1
    np.testing.assert_array_equal(a[:1], second[:1])


# -- parity with the JAX package, five KV layouts ----------------------------------


LAYOUT_ENGINE = dataclasses.replace(
    BASE, max_input_len=64, prefill_buckets=(8, 16, 32, 64),
    prefix_cache=True)
LAYOUTS = {
    "dense": {},
    "dense_int8": dict(kv_cache_int8=True),
    "paged": dict(paged_kv=True, kv_block_size=16),
    "paged_int8_on_demand": dict(paged_kv=True, kv_block_size=16,
                                 kv_cache_int8=True, kv_on_demand=True),
    "paged_int4_w4": dict(paged_kv=True, kv_block_size=16,
                          kv_cache_int4=True),
}
H = list(range(101, 141))
# a miss wave (a 32-token prefix, a 20-token one) and a hit wave (the first
# prefix again beside a miss of a 24-token prefix)
WAVES = ([H[:32] + [7, 8, 9], H[:20] + [5]],
         [H[:32] + [11, 12], H[:20] + [6, 7, 8, 9, 10]])


def _pool_rows(pool, idx):
    return [np.asarray(to_numpy(t) if isinstance(t, torch.Tensor) else t)[idx]
            for part in pool for t in part]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefix_layouts_match_jax(tree, params, layout):
    """Greedy tokens, hit / miss counts and the pool row of every miss equal
    the JAX core's; the port's cached tokens equal its uncached ones."""
    ecfg = dataclasses.replace(LAYOUT_ENGINE, **LAYOUTS[layout])
    jp, tp = to_jax(tree), params
    if layout == "paged_int4_w4":
        jp = jq.quantize_llama_params(jp, bits=4)
        tp = W.llama_params_from_jax(jp)
    jc, tc = JCore(jp, CFG, ecfg, eos_id=5), core(tp, ecfg)
    plain = core(tp, dataclasses.replace(ecfg, prefix_cache=False))
    for wave in WAVES:
        slots = list(range(len(wave)))
        want = gen(jc, wave, slots, reserve=[24] * len(wave))
        got = gen(tc, wave, slots, reserve=[24] * len(wave))
        np.testing.assert_array_equal(got, want, err_msg=layout)
        np.testing.assert_array_equal(
            got[: len(wave)],
            gen(plain, wave, slots, reserve=[24] * len(wave))[: len(wave)])
        assert (tc.prefix_hits, tc.prefix_misses) == \
            (jc.prefix_hits, jc.prefix_misses)
        assert list(tc._prefix_map.items()) == list(jc._prefix_map.items())
        for idx in tc._prefix_map.values():
            for g, w in zip(_pool_rows(tc._pool, idx),
                            _pool_rows(jc._pool, idx)):
                if g.dtype == np.int8:
                    np.testing.assert_array_equal(g, w, err_msg=layout)
                else:
                    np.testing.assert_allclose(g, w.astype(np.float32),
                                               atol=1e-5, rtol=1e-6,
                                               err_msg=layout)
        for c in (jc, tc, plain):
            reset(c, slots)
    assert (tc.prefix_hits, tc.prefix_misses) == (1, 3)
    if ecfg.paged_kv:       # the prefix counts in what a request reserves
        assert tc.kv_demand(40, 20) == jc.kv_demand(40, 20) > \
            plain.kv_demand(40, 20)


# -- the two places where the reference looked wrong ------------------------------


FAULT_A = dataclasses.replace(PAGED, prefix_len=8, kv_on_demand=True)


def _neighbour_then_admission(c):
    """A live neighbour in slot 1 (an 11-token prompt with an 8-token
    prefix), decoded until its next write position is 30 — its blocks
    then cover 32 positions — then a fused admission of 4 steps into slot
    0, and two decode launches. Returns slot 1's tokens, its next write
    position before the admission and its blocks after it."""
    mod = tS if isinstance(c, TCore) else jS
    sp = greedy_sp(mod, c.batch)
    act = np.zeros(c.batch, bool)
    t0, tok, act = c.prefill_decode_launch(
        [VOICE_HEADER + [2, 3, 4, 7, 8]], [1], sp,
        np.zeros(c.batch, np.int32), act, n=3)
    toks = [np.asarray(to_numpy(t0))[1]]
    for _ in range(4):
        t, tok, act = c.decode_steps_launch(sp, tok, act)
        toks.append(np.asarray(to_numpy(t))[1])
    write_pos = int(to_numpy(c.cache.lengths)[1])
    t, tok, act = c.prefill_decode_launch(
        [VOICE_HEADER + [2, 3, 9, 10]], [0], sp, tok, act, n=4)
    toks.append(np.asarray(to_numpy(t))[1, 1:])
    blocks = len(c._slot_blocks[1])
    for _ in range(2):
        t, tok, act = c.decode_steps_launch(sp, tok, act)
        toks.append(np.asarray(to_numpy(t))[1])
    return np.concatenate(toks), write_pos, blocks


def test_fault_a_prefix_admission_grows_the_live_slots(tree, params):
    """JAX side: the prefix branch of ``prefill_decode_launch`` grows no
    blocks, so the neighbour (next write at 30, 2 blocks of 16) writes
    positions 32 and 33 of its admission steps into the trash block, and
    its tokens leave those of the plain core (which grows) from the
    admission on. Port: the prefix branch grows the live slots first; its
    tokens equal the plain core's and the JAX plain core's."""
    plain_cfg = dataclasses.replace(FAULT_A, prefix_cache=False)
    pfx_cfg = dataclasses.replace(FAULT_A, prefix_cache=True)
    jp = to_jax(tree)
    j_plain, pos, j_blocks = _neighbour_then_admission(
        JCore(jp, CFG, plain_cfg, eos_id=5))
    j_pfx, pos_p, j_pfx_blocks = _neighbour_then_admission(
        JCore(jp, CFG, pfx_cfg, eos_id=5))
    assert pos == pos_p == 30
    assert j_blocks == 3 and j_pfx_blocks == 2   # 2 x 16 < 30 + 4
    first = int(np.flatnonzero(j_pfx != j_plain)[0])
    assert first >= len(j_plain) - 12       # from the admission launch on
    t_pfx, _, t_blocks = _neighbour_then_admission(core(params, pfx_cfg))
    t_plain, _, _ = _neighbour_then_admission(core(params, plain_cfg))
    assert t_blocks == 3
    np.testing.assert_array_equal(t_pfx, t_plain)
    np.testing.assert_array_equal(t_pfx, j_plain)


def _resume_candidate(mod, sched, prompt, generated):
    """A request waiting to resume in the held queue: prompt + generated
    tokens, its sampling state snapshot taken from slot 0."""
    req = mod.TTSRequest(text="resume", force_speech=True,
                         sampling=for_side(mod, SamplingConfig(
                             greedy=True, max_tokens=200,
                             token_range=AUDIO_RANGE)))
    state = mod._SlotState(req, sched)
    state.prompt_ids = list(prompt)
    state.token_ids = list(generated)
    state.resume_snapshot = sched.core.snapshot_slot(0)
    req._resume_state = state
    sched._held.append(req)
    return req


def test_fault_b_resume_gate_counts_the_prefix():
    """A resume of 60 tokens (resume bucket 64) over a 3-block pool of 32:
    the JAX gate sizes it 64 + slack 8 + 1 = 73 → 96 tokens and admits it,
    and the re-prefill through the prefix cache reserves 32 + 64 + 1 + 8 =
    105 → 4 blocks: "KV pool exhausted". The port's gate counts the prefix
    and holds the request; with a fourth block it resumes."""
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, paged_kv=True, kv_on_demand=True, kv_block_size=32,
        kv_pool_tokens=3 * 32, resume_buckets=(128, 256), prefix_cache=True))
    trees = (numpy_llama_tree(cfg.model, seed=0),
             numpy_snac_tree(cfg.snac, seed=1))
    prompt = [P.TOKEN_SOH] + list(range(300, 340))        # 41 tokens
    generated = [P.TOKEN_AUDIO_BASE + i for i in range(20)]
    js = JS.Scheduler(to_jax(trees[0]), cfg, JSnac(to_jax(trees[1]),
                                                   cfg.snac),
                      ByteTokenizer())
    _resume_candidate(JS, js, prompt, generated)
    assert js.core.free_tokens() == 96
    with pytest.raises(RuntimeError, match="KV pool exhausted: need 4"):
        js._admit()

    rt = Runtime.create(port_config(cfg), device="cpu", llama_tree=trees[0],
                        snac_tree=trees[1])
    ts = TS.Scheduler(rt.engine.core.params, rt.config, rt.vocoder,
                      rt.tokenizer, device="cpu")
    req = _resume_candidate(TS, ts, prompt, generated)
    assert not ts._admit() and list(ts._held) == [req]
    assert ts.core.free_tokens() == 96 and not ts.core._slot_blocks
    big = dataclasses.replace(rt.config, engine=dataclasses.replace(
        rt.config.engine, kv_pool_tokens=4 * 32))
    ts = TS.Scheduler(rt.engine.core.params, big, rt.vocoder, rt.tokenizer,
                      device="cpu")
    req = _resume_candidate(TS, ts, prompt, generated)
    assert ts._admit() and not ts._held
    assert len(ts.core._slot_blocks[0]) == 4 and ts.core.prefix_misses == 1
