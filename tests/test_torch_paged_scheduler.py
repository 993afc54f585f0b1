"""PyTorch port, the scheduler over paged KV on the CPU: preempt → resume is
byte-identical to an uninterrupted run of the port (stochastic sampling with
repetition penalty); pool pressure preempts instead of wedging; a greedy
paged-int8 run matches the JAX scheduler's PCM; and shortest-job-first with
aging and reserved short slots admit in the same order as the JAX
scheduler."""

import dataclasses
import time

import numpy as np
import pytest

from tts_inference_tpu import protocol as P
from tts_inference_tpu.config import SamplingConfig, StreamConfig, tiny_config
from tts_inference_tpu.engine import scheduler as JS
from tts_inference_tpu.models.snac import SnacDecoder as JSnac
from tts_inference_tpu.utils.tokenizer import ByteTokenizer
from tts_inference_tpu_torch.engine import scheduler as TS
from tts_inference_tpu_torch.runtime import Runtime

from tests.torch_port_helpers import (AUDIO_RANGE, numpy_llama_tree,
                                      numpy_snac_tree, to_jax)

SCFG = StreamConfig(frames_per_chunk=2, lookahead_frames=3,
                    left_context_frames=4)
BLOCK = 32


def engine_cfg(**over):
    cfg = tiny_config()
    return dataclasses.replace(cfg, engine=dataclasses.replace(cfg.engine,
                                                               **over))


@pytest.fixture(scope="module")
def trees():
    return (numpy_llama_tree(tiny_config().model, seed=0),
            numpy_snac_tree(tiny_config().snac, seed=1))


@pytest.fixture(scope="module")
def rt(trees):
    return Runtime.create(tiny_config(), device="cpu", llama_tree=trees[0],
                          snac_tree=trees[1])


def port_sched(rt, cfg):
    return TS.Scheduler(rt.engine.core.params, cfg, rt.vocoder, rt.tokenizer)


def run_until_idle(sched, max_iters=4000):
    for _ in range(max_iters):
        if not sched.step() and sched.n_queued == 0 and not sched.n_active:
            return
    raise AssertionError("scheduler did not drain")


def drain(req, timeout=120):
    chunks = []
    while True:
        kind, payload = req.events.get(timeout=timeout)
        if kind == "chunk":
            chunks.append(payload.pcm)
        elif kind == "done":
            return b"".join(chunks), payload
        else:
            raise AssertionError(payload)


def finish(sched, reqs):
    run_until_idle(sched)
    sched.drain_vocoder()
    out = [drain(r) for r in reqs]
    sched.stop()
    return out


# -- preemption ------------------------------------------------------------------


def on_demand(pool):
    return engine_cfg(paged_kv=True, kv_on_demand=True, kv_block_size=BLOCK,
                      kv_pool_tokens=pool, resume_buckets=(128, 256))


def stochastic(text, max_tokens=60):
    # stochastic sampling + repetition penalty: the state a resume must
    # carry across a preemption
    return TS.TTSRequest(text=text, sampling=SamplingConfig(
        max_tokens=max_tokens, seed=123, temperature=0.8, top_p=0.9,
        repetition_penalty=1.15, token_range=AUDIO_RANGE),
        stream_cfg=SCFG, force_speech=True)


def test_preempt_resume_is_byte_identical(rt):
    ref = port_sched(rt, on_demand(320 * 4))
    r1 = stochastic("preempt me")
    ref.submit(r1)
    [(pcm1, m1)] = finish(ref, [r1])
    assert m1.tokens == 60

    s = port_sched(rt, on_demand(320 * 4))
    r2 = stochastic("preempt me")
    s.submit(r2)
    for _ in range(100):
        s.step()
        live = [st for st in s.slots if st is not None]
        if live and len(live[0].token_ids) >= 10:
            break
    s._drain_inflight()
    slot = next(i for i, st in enumerate(s.slots) if st is not None)
    assert 0 < len(s.slots[slot].token_ids) < 60, "preempt must be mid-run"
    s._preempt(slot)
    assert s.preemptions == 1 and s.slots[slot] is None
    assert s.core.starved_slots() == [] and slot not in s.core._slot_blocks
    assert s.n_queued == 1
    [(pcm2, m2)] = finish(s, [r2])
    assert m2.tokens == m1.tokens
    assert pcm2 == pcm1


def test_pool_pressure_preempts_and_both_complete(rt):
    s = port_sched(rt, on_demand(5 * BLOCK))
    ra, rb = stochastic("older stream", 80), stochastic("younger stream", 80)
    s.submit(ra)
    s.step()                      # admit A first so B is the youngest
    s.submit(rb)
    (_, ma), (_, mb) = finish(s, [ra, rb])
    assert ma.tokens == 80 and mb.tokens == 80
    assert s.preemptions >= 1
    assert s.core.free_tokens() == 5 * BLOCK


def test_capacity_gate_counts_the_admission_launch_growth(rt):
    """A fresh request must not take the blocks that the admission launch
    grows the live slots (and itself) into: such an admission is held. The
    JAX gate counted only its prefill reservation, and the launch it let
    through fails with the pool exhausted (shown below on the core)."""
    s = port_sched(rt, on_demand(3 * BLOCK))      # 3 blocks
    core = s.core
    n = s.admission_steps
    core._reserve_blocks([0], [BLOCK])            # a live slot, one block,
    core._len_bounds[0] = BLOCK - 1               # its next step a new one
    assert core._blocks_deficit(n) == {0: 1} and core.free_tokens() == 64
    req = stochastic("fresh", 20)
    batch = [(1, req, [P.TOKEN_SOS] * 10)]        # bucket 16: 1 block
    s._capacity_gate(batch)
    assert batch == [] and list(s._held) == [req]
    sp = s._sampling_params()
    act = np.array([True, False, False, False])
    with pytest.raises(RuntimeError, match="KV pool exhausted"):
        core.prefill_decode_launch([[P.TOKEN_SOS] * 10], [1], sp,
                                   np.zeros(4, np.int32), act, n=n)


# -- against the JAX scheduler ---------------------------------------------------


def test_paged_int8_scheduler_matches_jax(trees, rt):
    """4 slots over a paged int8 pool, 3 concurrent greedy requests."""
    cfg = engine_cfg(paged_kv=True, kv_cache_int8=True, kv_block_size=16)

    def run(mod, sched):
        reqs = [mod.TTSRequest(text=f"request {i}", sampling=SamplingConfig(
            greedy=True, max_tokens=21 + 7 * i, token_range=AUDIO_RANGE),
            stream_cfg=SCFG, force_speech=True) for i in range(3)]
        for r in reqs:
            sched.submit(r)
        return finish(sched, reqs)

    want = run(JS, JS.Scheduler(to_jax(trees[0]), cfg,
                                JSnac(to_jax(trees[1]), cfg.snac),
                                ByteTokenizer()))
    sched = port_sched(rt, cfg)
    got = run(TS, sched)
    for (gp, gm), (wp, wm) in zip(got, want):
        assert gm.tokens == wm.tokens and gm.frames == wm.frames
        x = np.frombuffer(gp, np.int16).astype(np.int32)
        y = np.frombuffer(wp, np.int16).astype(np.int32)
        assert x.shape == y.shape and x.size > 0
        assert np.abs(x - y).max() <= 1
    assert sched.core.free_tokens() == (sched.core.cache.num_blocks - 1) * 16


def _admission_order(mod, sched, scenario):
    """Run a QoS scenario; returns the admission waves as (slot, text)."""
    waves = []
    orig = sched.core.prefill_decode_launch

    def spy(prompts, slots, *a, **k):
        waves.append(sorted((sl, sched.slots[sl].req.text) for sl in slots))
        return orig(prompts, slots, *a, **k)

    sched.core.prefill_decode_launch = spy

    def req(text, n):
        return mod.TTSRequest(text=text, sampling=SamplingConfig(
            greedy=True, max_tokens=n, token_range=AUDIO_RANGE),
            stream_cfg=SCFG, force_speech=True)

    if scenario == "reserved":
        reqs = [req(f"long {i}", 28) for i in range(5)]
        late = [("short", 14)]
    else:
        reqs = [req(f"long {i}", 28 + 14 * i) for i in range(4)]
        late = [("late long", 28), ("short", 14)]
    for r in reqs:
        sched.submit(r)
    for _ in range(50):
        sched.step()
        if sched.n_active == (3 if scenario == "reserved" else 4):
            break
    for text, n in late:
        reqs.append(sched.submit(req(text, n)))   # submitted_at = now
        if scenario == "aging":
            time.sleep(0.15)   # the long one ages past the fresh short one
    finish(sched, reqs)
    return waves


@pytest.mark.parametrize("scenario,over", [
    ("sjf", dict(admission_policy="sjf")),
    ("aging", dict(admission_policy="sjf", sjf_aging_ms=10.0)),
    ("reserved", dict(reserved_short_slots=1)),
])
def test_qos_admission_order_matches_jax(trees, rt, scenario, over):
    cfg = engine_cfg(short_request_tokens=14, **over)
    jsched = JS.Scheduler(to_jax(trees[0]), cfg,
                          JSnac(to_jax(trees[1]), cfg.snac), ByteTokenizer())
    want = _admission_order(JS, jsched, scenario)
    got = _admission_order(TS, port_sched(rt, cfg), scenario)
    assert got == want
    first_late = got[1][0][1]
    if scenario == "sjf":
        assert first_late == "short"         # jumps the earlier long one
    elif scenario == "aging":
        assert first_late == "late long"     # aged past the fresh short one
    else:
        assert got[0] == [(0, "long 0"), (1, "long 1"), (2, "long 2")]
        assert (3, "short") in got[1]        # the reserved slot
