"""PyTorch port, the preemption resume as a graph launch, on the CPU (where
the launch bodies run eagerly and the census names what the card captures):

- on a paged on-demand core the census holds ``capture_prefill_resume_{b}``
  for exactly the JAX core's ``compile_prefill_resume_{b}``, beside the
  counterparts of its other graphs, without and with the prefix cache;
- the warmup reserves no block: the free pool, the host and device block
  tables and the lengths are as they were, also on a 9-block pool;
- ``prefill_slots`` goes through ``_launch``: a resume-tier bucket under
  its own key, a prompt bucket under the bucket's admission key, every
  launch counted as a resume (the tier's warmup launches are not); a
  resume-tier launch runs the model over its one slot, leaves the other
  slots as they were and equals a whole-batch prefill; a scheduler counts
  one resume per preemption;
- a stream preempted late enough to resume through the resume tier gives
  the tokens and PCM of the same stream uninterrupted (stochastic, byte for
  byte) and of the JAX scheduler (greedy: the port's noise is its own).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tts_inference_tpu import protocol as P
from tts_inference_tpu.config import SamplingConfig, StreamConfig, tiny_config
from tts_inference_tpu.engine import scheduler as JS
from tts_inference_tpu.engine.engine import EngineCore as JCore
from tts_inference_tpu.models.snac import SnacDecoder as JSnac
from tts_inference_tpu.utils.tokenizer import ByteTokenizer
from tts_inference_tpu_torch.engine import scheduler as TS
from tts_inference_tpu_torch.ops import sampling as tS
from tts_inference_tpu_torch.runtime import Runtime

from tests.test_torch_graphs import _expected_captures, _stub_launches
from tests.torch_port_helpers import (AUDIO_RANGE, for_side, numpy_llama_tree,
                                      numpy_snac_tree, port_config, to_jax)

BLOCK = 32
RESUME = (128, 256)      # above the tiny prompt buckets (16, 32, 64)
SCFG = StreamConfig(frames_per_chunk=2, lookahead_frames=3,
                    left_context_frames=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the suite runs it beside
    other files' CPU-bound workers and servers, which wait on starved
    OpenMP threads when every worker takes all the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    return (numpy_llama_tree(tiny_config().model, seed=0),
            numpy_snac_tree(tiny_config().snac, seed=1))


@pytest.fixture(scope="module")
def rt(trees):
    return Runtime.create(port_config(tiny_config()), device="cpu",
                          llama_tree=trees[0], snac_tree=trees[1])


def on_demand(pool_blocks: int, **over):
    cfg = tiny_config()
    return dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, paged_kv=True, kv_on_demand=True, kv_block_size=BLOCK,
        kv_pool_tokens=pool_blocks * BLOCK, resume_buckets=RESUME, **over))


def port_sched(rt, cfg):
    return TS.Scheduler(rt.engine.core.params, port_config(cfg), rt.vocoder,
                        rt.tokenizer)


def _tables(core) -> dict:
    return {"free": core.free_tokens(), "slots": dict(core._slot_blocks),
            "host": core._table_host.copy(),
            "device": core.cache.block_table.clone(),
            "lengths": core.cache.lengths.clone()}


def _same_tables(a: dict, b: dict) -> bool:
    return (a["free"] == b["free"] and a["slots"] == b["slots"]
            and np.array_equal(a["host"], b["host"])
            and torch.equal(a["device"], b["device"])
            and torch.equal(a["lengths"], b["lengths"]))


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain", "prefix_cache"])
def warmed(request, trees, rt):
    """A 12-block on-demand scheduler before and after its warmup, and the
    JAX core's census of the same config (its launches stubbed)."""
    prefix = request.param
    cfg = on_demand(12, prefix_cache=prefix)
    sched = port_sched(rt, cfg)
    before = _tables(sched.core)
    info = sched.warmup()
    jcore = JCore(to_jax(trees[0]), cfg.model, cfg.engine)
    _stub_launches(jcore)
    jinfo = jcore.warmup_graphs(admission_ns=[
        sched.admission_steps, cfg.engine.decode_steps_per_call])
    return {"prefix": prefix, "cfg": cfg, "sched": sched, "info": info,
            "jinfo": jinfo, "before": before, "after": _tables(sched.core)}


def test_census_holds_the_jax_resume_tier(warmed):
    """The port's captures are exactly the counterparts of the JAX core's
    compiles, the resume tier's included (one graph per resume-tier
    bucket; the JAX condition: paged, on demand, above the largest prompt
    bucket, within max_seq)."""
    jnames = warmed["jinfo"]["graph_census_ms"]
    resume = {n for n in jnames if n.startswith("compile_prefill_resume_")}
    assert resume == {f"compile_prefill_resume_{b}" for b in RESUME}
    ecfg = warmed["cfg"].engine
    want = _expected_captures(jnames, ecfg.decode_steps_per_call,
                              warmed["prefix"], ecfg.max_batch_size)
    want |= {"capture_" + n[len("compile_"):] for n in resume}
    got = warmed["info"]["graph_census_ms"]
    assert set(got) == want and warmed["info"]["graphs_compiled"] == len(want)
    assert warmed["sched"].core.resume_tier() == list(RESUME)
    core = warmed["sched"].core
    # the tier's warmup launches are not resumes; nor are those of the
    # admission graphs that the one-prompt probes do not reach (row
    # buckets above one)
    assert core.late_captures == 0 and core.launches["resume"] == 0
    assert core.launches["warmup"] == len(RESUME) + len(
        ecfg.prefill_buckets) * (len(core.row_buckets()) - 1)


def test_warmup_reserves_no_block(warmed):
    """The resume tier is captured with every slot masked out: the pool,
    the block tables (host and device) and the lengths are as before."""
    assert _same_tables(warmed["before"], warmed["after"])
    assert warmed["after"]["free"] == 12 * BLOCK
    assert not warmed["sched"].core._len_bounds.any()


def test_warmup_fits_a_small_on_demand_pool_with_the_tier(rt):
    """The 9-block pool of test_warmup_fits_a_small_on_demand_pool: its
    256-token resume graph alone would take 8 blocks; the masked capture
    takes none."""
    core = port_sched(rt, on_demand(9)).core
    before = _tables(core)
    info = core.warmup_graphs(admission_ns=[27, 7])
    assert {f"capture_prefill_resume_{b}" for b in RESUME} <= set(
        info["graph_census_ms"])
    assert _same_tables(before, _tables(core)) and before["free"] == 9 * BLOCK


def test_prefill_slots_routes_through_launch(rt):
    """A resume-tier bucket launches under ("resume", b), a prompt bucket
    under its admission key; each counts as a resume, and the slot's
    sampled state and length are what reset_and_seed(seeds=[None]) + the
    prefill give."""
    core = port_sched(rt, on_demand(12)).core
    keys = []
    launch = core._launch

    def spy(key, kind=None, **inputs):
        keys.append((key, kind))
        return launch(key, kind=kind, **inputs)

    core._launch = spy
    sp = tS.SamplingParams.from_config(port_config(SamplingConfig(
        token_range=AUDIO_RANGE, repetition_penalty=1.2)), core.batch)
    prompt = [P.TOKEN_SOS] + list(range(300, 330))
    core.reset_and_seed([1], seeds=[5])
    seed1, step1 = int(core.sampling_state.seed[1]), 0
    tok = core.prefill_slots([prompt + [P.TOKEN_AUDIO_BASE] * 80], [1], sp,
                             seeds=[None], bucket=core.resume_bucket_len(111))
    assert keys == [(("resume", 128), "resume")]
    assert tok.shape == (core.batch,) and tok[0] == 0 and tok[1] != 0
    # no reseed: the slot keeps its noise seed, and the prefill's sample is
    # its first step
    assert int(core.sampling_state.seed[1]) == seed1
    assert int(core.sampling_state.step[1]) == step1 + 1
    assert int(core.cache.lengths[1]) == 111
    core.prefill_slots([prompt], [2], sp, seeds=[None],
                       bucket=core.resume_bucket_len(len(prompt)))
    assert keys[1] == (("admit", 32, 1), "resume")
    assert core.launches == {"resume": 2}
    assert {"capture_prefill_resume_128", "capture_prefill_32_r1"} <= set(
        core.graph_census_ms)


def test_resume_tier_prefills_one_row(rt, monkeypatch):
    """A resume-tier launch runs the model over its one slot, not the slot
    batch (two slots: two launches); it writes that slot's length and
    sampled state and leaves its neighbours' as they were, and the slot's
    cache and state equal a whole-batch admission prefill of the same
    prompt."""
    from tts_inference_tpu_torch.models import llama

    shapes = []
    forward = llama.forward

    def spy(params, cfg, tokens, *a, **kw):
        shapes.append(tuple(tokens.shape))
        return forward(params, cfg, tokens, *a, **kw)

    monkeypatch.setattr(llama, "forward", spy)
    core = port_sched(rt, on_demand(12)).core
    sp = tS.SamplingParams.from_config(port_config(SamplingConfig(
        token_range=AUDIO_RANGE)), core.batch)
    core.reset_and_seed([0], seeds=[9])
    core.prefill_slots([[P.TOKEN_SOS] + [300] * 20], [0], sp)
    before = (core.cache.lengths.clone(), [t.clone() for t in
                                           core.sampling_state])
    shapes.clear()
    prompts = [[P.TOKEN_SOS] + list(range(400, 470)),
               [P.TOKEN_SOS] + list(range(500, 590))]
    tok = core.prefill_slots(prompts, [2, 3], sp, seeds=[None, None],
                             bucket=128)
    assert shapes == [(1, 128), (1, 128)]
    assert core.launches == {"resume": 3}
    assert [int(x) for x in core.cache.lengths[[0, 2, 3]]] == [
        int(before[0][0]), 71, 91]
    for t, b in zip(core.sampling_state, before[1]):
        assert torch.equal(t[[0, 1]], b[[0, 1]])
    # the same prompt admitted over the slot batch, at the same bucket
    ref = port_sched(rt, on_demand(12)).core
    ref.reset_and_seed([3], seeds=[None])
    ref._maybe_reserve([3], 128, None, None)
    rtok, ss = ref._prefill_state(
        ref.sampling_state, ref._t(ref._prompt_batch(prompts[1:], [3], 128)[0],
                                   torch.int32),
        ref._t(ref._prompt_batch(prompts[1:], [3], 128)[1], torch.int32),
        sp, ref._t(ref._mask([3]), torch.bool))
    assert int(rtok[3]) == int(tok[3])
    for t, r in zip(core.sampling_state, ss):
        assert torch.equal(t[3], r[3])
    assert int(ref.cache.lengths[3]) == 91
    for li in range(len(core.cache.k)):
        for a, b in ((core.cache.k[li], ref.cache.k[li]),
                     (core.cache.v[li], ref.cache.v[li])):
            rows = [int(x) for x in core.cache.block_table[3, :3]]
            rrows = [int(x) for x in ref.cache.block_table[3, :3]]
            got = torch.cat([a[r] for r in rows], dim=1)[:, :91]
            want = torch.cat([b[r] for r in rrows], dim=1)[:, :91]
            assert torch.allclose(got.float(), want.float(), atol=1e-6,
                                  rtol=1e-5)


def _request(mod, text, max_tokens, greedy=False):
    # repetition penalty: presence is state a resume carries; stochastic
    # sampling adds the noise counter
    return mod.TTSRequest(text=text, sampling=for_side(mod, SamplingConfig(
        max_tokens=max_tokens, seed=123, greedy=greedy, temperature=0.8,
        top_p=0.9, repetition_penalty=1.15, token_range=AUDIO_RANGE)),
        stream_cfg=for_side(mod, SCFG), force_speech=True)


def _recording(sched):
    """Keep each finished request's raw token stream in `sched.finished`."""
    sched.finished = {}
    release = sched._release

    def _release(slot):
        st = sched.slots[slot]
        if st is not None:
            sched.finished[st.req.text] = list(st.token_ids)
        release(slot)

    sched._release = _release
    return sched


def _run(sched, reqs, max_iters=6000):
    for _ in range(max_iters):
        if not sched.step() and sched.n_queued == 0 and not sched.n_active:
            break
    else:
        raise AssertionError("scheduler did not drain")
    sched.drain_vocoder()
    out = []
    for r in reqs:
        chunks = []
        while True:
            kind, payload = r.events.get(timeout=120)
            if kind == "chunk":
                chunks.append(payload.pcm)
            elif kind == "done":
                out.append((b"".join(chunks), payload))
                break
            else:
                raise AssertionError(payload)
    sched.stop()
    return out


def test_pool_pressure_counts_one_resume_per_preemption(rt):
    """Two streams over a 5-block pool: every preemption is followed by one
    resume launch, and nothing else launches as a resume."""
    s = port_sched(rt, on_demand(5))
    ra, rb = (_request(TS, "older stream", 80),
              _request(TS, "younger stream", 80))
    s.submit(ra)
    s.step()
    s.submit(rb)
    (_, ma), (_, mb) = _run(s, [ra, rb])
    assert ma.tokens == mb.tokens == 80
    assert s.preemptions >= 1
    assert s.core.launches["resume"] == s.preemptions
    assert s.core.replays == {}     # the CPU runs the bodies eagerly


def _preempted(rt, cfg, req, at: int = 60):
    """Run `req` alone, preempting it after `at` tokens; returns (PCM,
    metrics, the scheduler, the keys its resumes launched)."""
    s = _recording(port_sched(rt, cfg))
    keys = []
    launch = s.core._launch

    def spy(key, kind=None, **inputs):
        if kind == "resume":
            keys.append(key)
        return launch(key, kind=kind, **inputs)

    s.core._launch = spy
    s.submit(req)
    for _ in range(200):
        s.step()
        live = [st for st in s.slots if st is not None]
        if live and len(live[0].token_ids) >= at:
            break
    s._drain_inflight()
    slot = next(i for i, st in enumerate(s.slots) if st is not None)
    st = s.slots[slot]
    assert len(st.prompt_ids) + len(st.token_ids) - 1 > 64
    s._preempt(slot)
    [(pcm, m)] = _run(s, [req])
    assert s.core.launches["resume"] == s.preemptions == 1
    return pcm, m, s, keys


def test_resume_tier_stream_is_byte_equal(rt):
    """A stochastic stream preempted after 60 tokens re-prefills prompt +
    generated (> 64 tokens) through the resume tier's 128 bucket, under its
    own key; its tokens and PCM equal the uninterrupted run's byte for
    byte."""
    cfg = on_demand(12)
    ref = _recording(port_sched(rt, cfg))
    r1 = _request(TS, "preempt me", 120)
    ref.submit(r1)
    [(pcm1, m1)] = _run(ref, [r1])
    pcm2, m2, s, keys = _preempted(rt, cfg, _request(TS, "preempt me", 120))
    assert keys == [("resume", 128)]
    assert m1.tokens == m2.tokens == 120 and pcm2 == pcm1
    assert s.finished == ref.finished


def test_resume_tier_stream_matches_jax(trees, rt):
    """The same through the resume tier with greedy sampling (the port's
    noise is its own): the preempted stream's tokens equal the JAX
    scheduler's uninterrupted run, its PCM within the 1 LSB that the two
    vocoders' f32 arithmetic may differ by (the bound of
    test_paged_int8_scheduler_matches_jax)."""
    cfg = on_demand(12)
    pcm, m, s, keys = _preempted(
        rt, cfg, _request(TS, "preempt me", 120, greedy=True))
    assert keys == [("resume", 128)]
    jsched = _recording(JS.Scheduler(to_jax(trees[0]), cfg,
                                     JSnac(to_jax(trees[1]), cfg.snac),
                                     ByteTokenizer()))
    r = _request(JS, "preempt me", 120, greedy=True)
    jsched.submit(r)
    [(jpcm, jm)] = _run(jsched, [r])
    assert jsched.finished == s.finished and jm.tokens == m.tokens == 120
    assert jm.frames == m.frames
    x = np.frombuffer(pcm, np.int16).astype(np.int32)
    y = np.frombuffer(jpcm, np.int16).astype(np.int32)
    assert x.shape == y.shape and x.size > 0
    assert np.abs(x - y).max() <= 1


def test_warmup_memory_needs_a_card(capsys):
    """tools/warmup_memory.py reads the card's allocator: without a card
    it exits 2 and prints no report."""
    from tts_inference_tpu_torch.tools import warmup_memory

    assert not torch.cuda.is_available()
    assert warmup_memory.main(["--tiny", "--device", "cpu"]) == 2
    assert capsys.readouterr().out == ""
