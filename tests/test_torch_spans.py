"""The port's span log and scheduler counters, on the CPU:

- ``SpanLog`` records nothing while off, drops its oldest spans at its
  bound, keeps every append of three threads, and puts its spans on
  ``time.time_ns()``'s clock;
- a tiny scheduler run with ``enable_tick_profile()``: every request is
  admitted under a launch that is fetched, after its submission by its
  ``queue_ms``; every launch id has one ``sched.fetch``; the ``sched.*``
  spans sum to the tick profile's phases; the counters agree with the
  spans and the launch counts; the ``launch`` / ``vocode.launch`` spans
  agree launch for launch, on one clock, with a recorder wrapped around
  ``EngineCore._launch`` and ``SnacDecoder.run``;
- ``enable_tick_profile()`` empties the log, ``stop()`` turns it off, and
  without the profile the log stays empty;
- two concurrent ``/ws/tts`` streams each get their own done message
  (``tokens``, ``server_queue_ms``), and ``/metrics`` reports the counters.
"""

import asyncio
import collections
import json
import sys
import threading
import time

import pytest
import torch

aiohttp = pytest.importorskip("aiohttp")
from aiohttp import WSMsgType  # noqa: E402
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from tts_inference_tpu_torch.config import (SamplingConfig,  # noqa: E402
                                            StreamConfig, tiny_config)
from tts_inference_tpu_torch.engine.scheduler import (Scheduler,  # noqa: E402
                                                      TTSRequest)
from tts_inference_tpu_torch.runtime import Runtime  # noqa: E402
from tts_inference_tpu_torch.serving.app import (AUDIO_RANGE,  # noqa: E402
                                                 create_app)
from tts_inference_tpu_torch.streaming.pipeline import \
    StreamMetrics  # noqa: E402
from tts_inference_tpu_torch.utils.timing import SPANS, SpanLog  # noqa: E402

SCFG = StreamConfig(frames_per_chunk=2, lookahead_frames=3,
                    left_context_frames=4)
PHASES = ("fetch", "host_tokens", "fused_pcm", "vocode_plan", "admit_launch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs, beside other files'
    CPU-bound workers; the process's span log off and empty after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    SPANS.disable()
    SPANS.clear()


@pytest.fixture(scope="module")
def rt(_one_thread):
    return Runtime.create(tiny_config(), seed=0, device="cpu")


def _scheduler(rt):
    return Scheduler(rt.engine.core.params, rt.config, rt.vocoder,
                     rt.tokenizer, device="cpu")


def _serve(s):
    """Four streams of different lengths, the fourth submitted after six
    steps, stepped on this thread to the end; returns the requests and
    their done metrics."""
    reqs = [TTSRequest(
        text=f"span {i}", sampling=SamplingConfig(
            max_tokens=21 + 14 * i, seed=40 + i, token_range=AUDIO_RANGE),
        stream_cfg=SCFG, force_speech=True) for i in range(4)]
    for r in reqs[:3]:
        s.submit(r)
    for k in range(4000):
        if k == 6:
            s.submit(reqs[3])
        if not s.step() and k > 6 and s.n_queued == 0 and not s.n_active:
            break
    s.drain_vocoder()
    done = []
    for r in reqs:
        while True:
            kind, payload = r.events.get(timeout=120)
            if kind in ("done", "error"):
                assert kind == "done", payload
                done.append(payload)
                break
    s.stop()
    return reqs, done


class _Recorder:
    """The engine core's launches and the vocoder's calls, each as (the
    time it began on ``time.time_ns()``, its key's kind), recorded around
    ``EngineCore._launch`` and ``SnacDecoder.run`` until ``remove()``."""

    def __init__(self, core, vocoder):
        self.launches, self.vocodes = [], []
        self._undo = []
        for obj, name, out in ((core, "_launch", self.launches),
                               (vocoder, "run", self.vocodes)):
            orig = getattr(obj, name)

            def wrapped(key, *a, _orig=orig, _out=out, **k):
                _out.append((time.time_ns(), key[0]))
                return _orig(key, *a, **k)
            setattr(obj, name, wrapped)
            self._undo.append((obj, name))

    def remove(self):
        for obj, name in self._undo:
            delattr(obj, name)


@pytest.fixture(scope="module")
def traced(rt):
    """One profiled run with the recorder installed: (the scheduler, its
    requests, their done metrics, the recorder, the spans, whether the log
    was on after ``stop()``, the core's launch counts before the run)."""
    SPANS.disable()
    SPANS.clear()
    s = _scheduler(rt)
    rec = _Recorder(s.core, s.vocoder)
    before = (dict(s.core.launches), dict(s.vocoder.launches))
    s.enable_tick_profile()
    try:
        reqs, done = _serve(s)
        on_after_stop = SPANS.on
        spans = SPANS.snapshot()
    finally:
        rec.remove()
        SPANS.disable()
        SPANS.clear()
    return s, reqs, done, rec, spans, on_after_stop, before


def _named(spans, name):
    return [sp for sp in spans if sp[0] == name]


# -- SpanLog ---------------------------------------------------------------


def test_span_log_records_nothing_while_off():
    log = SpanLog()
    log.record("x", 1.0, 2.0)
    assert log.snapshot() == []
    log.enable()
    log.record("x", 1.0, 2.0, id=7, parent=5, extra={"k": 1})
    log.disable()
    log.record("z", 4.0, 5.0)
    (span,) = log.snapshot()
    assert span == ("x", log.ns(1.0), log.ns(2.0),
                    threading.current_thread().name, 7, 5, {"k": 1})
    assert span[2] - span[1] == 10 ** 9


def test_span_log_drops_its_oldest_spans_at_its_bound():
    log = SpanLog(maxlen=8)
    log.enable()
    for i in range(20):
        log.record("s", i, i + 1, id=i)
    assert [sp[4] for sp in log.snapshot()] == list(range(12, 20))
    log.clear()
    assert log.snapshot() == []


def test_span_log_keeps_the_appends_of_three_threads():
    log = SpanLog()
    log.enable()
    per = 20_000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda k=k: [
            log.record("s", i, i, id=(k, i)) for i in range(per)],
            name=f"w{k}") for k in range(3)]
        for t in threads:
            t.start()
        seen = []
        while any(t.is_alive() for t in threads):
            seen.append(len(log.snapshot()))    # copies while appended to
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    spans = log.snapshot()
    assert len(spans) == 3 * per
    for k in range(3):
        mine = [sp[4][1] for sp in spans if sp[3] == f"w{k}"]
        assert mine == list(range(per))
    assert seen == sorted(seen)


def test_span_log_is_on_the_wall_clock():
    """A span's ends are perf_counter readings on time.time_ns()'s clock
    (within 100 us: the offset is read once, bracketed)."""
    log = SpanLog()
    log.enable()
    for _ in range(50):
        a = time.time_ns()
        t = time.perf_counter()
        b = time.time_ns()
        log.record("x", t, t)
        (span,) = log.snapshot()
        log.clear()
        assert a - 100_000 <= span[1] <= b + 100_000


# -- a profiled scheduler run ------------------------------------------------


def test_each_request_is_admitted_under_a_fetched_launch(traced):
    _, reqs, done, _, spans, _, _ = traced
    fetched = {sp[4]: sp for sp in _named(spans, "sched.fetch")}
    for r, m in zip(reqs, done):
        (adm,) = [sp for sp in _named(spans, "admit") if sp[4] == r.id]
        assert adm[5] in fetched and adm[2] <= fetched[adm[5]][2]
        # submitted, waited queue_ms for its slot, then admitted
        assert m.queue_ms >= 0.0
        assert SPANS.ns(r.submitted_at) + m.queue_ms * 1e6 <= adm[1] + 1000
    assert len(_named(spans, "admit")) == len(reqs)


def test_every_launch_has_one_fetch_with_its_id(traced):
    _, _, _, _, spans, _, _ = traced
    launches = {sp[4] for sp in _named(spans, "launch")}
    fetched = [sp[4] for sp in _named(spans, "sched.fetch")]
    assert launches and sorted(fetched) == sorted(launches)
    first = {}
    for sp in _named(spans, "launch"):
        first.setdefault(sp[4], sp[1])
    for sp in _named(spans, "sched.fetch"):
        assert sp[1] >= first[sp[4]]


def test_sched_spans_sum_to_the_tick_profile(traced):
    s, _, _, _, spans, _, _ = traced
    prof = s.tick_profile
    for phase in PHASES:
        got = sum(sp[2] - sp[1] for sp in _named(spans, f"sched.{phase}"))
        assert got / 1e9 == pytest.approx(prof[f"{phase}_s"], rel=0.01,
                                          abs=1e-6), phase
    assert len(_named(spans, "sched.fetch")) == prof["ticks"]
    assert {sp[0] for sp in spans if sp[0].startswith("sched.")} \
        <= {f"sched.{p}" for p in PHASES}


def test_counters_agree_with_the_spans(traced):
    s, reqs, done, _, spans, _, (core0, voc0) = traced
    c = s.counters
    admitting = {sp[5] for sp in _named(spans, "admit")}
    assert c["admissions"] == len(admitting) >= 2
    assert c["admitted_rows"] == len(reqs) == c["queue_ms_count"]
    # each admission prefills its row bucket: its admitted rows, padded
    per_launch = collections.Counter(sp[5] for sp in _named(spans, "admit"))
    assert c["prefilled_rows"] == sum(
        s.core.row_bucket(n) for n in per_launch.values())
    assert c["admitted_rows"] <= c["prefilled_rows"] \
        < c["admissions"] * s.core.batch
    assert c["queue_ms_sum"] == pytest.approx(sum(m.queue_ms for m in done))
    decodes = [sp for sp in _named(spans, "launch")
               if sp[6]["kind"] == "decode"]
    assert s.core.launches["decode"] - core0.get("decode", 0) \
        == len(decodes)
    assert 0 < c["decode_rows"] <= len(decodes) * s.core.batch
    voc = _named(spans, "vocode.launch")
    assert sum(s.vocoder.launches.values()) - sum(voc0.values()) == len(voc)
    assert len(voc) <= c["vocoder_rows"] <= len(voc) * s.core.batch


def test_launch_spans_agree_with_a_launch_recorder(traced):
    _, _, _, rec, spans, _, _ = traced
    ours = _named(spans, "launch")
    assert [k for _, k in rec.launches] == [sp[6]["kind"] for sp in ours]
    assert {"admit", "decode"} <= {k for _, k in rec.launches}
    for (t, _), sp in zip(rec.launches, ours):
        assert t <= sp[1] <= sp[2]      # one clock: ours is inside theirs
    # the vocoder's calls, per kind (one thread launches each kind)
    voc = _named(spans, "vocode.launch")
    for kind in ("decode", "first_chunk"):
        theirs = [t for t, k in rec.vocodes if k == kind]
        o = [sp for sp in voc if sp[6]["kind"] == kind]
        assert theirs and len(theirs) == len(o), kind
        for t, sp in zip(theirs, o):
            assert sp[1] <= t <= sp[2]  # the call lies in our span
    assert {sp[3] for sp in voc if sp[6]["kind"] == "decode"} \
        == {"tts-vocoder"}


def test_profile_empties_the_log_and_stop_turns_it_off(rt, traced):
    assert traced[5] is False
    SPANS.enable()
    SPANS.record("left over", 1.0, 2.0)
    s = _scheduler(rt)
    s.stop()                    # no profile: the log is not this one's
    assert SPANS.on
    s.enable_tick_profile()
    assert SPANS.on and SPANS.snapshot() == []
    s.stop()
    assert not SPANS.on


def test_the_log_stays_empty_without_the_profile(rt):
    SPANS.disable()
    SPANS.clear()
    s = _scheduler(rt)
    _serve(s)
    assert s.tick_profile is None and SPANS.snapshot() == []
    assert s.counters["admissions"] >= 2 and s.counters["vocoder_rows"] > 0


# -- the server ------------------------------------------------------------


REQ = {"text": "two streams", "voice": "tara", "frames_per_chunk": 2,
       "benchmark": True, "force_speech": True, "audio_only": True,
       "lookahead_frames": 3, "seed": 7}


async def _ws_done(c, req):
    ws = await c.ws_connect("/ws/tts")
    await ws.send_json(req)
    while True:
        msg = await ws.receive(timeout=300)
        if msg.type == WSMsgType.TEXT:
            data = json.loads(msg.data)
            assert "error" not in data, data
            if data.get("done"):
                await ws.close()
                return data


def test_concurrent_streams_get_their_own_done_metrics(rt):
    s = _scheduler(rt)
    s.start()
    loop = asyncio.new_event_loop()
    app = create_app(rt, scheduler=s)
    server = app["server"]
    c = TestClient(TestServer(app), loop=loop)
    loop.run_until_complete(c.start_server())

    async def go():
        # what the server keeps for /metrics is no stream's done message
        shared = server.metrics
        server.metrics = lambda: StreamMetrics(tokens=-1)
        try:
            done = await asyncio.gather(
                _ws_done(c, dict(REQ, max_tokens=21)),
                _ws_done(c, dict(REQ, text="the second stream",
                                 max_tokens=84)))
        finally:
            server.metrics = shared
        m = await (await c.get("/metrics")).json()
        return done, m

    try:
        done, m = loop.run_until_complete(go())
    finally:
        loop.run_until_complete(c.close())
        loop.close()
        s.stop()
    assert [d["server_metrics"]["tokens"] for d in done] == [21, 84]
    # 7 tokens a frame of 2,048 samples at 24 kHz
    assert [d["duration_s"] for d in done] == [
        round(n / 7 * 2048 / 24000, 3) for n in (21, 84)]
    for d in done:
        assert d["server_metrics"]["server_queue_ms"] >= 0.0
    sch = m["scheduler"]
    assert sch["admitted_rows"] == 2 == sch["queue_ms_count"]
    assert sch["admissions"] >= 1 and sch["decode_rows"] >= 1
    assert sch["vocoder_rows"] >= 1 and sch["queue_ms_sum"] >= 0.0
    assert m["graphs"]["launches"]["decode"] >= 1
    assert m["last_request"]["tokens"] in (21, 84)
