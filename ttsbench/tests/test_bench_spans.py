"""The readers of the port's span log (`ttsbench/spans.py`) on synthetic
runs: device idle time put down to the scheduler's tick phases and the
vocoder launch thread, the admission's hold, and the wait for a slot;
None where there is nothing to read, 0.0 on an empty intersection."""

import pytest

from ttsbench import spans
from tts_inference_tpu_torch.utils.timing import SPANS


@pytest.fixture(autouse=True)
def log():
    SPANS.clear()
    SPANS.enable()
    yield SPANS
    SPANS.disable()
    SPANS.clear()


def _rec(name, t0, t1, thread="tts-scheduler", id=None, parent=None,
         extra=None):
    SPANS._spans.append((name, t0, t1, thread, id, parent, extra))


def _run():
    # one stretch [1000, 2000): busy 1000-1200 and 1500-1600, so idle
    # 1200-1500 and 1600-2000 (700 of 1000 ns)
    ops = [(1000, 200, "a", 1), (1500, 100, "b", 2)]
    return {"trace": {"spans": [(1000, 2000)], "ops": ops, "groups": [],
                      "linked": 2}}


def test_idle_time_put_down_to_the_scheduler_thread():
    _rec("sched.host_tokens", 1100, 1300)      # 100 idle
    _rec("sched.fetch", 1300, 1500, id=2)      # the blocking fetch: left out
    _rec("sched.admit_launch", 1550, 1700)     # 100 idle
    _rec("sched.vocode_plan", 1650, 1680)      # inside the one above
    _rec("sched.fused_pcm", 2500, 2600)        # outside the stretch
    assert spans.idle_sched_host_share(_run()) == pytest.approx(20.0)
    # a decode launch before a tick's fetch, outside the tick phases
    _rec("launch", 1800, 1900, id=3, extra={"kind": "decode"})
    assert spans.idle_sched_host_share(_run()) == pytest.approx(30.0)


def test_idle_time_put_down_to_the_vocoder_launch_thread():
    _rec("vocode.launch", 1250, 1350, thread="tts-vocoder")     # 100 idle
    _rec("vocode.launch", 1400, 1450, thread="tts-scheduler")   # first chunk
    _rec("vocode.launch", 1100, 1200, thread="tts-vocoder")     # device busy
    assert spans.idle_vocode_host_share(_run()) == pytest.approx(10.0)
    assert spans.idle_sched_host_share(_run()) == 0.0


def test_no_spans_read_nothing_and_no_overlap_reads_zero():
    assert spans.idle_sched_host_share(_run()) is None
    assert spans.idle_vocode_host_share(_run()) is None
    assert spans.admission_launch_ms(_run()) is None
    _rec("sched.host_tokens", 1000, 1200)      # only while the device ran
    assert spans.idle_sched_host_share(_run()) == 0.0
    assert spans.idle_vocode_host_share(_run()) == 0.0
    assert spans.idle_sched_host_share({"trace": None}) is None


def test_a_program_without_the_log_reads_nothing(monkeypatch):
    _rec("sched.host_tokens", 1100, 1300)
    monkeypatch.setattr(spans, "snapshot", lambda: [])
    assert spans.idle_sched_host_share(_run()) is None
    assert spans.admission_launch_ms(_run()) is None


def test_admission_launch_holds_until_its_fetch_ends():
    ms = 1_000_000
    # admission 5: a prefix build and the admission graph share its id;
    # fetched 40 ms after its first launch began
    _rec("launch", 10 * ms, 11 * ms, id=5, extra={"kind": "prefix_build"})
    _rec("launch", 12 * ms, 13 * ms, id=5, extra={"kind": "admit"})
    _rec("launch", 13 * ms, 14 * ms, id=5, extra={"kind": "decode"})
    _rec("admit", 12 * ms, 14 * ms, id=101, parent=5)
    _rec("admit", 12 * ms, 14 * ms, id=102, parent=5)
    _rec("sched.fetch", 45 * ms, 50 * ms, id=5)
    # a decode launch is no admission
    _rec("launch", 60 * ms, 61 * ms, id=6, extra={"kind": "decode"})
    _rec("sched.fetch", 61 * ms, 90 * ms, id=6)
    # admission 7: 20 ms
    _rec("launch", 100 * ms, 101 * ms, id=7, extra={"kind": "admit"})
    _rec("admit", 100 * ms, 101 * ms, id=103, parent=7)
    _rec("sched.fetch", 110 * ms, 120 * ms, id=7)
    # admission 8 is fetched after the first traced stretch starts
    _rec("launch", 900 * ms, 901 * ms, id=8, extra={"kind": "admit"})
    _rec("admit", 900 * ms, 901 * ms, id=104, parent=8)
    _rec("sched.fetch", 990 * ms, 1100 * ms, id=8)
    run = {"trace": {"spans": [(1000 * ms, 2000 * ms)], "ops": []}}
    assert spans.admission_launch_ms(run) == pytest.approx(30.0)
    # an admission not yet fetched is left out
    SPANS.clear()
    _rec("launch", 12 * ms, 13 * ms, id=5, extra={"kind": "admit"})
    _rec("admit", 12 * ms, 14 * ms, id=101, parent=5)
    assert spans.admission_launch_ms(run) is None


def test_queue_wait_reads_the_done_messages_kept():
    # window [5, 15); the untraced half ends at 10 on the client's clock
    def rec(due, first, queue_ms, tokens=70):
        server = {"tokens": tokens, "server_ttfa_ms": 300.0}
        if queue_ms is not None:
            server["server_queue_ms"] = queue_ms
        return {"due": due, "sent": due, "chunks": [(first, 100)],
                "max_tokens": 70, "server": server}

    out = {"t0": 0.0, "records": [rec(6.0, 6.5, 12.0), rec(7.0, 7.4, 30.0),
                                  rec(8.0, 8.2, 999.0, tokens=7),
                                  rec(9.0, 9.2, 20.0),
                                  rec(12.0, 12.9, 800.0)]}
    run = {"out": out, "job": {"ramp_s": 5.0, "seconds": 10.0},
           "quiet_until": 10.0}
    assert spans.queue_wait_ms(run) == pytest.approx(20.0)
    # done messages without the field (a program without it): nothing
    for r in out["records"]:
        r["server"].pop("server_queue_ms")
    assert spans.queue_wait_ms(run) is None


def test_interval_helpers():
    assert spans.union([(5, 8), (1, 3), (2, 4), (9, 9)]) == [(1, 4), (5, 8)]
    assert spans.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    red = _run()["trace"]
    assert spans.idle(red) == [(1200, 1500), (1600, 2000)]
