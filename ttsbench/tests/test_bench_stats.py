import pytest

from ttsbench import stats

JOB = {"loop": "open", "ramp_s": 1.0, "seconds": 10.0}


def _rec(due, chunks, error=None, sent=None):
    return {"due": due, "sent": due if sent is None else sent,
            "chunks": chunks, "error": error, "done": None}


def _stream(due, first, every, n, size=2048 * 2 * 5):
    return _rec(due, [(first + i * every, size) for i in range(n)])


def test_pct_is_the_nearest_rank_of_all_values():
    assert stats.pct(list(range(101)), 95) == 95
    assert stats.pct([5.0], 95) == 5.0
    assert stats.pct([], 95) is None


def test_gap_tail_is_over_all_gaps_and_a_stall_moves_it():
    smooth = [_stream(1.0 + i * 0.1, 1.5, 0.2, 40) for i in range(20)]
    out = {"t0": 0.0, "records": smooth}
    assert stats.pct(stats.gaps_ms(out, JOB), 95) == pytest.approx(200.0)
    # five of twenty streams stall: a chunk every second (7% of all gaps
    # in the window): the tail over all gaps reads the stall, where a
    # median of per-stream tails would read 200 ms
    for r in out["records"][:5]:
        r["chunks"] = [(1.5 + k, n) for k, (t, n) in enumerate(r["chunks"])]
    assert stats.pct(stats.gaps_ms(out, JOB), 95) == pytest.approx(1000.0)


def test_ttfa_from_due_time_and_failures():
    out = {"t0": 0.0, "records": [
        _rec(0.5, [(0.9, 10)]),               # ramp: not counted
        _rec(2.0, [(2.3, 10)], sent=2.1),     # late sender: counted from due
        _rec(3.0, [], error="boom"),          # failed
        _rec(4.0, []),                        # no first chunk: failed
        _rec(11.5, [(11.6, 10)]),             # after the window
    ]}
    assert stats.ttfa_ms(out, JOB) == [pytest.approx(300.0)]
    assert stats.counts(out, JOB) == (3, 2)


def test_audio_window_counts_partial_streams():
    job = dict(JOB, loop="closed")
    # 2 s of PCM before the window, 3 s inside, 1 s after
    sec = 48000
    out = {"t0": 0.0, "records": [
        _rec(0.1, [(0.5, 2 * sec), (2.0, 3 * sec), (12.0, sec)]),
        {"due": 5.0, "sent": 5.0, "chunks": [(6.0, 3 * sec)], "error": None,
         "done": None, "cut": True},
    ]}
    assert stats.audio_s_per_s(out, job) == pytest.approx(6.0 / 10.0)
    assert stats.counts(out, job) == (2, 0)
