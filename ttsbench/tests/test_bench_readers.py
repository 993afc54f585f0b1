"""The traced stretches' arithmetic: busy and window time summed over
stretches, idle gaps and matched launches only inside one, and the
vocoder's time per second of the audio its traced calls decoded."""

import pytest

from ttsbench import readers, tracing

# two stretches, [0, 100) and [1000, 1100) ns; groups: a vocoder graph in
# each, one decode graph between them (untraced)
OPS = [(10, 30, "residual_unit_kernel", 1), (60, 20, "x", 1),
       (500, 50, "attention_mma", 2),
       (1010, 30, "residual_unit_kernel", 3), (1070, 10, "y", 3)]


def _red():
    groups = [{"ops": [o for o in OPS if o[3] == cid], "kind": kind,
               "t": t, "dur_ns": sum(o[1] for o in OPS if o[3] == cid)}
              for cid, kind, t in ((1, "vocoder", 5), (2, "decode", 495),
                                   (3, "vocoder", 1005))]
    return {"spans": [(0, 100), (1000, 1100)], "ops": OPS,
            "groups": groups, "linked": len(OPS)}


def test_busy_and_window_sum_over_stretches():
    red = _red()
    assert tracing.window_s(red) == pytest.approx(200e-9)
    # 10-40, 60-80 | 1010-1040, 1070-1080
    assert tracing.busy_s(red) == pytest.approx(90e-9)


def test_idle_gaps_stay_inside_a_stretch():
    gaps = [g for _, g in tracing.breakdown(_red())["idle_gaps"]]
    assert sorted(gaps) == pytest.approx([20e-9, 30e-9])
    names = [n for n, _ in tracing.breakdown(_red())["device_ops"]]
    assert "attention_mma" not in names


def test_match_keeps_groups_inside_the_stretches():
    spans = [{"t": 1, "kind": "vocoder", "valid_latent": [8]},
             {"t": 400, "kind": "decode"},
             {"t": 1002, "kind": "vocoder", "valid_latent": [8, 0]}]
    got = tracing.match(_red(), spans, "vocoder")
    assert [s["t"] for _, s in got] == [1, 1002]
    assert tracing.match(_red(), spans, "decode") == []


def test_match_takes_no_span_of_another_stretch_or_kind():
    # the second stretch's vocoder graph was launched by an unrecorded
    # call: it may not take the first stretch's span
    assert [s["t"] for _, s in tracing.match(
        _red(), [{"t": 1, "kind": "vocoder", "valid_latent": [8]}],
        "vocoder")] == [1]
    # a graph whose latest span is another launch's (an admission that
    # also vocodes) takes none
    spans = [{"t": 1, "kind": "vocoder", "valid_latent": [8]},
             {"t": 1004, "kind": "admission"}]
    assert [s["t"] for _, s in tracing.match(_red(), spans, "vocoder")] \
        == [1]


def test_vocoder_time_per_decoded_audio_second():
    class Log:
        spans = [{"t": 1, "kind": "vocoder", "valid_latent": [8]},
                 {"t": 1002, "kind": "vocoder", "valid_latent": [8, 0]}]

    run = {"trace": _red(), "log": Log()}
    # 90 ns of device over 16 latent positions = 4 frames of 2,048
    # samples at 24 kHz
    audio_s = 4 * 2048 / 24000
    assert readers.vocode_ms_per_audio_s(run) == pytest.approx(
        90e-6 / audio_s)
    Log.spans = []
    assert readers.vocode_ms_per_audio_s(run) is None


def test_host_metrics_read_the_untraced_half_only():
    # window [5, 15); the untraced half ends at 10 on the client's clock
    def rec(due, first, ttfa_ms, tokens=70):
        return {"due": due, "sent": due, "chunks": [(first, 100)],
                "max_tokens": 70, "server": {"tokens": tokens,
                                             "server_ttfa_ms": ttfa_ms,
                                             "server_ttft_ms": ttfa_ms}}

    out = {"t0": 0.0, "records": [rec(6.0, 6.5, 300.0),
                                  rec(7.0, 7.4, 200.0),
                                  rec(8.0, 8.2, 999.0, tokens=7),
                                  rec(9.5, 10.5, 900.0),
                                  rec(12.0, 12.9, 800.0)]}
    run = {"out": out, "job": {"ramp_s": 5.0, "seconds": 10.0},
           "quiet_until": 10.0}
    assert readers.server_ttft_ms(run) == pytest.approx(250.0)
    # client TTFA 500 and 400 ms against 300 and 200 on the server
    assert readers.ws_hop_ms(run) == pytest.approx(200.0)
