"""The per-layer metrics' arithmetic. Each metric's reader,
`metrics/<name>.py`, names one of these; a reader that finds nothing to
read returns None and the metric is left out of the result.

`run` holds the model configuration (`model`), the load generator's
records (`out`) and the job (`job`), the end of the window's untraced
first half (`quiet_until`), the scheduler's tick profile over that half
(`tick`), the reduced trace of the traced stretches (`trace`,
`tracing.Trace.reduce`) and the recorded launch spans (`log`)."""

from __future__ import annotations

import statistics
from typing import Dict, Optional

from ttsbench import families, roofline, stats, tracing
from ttsbench.roofline import PEAK_FLOPS


def _done_in_window(run: Dict):
    """Requests due in the window whose first chunk came in its untraced
    first half (`quiet_until`, on the client's clock) and whose done
    message carries their own server metrics (the server's metrics slot
    is shared between streams, so one whose token count is not the
    request's is left out)."""
    until = run.get("quiet_until") or float("inf")
    return [r for r in stats.due_in_window(run["out"], run["job"])
            if r.get("server") and r["chunks"]
            and r["chunks"][0][0] < until
            and r["server"].get("tokens") == r["max_tokens"]]


def ws_hop_ms(run: Dict) -> Optional[float]:
    """Median of the client's TTFA from sending minus the server's TTFA
    (the server's clock starts at the request's admission)."""
    v = [(r["chunks"][0][0] - r["sent"]) * 1e3 - r["server"]["server_ttfa_ms"]
         for r in _done_in_window(run)]
    return statistics.median(v) if v else None


def server_ttft_ms(run: Dict) -> Optional[float]:
    v = [r["server"]["server_ttft_ms"] for r in _done_in_window(run)]
    return statistics.median(v) if v else None


def sched_host_ms_per_tick(run: Dict) -> Optional[float]:
    t = run.get("tick")
    if not t or not t.get("ticks"):
        return None
    host = (t["host_tokens_s"] + t["fused_pcm_s"] + t["vocode_plan_s"]
            + t["admit_launch_s"])
    return host / t["ticks"] * 1e3


def _decodes(run: Dict):
    tr = run.get("trace")
    if not tr or run.get("log") is None:
        return []
    return tracing.match(tr, run["log"].spans, "decode")


def _vocodes(run: Dict):
    tr = run.get("trace")
    if not tr or run.get("log") is None:
        return []
    return tracing.match(tr, run["log"].spans, "vocoder")


def decode_step_ms(run: Dict) -> Optional[float]:
    pairs = _decodes(run)
    steps = sum(s["n"] for _, s in pairs)
    return sum(g["dur_ns"] for g, _ in pairs) / steps / 1e6 if steps \
        else None


def step_mfu(run: Dict) -> Optional[float]:
    pairs = _decodes(run)
    dur = sum(g["dur_ns"] for g, _ in pairs) / 1e9
    if not dur:
        return None
    launch = families.of(run["model"]).decode_launch
    flops = sum(launch(run["model"], s)["flops"] for _, s in pairs)
    return 100.0 * flops / (dur * PEAK_FLOPS["bf16"])


def k1_roofline(run: Dict) -> Optional[float]:
    pairs = _decodes(run)
    t = sum(op[1] for g, _ in pairs for op in g["ops"]
            if tracing.K1.search(op[2])) / 1e9
    if not t:
        return None
    launch = families.of(run["model"]).decode_launch
    b = sum(launch(run["model"], s)["k1_bound_s"] for _, s in pairs)
    return 100.0 * b / t


def k6_roofline(run: Dict) -> Optional[float]:
    pairs = _vocodes(run)
    t = sum(op[1] for g, _ in pairs for op in g["ops"]
            if tracing.K6.search(op[2])) / 1e9
    if not t:
        return None
    b = sum(roofline.k6_call_bound_s(s["valid_latent"]) for _, s in pairs)
    return 100.0 * b / t


def vocode_ms_per_audio_s(run: Dict) -> Optional[float]:
    """Device ms of the traced vocoder calls per second of audio those
    calls decoded: each row's valid latent length / 4 frames of 2,048
    samples at 24 kHz (the window's left context and lookahead included),
    so time and audio come from the same calls."""
    pairs = _vocodes(run)
    ms = sum(g["dur_ns"] for g, _ in pairs) / 1e6
    frames = sum(v for _, s in pairs for v in s["valid_latent"]) \
        / roofline.LATENT_PER_FRAME
    audio = frames * roofline.SAMPLES_PER_FRAME / roofline.SAMPLE_RATE
    return ms / audio if audio and ms else None


def device_idle_share(run: Dict) -> Optional[float]:
    tr = run.get("trace")
    if not tr or not tr["ops"]:
        return None
    return 100.0 * (1.0 - tracing.busy_s(tr) / tracing.window_s(tr))
