"""Per-layer metrics read from the port's own span log
(`tts_inference_tpu_torch.utils.timing.SPANS`), which the scheduler turns on
with its tick profile at the window's start; read after the run.

A span is `(name, t0_ns, t1_ns, thread, id, parent, extra)` on
`time.time_ns()`'s clock, the clock of the profiler's device operations, so
host spans and the traced stretches' idle time intersect directly. On a program
without the log every reader here returns None; so does a reader that
finds no spans at all. An empty intersection reads 0.0."""

from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Optional

from ttsbench import readers, tracing

VOCODE_THREAD = "tts-vocoder"     # the vocode worker's launch thread


def snapshot() -> list:
    """The port's spans, oldest first; [] where the port has no span log."""
    try:
        from tts_inference_tpu_torch.utils.timing import SPANS
    except ImportError:
        return []
    return SPANS.snapshot()


def union(iv: List[tuple]) -> List[tuple]:
    """Sorted, merged intervals."""
    out: List[list] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [tuple(x) for x in out]


def overlap_ns(x: List[tuple], y: List[tuple]) -> int:
    """Length of the intersection of two sorted, merged interval lists."""
    i = j = tot = 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if b > a:
            tot += b - a
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle(red: Dict) -> List[tuple]:
    """The traced stretches' intervals in which no device operation ran
    (each stretch less `tracing.busy` inside it)."""
    out = []
    for a, b in red["spans"]:
        t = a
        for s, e in tracing.busy(red["ops"], a, b):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if b > t:
            out.append((t, b))
    return out


def idle_host_share(run: Dict, pick: Callable) -> Optional[float]:
    """% of the traced stretches' time in which the device was idle and a
    span that `pick(span)` keeps was open."""
    red = run.get("trace")
    spans = snapshot()
    if not red or not spans:
        return None
    window = sum(b - a for a, b in red["spans"])
    if not window:
        return None
    host = union([(s[1], s[2]) for s in spans if pick(s)])
    return 100.0 * overlap_ns(union(idle(red)), host) / window


def idle_sched_host_share(run: Dict) -> Optional[float]:
    """Device idle with the scheduler thread at host work: a tick phase
    other than the blocking fetch of a launch's tokens, or an engine
    launch (`launch`: input copies and the graph's launch; the decode
    launches that top up the pipeline before a tick's fetch lie outside
    every tick phase)."""
    return idle_host_share(run, lambda s: s[0] == "launch" or (
        s[0].startswith("sched.") and s[0] != "sched.fetch"))


def idle_vocode_host_share(run: Dict) -> Optional[float]:
    """Device idle with the vocoder launch thread packing and launching a
    batched window decode."""
    return idle_host_share(run, lambda s: s[0] == "vocode.launch"
                           and s[3] == VOCODE_THREAD)


def queue_wait_ms(run: Dict) -> Optional[float]:
    """Median `server_queue_ms` (submission → admission) of the requests
    `readers._done_in_window` keeps."""
    v = [r["server"]["server_queue_ms"] for r in readers._done_in_window(run)
         if "server_queue_ms" in r["server"]]
    return statistics.median(v) if v else None


def admission_launch_ms(run: Dict) -> Optional[float]:
    """Median, over the admissions of requests (the launch ids `admit`
    spans name as parent) whose `sched.fetch` ends before the first traced
    stretch starts, of the time from the admission's first `launch` span's
    start to the end of the `sched.fetch` span of its id: how long one
    admission holds every live stream."""
    spans = snapshot()
    red = run.get("trace")
    if not spans:
        return None
    until = red["spans"][0][0] if red and red["spans"] else float("inf")
    ids = {s[5] for s in spans if s[0] == "admit"}
    start: Dict[int, int] = {}
    end: Dict[int, int] = {}
    for s in spans:
        if s[4] not in ids:
            continue
        if s[0] == "launch":
            start[s[4]] = min(start.get(s[4], s[1]), s[1])
        elif s[0] == "sched.fetch":
            end[s[4]] = s[2]
    v = [(end[i] - start[i]) / 1e6 for i in start
         if i in end and end[i] <= until]
    return statistics.median(v) if v else None
