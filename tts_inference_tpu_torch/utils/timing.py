"""Phase timing: the reference's perf_counter-at-every-boundary discipline
(SURVEY.md §5.1 — load split, TTFT, TTFA, per-chunk decode; exported in
result dicts and X-* headers) as a reusable utility. The port's copy of the
``PhaseTimer`` and ``maybe_profile`` of ``tts_inference_tpu/utils/timing.py``
(the trace is torch.profiler's, where the JAX package's is jax.profiler's);
profiling a decode step on the card is ``tools/step_profile.py``.

``SPANS`` is the serving path's span log (``SpanLog``): the scheduler, the
engine core and the vocode worker record their boundaries into it while it
is on (``Scheduler.enable_tick_profile`` empties it and turns it on,
``Scheduler.stop`` turns it off).
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, List, Optional


class PhaseTimer:
    """Accumulates named phase durations (ms) and point-in-time marks."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.phases: Dict[str, float] = {}
        self.marks: Dict[str, float] = {}
        self.series: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - start) * 1000.0
            self.phases[name] = self.phases.get(name, 0.0) + dt

    def mark(self, name: str) -> float:
        """Record time since construction (ms) the first time `name` fires."""
        if name not in self.marks:
            self.marks[name] = (time.perf_counter() - self.t0) * 1000.0
        return self.marks[name]

    def push(self, name: str, value_ms: float) -> None:
        self.series.setdefault(name, []).append(value_ms)

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1000.0

    def as_dict(self) -> Dict[str, object]:
        out: Dict[str, object] = dict(self.phases)
        out.update({f"{k}": v for k, v in self.marks.items()})
        for k, v in self.series.items():
            out[k] = v
        return out


class SpanLog:
    """A bounded in-memory log of spans, off until ``enable()``.

    A span is the tuple ``(name, t0_ns, t1_ns, thread, id, parent,
    extra)``: its start and end, the recording thread's name, the
    request's or launch's id, the id of what caused it, and a dict of what
    else it carries (or None). Its ends are ``time.perf_counter()``
    readings (``ns``) moved onto ``time.time_ns()``, the clock of
    torch.profiler's device events, by the offset read at ``enable()``:
    spans and device operations compare directly, and a step of the wall
    clock never shows up as a duration. Appends go to a
    ``collections.deque`` with ``maxlen``, atomic under the interpreter
    lock, so recording threads take no lock and the oldest spans drop once
    the log is full. A record point tests ``on`` before it computes
    anything, so while the log is off it costs one attribute test."""

    def __init__(self, maxlen: int = 2 ** 18):
        self.on = False
        self._offset = 0
        self._spans: collections.deque = collections.deque(maxlen=maxlen)

    def enable(self) -> None:
        # the offset from the tightest of five bracketed readings
        best = None
        for _ in range(5):
            a, p, b = time.time_ns(), time.perf_counter_ns(), time.time_ns()
            if best is None or b - a < best[0]:
                best = (b - a, (a + b) // 2 - p)
        self._offset = best[1]
        self.on = True

    def disable(self) -> None:
        self.on = False

    def clear(self) -> None:
        self._spans.clear()

    def ns(self, t: float) -> int:
        """A ``time.perf_counter()`` reading on the log's clock."""
        return int(t * 1e9) + self._offset

    def record(self, name: str, t0: float, t1: float, id=None, parent=None,
               extra: Optional[dict] = None) -> None:
        """A span from ``time.perf_counter()`` readings `t0` to `t1`."""
        if not self.on:
            return
        self._spans.append((name, self.ns(t0), self.ns(t1),
                            threading.current_thread().name, id, parent,
                            extra))

    def snapshot(self) -> list:
        """The spans held, oldest first (a copy)."""
        while True:
            try:
                return list(self._spans)
            except RuntimeError:    # appended to while copied: copy again
                continue


SPANS = SpanLog()


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str], name: str = "trace"):
    """torch.profiler over the block, written on exit as a Chrome trace,
    ``<trace_dir>/<name>.json`` (``export_chrome_trace``); the host's ops,
    and the card's kernels where there is a card. Yields the profiler;
    without `trace_dir`, nothing is traced and it yields None."""
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))
