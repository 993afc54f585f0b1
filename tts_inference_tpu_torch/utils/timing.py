"""Phase timing: the reference's perf_counter-at-every-boundary discipline
(SURVEY.md §5.1 — load split, TTFT, TTFA, per-chunk decode; exported in
result dicts and X-* headers) as a reusable utility. The port's copy of the
``PhaseTimer`` and ``maybe_profile`` of ``tts_inference_tpu/utils/timing.py``
(the trace is torch.profiler's, where the JAX package's is jax.profiler's);
profiling a decode step on the card is ``tools/step_profile.py``.
"""

from __future__ import annotations

import contextlib
import os
import sys
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
        verbose = os.environ.get("TTS_WARMUP_LOG")
        if verbose:
            print(f"[phase+] {name}", file=sys.stderr, flush=True)
        try:
            yield
        finally:
            dt = (time.perf_counter() - start) * 1000.0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if verbose:
                print(f"[phase-] {name} {dt:.0f} ms", file=sys.stderr,
                      flush=True)

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
