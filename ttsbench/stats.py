"""The end-to-end numbers, from the load generator's records.

`pct` is the percentile rule of the repository's benchmark client
(nearest rank at round(p/100 · (n − 1)) of the sorted values), copied.
A run's window is [t0 + ramp, t0 + ramp + seconds) on the client's clock.
"""

from __future__ import annotations

from typing import Dict, List, Optional

SAMPLE_RATE = 24000


def pct(values: List[float], p: float) -> Optional[float]:
    if not values:
        return None
    xs = sorted(values)
    n = len(xs)
    return xs[min(n - 1, max(0, round(p / 100.0 * (n - 1))))]


def window(out: Dict, job: Dict) -> tuple:
    w0 = out["t0"] + job["ramp_s"]
    return w0, w0 + job["seconds"]


def due_in_window(out: Dict, job: Dict) -> List[Dict]:
    w0, w1 = window(out, job)
    return [r for r in out["records"] if w0 <= r["due"] < w1]


def ttfa_ms(out: Dict, job: Dict) -> List[float]:
    """Due → first binary message, for every request due in the window
    that has one; the others are failures."""
    return [(r["chunks"][0][0] - r["due"]) * 1e3
            for r in due_in_window(out, job) if r["chunks"]]


def gaps_ms(out: Dict, job: Dict) -> List[float]:
    """Every gap between two binary messages of one stream whose second
    message arrives in the window, over all streams."""
    w0, w1 = window(out, job)
    g = []
    for r in out["records"]:
        t = [c[0] for c in r["chunks"]]
        g += [(b - a) * 1e3 for a, b in zip(t, t[1:]) if w0 <= b < w1]
    return g


def audio_s_per_s(out: Dict, job: Dict) -> float:
    """PCM seconds received in the window, partial streams included, per
    second of the window."""
    w0, w1 = window(out, job)
    nbytes = sum(n for r in out["records"] for t, n in r["chunks"]
                 if w0 <= t < w1)
    return nbytes / 2 / SAMPLE_RATE / (w1 - w0)


def counts(out: Dict, job: Dict) -> tuple:
    """(attempted, failed). Open loop: the requests due in the window; a
    failure has an error or no first audio by the drain's end. Closed loop:
    the requests sent before the window's end; a failure has an error
    (a stream the client closed at the window's end is not one)."""
    if job["loop"] == "open":
        rs = due_in_window(out, job)
        return len(rs), sum(1 for r in rs if r["error"] or not r["chunks"])
    w1 = window(out, job)[1]
    rs = [r for r in out["records"] if r["sent"] < w1]
    return len(rs), sum(1 for r in rs if r["error"])
