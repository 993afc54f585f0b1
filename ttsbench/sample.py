"""Which finished requests the correctness check compares: drawn from the
seed, with the longest greedy request always among them. Used by the load
generator (which returns their audio) and by the check."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def choose(finished: List[Dict], seed: int, greedy: int,
           sampled: int) -> List[int]:
    """Ids of the requests to compare: the longest greedy one, then
    `greedy` − 1 more greedy ones and `sampled` sampling ones, drawn."""
    rng = np.random.default_rng(np.random.PCG64(seed ^ 0x5EED))
    g = sorted((r for r in finished if r["greedy"]),
               key=lambda r: (-r["max_tokens"], r["id"]))
    s = sorted((r["id"] for r in finished if not r["greedy"]))
    if greedy <= 0:
        g = []
    out = [g[0]["id"]] if g else []
    rest = sorted(r["id"] for r in g[1:])
    if rest and greedy > 1:
        out += [int(i) for i in rng.choice(
            rest, size=min(greedy - 1, len(rest)), replace=False)]
    if s and sampled > 0:
        out += [int(i) for i in rng.choice(
            s, size=min(sampled, len(s)), replace=False)]
    return out
