"""The one traffic generator: a mix's parameters and a seed → requests.

Every seed gets the same set of sizes and gaps, in another order: lengths
and inter-arrival gaps are the distribution's quantiles at (i + 0.5) / n,
shuffled by the seed, so two seeds differ in the order of the work and
never in its amount. Texts are ASCII words of a drawn byte length, opened
by a request tag that makes every text unique (the server side keys its
records by the text).

Imports neither torch nor the port: the load generator runs it too.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from statistics import NormalDist
from typing import Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parent
SAMPLE_RATE = 24000
SAMPLES_PER_FRAME = 2048
FRAME_SIZE = 7
WORDS = ("the quick brown fox jumps over a lazy dog while seven bright "
         "voices read every line of this long chapter aloud to listeners "
         "who wait for the next turn of the story and then answer").split()


def load(name: str) -> Dict:
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def _quantiles(spec: Dict, n: int) -> np.ndarray:
    """n values of the distribution `spec` at the quantiles (i + 0.5) / n."""
    q = (np.arange(n) + 0.5) / n
    if spec["dist"] == "uniform":
        v = spec["min"] + q * (spec["max"] - spec["min"])
    elif spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in q])
        v = spec["median"] * np.exp(spec["sigma"] * z)
    else:
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    return np.clip(v, spec["min"], spec["max"])


def frames_of(audio_s: float) -> int:
    return max(1, int(round(audio_s * SAMPLE_RATE / SAMPLES_PER_FRAME)))


def _text(rng: np.random.Generator, idx: int, nbytes: int) -> str:
    out = f"r{idx:05d}"
    while len(out) < nbytes:
        out += " " + WORDS[int(rng.integers(len(WORDS)))]
    out = out[:nbytes]
    return out[:-1] + "s" if out.endswith(" ") else out


def _requests(mix: Dict, rng: np.random.Generator, n: int) -> List[Dict]:
    frames = [frames_of(a) for a in _quantiles(mix["audio_s"], n)]
    nbytes = [int(round(b)) for b in _quantiles(mix["text_bytes"], n)]
    greedy = [i < round(n * mix["greedy_share"]) for i in range(n)]
    for vals in (frames, nbytes, greedy):
        rng.shuffle(vals)
    return [{"id": i, "text": _text(rng, i, nbytes[i]),
             "voice": mix.get("voice", "tara"),
             "max_tokens": frames[i] * FRAME_SIZE, "greedy": bool(greedy[i])}
            for i in range(n)]


def generate(mix: Dict, seed: int, seconds: float) -> Dict:
    """The run's requests. Open loop: `requests` with a due offset `due_s`
    from the start of the ramp, through the ramp and the window. Closed
    loop: `clients` lists of requests, each client's start offset in
    `starts_s`."""
    rng = np.random.default_rng(np.random.PCG64(seed))
    ramp = float(mix["ramp_s"])
    if mix["loop"] == "open":
        rate = float(mix["rate_per_s"])
        n = max(1, int(round(rate * (ramp + seconds))))
        gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
        rng.shuffle(gaps)
        due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        # the same span for every seed: scale onto ramp + window
        due *= (ramp + seconds) * (n - 1) / n / max(due[-1], 1e-9) \
            if n > 1 else 1.0
        reqs = _requests(mix, rng, n)
        for r, d in zip(reqs, due):
            r["due_s"] = float(d)
        return {"loop": "open", "ramp_s": ramp, "seconds": seconds,
                "requests": reqs}
    clients = int(mix["clients"])
    lo = float(mix["audio_s"]["min"])
    per_client = int(math.ceil((ramp + seconds) / lo)) + 2
    reqs = _requests(mix, rng, clients * per_client)
    return {"loop": "closed", "ramp_s": ramp, "seconds": seconds,
            "starts_s": [ramp * c / clients for c in range(clients)],
            "clients": [reqs[c::clients] for c in range(clients)]}
