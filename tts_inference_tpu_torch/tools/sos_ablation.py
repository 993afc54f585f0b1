"""SOS-pattern ablation: decode first-SOS vs last-SOS extraction for A/B.

Port of ``tts_inference_tpu/tools/sos_ablation.py`` (its functions, flags —
``--device`` for ``--cpu`` — and JSON keys). From a token dump (e.g. ``cli
dump-tokens`` output) it extracts the audio codes by both strategies,
decodes each with the port's vocoder and writes a WAV per strategy for a
listener's A/B, with the token census and each decode's audio sanity.

    python -m tts_inference_tpu_torch.tools.sos_ablation \\
        --tokens-json dump.json --tiny --device cpu --out-dir abl_out
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Sequence

import numpy as np

from tts_inference_tpu_torch import protocol as P
from tts_inference_tpu_torch.tools.analyze_tokens import audio_sanity, census
from tts_inference_tpu_torch.utils.audio import write_wav

STRATEGIES = ("first_sos", "last_sos")


def ablate(
    decoder, token_ids: Sequence[int], out_dir: str, noise_seed: int = 0
) -> Dict[str, Dict]:
    os.makedirs(out_dir, exist_ok=True)
    report: Dict[str, Dict] = {"census": census(token_ids)}
    for strategy in STRATEGIES:
        codes = P.extract_audio_codes(token_ids, strategy=strategy)
        n = len(codes) // P.FRAME_SIZE
        entry: Dict = {"codes": len(codes), "frames": n}
        if n:
            l1, l2, l3 = P.deinterleave_frames(np.asarray(codes, np.int32))
            audio = decoder.decode_frames(
                l1, l2, l3, noise_seed=noise_seed, first_frame=0
            )
            path = os.path.join(out_dir, f"ablation_{strategy}.wav")
            write_wav(path, np.clip(
                audio * 32767, -32768, 32767
            ).astype(np.int16).tobytes())
            entry["wav"] = path
            entry.update(audio_sanity(audio))
        report[strategy] = entry
    return report


def main(argv=None) -> int:
    from tts_inference_tpu_torch.tools.lookahead_sweep import load_decoder

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tokens-json", required=True)
    ap.add_argument("--out-dir", default="ablation_out")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--snac-path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; an error when there "
                         "is none — ask for the CPU with --device cpu)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    decoder = load_decoder(args.snac_path, args.tiny, args.seed, args.device)

    if args.tokens_json == "-":
        data = json.load(sys.stdin)
    else:
        with open(args.tokens_json) as f:
            data = json.load(f)
    ids = data["token_ids"] if isinstance(data, dict) else data
    print(json.dumps(ablate(decoder, ids, args.out_dir), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
