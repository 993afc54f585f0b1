"""16-bit-vocoder fidelity bound: same codes, f32 vs bf16 (or float16) conv stack.

Port of ``tts_inference_tpu/tools/vocoder_dtype_fidelity.py``, the gate the
JAX package names for ``--vocoder-bf16`` (SnacConfig.dtype="bfloat16"):
its audio error must stay inside the reference's streaming-vs-batch bounds
(MSE < 1e-3, max |diff| < 0.5, corr > 0.998, std-ratio within 0.95 —
reference: tensorrt_tts/PIPELINE_REPORT.md:513-519). The tool decodes the
SAME fixed-seed codes through the full-geometry decoder in float32 and in
bfloat16 (on the card: K6's f32 kernel and the 16-bit body) and reports
those four metrics waveform to waveform, under the JAX tool's JSON keys;
``--dtype float16`` holds the float16 decode to the same gate.

The weights are seeded random (``weights.init_snac_params``; no released
checkpoint is in the repo), so the numbers bound the RELATIVE dtype error
of the conv arithmetic, not perceptual quality.

Usage:
    python -m tts_inference_tpu_torch.tools.vocoder_dtype_fidelity    # card
    python -m tts_inference_tpu_torch.tools.vocoder_dtype_fidelity --tiny \\
        --cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

THRESHOLDS = {"mse": 1e-3, "max_diff": 0.5, "corr": 0.998, "std_ratio": 0.95}


def fidelity(a: np.ndarray, b: np.ndarray) -> dict:
    """The four metrics of decode `b` against decode `a` (flattened, f64)
    and whether they pass THRESHOLDS."""
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    mse = float(np.mean((a - b) ** 2))
    report = {"mse": mse, "max_diff": float(np.max(np.abs(a - b))),
              "corr": float(np.corrcoef(a, b)[0, 1]),
              "std_ratio": float(np.std(b) / np.std(a)),
              "thresholds": dict(THRESHOLDS)}
    t = THRESHOLDS
    report["pass"] = bool(
        mse < t["mse"] and report["max_diff"] < t["max_diff"]
        and report["corr"] > t["corr"]
        and t["std_ratio"] < report["std_ratio"] < 1.0 / t["std_ratio"])
    return report


def run(frames: int = 64, batch: int = 4, seed: int = 0, tiny: bool = False,
        device=None, dtype: str = "bfloat16") -> dict:
    """The report: `batch` rows of `frames` frames of seeded codes through
    the seeded decoder in float32 and in `dtype` (bfloat16, the JAX tool's
    case, or float16) on `device` (default: the card)."""
    from tts_inference_tpu_torch import weights
    from tts_inference_tpu_torch.config import SnacConfig, tiny_config
    from tts_inference_tpu_torch.models import snac as snac_lib
    from tts_inference_tpu_torch.runtime import default_device

    dev = torch.device(device) if device is not None else default_device()
    cfg = tiny_config().snac if tiny else SnacConfig()
    params = weights.init_snac_params(cfg, seed, dev)
    rng = np.random.default_rng(seed)
    n_lat = frames * 4          # one 7-code frame = 4 latent steps
    codes = [
        rng.integers(0, cfg.codebook_size,
                     size=(batch, n_lat // s)).astype(np.int64)
        for s in cfg.vq_strides
    ]
    outs = {}
    with torch.no_grad():
        for dt in ("float32", dtype):
            dec = snac_lib.SnacDecoder(
                params, dataclasses.replace(cfg, dtype=dt), graphs=False)
            wav = snac_lib.decode_codes(
                dec.params, dec.cfg,
                [torch.from_numpy(c).to(dev) for c in codes], noise_seed=0)
            outs[dt] = wav.cpu().numpy()
    return {"geometry": "tiny" if tiny else "full", "frames": frames,
            "batch": batch, **fidelity(outs["float32"], outs[dtype])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the same as --device cpu)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; an error when there "
                         "is none)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float16"),
                    help="the 16-bit decode held against f32 (the JAX tool "
                         "has bfloat16 only)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.frames, args.batch, args.seed, args.tiny,
                         "cpu" if args.cpu else args.device, args.dtype)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
