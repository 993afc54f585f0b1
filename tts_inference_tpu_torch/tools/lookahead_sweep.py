"""Lookahead ablation: streaming-vs-batch quality at 0/2/3/5/10/20 frames.

Port of ``tts_inference_tpu/tools/lookahead_sweep.py`` (its functions,
flags — ``--device`` for ``--cpu`` — and JSON keys), on the port's
``SnacDecoder`` and ``LookaheadStreamingDecoder``. The windowed decoder
with position-addressed noise equals the batch decode from lookahead 3
(within the summation-order noise of the device's convolutions); at 0–2
the table quantifies the edge error with the reference's metric set.

    python -m tts_inference_tpu_torch.tools.lookahead_sweep --tiny \\
        --device cpu --frames 40
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Sequence

import numpy as np

from tts_inference_tpu_torch import protocol as P
from tts_inference_tpu_torch.config import StreamConfig
from tts_inference_tpu_torch.models.snac import SnacDecoder
from tts_inference_tpu_torch.streaming.lookahead import \
    LookaheadStreamingDecoder


def quality_stats(a: np.ndarray, b: np.ndarray) -> Dict[str, float]:
    """The reference's streaming-quality metric set (MSE < 1e-3, corr >
    0.998, max |diff| < 0.5, std ratio > 0.95)."""
    n = min(len(a), len(b))
    a, b = a[:n].astype(np.float64), b[:n].astype(np.float64)
    mse = float(np.mean((a - b) ** 2))
    corr = float(np.corrcoef(a, b)[0, 1]) if a.std() > 0 and b.std() > 0 else 0.0
    return {
        "mse": mse,
        "correlation": corr,
        "max_diff": float(np.abs(a - b).max()),
        "std_ratio": float(a.std() / b.std()) if b.std() > 0 else 0.0,
        # a Python bool: the JAX tool's numpy bool fails its json.dumps
        "pass": bool(mse < 1e-3 and corr > 0.998
                     and float(np.abs(a - b).max()) < 0.5
                     and (b.std() == 0 or 0.95 < a.std() / b.std())),
    }


def sweep(
    decoder: SnacDecoder,
    codes: Sequence[int],
    lookaheads=(0, 2, 3, 5, 10, 20),
    frames_per_chunk: int = 5,
    left_context: int = 16,
    noise_seed: int = 0,
) -> Dict[int, Dict[str, float]]:
    l1, l2, l3 = P.deinterleave_frames(np.asarray(codes, np.int32))
    batch = decoder.decode_frames(l1, l2, l3, noise_seed=noise_seed,
                                  first_frame=0)
    out: Dict[int, Dict[str, float]] = {}
    for la in lookaheads:
        dec = LookaheadStreamingDecoder(
            decoder,
            StreamConfig(frames_per_chunk=frames_per_chunk,
                         lookahead_frames=la,
                         left_context_frames=left_context),
            noise_seed=noise_seed,
        )
        chunks = []
        for i in range(0, len(codes), P.FRAME_SIZE):
            dec.feed(codes[i : i + P.FRAME_SIZE])
            got = dec.poll()
            if got is not None:
                chunks.append(got)
        tail = dec.flush()
        if tail is not None:
            chunks.append(tail)
        stream = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        stats = quality_stats(stream, batch)
        stats["added_latency_ms"] = la * P.FRAME_MS
        out[la] = stats
    return out


def tiny_snac_config():
    """The tools' tiny vocoder (no assets): the JAX tools' SnacConfig."""
    from tts_inference_tpu_torch.config import SnacConfig

    return SnacConfig(latent_dim=32, decoder_dim=64, codebook_dim=4)


def load_decoder(snac_path, tiny: bool, seed: int, device) -> SnacDecoder:
    """A SNAC dir's decoder, else seeded random weights (the tiny vocoder
    with `tiny`, else SNAC 24 kHz) on `device` (None: the card)."""
    import torch

    from tts_inference_tpu_torch import weights
    from tts_inference_tpu_torch.config import SnacConfig
    from tts_inference_tpu_torch.runtime import default_device

    dev = torch.device(device) if device else default_device()
    if snac_path:
        from tts_inference_tpu_torch.models.loader import load_snac_checkpoint

        params, cfg = load_snac_checkpoint(snac_path, device=dev)
    else:
        cfg = tiny_snac_config() if tiny else SnacConfig()
        params = weights.init_snac_params(cfg, seed, dev)
    return SnacDecoder(params, cfg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="tiny random vocoder (no assets)")
    ap.add_argument("--snac-path", help="real SNAC checkpoint dir")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; an error when there "
                         "is none — ask for the CPU with --device cpu)")
    args = ap.parse_args(argv)
    decoder = load_decoder(args.snac_path, args.tiny, args.seed, args.device)

    rng = np.random.default_rng(args.seed)
    codes = []
    for _ in range(args.frames):
        for p in range(P.FRAME_SIZE):
            codes.append(int(rng.integers(0, decoder.cfg.codebook_size))
                         + P.POSITION_OFFSETS[p])
    table = sweep(decoder, codes)
    print(json.dumps({str(k): v for k, v in table.items()}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
