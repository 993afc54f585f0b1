"""A streaming-vs-batch audio artifact pair of the tiny model.

Port of ``tts_inference_tpu/tools/make_artifacts.py`` (its flags — the
device by ``--device`` — and JSON keys). The same request of the
fixed-seed tiny model is decoded (a) through the windowed streaming path,
chunk by chunk as ``/ws/tts`` emits it, and (b) in one batch window; both
are written as WAVs with the ``tools/audio_fidelity`` report of the pair,
and the gate is the reference's streaming-vs-batch contract (MSE < 1e-3,
max |diff| < 0.5, corr > 0.998) plus at most 2 PCM16 steps between the two.

Two differences from the JAX tool:

- ``--out`` defaults to ``build/artifacts_torch``: the repo's
  ``artifacts/`` holds the JAX package's pair;
- the port's ``compare_wavs`` compares the waveforms as read, in [-1, 1];
  the JAX tool's divides them by 32767 a second time (ROADMAP Queue 3, PR
  13 b), so wherever the two WAVs differ this report's ``mse`` and
  ``max_diff`` are 32767² and 32767 times the JAX tool's.

Usage:
    python -m tts_inference_tpu_torch.tools.make_artifacts [--device cpu]

Exits 0 when the gate passes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join("build", "artifacts_torch"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tokens", type=int, default=7 * 72,
                    help="output tokens (72 frames ≈ 6.1 s of audio)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; an error when there "
                         "is none — ask for the CPU with --device cpu)")
    args = ap.parse_args(argv)

    import numpy as np

    from tts_inference_tpu_torch import protocol as P
    from tts_inference_tpu_torch.config import (SamplingConfig, StreamConfig,
                                                tiny_config)
    from tts_inference_tpu_torch.runtime import Runtime
    from tts_inference_tpu_torch.tools.audio_fidelity import compare_wavs
    from tts_inference_tpu_torch.utils.audio import write_wav

    rt = Runtime.create(tiny_config(), seed=args.seed, device=args.device)
    text = "The quick brown fox jumps over the lazy dog."
    sampling = SamplingConfig(
        max_tokens=args.tokens, seed=args.seed + 7, temperature=0.8,
        top_p=0.95, repetition_penalty=1.1,
        token_range=(P.TOKEN_AUDIO_BASE, P.TOKEN_AUDIO_BASE + P.AUDIO_VOCAB),
    )
    # the geometry the streaming tests hold bit-equal to a batch decode
    stream_cfg = StreamConfig(frames_per_chunk=2, lookahead_frames=3,
                              left_context_frames=4)

    os.makedirs(args.out, exist_ok=True)
    # (a) streaming path: chunked windowed re-decode, as /ws/tts emits it
    chunks = list(rt.pipeline.stream(text, "tara", sampling, stream_cfg,
                                     force_speech=True))
    stream_pcm = b"".join(c.pcm for c in chunks)
    m_stream = rt.pipeline.last_metrics
    # (b) batch path: the same request decoded in ONE window
    batch_cfg = dataclasses.replace(stream_cfg, frames_per_chunk=10 ** 6)
    batch_pcm, m_batch = rt.pipeline.synthesize(
        text, "tara", sampling, batch_cfg, force_speech=True)

    p_stream = os.path.join(args.out, "tiny_stream.wav")
    p_batch = os.path.join(args.out, "tiny_batch.wav")
    write_wav(p_stream, stream_pcm)      # int16 PCM bytes
    write_wav(p_batch, batch_pcm)
    n_samples = len(stream_pcm) // 2

    report = compare_wavs(p_batch, p_stream)
    si = np.frombuffer(stream_pcm, np.int16).astype(np.int32)
    bi = np.frombuffer(batch_pcm, np.int16).astype(np.int32)
    mism = int(np.count_nonzero(si != bi)) if len(si) == len(bi) else -1
    max_lsb = int(np.abs(si - bi).max()) if len(si) == len(bi) else -1
    report["exactness"] = {
        "samples": len(si),
        "mismatched_samples": mism,
        "max_lsb_diff": max_lsb,
        "bit_exact": mism == 0,
    }
    report["request"] = {
        "text": text, "seed": sampling.seed, "tokens": m_stream.tokens,
        "chunks": len(chunks), "model": "tiny (fixed-seed synthetic)",
        "audio_s": round(n_samples / P.SAMPLE_RATE, 3),
        "device": str(rt.device),
    }
    ok = bool(report.get("pass", False)) and 0 <= max_lsb <= 2
    report["artifact_gate"] = {"passed": ok,
                               "criteria": "reference thresholds + <=2 LSB"}
    with open(os.path.join(args.out, "fidelity.json"), "w") as f:
        json.dump(report, f, indent=2, default=str)
    print(json.dumps({
        "stream_wav": p_stream, "batch_wav": p_batch,
        "passed": ok, "mismatched_samples": mism, "max_lsb_diff": max_lsb,
        "tokens": m_stream.tokens, "batch_tokens": m_batch.tokens,
        "chunks": len(chunks),
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
