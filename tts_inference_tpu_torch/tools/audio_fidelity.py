"""Audio fidelity harness: waveform + log-mel spectral comparison.

The reference's quality contract for streaming-vs-batch equivalence is a
metric table with hard thresholds (MSE < 1e-3, max-diff < 0.5,
correlation > 0.998, std-ratio > 0.95 — `tensorrt_tts/
PIPELINE_REPORT.md:513-519`, validated in its missing
`test_streaming_audio_quality.py` per :699-709) plus human A/B listening on
saved WAVs (`helpers/compare_snac.py:493-505`). This module implements the
quantitative half for the TPU stack, extended with the log-mel spectral
distance the north star asks for ("matching mel-spectral fidelity"):

    python -m tts_inference_tpu_torch.tools.audio_fidelity a.wav b.wav
    python -m tts_inference_tpu_torch.tools.audio_fidelity --dir ours/ theirs/

The port's copy of ``tts_inference_tpu/tools/audio_fidelity.py``: the same
metrics, thresholds and report keys. One difference: ``compare_wavs``
compares the waveforms ``read_wav`` returns, already in [-1, 1]; the JAX
tool divides them by 32767 a second time, which shrinks ``mse`` by 32767²
and ``max_diff`` by 32767, so its two waveform gates pass whatever the
files hold (ROADMAP.md Queue 3).

Everything is plain numpy — the harness must run anywhere (CI, no JAX), and
spectrogram cost is negligible next to generation.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np

# reference thresholds (PIPELINE_REPORT.md:513-519)
THRESHOLDS = {
    "mse": 1e-3,           # <
    "max_diff": 0.5,       # <
    "corr": 0.998,         # >
    "std_ratio": 0.95,     # >
}
# mel-spectral gates (north-star "matching mel-spectral fidelity"). The
# spectrogram is dB-scaled with an 80 dB dynamic-range floor (librosa
# power_to_db convention); calibration on synthetic speech-like signals
# (tests/test_audio_fidelity.py): waveform noise at the reference's own
# passing level (MSE ~1.6e-5) → mel_mse ≈ 0.7 dB², mel_corr ≈ 0.997
# (passes); an 85 ms dropped chunk → mel_mse ≈ 313, corr ≈ 0.47 (fails).
MEL_THRESHOLDS = {
    "mel_mse": 10.0,       # < (dB²)
    "mel_corr": 0.99,      # >
}


def hz_to_mel(f: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(
    sr: int, n_fft: int, n_mels: int,
    fmin: float = 0.0, fmax: Optional[float] = None,
) -> np.ndarray:
    """(n_mels, n_fft//2+1) triangular mel filterbank (HTK mel scale)."""
    fmax = fmax or sr / 2.0
    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * hz / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lo, mid, hi = bins[i], bins[i + 1], bins[i + 2]
        if mid > lo:
            fb[i, lo:mid] = (np.arange(lo, mid) - lo) / (mid - lo)
        if hi > mid:
            fb[i, mid:hi] = (hi - np.arange(mid, hi)) / (hi - mid)
    return fb


def log_mel_spectrogram(
    wave: np.ndarray, sr: int = 24000, n_fft: int = 1024,
    hop: int = 256, n_mels: int = 80, top_db: float = 80.0,
) -> np.ndarray:
    """(n_mels, T) dB-scaled mel power spectrogram of a float waveform in
    [-1, 1], floored `top_db` below the peak (so inaudible energy in quiet
    bands can't dominate the distance)."""
    wave = np.asarray(wave, np.float64)
    if len(wave) < n_fft:
        wave = np.pad(wave, (0, n_fft - len(wave)))
    n_frames = 1 + (len(wave) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = wave[idx] * np.hanning(n_fft)[None, :]
    power = np.abs(np.fft.rfft(frames, axis=1)) ** 2  # (T, n_fft//2+1)
    mel = mel_filterbank(sr, n_fft, n_mels) @ power.T  # (n_mels, T)
    db = 10.0 * np.log10(np.maximum(mel, 1e-10))
    return np.maximum(db, db.max() - top_db)


def _align(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    n = min(len(a), len(b))
    return np.asarray(a[:n], np.float64), np.asarray(b[:n], np.float64)


def waveform_metrics(a: np.ndarray, b: np.ndarray) -> Dict[str, float]:
    """The reference's four-metric block on float waveforms in [-1, 1]."""
    a, b = _align(a, b)
    if len(a) == 0:
        return {"mse": float("inf"), "max_diff": float("inf"),
                "corr": 0.0, "std_ratio": 0.0, "length_ratio": 0.0}
    diff = a - b
    sa, sb = float(np.std(a)), float(np.std(b))
    if sa > 0 and sb > 0:
        corr = float(np.corrcoef(a, b)[0, 1])
    else:
        corr = 1.0 if np.allclose(a, b) else 0.0
    return {
        "mse": float(np.mean(diff ** 2)),
        "max_diff": float(np.max(np.abs(diff))),
        "corr": corr,
        "std_ratio": (min(sa, sb) / max(sa, sb)) if max(sa, sb) > 0 else 1.0,
        "length_ratio": 1.0,
    }


def mel_metrics(
    a: np.ndarray, b: np.ndarray, sr: int = 24000,
) -> Dict[str, float]:
    a, b = _align(a, b)
    ma, mb = log_mel_spectrogram(a, sr), log_mel_spectrogram(b, sr)
    t = min(ma.shape[1], mb.shape[1])
    ma, mb = ma[:, :t].ravel(), mb[:, :t].ravel()
    if np.std(ma) > 0 and np.std(mb) > 0:
        corr = float(np.corrcoef(ma, mb)[0, 1])
    else:
        corr = 1.0 if np.allclose(ma, mb) else 0.0
    return {
        "mel_mse": float(np.mean((ma - mb) ** 2)),
        "mel_max_diff": float(np.max(np.abs(ma - mb))),
        "mel_corr": corr,
    }


def fidelity_report(
    a: np.ndarray, b: np.ndarray, sr: int = 24000,
) -> Dict[str, object]:
    """Full metric block + per-threshold pass flags + overall verdict."""
    wf = waveform_metrics(a, b)
    mel = mel_metrics(a, b, sr)
    checks = {
        "mse": wf["mse"] < THRESHOLDS["mse"],
        "max_diff": wf["max_diff"] < THRESHOLDS["max_diff"],
        "corr": wf["corr"] > THRESHOLDS["corr"],
        "std_ratio": wf["std_ratio"] > THRESHOLDS["std_ratio"],
        "mel_mse": mel["mel_mse"] < MEL_THRESHOLDS["mel_mse"],
        "mel_corr": mel["mel_corr"] > MEL_THRESHOLDS["mel_corr"],
    }
    n_a, n_b = len(a), len(b)
    return {
        **wf, **mel,
        "samples_a": n_a, "samples_b": n_b,
        "duration_s_a": round(n_a / sr, 3),
        "duration_s_b": round(n_b / sr, 3),
        "checks": checks,
        "pass": all(checks.values()),
    }


def compare_wavs(path_a: str, path_b: str) -> Dict[str, object]:
    from tts_inference_tpu_torch.utils.audio import read_wav

    a, sr_a = read_wav(path_a)      # PCM16 / 32767: in [-1, 1] already
    b, sr_b = read_wav(path_b)
    if sr_a != sr_b:
        raise ValueError(f"sample-rate mismatch: {sr_a} vs {sr_b}")
    rep = fidelity_report(a.astype(np.float64), b.astype(np.float64), sr_a)
    rep["a"], rep["b"], rep["sample_rate"] = path_a, path_b, sr_a
    return rep


def compare_dirs(dir_a: str, dir_b: str) -> Dict[str, object]:
    """Compare same-named WAVs across two dirs (ours vs the reference's
    `vllm_inference/out/` / `plot_metrics/output/` artifacts)."""
    names = sorted(
        f for f in os.listdir(dir_a)
        if f.endswith(".wav") and os.path.exists(os.path.join(dir_b, f))
    )
    reports = {
        n: compare_wavs(os.path.join(dir_a, n), os.path.join(dir_b, n))
        for n in names
    }
    return {
        "pairs": len(reports),
        "pass": bool(reports) and all(r["pass"] for r in reports.values()),
        "reports": reports,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="waveform + log-mel fidelity comparison"
    )
    ap.add_argument("a", help="WAV file (or dir with --dir)")
    ap.add_argument("b", help="WAV file (or dir with --dir)")
    ap.add_argument("--dir", action="store_true",
                    help="compare same-named WAVs across two directories")
    args = ap.parse_args(argv)
    rep = compare_dirs(args.a, args.b) if args.dir else \
        compare_wavs(args.a, args.b)
    print(json.dumps(rep, indent=2, default=str))
    return 0 if rep["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
