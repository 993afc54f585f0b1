"""PCM/WAV utilities (24 kHz 16-bit mono, the reference's output format)."""

from __future__ import annotations

import io
import wave
from typing import Tuple

import numpy as np

from tts_inference_tpu_torch import protocol


def pcm16_bytes(audio: np.ndarray) -> bytes:
    """float [-1,1] or int16 array → little-endian PCM16 bytes."""
    a = np.asarray(audio)
    if a.dtype != np.int16:
        a = np.clip(a * 32767.0, -32768, 32767).astype(np.int16)
    return a.tobytes()


def wav_bytes(pcm: bytes, sample_rate: int = protocol.SAMPLE_RATE) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm)
    return buf.getvalue()


def write_wav(path: str, pcm: bytes,
              sample_rate: int = protocol.SAMPLE_RATE) -> None:
    with open(path, "wb") as f:
        f.write(wav_bytes(pcm, sample_rate))


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        data = w.readframes(n)
        rate = w.getframerate()
    audio = np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32767.0
    return audio, rate


def duration_s(pcm: bytes, sample_rate: int = protocol.SAMPLE_RATE) -> float:
    return (len(pcm) // 2) / sample_rate
