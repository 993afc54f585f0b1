"""The Orpheus token protocol, as the reference reads it: the prompt
envelope, the audio id range and the 7-code frame de-interleave."""

from __future__ import annotations

from typing import List

import numpy as np

SOH, EOT, EOH, SOS, DELIMITER = 128259, 128009, 128260, 128257, 128261
AUDIO_BASE = 128266
CODEBOOK = 4096
FRAME = 7
AUDIO_VOCAB = FRAME * CODEBOOK
AUDIO_RANGE = (AUDIO_BASE, AUDIO_BASE + AUDIO_VOCAB)
HEAD_BASE = 128000          # the port's sliced head starts at this row
BYTE_OFFSET = 256           # byte tokenizer: id = byte + 256


def prompt_ids(text: str, voice: str) -> List[int]:
    """`voice: text` as bytes, in the envelope of a speech-forcing
    request: SOH, text, EOT, EOH, DELIMITER, SOS."""
    ids = [b + BYTE_OFFSET for b in f"{voice}: {text}".encode("utf-8")]
    return [SOH, *ids, EOT, EOH, DELIMITER, SOS]


def layers_of(tokens) -> tuple:
    """Audio tokens → the SNAC codebook layers (n,), (2n,), (4n,) of the
    complete frames; codes out of their position's block are clamped."""
    codes = np.asarray(tokens, np.int64) - AUDIO_BASE
    n = len(codes) // FRAME
    f = codes[: n * FRAME].reshape(n, FRAME) - CODEBOOK * np.arange(FRAME)
    f = np.clip(f, 0, CODEBOOK - 1)
    return f[:, 0], f[:, [1, 4]].reshape(-1), f[:, [2, 3, 5, 6]].reshape(-1)
