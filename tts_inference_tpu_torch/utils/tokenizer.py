"""Tokenizer abstraction: HF tokenizer when a checkpoint dir is available,
byte-level fallback when not (tests/bench run with zero downloadable assets).

The reference always tokenizes "voice: text" with the model's HF tokenizer
(`modal_audio_stream.py:244-269`); the envelope/special tokens are added as
raw IDs by `protocol.format_prompt_ids`, never by the tokenizer.
"""

from __future__ import annotations

from typing import List, Protocol


class TokenizerProtocol(Protocol):
    def encode(self, text: str) -> List[int]: ...
    def decode(self, ids: List[int]) -> str: ...


class ByteTokenizer:
    """Reversible byte-level tokenizer: id = byte + offset.

    Stands in for the Llama tokenizer when no checkpoint assets exist; keeps
    every id far below the special-token range so protocol invariants hold.
    """

    def __init__(self, offset: int = 256):
        self.offset = offset

    def encode(self, text: str) -> List[int]:
        return [b + self.offset for b in text.encode("utf-8")]

    def decode(self, ids: List[int]) -> str:
        return bytes(
            max(0, min(255, i - self.offset)) for i in ids
        ).decode("utf-8", errors="replace")


class HFTokenizer:
    """Thin wrapper over transformers AutoTokenizer (local files only)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids)


def load_tokenizer(path: str | None) -> TokenizerProtocol:
    if path:
        return HFTokenizer(path)
    return ByteTokenizer()
