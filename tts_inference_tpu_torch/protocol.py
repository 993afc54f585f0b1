"""Orpheus token protocol: constants, prompt format, extraction, de-interleave.

This is the cross-cutting invariant layer of the whole stack (reference:
`vllm_inference/modal_audio_stream.py:97-103`, `tensorrt_tts/inference.py:43-51`,
`tensorrt_tts/hindi_canopy/inference.py:36-44`). The reference declares these
constants in 8+ files; here they live exactly once.

The model is a Llama-3.2-3B causal LM whose vocabulary is extended with audio
codec tokens. Text is wrapped in a special-token prompt, the LM emits 7-token
"frames" of SNAC codes, and the codes de-interleave into SNAC's 3 hierarchical
codebook layers (1 + 2 + 4 codes per frame).

Pure Python/numpy, so the serving layer can import it cheaply. The port's own
copy of ``tts_inference_tpu/protocol.py``, held to it by the tests.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np

# --- Special token IDs (reference: modal_audio_stream.py:97-103) -----------
TOKEN_SOH = 128259          # Start of Human  (prompt start)
TOKEN_EOT = 128009          # End of Text
TOKEN_EOH = 128260          # End of Human    (prompt end)
TOKEN_SOS = 128257          # Start of Speech (gate: audio tokens follow)
TOKEN_EOS = 128258          # End of Speech   (stop generation)
TOKEN_DELIMITER = 128261    # Delimiter (appears between multi-SOS segments)
TOKEN_AUDIO_BASE = 128266   # code = token_id - TOKEN_AUDIO_BASE - 4096*pos

# Every token a TTS generation can legitimately emit — Llama specials
# (128000-128255), SOS/EOS/delimiters (128256-128265), and the audio vocab
# (128266+) — sits at or above this id. The decode hot path exploits that:
# with `EngineConfig.sliced_head` the LM head only computes logits for rows
# [HEAD_SLICE_BASE, vocab), skipping the 128,000 plain-text rows (the reference instead computes the
# full head and lets its extractor DROP sub-audio tokens after the fact,
# tensorrt_tts/inference.py:54-93).
HEAD_SLICE_BASE = 128000

# --- Frame / codec geometry (reference: spec.md:11-45) ----------------------
FRAME_SIZE = 7              # LM tokens per audio frame
SAMPLE_RATE = 24000         # Hz
SAMPLES_PER_FRAME = 2048    # PCM samples decoded per frame (~85.33 ms)
FRAME_MS = SAMPLES_PER_FRAME / SAMPLE_RATE * 1000.0  # 85.333… ms
CODEBOOK_SIZE = 4096        # per-codebook entries in SNAC
NUM_CODEBOOKS = 3           # hierarchical SNAC codebooks (strides 4/2/1)
AUDIO_VOCAB = FRAME_SIZE * CODEBOOK_SIZE  # 28672 audio tokens

# Per-position offsets within a frame: position p carries code + 4096*p
# (reference: tensorrt_tts/inference.py:54-93 POSITION_OFFSETS).
POSITION_OFFSETS = tuple(p * CODEBOOK_SIZE for p in range(FRAME_SIZE))

# Frame position → SNAC layer routing (reference: modal_audio_stream.py:160-180):
#   layer 1 (coarse, 1/frame):  position 0
#   layer 2 (mid,    2/frame):  positions 1, 4
#   layer 3 (fine,   4/frame):  positions 2, 3, 5, 6
LAYER_OF_POSITION = (0, 1, 2, 2, 1, 2, 2)

# Default sampling (reference: tensorrt_tts/inference.py:209-217 — the comment
# "repetition_penalty=1.1 is critical for proper audio generation").
DEFAULT_TEMPERATURE = 0.6
DEFAULT_TOP_P = 0.95
DEFAULT_REPETITION_PENALTY = 1.1
DEFAULT_MAX_TOKENS = 1200

# Lookahead emission rule (reference: PIPELINE_REPORT.md:496-519): emit only
# samples with >= 5 frames of future context.
DEFAULT_LOOKAHEAD_FRAMES = 5

# Capacity limits (reference: spec.md:133-135).
MAX_TEXT_CHARS = 2000
MAX_AUDIO_SECONDS = 120


def format_prompt_ids(
    text_ids: Sequence[int],
    *,
    force_speech: bool = False,
) -> List[int]:
    """Wrap tokenized "voice: text" in the Orpheus special-token envelope.

    ``[SOH] + ids + [EOT, EOH]`` (reference: modal_audio_stream.py:244-269).
    With ``force_speech`` a trailing ``[DELIMITER, SOS]`` is appended to force
    immediate speech (reference: helpers/compare_snac.py:61-63).
    """
    ids = [TOKEN_SOH, *text_ids, TOKEN_EOT, TOKEN_EOH]
    if force_speech:
        ids += [TOKEN_DELIMITER, TOKEN_SOS]
    return ids


def format_prompt_text(text: str, voice: str = "tara") -> str:
    """The raw text that gets tokenized: ``"{voice}: {text}"``."""
    return f"{voice}: {text}"


def audio_duration_s(num_tokens: int) -> float:
    """Audio seconds produced by `num_tokens` LM tokens (complete frames only).

    Reference capacity math: ``max_duration = (tokens//7)*0.085``
    (hindi_canopy/build_engine.py:158-162).
    """
    return (num_tokens // FRAME_SIZE) * SAMPLES_PER_FRAME / SAMPLE_RATE


# ---------------------------------------------------------------------------
# Streaming extraction state machine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TokenExtractor:
    """Streaming SOS/EOS gate over a raw LM token stream.

    Mirrors the hot loop of `modal_audio_stream.py:307-336`: skip everything
    until SOS is seen, yield audio token IDs, stop at EOS. With
    ``restart_on_sos=True`` it implements the "last-SOS" strategy of
    `hindi_canopy/inference.py:137-153` (multi-SOS outputs: each new SOS
    discards previously collected codes).
    """

    restart_on_sos: bool = False
    started: bool = dataclasses.field(default=False, init=False)
    finished: bool = dataclasses.field(default=False, init=False)
    codes: List[int] = dataclasses.field(default_factory=list, init=False)
    restart_count: int = dataclasses.field(default=0, init=False)

    def feed(self, token_id: int) -> List[int]:
        """Feed one token; return newly accepted audio *codes* (offset-free).

        Codes are ``token - TOKEN_AUDIO_BASE`` (still carrying the 4096*pos
        frame offsets; de-interleave removes those).
        """
        if self.finished:
            return []
        if token_id == TOKEN_EOS:
            self.finished = True
            return []
        if token_id == TOKEN_SOS:
            if self.started and self.restart_on_sos:
                self.codes.clear()
                self.restart_count += 1
            self.started = True
            return []
        if not self.started:
            return []
        if token_id < TOKEN_AUDIO_BASE:
            # Non-audio token inside a speech segment (e.g. DELIMITER):
            # ignored, like the reference's state machine.
            return []
        code = token_id - TOKEN_AUDIO_BASE
        if code >= AUDIO_VOCAB:
            return []
        self.codes.append(code)
        return [code]

    def feed_many(self, token_ids: Iterable[int]) -> List[int]:
        out: List[int] = []
        for t in token_ids:
            out.extend(self.feed(t))
        return out


def extract_audio_codes(
    token_ids: Sequence[int],
    *,
    strategy: str = "first_sos",
) -> List[int]:
    """Batch extraction of audio codes from a full LM output.

    strategy="first_sos": reference `tensorrt_tts/inference.py:231-242`.
    strategy="last_sos":  reference `hindi_canopy/inference.py:137-153` —
    multi-SOS outputs keep only the final speech segment (ablated in
    `helpers/analyze_sos_pattern.py:190-250`).
    """
    if strategy not in ("first_sos", "last_sos"):
        raise ValueError(f"unknown extraction strategy: {strategy}")
    ex = TokenExtractor(restart_on_sos=(strategy == "last_sos"))
    ex.feed_many(token_ids)
    return ex.codes


# ---------------------------------------------------------------------------
# Frame de-interleave  (7 codes/frame → 3 SNAC layers)
# ---------------------------------------------------------------------------


def deinterleave_frames(
    codes: Sequence[int] | np.ndarray,
    *,
    clamp: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split flat audio codes into the 3 SNAC codebook layers.

    Per frame ``[c0..c6]`` (reference: modal_audio_stream.py:160-180):

        layer1 += [c0]
        layer2 += [c1-4096,  c4-4*4096]
        layer3 += [c2-2*4096, c3-3*4096, c5-5*4096, c6-6*4096]

    Out-of-range results are clamped to [0, 4095] — "can happen with Hindi
    model tokens" (modal_audio_stream.py:185-190).

    Returns int32 arrays of shape (n,), (2n,), (4n,) for n complete frames.
    Incomplete trailing frames are dropped (reference behavior).
    """
    codes = np.asarray(codes, dtype=np.int32)
    n = codes.shape[0] // FRAME_SIZE
    frames = codes[: n * FRAME_SIZE].reshape(n, FRAME_SIZE)
    if n == 0:
        z = np.zeros((0,), dtype=np.int32)
        return z, z.copy(), z.copy()
    offsets = np.asarray(POSITION_OFFSETS, dtype=np.int32)
    adjusted = frames - offsets  # remove per-position offsets
    l1 = adjusted[:, 0]
    l2 = adjusted[:, [1, 4]].reshape(-1)
    l3 = adjusted[:, [2, 3, 5, 6]].reshape(-1)
    if clamp:
        l1 = np.clip(l1, 0, CODEBOOK_SIZE - 1)
        l2 = np.clip(l2, 0, CODEBOOK_SIZE - 1)
        l3 = np.clip(l3, 0, CODEBOOK_SIZE - 1)
    return l1.astype(np.int32), l2.astype(np.int32), l3.astype(np.int32)


def interleave_frames(
    l1: np.ndarray, l2: np.ndarray, l3: np.ndarray
) -> np.ndarray:
    """Inverse of :func:`deinterleave_frames` — 3 layers → flat 7/frame codes.

    Used by tests and by the training data path (audio → LM target tokens).
    """
    l1 = np.asarray(l1, dtype=np.int32)
    l2 = np.asarray(l2, dtype=np.int32).reshape(-1, 2)
    l3 = np.asarray(l3, dtype=np.int32).reshape(-1, 4)
    n = l1.shape[0]
    if l2.shape[0] != n or l3.shape[0] != n:
        raise ValueError("layer lengths must be n, 2n, 4n")
    frames = np.zeros((n, FRAME_SIZE), dtype=np.int32)
    frames[:, 0] = l1
    frames[:, 1] = l2[:, 0] + POSITION_OFFSETS[1]
    frames[:, 4] = l2[:, 1] + POSITION_OFFSETS[4]
    frames[:, 2] = l3[:, 0] + POSITION_OFFSETS[2]
    frames[:, 3] = l3[:, 1] + POSITION_OFFSETS[3]
    frames[:, 5] = l3[:, 2] + POSITION_OFFSETS[5]
    frames[:, 6] = l3[:, 3] + POSITION_OFFSETS[6]
    return frames.reshape(-1)


def codes_to_tokens(codes: np.ndarray) -> np.ndarray:
    """Flat interleaved codes → LM token IDs."""
    return np.asarray(codes, dtype=np.int32) + TOKEN_AUDIO_BASE


def validate_frame_offsets(codes: Sequence[int]) -> List[int]:
    """Positions whose code violates the per-position offset invariant.

    Position p must satisfy ``p*4096 <= code < (p+1)*4096``
    (reference: helpers/analyze_tokens.py:111-136). Returns flat indices of
    violations (empty == valid).
    """
    codes = np.asarray(codes, dtype=np.int64)
    n = codes.shape[0] // FRAME_SIZE
    frames = codes[: n * FRAME_SIZE].reshape(n, FRAME_SIZE)
    offsets = np.asarray(POSITION_OFFSETS, dtype=np.int64)
    ok = (frames >= offsets) & (frames < offsets + CODEBOOK_SIZE)
    return [int(i) for i in np.flatnonzero(~ok.reshape(-1))]


def frames_from_codes(codes: Sequence[int]) -> int:
    return len(codes) // FRAME_SIZE


def iter_complete_frames(codes: Sequence[int]) -> Iterator[Sequence[int]]:
    n = frames_from_codes(codes)
    for i in range(n):
        yield codes[i * FRAME_SIZE : (i + 1) * FRAME_SIZE]
