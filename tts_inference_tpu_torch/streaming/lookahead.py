"""Lookahead streaming decoder: emit only context-stable samples.

Re-homed copy of ``tts_inference_tpu/streaming/lookahead.py`` (numpy over a
decoder; the JAX module imports the JAX vocoder, so it cannot be reused
here), typed against the port's ``SnacDecoder``.

- **Windowed re-decode**: each chunk decodes only the window
  [emit_frame − left_context, total_frames). With left_context ≥ 3 and
  lookahead ≥ 3 the emitted samples equal a full batch decode (the
  vocoder's influence reach is ±2.29 frames), O(n) total work.
- **Emission rule**: with ``lookahead_frames`` L, sample s is emitted once
  ≥ L complete frames exist after s's frame; on EOS everything flushes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from tts_inference_tpu_torch import protocol
from tts_inference_tpu_torch.config import StreamConfig
from tts_inference_tpu_torch.models.snac import SnacDecoder


def max_window_frames(scfg: StreamConfig, steps_per_launch: int = 7) -> int:
    """The most frames one streaming window decodes: the left context, a
    chunk, its lookahead, and what one token launch can add beyond the
    point where the chunk became due."""
    burst = -(-steps_per_launch // protocol.FRAME_SIZE)
    la = max(scfg.lookahead_frames, scfg.first_chunk_lookahead or 0)
    return (scfg.left_context_frames
            + max(scfg.frames_per_chunk, scfg.first_chunk_frames) + la
            + burst - 1)


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """Decode frames [w0, w1); emit samples [lo, hi) of that decode."""

    w0: int
    w1: int
    lo: int
    hi: int


@dataclasses.dataclass
class LookaheadStreamingDecoder:
    """Incremental codes → stable PCM samples.

    feed(codes) buffers flat interleaved audio codes (7/frame, offsets still
    applied); poll() / flush() return newly stable float32 samples.
    """

    decoder: SnacDecoder
    stream_cfg: StreamConfig = dataclasses.field(default_factory=StreamConfig)
    noise_seed: int = 0
    # one-time shrink of the SECOND chunk (then back to frames_per_chunk):
    # the scheduler sets slot % frames_per_chunk so concurrently admitted
    # streams chunk on different ticks; emitted bytes are unchanged
    chunk_phase: int = 0

    codes: List[int] = dataclasses.field(default_factory=list, init=False)
    samples_emitted: int = dataclasses.field(default=0, init=False)
    decode_calls: int = dataclasses.field(default=0, init=False)
    frames_decoded_total: int = dataclasses.field(default=0, init=False)

    @property
    def spf(self) -> int:
        return self.decoder.cfg.samples_per_frame

    @property
    def total_frames(self) -> int:
        return len(self.codes) // protocol.FRAME_SIZE

    def feed(self, new_codes) -> None:
        self.codes.extend(int(c) for c in new_codes)

    def plan(self, flush: bool = False) -> Optional[WindowPlan]:
        """Next decode window + emission span, without decoding. A returned
        plan must be passed to exactly one of execute()/commit()."""
        if flush:
            stable_frames = self.total_frames
        else:
            first = self.samples_emitted == 0
            lookahead = self.stream_cfg.lookahead_frames
            if first and self.stream_cfg.first_chunk_lookahead is not None:
                lookahead = self.stream_cfg.first_chunk_lookahead
            stable_frames = self.total_frames - lookahead
            # the phase SHRINKS the second chunk, never extends it
            need = (self.stream_cfg.first_chunk_frames if first
                    else max(1, self.stream_cfg.frames_per_chunk
                             - (self.chunk_phase
                                if self.decode_calls == 1 else 0)))
            pending = stable_frames - self.samples_emitted // self.spf
            if pending < max(1, need):
                return None
        stable_end = stable_frames * self.spf
        if stable_end <= self.samples_emitted:
            return None
        emit_frame = self.samples_emitted // self.spf
        w0 = max(0, emit_frame - self.stream_cfg.left_context_frames)
        return WindowPlan(
            w0=w0,
            w1=self.total_frames,
            lo=self.samples_emitted - w0 * self.spf,
            hi=stable_end - w0 * self.spf,
        )

    def window_layers(self, plan: WindowPlan):
        flat = np.asarray(
            self.codes[plan.w0 * protocol.FRAME_SIZE
                       : plan.w1 * protocol.FRAME_SIZE],
            dtype=np.int32,
        )
        return protocol.deinterleave_frames(flat)

    def commit(self, plan: WindowPlan) -> None:
        """Advance emission bookkeeping for a plan decoded externally."""
        self.decode_calls += 1
        self.frames_decoded_total += plan.w1 - plan.w0
        self.samples_emitted = plan.hi + plan.w0 * self.spf

    def execute(self, plan: WindowPlan) -> np.ndarray:
        l1, l2, l3 = self.window_layers(plan)
        audio = self.decoder.decode_frames(
            l1, l2, l3, noise_seed=self.noise_seed, first_frame=plan.w0
        )
        self.commit(plan)
        return audio[plan.lo: plan.hi]

    def poll(self) -> Optional[np.ndarray]:
        """Newly stable samples given the current buffer (None if not enough)."""
        plan = self.plan()
        return None if plan is None else self.execute(plan)

    def flush(self) -> Optional[np.ndarray]:
        """EOS: emit all remaining samples (now stable with full context)."""
        plan = self.plan(flush=True)
        return None if plan is None else self.execute(plan)
