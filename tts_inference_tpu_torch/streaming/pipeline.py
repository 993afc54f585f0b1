"""TTS pipeline: text → prompt → token stream → stable PCM chunks.

Port of ``tts_inference_tpu/streaming/pipeline.py``, around the windowed
lookahead decoder and the multi-token engine. The fused first chunk is
kept: the first chunk's extraction (audio-range check, de-interleave,
clamp) and SNAC decode run on the device straight from the first launch's
token tensor, with no host sync in between (one vocoder call: a CUDA graph
per first-chunk geometry on the card), and its PCM is copied back with the
first tokens. Anything unclean (SOS/EOS/non-audio in the burst, a plan
mismatch) flips ``ok`` and the host path decodes the chunk instead.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Optional

import numpy as np
import torch

from tts_inference_tpu_torch import protocol
from tts_inference_tpu_torch.config import Config, SamplingConfig, StreamConfig
from tts_inference_tpu_torch.utils.audio import pcm16_bytes
from tts_inference_tpu_torch.utils.timing import PhaseTimer
from tts_inference_tpu_torch.utils.tokenizer import TokenizerProtocol
from tts_inference_tpu_torch.engine.engine import GenerationEngine
from tts_inference_tpu_torch.models.snac import (SnacDecoder, decode_codes,
                                                 to_pcm16)
from tts_inference_tpu_torch.streaming.lookahead import \
    LookaheadStreamingDecoder
from tts_inference_tpu_torch.utils import to_numpy


@dataclasses.dataclass
class AudioChunk:
    pcm: bytes               # int16 LE mono 24 kHz
    index: int
    samples: int

    @property
    def duration_ms(self) -> float:
        return self.samples / protocol.SAMPLE_RATE * 1000.0


@dataclasses.dataclass
class StreamMetrics:
    """server_metrics payload fields (the reference wire contract)."""

    ttft_ms: float = 0.0
    ttfa_ms: float = 0.0
    tokens: int = 0
    frames: int = 0
    chunks: int = 0
    audio_duration_ms: float = 0.0
    generation_time_ms: float = 0.0
    tokens_per_sec: float = 0.0
    frames_per_sec: float = 0.0
    rtf: float = 0.0
    decode_times_ms: List[float] = dataclasses.field(default_factory=list)

    def finalize(self) -> "StreamMetrics":
        s = self.generation_time_ms / 1000.0
        if s > 0:
            self.tokens_per_sec = self.tokens / s
            self.frames_per_sec = self.frames / s
            self.rtf = (self.audio_duration_ms / 1000.0) / s
        return self

    def as_wire(self) -> dict:
        return {
            "server_ttft_ms": round(self.ttft_ms, 2),
            "server_ttfa_ms": round(self.ttfa_ms, 2),
            "server_rtf": round(self.rtf, 4),
            "tokens": self.tokens,
            "tokens_per_sec": round(self.tokens_per_sec, 2),
            "frames_per_sec": round(self.frames_per_sec, 2),
            "generation_time_s": round(self.generation_time_ms / 1000.0, 3),
            "decode_times_ms": [round(d, 2) for d in self.decode_times_ms],
        }


def first_chunk_geometry(scfg: StreamConfig, spf: int):
    """(n_codes, nf, emit) of a stream's fused first chunk: the codes of its
    first nf frames (first chunk + its lookahead) and the samples it
    emits."""
    la = (scfg.first_chunk_lookahead
          if scfg.first_chunk_lookahead is not None
          else scfg.lookahead_frames)
    nf = scfg.first_chunk_frames + la
    return nf * protocol.FRAME_SIZE, nf, scfg.first_chunk_frames * spf


_OFFSETS: dict = {}   # device → protocol.POSITION_OFFSETS (made outside any capture)


def first_chunk_pcm(vocoder: SnacDecoder, toks: torch.Tensor, n_codes: int,
                    nf: int, emit: int, noise_seeds: torch.Tensor):
    """Device-side first chunk for every row of a launch's token tensor.

    toks (B, ≥ n_codes) → (pcm (B, emit) int16, ok (B,) bool). Row r is
    decoded exactly like the host path would decode its first nf frames
    (same frame bucket, valid length and noise seed); ``ok`` is False when
    the row's first n_codes tokens are not all audio codes. Device work
    only (it runs inside a CUDA-graph capture)."""
    cfg = vocoder.cfg
    b = toks.shape[0]
    nb = vocoder.bucket_frames(nf)
    lat = max(cfg.vq_strides)
    ab = protocol.TOKEN_AUDIO_BASE
    dev = toks.device
    t = toks[:, :n_codes].long()
    ok = ((t >= ab) & (t < ab + protocol.AUDIO_VOCAB)).all(dim=1)
    offs = _OFFSETS.get(dev)
    if offs is None:
        offs = _OFFSETS[dev] = torch.tensor(protocol.POSITION_OFFSETS,
                                            device=dev)
    frames = ((t - ab).reshape(b, nf, protocol.FRAME_SIZE) - offs).clamp(
        0, cfg.codebook_size - 1)

    def pad(x, m):
        out = torch.zeros((b, m * nb), dtype=torch.int64, device=dev)
        out[:, : x.shape[1]] = x
        return out

    # the de-interleave by slices (a list index would copy it from the host)
    l1 = frames[:, :, 0]
    l2 = torch.stack([frames[:, :, i] for i in (1, 4)], dim=2).reshape(b, -1)
    l3 = torch.stack([frames[:, :, i] for i in (2, 3, 5, 6)],
                     dim=2).reshape(b, -1)
    audio = decode_codes(
        vocoder.params, cfg, (pad(l1, 1), pad(l2, 2), pad(l3, 4)),
        noise_seed=noise_seeds,
        latent_offset=torch.zeros(b, dtype=torch.int64, device=dev),
        use_noise=vocoder.use_noise,
        valid_latent=torch.full((b,), nf * lat, dtype=torch.int32,
                                device=dev),
    )
    return to_pcm16(audio[:, :emit]), ok


def first_chunk_launch(vocoder: SnacDecoder, toks: torch.Tensor,
                       n_codes: int, nf: int, emit: int,
                       noise_seeds: torch.Tensor):
    """:func:`first_chunk_pcm` as one vocoder call (the graph of its
    geometry at this batch on the card); `noise_seeds` (B,) int64 on the
    host or the device. Returns the host copies (pcm, ok)."""
    return vocoder.run(
        ("first_chunk", toks.shape[0], n_codes, nf, emit),
        lambda toks, seeds: first_chunk_pcm(vocoder, toks, n_codes, nf,
                                            emit, seeds),
        toks=toks[:, :n_codes], seeds=noise_seeds)


def warmup_first_chunks(vocoder: SnacDecoder, batch: int, geometries,
                        device) -> None:
    """Capture the fused first chunk of each geometry at `batch` (a call of
    audio-base tokens; nothing runs on the CPU, as in
    ``SnacDecoder.warmup_graphs``)."""
    if vocoder.device.type == "cpu":
        return
    with vocoder.warming(), torch.no_grad():
        for n_codes, nf, emit in geometries:
            toks = torch.full((batch, n_codes), protocol.TOKEN_AUDIO_BASE,
                              dtype=torch.int32, device=device)
            to_numpy(first_chunk_launch(
                vocoder, toks, n_codes, nf, emit,
                torch.zeros(batch, dtype=torch.int64))[0])


class TTSPipeline:
    """Single-stream synthesis over one engine slot."""

    def __init__(self, engine: GenerationEngine, vocoder: SnacDecoder,
                 tokenizer: TokenizerProtocol,
                 config: Optional[Config] = None):
        self.engine = engine
        self.vocoder = vocoder
        self.tokenizer = tokenizer
        self.config = config or Config()
        self.last_metrics: Optional[StreamMetrics] = None

    def build_prompt(self, text: str, voice: str = "tara",
                     force_speech: bool = False) -> List[int]:
        text = text[: protocol.MAX_TEXT_CHARS]
        ids = self.tokenizer.encode(protocol.format_prompt_text(text, voice))
        return protocol.format_prompt_ids(ids, force_speech=force_speech)

    @torch.no_grad()
    def stream(self, text: str, voice: str = "tara",
               sampling: Optional[SamplingConfig] = None,
               stream_cfg: Optional[StreamConfig] = None,
               noise_seed: int = 0,
               force_speech: bool = False) -> Iterator[AudioChunk]:
        sampling = sampling or self.config.sampling
        scfg = stream_cfg or self.config.stream
        timer = PhaseTimer()
        metrics = StreamMetrics()
        self.last_metrics = metrics

        prompt = self.build_prompt(text, voice, force_speech=force_speech)
        extractor = protocol.TokenExtractor(
            restart_on_sos=(scfg.extraction == "last_sos"))
        if force_speech:
            extractor.started = True   # the prompt already ends in SOS
        la = LookaheadStreamingDecoder(self.vocoder, scfg, noise_seed)
        chunk_index = 0

        def cut(samples: np.ndarray) -> Iterator[AudioChunk]:
            nonlocal chunk_index
            metrics.ttfa_ms = metrics.ttfa_ms or timer.mark("ttfa_ms")
            chunk_index += 1
            metrics.chunks = chunk_index
            metrics.audio_duration_ms += \
                len(samples) / protocol.SAMPLE_RATE * 1e3
            yield AudioChunk(pcm16_bytes(samples), chunk_index, len(samples))

        # first launch: tokens for the first stable chunk
        first_burst, nf_first, emit_first = first_chunk_geometry(
            scfg, self.vocoder.cfg.samples_per_frame)
        fused: dict = {}

        def on_first_tokens(toks_d):
            if toks_d.shape[1] < first_burst:
                return
            seeds = torch.full((toks_d.shape[0],), noise_seed & 0xFFFFFFFF,
                               dtype=torch.int64)
            fused["pcm"], fused["ok"] = first_chunk_launch(
                self.vocoder, toks_d, first_burst, nf_first, emit_first,
                seeds)

        hook = on_first_tokens if extractor.started else None

        restarts_seen = 0
        for token_chunk in self.engine.stream(
                prompt, sampling, first_burst=first_burst,
                on_first_tokens=hook):
            metrics.ttft_ms = metrics.ttft_ms or timer.mark("ttft_ms")
            metrics.tokens += len(token_chunk)
            new_codes = extractor.feed_many(token_chunk)
            if extractor.restart_count != restarts_seen:
                # last-SOS restart: drop buffered (un-emitted) frames
                restarts_seen = extractor.restart_count
                if metrics.chunks == 0:
                    la = LookaheadStreamingDecoder(self.vocoder, scfg,
                                                   noise_seed)
            if new_codes:
                la.feed(new_codes)
                if fused:
                    pcm_h, ok_h = fused.pop("pcm"), fused.pop("ok")
                    t0 = time.perf_counter()
                    plan = la.plan()
                    if (plan is not None and plan.w0 == 0
                            and plan.w1 == nf_first and plan.lo == 0
                            and plan.hi == emit_first
                            and not extractor.finished
                            and extractor.restart_count == restarts_seen
                            and bool(to_numpy(ok_h)[0])):
                        la.commit(plan)
                        metrics.decode_times_ms.append(
                            (time.perf_counter() - t0) * 1000.0)
                        yield from cut(to_numpy(pcm_h)[0])
                        continue
                t0 = time.perf_counter()
                out = la.poll()
                if out is not None and len(out):
                    metrics.decode_times_ms.append(
                        (time.perf_counter() - t0) * 1000.0)
                    yield from cut(out)
            if extractor.finished:
                break

        t0 = time.perf_counter()
        tail = la.flush()
        if tail is not None and len(tail):
            metrics.decode_times_ms.append((time.perf_counter() - t0) * 1000.0)
            yield from cut(tail)

        metrics.frames = la.total_frames
        metrics.generation_time_ms = timer.elapsed_ms()
        metrics.ttfa_ms = metrics.ttfa_ms or metrics.generation_time_ms
        metrics.finalize()

    def synthesize(self, text: str, voice: str = "tara",
                   sampling: Optional[SamplingConfig] = None,
                   stream_cfg: Optional[StreamConfig] = None,
                   force_speech: bool = False) -> tuple:
        """Batch path (reference `/generate`): full PCM + metrics."""
        parts = [c.pcm for c in self.stream(text, voice, sampling, stream_cfg,
                                            force_speech=force_speech)]
        return b"".join(parts), self.last_metrics
