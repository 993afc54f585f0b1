"""Unified dataclass config tree.

The port's own copy of ``tts_inference_tpu/config.py``: the same
dataclasses, field names and defaults, so a config translates between the
two packages field by field (``dataclasses.asdict``). A field the port does
not honour yet keeps its name and is rejected where it is read (the mesh
axes and the bf16 vocoder, in ``cli.py``) or has no
effect because the port has no such switch (``use_pallas_attention``,
``use_pallas``, ``compilation_cache_dir``: the port's kernels always run on
a CUDA tensor and eager PyTorch compiles nothing).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

from tts_inference_tpu_torch import protocol


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Llama-style decoder config (HF `LlamaConfig` field-compatible).

    Defaults are Orpheus-3B = Llama-3.2-3B with the audio-extended vocab
    (128256 base + 10 specials + 28672 audio + pad → 156940).
    """

    vocab_size: int = 156940
    hidden_size: int = 3072
    intermediate_size: int = 8192
    num_hidden_layers: int = 28
    num_attention_heads: int = 24
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    # Llama-3 rope scaling (HF rope_scaling{rope_type="llama3"}); None disables.
    rope_scaling_factor: Optional[float] = 32.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    max_position_embeddings: int = 131072
    tie_word_embeddings: bool = True
    dtype: str = "bfloat16"
    # The JAX package's switch for its Pallas decode-attention kernel. The
    # port reads no such switch: a decode step always runs its kernel.
    use_pallas_attention: bool = False

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "ModelConfig":
        """A small config for tests (CPU-fast, same code paths)."""
        return cls(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            head_dim=16,
            rope_scaling_factor=None,
            max_position_embeddings=512,
            dtype="float32",
        )

    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        rs = d.get("rope_scaling") or {}
        is_llama3 = rs.get("rope_type", rs.get("type")) == "llama3"
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            num_key_value_heads=d.get(
                "num_key_value_heads", d["num_attention_heads"]
            ),
            head_dim=d.get(
                "head_dim", d["hidden_size"] // d["num_attention_heads"]
            ),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            rope_theta=d.get("rope_theta", 10000.0),
            rope_scaling_factor=rs.get("factor") if is_llama3 else None,
            rope_low_freq_factor=rs.get("low_freq_factor", 1.0),
            rope_high_freq_factor=rs.get("high_freq_factor", 4.0),
            rope_original_max_position=rs.get(
                "original_max_position_embeddings", 8192
            ),
            max_position_embeddings=d.get("max_position_embeddings", 131072),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            dtype={
                "float32": "float32", "float16": "float16",
                "bfloat16": "bfloat16",
            }.get(
                # transformers ≥4.56 writes "dtype"; older wrote "torch_dtype"
                str(d.get("dtype", d.get("torch_dtype", "bfloat16"))),
                "bfloat16",
            ),
        )


@dataclasses.dataclass(frozen=True)
class SnacConfig:
    """SNAC 24 kHz decoder config (hubertsiuzdak/snac_24khz geometry).

    decoder_rates [8,8,4,2] × hop → 512 samples per latent step; vq_strides
    [4,2,1] → one 7-code TTS frame = 4 latent steps = 2048 samples.
    """

    sampling_rate: int = 24000
    latent_dim: int = 768            # encoder_dim 48 * 2**len(encoder_rates)
    decoder_dim: int = 1024
    decoder_rates: Tuple[int, ...] = (8, 8, 4, 2)
    codebook_size: int = 4096
    codebook_dim: int = 8
    vq_strides: Tuple[int, ...] = (4, 2, 1)
    noise: bool = True
    depthwise: bool = True
    dtype: str = "float32"
    # The JAX package's switch for its Pallas residual-unit kernel. The
    # port reads no such switch: the residual unit is always its kernel.
    use_pallas: Optional[bool] = None

    @property
    def hop_length(self) -> int:
        h = 1
        for r in self.decoder_rates:
            h *= r
        return h  # 512

    @property
    def samples_per_frame(self) -> int:
        return self.hop_length * max(self.vq_strides)  # 2048

    @classmethod
    def tiny(cls) -> "SnacConfig":
        return cls(
            latent_dim=32,
            decoder_dim=64,
            decoder_rates=(8, 8, 4, 2),
            codebook_size=64,
            codebook_dim=4,
        )


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Per-request sampling knobs (reference: inference.py:209-217)."""

    temperature: float = protocol.DEFAULT_TEMPERATURE
    top_p: float = protocol.DEFAULT_TOP_P
    repetition_penalty: float = protocol.DEFAULT_REPETITION_PENALTY
    max_tokens: int = protocol.DEFAULT_MAX_TOKENS
    top_k: int = 0          # 0 = disabled; >0 caps candidate set
    greedy: bool = False    # temp=0/top_k=1 parity mode (debug_tokens.py)
    seed: Optional[int] = None
    # Constrain sampling to token ids in [lo, hi) — audio-tokens-only mode
    # guarantees valid SNAC codes (structured decoding; None = off).
    token_range: Optional[Tuple[int, int]] = None
    # Frame-aligned structured decoding: position p of each 7-token frame
    # only admits codes in its own 4096-block, EOS only at frame boundaries,
    # and only SOS before speech starts — generated frames are ALWAYS
    # protocol-valid (the reference instead detects and clamps invalid
    # codes, hindi_canopy/inference.py:176-192).
    frame_protocol: bool = False


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Generation-engine config: bucketing, batching, cache geometry.

    Prompt and KV-window buckets keep the set of shapes a launch can take
    small (the reference's TRT BuildConfig(max_input_len=512, max_seq_len=…),
    build_engine.py:133-138).
    """

    max_input_len: int = 512
    max_output_len: int = 4096
    max_batch_size: int = 8          # continuous-batching slots
    # 16/32 buckets: a real-BPE prompt ("tara: <sentence>" ≈ 10-25 ids incl.
    # the protocol envelope) prefills 16 or 32 positions instead of the 128
    # a byte-tokenized prompt needs.
    prefill_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256, 512)
    decode_steps_per_call: int = protocol.FRAME_SIZE  # host sync cadence
    # KV attention-window buckets: the decode step reads only the smallest
    # bucket covering the longest live sequence (the step is bound by the
    # bytes it reads; all of max_seq for short sequences wastes them).
    kv_buckets: Tuple[int, ...] = (256, 512, 1024, 2048, 4096)
    # int8 KV cache: halves cache memory (2x slot capacity) and attention
    # read bandwidth; per-(slot, position, head) scales, dequant fused into
    # the attention dots. Off by default (bit-identical serving).
    kv_cache_int8: bool = False
    # int4 KV pools (paged mode only): packs two int4 per byte with the
    # head-pair layout of ops/paged_attention_int4.py — half the int8
    # pools' bytes, in capacity and in what a decode step reads. Lossier
    # than int8 (per-(pos,head) absmax/7): a default-on decision needs a
    # fidelity check on real checkpoints, like --weight-bits 4.
    kv_cache_int4: bool = False
    # Paged/blocked KV cache (reference: TRT-LLM paged KV, 32 tok/block,
    # PIPELINE_REPORT.md:58-64): slots reserve blocks from a shared pool
    # sized in TOKENS (kv_pool_tokens; default max_batch_size*max_seq/2)
    # instead of holding dense max_seq buffers — device memory scales with
    # admitted work, and admission is capacity-gated like TRT in-flight
    # batching.
    paged_kv: bool = False
    kv_block_size: int = 128
    kv_pool_tokens: Optional[int] = None
    # vLLM-style on-demand paged KV (the reference's vLLM PagedAttention
    # allocation semantics, SURVEY §2.2): reserve only the prefill window
    # at admission and grow blocks per decode-call window, instead of
    # holding bucket+max_tokens worst-case for the request's whole life —
    # a request asking for 2048 max_tokens but emitting 300 no longer
    # pins ~7x its real KV need. On true pool exhaustion the scheduler
    # preempts the youngest stream (snapshot sampling chain, free blocks,
    # requeue; resume = re-prefill prompt+generated + state restore,
    # bit-identical continuation — tests/test_preemption.py).
    kv_on_demand: bool = False
    # prefill buckets a preempted stream may resume through (re-prefill of
    # prompt + generated-so-far), kept apart from prefill_buckets as in
    # the JAX package. A stream too long for the largest resume bucket is
    # not preemptible.
    resume_buckets: Tuple[int, ...] = (1024, 2048)
    # Sliced LM head: compute decode logits only for rows ≥
    # protocol.HEAD_SLICE_BASE (specials + audio vocab — everything a TTS
    # generation can legitimately emit; the reference's extractor DROPS
    # sub-audio tokens after the fact, tensorrt_tts/inference.py:54-93).
    # Skips the 128,000 plain-text head rows (128,000 × hidden weight
    # elements less per decode step, a 5.4× smaller sampling chain).
    # Bit-identical under
    # structured decoding (token_range / frame_protocol); otherwise text
    # rows become unsampleable (a protocol-correctness guard, not a loss).
    sliced_head: bool = True
    # Prefix caching (reference: vLLM enable_prefix_caching=True,
    # modal_audio_stream.py:232): KV for repeated prompt prefixes — the
    # shared "{voice}: " header, or whole repeated prompts — is computed
    # once into a device-side pool and injected into the slot cache at
    # admission, so same-prefix requests prefill only their suffix.
    prefix_cache: bool = False
    prefix_len: int = 32          # cached prefix bucket (tokens)
    prefix_entries: int = 16      # pool capacity (LRU)
    # --- Admission QoS under oversubscription (reference roadmap: ~100
    # concurrent users, spec.md:137-139). Strict FIFO gives every request
    # the same multi-second p95 TTFA once the queue exceeds the slots;
    # "sjf" ranks the backlog shortest-job-first with aging so short
    # interactive requests stop queueing behind long-audio jobs, and
    # reserved slots guarantee shorts always have capacity to land in.
    admission_policy: str = "fifo"   # "fifo" | "sjf" (shortest-first+aging)
    # Aging bound on starvation: a queued job's effective length shrinks by
    # max_output_len per sjf_aging_ms waited, so after ~sjf_aging_ms any
    # long job outranks a freshly arrived short one.
    sjf_aging_ms: float = 4000.0
    # Slots only "short" requests may occupy (0 = none reserved). Long
    # requests are confined to the remaining slots, so a burst of
    # long-audio work can never consume the whole machine.
    reserved_short_slots: int = 0
    # "short" = sampling.max_tokens ≤ this (896 tokens = 128 frames ≈ 10.9 s
    # of audio — interactive-utterance territory).
    short_request_tokens: int = 896
    compilation_cache_dir: Optional[str] = None

    @property
    def max_seq_len(self) -> int:
        return self.max_input_len + self.max_output_len


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Streaming orchestration (reference: PIPELINE_REPORT.md:496-519).

    lookahead default is 3 (not the reference's 5): our vocoder's influence
    reach is ±2.29 frames (measured), so 3 frames is already BIT-EXACT vs
    batch decode — the reference needed 5 for 0.9987 correlation because of
    its nondeterministic noise. Saves 2 frames (~171 ms) of TTFA.
    first_chunk_frames emits a smaller first chunk as soon as it is stable
    (TTFA budget = (first_chunk+lookahead)·85 ms of tokens instead of
    (frames_per_chunk+lookahead)).
    """

    frames_per_chunk: int = 5
    first_chunk_frames: int = 1
    lookahead_frames: int = 3
    # Optional smaller lookahead for the FIRST emission only (progressive
    # lookahead): e.g. 2 shaves ~85 ms off TTFA at the cost of a bounded,
    # tiny deviation in the first chunk's final 0.29 frames (the influence
    # reach is 2.29). None = use lookahead_frames (bit-exact).
    first_chunk_lookahead: Optional[int] = None
    # Left context for windowed re-decode. The reference re-decodes from
    # frame 0 every chunk (O(n²)); we decode a bounded window whose margin
    # covers the vocoder receptive field, making streaming O(n) and
    # sample-exact vs batch decode (SURVEY.md §7.3).
    left_context_frames: int = 6
    extraction: str = "first_sos"    # or "last_sos"
    # De-phase concurrent streams' chunk cadence: the scheduler gives slot
    # i a one-time (i % frames_per_chunk)-frame phase on its SECOND chunk,
    # so burst-admitted streams stop vocoding on the same tick — the
    # synchronized vocode burst set the worst inter-chunk gap at the
    # capacity frontier. Emitted bytes are unchanged
    # (windowed decode is chunk-boundary independent, test-enforced).
    stagger_chunks: bool = True


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh axes (SURVEY.md §5.8). The port serves on one card and
    rejects any other value."""

    dp: int = 1     # data parallel (replica) axis
    tp: int = 1     # tensor parallel axis (heads / ffn sharding)

    @property
    def num_devices(self) -> int:
        return self.dp * self.tp


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    host: str = "0.0.0.0"
    port: int = 8000
    max_concurrent_streams: int = 8
    default_voice: str = "tara"
    request_timeout_s: float = 300.0


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    snac: SnacConfig = dataclasses.field(default_factory=SnacConfig)
    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    stream: StreamConfig = dataclasses.field(default_factory=StreamConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    server: ServerConfig = dataclasses.field(default_factory=ServerConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    def replace(self, **sections: Any) -> "Config":
        return dataclasses.replace(self, **sections)


def extended_kv_buckets(base: Tuple[int, ...],
                        max_seq: int) -> Tuple[int, ...]:
    """Extend the KV window bucket series by doubling up to (but below)
    max_seq — long-audio engines (reference: hindi_canopy 12,000-output-
    token build, `build_engine.py:61,127-135`) otherwise jump straight
    from the last default bucket to the full max_seq window and pay the
    whole window's read for mid-length sequences. kv_bucket() already
    falls back to max_seq itself for the longest sequences."""
    buckets = sorted({b for b in base if b < max_seq})
    if not buckets:
        return tuple(base)
    b = buckets[-1]
    while b * 2 < max_seq:
        b *= 2
        buckets.append(b)
    return tuple(buckets)


def tiny_config() -> Config:
    """Full-stack tiny config used by the test suite and CLI --tiny.

    Uses the REAL Orpheus vocab (so protocol special tokens and the audio
    token range are genuine ids) over a tiny transformer + tiny vocoder.
    """
    return Config(
        model=ModelConfig.tiny(vocab_size=156940),
        snac=SnacConfig(
            latent_dim=32, decoder_dim=64, codebook_dim=4,
        ),
        engine=EngineConfig(
            max_input_len=64,
            max_output_len=256,
            max_batch_size=4,
            prefill_buckets=(16, 32, 64),
        ),
    )
