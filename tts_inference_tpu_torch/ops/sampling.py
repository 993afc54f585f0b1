"""On-device sampling: temperature / top-k / top-p / repetition penalty.

Port of ``tts_inference_tpu/ops/sampling.py``; the chain is the same:

    logits → token_range → frame protocol → repetition penalty
           → temperature → exact top-k-256 cap → top-p → Gumbel-max
           (or argmax when greedy)

All knobs are per-slot tensors; every function here is out-of-place, like
the JAX one, because admission restores the rows of non-admitted slots from
the old state. The engine writes a launch's final state back into its own
state tensors with ``copy_state``: a CUDA graph reads and writes the
addresses it was captured with.

The noise differs from the JAX package on purpose: JAX draws its Gumbel noise
with threefry keys, which torch cannot reproduce. Here the uniforms come from
a counter hash of (slot seed, step, column) — the splitmix ``_mix32`` of the
vocoder's position noise — so a request's tokens depend only on its own seed
and step count, never on its slot or its neighbours. ``sample`` also takes
the uniforms as an argument, which lets tests inject the exact noise the JAX
package drew. The TPU-only ``approx_max_k`` branch is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from tts_inference_tpu_torch import protocol
from tts_inference_tpu_torch.config import SamplingConfig
from tts_inference_tpu_torch.models.snac import _mix32, _mul32

NEG_INF = -1e30
_M32 = 0xFFFFFFFF


class SamplingState(NamedTuple):
    """Per-slot state carried across decode steps.

    presence: (B, V) bool — tokens seen in prompt+output.
    seed, step: (B,) int64 — the noise counter (step advances per sample).
    in_speech: (B,) bool — SOS seen.  frame_pos: (B,) int32.
    """

    presence: torch.Tensor
    seed: torch.Tensor
    step: torch.Tensor
    in_speech: torch.Tensor
    frame_pos: torch.Tensor


class SamplingParams(NamedTuple):
    """Per-slot knobs, shape (B,). temperature == 0 means greedy;
    allowed_max == 0 disables the [allowed_min, allowed_max) range."""

    temperature: torch.Tensor
    top_p: torch.Tensor
    top_k: torch.Tensor
    repetition_penalty: torch.Tensor
    allowed_min: torch.Tensor
    allowed_max: torch.Tensor
    frame_protocol: torch.Tensor

    @classmethod
    def from_config(cls, cfg: SamplingConfig, batch: int,
                    device="cpu") -> "SamplingParams":
        def full(v, dt=torch.float32):
            return torch.full((batch,), v, dtype=dt, device=device)

        lo, hi = cfg.token_range or (0, 0)
        return cls(
            temperature=full(0.0 if cfg.greedy else cfg.temperature),
            top_p=full(cfg.top_p),
            top_k=full(1 if cfg.greedy else cfg.top_k, torch.int32),
            repetition_penalty=full(cfg.repetition_penalty),
            allowed_min=full(lo, torch.int32),
            allowed_max=full(hi, torch.int32),
            frame_protocol=full(bool(cfg.frame_protocol), torch.bool),
        )


def slot_seed(seed) -> torch.Tensor:
    """A request seed → the 32-bit noise seed of its slot."""
    return torch.as_tensor(seed, dtype=torch.int64) & _M32


def init_sampling_state(batch: int, vocab: int, seed: int = 0,
                        device="cpu") -> SamplingState:
    slots = torch.arange(batch, dtype=torch.int64, device=device)
    seeds = _mix32((seed & _M32) ^ _mul32(slots + 1, 0x9E3779B9))
    return SamplingState(
        presence=torch.zeros((batch, vocab), dtype=torch.bool, device=device),
        seed=seeds,
        step=torch.zeros(batch, dtype=torch.int64, device=device),
        in_speech=torch.zeros(batch, dtype=torch.bool, device=device),
        frame_pos=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def copy_state(dst: SamplingState, src: SamplingState) -> None:
    """Write `src` into the tensors of `dst`, in place."""
    for d, s in zip(dst, src):
        if d is not s:
            d.copy_(s)


def mark_tokens(state: SamplingState, tokens: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> SamplingState:
    """Record generated tokens (B,) into the presence set."""
    b = tokens.shape[0]
    rows = torch.arange(b, device=tokens.device)
    cols = tokens.long()
    upd = torch.ones(b, dtype=torch.bool, device=tokens.device) \
        if mask is None else mask
    presence = state.presence.clone()
    presence[rows, cols] = presence[rows, cols] | upd
    return state._replace(presence=presence)


def mark_prompt(state: SamplingState, tokens: torch.Tensor,
                lens: torch.Tensor) -> SamplingState:
    """Record a right-padded prompt batch (B, S) with valid lengths (B,)."""
    s = tokens.shape[1]
    valid = torch.arange(s, device=tokens.device)[None, :] < lens[:, None]
    # scatter max (duplicate ids in a row OR together); CUDA has no bool
    # scatter_reduce, so it runs on uint8
    presence = state.presence.to(torch.uint8).scatter_reduce(
        1, tokens.long(), valid.to(torch.uint8), reduce="amax")
    return state._replace(presence=presence.bool())


def apply_repetition_penalty(logits, presence, penalty):
    """vLLM/HF semantics: seen ∧ logit>0 → /p ; seen ∧ logit<=0 → *p."""
    p = penalty[:, None]
    penalized = torch.where(logits > 0, logits / p, logits * p)
    return torch.where(presence, penalized, logits)


def top_k_mask(logits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Mask logits outside the per-slot top-k (k == 0 → no-op)."""
    vocab = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k_eff = torch.where(k <= 0, torch.full_like(k, vocab), k)
    idx = (k_eff - 1).clamp(0, vocab - 1).long()
    thresh = sorted_desc.gather(1, idx[:, None])
    return torch.where(logits >= thresh, logits,
                       torch.full_like(logits, NEG_INF))


def top_p_mask(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus filter over the full sorted distribution."""
    sorted_logits, order = torch.sort(logits, dim=-1, descending=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p[:, None]
    keep = torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)
    return torch.where(keep, logits, torch.full_like(logits, NEG_INF))


def noise_uniforms(state: SamplingState, n: int) -> torch.Tensor:
    """(B, n) uniforms in (0, 1) from (slot seed, step, column)."""
    col = torch.arange(n, dtype=torch.int64, device=state.seed.device)
    row = _mix32(state.seed ^ _mul32((state.step + 1) & _M32, 0x85EBCA6B))
    h = _mix32(row[:, None] ^ _mul32(col[None, :] + 1, 0x9E3779B9))
    # 24 bits, centred: exactly representable in f32 and never 0 or 1
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def sample(logits: torch.Tensor, params: SamplingParams,
           state: SamplingState, *, nucleus_cap: int = 256, base: int = 0,
           uniforms: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, SamplingState]:
    """Full sampling chain; returns (tokens (B,) int32, new state).

    ``nucleus_cap`` bounds the top-p candidate set with an exact top-k (0 =
    full-vocab sort). ``base``: logits column i is token id base + i (the
    sliced head); masks and penalties index absolute ids. ``uniforms``:
    (B, cap) — or (B, V) without the cap — noise in (0, 1); by default the
    state's counter hash."""
    vocab = logits.shape[-1]
    dev = logits.device
    rng_ok = params.allowed_max > 0
    ids = base + torch.arange(vocab, dtype=torch.int32, device=dev)[None, :]
    in_range = (ids >= params.allowed_min[:, None]) & (
        ids < params.allowed_max[:, None])
    logits = logits.masked_fill(rng_ok[:, None] & ~in_range, NEG_INF)

    # frame-aligned structured decoding: in speech, position p admits only
    # its own 4096-code block, EOS only at a frame boundary; before SOS,
    # only SOS
    if base + vocab > protocol.TOKEN_AUDIO_BASE:
        lo = protocol.TOKEN_AUDIO_BASE + state.frame_pos * protocol.CODEBOOK_SIZE
        hi = lo + protocol.CODEBOOK_SIZE
        frame_ok = (ids >= lo[:, None]) & (ids < hi[:, None])
        at_boundary = state.frame_pos == 0
        frame_ok = frame_ok | ((ids == protocol.TOKEN_EOS)
                               & at_boundary[:, None])
        pre_speech_ok = ids == protocol.TOKEN_SOS
        mask_ok = torch.where(state.in_speech[:, None], frame_ok,
                              pre_speech_ok)
        logits = logits.masked_fill(
            params.frame_protocol[:, None] & ~mask_ok, NEG_INF)
    logits = apply_repetition_penalty(logits, state.presence[:, base:],
                                      params.repetition_penalty)
    greedy = params.temperature <= 0.0
    safe_temp = torch.where(greedy, torch.ones_like(params.temperature),
                            params.temperature)
    scaled = logits / safe_temp[:, None]

    if nucleus_cap and nucleus_cap < vocab:
        cap = nucleus_cap
        vals, idx = torch.topk(scaled, cap, dim=-1)      # sorted descending
        pos = torch.arange(cap, device=dev)[None, :]
        k_eff = torch.where(params.top_k <= 0,
                            torch.full_like(params.top_k, cap), params.top_k)
        vals = vals.masked_fill(pos >= k_eff[:, None], NEG_INF)
        probs = torch.softmax(vals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < params.top_p[:, None]
        vals = vals.masked_fill(~keep, NEG_INF)
    else:
        vals = top_p_mask(top_k_mask(scaled, params.top_k), params.top_p)
        idx = None

    u = noise_uniforms(state, vals.shape[-1]) if uniforms is None \
        else uniforms.to(device=dev, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u))
    choice = torch.argmax(vals + gumbel, dim=-1)
    sampled = choice if idx is None else idx.gather(1, choice[:, None])[:, 0]
    greedy_tok = torch.argmax(logits, dim=-1)
    tokens = (base + torch.where(greedy, greedy_tok, sampled)).to(torch.int32)

    # frame-position tracking (advances regardless of the structured flag so
    # it can be enabled mid-stream)
    abase = protocol.TOKEN_AUDIO_BASE
    is_audio = (tokens >= abase) & (tokens < abase + protocol.AUDIO_VOCAB)
    in_speech = state.in_speech | (tokens == protocol.TOKEN_SOS)
    frame_pos = torch.where(is_audio & in_speech,
                            (state.frame_pos + 1) % protocol.FRAME_SIZE,
                            state.frame_pos)
    new_state = mark_tokens(
        state._replace(step=state.step + 1, in_speech=in_speech,
                       frame_pos=frame_pos.to(torch.int32)),
        tokens,
    )
    return tokens, new_state
