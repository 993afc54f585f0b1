"""Llama-3.2-style causal decoder (the Orpheus-3B body), dense path.

Port of ``tts_inference_tpu/models/llama.py``: plain functions over the
parameter tree (``weights.py``), feature-last matmuls (``x @ w``), f32
normalization/softmax islands inside a bf16 graph, and a dense slotted KV
cache with per-slot lengths for continuous batching.

Differences from the JAX package, all deliberate:
- the KV cache is updated IN PLACE (JAX relied on buffer donation to get the
  same effect); ``forward`` still returns the cache for call-site parity;
- a single decode token (s == 1) runs K1, ``ops.decode_attention`` — the
  hand-written kernel on CUDA, its plain version on the CPU — where the JAX
  serve default ran the einsum path; prefill runs ``_attention``;
- only the dense bf16/f32 cache: no paged, int8 or int4 branches yet
  (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tts_inference_tpu.config import ModelConfig
from tts_inference_tpu_torch.models.quant import (embed_rows, head_logits, mm,
                                                  tied_logits)
from tts_inference_tpu_torch.ops.decode_attention import decode_attention

Params = Dict


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.dtype]


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def rope_inv_freq(cfg: ModelConfig) -> np.ndarray:
    """Inverse frequencies, with HF "llama3" rope scaling when configured."""
    d = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
    if cfg.rope_scaling_factor is None:
        return inv.astype(np.float32)
    factor = cfg.rope_scaling_factor
    lo_f, hi_f = cfg.rope_low_freq_factor, cfg.rope_high_freq_factor
    orig = cfg.rope_original_max_position
    low_wl = orig / lo_f
    high_wl = orig / hi_f
    wavelen = 2 * np.pi / inv
    scaled = np.where(wavelen > low_wl, inv / factor, inv)
    smooth = (orig / wavelen - lo_f) / (hi_f - lo_f)
    mid = (1 - smooth) * inv / factor + smooth * inv
    is_mid = (wavelen >= high_wl) & (wavelen <= low_wl)
    return np.where(is_mid, mid, scaled).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _inv_freq_on(cfg: ModelConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rope_inv_freq(cfg)).to(device)


def rope_tables(cfg: ModelConfig, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (…,) int → cos/sin tables (…, head_dim/2) f32."""
    ang = positions.float()[..., None] * _inv_freq_on(cfg, positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate halves (HF convention). x: (B, S, H, D); cos/sin: (B, S, D/2)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


@dataclasses.dataclass
class KVCache:
    """Dense slotted KV cache, updated in place.

    k/v: per-layer (batch, max_seq, kv_heads, head_dim) tensors; lengths:
    (batch,) int32 — tokens currently valid per slot.
    """

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    lengths: torch.Tensor

    @property
    def max_seq(self) -> int:
        return self.k[0].shape[1]


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
                  device="cpu") -> KVCache:
    shape = (batch, max_seq, cfg.num_key_value_heads, cfg.head_dim)
    dt = dtype or param_dtype(cfg)
    n = cfg.num_hidden_layers
    return KVCache(
        k=[torch.zeros(shape, dtype=dt, device=device) for _ in range(n)],
        v=[torch.zeros(shape, dtype=dt, device=device) for _ in range(n)],
        lengths=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def _attention(q, k, v, mask):
    """GQA attention (prefill): q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D),
    mask (B, Sq, Skv) bool, True = attend. Scores and p·v in f32; the
    probabilities are rounded to v's dtype first, like the JAX einsum."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    logits = logits * (1.0 / math.sqrt(d))
    logits = logits.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def _write_cache(c: torch.Tensor, new: torch.Tensor, write_pos: torch.Tensor,
                 write_mask: torch.Tensor) -> None:
    """Write new (B, S, Hkv, D) at each slot's write_pos, in place, only for
    slots in write_mask (continuous batching: prefilling one slot must not
    clobber a slot that is mid-generation)."""
    b, s = new.shape[:2]
    max_seq = c.shape[1]
    bi = torch.arange(b, device=c.device)
    if s == 1:
        # decode: masked slots write the trash row max_seq-1, which is never
        # attended (active slots are frozen before reaching it)
        eff = torch.where(write_mask, write_pos,
                          torch.full_like(write_pos, max_seq - 1))
        c.index_put_((bi, eff.long()), new[:, 0].to(c.dtype))
        return
    # chunk: per-slot slice at write_pos (clamped so it fits, like
    # dynamic_update_slice); masked slots rewrite their old rows
    start = write_pos.long().clamp(0, max_seq - s)
    idx = start[:, None] + torch.arange(s, device=c.device)[None, :]
    old = c[bi[:, None], idx]
    keep = write_mask[:, None, None, None]
    c.index_put_((bi[:, None], idx), torch.where(keep, new.to(c.dtype), old))


def _layer(lp: Params, cfg: ModelConfig, x, cos, sin, cache_k, cache_v,
           write_pos, mask, write_mask, kv_window: Optional[int]):
    b, s, _ = x.shape
    hd, nq, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads

    h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
    q = mm(h, lp["wq"]).reshape(b, s, nq, hd)
    k = mm(h, lp["wk"]).reshape(b, s, nkv, hd)
    v = mm(h, lp["wv"]).reshape(b, s, nkv, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    _write_cache(cache_k, k, write_pos, write_mask)
    _write_cache(cache_v, v, write_pos, write_mask)

    if kv_window is not None and kv_window < cache_k.shape[1]:
        ck, cv = cache_k[:, :kv_window], cache_v[:, :kv_window]
    else:
        ck, cv = cache_k, cache_v
    if s == 1:
        qg = q.reshape(b, nkv, nq // nkv, hd)
        attn = decode_attention(qg, ck, cv, write_pos)
    else:
        attn = _attention(q, ck, cv, mask)
    x = x + mm(attn.reshape(b, s, nq * hd), lp["wo"])

    h = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
    gate = F.silu(mm(h, lp["w_gate"]).float()).to(h.dtype)
    return x + mm(gate * mm(h, lp["w_up"]), lp["w_down"])


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: KVCache, write_pos: torch.Tensor, seg_lens: torch.Tensor,
            kv_window: Optional[int] = None
            ) -> Tuple[torch.Tensor, KVCache]:
    """Process a token chunk against the cache (updated in place); returns
    (final-norm hidden states (B, S, H), cache).

    Positions are write_pos + arange(S); kv slot j is attended by query
    position p iff j <= p. ``kv_window`` bounds the attention read to the
    cache prefix (the decode step is memory-bound)."""
    b, s = tokens.shape
    max_seq = cache.max_seq
    window = max_seq if kv_window is None else min(kv_window, max_seq)
    write_pos = write_pos.to(torch.int32)
    positions = write_pos[:, None] + torch.arange(
        s, dtype=torch.int32, device=tokens.device)[None, :]
    cos, sin = rope_tables(cfg, positions)
    mask = None
    if s > 1:
        kv_idx = torch.arange(window, dtype=torch.int32, device=tokens.device)
        mask = kv_idx[None, None, :] <= positions[:, :, None]
    write_mask = seg_lens > 0
    x = embed_rows(params["embed"], tokens, param_dtype(cfg))
    for li, lp in enumerate(params["layers"]):
        x = _layer(lp, cfg, x, cos, sin, cache.k[li], cache.v[li], write_pos,
                   mask, write_mask, window if window < max_seq else None)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    cache.lengths.copy_(torch.maximum(cache.lengths,
                                      write_pos + seg_lens.to(torch.int32)))
    return x, cache


def compute_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor,
                   base: int = 0) -> torch.Tensor:
    """Final-norm hidden (…, H) → f32 logits (…, V - base); logit i is token
    id base + i (the sliced-head decode path skips rows below base)."""
    if cfg.tie_word_embeddings or "lm_head" not in params:
        return tied_logits(hidden, params["embed"], base)
    return head_logits(hidden, params["lm_head"], base)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            prompt_lens: torch.Tensor, cache: KVCache,
            kv_window: Optional[int] = None, logits_base: int = 0
            ) -> Tuple[torch.Tensor, KVCache]:
    """Prefill the cache; returns (last-valid-position logits (B, V), cache).
    A prompt only attends to itself, so kv_window defaults to the bucket."""
    zero = torch.zeros_like(prompt_lens)
    if kv_window is None:
        kv_window = tokens.shape[1]
    hidden, cache = forward(params, cfg, tokens, cache, zero, prompt_lens,
                            kv_window=kv_window)
    last = (prompt_lens - 1).clamp(min=0).long()
    b = tokens.shape[0]
    last_hidden = hidden[torch.arange(b, device=hidden.device), last]
    return compute_logits(params, cfg, last_hidden, logits_base), cache


def decode_one(params: Params, cfg: ModelConfig, token: torch.Tensor,
               cache: KVCache, active: Optional[torch.Tensor] = None,
               kv_window: Optional[int] = None, logits_base: int = 0
               ) -> Tuple[torch.Tensor, KVCache]:
    """One decode step for every slot; returns (logits (B, V), cache).

    ``active`` (B,) bool freezes finished slots: their KV write lands at the
    trash row (max_seq-1, never attended) and lengths don't advance."""
    seg = (torch.ones_like(cache.lengths) if active is None
           else active.to(torch.int32))
    hidden, cache = forward(params, cfg, token[:, None], cache,
                            cache.lengths.clone(), seg, kv_window=kv_window)
    return compute_logits(params, cfg, hidden[:, 0], logits_base), cache
