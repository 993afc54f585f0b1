"""Llama-3.2-style causal decoder (the Orpheus-3B body).

Port of ``tts_inference_tpu/models/llama.py``: plain functions over the
parameter tree (``weights.py``), feature-last matmuls (``x @ w``), f32
normalization/softmax islands inside a bf16 graph, and a slotted KV cache
with per-slot lengths for continuous batching — dense (``KVCache``, bf16/f32
or int8 with per-position scales) or paged (``PagedKVCache``: a pool of
blocks shared by all slots, addressed through a per-slot block table).

Differences from the JAX package, all deliberate:
- both caches are updated IN PLACE, where JAX relied on buffer donation for
  the same effect; ``forward`` still returns the cache for call-site parity;
- a single decode token (s == 1) always runs a kernel: K1
  (``ops.decode_attention``) over the dense window — dequantized first for
  int8 — and K3a/K3b (``ops.paged_attention``) or K5
  (``ops.paged_attention_int4``) over the paged pools; the hand-written
  kernel on CUDA, its plain version on the CPU. Prefill and other chunks
  (s > 1) run ``_attention`` over the gathered (and, for quantized pools,
  dequantized) window;
- the linears go through ``models.quant.mm``: plain weights to
  ``torch.matmul``, int8 and int4 leaves to the kernels K2 and K4.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from tts_inference_tpu_torch.config import ModelConfig
from tts_inference_tpu_torch.models.quant import (embed_rows, head_logits, mm,
                                                  tied_logits)
from tts_inference_tpu_torch.ops.decode_attention import decode_attention
from tts_inference_tpu_torch.ops.paged_attention import (
    gather_window, paged_decode_attention, paged_decode_attention_int8)
from tts_inference_tpu_torch.ops.paged_attention_int4 import (
    gather_window_int4, paged_decode_attention_int4, quantize_kv_int4,
    scales_to_planes)

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
    (batch,) int32 — tokens currently valid per slot. int8 mode: k/v are
    int8 with per-(slot, position, head) f32 scales in k_scale/v_scale,
    (batch, max_seq, kv_heads); empty scale lists mean full precision.
    """

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    lengths: torch.Tensor
    k_scale: List[torch.Tensor] = dataclasses.field(default_factory=list)
    v_scale: List[torch.Tensor] = dataclasses.field(default_factory=list)

    @property
    def max_seq(self) -> int:
        return self.k[0].shape[1]

    @property
    def quantized(self) -> bool:
        return len(self.k_scale) > 0


@dataclasses.dataclass
class PagedKVCache:
    """Paged KV cache, updated in place.

    k/v: per-layer head-batched (num_blocks, kv_heads, block_size, head_dim)
    pools shared by all slots; block_table: (batch, max_blocks) int32 maps a
    slot's logical block to a pool row. Block 0 is the TRASH block: never
    allocated, the write target of masked slots and unallocated table
    entries (which are 0), and never attended — reads are masked by
    position. int8 mode: int8 pools plus per-(block, head, position) f32
    scale pools (num_blocks, kv_heads, block_size). int4 mode: pools are
    packed by head pair, (num_blocks, kv_heads/2, block_size, head_dim) int8
    (``ops/paged_attention_int4.py`` has the layout), and the scale pools are
    (num_blocks, 2, kv_heads/2, block_size) nibble planes: half the int8
    pools' bytes, in capacity and in what a decode step reads.
    """

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    block_table: torch.Tensor
    lengths: torch.Tensor
    k_scale: List[torch.Tensor] = dataclasses.field(default_factory=list)
    v_scale: List[torch.Tensor] = dataclasses.field(default_factory=list)

    @property
    def block_size(self) -> int:
        return self.k[0].shape[2]

    @property
    def num_blocks(self) -> int:
        return self.k[0].shape[0]

    @property
    def max_seq(self) -> int:
        """Per-slot position capacity (table width × block size)."""
        return self.block_table.shape[1] * self.block_size

    @property
    def quantized(self) -> bool:
        return len(self.k_scale) > 0

    @property
    def int4(self) -> bool:
        """Pools packed by head pair (the scale pools then have a nibble
        plane axis)."""
        return self.quantized and self.k_scale[0].dim() == 4


Cache = Union[KVCache, PagedKVCache]


def _layers(n: int, shape, dtype, device) -> List[torch.Tensor]:
    return [torch.zeros(shape, dtype=dtype, device=device) for _ in range(n)]


def init_paged_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
                        num_blocks: int, block_size: int = 128, dtype=None,
                        int8: bool = False, int4: bool = False,
                        device="cpu") -> PagedKVCache:
    """Pool of `num_blocks` blocks (block 0 is the trash block) and per-slot
    tables sized for max_seq positions."""
    if max_seq % block_size:
        raise ValueError(f"max_seq {max_seq} not a multiple of block_size "
                         f"{block_size}")
    if int8 and int4:
        raise ValueError("kv int8 and int4 are mutually exclusive")
    n, hkv = cfg.num_hidden_layers, cfg.num_key_value_heads
    shape = (num_blocks, hkv, block_size, cfg.head_dim)
    table = torch.zeros((batch, max_seq // block_size), dtype=torch.int32,
                        device=device)
    lengths = torch.zeros(batch, dtype=torch.int32, device=device)
    if int4:
        if hkv % 2:
            raise ValueError(f"int4 KV needs an even kv-head count, got "
                             f"{hkv} (head-pair packing)")
        pshape = (num_blocks, hkv // 2, block_size, cfg.head_dim)
        sshape = (num_blocks, 2, hkv // 2, block_size)   # nibble planes
        return PagedKVCache(
            k=_layers(n, pshape, torch.int8, device),
            v=_layers(n, pshape, torch.int8, device),
            block_table=table, lengths=lengths,
            k_scale=_layers(n, sshape, torch.float32, device),
            v_scale=_layers(n, sshape, torch.float32, device))
    if int8:
        sshape = (num_blocks, hkv, block_size)
        return PagedKVCache(
            k=_layers(n, shape, torch.int8, device),
            v=_layers(n, shape, torch.int8, device),
            block_table=table, lengths=lengths,
            k_scale=_layers(n, sshape, torch.float32, device),
            v_scale=_layers(n, sshape, torch.float32, device))
    dt = dtype or param_dtype(cfg)
    return PagedKVCache(k=_layers(n, shape, dt, device),
                        v=_layers(n, shape, dt, device),
                        block_table=table, lengths=lengths)


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
                  device="cpu", int8: bool = False) -> KVCache:
    shape = (batch, max_seq, cfg.num_key_value_heads, cfg.head_dim)
    n = cfg.num_hidden_layers
    lengths = torch.zeros(batch, dtype=torch.int32, device=device)
    if int8:
        return KVCache(
            k=_layers(n, shape, torch.int8, device),
            v=_layers(n, shape, torch.int8, device), lengths=lengths,
            k_scale=_layers(n, shape[:3], torch.float32, device),
            v_scale=_layers(n, shape[:3], torch.float32, device))
    dt = dtype or param_dtype(cfg)
    return KVCache(k=_layers(n, shape, dt, device),
                   v=_layers(n, shape, dt, device), lengths=lengths)


def pool_scatter(c: torch.Tensor, rows: torch.Tensor, offs: torch.Tensor,
                 new: torch.Tensor, n_mid: int = 1,
                 memo: Optional[dict] = None) -> torch.Tensor:
    """Scatter per-position values into a head-batched pool, in place.

    c: (N, *mid, bs[, D]) pool; rows/offs: (B, S) pool row / in-block
    offset per position; new: (B, S, *mid[, D]); n_mid = number of pool
    axes between the block row and the position axis (1 for the K/V pools
    and the int8 scale pools, 2 for the int4 nibble-plane scale pools).
    Flattening (N, *mid) into one leading axis
    makes the two indexed axes adjacent, so one ``index_put_`` writes every
    (position, head) row. Duplicate indices occur only in the trash block
    (row 0), where the surviving value does not matter. The two index
    tensors depend on (rows, offs) and the pool's middle width only, which
    are the same for every layer of a forward pass: `memo` keeps them."""
    n = c.shape[0]
    mid = int(np.prod(c.shape[1:1 + n_mid]))
    tail = c.shape[1 + n_mid:]
    b, s = rows.shape
    if memo is not None and mid in memo:
        flat, offs_b = memo[mid]
    else:
        flat = rows.long()[:, :, None] * mid + torch.arange(
            mid, device=c.device)[None, None, :]
        offs_b = offs.long()[:, :, None].expand(b, s, mid)
        if memo is not None:
            memo[mid] = (flat, offs_b)
    c.view((n * mid,) + tuple(tail)).index_put_(
        (flat, offs_b), new.reshape((b, s, mid) + tuple(tail[1:])).to(c.dtype))
    return c


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, H, D) → int8 values + (B, S, H) f32 scales (absmax / 127,
    round half to even, as jnp.round)."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp(min=1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


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
    """Write new (B, S, …) at each slot's write_pos of a dense (B, max_seq,
    …) cache or scale tensor, in place, only for slots in write_mask
    (continuous batching: prefilling one slot must not clobber a slot that
    is mid-generation)."""
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
    keep = write_mask.view((b,) + (1,) * (new.dim() - 1))
    c.index_put_((bi[:, None], idx), torch.where(keep, new.to(c.dtype), old))


def _paged_slots(table: torch.Tensor, write_pos: torch.Tensor, s: int,
                 write_mask: torch.Tensor, bs: int):
    """Pool row and in-block offset (B, S) of each written position:
    position p of slot i lives at row table[i, p // bs], offset p % bs.
    Masked slots, unallocated blocks (table entry 0) and positions past the
    table land in the trash block, row 0."""
    pos = write_pos[:, None] + torch.arange(s, dtype=torch.int32,
                                            device=table.device)[None, :]
    blk = (pos // bs).long()
    cap = table.shape[1]
    rows = table.gather(1, blk.clamp(max=cap - 1))
    rows = torch.where(write_mask[:, None] & (blk < cap), rows,
                       torch.zeros_like(rows))
    return rows, pos % bs


def _dequant(c: torch.Tensor, sc: torch.Tensor, dtype) -> torch.Tensor:
    return (c.float() * sc[..., None]).to(dtype)


def _layer(lp: Params, cfg: ModelConfig, x, cos, sin, cache, li: int,
           write_pos, mask, write_mask, kv_window: Optional[int], paged_at):
    """One decoder layer; writes this chunk's K/V into layer `li` of the
    cache. paged_at: (rows, offs, memo) of the written positions for a
    paged cache (``_paged_slots`` plus ``pool_scatter``'s index memo), None
    for a dense one."""
    b, s, _ = x.shape
    hd, nq, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads

    h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
    q = mm(h, lp["wq"]).reshape(b, s, nq, hd)
    k = mm(h, lp["wk"]).reshape(b, s, nkv, hd)
    v = mm(h, lp["wv"]).reshape(b, s, nkv, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    ck, cv = cache.k[li], cache.v[li]
    ks = cache.k_scale[li] if cache.quantized else None
    vs = cache.v_scale[li] if cache.quantized else None
    packed_i4 = paged_at is not None and cache.int4
    if packed_i4:
        kq, k_sc = quantize_kv_int4(k)      # (B, S, P2, D), (B, S, Hkv)
        vq, v_sc = quantize_kv_int4(v)
        writes = ((ck, kq, 1), (cv, vq, 1),
                  (ks, scales_to_planes(k_sc), 2),
                  (vs, scales_to_planes(v_sc), 2))
    elif cache.quantized:
        kq, k_sc = _quantize_kv(k)
        vq, v_sc = _quantize_kv(v)
        writes = ((ck, kq, 1), (cv, vq, 1), (ks, k_sc, 1), (vs, v_sc, 1))
    else:
        writes = ((ck, k, 1), (cv, v, 1))
    for c, new, n_mid in writes:
        if paged_at is not None:
            pool_scatter(c, paged_at[0], paged_at[1], new, n_mid=n_mid,
                         memo=paged_at[2])
        else:
            _write_cache(c, new, write_pos, write_mask)

    if paged_at is not None:
        bs = ck.shape[2]
        cap = cache.block_table.shape[1] * bs
        w = cap if kv_window is None or kv_window >= cap else kv_window
        idx = cache.block_table[:, : w // bs]     # forward() block-aligns w
        if s == 1:
            qg = q.reshape(b, nkv, nq // nkv, hd)
            if packed_i4:
                attn = paged_decode_attention_int4(qg, ck, cv, ks, vs, idx,
                                                   write_pos)
            elif cache.quantized:
                attn = paged_decode_attention_int8(qg, ck, cv, ks, vs, idx,
                                                   write_pos)
            else:
                attn = paged_decode_attention(qg, ck, cv, idx, write_pos)
        elif packed_i4:
            # prefill / resume chunk: gather, unpack and dequantize
            kw = gather_window_int4(ck, ks, idx).to(k.dtype)
            vw = gather_window_int4(cv, vs, idx).to(k.dtype)
            attn = _attention(q, kw, vw, mask)
        else:
            # prefill / resume chunk: gather the window's blocks
            kw, vw = gather_window(ck, idx), gather_window(cv, idx)
            if cache.quantized:
                kw = _dequant(kw, gather_window(ks, idx), k.dtype)
                vw = _dequant(vw, gather_window(vs, idx), k.dtype)
            attn = _attention(q, kw, vw, mask)
    else:
        win = (slice(None), slice(None, kv_window))
        kw, vw = ck[win], cv[win]
        if cache.quantized:
            kw = _dequant(kw, ks[win], k.dtype)
            vw = _dequant(vw, vs[win], k.dtype)
        if s == 1:
            qg = q.reshape(b, nkv, nq // nkv, hd)
            attn = decode_attention(qg, kw, vw, write_pos)
        else:
            attn = _attention(q, kw, vw, mask)
    x = x + mm(attn.reshape(b, s, nq * hd), lp["wo"])

    h = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
    gate = F.silu(mm(h, lp["w_gate"]).float()).to(h.dtype)
    return x + mm(gate * mm(h, lp["w_up"]), lp["w_down"])


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Cache, write_pos: torch.Tensor,
            seg_lens: torch.Tensor, kv_window: Optional[int] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Process a token chunk against the cache (updated in place); returns
    (final-norm hidden states (B, S, H), cache).

    Positions are write_pos + arange(S); kv slot j is attended by query
    position p iff j <= p. ``kv_window`` bounds the attention read to the
    cache prefix (the decode step is memory-bound); a paged cache rounds it
    up to whole blocks."""
    b, s = tokens.shape
    max_seq = cache.max_seq
    window = max_seq if kv_window is None else min(kv_window, max_seq)
    paged = isinstance(cache, PagedKVCache)
    if paged:  # the paged view gathers whole blocks
        bs = cache.block_size
        window = min(-(-window // bs) * bs, max_seq)
    write_pos = write_pos.to(torch.int32)
    positions = write_pos[:, None] + torch.arange(
        s, dtype=torch.int32, device=tokens.device)[None, :]
    cos, sin = rope_tables(cfg, positions)
    mask = None
    if s > 1:
        kv_idx = torch.arange(window, dtype=torch.int32, device=tokens.device)
        mask = kv_idx[None, None, :] <= positions[:, :, None]
    write_mask = seg_lens > 0
    paged_at = ((*_paged_slots(cache.block_table, write_pos, s, write_mask,
                               cache.block_size), {}) if paged else None)
    x = embed_rows(params["embed"], tokens, param_dtype(cfg))
    for li, lp in enumerate(params["layers"]):
        x = _layer(lp, cfg, x, cos, sin, cache, li, write_pos, mask,
                   write_mask, window if window < max_seq else None, paged_at)
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
            prompt_lens: torch.Tensor, cache: Cache,
            kv_window: Optional[int] = None, logits_base: int = 0
            ) -> Tuple[torch.Tensor, Cache]:
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
               cache: Cache, active: Optional[torch.Tensor] = None,
               kv_window: Optional[int] = None, logits_base: int = 0
               ) -> Tuple[torch.Tensor, Cache]:
    """One decode step for every slot; returns (logits (B, V), cache).

    ``active`` (B,) bool freezes finished slots: their KV write lands in the
    trash (row max_seq-1 of a dense cache, block 0 of a paged one; never
    attended) and lengths don't advance."""
    seg = (torch.ones_like(cache.lengths) if active is None
           else active.to(torch.int32))
    hidden, cache = forward(params, cfg, token[:, None], cache,
                            cache.lengths.clone(), seg, kv_window=kv_window)
    return compute_logits(params, cfg, hidden[:, 0], logits_base), cache
