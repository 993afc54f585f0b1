"""K5: paged GQA decode attention over int4 K/V pools packed by head pair.

Port of ``tts_inference_tpu/ops/pallas/paged_attention_int4.py``. The kernel
is hand-written CUDA C++ for Hopper (``csrc/paged_attention.cu``: a third
key addressing of the bodies in ``csrc/attention.cuh``; a bf16 query at D
64 / 128 runs the tensor-core body with one block per head pair, which
reads each packed byte once); beside it,
``paged_decode_attention_int4_reference`` is the plain PyTorch version:
gather the window's blocks, unpack the nibbles, dequantize in f32 with the
nibble-plane scales, then dense masked attention. The wrapper takes the
plain version only for tensors on the CPU; a CUDA tensor launches the kernel
or raises.

Packing — *head-pair split, head-batched*: kv heads (2p, 2p+1) share packed
pool slab p: head 2p in the low nibble, offset-encoded (bits = q + 8), head
2p+1 in the high nibble, two's complement. Scales are per (block, position,
head), kept in two nibble planes: plane 0 = low heads (2p), plane 1 = high
heads (2p+1). The k scale multiplies the score column, the v scale the
probability row, the softmax denominator stays unscaled — equal to
dequantizing K/V first, by linearity.

Shapes (N = pool blocks, bs = block size, Hkv = kv heads, P2 = Hkv/2,
G = query heads per kv head, D = head dim, WB = window blocks):
    q:       (B, Hkv, G, D)
    kp, vp:  (N, P2, bs, D) int8 — packed pools
    ks, vs:  (N, 2, P2, bs) f32  — per-(block, nibble plane, pair, position)
    table:   (B, WB) int32       — pool row of each slot's logical block
    pos:     (B,) int32          — kv index j attends iff j <= pos[slot]
    out:     (B, Hkv, G, D) in q's dtype
Unlike the TPU kernel, G is not padded and q is not rearranged by nibble
plane.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tts_inference_tpu_torch.ops import _build
from tts_inference_tpu_torch.ops import paged_attention as _pa
from tts_inference_tpu_torch.ops.decode_attention import \
    decode_attention_reference

launches = _build.LaunchCounter()        # K5


def pack_kv_int4(q4: torch.Tensor) -> torch.Tensor:
    """(..., Hkv, D) integers in [-7, 7] → (..., Hkv/2, D) int8, head-pair
    split: pair slab p holds head 2p (low nibble, bits q + 8) and head 2p+1
    (high nibble, two's complement)."""
    hkv, d = q4.shape[-2:]
    if hkv % 2:
        raise ValueError(f"pack_kv_int4: {hkv} kv heads (head-pair packing "
                         "needs an even count)")
    pairs = q4.reshape(*q4.shape[:-2], hkv // 2, 2, d)
    # read as a signed byte, (hi << 4) | (lo + 8) is hi·16 + lo + 8: the high
    # nibble's multiple of 16 leaves the low four bits to the offset value
    return (pairs[..., 1, :] * 16 + pairs[..., 0, :] + 8).to(torch.int8)


def unpack_kv_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., Hkv/2, D) int8 → (..., Hkv, D) int32 (inverse of
    pack_kv_int4)."""
    p = packed.to(torch.int32)
    hi = p >> 4                          # arithmetic: the signed high nibble
    lo = (p - (hi << 4)) - 8             # the unsigned low bits, decoded
    both = torch.stack([lo, hi], dim=-2)           # (..., Hkv/2, 2, D)
    return both.reshape(*packed.shape[:-2], packed.shape[-2] * 2,
                        packed.shape[-1])


def quantize_kv_int4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., Hkv, D) → packed (..., Hkv/2, D) int8 + (..., Hkv) f32 scales in
    natural head order: symmetric per-(position, head) absmax / 7, round
    half to even (as jnp.round)."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 7.0).clamp(min=1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-7, 7)
    return pack_kv_int4(q), scale


def scales_to_planes(scale: torch.Tensor) -> torch.Tensor:
    """(..., Hkv) natural head order → (..., 2, Hkv/2) nibble planes (plane 0
    = low heads 2p, plane 1 = high heads 2p+1)."""
    hkv = scale.shape[-1]
    return scale.reshape(*scale.shape[:-1], hkv // 2, 2).transpose(-1, -2)


def planes_to_scales(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of scales_to_planes: (..., 2, Hkv/2) → (..., Hkv)."""
    p2 = planes.shape[-1]
    return planes.transpose(-1, -2).reshape(*planes.shape[:-2], 2 * p2)


def gather_window_int4(pool: torch.Tensor, scale_pool: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """Gather the table's blocks of an int4 pool into a dense dequantized
    window: (N, P2, bs, D) int8 + (N, 2, P2, bs) f32 scales, (B, WB) table →
    (B, WB·bs, Hkv, D) f32."""
    b, wb = table.shape
    bs, d = pool.shape[2:]
    idx = table.long()
    # (B, WB, P2, bs, D) → (B, WB, bs, P2, D) → integers (B, WB, bs, Hkv, D)
    ints = unpack_kv_int4(pool[idx].movedim(2, 3))
    # (B, WB, 2, P2, bs) → (B, WB, bs, 2, P2) → (B, WB, bs, Hkv)
    sc = planes_to_scales(scale_pool[idx].movedim(4, 2))
    return (ints.float() * sc[..., None]).reshape(b, wb * bs, -1, d)


def paged_decode_attention_int4_reference(q, kp_pool, vp_pool, ks_pool,
                                          vs_pool, table, pos):
    """Plain PyTorch version: gather, unpack and dequantize the window in
    f32, then dense masked attention."""
    return decode_attention_reference(
        q, gather_window_int4(kp_pool, ks_pool, table),
        gather_window_int4(vp_pool, vs_pool, table), pos)


def paged_decode_attention_int4(q, kp_pool, vp_pool, ks_pool, vs_pool, table,
                                pos):
    """K5: (B, Hkv, G, D) attention over int4 pools packed by head pair, with
    nibble-plane f32 scale pools; kernel on CUDA, plain version on the
    CPU."""
    if q.device.type == "cpu":
        _pa.check_paged("paged_decode_attention_int4", q, kp_pool, vp_pool,
                        table, pos, (ks_pool, vs_pool), heads_per_row=2)
        return paged_decode_attention_int4_reference(
            q, kp_pool, vp_pool, ks_pool, vs_pool, table, pos)
    return _pa.launch_paged("tts_paged_attention_int4", launches, q, kp_pool,
                            vp_pool, (ks_pool, vs_pool), table, pos,
                            heads_per_row=2)
