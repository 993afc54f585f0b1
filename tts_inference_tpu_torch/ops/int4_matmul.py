"""K4 / K2: weight-only quantized matmuls (int4 packed, and its int8 twin).

K4 is the port of ``tts_inference_tpu/ops/pallas/int4_matmul.py``::

    int4_mm(x, w_p, scales)      y = x @ dequant(w_p, scales)

K2 has no TPU kernel (the JAX package's ``models/quant.py`` left the int8
convert to its compiler); it is K4's body with another unpack::

    w8_mm(x, w_i8, scale)               y = (x @ w_i8) * scale, w_i8 (K, N)
    w8_mm(x, w_i8, scale, rows=True)    the same with w_i8 (N, K): the tied
                                        head over a row slice of the (V, H)
                                        int8 embedding, read in place

Both kernels are hand-written CUDA C++ for Hopper (``csrc/quant_matmul.cu``):
bf16 activations go through the tensor cores (``mma.sync`` on the weights as
they are stored), f32 activations through f32 FMAs on the CUDA cores.
Beside them ``int4_mm_reference`` and ``w8_mm_reference`` are the plain
PyTorch versions (unpack, dequantize, f32 product). The wrappers take the
plain versions only for tensors on the CPU; a CUDA tensor launches the
kernel or raises. Unlike the JAX package, the kernel also takes the tiny
configuration's shapes (K 64 and 128, groups 32 and 64): there is no switch
to the plain version by shape.

The packed format is the JAX package's, bit for bit — *global split-half*
along K: packed row i holds q[i] in the low nibble, offset-encoded (bits =
q + 8), and q[K/2 + i] in the high nibble, two's complement.

Shapes:
    x:      (..., K)      activations, bf16 or f32
    w_p:    (K//2, Np)    packed int8; Np >= N (the JAX package pads the out
                          dimension to a multiple of 128 in the packed array)
    scales: (K//G, N)     f32 per-(group, out channel); G | K/2
    w_i8:   (K, N) int8, any row stride, or with rows=True (N, K)
    scale:  (N,) f32
    out:    (..., N)      x.dtype, or ``out_dtype`` (f32 logits)
"""

from __future__ import annotations

from typing import Optional

import torch

from tts_inference_tpu_torch.ops import _build

launches = _build.LaunchCounter()      # K4
launches_w8 = _build.LaunchCounter()   # K2

GROUP = 512          # quantization group along K (G | K/2)

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_FMT_I4, _FMT_I8, _FMT_I8_ROWS = 0, 1, 2
_splits: dict = {}   # launch arguments → K splits the library will use


def pick_group(k: int, group: int = GROUP) -> int:
    """Largest usable group <= `group` for a K of `k` (groups must tile each
    packed half: G | K/2)."""
    g = min(group, max(1, k // 2))
    while k // 2 % g:
        g //= 2
    return g


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(K, N) integers in [-8, 7] → (K//2, N) int8, global split-half: low
    half of K → offset-encoded low nibbles (bits = q + 8), high half →
    two's-complement high nibbles."""
    k = q.shape[0]
    if k % 2:
        raise ValueError(f"pack_int4: K {k} must be even")
    h = k // 2
    # read as a signed byte, (hi << 4) | (lo + 8) is hi·16 + lo + 8: the high
    # nibble's multiple of 16 leaves the low four bits to the offset value
    return (q[h:].to(torch.int32) * 16 + q[:h].to(torch.int32) + 8).to(
        torch.int8)


def unpack_int4(w_p: torch.Tensor) -> torch.Tensor:
    """(K//2, N) int8 → (K, N) int32 in [-8, 7] (inverse of pack_int4)."""
    p = w_p.to(torch.int32)
    hi = p >> 4                         # arithmetic: the signed high nibble
    lo = (p - (hi << 4)) - 8            # the unsigned low bits, offset-decoded
    return torch.cat([lo, hi], dim=0)


def int4_mm_reference(x: torch.Tensor, w_p: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: unpack, dequantize, matmul, all in f32;
    the result is rounded once to x.dtype."""
    k = x.shape[-1]
    n = scales.shape[1]
    group = k // scales.shape[0]
    q = unpack_int4(w_p)[:, :n].float()
    w = (q.reshape(k // group, group, n)
         * scales.float()[:, None, :]).reshape(k, n)
    out = x.float().reshape(-1, k) @ w
    return out.to(x.dtype).reshape(*x.shape[:-1], n)


def w8_mm_reference(x: torch.Tensor, w_i8: torch.Tensor, scale: torch.Tensor,
                    *, rows: bool = False,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version of K2: f32 product of x and the integers, scaled
    once per out channel, rounded once to `out_dtype` (default x.dtype)."""
    w = w_i8.float()
    if rows:
        w = w.t()
    k, n = w.shape
    out = (x.float().reshape(-1, k) @ w) * scale.float()
    return out.to(out_dtype or x.dtype).reshape(*x.shape[:-1], n)


def _check_x(name: str, x: torch.Tensor, out_dtype) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: x is {x.dtype}; the kernel takes bf16 or "
                        "f32")
    if out_dtype not in _DTYPES:
        raise TypeError(f"{name}: out dtype {out_dtype}; the kernel writes "
                        "bf16 or f32")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"{name}: x {tuple(x.shape)} is empty")


def _launch(name, counter, fmt, x, w, scale, n, nw, ldw, group, out_dtype):
    """Launch the kernel of format `fmt` over x flattened to (M, K)."""
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    m = x2.shape[0]
    if x2.data_ptr() % 16 or scale.data_ptr() % 4:
        raise ValueError(f"{name}: x must be 16-byte aligned")
    if {x.device, w.device, scale.device} != {x.device} \
            or x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for tensors on {x.device}, "
                         f"{w.device}, {scale.device}")
    lib = _build.load()
    # the splits depend on the shape, the types and the weights' alignment
    key = (w.data_ptr() % 4, fmt, m, k, n, ldw, nw, group, _DTYPES[x.dtype])
    nsplit = _splits.get(key)
    if nsplit is None:
        nsplit = _splits[key] = lib.tts_quant_matmul_splits(w.data_ptr(),
                                                            *key[1:])
    if nsplit < 1:
        raise ValueError(f"{name}: the kernel does not take M {m}, K {k}, "
                         f"N {n}, group {group}")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    # the K splits' partial tiles, summed by the second pass
    partial = (torch.empty((nsplit, m, n), dtype=torch.float32,
                           device=x.device) if nsplit > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.tts_quant_matmul(
        x2.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), fmt, m, k, n, ldw,
        nw, group, _DTYPES[x.dtype], _DTYPES[out_dtype], stream)
    _build.check(err, name)
    counter.add()
    return out.reshape(*x.shape[:-1], n)


def int4_mm(x: torch.Tensor, w_p: torch.Tensor,
            scales: torch.Tensor) -> torch.Tensor:
    """K4: x (..., K) @ int4-packed weights (K//2, Np) → (..., N) in x.dtype;
    kernel on CUDA, plain version on the CPU. The group is K //
    scales.shape[0]; columns of w_p past N = scales.shape[1] are padding and
    are never written to the output."""
    k = x.shape[-1]
    _check_x("int4_mm", x, x.dtype)
    if w_p.dim() != 2 or w_p.dtype != torch.int8 or k % 2 \
            or w_p.shape[0] * 2 != k:
        raise ValueError(f"int4_mm: x (..., {k}) vs packed weights "
                         f"{tuple(w_p.shape)} {w_p.dtype}; expected "
                         f"({k // 2}, Np) int8")
    if scales.dim() != 2 or scales.dtype != torch.float32 \
            or scales.shape[0] < 1 or k % scales.shape[0]:
        raise ValueError(f"int4_mm: scales {tuple(scales.shape)} "
                         f"{scales.dtype}; expected (K/G, N) f32")
    n = scales.shape[1]
    group = k // scales.shape[0]
    if (k // 2) % group or not 1 <= n <= w_p.shape[1]:
        raise ValueError(f"int4_mm: group {group} must divide K/2 = {k // 2} "
                         f"and N {n} must fit the packed width "
                         f"{w_p.shape[1]}")
    if not (w_p.is_contiguous() and scales.is_contiguous()):
        raise ValueError("int4_mm: w_p and scales must be contiguous")
    if x.device.type == "cpu":
        return int4_mm_reference(x, w_p, scales)
    return _launch("int4_mm", launches, _FMT_I4, x, w_p, scales, n,
                   w_p.shape[1], w_p.shape[1], group, x.dtype)


def w8_mm(x: torch.Tensor, w_i8: torch.Tensor, scale: torch.Tensor, *,
          rows: bool = False,
          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K2: (x (..., K) @ int8 weights) * scale → (..., N) in `out_dtype`
    (default x.dtype); kernel on CUDA, plain version on the CPU. w_i8 is
    (K, N), or (N, K) with rows=True; either may be a view with a larger row
    stride (a column or row slice), which is read in place."""
    k = x.shape[-1]
    out_dtype = out_dtype or x.dtype
    _check_x("w8_mm", x, out_dtype)
    if w_i8.dim() != 2 or w_i8.dtype != torch.int8 or w_i8.stride(1) != 1 \
            or w_i8.shape[1 if rows else 0] != k:
        raise ValueError(f"w8_mm: x (..., {k}) vs int8 weights "
                         f"{tuple(w_i8.shape)} {w_i8.dtype} strides "
                         f"{w_i8.stride()} (rows={rows})")
    n = w_i8.shape[0 if rows else 1]
    if scale.shape != (n,) or scale.dtype != torch.float32 \
            or not scale.is_contiguous() or n < 1:
        raise ValueError(f"w8_mm: scale {tuple(scale.shape)} {scale.dtype}; "
                         f"expected ({n},) f32")
    if rows and (k % 4 or w_i8.stride(0) % 4):
        raise ValueError(f"w8_mm: rows=True needs K {k} and the row stride "
                         f"{w_i8.stride(0)} to be multiples of 4")
    if x.device.type == "cpu":
        return w8_mm_reference(x, w_i8, scale, rows=rows,
                               out_dtype=out_dtype)
    if rows and w_i8.data_ptr() % 4:
        raise ValueError("w8_mm: rows=True needs 4-byte aligned weights")
    return _launch("w8_mm", launches_w8, _FMT_I8_ROWS if rows else _FMT_I8,
                   x, w_i8, scale, n, n, w_i8.stride(0), 0, out_dtype)
