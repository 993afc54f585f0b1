"""K1: fused GQA decode attention over a dense KV window.

Port of ``tts_inference_tpu/ops/pallas/decode_attention.py``. The kernel is
hand-written CUDA C++ for Hopper (``csrc/decode_attention.cu``); beside it,
``decode_attention_reference`` is the plain PyTorch version of the same
function. The wrapper takes the plain version only for tensors on the CPU;
a CUDA tensor launches the kernel or raises.

Shapes (Hkv = kv heads, G = query heads per kv head, W = kv window,
D = head dim):
    q:   (B, Hkv, G, D)
    k,v: (B, W, Hkv, D) — (W, Hkv, D) contiguous; the batch stride is free, so
         a window slice ``cache[:, :W]`` of the (B, max_seq, Hkv, D) cache is
         read in place
    pos: (B,) int32 — kv index j attends iff j <= pos[b] (pos >= 0)
    out: (B, Hkv, G, D) in q's dtype
Unlike the TPU kernel, every W is covered (no VMEM bound), and G is not
padded.
"""

from __future__ import annotations

import math

import torch

from tts_inference_tpu_torch.ops import _build

launches = _build.LaunchCounter()

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def decode_attention_reference(q, k, v, pos):
    """Plain PyTorch version: f32 scores, -1e30 mask, softmax, f32 p·v."""
    w = k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k.float()) * scale
    col = torch.arange(w, device=q.device)[None, None, None, :]
    s = torch.where(col <= pos.to(torch.int64)[:, None, None, None], s,
                    torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return o.to(q.dtype)


def _check(q, k, v, pos):
    b, hkv, g, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[2] != hkv or k.shape[3] != d:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes bf16 or f32")
    if d % 8 or d > 256:
        raise ValueError(f"decode_attention: head dim {d} must be a multiple "
                         "of 8 up to 256")
    if not 1 <= g <= 8:
        raise ValueError(f"decode_attention: {g} query heads per kv head "
                         "(the kernel takes 1..8)")
    if pos.shape != (b,) or pos.dtype != torch.int32:
        raise ValueError("decode_attention: pos must be (B,) int32")
    w = k.shape[1]
    for name, t in (("k", k), ("v", v)):
        if t.stride()[1:] != (hkv * d, d, 1):
            raise ValueError(f"decode_attention: {name} rows (W, Hkv, D) "
                             "must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} not 16-byte aligned")
    for name, t in (("q", q), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    devs = {t.device for t in (q, k, v, pos)}
    if len(devs) != 1:
        raise ValueError(f"decode_attention: tensors on {devs}")
    return b, hkv, g, d, w


def decode_attention(q, k, v, pos):
    """(B, Hkv, G, D) attention output; kernel on CUDA, plain on the CPU."""
    b, hkv, g, d, w = _check(q, k, v, pos)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, pos)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    lib = _build.load()
    out = torch.empty_like(q)
    # per-chunk partials (acc, max, denominator) for the combine pass
    nsplit = lib.tts_decode_attention_splits(w)
    scratch = (torch.empty(b * hkv * nsplit * g * (d + 2),
                           dtype=torch.float32, device=q.device)
               if nsplit > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.tts_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        b, hkv, g, d, w, k.stride(0), v.stride(0), 1.0 / math.sqrt(d),
        _DTYPES[q.dtype], stream)
    _build.check(err, "decode_attention")
    launches.add()
    return out
