"""K3a / K3b: paged GQA decode attention over a block pool (K5, the int4
pools, is ``ops/paged_attention_int4.py`` over the same launcher).

Port of ``tts_inference_tpu/ops/pallas/paged_attention.py``. The kernels are
hand-written CUDA C++ for Hopper (``csrc/paged_attention.cu``, sharing its
body with K1 through ``csrc/attention.cuh``); beside them,
``paged_decode_attention_reference`` and
``paged_decode_attention_int8_reference`` are the plain PyTorch versions:
gather the window's blocks (dequantized in f32 for int8), then dense masked
attention. The wrappers take the plain versions only for tensors on the CPU;
a CUDA tensor launches the kernel or raises.

Shapes (N = pool blocks, bs = block size, Hkv = kv heads, G = query heads
per kv head, D = head dim, WB = window blocks), the JAX package's
head-batched pool layout:
    q:     (B, Hkv, G, D)
    k, v:  (N, Hkv, bs, D) — the pools, contiguous
    ks, vs: (N, Hkv, bs) f32 — the int8 pools' per-(block, head, position)
           scales
    table: (B, WB) int32 — pool row of each slot's logical block; a column
           slice ``table[:, :WB]`` of the wider engine table is read in place
    pos:   (B,) int32 — position j attends iff j <= pos[b]
    out:   (B, Hkv, G, D) in q's dtype
Unlike the TPU kernel, G is not padded to the 8-row sublane tile and there
is no super-block width to tune.
"""

from __future__ import annotations

import math

import torch

from tts_inference_tpu_torch.ops import _build
from tts_inference_tpu_torch.ops.decode_attention import \
    decode_attention_reference

launches = _build.LaunchCounter()        # K3a
launches_int8 = _build.LaunchCounter()   # K3b

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def gather_window(pool, table):
    """Gather the table's blocks into a dense window: (N, Hkv, bs, …) pool,
    (B, WB) table → (B, WB·bs, Hkv, …)."""
    b, wb = table.shape
    blocks = pool[table.long()].movedim(3, 2)    # (B, WB, bs, Hkv, …)
    return blocks.reshape(b, wb * pool.shape[2], *blocks.shape[3:])


def paged_decode_attention_reference(q, k_pool, v_pool, table, pos):
    """Plain PyTorch version: gather the window, then dense masked
    attention (f32 scores, -1e30 mask, softmax, f32 p·v)."""
    return decode_attention_reference(q, gather_window(k_pool, table),
                                      gather_window(v_pool, table), pos)


def paged_decode_attention_int8_reference(q, k_pool, v_pool, ks_pool,
                                          vs_pool, table, pos):
    """Plain PyTorch version over int8 pools: gather the window, dequantize
    it in f32 with its scales, then dense masked attention."""
    k = gather_window(k_pool, table).float() \
        * gather_window(ks_pool, table)[..., None]
    v = gather_window(v_pool, table).float() \
        * gather_window(vs_pool, table)[..., None]
    return decode_attention_reference(q, k, v, pos)


def check_paged(name, q, k_pool, v_pool, table, pos, scales=(),
                heads_per_row=1):
    """Raise on what the paged kernels do not take; returns (B, Hkv, G, D,
    bs, WB). heads_per_row = kv heads packed into one pool row: 1 for K3a /
    K3b, 2 for K5, whose pools are (N, Hkv/2, bs, D) and whose scale pools
    are (N, 2, Hkv/2, bs) nibble planes."""
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (B, Hkv, G, D), got "
                         f"{tuple(q.shape)}")
    b, hkv, g, d = q.shape
    if hkv % heads_per_row:
        raise ValueError(f"{name}: {hkv} kv heads (head-pair packing needs "
                         "an even count)")
    rows = hkv // heads_per_row
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape \
            or k_pool.shape[1] != rows or k_pool.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    n, bs = k_pool.shape[0], k_pool.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: q is {q.dtype}; the kernel takes bf16 or "
                        "f32")
    pool_dt = torch.int8 if scales else q.dtype
    if k_pool.dtype != pool_dt or v_pool.dtype != pool_dt:
        raise TypeError(f"{name}: pools {k_pool.dtype}/{v_pool.dtype}, "
                        f"expected {pool_dt}")
    sshape = (n, rows, bs) if heads_per_row == 1 \
        else (n, heads_per_row, rows, bs)
    for t in scales:
        if t.shape != sshape or t.dtype != torch.float32:
            raise ValueError(f"{name}: scale pools must be {sshape} f32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if d % 8 or d > 256:
        raise ValueError(f"{name}: head dim {d} must be a multiple of 8 up "
                         "to 256")
    if not 1 <= g <= 8:
        raise ValueError(f"{name}: {g} query heads per kv head (the kernel "
                         "takes 1..8)")
    if bs % 16 or bs > 256:
        raise ValueError(f"{name}: block size {bs} must be a multiple of 16 "
                         "up to 256")
    if table.dim() != 2 or table.shape[0] != b or table.shape[1] < 1 \
            or table.dtype != torch.int32 or table.stride(1) != 1:
        raise ValueError(f"{name}: table must be (B, WB) int32 with "
                         "contiguous rows")
    if pos.shape != (b,) or pos.dtype != torch.int32:
        raise ValueError(f"{name}: pos must be (B,) int32")
    for nm, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                  ("pos", pos), *(("scale pool", s) for s in scales)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {nm} not 16-byte aligned")
    devs = {t.device for t in (q, k_pool, v_pool, table, pos, *scales)}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on {devs}")
    return b, hkv, g, d, bs, table.shape[1]


def launch_paged(fn, counter, q, k_pool, v_pool, scales, table, pos,
                 heads_per_row=1):
    """Check the arguments and launch the paged kernel `fn` of the library
    (``tts_paged_attention[_int8|_int4]``) on q's stream."""
    b, hkv, g, d, bs, wb = check_paged(fn, q, k_pool, v_pool, table, pos,
                                       scales, heads_per_row)
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for {q.device}")
    lib = _build.load()
    out = torch.empty_like(q)
    # per-chunk partials (acc, max, denominator) for the combine pass
    nsplit = lib.tts_paged_attention_splits(wb, bs)
    scratch = (torch.empty(b * hkv * nsplit * g * (d + 2),
                           dtype=torch.float32, device=q.device)
               if nsplit > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, fn)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        *(s.data_ptr() for s in scales), table.data_ptr(), table.stride(0),
        pos.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        b, hkv, g, d, bs, wb, 1.0 / math.sqrt(d), _DTYPES[q.dtype], stream)
    _build.check(err, fn)
    counter.add()
    return out


def paged_decode_attention(q, k_pool, v_pool, table, pos):
    """K3a: (B, Hkv, G, D) attention over bf16/f32 pools; kernel on CUDA,
    plain version on the CPU."""
    if q.device.type == "cpu":
        check_paged("paged_decode_attention", q, k_pool, v_pool, table, pos)
        return paged_decode_attention_reference(q, k_pool, v_pool, table, pos)
    return launch_paged("tts_paged_attention", launches, q, k_pool, v_pool,
                        (), table, pos)


def paged_decode_attention_int8(q, k_pool, v_pool, ks_pool, vs_pool, table,
                                pos):
    """K3b: (B, Hkv, G, D) attention over int8 pools with f32 scale pools;
    kernel on CUDA, plain version on the CPU."""
    scales = (ks_pool, vs_pool)
    if q.device.type == "cpu":
        check_paged("paged_decode_attention_int8", q, k_pool, v_pool, table,
                    pos, scales)
        return paged_decode_attention_int8_reference(
            q, k_pool, v_pool, ks_pool, vs_pool, table, pos)
    return launch_paged("tts_paged_attention_int8", launches_int8, q, k_pool,
                        v_pool, scales, table, pos)
