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

The window is cut into chunks, one thread block each. bf16 with D 64 or 128
runs the tensor-core body, whose chunk length ``chunk_keys`` picks from the
shape; everything else runs the CUDA-core body in chunks of ``SIMPLE_CHUNK``
keys (``plan`` says which, for this kernel and the paged ones, and sizes the
scratch for the chunks' partial results).
"""

from __future__ import annotations

import math

import torch

from tts_inference_tpu_torch.ops import _build

launches = _build.LaunchCounter()

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

MMA_CHUNKS = (128, 64)   # keys per block of the tensor-core body, longest first
SIMPLE_CHUNK = 256       # keys per block of the CUDA-core body
H100_SMS = 132

_workspaces = {}         # device → _Workspace


def chunk_keys(b: int, units: int, w: int, sms: int = H100_SMS) -> int:
    """Keys per block of the tensor-core body: the longest chunk that still
    gives every SM two blocks (one block per slot, chunk and unit of kv
    heads: a kv head, or K5's head pair), else the shortest."""
    for chunk in MMA_CHUNKS:
        if b * units * -(-w // chunk) >= 2 * sms:
            return chunk
    return MMA_CHUNKS[-1]


def plan(b, hkv, g, d, w, dtype, sms: int = H100_SMS,
         heads_per_block: int = 1):
    """(keys per chunk, chunks, f32 elements of scratch) of one call: each
    chunk of each (slot, kv head) leaves G·D sums, G maxima and G
    denominators when there is more than one chunk to combine. A bf16 query
    at D 64 / 128 takes the tensor-core body, over bf16, int8 or int4 rows
    alike; `heads_per_block` kv heads share one of its blocks (2 for K5's
    head pairs, which share their packed rows)."""
    if dtype == torch.bfloat16 and d in (64, 128):
        chunk = chunk_keys(b, hkv // heads_per_block, w, sms)
    else:
        chunk = SIMPLE_CHUNK
    nchunk = -(-w // chunk)
    return chunk, nchunk, (b * hkv * nchunk * g * (d + 2) if nchunk > 1 else 0)


class _Workspace:
    """What the attention kernels need of one device beside their
    arguments: the SM count, a counter per (slot, kv head) that is zero
    between launches (the kernel's last block sets its counter back), and
    the scratch for the chunks' partial results, both grown as needed. The
    dense and the paged wrappers, and K4 / K2, share it: calls on one device
    follow each other on its stream, as the engine's do, and so do the
    replays of the CUDA graphs that captured them.

    A captured graph keeps the addresses it was captured with, so the
    buffers must outlive every graph: growth inside a capture raises (the
    eager pass before a capture sizes them), and a growth after a capture
    has read the buffers keeps the old ones alive beside the new ones. The
    engines of one process (the scheduler's and the single-stream one) and
    configurations of other sizes share the workspace, so no one size can
    be fixed before the first capture."""

    def __init__(self, device):
        self.device = device
        self.sms = torch.cuda.get_device_properties(
            device).multi_processor_count
        self.counters = torch.zeros(1024, dtype=torch.int32, device=device)
        self.scratch = torch.empty(1 << 20, dtype=torch.float32,
                                   device=device)
        self.captured = False   # a capture has read the current buffers
        self.retired = []       # buffers that captures read, kept alive

    def reserve(self, heads: int, floats: int):
        capturing = torch.cuda.is_current_stream_capturing()
        if self.counters.numel() < heads or self.scratch.numel() < floats:
            if capturing:
                raise RuntimeError(
                    f"attention/matmul workspace must grow to {heads} "
                    f"counters and {floats} floats inside a CUDA graph "
                    "capture: run the launch eagerly before capturing it")
            if self.captured:
                self.retired.append((self.counters, self.scratch))
                self.captured = False
            if self.counters.numel() < heads:
                self.counters = torch.zeros(2 * heads, dtype=torch.int32,
                                            device=self.device)
            if self.scratch.numel() < floats:
                self.scratch = torch.empty(2 * floats, dtype=torch.float32,
                                           device=self.device)
        self.captured |= capturing
        return self.counters, self.scratch


def workspace(device) -> _Workspace:
    ws = _workspaces.get(device)
    if ws is None:
        ws = _workspaces[device] = _Workspace(device)
    return ws


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
    if q.data_ptr() % 16:
        raise ValueError("decode_attention: q not 16-byte aligned")
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
    ws = workspace(q.device)
    chunk, _, floats = plan(b, hkv, g, d, w, q.dtype, ws.sms)
    counters, scratch = ws.reserve(b * hkv, floats)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.tts_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), counters.data_ptr(),
        b, hkv, g, d, w, chunk, k.stride(0), v.stride(0), 1.0 / math.sqrt(d),
        _DTYPES[q.dtype], stream)
    _build.check(err, "decode_attention")
    launches.add()
    return out
