"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failed check raises, so the exit code is nonzero and
no result line is printed:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build of the hand-written kernels from ``tts_inference_tpu_torch/csrc``;
3. kernel phase: each of the seven kernels (K1, K6, K3a, K3b, K5 over pools
   filled by the port's own pool writes; K4 and K2 over weights quantized
   by the port) against its plain PyTorch version on the card, at the serve
   paths' shapes: max |Δ| and its tolerance, device µs per call of both (a
   CUDA graph of the calls, replayed), the least time the card could take
   (bytes or operations), and the time of the one PyTorch call that
   computes the same function where there is one;
4. serve phase: the full Orpheus-3B + SNAC 24 kHz geometry with seeded
   random weights behind the port's aiohttp server (``cli serve``
   defaults: 8 slots, max_seq 4608, dense bf16 KV); 8 concurrent
   ``/ws/tts`` requests and one ``/generate``; launch counts prove K1 and
   K6 carried the path;
5. streaming exactness: windowed lookahead decode vs one batch decode;
6. reference: the slice at ``tiny_config()`` on the card against the same
   weights on the CPU (plain versions), and finite full-geometry logits;
7. paged int8 serve phase: ``serve --paged-kv --kv-int8 --kv-on-demand``
   with a pool too small for the 8 streams (16 blocks of 128), so streams
   are preempted and resumed; K3b carries every decode step, K1 and K3a
   none;
8. paged bf16 serve phase: ``serve --paged-kv`` (worst-case reservation),
   8 streams and one ``/generate``; K3a carries every decode step;
9. paged reference: the tiny slice paged (K3a), dense int8 and paged int8
   (K3b) on the card against the CPU, and a preempt → resume on the card
   against the same requests served without preemption;
10. int4 serve phase: ``serve --quantize --weight-bits 4 --paged-kv
    --kv-int4``; K4 carries every layer linear of every forward pass, K5
    every decode step, K2 the head; K1, K3a, K3b none;
11. int8 weights serve phase: ``serve --quantize``; K2 carries every linear
    and the head, K1 every decode step;
12. quantized reference: the tiny slice with int4 weights + int4 KV and with
    int8 weights on the card against the same quantized leaves on the CPU;
13. the card line, the kernels' JSON line, and last
    ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package. Exits nonzero
without a card. ``--only PHASES`` runs some phases during development and
prints no result line.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import subprocess
import sys
import time

import torch

K1_TOL = 2e-2    # bf16 inputs; compared in f32
K3_TOL = 2e-2    # K3a/K3b/K5: bf16 queries and outputs; compared in f32
K6_TOL = 1e-4    # f32 with TF32 off on both sides
# K4/K2: the kernel and the plain version both accumulate in f32, in another
# order, and round once: a bf16 output may differ by one bf16 step of the
# largest output (2^-7 relative), an f32 output by summation order only
QMM_TOL_BF16 = 2.0 ** -7
QMM_TOL_F32 = 1e-4

# Published peaks of one H100 SXM (NVIDIA's data sheet), for the bounds:
# device memory, dense bf16 tensor cores, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def bound(nbytes: float, flops: float, kind: str) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the operations at
    the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_ms(fn, iters: int = 10, warmup: int = 3, rotate=None,
            replays: int = 3) -> float:
    """Mean DEVICE time per call: `iters` calls are captured into a CUDA
    graph, and CUDA events time `replays` replays of it, so the host's time
    to enqueue a call (tens of µs of Python per wrapper call, more than most
    of these kernels run) is not in the number. With `rotate` (a list of
    argument tuples whose tensors together exceed the 50 MB L2), call i gets
    rotate[i % len]: the weights then come from device memory, as on the
    serve path, where 28 layers' weights pass between two uses of one."""
    calls = [fn] if rotate is None else [
        (lambda a=a: fn(*a)) for a in rotate]
    iters = max(iters, len(calls))
    for i in range(max(warmup, len(calls))):
        calls[i % len(calls)]()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    return ms


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def build_phase() -> float:
    from tts_inference_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    dt = time.perf_counter() - t0
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("ptxas:", line.strip())
    print(f"build: {dt:.1f} s (nvcc {_build.build_seconds:.1f} s) -> "
          f"{_build.library_path()}", flush=True)
    return dt


def _report(name: str, shape: str, err: float, tol: float, ms: float,
            plain_ms: float, bnd: dict, library_ms=None, extra: str = ""):
    """Print one kernel case and fail it when the kernel disagrees with its
    plain version."""
    lib = "none" if library_ms is None else f"{library_ms * 1e3:.1f} us"
    print(f"{name} {shape}: max|d|={err:.3e} (tol {tol:.1e}) kernel "
          f"{ms * 1e3:.1f} us plain {plain_ms * 1e3:.1f} us bound "
          f"{bnd['bound_ms'] * 1e3:.2f} us by {bnd['bound_by']} library "
          f"{lib}{extra}", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name} {shape}: max|d| {err} > {tol}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
            "library_ms": library_ms}


def _attention_bound(pos, hkv: int, g: int, d: int, kv_bytes_per_key: float,
                     q_bytes: int) -> dict:
    """Decode attention reads the keys and values j <= pos[b] of every kv
    head once (kv_bytes_per_key bytes for one head's K and V rows together,
    scales included), reads q and writes the output; 4·G·D operations per
    key and head (q·k and p·v)."""
    keys = int((pos.long() + 1).sum())
    b = pos.numel()
    nbytes = keys * hkv * kv_bytes_per_key + 2 * b * hkv * g * d * q_bytes
    return bound(nbytes, 4.0 * g * d * keys * hkv, "bf16")


def _k1_case(w: int, gen: torch.Generator):
    import torch.nn.functional as F

    from tts_inference_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)

    b, hkv, g, d, max_seq = 8, 8, 3, 128, 4608
    dev = "cuda"
    q = torch.randn(b, hkv, g, d, generator=gen, device=dev).bfloat16()
    # the main path reads a window slice of the (B, max_seq, Hkv, D) cache
    kc = torch.randn(b, max_seq, hkv, d, generator=gen, device=dev).bfloat16()
    vc = torch.randn(b, max_seq, hkv, d, generator=gen, device=dev).bfloat16()
    k, v = kc[:, :w], vc[:, :w]
    pos = torch.randint(0, w, (b,), generator=gen, device=dev)
    pos[0], pos[1] = 0, w - 1
    pos = pos.to(torch.int32)
    got = decode_attention(q, k, v, pos)
    want = decode_attention_reference(q, k, v, pos)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ms = time_ms(lambda: decode_attention(q, k, v, pos))
    plain = time_ms(lambda: decode_attention_reference(q, k, v, pos))
    # the library call: one scaled_dot_product_attention over the same
    # window with the position mask (timed here, used nowhere in the port)
    qs = q.reshape(b, hkv * g, 1, d)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(w, device=dev)[None, :]
            <= pos[:, None])[:, None, None, :]
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True))
    return _report("K1 decode_attention", f"B8 Hkv8 G3 D128 bf16 W{w}", err,
                   K1_TOL, ms, plain,
                   _attention_bound(pos, hkv, g, d, 2 * d * 2, 2), lib)


def _paged_case_inputs(b: int, w: int, gen: torch.Generator):
    """Random paged-attention inputs at the serve path's Hkv 8, G 3, D 128
    and block 128: each slot holds a random number of blocks at random pool
    rows (slot 0 the whole window, slot 1 one block), its table row is 0
    past its last block, and the kernels read a column slice of a wider
    table, as the engine hands it."""
    hkv, g, d, bs = 8, 3, 128, 128
    dev = "cuda"
    wb = w // bs
    nb = torch.randint(1, wb + 1, (b,), generator=gen, device=dev)
    nb[0], nb[1] = wb, 1
    n = 1 + int(nb.sum())
    perm = torch.randperm(n - 1, generator=gen, device=dev).to(torch.int32) + 1
    table = torch.zeros(b, wb + 3, dtype=torch.int32, device=dev)
    j = torch.arange(wb, device=dev)[None, :]
    table[:, :wb][j < nb[:, None]] = perm
    pos = (torch.rand(b, generator=gen, device=dev) * nb * bs).to(torch.int32)
    pos[0], pos[1] = w - 1, 0
    p = torch.arange(w, device=dev)[None, :]
    rows = torch.where(p < nb[:, None] * bs,
                       table.gather(1, (p // bs).expand(b, w)), 0)
    offs = (p % bs).expand(b, w)
    q = torch.randn(b, hkv, g, d, generator=gen, device=dev).bfloat16()
    kv = [torch.randn(b, w, hkv, d, generator=gen, device=dev).bfloat16()
          for _ in range(2)]
    return n, table[:, :wb], pos, rows, offs, q, kv


def _k3_case(kind: str, b: int, w: int, gen: torch.Generator):
    """K3a (bf16 pools), K3b (int8 pools) or K5 (int4 pools packed by head
    pair) at (B, W). Pools are written by the port's own pool_scatter and
    quantizers from random bf16 K/V. No PyTorch call computes attention
    over a block pool, so there is no library time."""
    from tts_inference_tpu_torch.models.llama import _quantize_kv, pool_scatter
    from tts_inference_tpu_torch.ops import paged_attention as pa
    from tts_inference_tpu_torch.ops import paged_attention_int4 as pa4

    hkv, g, d, bs = 8, 3, 128, 128
    dev = "cuda"
    n, table, pos, rows, offs, q, kv = _paged_case_inputs(b, w, gen)
    if kind == "K5":
        pools = [torch.zeros(n, hkv // 2, bs, d, dtype=torch.int8, device=dev)
                 for _ in range(2)]
        scales = [torch.zeros(n, 2, hkv // 2, bs, device=dev)
                  for _ in range(2)]
        for pool, sc, x in zip(pools, scales, kv):
            xq, xs = pa4.quantize_kv_int4(x)
            pool_scatter(pool, rows, offs, xq)
            pool_scatter(sc, rows, offs, pa4.scales_to_planes(xs), n_mid=2)
        args = (q, *pools, *scales, table, pos)
        kern = pa4.paged_decode_attention_int4
        plain = pa4.paged_decode_attention_int4_reference
        name, what, key_bytes = ("K5 paged_decode_attention_int4", "int4",
                                 2 * (d / 2 + 4))
    elif kind == "K3b":
        pools = [torch.zeros(n, hkv, bs, d, dtype=torch.int8, device=dev)
                 for _ in range(2)]
        scales = [torch.zeros(n, hkv, bs, device=dev) for _ in range(2)]
        for pool, sc, x in zip(pools, scales, kv):
            xq, xs = _quantize_kv(x)
            pool_scatter(pool, rows, offs, xq)
            pool_scatter(sc, rows, offs, xs)
        args = (q, *pools, *scales, table, pos)
        kern = pa.paged_decode_attention_int8
        plain = pa.paged_decode_attention_int8_reference
        name, what, key_bytes = ("K3b paged_decode_attention_int8", "int8",
                                 2 * (d + 4))
    else:
        pools = [torch.zeros(n, hkv, bs, d, dtype=torch.bfloat16, device=dev)
                 for _ in range(2)]
        for pool, x in zip(pools, kv):
            pool_scatter(pool, rows, offs, x)
        args = (q, *pools, table, pos)
        kern = pa.paged_decode_attention
        plain = pa.paged_decode_attention_reference
        name, what, key_bytes = "K3a paged_decode_attention", "bf16", 2 * d * 2
    got = kern(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ms = time_ms(lambda: kern(*args))
    plain_ms = time_ms(lambda: plain(*args))
    return _report(name, f"B{b} Hkv8 G3 D128 bs128 {what} W{w}", err, K3_TOL,
                   ms, plain_ms,
                   _attention_bound(pos, hkv, g, d, key_bytes, 2))


def _k6_unit(c: int, gen: torch.Generator):
    dev = "cuda"

    def u(shape, scale):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * scale

    return {
        "alpha1": 0.5 + torch.rand(c, generator=gen, device=dev),
        "conv1": {"w": u((c, 1, 7), 7 ** -0.5), "b": u((c,), 0.1)},
        "alpha2": 0.5 + torch.rand(c, generator=gen, device=dev),
        "conv2": {"w": u((c, c, 1), c ** -0.5), "b": u((c,), 0.1)},
    }


def _k6_case(c: int, t: int, dil: int, gen: torch.Generator):
    """One residual unit. Its plain version IS the library sequence (two
    snakes in elementwise calls, a depthwise and a pointwise cuDNN
    convolution, an add): no single PyTorch call computes the unit, so the
    sequence's time stands as the library time."""
    from tts_inference_tpu_torch.ops.vocoder import (
        fused_residual_unit, fused_residual_unit_reference)

    b = 8
    p = _k6_unit(c, gen)
    # channel-first storage viewed as (B, T, C), as the decoder keeps it
    x = torch.randn(b, c, t, generator=gen, device="cuda").transpose(1, 2)
    valid = torch.full((b,), t, dtype=torch.int32, device="cuda")
    valid[3] = t - 37
    x = torch.where(torch.arange(t, device="cuda")[None, :, None]
                    < valid[:, None, None], x, 0.0)
    got = fused_residual_unit(x, p, dil, valid)
    want = fused_residual_unit_reference(x, p, dil, valid)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ms = time_ms(lambda: fused_residual_unit(x, p, dil, valid))
    plain = time_ms(lambda: fused_residual_unit_reference(x, p, dil, valid))
    # x read and the output written once, the weights once; the pointwise
    # product (2·C per output element), the 7-tap depthwise convolution and
    # two snakes (~8 operations each), in f32
    elems = b * t * c
    bnd = bound(4.0 * (2 * elems + c * c + 10 * c),
                elems * (2.0 * c + 14 + 16), "f32")
    return _report("K6 fused_residual_unit", f"B8 C{c} T{t} dil{dil} f32",
                   err, K6_TOL, ms, plain, bnd, plain)


def _qmm_weight(k: int, n: int, dtype, gen: torch.Generator):
    w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
    return w.to(dtype)


def _qmm_finish(name, shape, x, kern, plain, rotate, out_f32, wbytes, k, n,
                ctx_weight=None):
    """Compare one quantized matmul with its plain version and time both
    over weights that rotate through more than the L2 holds. No PyTorch call
    multiplies by these packed formats, so there is no library time; the
    bf16 ``torch.matmul`` of the same (M, K, N) is printed as context."""
    m = x.numel() // k
    got = kern(*rotate[0])
    want = plain(*rotate[0])
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    tol = (QMM_TOL_F32 * max(1.0, top) if out_f32 or x.dtype == torch.float32
           else QMM_TOL_BF16 * top)
    ms = time_ms(kern, rotate=rotate)
    plain_ms = time_ms(plain, rotate=rotate)
    xb = 4 if x.dtype == torch.float32 else 2
    ob = 4 if out_f32 else xb
    bnd = bound(wbytes + m * k * xb + m * n * ob, 2.0 * m * k * n,
                "f32" if x.dtype == torch.float32 else "bf16")
    extra = ""
    res_extra = {}
    if ctx_weight is not None:
        ws = [ctx_weight() for _ in range(_copies(2 * k * n))]
        xbf = x.bfloat16()
        ctx = time_ms(lambda w: xbf @ w, rotate=[(w,) for w in ws])
        extra = f"; bf16 torch.matmul of the same shape {ctx * 1e3:.1f} us"
        res_extra = {"bf16_matmul_ms": ctx}
    res = _report(name, shape, err, tol, ms, plain_ms, bnd, None, extra)
    return {**res, **res_extra}


def _copies(nbytes: int) -> int:
    """How many weight copies a timing rotates through: more than 60 MB,
    at most 40 (small weights)."""
    return min(40, max(2, -(-60_000_000 // nbytes)))


def _k4_case(m: int, k: int, n: int, group: int, dtype,
             gen: torch.Generator, context: bool = False):
    from tts_inference_tpu_torch.models.quant import quantize_linear_i4
    from tts_inference_tpu_torch.ops.int4_matmul import (int4_mm,
                                                         int4_mm_reference)

    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    qs = [quantize_linear_i4(_qmm_weight(k, n, dtype, gen), group)
          for _ in range(_copies(k * n // 2))]
    g = k // qs[0].scale.shape[0]
    wbytes = qs[0].w_p.shape[0] * n + qs[0].scale.numel() * 4
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    return _qmm_finish(
        "K4 int4_mm", f"M{m} K{k} N{n} G{g} {dt}", x, int4_mm,
        int4_mm_reference, [(x, q.w_p, q.scale) for q in qs], False, wbytes,
        k, n, (lambda: _qmm_weight(k, n, torch.bfloat16, gen))
        if context else None)


def _k2_case(m: int, k: int, n: int, gen: torch.Generator,
             context: bool = False):
    from tts_inference_tpu_torch.models.quant import quantize_linear
    from tts_inference_tpu_torch.ops.int4_matmul import w8_mm, w8_mm_reference

    x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    qs = [quantize_linear(_qmm_weight(k, n, torch.bfloat16, gen))
          for _ in range(_copies(k * n))]
    return _qmm_finish(
        "K2 w8_mm", f"M{m} K{k} N{n} (in, out) bf16", x, w8_mm,
        w8_mm_reference, [(x, q.w_i8, q.scale) for q in qs], False,
        k * n + 4 * n, k, n,
        (lambda: _qmm_weight(k, n, torch.bfloat16, gen)) if context else None)


def _k2_head_case(gen: torch.Generator):
    """The tied head: the last 28,940 rows of a (156,940, 3072) int8
    embedding, read in place as a row slice, f32 logits."""
    from tts_inference_tpu_torch import protocol
    from tts_inference_tpu_torch.models.quant import QuantEmbed
    from tts_inference_tpu_torch.ops.int4_matmul import w8_mm, w8_mm_reference

    v, h, base, m = 156940, 3072, protocol.HEAD_SLICE_BASE, 8
    emb = QuantEmbed(
        torch.randint(-127, 128, (v, h), generator=gen, device="cuda",
                      dtype=torch.int8),
        torch.rand(v, generator=gen, device="cuda") * 1e-3 + 1e-4)
    x = torch.randn(m, h, generator=gen, device="cuda").bfloat16()
    n = v - base

    def kern(x, w, s):
        return w8_mm(x, w, s, rows=True, out_dtype=torch.float32)

    def plain(x, w, s):
        return w8_mm_reference(x, w, s, rows=True, out_dtype=torch.float32)

    return _qmm_finish("K2 w8_mm", f"M{m} K{h} N{n} rows [{base}:] of "
                       f"({v}, {h}), f32 out", x, kern, plain,
                       [(x, emb.w_i8[base:], emb.scale[base:])], True,
                       n * h + 4 * n, h, n)


def kernel_phase() -> dict:
    """Each kernel against its plain version at the serve paths' shapes."""
    # the vocoder's f32 parity needs full-precision cuDNN and matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    k1 = {w: _k1_case(w, gen) for w in (256, 512, 2048, 4608)}
    # SNAC 24 kHz: (C, T per frame) after each upsample stage, 16-frame bucket
    k6 = {}
    for c, t_frame in ((512, 32), (256, 256), (128, 1024), (64, 2048)):
        for dil in (1, 3, 9):
            k6[(c, dil)] = _k6_case(c, 16 * t_frame, dil, gen)
    # the serve windows at 8 slots; the long-audio window (bench.py --mode
    # long: 4 slots, 12,160 positions = 95 blocks); 64 paged quantized slots
    k3a = {(b, w): _k3_case("K3a", b, w, gen)
           for b, w in ((8, 512), (8, 2048), (8, 4608), (4, 12160))}
    k3b = {(b, w): _k3_case("K3b", b, w, gen)
           for b, w in ((8, 512), (8, 2048), (8, 4608), (64, 512))}
    k5 = {(b, w): _k3_case("K5", b, w, gen)
          for b, w in ((8, 512), (8, 2048), (8, 4608), (4, 12160), (64, 512))}
    # the Orpheus-3B linears (q/o, k/v, gate/up, down) at a decode step's
    # M 8; a finer group; odd M; a prefill M; the tiny configuration's f32
    # linears (K 64 / 128, groups 32 / 64, N 64 padded to 128 columns)
    linears = ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072))
    k4 = {(8, k, n): _k4_case(8, k, n, 512, bf16, gen, context=True)
          for k, n in linears}
    k4[(8, 3072, 8192, 128)] = _k4_case(8, 3072, 8192, 128, bf16, gen)
    for m in (1, 3, 512):
        k4[(m, 3072, 3072)] = _k4_case(m, 3072, 3072, 512, bf16, gen,
                                       context=m == 512)
    for k, n in ((64, 64), (64, 32), (64, 128), (128, 64)):
        k4[(4, k, n)] = _k4_case(4, k, n, 512, f32, gen)
    k2 = {(8, k, n): _k2_case(8, k, n, gen, context=True) for k, n in linears}
    k2[(512, 3072, 3072)] = _k2_case(512, 3072, 3072, gen, context=True)
    k2["head"] = _k2_head_case(gen)

    def worst(cases):
        return max(c["max_abs_err"] for c in cases.values())

    def summed(cases):
        out = {"max_abs_err": worst(cases),
               "bound_by": next(iter(cases.values()))["bound_by"]}
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            out[key] = sum(c[key] for c in cases.values())
        return out

    return {
        # the window the serve phases' decode steps mostly read
        "K1": {**k1[512], "max_abs_err": worst(k1)},
        "K3a": {**k3a[(8, 512)], "max_abs_err": worst(k3a)},
        "K3b": {**k3b[(8, 512)], "max_abs_err": worst(k3b)},
        "K5": {**k5[(8, 512)], "max_abs_err": worst(k5)},
        # all 12 units of one 8-row, 16-frame vocoder call
        "K6": summed(k6),
        # the gate / up projection of a decode step, the largest linear
        "K4": {**k4[(8, 3072, 8192)], "max_abs_err": worst(k4)},
        "K2": {**k2[(8, 3072, 8192)], "max_abs_err": worst(k2)},
    }


N_STREAMS = 8
MAX_TOKENS = 280                     # 40 frames of 7 tokens
PCM_BYTES = (MAX_TOKENS // 7) * 2048 * 2
PCM16_TOL = 4                        # LSB, windowed vs batch decode


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(i: int) -> dict:
    # bench.py's request: speech forced, audio tokens only, fixed budget
    return {"text": f"Stream {i}: the quick brown fox jumps over the dog.",
            "force_speech": True, "audio_only": True,
            "max_tokens": MAX_TOKENS, "seed": 1000 + i, "benchmark": True}


async def _drive(port: int, generate: bool) -> dict:
    import io
    import wave

    import aiohttp

    base = f"http://127.0.0.1:{port}"
    async with aiohttp.ClientSession() as sess:

        async def one(i: int) -> dict:
            t0 = time.perf_counter()
            first = None
            nbytes = 0
            done = None
            async with sess.ws_connect(base + "/ws/tts") as ws:
                await ws.send_json(_request(i))
                async for msg in ws:
                    if msg.type == aiohttp.WSMsgType.BINARY:
                        first = first or time.perf_counter()
                        nbytes += len(msg.data)
                    elif msg.type == aiohttp.WSMsgType.TEXT:
                        data = json.loads(msg.data)
                        if "error" in data:
                            raise AssertionError(f"stream {i}: {data}")
                        if data.get("done"):
                            done = data
                            break
                    else:
                        raise AssertionError(f"stream {i}: {msg.type}")
            wall = time.perf_counter() - t0
            if done is None or done["bytes"] != nbytes:
                raise AssertionError(f"stream {i}: done {done}, {nbytes} B")
            return {"ttfa_ms": (first - t0) * 1e3, "bytes": nbytes,
                    "wall_s": wall, "done": done}

        t0 = time.perf_counter()
        streams = await asyncio.gather(*(one(i) for i in range(N_STREAMS)))
        wave_s = time.perf_counter() - t0
        out = {"streams": streams, "wave_s": wave_s}
        if generate:
            t1 = time.perf_counter()
            async with sess.post(base + "/generate",
                                 json=_request(N_STREAMS)) as r:
                if r.status != 200:
                    raise AssertionError(f"/generate: {r.status} "
                                         f"{await r.text()}")
                wav = await r.read()
            out["generate_s"] = time.perf_counter() - t1
            with wave.open(io.BytesIO(wav)) as w:
                out["generate_samples"] = w.getnframes()
        async with sess.get(base + "/metrics") as r:
            out["metrics"] = await r.json()
    return out


def _launch_counters() -> dict:
    from tts_inference_tpu_torch.ops import (decode_attention, int4_matmul,
                                             paged_attention,
                                             paged_attention_int4, vocoder)

    return {"K1": decode_attention.launches, "K3a": paged_attention.launches,
            "K3b": paged_attention.launches_int8,
            "K5": paged_attention_int4.launches, "K6": vocoder.launches,
            "K4": int4_matmul.launches, "K2": int4_matmul.launches_w8}


# launches of a kernel in a serve phase, from (layers, decode steps, forward
# passes = decode steps + prefills): an attention kernel runs once per layer
# and decode step, the 7 linears of a layer once per layer and forward pass,
# the head once per forward pass
PER_STEP = lambda layers, steps, passes: layers * steps          # noqa: E731
LINEARS = lambda layers, steps, passes: 7 * layers * passes      # noqa: E731
HEAD = lambda layers, steps, passes: passes                      # noqa: E731
LINEARS_AND_HEAD = lambda layers, steps, passes: (               # noqa: E731
    7 * layers + 1) * passes


def serve_phase(name: str, argv, expect: dict, generate: bool = True,
                min_preemptions: int = 0) -> dict:
    """Build `cli serve` (runtime + scheduler) from `argv`, put the port's
    aiohttp app on a localhost port and drive it: 8 concurrent /ws/tts
    streams, then (with `generate`) one /generate, then /metrics. `expect`
    maps each kernel of the phase's path to its launch count as a function
    of (layers, decode steps, forward passes); every kernel it does not name
    must not run, except K6, which must."""
    from aiohttp import web

    from tts_inference_tpu_torch import cli
    from tts_inference_tpu_torch.serving.app import create_app

    args = cli.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    rt, scheduler = cli.build_serving(args)
    core = scheduler.core
    kv = (" int4" if getattr(core.cache, "int4", False)
          else " int8" if core.cache.quantized else "")
    weights = type(core.params["layers"][0]["wq"]).__name__
    print(f"serve[{name}]: runtime + warmup {time.perf_counter() - t0:.1f} s "
          f"on {rt.device}; {rt.config.model.num_hidden_layers} layers, "
          f"hidden {rt.config.model.hidden_size}, {core.batch} slots, "
          f"max_seq {core.max_seq}, cache {type(core.cache).__name__}"
          f"{kv}, weights {weights}, free KV tokens "
          f"{core.free_tokens()}", flush=True)
    port = _free_port()
    cores = (core, rt.engine.core)
    counters = _launch_counters()

    async def run() -> dict:
        runner = web.AppRunner(create_app(rt, scheduler))
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        try:
            return await _drive(port, generate)
        finally:
            await runner.cleanup()

    scheduler.start()
    try:
        if rt.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        # counts cover exactly the main path's run
        for c in counters.values():
            c.reset()
        steps0 = sum(c.decode_steps for c in cores)
        prefills0 = sum(c.prefills for c in cores)
        res = asyncio.run(run())
        steps = sum(c.decode_steps for c in cores) - steps0
        passes = steps + sum(c.prefills for c in cores) - prefills0
        launches = {k: c.count for k, c in counters.items()}
    finally:
        scheduler.stop()

    layers = rt.config.model.num_hidden_layers
    for i, s in enumerate(res["streams"]):
        if s["bytes"] != PCM_BYTES:
            raise AssertionError(f"stream {i}: {s['bytes']} PCM bytes, "
                                 f"expected {PCM_BYTES}")
    if generate and res["generate_samples"] != PCM_BYTES // 2:
        raise AssertionError(f"/generate: {res['generate_samples']} samples")
    on_cuda = rt.device.type == "cuda"
    want = {k: fn(layers, steps, passes) for k, fn in expect.items()}
    others = [k for k in launches if k not in want and k != "K6"]
    if on_cuda and not (steps > 0 and launches["K6"] > 0
                        and all(launches[k] == n for k, n in want.items())
                        and all(launches[k] == 0 for k in others)):
        raise AssertionError(f"serve[{name}] kernel launches {launches}: "
                             f"need {want} for {layers} layers, {steps} "
                             f"decode steps, {passes} forward passes, K6 > 0,"
                             f" {others} == 0")
    sched_metrics = res["metrics"]["scheduler"]
    if sched_metrics.get("preemptions", 0) < min_preemptions:
        raise AssertionError(f"serve[{name}]: /metrics {sched_metrics}, "
                             f"expected >= {min_preemptions} preemptions")
    audio_s = PCM_BYTES / 2 / 24000
    ttfa = sorted(s["ttfa_ms"] for s in res["streams"])
    out = {
        "ttfa_ms_p50": ttfa[len(ttfa) // 2],
        "ttfa_ms_p95": ttfa[min(len(ttfa) - 1,
                                int(round(0.95 * (len(ttfa) - 1))))],
        "per_stream_rtf": [audio_s / s["wall_s"] for s in res["streams"]],
        "aggregate_rtf": N_STREAMS * audio_s / res["wave_s"],
        "wave_wall_s": res["wave_s"],
        "generate_wall_s": res.get("generate_s"),
        "decode_steps": steps, "forward_passes": passes,
        "launches": launches,
        "scheduler_metrics": sched_metrics,
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if on_cuda else None),
    }
    print(f"serve[{name}] TTFA ms p50 {out['ttfa_ms_p50']:.1f} p95 "
          f"{out['ttfa_ms_p95']:.1f}", flush=True)
    rtf = out["per_stream_rtf"]
    print(f"serve[{name}] RTF per stream {min(rtf):.4f}..{max(rtf):.4f} "
          f"aggregate {out['aggregate_rtf']:.3f}", flush=True)
    print(f"serve[{name}] peak memory {out['max_memory_allocated']} bytes",
          flush=True)
    print(f"serve[{name}]: 8 x /ws/tts{' + /generate' if generate else ''} "
          "ok:", json.dumps(out), flush=True)
    return {"rt": rt, **out}


def exactness_phase(rt) -> dict:
    """One request's codes decoded once in a single batch and once through
    the windowed lookahead (the streaming path), compared in PCM16."""
    import numpy as np

    from tts_inference_tpu_torch import protocol
    from tts_inference_tpu_torch.config import SamplingConfig
    from tts_inference_tpu_torch.models.snac import to_pcm16
    from tts_inference_tpu_torch.streaming.lookahead import \
        LookaheadStreamingDecoder

    sampling = SamplingConfig(
        max_tokens=MAX_TOKENS, seed=7,
        token_range=(protocol.TOKEN_AUDIO_BASE,
                     protocol.TOKEN_AUDIO_BASE + protocol.AUDIO_VOCAB))
    prompt = rt.pipeline.build_prompt("Exactness probe.", force_speech=True)
    tokens = rt.engine.generate(prompt, sampling).token_ids
    ex = protocol.TokenExtractor()
    ex.started = True
    codes = ex.feed_many(tokens)
    l1, l2, l3 = protocol.deinterleave_frames(codes)
    batch = rt.vocoder.decode_frames(l1, l2, l3, noise_seed=0)
    la = LookaheadStreamingDecoder(rt.vocoder, rt.config.stream, 0)
    parts = []
    for i in range(0, len(codes), protocol.FRAME_SIZE):
        la.feed(codes[i:i + protocol.FRAME_SIZE])
        out = la.poll()
        if out is not None:
            parts.append(out)
    tail = la.flush()
    if tail is not None:
        parts.append(tail)
    windowed = np.concatenate(parts)
    if len(tokens) != MAX_TOKENS or batch.shape != (PCM_BYTES // 2,) \
            or not (np.isfinite(batch).all() and np.isfinite(windowed).all()):
        raise AssertionError(f"{len(tokens)} tokens, batch audio "
                             f"{batch.shape}, finite audio expected")
    a = to_pcm16(torch.from_numpy(batch)).numpy().astype(np.int32)
    b = to_pcm16(torch.from_numpy(windowed)).numpy().astype(np.int32)
    if a.shape != b.shape:
        raise AssertionError(f"windowed {b.shape} vs batch {a.shape}")
    diff = np.abs(a - b)
    res = {"frames": len(l1), "windows": la.decode_calls,
           "max_pcm16_diff": int(diff.max()),
           "samples_differing": int((diff > 0).sum()), "samples": len(a)}
    print("exactness: windowed vs batch decode", json.dumps(res), flush=True)
    if res["max_pcm16_diff"] > PCM16_TOL:
        raise AssertionError(f"windowed decode off by {res['max_pcm16_diff']}"
                             f" LSB > {PCM16_TOL}")
    return res


def _copy_tree(dst, src) -> None:
    """Copy a parameter tree into one of the same structure, in place."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_tree(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):   # tuples: the quantized leaves
        for d, s in zip(dst, src):
            _copy_tree(d, s)
    elif dst is not None:
        dst.copy_(src)


def _tiny_pair(device, quantize=False, weight_bits=8, **engine_over):
    """The tiny_config() runtime on the CPU and on `device` (the card), with
    the same weights (the card's copied from the CPU's, quantized leaves
    byte for byte)."""
    from tts_inference_tpu_torch.config import tiny_config
    from tts_inference_tpu_torch.runtime import Runtime

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(cfg.engine,
                                                              **engine_over))
    cpu = Runtime.create(cfg, seed=0, device="cpu", quantize=quantize,
                         weight_bits=weight_bits)
    gpu = Runtime.create(cfg, seed=0, device=device, quantize=quantize,
                         weight_bits=weight_bits)
    _copy_tree(gpu.engine.core.params, cpu.engine.core.params)
    _copy_tree(gpu.vocoder.params, cpu.vocoder.params)
    return cpu, gpu


def _tiny_sampling():
    from tts_inference_tpu_torch import protocol
    from tts_inference_tpu_torch.config import SamplingConfig

    return SamplingConfig(
        greedy=True, max_tokens=70,
        token_range=(protocol.TOKEN_AUDIO_BASE,
                     protocol.TOKEN_AUDIO_BASE + protocol.AUDIO_VOCAB))


def _cpu_top2_gap(rt, prompt, toks, i, sampling) -> float:
    """The CPU's logit gap between the best and the second-best allowed
    token at greedy step i: prompt + toks[:i] prefilled into a cache of the
    runtime's kind, then the repetition penalty and the token range applied
    as the sampler applies them."""
    from tts_inference_tpu_torch.models import llama
    from tts_inference_tpu_torch.ops import sampling as S

    core, cfg = rt.engine.core, rt.config.model
    ecfg = rt.config.engine
    if ecfg.paged_kv:
        bs = ecfg.kv_block_size
        nblk = core.max_seq // bs
        cache = llama.init_paged_kv_cache(
            cfg, 1, core.max_seq, num_blocks=1 + nblk, block_size=bs,
            int8=ecfg.kv_cache_int8, int4=ecfg.kv_cache_int4)
        cache.block_table[0] = torch.arange(1, 1 + nblk, dtype=torch.int32)
    else:
        cache = llama.init_kv_cache(cfg, 1, core.max_seq,
                                    int8=ecfg.kv_cache_int8)
    ids = torch.tensor([list(prompt) + list(toks[:i])], dtype=torch.int32)
    n = torch.tensor([ids.shape[1]], dtype=torch.int32)
    logits, _ = llama.prefill(core.params, cfg, ids, n, cache,
                              logits_base=core.logits_base)
    presence = S.mark_prompt(S.init_sampling_state(1, cfg.vocab_size), ids,
                             n).presence
    pen = S.apply_repetition_penalty(
        logits, presence[:, core.logits_base:],
        torch.tensor([sampling.repetition_penalty]))
    lo, hi = sampling.token_range
    col = core.logits_base + torch.arange(pen.shape[-1])
    pen = pen.masked_fill(~((col >= lo) & (col < hi)), float("-inf"))
    top = pen[0].topk(2).values
    return float(top[0] - top[1])


def _tiny_check(name: str, device, flip_gap=None, quantize=False,
                weight_bits=8, **engine_over) -> dict:
    """Greedy tokens of the tiny slice equal on the card and the CPU, and
    PCM within PCM16_TOL. With `flip_gap`, a differing token is allowed
    where the CPU's top-2 logit gap is at most flip_gap (a one-level
    rounding flip of a quantized KV entry between the machines); the phase
    prints the step and the gap, and compares no PCM then."""
    import numpy as np

    cpu, gpu = _tiny_pair(device, quantize, weight_bits, **engine_over)
    sampling = _tiny_sampling()
    prompt = cpu.pipeline.build_prompt("hello", force_speech=True)
    toks = [[t for c in r.engine.stream(prompt, sampling) for t in c]
            for r in (cpu, gpu)]
    if len(toks[0]) != sampling.max_tokens or len(toks[1]) != len(toks[0]):
        raise AssertionError(f"tiny {name}: {len(toks[1])} card tokens, "
                             f"{len(toks[0])} CPU tokens")
    res = {"tokens": len(toks[0])}
    if toks[0] != toks[1]:
        i = next(k for k, (a, b) in enumerate(zip(*toks)) if a != b)
        gap = None if flip_gap is None else _cpu_top2_gap(cpu, prompt,
                                                          toks[0], i, sampling)
        print(f"reference[{name}]: first token difference at step {i}: card "
              f"{toks[1][i]} CPU {toks[0][i]}; CPU top-2 logit gap {gap}",
              flush=True)
        if gap is None or gap > flip_gap:
            raise AssertionError(f"tiny {name} greedy tokens: card {toks[1]} "
                                 f"vs CPU {toks[0]}")
        res.update(first_diff_step=i, cpu_top2_gap=gap)
        return res
    pcm = [np.frombuffer(b"".join(
        c.pcm for c in r.pipeline.stream("hello", sampling=sampling,
                                         force_speech=True)),
        np.int16).astype(np.int32) for r in (cpu, gpu)]
    if pcm[0].shape != pcm[1].shape or pcm[0].size != 10 * 2048:
        raise AssertionError(f"tiny {name} PCM: card {pcm[1].shape} vs CPU "
                             f"{pcm[0].shape}")
    diff = np.abs(pcm[0] - pcm[1])
    res.update(max_pcm16_diff=int(diff.max()),
               samples_differing=int((diff > 0).sum()),
               samples=int(diff.size))
    if res["max_pcm16_diff"] > PCM16_TOL:
        raise AssertionError(f"tiny {name} PCM off by {diff.max()} LSB")
    return res


def reference_phase(rt) -> dict:
    """What comes out is right on a small input: the slice at
    ``tiny_config()`` (f32) with the same weights on the card (its kernels)
    and on the CPU (their plain versions, which the CPU tests hold against
    the JAX package) gives the same greedy tokens and PCM within
    PCM16_TOL; the full-geometry model gives finite logits of the expected
    shape through prefill and a K1 decode step."""
    from tts_inference_tpu_torch.models import llama

    res = {}
    with torch.no_grad():
        res["tiny"] = _tiny_check("dense", rt.device)
        core = rt.engine.core
        mcfg = rt.config.model
        prompt = rt.pipeline.build_prompt("hello", force_speech=True)
        cache = llama.init_kv_cache(mcfg, 1, 64, device=core.device)
        ids = torch.tensor([prompt], dtype=torch.int32, device=core.device)
        lens = torch.tensor([len(prompt)], dtype=torch.int32,
                            device=core.device)
        logits, cache = llama.prefill(core.params, mcfg, ids, lens, cache,
                                      logits_base=core.logits_base)
        nxt = logits.argmax(-1).to(torch.int32) + core.logits_base
        step, _ = llama.decode_one(core.params, mcfg, nxt, cache,
                                   logits_base=core.logits_base)
        want = (1, mcfg.vocab_size - core.logits_base)
        for name, t in (("prefill", logits), ("decode", step)):
            if tuple(t.shape) != want or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"full-geometry {name} logits "
                                     f"{tuple(t.shape)}, expected {want}, "
                                     "finite")
        res["full_geometry_logits"] = list(want)
    print("reference: card vs CPU on tiny_config, full-geometry logits",
          json.dumps(res), flush=True)
    return res


def _preempt_run(rt, pool_tokens: int) -> dict:
    """Two stochastic requests (repetition penalty on) through a scheduler
    on the card over a paged on-demand pool of `pool_tokens`; returns each
    request's tokens and PCM and the preemption count."""
    from tts_inference_tpu_torch import protocol
    from tts_inference_tpu_torch.config import SamplingConfig, StreamConfig
    from tts_inference_tpu_torch.engine import scheduler as TS

    class Recording(TS.Scheduler):
        """Keeps each finished request's raw token stream."""

        def _release(self, slot):
            st = self.slots[slot]
            if st is not None:
                finished[st.req.text] = list(st.token_ids)
            super()._release(slot)

    finished = {}
    cfg = dataclasses.replace(rt.config, engine=dataclasses.replace(
        rt.config.engine, paged_kv=True, kv_on_demand=True, kv_block_size=32,
        kv_pool_tokens=pool_tokens, resume_buckets=(128, 256)))
    sched = Recording(rt.engine.core.params, cfg, rt.vocoder, rt.tokenizer,
                      device=rt.device)
    scfg = StreamConfig(frames_per_chunk=2, lookahead_frames=3,
                        left_context_frames=4)
    reqs = [TS.TTSRequest(text=text, stream_cfg=scfg, force_speech=True,
                          sampling=SamplingConfig(
                              max_tokens=80, seed=123 + i, temperature=0.8,
                              top_p=0.9, repetition_penalty=1.15,
                              token_range=(protocol.TOKEN_AUDIO_BASE,
                                           protocol.TOKEN_AUDIO_BASE
                                           + protocol.AUDIO_VOCAB)))
            for i, text in enumerate(("older stream", "younger stream"))]
    sched.submit(reqs[0])
    sched.step()                  # admit the older one first
    sched.submit(reqs[1])
    for _ in range(4000):
        if not sched.step() and sched.n_queued == 0 and not sched.n_active:
            break
    else:
        raise AssertionError("preempt run did not drain")
    sched.drain_vocoder()
    pcm = {}
    for r in reqs:
        chunks = []
        while True:
            kind, payload = r.events.get(timeout=60)
            if kind == "chunk":
                chunks.append(payload.pcm)
            elif kind == "done":
                break
            else:
                raise AssertionError(f"{r.text}: {payload}")
        pcm[r.text] = b"".join(chunks)
    sched.stop()
    return {"tokens": finished, "pcm": pcm,
            "preemptions": sched.preemptions}


def paged_reference_phase(device="cuda") -> dict:
    """The tiny slice on the card against the CPU, paged (K3a), dense int8
    (K1 over the dequantized window) and paged int8 (K3b; a differing token
    only where the CPU's top-2 logit gap is <= 1e-3); then a preempt →
    resume on the card (two requests, a pool that forces a preemption)
    against the same requests over a pool large enough for both: equal
    tokens and PCM within PCM16_TOL. The last is the check of the block
    table's ordering on the stream that the CPU cannot make."""
    import numpy as np

    from tts_inference_tpu_torch.config import tiny_config
    from tts_inference_tpu_torch.runtime import Runtime

    res = {}
    with torch.no_grad():
        res["paged"] = _tiny_check("paged", device, paged_kv=True,
                                   kv_block_size=16)
        res["dense_int8"] = _tiny_check("dense_int8", device,
                                        kv_cache_int8=True)
        res["paged_int8"] = _tiny_check("paged_int8", device, flip_gap=1e-3,
                                        paged_kv=True, kv_cache_int8=True,
                                        kv_block_size=16)
        gpu = Runtime.create(tiny_config(), seed=0, device=device)
        small = _preempt_run(gpu, 5 * 32)
        large = _preempt_run(gpu, 320 * 4)
    if small["preemptions"] < 1 or large["preemptions"] != 0:
        raise AssertionError(f"preemptions: small pool {small['preemptions']}"
                             f", large pool {large['preemptions']}")
    diffs = {}
    for text, toks in large["tokens"].items():
        if small["tokens"].get(text) != toks or len(toks) != 80:
            raise AssertionError(f"{text}: tokens with preemption "
                                 f"{small['tokens'].get(text)} vs {toks}")
        a = np.frombuffer(small["pcm"][text], np.int16).astype(np.int32)
        b = np.frombuffer(large["pcm"][text], np.int16).astype(np.int32)
        if a.shape != b.shape or a.size == 0:
            raise AssertionError(f"{text}: PCM {a.shape} vs {b.shape}")
        diffs[text] = int(np.abs(a - b).max())
    if max(diffs.values()) > PCM16_TOL:
        raise AssertionError(f"preempt/resume PCM off by {diffs} LSB")
    res["preempt_resume"] = {"preemptions": small["preemptions"],
                             "tokens_equal": True, "max_pcm16_diff": diffs}
    print("reference[paged]: card vs CPU on tiny_config, preempt/resume on "
          "the card", json.dumps(res), flush=True)
    return res


def quant_reference_phase(device="cuda") -> dict:
    """The tiny slice on the card against the CPU from the same quantized
    leaves: int4 weights + int4 KV pools (K4 on every layer linear, K5, K2
    on the head) and int8 weights over the dense cache (K2, K1). A differing
    greedy token is allowed only where the CPU's top-2 logit gap is <= 1e-3
    (quantized KV entries round at near-ties between the machines)."""
    res = {}
    with torch.no_grad():
        res["int4"] = _tiny_check("int4", device, flip_gap=1e-3,
                                  quantize=True, weight_bits=4, paged_kv=True,
                                  kv_cache_int4=True, kv_block_size=16)
        res["int8w"] = _tiny_check("int8w", device, flip_gap=1e-3,
                                   quantize=True, weight_bits=8)
    print("reference[quant]: card vs CPU on tiny_config", json.dumps(res),
          flush=True)
    return res


def _free(phase: dict) -> None:
    """Drop a full-width runtime before the next one is built."""
    phase.pop("rt", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


KERNELS = (
    # key, name, source under tts_inference_tpu_torch/csrc, the TPU kernel
    ("K1", "decode_attention", "decode_attention.cu",
     "tts_inference_tpu/ops/pallas/decode_attention.py:97"),
    ("K6", "fused_residual_unit", "vocoder.cu",
     "tts_inference_tpu/ops/pallas/vocoder.py:212"),
    ("K3a", "paged_decode_attention", "paged_attention.cu",
     "tts_inference_tpu/ops/pallas/paged_attention.py:224"),
    ("K3b", "paged_decode_attention_int8", "paged_attention.cu",
     "tts_inference_tpu/ops/pallas/paged_attention.py:286"),
    ("K4", "int4_mm", "quant_matmul.cu",
     "tts_inference_tpu/ops/pallas/int4_matmul.py:192"),
    ("K5", "paged_decode_attention_int4", "paged_attention.cu",
     "tts_inference_tpu/ops/pallas/paged_attention_int4.py:285"),
    ("K2", "w8_mm", "quant_matmul.cu", None),   # no TPU original
)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None, metavar="PHASES",
                    help="development: run only these phases (comma list of "
                         "kernels, dense, paged, quant) and print no result "
                         "line; the full run takes no arguments")
    only = ap.parse_args(argv).only
    only = set(only.split(",")) if only else None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port must be importable from here before anything is reported
    import tts_inference_tpu_torch.cli  # noqa: F401
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    build_phase()

    def on(phase: str) -> bool:
        return only is None or phase in only

    kern = kernel_phase() if on("kernels") else None
    phases = {}
    if on("dense"):
        dense = phases["dense"] = serve_phase("dense", ["serve"],
                                              {"K1": PER_STEP})
        exactness_phase(dense["rt"])
        reference_phase(dense["rt"])
        _free(dense)
    if on("paged"):
        phases["paged_int8"] = serve_phase(
            "paged_int8", ["serve", "--paged-kv", "--kv-int8",
                           "--kv-on-demand", "--kv-block-size", "128",
                           "--kv-pool-tokens", "2048"],
            {"K3b": PER_STEP}, generate=False, min_preemptions=1)
        _free(phases["paged_int8"])
        phases["paged_bf16"] = serve_phase("paged_bf16",
                                           ["serve", "--paged-kv"],
                                           {"K3a": PER_STEP})
        _free(phases["paged_bf16"])
        paged_reference_phase()
    if on("quant"):
        phases["int4"] = serve_phase(
            "int4", ["serve", "--quantize", "--weight-bits", "4",
                     "--paged-kv", "--kv-int4"],
            {"K4": LINEARS, "K5": PER_STEP, "K2": HEAD}, generate=False)
        _free(phases["int4"])
        phases["int8w"] = serve_phase(
            "int8w", ["serve", "--quantize"],
            {"K2": LINEARS_AND_HEAD, "K1": PER_STEP}, generate=False)
        _free(phases["int8w"])
        quant_reference_phase()
    if only is not None:
        print(f"chip_smoke: phases {sorted(only)} passed; no result line "
              "without the full run", flush=True)
        return 0
    # each kernel's launches on the main path of the phase that runs it
    on_path = {"K1": "dense", "K6": "dense", "K3a": "paged_bf16",
               "K3b": "paged_int8", "K4": "int4", "K5": "int4",
               "K2": "int8w"}
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"tts_inference_tpu_torch/csrc/{src}", "replaces": tpu,
         "launches": phases[on_path[key]]["launches"][key], **kern[key]}
        for key, name, src, tpu in KERNELS]
    if any(k["launches"] < 1 for k in kernels):
        raise AssertionError(f"a kernel never ran on its main path: {kernels}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
