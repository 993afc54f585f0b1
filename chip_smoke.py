"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failed check raises, so the exit code is nonzero and
no result line is printed:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build of the hand-written kernels from ``tts_inference_tpu_torch/csrc``;
3. kernel phase: each of the nine kernels (K1, K6, K6-bf16, K6-f16, K3a, K3b, K5 over pools
   filled by the port's own pool writes; K4 and K2 over weights quantized
   by the port) against its plain PyTorch version on the card, at the serve
   paths' shapes: max |Δ| and its tolerance, device µs per call of both (a
   CUDA graph of the calls, replayed), the least time the card could take
   (bytes or operations), and the time of the one PyTorch call that
   computes the same function where there is one (K2: the build is asked
   whether it has ``aten::_weight_int8pack_mm`` on CUDA; K4: tinygemm's
   ``aten::_weight_int4pack_mm`` on a repacked copy, held against K4's
   plain version); the time of an
   empty kernel; a ``torch.profiler`` count that every K4 / K2 call, and
   every K3b / K5 call with bf16 queries, is one kernel; every kernel also
   at the edges of its tilings, correctness only, each case run twice for
   bit-equal outputs (K4 / K2: M 1 to 4096, N under a padded w_p, small
   groups, column and row slices of a wider weight read in place, what the
   tensor-core kernel refuses, f32 x; K1, and K3a / K3b / K5 over block
   sizes 16 to 128: G 1, 3, 4, 8, D 64, f32 at the tiny shapes (the
   CUDA-core body), windows that are no multiple of a chunk, every pos 0
   and W - 1, pos at a chunk's last and first key, a column slice of a
   wider block table; K6: T that is no multiple of a tile, T below the
   halo, valid 0 and T on different rows, channel-last input, channel
   counts below the narrowest tile and no multiple of 4); K6-bf16 and
   K6-f16, the 16-bit body in bf16 and in float16, at the same 12 serve
   shapes and at the 12 units of the first chunk at batch 1 (one row of 8
   frames), timed, against their plain versions in the same dtype (two
   steps of that dtype at the largest output), and at K6's edges plus an
   odd channel count and, at every width, the layouts the copy engine
   cannot take (channel-first T no multiple of 8, x one element in, T
   under the halo at dilation 9);
4. serve phase: the full Orpheus-3B + SNAC 24 kHz geometry with seeded
   random weights behind the port's aiohttp server (``cli serve``
   defaults: 8 slots, max_seq 4608, dense bf16 KV); 8 concurrent
   ``/ws/tts`` requests and one ``/generate``; launch counts prove K1 and
   K6 carried the path. Every serve phase prints each stream's worst
   inter-chunk gap (client clock at every binary message), p50 and max over
   the streams, and the CUDA-graph census of
   its two engine cores (graphs captured at warmup, capture seconds), and
   fails unless every decode and admission launch of the run was a graph
   replay with no capture while serving; every serve phase prints the
   vocoder's graph census too (row bucket x frame bucket, first chunk) and
   fails unless every vocode-worker call and fused first chunk was a
   replay, with K6 (or K6-bf16) launched exactly 12 times a vocoder call;
   after it, a graph phase runs the same eight requests (greedy and
   seeded) through a scheduler over an eager core (``EngineCore(...,
   graphs=False)``) and eager vocoder and over replayed ones on the
   phase's weights: tokens equal, or a greedy flip at an eager top-2 logit
   gap <= 1e-3, and the PCM of equal tokens within PCM16_TOL;
5. streaming exactness: windowed lookahead decode vs one batch decode;
6. reference: the slice at ``tiny_config()`` on the card against the same
   weights on the CPU (plain versions), and finite full-geometry logits;
7. checkpoint phase: the dense phase's seeded weights written as an
   Orpheus-3B HF dir (bf16, 2 GiB safetensors shards, a byte-level BPE
   tokenizer.json) and a SNAC dir by ``tools/make_checkpoint.py``, booted
   by ``cli serve --model-path --snac-path`` (every leaf equal, the port's
   own tokenizer) and served as in 4 (K1, K6, every launch a replay);
   then ``cli quantize`` and a boot from its output with no quantization
   at boot, int8 leaves byte-equal, one request carried by K2;
8. train phase: three LoRA steps of the tiny model on the card against
   the CPU in f32 (TF32 off) and bf16 (every step's loss and the final A
   and B within TRAIN_TOL); then at full width on the checkpoint phase's HF
   dir: ``finetune train`` (LoRA r 16 on the 7 targets, 20 steps of 2 x
   512 tokens over 16 records of text + 60 frames, a step checkpoint every
   10: the mean loss of the last 5 steps below the first 5's, the last two
   step dirs kept; step ms, tokens/s, TFLOP/s against the bound of the
   operations at their type's peak, peak memory), 2 steps of
   ``--full-finetune`` (step ms, TFLOP/s, peak memory), ``finetune
   merge`` (seconds, write GB/s), and ``cli serve --model-path merged``
   with the 8 streams as in 4, where the booted leaves and the greedy
   tokens equal an in-memory merge on the card, the served PCM of those
   tokens passes ``tools/audio_fidelity`` against their whole decode, and
   ``tools/analyze_tokens`` finds no invalid frame in any served stream;
9. paged int8 serve phase: ``serve --paged-kv --kv-int8 --kv-on-demand``
   with a pool too small for the 8 streams (16 blocks of 128), so streams
   are preempted and resumed; K3b carries every decode step, K1 and K3a
   none; the census holds the resume tier (``capture_prefill_resume_1024``
   and ``_2048``), every resume (one per preemption, at least one) replays
   a graph, and the phase prints the resume gap (the worst gap of the
   preempted streams) and their RTF, and its peak memory; then the soak
   (``tools/soak.py`` over that phase's scheduler, twice: 30 s of
   randomized churn at 8 target streams, cancel rate 0.1; no error, no slot
   or block leak, the vocode queue drained, every submission accounted
   for, no capture; first at 300-900 tokens a request, where the pool must
   preempt and every resume replay a graph, then at the JAX tool's 14-70
   with RSS growth and TTFA drift within the tool's limits, printed beside
   them);
10. paged bf16 serve phase: ``serve --paged-kv`` (worst-case reservation),
   8 streams and one ``/generate``; K3a carries every decode step;
11. paged reference: the tiny slice paged (K3a), dense int8 and paged int8
   (K3b) on the card against the CPU, and a preempt → resume on the card
   against the same requests served without preemption, every launch of
   both a graph replay (the scheduler's warmup captures them);
12. int4 serve phase: ``serve --quantize --weight-bits 4 --paged-kv
    --kv-int4``; K4 carries every layer linear of every forward pass, K5
    every decode step, K2 the head; K1, K3a, K3b none;
13. int8 weights serve phase: ``serve --quantize``; K2 carries every linear
    and the head, K1 every decode step; then the native phase, ``serve
    --quantize --native-protocol`` (the C++ extractor and deinterleave of
    ``native/tts_runtime.cpp``), the same kernel counts, printed beside
    int8w, and the tiny scheduler on the card with the native and the
    Python extractor over the same requests: tokens and PCM byte-equal;
14. quantized reference: the tiny slice with int4 weights + int4 KV and with
    int8 weights on the card against the same quantized leaves on the CPU;
15. prefix serve phase: ``serve --prefix-cache`` (dense bf16 KV), two waves
    of 8 ``/ws/tts`` requests whose texts share a 37-byte opener, then one
    ``/generate``; the waves add exactly 1 miss and 15 hits to the
    scheduler core's prefix counters on ``/metrics`` (the warmup's probes
    missed once and hit before), every launch (the build's too) is a
    replay, K1 carries every decode step; TTFA per wave beside the dense
    phase's;
16. prefix reference: the five KV layouts (dense bf16, dense int8, paged
    bf16, paged int8 on demand, paged int4 with int4 weights) at full
    width, a prefix core against a plain core over the same weights (eager
    cores): the injected rows [0, 32) against the plain prefill's, greedy
    tokens of a miss wave and a hit wave of 8 requests, and on demand an
    admission beside a live slot at the edge of its last block;
17. the bf16 vocoder: the `vocoder_bf16` serve phase (``serve
    --vocoder-bf16``; K6-bf16 on every unit of every vocoder call, K6
    none, K1 every decode step, every vocoder call a replay) beside the
    dense phase's numbers, windowed vs batch decode in bf16 within
    PCM16_TOL_BF16, and the fidelity gate of
    ``tools/vocoder_dtype_fidelity.py`` at full geometry (64 frames x 4
    rows: MSE, max |diff|, corr, std ratio); then the float16 vocoder
    (``SnacConfig(dtype="float16")``, which no serve flag reaches): the
    same gate for a float16 decode of the same codes, with the launch
    counters set to 0 before it (K6-f16 12, K6 12 for the f32 decode,
    nothing else);
18. the card line, the kernels' JSON line, and last
    ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package. Exits nonzero
without a card. ``--only PHASES`` (kernels, qmm = K4 and K2 alone, dense,
checkpoint, train, paged, quant, native, prefix, vocoder = phase 17 with the 16-bit
kernel cases; paged,soak runs the churn soak twice; gap = the paged_int8 serve
phase alone, with ``--port-root DIR`` from another checkout, to time two
trees in one call) runs some phases during development and prints no
result line.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

K1_TOL = 2e-2    # bf16 inputs; compared in f32
K3_TOL = 2e-2    # K3a/K3b/K5: bf16 queries and outputs; compared in f32
K6_TOL = 1e-4    # f32 with TF32 off on both sides
# K6 in bf16: the kernel keeps stage 1 and the sums in f32 and rounds twice
# (y2, the output); the plain version rounds after every bf16 operation. On
# the CPU the two arithmetics differ by one bf16 step of the largest output
# at all twelve serve shapes; the tolerance is two such steps
K6_BF16_STEPS = 2
# K6 in float16: the same body and the same two roundings against torch's
# float16 sequence; the tolerance is two float16 steps (2^-10 relative) of
# the largest output, as in bf16 (measured on the CPU against the Pallas
# kernel and XLA: 0.5–1 step)
K6_F16_STEPS = 2
# K4/K2: the kernel and the plain version both accumulate in f32, in another
# order, and round once: a bf16 output may differ by one bf16 step of the
# largest output (2^-7 relative), an f32 output by summation order only
QMM_TOL_BF16 = 2.0 ** -7
QMM_TOL_F32 = 1e-4

# Published peaks of one H100 SXM (NVIDIA's data sheet), for the bounds:
# device memory, dense bf16 tensor cores, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def bound(nbytes: float, flops, kind: str = "") -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the operations at
    the peak rate of their type, whichever is larger. `flops` is a count of
    `kind`, or a dict type → count (their times add)."""
    if not isinstance(flops, dict):
        flops = {kind: flops}
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_FLOPS[k] for k, n in flops.items()) * 1e3
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


def _edge(name: str, what: str, fn, want, tol: float) -> float:
    """One correctness-only case: the kernel twice (bit-equal outputs) and
    its plain version once; no timing."""
    got, again = fn(), fn()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    print(f"{name} edge {what}: max|d|={err:.3e} (tol {tol:.1e})", flush=True)
    if not torch.equal(got, again):
        raise AssertionError(f"{name} edge {what}: two runs differ")
    if not err <= tol:
        raise AssertionError(f"{name} edge {what}: max|d| {err} > {tol}")
    return err


def _k1_edges(gen: torch.Generator) -> float:
    """The edges of K1's tilings: G 1, 4 and 8; D 64; f32 at the tiny
    configuration's shapes; windows that are no multiple of a chunk; every
    pos 0 and every pos W - 1; pos at a chunk's last and first key. K and V
    are window slices of a longer cache (a free batch stride) throughout."""
    from tts_inference_tpu_torch.ops.decode_attention import (
        MMA_CHUNKS, decode_attention, decode_attention_reference)

    dev, bf16, f32 = "cuda", torch.bfloat16, torch.float32
    edges = [c + (k - 1) for c in MMA_CHUNKS for k in (0, 1)]
    cases = [   # b, hkv, g, d, w, dtype, pos ("rand", "zero", "last", list)
        (8, 8, 1, 128, 512, bf16, "rand"), (8, 8, 4, 128, 512, bf16, "rand"),
        (8, 8, 8, 128, 512, bf16, "rand"), (8, 8, 3, 64, 512, bf16, "rand"),
        (8, 8, 8, 64, 2048, bf16, "rand"),
        (4, 2, 2, 16, 320, f32, "rand"), (4, 2, 2, 16, 64, f32, "rand"),
        (8, 8, 3, 128, 300, bf16, "rand"), (8, 8, 3, 128, 4480, bf16, "rand"),
        (8, 8, 3, 128, 512, bf16, "zero"), (8, 8, 3, 128, 512, bf16, "last"),
        (8, 8, 3, 128, 4608, bf16, "zero"), (8, 8, 3, 128, 4608, bf16, "last"),
        (4, 8, 3, 128, 512, bf16, edges), (4, 8, 3, 128, 4608, bf16, edges),
        (1, 8, 3, 128, 64, bf16, "last"),
    ]
    worst = 0.0
    for b, hkv, g, d, w, dtype, how in cases:
        q = torch.randn(b, hkv, g, d, generator=gen, device=dev).to(dtype)
        kc, vc = (torch.randn(b, w + 96, hkv, d, generator=gen,
                              device=dev).to(dtype) for _ in range(2))
        k, v = kc[:, :w], vc[:, :w]
        if how == "rand":
            pos = torch.randint(0, w, (b,), generator=gen, device=dev)
        elif how == "zero":
            pos = torch.zeros(b, device=dev)
        elif how == "last":
            pos = torch.full((b,), w - 1, device=dev)
        else:
            pos = torch.tensor(how, device=dev)
        pos = pos.to(torch.int32)
        what = (f"B{b} Hkv{hkv} G{g} D{d} W{w} "
                f"{'bf16' if dtype == bf16 else 'f32'} pos "
                f"{how if isinstance(how, str) else pos.tolist()}")
        worst = max(worst, _edge(
            "K1", what, lambda: decode_attention(q, k, v, pos),
            decode_attention_reference(q, k, v, pos),
            K1_TOL if dtype == bf16 else 1e-5))
    return worst


def _k3a_edges(gen: torch.Generator) -> float:
    """K3a over bf16 pools runs K1's tensor-core body through the block
    table: block sizes below and above a chunk, G 1 and 8, D 64, every pos
    0 and every pos W - 1, pos at a chunk's last and first key; the f32
    pools of the tiny configuration (the CUDA-core body). The table is a
    column slice of a wider one, as the engine hands it."""
    from tts_inference_tpu_torch.ops import paged_attention as pa
    from tts_inference_tpu_torch.ops.decode_attention import MMA_CHUNKS

    dev, bf16, f32 = "cuda", torch.bfloat16, torch.float32
    edges = [c + (k - 1) for c in MMA_CHUNKS for k in (0, 1)]
    cases = [   # b, hkv, g, d, bs, wb, dtype, pos
        (8, 8, 3, 128, 16, 19, bf16, "rand"), (8, 8, 1, 128, 128, 4, bf16, "rand"),
        (8, 8, 8, 128, 32, 16, bf16, "rand"), (8, 8, 3, 64, 64, 8, bf16, "rand"),
        (8, 8, 3, 128, 128, 36, bf16, "zero"), (8, 8, 3, 128, 128, 36, bf16, "last"),
        (4, 8, 3, 128, 16, 32, bf16, edges), (4, 8, 3, 128, 128, 36, bf16, edges),
        (4, 2, 2, 16, 16, 20, f32, "rand"),
    ]
    worst = 0.0
    for b, hkv, g, d, bs, wb, dtype, how in cases:
        w, n = wb * bs, 1 + b * wb
        q = torch.randn(b, hkv, g, d, generator=gen, device=dev).to(dtype)
        pools = [torch.randn(n, hkv, bs, d, generator=gen,
                             device=dev).to(dtype) for _ in range(2)]
        wide = torch.zeros(b, wb + 3, dtype=torch.int32, device=dev)
        wide[:, :wb] = (torch.randperm(n - 1, generator=gen, device=dev)
                        .to(torch.int32) + 1).view(b, wb)
        table = wide[:, :wb]
        if how == "rand":
            pos = torch.randint(0, w, (b,), generator=gen, device=dev)
        elif how == "zero":
            pos = torch.zeros(b, device=dev)
        elif how == "last":
            pos = torch.full((b,), w - 1, device=dev)
        else:
            pos = torch.tensor(how, device=dev)
        pos = pos.to(torch.int32)
        what = (f"B{b} Hkv{hkv} G{g} D{d} bs{bs} W{w} "
                f"{'bf16' if dtype == bf16 else 'f32'} pos "
                f"{how if isinstance(how, str) else pos.tolist()}")
        worst = max(worst, _edge(
            "K3a", what,
            lambda: pa.paged_decode_attention(q, *pools, table, pos),
            pa.paged_decode_attention_reference(q, *pools, table, pos),
            K3_TOL if dtype == bf16 else 1e-5))
    return worst


def _quant_pools(kind: str, n: int, hkv: int, bs: int, d: int,
                 gen: torch.Generator):
    """K and V pools of `n` blocks, quantized by the port from random f32
    rows: K3b int8 (N, Hkv, bs, D) + scales (N, Hkv, bs); K5 int4 packed by
    head pair (N, Hkv/2, bs, D) + nibble-plane scales (N, 2, Hkv/2, bs)."""
    from tts_inference_tpu_torch.models.llama import _quantize_kv
    from tts_inference_tpu_torch.ops import paged_attention_int4 as pa4

    pools, scales = [], []
    for _ in range(2):
        x = torch.randn(n, bs, hkv, d, generator=gen, device="cuda")
        if kind == "K5":
            xq, xs = pa4.quantize_kv_int4(x)
            pools.append(xq.permute(0, 2, 1, 3).contiguous())
            scales.append(pa4.scales_to_planes(xs).permute(0, 2, 3, 1)
                          .contiguous())
        else:
            xq, xs = _quantize_kv(x)
            pools.append(xq.permute(0, 2, 1, 3).contiguous())
            scales.append(xs.permute(0, 2, 1).contiguous())
    return pools, scales


def _paged_quant_edges(kind: str, gen: torch.Generator) -> float:
    """K3b (int8 pools) or K5 (int4 pools packed by head pair) at the edges
    of the tensor-core body's tilings: block sizes 16 to 128, G 1, 3 and 8,
    D 64 and 128, one head pair, every pos 0 and every pos W - 1, pos at a
    chunk's last and first key; and f32 queries at the tiny configuration's
    shapes (the CUDA-core body). The table is a column slice of a wider one,
    as the engine hands it."""
    from tts_inference_tpu_torch.ops import paged_attention as pa
    from tts_inference_tpu_torch.ops import paged_attention_int4 as pa4
    from tts_inference_tpu_torch.ops.decode_attention import MMA_CHUNKS

    dev, bf16, f32 = "cuda", torch.bfloat16, torch.float32
    if kind == "K5":
        kern = pa4.paged_decode_attention_int4
        plain = pa4.paged_decode_attention_int4_reference
    else:
        kern = pa.paged_decode_attention_int8
        plain = pa.paged_decode_attention_int8_reference
    edges = [c + (k - 1) for c in MMA_CHUNKS for k in (0, 1)]
    cases = [   # b, hkv, g, d, bs, wb, dtype, pos
        (8, 8, 3, 128, 16, 19, bf16, "rand"), (8, 8, 1, 128, 128, 4, bf16, "rand"),
        (8, 8, 8, 128, 32, 16, bf16, "rand"), (8, 8, 3, 64, 64, 8, bf16, "rand"),
        (8, 8, 8, 64, 32, 40, bf16, "rand"), (4, 2, 3, 64, 16, 10, bf16, "rand"),
        (8, 8, 3, 128, 128, 36, bf16, "zero"), (8, 8, 3, 128, 128, 36, bf16, "last"),
        (4, 8, 3, 128, 16, 32, bf16, edges), (4, 8, 3, 128, 128, 36, bf16, edges),
        (2, 8, 3, 128, 128, 95, bf16, "last"), (4, 2, 2, 16, 16, 20, f32, "rand"),
    ]
    worst = 0.0
    for b, hkv, g, d, bs, wb, dtype, how in cases:
        w, n = wb * bs, 1 + b * wb
        q = torch.randn(b, hkv, g, d, generator=gen, device=dev).to(dtype)
        pools, scales = _quant_pools(kind, n, hkv, bs, d, gen)
        wide = torch.zeros(b, wb + 3, dtype=torch.int32, device=dev)
        wide[:, :wb] = (torch.randperm(n - 1, generator=gen, device=dev)
                        .to(torch.int32) + 1).view(b, wb)
        table = wide[:, :wb]
        if how == "rand":
            pos = torch.randint(0, w, (b,), generator=gen, device=dev)
        elif how == "zero":
            pos = torch.zeros(b, device=dev)
        elif how == "last":
            pos = torch.full((b,), w - 1, device=dev)
        else:
            pos = torch.tensor(how, device=dev)
        pos = pos.to(torch.int32)
        args = (q, *pools, *scales, table, pos)
        what = (f"B{b} Hkv{hkv} G{g} D{d} bs{bs} W{w} "
                f"{'bf16' if dtype == bf16 else 'f32'} pos "
                f"{how if isinstance(how, str) else pos.tolist()}")
        worst = max(worst, _edge(kind, what, lambda: kern(*args),
                                 plain(*args),
                                 K3_TOL if dtype == bf16 else 1e-5))
    return worst


def _k3b_edges(gen: torch.Generator) -> float:
    return _paged_quant_edges("K3b", gen)


def _k5_edges(gen: torch.Generator) -> float:
    return _paged_quant_edges("K5", gen)


def _attention_one_launch_check(gen: torch.Generator) -> dict:
    """Every K3b / K5 call with bf16 queries is exactly one kernel (the
    tensor-core body, its chunks combined by the last block): torch.profiler
    counts the kernels of one call at the serve shapes, B 8 and W 512 /
    2048 / 4608."""
    from torch.profiler import ProfilerActivity, profile

    from tts_inference_tpu_torch.ops import paged_attention as pa
    from tts_inference_tpu_torch.ops import paged_attention_int4 as pa4

    b, hkv, g, d, bs, dev = 8, 8, 3, 128, 128, "cuda"
    counts = {}
    for kind, fn in (("K3b", pa.paged_decode_attention_int8),
                     ("K5", pa4.paged_decode_attention_int4)):
        for w in (512, 2048, 4608):
            wb = w // bs
            n = 1 + b * wb
            pools, scales = _quant_pools(kind, n, hkv, bs, d, gen)
            q = torch.randn(b, hkv, g, d, generator=gen,
                            device=dev).bfloat16()
            table = (torch.randperm(n - 1, generator=gen, device=dev)
                     .to(torch.int32) + 1).view(b, wb)
            pos = torch.randint(0, w, (b,), generator=gen, device=dev)
            pos[0] = w - 1
            args = (q, *pools, *scales, table, pos.to(torch.int32))
            fn(*args)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn(*args)
                torch.cuda.synchronize()
            counts[f"{kind} W{w}"] = sum(
                ev.count for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA)
    print("K3b/K5 kernels per call (torch.profiler):", json.dumps(counts),
          flush=True)
    if any(c != 1 for c in counts.values()):
        raise AssertionError(f"a paged attention call is not one launch: "
                             f"{counts}")
    return counts


def _k6_edges(gen: torch.Generator) -> float:
    """The edges of K6's tilings: T that is no multiple of a tile, T shorter
    than the halo at dilation 9, valid 0 and valid T on different rows,
    channel-last input as well as the channel-first view, and channel counts
    below the narrowest tile (the tiny configuration's widths, and one that
    is no multiple of 4)."""
    from tts_inference_tpu_torch.ops.vocoder import (
        fused_residual_unit, fused_residual_unit_reference)

    dev = "cuda"
    cases = [   # c, t, dil, channel_first
        (512, 37, 1, True), (512, 512 + 5, 9, True), (64, 37, 3, True),
        (64, 512 + 5, 9, True), (256, 16, 9, True), (128, 133, 9, True),
        (512, 96, 3, False), (64, 700, 9, False), (256, 100, 1, False),
        (32, 512, 1, True), (16, 4096, 3, True), (8, 1000, 9, True),
        (4, 300, 9, True), (6, 77, 3, True), (6, 77, 3, False),
        (100, 260, 9, True), (300, 70, 3, True),
    ]
    worst = 0.0
    for c, t, dil, channel_first in cases:
        b = 3
        p = _k6_unit(c, gen)
        x = (torch.randn(b, c, t, generator=gen, device=dev).transpose(1, 2)
             if channel_first
             else torch.randn(b, t, c, generator=gen, device=dev))
        valid = torch.tensor([t, 0, max(1, t // 3)], dtype=torch.int32,
                             device=dev)
        what = (f"B{b} C{c} T{t} dil{dil} "
                f"{'channel-first' if channel_first else 'channel-last'}")
        worst = max(worst, _edge(
            "K6", what, lambda: fused_residual_unit(x, p, dil, valid),
            fused_residual_unit_reference(x, p, dil, valid), K6_TOL))
    return worst


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


def _k6_unit(c: int, gen: torch.Generator, dtype=torch.float32):
    dev = "cuda"

    def u(shape, scale):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * scale).to(dtype)

    return {
        "alpha1": (0.5 + torch.rand(c, generator=gen, device=dev)).to(dtype),
        "conv1": {"w": u((c, 1, 7), 7 ** -0.5), "b": u((c,), 0.1)},
        "alpha2": (0.5 + torch.rand(c, generator=gen, device=dev)).to(dtype),
        "conv2": {"w": u((c, c, 1), c ** -0.5), "b": u((c,), 0.1)},
    }


def steps16(want: torch.Tensor, steps: int, dtype) -> float:
    """`steps` steps of the 16-bit `dtype` at the largest magnitude in
    `want` (a value in [2^e, 2^(e+1)) has steps of 2^(e-7) in bf16,
    2^(e-10) in float16)."""
    import math

    m = want.float().abs().max().item()
    mant = 7 if dtype == torch.bfloat16 else 10
    return steps * 2.0 ** (math.floor(math.log2(m)) - mant) if m > 0 else 0.0


K6_16 = {torch.bfloat16: ("K6-bf16", "bf16", K6_BF16_STEPS),
         torch.float16: ("K6-f16", "f16", K6_F16_STEPS)}


def _k6_16_case(c: int, t: int, dil: int, gen: torch.Generator,
                dtype=torch.bfloat16, b: int = 8):
    """One residual unit in 16 bits (``--vocoder-bf16``, or
    ``SnacConfig.dtype="float16"``). The plain version is torch's sequence
    in the dtype (snakes, depthwise and pointwise convolutions — cuDNN's,
    or in float16 PyTorch's own — add), which is also the library
    sequence."""
    from tts_inference_tpu_torch.ops.vocoder import (
        fused_residual_unit, fused_residual_unit_reference)

    key, tag, n_steps = K6_16[dtype]
    p = _k6_unit(c, gen, dtype)
    x = torch.randn(b, c, t, generator=gen, device="cuda").to(dtype) \
        .transpose(1, 2)
    valid = torch.full((b,), t, dtype=torch.int32, device="cuda")
    valid[min(3, b - 1)] = t - 37
    x = torch.where(torch.arange(t, device="cuda")[None, :, None]
                    < valid[:, None, None], x,
                    torch.zeros((), dtype=x.dtype, device="cuda"))
    got = fused_residual_unit(x, p, dil, valid)
    want = fused_residual_unit_reference(x, p, dil, valid)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ms = time_ms(lambda: fused_residual_unit(x, p, dil, valid))
    plain = time_ms(lambda: fused_residual_unit_reference(x, p, dil, valid))
    # x read and the output written once in 16 bits, the weights once; the
    # pointwise product (2·C per output element) on the 16-bit tensor cores,
    # the taps and two snakes (~30 operations an element) in f32
    elems = b * t * c
    bnd = bound(2.0 * (2 * elems + c * c + 10 * c),
                {"bf16": 2.0 * c * elems, "f32": 30.0 * elems})
    return _report(f"{key} fused_residual_unit", f"B{b} C{c} T{t} dil{dil} "
                   f"{tag}", err, steps16(want, n_steps, dtype), ms, plain,
                   bnd, plain)


def _k6_16_edges(gen: torch.Generator, dtype=torch.bfloat16) -> float:
    """The 16-bit body at the edges of its tilings and paths: K6's f32 edge
    cases (T no multiple of a tile, T below the halo at dilation 9, valid 0
    and T on different rows, channel-last input, channel counts below the
    narrowest tile and no multiple of 4), an odd channel count, and at every
    width a channel-first T that is no multiple of 8, x whose storage starts
    one element in, and T shorter than the halo at dilation 9 — all of which
    the copy engine cannot take (the block gathers them) — and one T that it
    takes whole. Returns the worst error in units of the tolerance."""
    from tts_inference_tpu_torch.ops.vocoder import (
        fused_residual_unit, fused_residual_unit_reference)

    key, _, n_steps = K6_16[dtype]
    dev = "cuda"
    cases = [   # c, t, dil, layout
        (512, 37, 1, "cf"), (512, 512 + 5, 9, "cf"), (64, 37, 3, "cf"),
        (64, 512 + 5, 9, "cf"), (256, 16, 9, "cf"), (128, 133, 9, "cf"),
        (512, 96, 3, "cl"), (64, 700, 9, "cl"), (256, 100, 1, "cl"),
        (32, 512, 1, "cf"), (16, 4096, 3, "cf"), (8, 1000, 9, "cf"),
        (4, 300, 9, "cf"), (6, 77, 3, "cf"), (6, 77, 3, "cl"),
        (100, 260, 9, "cf"), (300, 70, 3, "cf"), (7, 64, 9, "cf"),
    ]
    for c in (64, 128, 256, 512):
        cases += [(c, 100, 3, "cf"), (c, 256, 9, "offset"), (c, 20, 9, "cf"),
                  (c, 64, 9, "cf")]
    worst = 0.0
    for c, t, dil, layout in cases:
        b = 3
        p = _k6_unit(c, gen, dtype)
        if layout == "offset":   # a contiguous view one element in
            flat = torch.randn(b * c * t + 1, generator=gen, device=dev)
            x = flat.to(dtype)[1:].view(b, c, t).transpose(1, 2)
        elif layout == "cf":
            x = torch.randn(b, c, t, generator=gen, device=dev).to(dtype) \
                .transpose(1, 2)
        else:
            x = torch.randn(b, t, c, generator=gen, device=dev).to(dtype)
        valid = torch.tensor([t, 0, max(1, t // 3)], dtype=torch.int32,
                             device=dev)
        what = (f"B{b} C{c} T{t} dil{dil} "
                + {"cf": "channel-first", "cl": "channel-last",
                   "offset": "channel-first, one element in"}[layout])
        want = fused_residual_unit_reference(x, p, dil, valid)
        tol = steps16(want, n_steps, dtype)
        err = _edge(key, what,
                    lambda: fused_residual_unit(x, p, dil, valid), want, tol)
        worst = max(worst, err / tol)
    return worst


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


def int8pack_mm_on_card() -> bool:
    """Whether this build of PyTorch has a CUDA kernel for
    ``aten::_weight_int8pack_mm`` (x (M, K) bf16, int8 (N, K), scales (N,)):
    the one library call that computes K2's function."""
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        "aten::_weight_int8pack_mm", "CUDA")


def int4pack_mm_on_card() -> bool:
    """Whether this build of PyTorch has a CUDA kernel for
    ``aten::_weight_int4pack_mm`` (tinygemm: x (M, K) bf16, a weight packed
    by ``_convert_weight_to_int4pack``, bf16 scales and zeros per group):
    the one library call that computes K4's function."""
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        "aten::_weight_int4pack_mm", "CUDA")


# tinygemm's group sizes are 32 to 256: K4's groups of 512 (or 128) become
# groups of 128 with each scale repeated
INT4PACK_GROUP = 128


def _int4pack_operands(q, k: int, n: int):
    """tinygemm's operands for one K4 weight, dequantizing to K4's values:
    tinygemm computes (u - 8) · scale + zero from unsigned nibbles u, so u =
    q + 8 and every zero is 0; its weight is (N, K) with two nibbles a byte
    (even k high), packed by ``_convert_weight_to_int4pack`` (8 inner K
    tiles), its scales bf16 — K4's f32 scales rounded."""
    from tts_inference_tpu_torch.ops.int4_matmul import unpack_int4

    u = (unpack_int4(q.w_p)[:, :n] + 8).t().contiguous()      # (N, K)
    nib = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8)
    packed = torch._convert_weight_to_int4pack(nib, 8)
    rep = k // q.scale.shape[0] // INT4PACK_GROUP
    sc = q.scale.repeat_interleave(rep, dim=0).bfloat16()
    return packed, torch.stack([sc, torch.zeros_like(sc)], dim=2).contiguous()


def _int4pack_library(x, qs, k: int, n: int):
    """K4's library call over the rotating weights, held against K4's plain
    version on the scales the call takes (bf16): the call also rounds each
    dequantized weight to bf16 before its product, where K4 and the plain
    version multiply in f32, so its tolerance is two bf16 steps of the
    largest output. Returns (fn, rotating arguments, max |d|)."""
    from tts_inference_tpu_torch.ops.int4_matmul import int4_mm_reference

    def fn(x, packed, sz):
        return torch._weight_int4pack_mm(x, packed, INT4PACK_GROUP, sz)

    rotate = [(x, *_int4pack_operands(q, k, n)) for q in qs]
    got = fn(*rotate[0])
    want = int4_mm_reference(x, qs[0].w_p, qs[0].scale.bfloat16().float())
    err = (got.float() - want.float()).abs().max().item()
    tol = 2 * QMM_TOL_BF16 * want.float().abs().max().item()
    print(f"K4 library torch._weight_int4pack_mm M{x.shape[0]} K{k} N{n}: "
          f"max|d| {err:.3e} against the plain version (tol {tol:.1e})",
          flush=True)
    if not err <= tol:
        raise AssertionError(f"_weight_int4pack_mm: max|d| {err} > {tol}")
    return fn, rotate, err


def _qmm_finish(name, shape, x, kern, plain, rotate, out_f32, wbytes, k, n,
                ctx_weight=None, library=None):
    """Compare one quantized matmul with its plain version and time both
    over weights that rotate through more than the L2 holds. The library
    call is `library` = (fn, rotating arguments) where the build has it:
    ``_weight_int4pack_mm`` for K4, ``_weight_int8pack_mm`` for K2. The
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
    lib_ms = None if library is None else time_ms(library[0],
                                                  rotate=library[1])
    res = _report(name, shape, err, tol, ms, plain_ms, bnd, lib_ms, extra)
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
    library = None
    if context and dtype == torch.bfloat16 and int4pack_mm_on_card():
        library = _int4pack_library(x, qs, k, n)[:2]
    return _qmm_finish(
        "K4 int4_mm", f"M{m} K{k} N{n} G{g} {dt}", x, int4_mm,
        int4_mm_reference, [(x, q.w_p, q.scale) for q in qs], False, wbytes,
        k, n, (lambda: _qmm_weight(k, n, torch.bfloat16, gen))
        if context else None, library)


def _k2_case(m: int, k: int, n: int, gen: torch.Generator,
             context: bool = False):
    from tts_inference_tpu_torch.models.quant import quantize_linear
    from tts_inference_tpu_torch.ops.int4_matmul import w8_mm, w8_mm_reference

    x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    qs = [quantize_linear(_qmm_weight(k, n, torch.bfloat16, gen))
          for _ in range(_copies(k * n))]
    library = None
    if context and int8pack_mm_on_card():
        # the library call wants (N, K) weights and scales in x's type:
        # transposed copies, made outside the timed region
        library = (torch._weight_int8pack_mm,
                   [(x, q.w_i8.t().contiguous(), q.scale.bfloat16())
                    for q in qs])
    return _qmm_finish(
        "K2 w8_mm", f"M{m} K{k} N{n} (in, out) bf16", x, w8_mm,
        w8_mm_reference, [(x, q.w_i8, q.scale) for q in qs], False,
        k * n + 4 * n, k, n,
        (lambda: _qmm_weight(k, n, torch.bfloat16, gen)) if context else None,
        library)


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

    library = None
    if int8pack_mm_on_card():     # bf16 logits, the weights read in place
        library = (torch._weight_int8pack_mm,
                   [(x, emb.w_i8[base:], emb.scale[base:].bfloat16())])
    return _qmm_finish("K2 w8_mm", f"M{m} K{h} N{n} rows [{base}:] of "
                       f"({v}, {h}), f32 out", x, kern, plain,
                       [(x, emb.w_i8[base:], emb.scale[base:])], True,
                       n * h + 4 * n, h, n, library=library)


def _qmm_edges(gen: torch.Generator) -> dict:
    """The edges of K4's and K2's plans and tilings, correctness only, each
    case twice for bit-equal outputs: M 1 to 4096 (one tile of 16 rows,
    tiles of 64 with a ragged last one); N that is no multiple of 128, and
    none of 4 (scale rows off 16 bytes), under a padded w_p; G 128 and the
    groups small K gives; a column slice and a
    row slice of a wider int8 weight, read in place; a row stride and a
    pointer the tensor-core kernel refuses (the CUDA-core kernels); f32 x."""
    from tts_inference_tpu_torch.models.quant import (quantize_linear,
                                                      quantize_linear_i4)
    from tts_inference_tpu_torch.ops.int4_matmul import (
        int4_mm, int4_mm_reference, w8_mm, w8_mm_reference)

    dev, bf16, f32 = "cuda", torch.bfloat16, torch.float32

    def tol_of(want, dtype):
        top = want.float().abs().max().item()
        return (QMM_TOL_F32 * max(1.0, top) if dtype == f32
                else QMM_TOL_BF16 * top)

    worst = {"K4": 0.0, "K2": 0.0}
    k4_cases = [(m, 3072, 3072, 512, bf16)
                for m in (1, 3, 9, 16, 17, 64, 200, 4096)]
    k4_cases += [(8, 3072, 200, 512, bf16), (8, 3072, 202, 512, bf16),
                 (8, 8192, 1000, 128, bf16),
                 (70, 1024, 328, 128, bf16), (5, 64, 64, 512, bf16),
                 (5, 128, 32, 512, bf16), (8, 1040, 256, 512, bf16),
                 (8, 1028, 256, 512, bf16), (9, 3072, 1024, 512, f32),
                 (3, 1000, 72, 512, f32)]
    for m, k, n, group, dtype in k4_cases:
        q = quantize_linear_i4(_qmm_weight(k, n, dtype, gen), group)
        x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
        want = int4_mm_reference(x, q.w_p, q.scale)
        what = (f"M{m} K{k} N{n} Np{q.w_p.shape[1]} G{k // q.scale.shape[0]} "
                f"{'bf16' if dtype == bf16 else 'f32'}")
        worst["K4"] = max(worst["K4"], _edge(
            "K4", what, lambda: int4_mm(x, q.w_p, q.scale), want,
            tol_of(want, dtype)))
    for m in (1, 3, 9, 16, 17, 64, 200, 4096):
        q = quantize_linear(_qmm_weight(3072, 1024, bf16, gen))
        x = torch.randn(m, 3072, generator=gen, device=dev).bfloat16()
        want = w8_mm_reference(x, q.w_i8, q.scale)
        worst["K2"] = max(worst["K2"], _edge(
            "K2", f"M{m} K3072 N1024 (in, out) bf16",
            lambda: w8_mm(x, q.w_i8, q.scale), want, tol_of(want, bf16)))
    # views of a wider weight, read in place: column slices (head_logits)
    # at a 16-byte aligned and at an odd offset, row slices (tied_logits)
    wide = torch.randint(-127, 128, (1000, 1200), generator=gen, device=dev,
                         dtype=torch.int8)
    sc = torch.rand(1200, generator=gen, device=dev) * 1e-2 + 1e-3
    for what, x_k, w, s, rows, dtype in (
            ("columns [176:] of (1000, 1200)", 1000, wide[:, 176:], sc[176:],
             False, bf16),
            ("columns [7:207] of (1000, 1200)", 1000, wide[:, 7:207],
             sc[7:207].contiguous(), False, bf16),
            ("rows [7:] of (1000, 1200)", 1200, wide[7:], sc[:993], True,
             bf16),
            ("rows [7:] of (1000, 1200) f32", 1200, wide[7:], sc[:993], True,
             f32),
            ("rows [64:320], K [:1000] of (1000, 1200)", 1000,
             wide[64:320, :1000], sc[:256], True, bf16),
            ("columns [176:] of (1000, 1200) f32", 1000, wide[:, 176:],
             sc[176:], False, f32)):
        for m in (8, 33):
            x = torch.randn(m, x_k, generator=gen, device=dev).to(dtype)
            want = w8_mm_reference(x, w, s, rows=rows, out_dtype=f32)
            worst["K2"] = max(worst["K2"], _edge(
                "K2", f"M{m} {what}",
                lambda: w8_mm(x, w, s, rows=rows, out_dtype=f32), want,
                tol_of(want, f32)))
    return worst


def _qmm_one_launch_check(gen: torch.Generator) -> dict:
    """Every int4_mm / w8_mm call is exactly one kernel: torch.profiler
    counts the kernels of one call of each path (tensor cores at M 8 and
    M 512, the tied head, the CUDA cores for f32 x)."""
    from torch.profiler import ProfilerActivity, profile

    from tts_inference_tpu_torch.models.quant import (quantize_linear,
                                                      quantize_linear_i4)
    from tts_inference_tpu_torch.ops.int4_matmul import int4_mm, w8_mm

    dev, bf16 = "cuda", torch.bfloat16
    w = _qmm_weight(3072, 1024, bf16, gen)
    q4, q8 = quantize_linear_i4(w, 512), quantize_linear(w)
    rows = q8.w_i8.t().contiguous()
    calls = {}
    for m, dtype in ((8, bf16), (512, bf16), (8, torch.float32)):
        x = torch.randn(m, 3072, generator=gen, device=dev).to(dtype)
        tag = f"M{m} {'bf16' if dtype == bf16 else 'f32'}"
        calls[f"K4 {tag}"] = lambda x=x: int4_mm(x, q4.w_p, q4.scale)
        calls[f"K2 {tag}"] = lambda x=x: w8_mm(x, q8.w_i8, q8.scale)
        calls[f"K2 rows {tag}"] = lambda x=x: w8_mm(x, rows, q8.scale,
                                                     rows=True)
    counts = {}
    for what, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts[what] = sum(
            ev.count for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA)
    print("K4/K2 kernels per call (torch.profiler):", json.dumps(counts),
          flush=True)
    if any(c != 1 for c in counts.values()):
        raise AssertionError(f"a quantized matmul is not one launch: {counts}")
    return counts


def _empty_kernel_ms() -> float:
    """The time of an empty kernel under time_ms: the floor under every
    call, which the smallest linear (0.5 µs of bytes) cannot go below."""
    from tts_inference_tpu_torch.ops import _build

    lib = _build.load()

    def launch():
        _build.check(lib.tts_empty_kernel(
            torch.cuda.current_stream().cuda_stream), "empty kernel")

    ms = time_ms(launch)
    print(f"empty kernel: {ms * 1e3:.2f} us per launch (CUDA-graph replay)",
          flush=True)
    return ms


def _qmm_cases(gen: torch.Generator):
    """K4 and K2 at the serve paths' shapes: the Orpheus-3B linears (q/o,
    k/v, gate/up, down) at a decode step's M 8; a finer group; odd M;
    prefill M (8 slots × the 16- and 64-token buckets, 512, 2048); the tiny
    configuration's f32 linears (K 64 / 128, groups 32 / 64, N 64 padded to
    128 columns); the tied head. Then their edge cases."""
    bf16, f32 = torch.bfloat16, torch.float32
    _empty_kernel_ms()
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
    # added after the cases above, which so keep drawing the inputs they
    # always drew
    for m in (128, 2048):
        k4[(m, 3072, 3072)] = _k4_case(m, 3072, 3072, 512, bf16, gen,
                                       context=True)
        k2[(m, 3072, 3072)] = _k2_case(m, 3072, 3072, gen, context=True)
    for name, cases in (("K4", k4), ("K2", k2)):
        layer = [cases[(8, 3072, 3072)], cases[(8, 3072, 1024)],
                 cases[(8, 3072, 8192)], cases[(8, 8192, 3072)]]
        mult = (2, 2, 2, 1)     # q and o, k and v, gate and up, down
        lib = ("none" if any(c["library_ms"] is None for c in layer) else
               f"{sum(c['library_ms'] * f for c, f in zip(layer, mult)) * 1e3:.1f} us")
        print(f"{name} M8, the seven linears of a layer: kernel "
              f"{sum(c['ms'] * f for c, f in zip(layer, mult)) * 1e3:.1f} us"
              f" bound "
              f"{sum(c['bound_ms'] * f for c, f in zip(layer, mult)) * 1e3:.1f}"
              f" us library {lib}", flush=True)
    return k4, k2


def qmm_phase() -> None:
    """Development: K4's and K2's part of the kernel phase alone."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    _qmm_cases(gen)
    _qmm_edges(gen)
    _qmm_one_launch_check(gen)


def k6_16_phase(gen: torch.Generator, dtype=torch.bfloat16):
    """The 16-bit body in `dtype` at the serve shapes (the 12 units of an
    8-row, 16-frame vocoder call: C 512 / 256 / 128 / 64 at dilations 1, 3,
    9), timed; the same 12 units of the first chunk at batch 1 (one row of
    8 frames), timed; and its edges. Returns the serve cases, the batch-1
    cases and the worst edge error in units of the tolerance."""
    cases, first = {}, {}
    for c, t_frame in ((512, 32), (256, 256), (128, 1024), (64, 2048)):
        for dil in (1, 3, 9):
            cases[(c, dil)] = _k6_16_case(c, 16 * t_frame, dil, gen, dtype)
    for c, t_frame in ((512, 32), (256, 256), (128, 1024), (64, 2048)):
        for dil in (1, 3, 9):
            first[(c, dil)] = _k6_16_case(c, 8 * t_frame, dil, gen, dtype,
                                          b=1)
    key = K6_16[dtype][0]
    for tag, cs in (("8 rows x 16 frames", cases), ("1 row x 8 frames", first)):
        print(f"{key} 12 units, {tag}: kernel "
              f"{sum(v['ms'] for v in cs.values()) * 1e3:.1f} us, bound "
              f"{sum(v['bound_ms'] for v in cs.values()) * 1e3:.1f} us, plain "
              f"{sum(v['plain_ms'] for v in cs.values()) * 1e3:.1f} us",
              flush=True)
    return cases, first, _k6_16_edges(gen, dtype)


def kernel_phase() -> dict:
    """Each kernel against its plain version at the serve paths' shapes."""
    # the vocoder's f32 parity needs full-precision cuDNN and matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
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
    k4, k2 = _qmm_cases(gen)
    # last, so that the timed cases above draw the inputs they always drew
    # and their times compare from run to run
    k1_edge = _k1_edges(gen)
    k3a_edge = _k3a_edges(gen)
    k6_edge = _k6_edges(gen)
    qmm_edge = _qmm_edges(gen)
    _qmm_one_launch_check(gen)
    k3b_edge = _k3b_edges(gen)
    k5_edge = _k5_edges(gen)
    _attention_one_launch_check(gen)
    # after every earlier draw, so that those keep their inputs
    k6_bf16, _, k6_bf16_edge = k6_16_phase(gen, torch.bfloat16)
    k6_f16, _, k6_f16_edge = k6_16_phase(gen, torch.float16)

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
        "K1": {**k1[512], "max_abs_err": max(worst(k1), k1_edge)},
        "K3a": {**k3a[(8, 512)], "max_abs_err": max(worst(k3a), k3a_edge)},
        "K3b": {**k3b[(8, 512)], "max_abs_err": max(worst(k3b), k3b_edge)},
        "K5": {**k5[(8, 512)], "max_abs_err": max(worst(k5), k5_edge)},
        # all 12 units of one 8-row, 16-frame vocoder call
        "K6": {**summed(k6), "max_abs_err": max(worst(k6), k6_edge)},
        # the same in bf16 and float16 (their edge cases are checked in
        # their own units of tolerance, above)
        "K6-bf16": summed(k6_bf16),
        "K6-f16": summed(k6_f16),
        # the gate / up projection of a decode step, the largest linear
        "K4": {**k4[(8, 3072, 8192)],
               "max_abs_err": max(worst(k4), qmm_edge["K4"])},
        "K2": {**k2[(8, 3072, 8192)],
               "max_abs_err": max(worst(k2), qmm_edge["K2"])},
    }


N_STREAMS = 8
MAX_TOKENS = 280                     # 40 frames of 7 tokens
PCM_BYTES = (MAX_TOKENS // 7) * 2048 * 2
PCM16_TOL = 4                        # LSB, windowed vs batch decode
# LSB, windowed vs batch decode of the bf16 vocoder: twice the 4 LSB
# measured on the card at this random model's amplitude (rms ~0.0035). One
# cuDNN op (the second transposed convolution) rounds ~1.6e-4 of its bf16
# outputs one step apart at a window's length and at a batch's; in f32,
# rounded once, it agrees exactly but the call takes 47% longer (PERF.md)
PCM16_TOL_BF16 = 8


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# the prefix phase's shared opener: with ByteTokenizer the first 32 prompt
# tokens of every request are equal (a voice agent's canned greeting)
OPENER = "Thanks for calling the support line. "


def _request(i: int, opener: str = "") -> dict:
    # bench.py's request: speech forced, audio tokens only, fixed budget
    return {"text": f"{opener}Stream {i}: the quick brown fox jumps over the "
                    "dog.",
            "force_speech": True, "audio_only": True,
            "max_tokens": MAX_TOKENS, "seed": 1000 + i, "benchmark": True}


async def _drive(port: int, generate: bool, waves: int = 1,
                 opener: str = "") -> dict:
    """`waves` waves of N_STREAMS concurrent /ws/tts requests, one after the
    other, then (with `generate`) one /generate; /metrics before the first
    wave, after the last and at the end."""
    import io
    import wave

    import aiohttp

    base = f"http://127.0.0.1:{port}"
    async with aiohttp.ClientSession() as sess:

        async def metrics() -> dict:
            async with sess.get(base + "/metrics") as r:
                return await r.json()

        async def one(i: int) -> dict:
            t0 = time.perf_counter()
            arrivals = []       # host clock at each binary message
            nbytes = 0
            done = None
            async with sess.ws_connect(base + "/ws/tts") as ws:
                await ws.send_json(_request(i, opener))
                async for msg in ws:
                    if msg.type == aiohttp.WSMsgType.BINARY:
                        arrivals.append(time.perf_counter())
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
            if done is None or done["bytes"] != nbytes or not arrivals:
                raise AssertionError(f"stream {i}: done {done}, {nbytes} B")
            gaps = [(b - a) * 1e3 for a, b in zip(arrivals, arrivals[1:])]
            return {"ttfa_ms": (arrivals[0] - t0) * 1e3, "bytes": nbytes,
                    "wall_s": wall, "done": done,
                    "text": _request(i, opener)["text"],
                    "worst_gap_ms": max(gaps, default=0.0)}

        out = {"streams": [], "waves": [], "wave_s": 0.0,
               "metrics_before": await metrics()}
        for w in range(waves):
            t0 = time.perf_counter()
            streams = await asyncio.gather(*(
                one(w * N_STREAMS + i) for i in range(N_STREAMS)))
            wave_s = time.perf_counter() - t0
            out["waves"].append({"streams": streams, "wave_s": wave_s})
            out["streams"] += streams
            out["wave_s"] += wave_s
        out["metrics_waves"] = await metrics()
        if generate:
            t1 = time.perf_counter()
            async with sess.post(base + "/generate", json=_request(
                    waves * N_STREAMS, opener)) as r:
                if r.status != 200:
                    raise AssertionError(f"/generate: {r.status} "
                                         f"{await r.text()}")
                wav = await r.read()
            out["generate_s"] = time.perf_counter() - t1
            with wave.open(io.BytesIO(wav)) as w:
                out["generate_samples"] = w.getnframes()
        out["metrics"] = await metrics()
    return out


def _pct(values) -> tuple:
    """p50 and p95 of a list."""
    t = sorted(values)
    return t[len(t) // 2], t[min(len(t) - 1, int(round(0.95 * (len(t) - 1))))]


def _ttfa(streams) -> tuple:
    """TTFA p50 and p95 (ms) of a list of streams."""
    return _pct(s["ttfa_ms"] for s in streams)


def _ttfa_parts(streams) -> dict:
    """Where a stream's TTFA goes, p50 over the streams (ms): before its
    slot's admission (the WebSocket, the queue: client TTFA − server TTFA),
    the admission launch up to the first tokens on the host (server TTFT,
    from the admission), and the first chunk from there to its emission
    (server TTFA − TTFT)."""
    sm = [s["done"]["server_metrics"] for s in streams]
    return {"before_admission": _pct(
                s["ttfa_ms"] - m["server_ttfa_ms"]
                for s, m in zip(streams, sm))[0],
            "admission_to_first_tokens": _pct(
                m["server_ttft_ms"] for m in sm)[0],
            "first_tokens_to_first_chunk": _pct(
                m["server_ttfa_ms"] - m["server_ttft_ms"] for m in sm)[0]}


def _launch_counters() -> dict:
    from tts_inference_tpu_torch.ops import (decode_attention, int4_matmul,
                                             paged_attention,
                                             paged_attention_int4, vocoder)

    return {"K1": decode_attention.launches, "K3a": paged_attention.launches,
            "K3b": paged_attention.launches_int8,
            "K5": paged_attention_int4.launches, "K6": vocoder.launches,
            "K6-bf16": vocoder.launches_bf16, "K6-f16": vocoder.launches_f16,
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


UNITS_PER_CALL = 12     # residual units of one vocoder call: 4 blocks × 3


def _eager_vocoder(voc):
    """A decoder over the same (already cast) weights that launches eagerly
    (``graphs=False``)."""
    from tts_inference_tpu_torch.models.snac import SnacDecoder

    return SnacDecoder(voc.params, voc.cfg, frame_buckets=voc.frame_buckets,
                       use_noise=voc.use_noise, graphs=False,
                       graph_max_frames=voc.graph_max_frames)


def _vocoder_uses(voc) -> dict:
    return {"launches": dict(voc.launches), "replays": dict(voc.replays),
            "late_captures": voc.late_captures,
            "eager_calls": voc.eager_calls}


def _vocoder_delta(voc, before: dict) -> dict:
    import collections

    now = _vocoder_uses(voc)
    return {k: (dict(collections.Counter(now[k])
                     - collections.Counter(before[k]))
                if isinstance(now[k], dict) else now[k] - before[k])
            for k in now}


def serve_phase(name: str, argv, expect: dict, generate: bool = True,
                min_preemptions: int = 0, eager: bool = False,
                on_boot=None, waves: int = 1, opener: str = "",
                prefix_counts=None, vocoder_kernel: str = "K6",
                resume: bool = False) -> dict:
    """Build `cli serve` (runtime + scheduler) from `argv`, put the port's
    aiohttp app on a localhost port and drive it: `waves` waves of 8
    concurrent /ws/tts streams (texts starting with `opener`), then (with
    `generate`) one /generate, then /metrics. `expect` maps each kernel of
    the phase's path to its launch count as a function of (layers, decode
    steps, forward passes); every kernel it does not name must not run,
    except `vocoder_kernel` (K6, or K6-bf16 under ``--vocoder-bf16``),
    which carries every residual unit of every vocoder call: 12 launches a
    call. Every vocoder call of the run (the vocode worker's and the fused
    first chunk's) must be a graph replay, with no capture while serving;
    decodes beyond the streaming window's frame bucket run eagerly and are
    counted. With `eager` both engine cores are replaced by eager ones
    (``EngineCore(..., graphs=False)``, warmed by one eager pass) and the
    vocoder by an eager decoder: the path as it ran before CUDA graphs, for
    comparison.
    `on_boot(rt)` runs after the boot, before the requests.
    `prefix_counts` (misses, hits): what the waves must add to the
    scheduler core's prefix-cache counters on /metrics. With `resume` the
    scheduler core must have captured its resume tier at warmup
    (``capture_prefill_resume_{b}``) and, on the card, replayed a graph
    for every resume of the run (one per preemption, at least one).
    Every phase prints each stream's worst inter-chunk gap (client clock),
    p50 and max over the streams, and for the streams the scheduler
    preempted (found through the in-process scheduler) their worst gaps —
    the resume gap — and their RTF. The result's `served_tokens` maps each
    finished request's text to its prompt and generated ids."""
    from aiohttp import web

    from tts_inference_tpu_torch import cli
    from tts_inference_tpu_torch.engine.engine import EngineCore
    from tts_inference_tpu_torch.serving.app import create_app

    args = cli.build_parser().parse_args(
        list(argv) + (["--no-warmup"] if eager else []))
    t0 = time.perf_counter()
    rt, scheduler = cli.build_serving(args)
    if getattr(args, "native_protocol", False) and not scheduler.use_native:
        raise AssertionError(f"serve[{name}]: --native-protocol, but the "
                             "scheduler runs the Python extractor")
    preempted = []      # texts of the requests the scheduler preempted
    preempt = scheduler._preempt

    def _recording_preempt(slot):
        preempted.append(scheduler.slots[slot].req.text)
        preempt(slot)

    scheduler._preempt = _recording_preempt
    served = {}         # text → prompt + generated ids of a finished request
    release = scheduler._release

    def _recording_release(slot):
        st = scheduler.slots[slot]
        if st is not None:
            served[st.req.text] = list(st.prompt_ids) + list(st.token_ids)
        release(slot)

    scheduler._release = _recording_release
    if eager:
        for holder in (scheduler, rt.engine):
            c = holder.core
            holder.core = EngineCore(c.params, c.model_cfg, c.engine_cfg,
                                     batch_size=c.batch, eos_id=c.eos_id,
                                     device=c.device, graphs=False)
        rt.vocoder = rt.pipeline.vocoder = scheduler.vocoder = \
            _eager_vocoder(rt.vocoder)
        rt.engine.warmup()
        scheduler.warmup()
    if on_boot is not None:
        on_boot(rt)
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
    graphs = {tag: {"graphs_captured": len(c.graph_census_ms),
                    "capture_s": sum(c.graph_census_ms.values()) / 1e3,
                    "prepare_s": c.prepare_ms / 1e3,
                    "late_captures": c.late_captures}
              for tag, c in (("scheduler", core),
                             ("single_stream", rt.engine.core))}
    print(f"serve[{name}] graph census:", json.dumps(graphs), flush=True)
    print(f"serve[{name}] census ms (scheduler):",
          json.dumps({k: round(v, 1) for k, v in core.graph_census_ms.items()}),
          flush=True)
    voc = rt.vocoder
    vocoder_census = {"graphs_captured": len(voc.graph_census_ms),
                      "capture_s": sum(voc.graph_census_ms.values()) / 1e3,
                      "dtype": rt.config.snac.dtype,
                      "graph_max_frames": voc.graph_max_frames}
    print(f"serve[{name}] vocoder graph census:", json.dumps(vocoder_census),
          json.dumps({k: round(v, 1) for k, v in voc.graph_census_ms.items()}),
          flush=True)
    voc0 = _vocoder_uses(voc)
    late0 = [c.late_captures for c in cores]
    uses0 = [(c.launches.copy(), c.replays.copy()) for c in cores]

    async def run() -> dict:
        runner = web.AppRunner(create_app(rt, scheduler))
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        try:
            return await _drive(port, generate, waves, opener)
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
    # every decode and admission launch of the run was a graph replay, and
    # no graph was captured while serving
    uses = [{"launches": dict(c.launches - u[0]),
             "replays": dict(c.replays - u[1])}
            for c, u in zip(cores, uses0)]
    late = [c.late_captures - n for c, n in zip(cores, late0)]
    print(f"serve[{name}] launches and replays (scheduler, single stream):",
          json.dumps(uses), "late captures", late, flush=True)
    if resume:
        tier = {f"capture_prefill_resume_{b}" for b in core.resume_tier()}
        resumes = uses[0]["launches"].get("resume", 0)
        print(f"serve[{name}] resume tier {sorted(tier)}; resumes "
              f"{resumes}, replayed {uses[0]['replays'].get('resume', 0)},"
              f" preemptions {len(preempted)}", flush=True)
        if not eager and (not tier or not tier <= set(core.graph_census_ms)):
            raise AssertionError(f"serve[{name}]: resume tier {tier} not "
                                 f"all in the census")
        if resumes != len(preempted) or (
                rt.device.type == "cuda" and not eager and (
                    resumes < 1
                    or uses[0]["replays"].get("resume", 0) != resumes)):
            raise AssertionError(f"serve[{name}]: {resumes} resumes for "
                                 f"{len(preempted)} preemptions, replays "
                                 f"{uses[0]['replays']}")
    if rt.device.type == "cuda" and not eager and (
            any(late) or any(u["launches"] != u["replays"] for u in uses)
            or not uses[0]["replays"].get("decode")
            or not uses[0]["replays"].get("admission")):
        raise AssertionError(f"serve[{name}]: launches vs replays {uses}, "
                             f"late captures {late}")
    # every vocoder call a replay: the worker's window decodes and the fused
    # first chunks; whole-utterance decodes (none on this path) eager
    vuse = _vocoder_delta(voc, voc0)
    vcalls = sum(vuse["launches"].values())
    print(f"serve[{name}] vocoder calls:", json.dumps(vuse), flush=True)
    if rt.device.type == "cuda" and not eager and (
            vuse["late_captures"] or not vuse["launches"].get("decode")
            or not vuse["launches"].get("first_chunk")
            or vuse["launches"] != vuse["replays"]):
        raise AssertionError(f"serve[{name}]: vocoder calls {vuse}: every "
                             "worker call and first chunk must replay")

    layers = rt.config.model.num_hidden_layers
    short = [(i, s["bytes"], s["done"]) for i, s in enumerate(res["streams"])
             if s["bytes"] != PCM_BYTES]
    if short:
        raise AssertionError(f"streams (index, PCM bytes, done) {short}: "
                             f"expected {PCM_BYTES} bytes each")
    if generate and res["generate_samples"] != PCM_BYTES // 2:
        raise AssertionError(f"/generate: {res['generate_samples']} samples")
    on_cuda = rt.device.type == "cuda"
    want = {k: fn(layers, steps, passes) for k, fn in expect.items()}
    want[vocoder_kernel] = UNITS_PER_CALL * vcalls
    others = [k for k in launches if k not in want]
    if on_cuda and not (steps > 0 and vcalls > 0
                        and all(launches[k] == n for k, n in want.items())
                        and all(launches[k] == 0 for k in others)):
        raise AssertionError(f"serve[{name}] kernel launches {launches}: "
                             f"need {want} for {layers} layers, {steps} "
                             f"decode steps, {passes} forward passes, "
                             f"{vcalls} vocoder calls, {others} == 0")
    sched_metrics = res["metrics"]["scheduler"]
    if sched_metrics.get("preemptions", 0) < min_preemptions:
        raise AssertionError(f"serve[{name}]: /metrics {sched_metrics}, "
                             f"expected >= {min_preemptions} preemptions")
    prefix = None
    if prefix_counts is not None:
        b4 = res["metrics_before"]["scheduler"]
        aft = res["metrics_waves"]["scheduler"]
        prefix = {k: aft[k] - b4[k] for k in ("prefix_misses", "prefix_hits")}
        print(f"serve[{name}] prefix cache: the waves added {prefix} "
              f"(before {b4['prefix_misses']} misses, {b4['prefix_hits']} "
              f"hits; at the end {sched_metrics['prefix_misses']} / "
              f"{sched_metrics['prefix_hits']})", flush=True)
        if (prefix["prefix_misses"], prefix["prefix_hits"]) != \
                tuple(prefix_counts):
            raise AssertionError(f"serve[{name}]: the waves added {prefix} "
                                 f"to the prefix counters, expected "
                                 f"{prefix_counts}")
    audio_s = PCM_BYTES / 2 / 24000
    p50, p95 = _ttfa(res["streams"])
    gaps = sorted(st["worst_gap_ms"] for st in res["streams"])
    resumed = [{"text": st["text"], "worst_gap_ms": st["worst_gap_ms"],
                "rtf": audio_s / st["wall_s"]}
               for st in res["streams"] if st["text"] in preempted]
    out = {
        "ttfa_ms_p50": p50, "ttfa_ms_p95": p95,
        "worst_gap_ms_p50": gaps[len(gaps) // 2],
        "worst_gap_ms_max": gaps[-1],
        "preempted_streams": resumed,
        "resume_gap_ms": max((r["worst_gap_ms"] for r in resumed),
                             default=None),
        "ttfa_ms_per_wave": [_ttfa(w["streams"]) for w in res["waves"]],
        "ttfa_parts_ms_per_wave": [_ttfa_parts(w["streams"])
                                   for w in res["waves"]],
        "prefix_counts": prefix,
        "per_stream_rtf": [audio_s / s["wall_s"] for s in res["streams"]],
        "aggregate_rtf": len(res["streams"]) * audio_s / res["wave_s"],
        "wave_wall_s": res["wave_s"],
        "generate_wall_s": res.get("generate_s"),
        "decode_steps": steps, "forward_passes": passes,
        "launches": launches, "vocoder_calls": vuse,
        "vocoder_census": vocoder_census,
        "scheduler_metrics": sched_metrics,
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if on_cuda else None),
        "max_memory_reserved": (torch.cuda.max_memory_reserved()
                                if on_cuda else None),
        "graphs": graphs, "graph_uses": uses,
    }
    print(f"serve[{name}] TTFA ms p50 {out['ttfa_ms_p50']:.1f} p95 "
          f"{out['ttfa_ms_p95']:.1f}; per wave (p50, p95) "
          f"{[(round(a, 1), round(b, 1)) for a, b in out['ttfa_ms_per_wave']]}"
          f"; parts p50 per wave {out['ttfa_parts_ms_per_wave']}",
          flush=True)
    rtf = out["per_stream_rtf"]
    print(f"serve[{name}] RTF per stream {min(rtf):.4f}..{max(rtf):.4f} "
          f"aggregate {out['aggregate_rtf']:.3f}", flush=True)
    print(f"serve[{name}] worst inter-chunk gap per stream, ms: p50 "
          f"{out['worst_gap_ms_p50']:.1f} max {out['worst_gap_ms_max']:.1f}",
          flush=True)
    if resumed:
        print(f"serve[{name}] preempted streams ({len(preempted)} "
              f"preemptions): resume gap {out['resume_gap_ms']:.1f} ms; "
              "worst gap ms and RTF per stream",
              json.dumps([(r["text"][:9], round(r["worst_gap_ms"], 1),
                           round(r["rtf"], 4)) for r in resumed]),
              flush=True)
    peak, held = out["max_memory_allocated"], out["max_memory_reserved"]
    gb = f" = {peak / 1e9:.2f} GB, reserved {held / 1e9:.2f} GB" if peak \
        else ""
    print(f"serve[{name}] peak memory {peak} bytes{gb}", flush=True)
    print(f"serve[{name}]: {waves} x 8 x /ws/tts"
          f"{' + /generate' if generate else ''} ok:", json.dumps(out),
          flush=True)
    return {"rt": rt, "sched": scheduler, "served_tokens": served, **out}


def exactness_phase(rt, tol: int = PCM16_TOL) -> dict:
    """One request's codes decoded once in a single batch and once through
    the windowed lookahead (the streaming path), compared in PCM16 against
    `tol` LSB."""
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
    res["dtype"] = rt.config.snac.dtype
    print("exactness: windowed vs batch decode", json.dumps(res), flush=True)
    if res["max_pcm16_diff"] > tol:
        raise AssertionError(f"windowed decode off by {res['max_pcm16_diff']}"
                             f" LSB > {tol}")
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


def _top2_gap(rt, prompt, toks, i, sampling) -> float:
    """The logit gap between the best and the second-best allowed token at
    greedy step i, on the runtime's device (the CPU's in the reference
    phases)."""
    top = _allowed_logits(rt, prompt, toks, i, sampling)[0].topk(2).values
    return float(top[0] - top[1])


def _allowed_logits(rt, prompt, toks, i, sampling, kv_window=None,
                    with_cache=False, split=0):
    """The logits the sampler ranks at greedy step i: prompt + toks[:i]
    prefilled into a one-slot cache of the runtime's kind (attention window:
    those tokens, or `kv_window`), then the repetition penalty and the token
    range applied as the sampler applies them (-inf outside the range).
    `with_cache`: (logits, the one-slot cache). `split`: prefill the first
    `split` tokens alone, then the rest from position `split`."""
    from tts_inference_tpu_torch.models import llama
    from tts_inference_tpu_torch.ops import sampling as S

    core, cfg = rt.engine.core, rt.config.model
    ecfg, dev = rt.config.engine, core.device
    if ecfg.paged_kv:
        bs = ecfg.kv_block_size
        nblk = core.max_seq // bs
        cache = llama.init_paged_kv_cache(
            cfg, 1, core.max_seq, num_blocks=1 + nblk, block_size=bs,
            int8=ecfg.kv_cache_int8, int4=ecfg.kv_cache_int4, device=dev)
        cache.block_table[0] = torch.arange(1, 1 + nblk, dtype=torch.int32)
    else:
        cache = llama.init_kv_cache(cfg, 1, core.max_seq, device=dev,
                                    int8=ecfg.kv_cache_int8)
    ids = torch.tensor([list(prompt) + list(toks[:i])], dtype=torch.int32,
                       device=dev)
    n = torch.tensor([ids.shape[1]], dtype=torch.int32, device=dev)
    if split:
        first = torch.tensor([split], dtype=torch.int32, device=dev)
        llama.forward(core.params, cfg, ids[:, :split], cache,
                      torch.zeros_like(first), first, kv_window=split)
        hidden, _ = llama.forward(core.params, cfg, ids[:, split:], cache,
                                  first, n - first,
                                  kv_window=kv_window or ids.shape[1])
        logits = llama.compute_logits(core.params, cfg, hidden[:, -1],
                                      core.logits_base)
    else:
        logits, _ = llama.prefill(core.params, cfg, ids, n, cache,
                                  kv_window=kv_window,
                                  logits_base=core.logits_base)
    presence = S.mark_prompt(S.init_sampling_state(1, cfg.vocab_size,
                                                   device=dev), ids,
                             n).presence
    pen = S.apply_repetition_penalty(
        logits, presence[:, core.logits_base:],
        torch.tensor([sampling.repetition_penalty], device=dev))
    lo, hi = sampling.token_range
    col = core.logits_base + torch.arange(pen.shape[-1], device=dev)
    pen = pen.masked_fill(~((col >= lo) & (col < hi)), float("-inf"))
    return (pen, cache) if with_cache else pen


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
        gap = None if flip_gap is None else _top2_gap(cpu, prompt,
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


def _recording_scheduler(rt, config, finished: dict, vocoder=None,
                         use_native: bool = False):
    """A scheduler of `config` over the runtime's weights (and its vocoder,
    or `vocoder`) that keeps each finished request's raw token stream in
    `finished` (text → tokens)."""
    from tts_inference_tpu_torch.engine import scheduler as TS

    class Recording(TS.Scheduler):
        def _release(self, slot):
            st = self.slots[slot]
            if st is not None:
                finished[st.req.text] = list(st.token_ids)
            super()._release(slot)

    return Recording(rt.engine.core.params, config, vocoder or rt.vocoder,
                     rt.tokenizer, device=rt.device, use_native=use_native)


GRAPH_FLIP_GAP = 1e-3   # eager top-2 logit gap below which a greedy flip passes


def _graph_run(rt, graphs: bool) -> dict:
    """Eight requests through a scheduler over the runtime's weights,
    stepped by hand so that both runs admit and preempt alike: six at once
    (three greedy, three seeded), two more after eight steps, beside live
    streams. graphs=False puts an eager core (``EngineCore(...,
    graphs=False)``) and an eager vocoder under the scheduler. Returns each
    request's raw token stream and PCM and the core's launch counts."""
    from tts_inference_tpu_torch import protocol
    from tts_inference_tpu_torch.config import SamplingConfig
    from tts_inference_tpu_torch.engine import scheduler as TS
    from tts_inference_tpu_torch.engine.engine import EngineCore

    finished = {}
    sched = _recording_scheduler(
        rt, rt.config, finished,
        vocoder=None if graphs else _eager_vocoder(rt.vocoder))
    if not graphs:
        sched.core = EngineCore(rt.engine.core.params, rt.config.model,
                                rt.config.engine, device=rt.device,
                                graphs=False)
    audio = (protocol.TOKEN_AUDIO_BASE,
             protocol.TOKEN_AUDIO_BASE + protocol.AUDIO_VOCAB)
    reqs = [TS.TTSRequest(
        text=f"Graph probe {i}: the quick brown fox jumps over the dog.",
        force_speech=True,
        sampling=(SamplingConfig(greedy=True, max_tokens=MAX_TOKENS,
                                 token_range=audio) if i % 2 == 0 else
                  SamplingConfig(max_tokens=MAX_TOKENS, seed=500 + i,
                                 token_range=audio)))
        for i in range(N_STREAMS)]
    t0 = time.perf_counter()
    for r in reqs[:6]:
        sched.submit(r)
    for k in range(20000):
        if k == 8:
            for r in reqs[6:]:
                sched.submit(r)
        if not sched.step() and k > 8 and sched.n_queued == 0 \
                and not sched.n_active:
            break
    else:
        raise AssertionError("graph run did not drain")
    wall = time.perf_counter() - t0
    sched.drain_vocoder()
    sched.stop()
    pcm = {}
    for r in reqs:
        parts = []
        while True:
            kind, payload = r.events.get(timeout=60)
            if kind == "chunk":
                parts.append(payload.pcm)
            if kind == "done":
                break
            if kind == "error":
                raise AssertionError(f"{r.text}: {payload}")
        pcm[r.text] = b"".join(parts)
    core = sched.core
    return {"tokens": finished, "pcm": pcm, "reqs": reqs, "wall_s": wall,
            "preemptions": sched.preemptions,
            "launches": dict(core.launches), "replays": dict(core.replays),
            "late_captures": core.late_captures}


def graph_phase(name: str, rt) -> dict:
    """The replayed path against the eager one at full geometry, on the same
    card and weights: the same eight requests (greedy and seeded) through a
    scheduler over an eager core and over a replayed core. Every request's
    tokens must be equal; a greedy request may differ only where the eager
    model's top-2 logit gap is at most GRAPH_FLIP_GAP (the phase prints the
    step and the gap)."""
    with torch.no_grad():
        eager = _graph_run(rt, graphs=False)
        replayed = _graph_run(rt, graphs=True)
    on_cuda = rt.device.type == "cuda"
    if replayed["preemptions"] != eager["preemptions"]:
        raise AssertionError(f"graph[{name}]: preemptions eager "
                             f"{eager['preemptions']} vs replayed "
                             f"{replayed['preemptions']}")
    if on_cuda and (replayed["launches"] != replayed["replays"]
                    or eager["replays"]):
        raise AssertionError(f"graph[{name}]: replayed core launches "
                             f"{replayed['launches']} replays "
                             f"{replayed['replays']}; eager replays "
                             f"{eager['replays']}")
    flips = []
    pcm_diff = 0
    for r in eager["reqs"]:
        a, b = eager["tokens"][r.text], replayed["tokens"][r.text]
        if len(a) != MAX_TOKENS:
            raise AssertionError(f"graph[{name}] {r.text}: {len(a)} tokens")
        if a == b:
            # the same tokens: the replayed vocoder calls' PCM against the
            # eager calls'
            import numpy as np

            pa, pb = (np.frombuffer(x[r.text], np.int16).astype(np.int32)
                      for x in (eager["pcm"], replayed["pcm"]))
            if pa.shape != pb.shape or (
                    len(pa) and np.abs(pa - pb).max() > PCM16_TOL):
                raise AssertionError(
                    f"graph[{name}] {r.text}: replayed PCM {pb.shape} vs "
                    f"eager {pa.shape} beyond {PCM16_TOL} LSB")
            pcm_diff = max(pcm_diff, int(np.abs(pa - pb).max()) if len(pa)
                           else 0)
            continue
        i = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        gap = None
        if r.sampling.greedy:
            prompt = rt.pipeline.build_prompt(r.text, force_speech=True)
            gap = _top2_gap(rt, prompt, a, i, r.sampling)
        print(f"graph[{name}]: {r.text!r} first token difference at step "
              f"{i}: eager {a[i] if i < len(a) else None} replayed "
              f"{b[i] if i < len(b) else None}; eager top-2 logit gap {gap}",
              flush=True)
        if gap is None or gap > GRAPH_FLIP_GAP:
            raise AssertionError(f"graph[{name}] {r.text}: replayed tokens "
                                 f"differ from eager at step {i}")
        flips.append({"request": r.text, "step": i, "gap": gap})
    res = {"requests": len(eager["reqs"]),
           "tokens_equal": not flips, "flips": flips,
           "pcm16_max_diff_replayed_vs_eager": pcm_diff,
           "preemptions": eager["preemptions"],
           "decode_launches": replayed["launches"].get("decode", 0),
           "admission_launches": replayed["launches"].get("admission", 0),
           "late_captures": replayed["late_captures"],
           "eager_wall_s": eager["wall_s"],
           "replayed_wall_s": replayed["wall_s"]}
    print(f"graph[{name}]: replayed vs eager", json.dumps(res), flush=True)
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

    finished = {}
    cfg = dataclasses.replace(rt.config, engine=dataclasses.replace(
        rt.config.engine, paged_kv=True, kv_on_demand=True, kv_block_size=32,
        kv_pool_tokens=pool_tokens, resume_buckets=(128, 256)))
    sched = _recording_scheduler(rt, cfg, finished)
    sched.warmup()    # on the card: every launch below is a graph replay
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
    core = sched.core
    if core.use_graphs and (core.late_captures
                            or core.launches != core.replays):
        raise AssertionError(f"preempt run: launches {core.launches}, "
                             f"replays {core.replays}, late captures "
                             f"{core.late_captures}")
    return {"tokens": finished, "pcm": pcm,
            "preemptions": sched.preemptions,
            "replays": dict(core.replays)}


def native_reference_phase(device="cuda") -> dict:
    """The tiny slice's scheduler on the card twice over the same requests
    (stochastic and greedy, one admitted beside live streams), with the C++
    extractor and deinterleave and with the Python ones: every request's
    raw tokens and PCM byte-equal."""
    from tts_inference_tpu_torch import protocol
    from tts_inference_tpu_torch.config import (SamplingConfig, StreamConfig,
                                                tiny_config)
    from tts_inference_tpu_torch.engine import scheduler as TS
    from tts_inference_tpu_torch.runtime import Runtime

    rt = Runtime.create(tiny_config(), seed=0, device=device)
    audio = (protocol.TOKEN_AUDIO_BASE,
             protocol.TOKEN_AUDIO_BASE + protocol.AUDIO_VOCAB)
    scfg = StreamConfig(frames_per_chunk=2, lookahead_frames=3,
                        left_context_frames=4)
    runs = {}
    with torch.no_grad():
        for use_native in (True, False):
            finished = {}
            sched = _recording_scheduler(rt, rt.config, finished,
                                         use_native=use_native)
            reqs = [TS.TTSRequest(
                text=f"native probe {i}", stream_cfg=scfg, force_speech=True,
                sampling=SamplingConfig(max_tokens=35 + 14 * i, seed=90 + i,
                                        greedy=i == 1, token_range=audio))
                for i in range(4)]
            for r in reqs[:3]:
                sched.submit(r)
            for k in range(4000):
                if k == 4:
                    sched.submit(reqs[3])
                if not sched.step() and k > 4 and sched.n_queued == 0 \
                        and not sched.n_active:
                    break
            else:
                raise AssertionError("native reference run did not drain")
            sched.drain_vocoder()
            sched.stop()
            pcm = {}
            for r in reqs:
                parts = []
                while True:
                    kind, payload = r.events.get(timeout=60)
                    if kind == "chunk":
                        parts.append(payload.pcm)
                    elif kind == "done":
                        break
                    else:
                        raise AssertionError(f"{r.text}: {payload}")
                pcm[r.text] = b"".join(parts)
            runs[use_native] = (finished, pcm, sched.use_native)
    (tok_n, pcm_n, on_n), (tok_p, pcm_p, on_p) = runs[True], runs[False]
    if not (on_n and not on_p) or tok_n != tok_p or pcm_n != pcm_p \
            or len(tok_n) != 4 or not all(pcm_n.values()):
        raise AssertionError(f"native vs Python scheduler: tokens "
                             f"{tok_n} vs {tok_p}, PCM bytes "
                             f"{ {k: len(v) for k, v in pcm_n.items()} } vs "
                             f"{ {k: len(v) for k, v in pcm_p.items()} }")
    res = {"requests": len(tok_n), "tokens": [len(t) for t in tok_n.values()],
           "pcm_bytes": [len(p) for p in pcm_n.values()],
           "tokens_and_pcm_byte_equal": True}
    print("reference[native]: tiny scheduler on the card, native vs Python",
          json.dumps(res), flush=True)
    return res


# tools/soak.py over the paged_int8 phase's scheduler, at full geometry,
# twice. "preempt": requests of 300-900 tokens (3-8 of the pool's 16 blocks
# each), so that the pool preempts and resumes replay graphs, the 1024
# resume tier's among them, while cancels and the held queue churn. "churn":
# the JAX tool's 14-70 tokens (one block each: no preemption), whose RSS
# growth and TTFA drift gate too: two runs after the "preempt" one, in one
# call on the card, read 2.1 / 0.0 MB and -0.035 / -0.035 against the
# tool's 4096 MB and 0.5 (PERF.md, section 6). No warm-up round: the serve phase warmed the
# scheduler (every graph captured, no late capture allowed).
SOAK = {"duration_s": 30.0, "target_streams": 8, "cancel_rate": 0.1,
        "seed": 0, "warm_s": 0.0}
SOAKS = {"preempt": {**SOAK, "max_tokens_range": (300, 900)},
         "churn": SOAK}


def soak_phase(name: str, scheduler, kind: str) -> dict:
    """The port's ``tools/soak.py`` over a served phase's warmed scheduler:
    randomized churn (mixed lengths and sampling, mid-stream cancels) for
    30 s at 8 target streams, at SOAKS[kind]'s lengths. Fails on error
    events, a slot or KV block held at the end, an undrained vocode queue,
    a submission not accounted for, or a capture while it ran; "preempt"
    also unless the pool preempted and every resume replayed a graph (at
    least one), "churn" also on RSS growth or TTFA drift beyond the tool's
    thresholds. Prints both beside the thresholds, and the preemptions
    and resume replays of the run."""
    from tts_inference_tpu_torch.tools import soak

    t0 = time.perf_counter()
    scheduler.start()
    try:
        rep = soak.run_soak(scheduler, **SOAKS[kind])
    finally:
        scheduler.stop()
    rep["wall_s"] = time.perf_counter() - t0
    tag = f"soak[{name} {kind}]"
    print(f"{tag}:", json.dumps(rep), flush=True)
    print(f"{tag}: RSS growth {rep['rss_growth_mb']} MB (limit "
          f"{rep['rss_limit_mb']}), TTFA drift {rep['ttfa_drift']} (limit "
          f"{rep['drift_limit']}{'' if kind == 'churn' else ', not gated'});"
          f" {rep['preemptions']} preemptions, {rep['resumes']} resumes, "
          f"{rep['resume_replays']} replayed", flush=True)
    graphs = scheduler.core.use_graphs
    ok = rep["ok"] if kind == "churn" else (
        rep["hard_ok"] and rep["preemptions"] >= 1 and rep["resumes"] >= 1)
    if not ok or (graphs and (rep["resume_replays"] != rep["resumes"]
                              or rep["late_captures"])):
        raise AssertionError(f"{tag}: {rep}")
    return rep


def gap_phase(port_root=None) -> dict:
    """The paged_int8 serve phase alone, for timing one tree against
    another in one call (``--only gap [--port-root DIR]``): the resume gap,
    the worst inter-chunk gap and the per-stream RTF. Another tree's
    resumes are timed, not checked (one from before the resume graphs
    launches them eagerly)."""
    argv, expect, kw = SERVE_PHASES["paged_int8"]
    kw = {**kw, "resume": port_root is None}
    ph = serve_phase("paged_int8", argv, expect, **kw)
    rtf = sorted(ph["per_stream_rtf"])
    res = {"tree": port_root or "checkout",
           "resume_gap_ms": ph["resume_gap_ms"],
           "preempted_streams": ph["preempted_streams"],
           "worst_gap_ms_p50": ph["worst_gap_ms_p50"],
           "worst_gap_ms_max": ph["worst_gap_ms_max"],
           "per_stream_rtf_min": rtf[0], "per_stream_rtf_max": rtf[-1],
           "aggregate_rtf": ph["aggregate_rtf"],
           "ttfa_ms_p50": ph["ttfa_ms_p50"], "ttfa_ms_p95": ph["ttfa_ms_p95"],
           "peak_gb": ph["max_memory_allocated"] / 1e9,
           "reserved_gb": ph["max_memory_reserved"] / 1e9,
           "graph_uses": ph["graph_uses"]}
    print("gap[paged_int8]:", json.dumps(res), flush=True)
    _free(ph)
    return res


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
                             "tokens_equal": True, "max_pcm16_diff": diffs,
                             "replays": small["replays"]}
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


# the prefix reference phase. The build and the plain prefill compute the
# prefix's K/V with GEMMs of other widths (32 rows against the whole batch's
# prompts), so in bf16 they differ by rounding, which grows through the
# layers (and, in int8 / int4 rows, flips quantization levels); the plain
# path itself moves as much under a mathematical no-op.
# The model's own noise, measured on four of the prompts in the same run
# (_own_noise: logits, and the cache rows [0, 32) dequantized), sets the
# bounds: the pool entry's rows within twice the rows' noise plus one
# quantization level of the plain prefill's; a greedy flip only where the
# plain core's top-2 gap is within twice the logits' noise; and the logits'
# noise itself under PREFIX_NOISE_MAX, half a standard deviation of the
# random model's audio logits (1.1 at full width). With int4 KV the noise is
# largest: a level there is 1/7 of a row's largest magnitude (on an H100 at
# 700 W: logits 0.09 in bf16 and int8 KV, 0.25 in int4). The injection must
# copy the pool entry exactly: the slot's rows [0, plen) equal the pool
# row's bytes.
PREFIX_NOISE_MAX = 0.5
# name → (engine flags, int4 weights): the five KV layouts
PREFIX_LAYOUTS = {
    "dense": ({}, False),
    "dense_int8": ({"kv_cache_int8": True}, False),
    "paged": ({"paged_kv": True}, False),
    "paged_int8_on_demand": ({"paged_kv": True, "kv_cache_int8": True,
                              "kv_on_demand": True}, False),
    "int4": ({"paged_kv": True, "kv_cache_int4": True}, True),
}


def _prefix_rows(c, slot: int, n: int) -> list:
    """(name, tensor) of every tensor of every layer of cache `c` at the
    slot's positions [0, n), position-major; through the block table when
    paged."""
    paged = hasattr(c, "block_table")
    out = []
    for name in ("k", "v", "k_scale", "v_scale"):
        for x in getattr(c, name):
            if not paged:
                out.append((name, x[slot, :n].clone()))
                continue
            pos = torch.arange(n, device=x.device)
            rows = c.block_table[slot].long()[pos // c.block_size]
            pax = 3 if name.endswith("scale") and c.int4 else 2
            out.append((name, x.movedim(pax, 1)[rows, pos % c.block_size]))
    return out


def _pool_rows(core, idx: int, n: int) -> list:
    """Pool row idx of the prefix cache at positions [0, n), in
    _prefix_rows' order and layout."""
    int4 = core.engine_cfg.kv_cache_int4
    out = []
    for part, name in zip(core._pool, ("k", "v", "k_scale", "v_scale")):
        for x in part:
            row = x[idx]
            if int4:      # (P2, PB, D) values, (2, P2, PB) scale planes
                row = row.movedim(2, 0) if name.endswith("scale") \
                    else row.movedim(1, 0)
            out.append((name, row[:n]))
    return out


def _rows_diff(got: list, want: list, int4: bool) -> dict:
    """Injected rows against the plain prefill's, as (dequantized) values:
    max |d|, the largest magnitude and the largest quantization level
    (scale); for quantized rows also the differing bytes, the largest level
    step and the largest relative scale difference."""
    from tts_inference_tpu_torch.ops.paged_attention_int4 import (
        planes_to_scales, unpack_kv_int4)

    res = {"max_abs_diff": 0.0, "max_abs": 0.0, "max_level": 0.0,
           "bytes_differing": 0, "bytes": 0, "max_level_step": 0,
           "max_scale_rel_diff": 0.0}
    # k and v of every layer first, then (quantized) their scales in the
    # same order
    n_values = sum(not name.endswith("scale") for name, _ in got)
    for j, ((name, x), (_, y)) in enumerate(zip(got, want)):
        if name.endswith("scale"):
            rel = ((x - y).abs() / y.abs().clamp(min=1e-30)).max()
            res["max_scale_rel_diff"] = max(res["max_scale_rel_diff"],
                                            float(rel))
            continue
        if x.dtype == torch.int8:
            res["bytes_differing"] += int((x != y).sum())
            res["bytes"] += x.numel()
            a, b = ((unpack_kv_int4(x), unpack_kv_int4(y)) if int4
                    else (x.int(), y.int()))
            res["max_level_step"] = max(res["max_level_step"],
                                        int((a - b).abs().max()))
            sa, sb = got[n_values + j][1], want[n_values + j][1]
            if int4:        # nibble planes (…, 2, P2) → (…, Hkv)
                sa, sb = planes_to_scales(sa), planes_to_scales(sb)
            x, y = a.float() * sa[..., None], b.float() * sb[..., None]
            res["max_level"] = max(res["max_level"], float(sb.max()))
        res["max_abs_diff"] = max(res["max_abs_diff"], float(
            (x.float() - y.float()).abs().max()))
        res["max_abs"] = max(res["max_abs"], float(y.float().abs().max()))
    return res


def _own_noise(shim, prompts, sampling, pb: int, int4: bool) -> tuple:
    """The plain model's own noise, over one-slot prefills of each prompt,
    under two mathematical no-ops: the attention window widened from the
    prompt to max_seq, and the prompt prefilled in two parts (its first pb
    tokens, then the rest from position pb). Returns the largest change of
    the allowed logits under either, and of the (dequantized) cache rows
    [0, pb) under the second."""
    logits = rows = 0.0
    for p in prompts:
        a, ca = _allowed_logits(shim, p, [], 0, sampling, with_cache=True)
        b = _allowed_logits(shim, p, [], 0, sampling,
                            kv_window=shim.engine.core.max_seq)
        c, cp = _allowed_logits(shim, p, [], 0, sampling, with_cache=True,
                                split=pb)
        ok = torch.isfinite(a)
        logits = max(logits, float((a - b)[ok].abs().max()),
                     float((a - c)[ok].abs().max()))
        rows = max(rows, _rows_diff(_prefix_rows(cp, 0, pb),
                                    _prefix_rows(ca, 0, pb),
                                    int4)["max_abs_diff"])
    return logits, rows


def _prefix_waves(core, waves, n_adm: int, launches: int, sampling, pb: int):
    """Each wave's prompts admitted into slots 0.. in one fused admission of
    n_adm steps (a paged cache reserves what the wave decodes), then
    `launches` decode launches of 7; returns per wave the tokens of every
    slot and its cache rows [0, pb) after the admission. With the prefix
    cache, each slot's rows [0, plen) must be its pool row's bytes."""
    import numpy as np

    from tts_inference_tpu_torch.ops import sampling as S
    from tts_inference_tpu_torch.utils import to_numpy

    sp = S.SamplingParams.from_config(sampling, core.batch,
                                      device=core.device)
    out = []
    for prompts in waves:
        slots = list(range(len(prompts)))
        t0, tok, act = core.prefill_decode_launch(
            prompts, slots, sp, np.zeros(core.batch, np.int32),
            np.zeros(core.batch, bool), n=n_adm,
            reserve_extra=[n_adm + 7 * launches] * len(prompts))
        rows = [_prefix_rows(core.cache, sl, pb) for sl in slots]
        if core.engine_cfg.prefix_cache:
            for p, got in zip(prompts, rows):
                cut = core.prefix_cut(len(p))
                pool = _pool_rows(core, core._prefix_map[tuple(p[:cut])],
                                  cut)
                if not all(torch.equal(g[:cut], w) for (_, g), (_, w)
                           in zip(got, pool)):
                    raise AssertionError("the injected rows are not the "
                                         "pool entry's bytes")
        chunks = [t0]
        for _ in range(launches):
            t, tok, act = core.decode_steps_launch(sp, tok, act, 7)
            chunks.append(t)
        toks = to_numpy(torch.cat(chunks, dim=1))
        out.append(([toks[sl].tolist() for sl in slots], rows))
        core.reset_and_seed(list(range(core.batch)))
    return out


def _boundary_run(core, neighbour, newcomer, sampling) -> dict:
    """A live neighbour in slot 7 decoded until its next write position is
    126 — with blocks of 128 its blocks then cover 128 positions — then a
    fused admission of 13 steps into slot 0 (the neighbour writes 126..138
    inside it) and two decode launches. Returns both slots' tokens, the
    neighbour's write position before the admission and its blocks after
    it."""
    import numpy as np

    from tts_inference_tpu_torch.ops import sampling as S
    from tts_inference_tpu_torch.utils import to_numpy

    sp = S.SamplingParams.from_config(sampling, core.batch,
                                      device=core.device)
    t0, tok, act = core.prefill_decode_launch(
        [neighbour], [7], sp, np.zeros(core.batch, np.int32),
        np.zeros(core.batch, bool), n=13)
    late = [t0[7]]
    for _ in range(10):
        t, tok, act = core.decode_steps_launch(sp, tok, act, 7)
        late.append(t[7])
    pos = int(core.cache.lengths[7])
    t, tok, act = core.prefill_decode_launch([newcomer], [0], sp, tok, act,
                                             n=13)
    blocks = len(core._slot_blocks[7])
    late.append(t[7, 1:])
    new = [t[0]]
    for _ in range(2):
        t, tok, act = core.decode_steps_launch(sp, tok, act, 7)
        late.append(t[7])
        new.append(t[0])
    res = {"neighbour": to_numpy(torch.cat(late)).tolist(),
           "newcomer": to_numpy(torch.cat(new)).tolist(),
           "write_pos": pos, "neighbour_blocks": blocks}
    core.reset_and_seed(list(range(core.batch)))
    return res


def _first_flip(name: str, shim, prompt, got, want, sampling, bound):
    """None when the token lists are equal; else the first differing step
    and the plain core's top-2 logit gap there, which must be at most
    `bound`."""
    if got == want:
        return None
    i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    gap = _top2_gap(shim, prompt, want, i, sampling)
    print(f"reference[prefix {name}]: first token difference at step {i}: "
          f"prefix core {got[i] if i < len(got) else None} plain "
          f"{want[i] if i < len(want) else None}; plain top-2 logit gap "
          f"{gap} (bound {bound})", flush=True)
    if not gap <= bound:
        raise AssertionError(f"prefix {name}: tokens differ from the plain "
                             f"core's at step {i} (gap {gap} > {bound})")
    return {"step": i, "gap": gap}


def prefix_reference_phase(rt) -> dict:
    """The prefix cache against the plain path on the card, at full width,
    over the runtime's weights (int4 weights quantized from them for the
    int4 layout), eager cores: for each of the five KV layouts a prefix core
    and a plain core run 8 greedy requests sharing a 32-token header — a
    miss wave (the first request builds, the other seven hit in the same
    admission) and a hit wave of other suffixes — 56 tokens each. After
    each admission every slot's rows [0, plen) are its pool entry's bytes,
    and the rows [0, 32) are the plain core's within the bounds above the
    PREFIX_NOISE_MAX line (the model's own noise, measured here); so are the
    tokens (a flip only at a plain top-2 logit gap within twice the
    logits' noise). Under --kv-on-demand a
    request is admitted while a live neighbour stands at write position
    126 of a 128-token block: the neighbour's and the newcomer's tokens
    equal the plain core's (the admission grows the live slot's blocks)."""
    import types

    from tts_inference_tpu_torch.engine.engine import EngineCore
    from tts_inference_tpu_torch.models.quant import quantize_llama_params

    t_start = time.perf_counter()
    counters = _launch_counters()
    for c in counters.values():
        c.reset()
    mcfg, base = rt.config.model, rt.config.engine
    sampling = _tiny_sampling()
    pb = base.prefix_len
    waves = [[rt.pipeline.build_prompt(f"{OPENER}{kind} {i}: the quick "
                                       "brown fox jumps over the dog.",
                                       force_speech=True)
              for i in range(N_STREAMS)] for kind in ("Request", "Answer")]
    if len({tuple(p[:pb]) for w in waves for p in w}) != 1:
        raise AssertionError("the prefix phase's prompts share no "
                             f"{pb}-token header")
    long = rt.pipeline.build_prompt(OPENER + "Neighbour stream, a longer "
                                    "text for the boundary check.",
                                    force_speech=True)
    neighbour = long[:39] + long[-4:]        # 43 tokens
    newcomer = waves[1][0]
    res = {}
    with torch.no_grad():
        for name, (over, w4) in PREFIX_LAYOUTS.items():
            t0 = time.perf_counter()
            params = rt.engine.core.params
            if w4:
                params = quantize_llama_params(params, bits=4)
            plain_cfg = dataclasses.replace(base, prefix_cache=False, **over)
            runs = {}
            for tag in ("prefix", "plain"):
                cfg = dataclasses.replace(plain_cfg,
                                          prefix_cache=tag == "prefix")
                core = EngineCore(params, mcfg, cfg, device=rt.device,
                                  graphs=False)
                run = {"waves": _prefix_waves(core, waves, 13, 6, sampling,
                                              pb)}
                if cfg.kv_on_demand:
                    run["boundary"] = _boundary_run(core, neighbour, newcomer,
                                                    sampling)
                run["counts"] = (core.prefix_misses, core.prefix_hits)
                runs[tag] = run
            # `core` is the plain one: the gaps of a flip are its
            shim = types.SimpleNamespace(
                engine=types.SimpleNamespace(core=core),
                config=types.SimpleNamespace(model=mcfg, engine=plain_cfg))
            int4 = plain_cfg.kv_cache_int4
            noise, kv_noise = _own_noise(shim, waves[0][:4], sampling, pb,
                                         int4)
            if not noise <= PREFIX_NOISE_MAX:
                raise AssertionError(f"prefix {name}: the plain prefill's "
                                     f"logits move by {noise} under a no-op "
                                     f"(> {PREFIX_NOISE_MAX})")
            bound = 2 * noise
            flips = []
            for wave, (got, _), (want, _) in zip(
                    waves, runs["prefix"]["waves"], runs["plain"]["waves"]):
                for i, prompt in enumerate(wave):
                    f = _first_flip(name, shim, prompt, got[i], want[i],
                                    sampling, bound)
                    if f is not None:
                        flips.append(f)
            row = {"prefix_counts": runs["prefix"]["counts"],
                   "logit_noise": noise, "kv_noise": kv_noise}
            if plain_cfg.kv_on_demand:
                bg, bw = runs["prefix"]["boundary"], runs["plain"]["boundary"]
                for who, prompt in (("neighbour", neighbour),
                                    ("newcomer", newcomer)):
                    f = _first_flip(f"{name} boundary {who}", shim, prompt,
                                    bg[who], bw[who], sampling, bound)
                    if f is not None:
                        flips.append(f)
                row["boundary"] = {k: bg[k] for k in ("write_pos",
                                                      "neighbour_blocks")}
                if bg["write_pos"] != 126 or bg["neighbour_blocks"] \
                        * plain_cfg.kv_block_size < 126 + 13:
                    raise AssertionError(f"prefix {name} boundary: "
                                         f"{row['boundary']}")
            del core, shim
            diff = None
            for (_, rg), (_, rw) in zip(runs["prefix"]["waves"],
                                        runs["plain"]["waves"]):
                for g, w in zip(rg, rw):
                    d = _rows_diff(g, w, int4)
                    diff = d if diff is None else {
                        k: (diff[k] + v if k.startswith("bytes")
                            else max(diff[k], v)) for k, v in d.items()}
            row.update(kv=diff, flips=flips,
                       seconds=time.perf_counter() - t0)
            print(f"reference[prefix {name}]:", json.dumps(row), flush=True)
            # one miss (the first request), then hits: the rest of the miss
            # wave, the hit wave, and the boundary check's two requests
            want_counts = (1, 2 * N_STREAMS - 1
                           + (2 if plain_cfg.kv_on_demand else 0))
            if runs["prefix"]["counts"] != want_counts:
                raise AssertionError(f"prefix {name}: (misses, hits) "
                                     f"{runs['prefix']['counts']}, expected "
                                     f"{want_counts}")
            if not diff["max_abs_diff"] <= 2 * kv_noise + diff["max_level"]:
                raise AssertionError(f"prefix {name}: injected rows vs the "
                                     f"plain prefill's {diff}")
            res[name] = row
            del params, runs
            gc.collect()
            torch.cuda.empty_cache()
    launches = {k: c.count for k, c in counters.items()}
    print(f"reference[prefix]: {time.perf_counter() - t_start:.1f} s, kernel "
          "launches", json.dumps(launches), flush=True)
    res["launches"] = launches
    return res


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0 if tree is None else tree.numel() * tree.element_size()


def _assert_trees_equal(got, want, path: str) -> int:
    """Every leaf torch.equal (same dtype, shape, bytes); returns the
    number of leaves."""
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            raise AssertionError(f"{path}: keys {sorted(got)} vs "
                                 f"{sorted(want)}")
        return sum(_assert_trees_equal(got[k], want[k], f"{path}.{k}")
                   for k in want)
    if isinstance(want, (list, tuple)):
        if type(got) is not type(want) or len(got) != len(want):
            raise AssertionError(f"{path}: {type(got)} vs {type(want)}")
        return sum(_assert_trees_equal(g, w, f"{path}[{i}]")
                   for i, (g, w) in enumerate(zip(got, want)))
    if want is None:
        if got is not None:
            raise AssertionError(f"{path}: expected None")
        return 0
    if got.dtype != want.dtype or got.shape != want.shape \
            or not torch.equal(got, want):
        raise AssertionError(f"{path}: {got.dtype}{tuple(got.shape)} differs "
                             f"from {want.dtype}{tuple(want.shape)}")
    return 1


def checkpoint_phase(extra=(), keep: bool = False) -> dict:
    """Boot from checkpoint directories at full width: the dense phase's
    seeded weights (``cli serve``: LM seed 0, vocoder seed 1) written by
    ``tools/make_checkpoint.py`` as an Orpheus-3B HF dir (bf16, 2 GiB
    shards, index, config.json, a byte-level BPE tokenizer.json) and a SNAC
    dir, under ``build/`` of this checkout; ``cli serve --model-path D
    --snac-path S`` boots from them (every LM and SNAC leaf torch.equal to
    the seeded ones, the port's HFTokenizer in use) and serves the 8
    streams and one /generate (K1 every decode step, K6, every launch a
    replay); then ``cli quantize --model-path D --quantize --out Q`` and a
    boot from Q with no quantization at boot (``--quantize`` given and
    ignored), int8 leaves byte-equal to ``quantize_llama_params`` of the
    loaded tree, one request carried by K2. The directory is removed in
    any case, but with `keep` the phase ends with the HF and SNAC dirs in
    place for the train phase (``res["dirs"]``; the train phase removes
    them). `extra`: more ``cli serve`` flags for every boot (the CPU
    rehearsal: ``--tiny --device cpu --max-output-len 512``)."""
    import contextlib
    import io
    import os
    import shutil

    import numpy as np

    from tts_inference_tpu_torch import cli, protocol, weights
    from tts_inference_tpu_torch import runtime as R
    from tts_inference_tpu_torch.config import SamplingConfig
    from tts_inference_tpu_torch.models.quant import quantize_llama_params
    from tts_inference_tpu_torch.tools.make_checkpoint import (
        write_llama_checkpoint, write_snac_checkpoint, write_tokenizer)
    from tts_inference_tpu_torch.utils.tokenizer import (ByteTokenizer,
                                                         HFTokenizer)

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "checkpoint_phase")
    model_dir, snac_dir, q_dir = (os.path.join(root, n)
                                  for n in ("model", "snac", "quantized"))
    extra = list(extra)
    args = cli.build_parser().parse_args(["serve", *extra])
    cfg = cli._config(args)
    device = args.device or "cuda"
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    res = {}
    try:
        llama = weights.init_llama_params(cfg.model, args.seed, device)
        snac = weights.init_snac_params(cfg.snac, args.seed + 1, device)
        nbytes = _tree_bytes(llama)
        free = shutil.disk_usage(root).free
        # the bf16 dir and the int8 one (about half), with room to spare
        if free < 2 * nbytes:
            raise AssertionError(f"checkpoint: {free} bytes free under "
                                 f"{root}, need {2 * nbytes}")
        t0 = time.perf_counter()
        info = write_llama_checkpoint(llama, cfg.model, model_dir)
        write_tokenizer(model_dir)
        sinfo = write_snac_checkpoint(snac, cfg.snac, snac_dir)
        res["write_s"] = time.perf_counter() - t0
        res.update(bytes=info["bytes"], shards=info["shards"],
                   snac_bytes=sinfo["bytes"], disk_free_before=free)
        print("checkpoint: wrote", json.dumps(res), flush=True)

        def on_boot(rt):
            t = rt.load_timings
            n_llama = _assert_trees_equal(rt.engine.core.params, llama,
                                          "llama")
            n_snac = _assert_trees_equal(rt.vocoder.params, snac, "snac")
            if not isinstance(rt.tokenizer, HFTokenizer):
                raise AssertionError(f"tokenizer {type(rt.tokenizer)}")
            text = _request(0)["text"]
            boot = {k: t[k] for k in ("load_model_s", "load_snac_s",
                                      "load_tokenizer_s")}
            boot["read_gb_per_s"] = info["bytes"] / t["load_model_s"] / 1e9
            boot["leaves_equal"] = {"llama": n_llama, "snac": n_snac}
            boot["prompt_ids"] = {
                "bpe": len(rt.pipeline.build_prompt(text, force_speech=True)),
                "bytes": len(protocol.format_prompt_ids(
                    ByteTokenizer().encode(protocol.format_prompt_text(
                        text, "tara")), force_speech=True))}
            res["boot"] = boot
            print("checkpoint: booted", json.dumps(boot), flush=True)

        ph = serve_phase("checkpoint", ["serve", "--model-path", model_dir,
                                        "--snac-path", snac_dir, *extra],
                         {"K1": PER_STEP}, on_boot=on_boot)
        res["serve"] = {k: ph[k] for k in (
            "ttfa_ms_p50", "ttfa_ms_p95", "aggregate_rtf", "launches",
            "decode_steps")}
        _free(ph)

        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["quantize", "--model-path", model_dir,
                           "--quantize", "--out", q_dir, *extra])
        if rc != 0:
            raise AssertionError(f"cli quantize: {rc}")
        res["quantize"] = json.loads(buf.getvalue().strip().splitlines()[-1])
        res["quantize"]["command_s"] = time.perf_counter() - t0
        print("checkpoint: cli quantize", json.dumps(res["quantize"]),
              flush=True)

        def no_quantization(*a, **k):
            raise AssertionError("quantized at boot")

        args = cli.build_parser().parse_args(
            ["generate", "--model-path", q_dir, "--snac-path", snac_dir,
             "--tokenizer-path", model_dir, "--quantize", "--no-warmup",
             "--text", _request(0)["text"], *extra])
        saved = R.quantize_llama_params
        R.quantize_llama_params = no_quantization
        try:
            rt = cli._build_runtime(args)
        finally:
            R.quantize_llama_params = saved
        want = quantize_llama_params(llama, bits=8)
        n_q = _assert_trees_equal(rt.engine.core.params, want, "quantized")
        del want
        counters = _launch_counters()
        for c in counters.values():
            c.reset()
        pcm, metrics = rt.pipeline.synthesize(
            _request(0)["text"], "tara", SamplingConfig(
                max_tokens=70, seed=3, token_range=(
                    protocol.TOKEN_AUDIO_BASE,
                    protocol.TOKEN_AUDIO_BASE + protocol.AUDIO_VOCAB)),
            force_speech=True)
        launches = {k: c.count for k, c in counters.items()}
        if (device != "cpu" and launches["K2"] < 1) \
                or len(pcm) != 10 * 2048 * 2 or not np.frombuffer(
                    pcm, np.int16).any():
            raise AssertionError(f"checkpoint[quantized]: launches "
                                 f"{launches}, {len(pcm)} samples")
        res["quantized_boot"] = {
            "load_model_s": rt.load_timings["load_model_s"],
            "load_model_s_quantizing_at_boot":
                res["quantize"]["load_model_s"],
            "leaves_equal": n_q, "launches": launches,
            "tokens": metrics.tokens}
        print("checkpoint: boot from cli quantize's output",
              json.dumps(res["quantized_boot"]), flush=True)
        del rt
        if keep:
            shutil.rmtree(q_dir)
            res["dirs"] = (model_dir, snac_dir)
    finally:
        if "dirs" not in res:
            shutil.rmtree(root, ignore_errors=True)
    return res


# the fine-tune phase: ``train_step.CARD_*`` (LoRA r 16, alpha 32 on the 7
# targets, two sequences of up to 512 tokens a step) over 16 records of
# text + 60 frames (420 audio tokens, the length bench.py asks for)
TRAIN_RECORDS, TRAIN_FRAMES = 16, 60
TRAIN_STEPS, SAVE_EVERY, FULL_STEPS = 20, 10, 2
# the tiny train check, card against CPU: the loss of every step (relative)
# and the final A and B (the norm of the difference over the CPU's norm).
# f32 with TF32 off: the sums run in another order; the JAX package against
# the port on the CPU differs by 1.6e-7 in the loss, 7.7e-6 in B. bf16: a
# rounding of every product's inputs and of each layer's output
TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _tree_to(tree, device):
    """A copy of a tensor tree on `device` (fresh leaves, also on the same
    device)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return None if tree is None else tree.detach().to(device, copy=True)


def train_reference_phase(device="cuda") -> dict:
    """Three LoRA steps of ``tiny_config()``'s model (r 4 on the 7 targets,
    lr 2e-4, the train step of ``training/train_step.py``) on the card and
    on the CPU from the same base, adapters and batches, in f32 and in
    bf16: every step's loss and the final A and B within TRAIN_TOL. In
    bf16 the tied head's f32 product on the card is ``torch.mm(...,
    out_dtype=float32)``, which gets its derivative from
    ``models/quant._MmF32``; the f32 check needs TF32 off (``models/snac``
    turns it off when imported; the phase checks)."""
    import numpy as np

    from tts_inference_tpu_torch import weights
    from tts_inference_tpu_torch.config import tiny_config
    from tts_inference_tpu_torch.training import data as D
    from tts_inference_tpu_torch.training import lora as L
    from tts_inference_tpu_torch.training import train_step as T
    from tts_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    tf32 = torch.backends.cuda.matmul.allow_tf32
    print(f"reference[train]: torch.backends.cuda.matmul.allow_tf32 = {tf32}",
          flush=True)
    if tf32:
        raise AssertionError("reference[train]: TF32 is on; the f32 check "
                             "needs full-precision matmuls")
    if device != "cpu":   # why the tied head's product needs _MmF32 here
        a = torch.ones(4, 8, device=device, dtype=torch.bfloat16,
                       requires_grad=True)
        try:
            torch.mm(a, a.detach().t(), out_dtype=torch.float32).sum(
                ).backward()
            print("reference[train]: torch.mm(out_dtype=float32) has a "
                  "derivative in this build", flush=True)
        except RuntimeError as e:
            print("reference[train]: torch.mm(out_dtype=float32) has no "
                  f"derivative in this build: {str(e).splitlines()[0]}",
                  flush=True)
    recs = D.synthetic_records(np.random.default_rng(0), n=6, frames=4)
    batches = list(D.batches(ByteTokenizer(), recs, 2, 64))[:3]
    res = {}
    for dtype, tol in TRAIN_TOL.items():
        cfg = dataclasses.replace(tiny_config().model, dtype=dtype)
        base = weights.init_llama_params(cfg, 0, "cpu")
        ad = L.init_lora(torch.Generator().manual_seed(1), cfg, base, r=4)
        runs = {}
        for dev in ("cpu", device):
            opt = T.make_optimizer(2e-4, len(batches))
            step = T.make_train_step(cfg, opt, base_params=_tree_to(base, dev),
                                     lora_scale=L.lora_scale(4, 32.0))
            st = T.init_train_state(_tree_to(ad, dev), opt)
            losses = [float(step(st, t, n)[1]) for t, n in batches]
            runs[dev] = (losses, T.tree_leaves(_tree_to(st.params, "cpu")))
        (l_cpu, p_cpu), (l_dev, p_dev) = runs["cpu"], runs[device]
        row = {"loss_cpu": l_cpu, "loss_card": l_dev,
               "loss_rel": max(abs(a - b) / abs(a)
                               for a, b in zip(l_cpu, l_dev))}
        for i, key in ((0, "A"), (1, "B")):   # leaves alternate A, B
            num = sum(float((d.float() - c.float()).pow(2).sum())
                      for d, c in zip(p_dev[i::2], p_cpu[i::2]))
            den = sum(float(c.float().pow(2).sum()) for c in p_cpu[i::2])
            row[f"{key}_rel"] = (num / den) ** 0.5
        print(f"reference[train] {dtype}: {json.dumps(row)} (tol {tol})",
              flush=True)
        if not all(row[k] <= tol for k in ("loss_rel", "A_rel", "B_rel")) \
                or not l_cpu[-1] < l_cpu[0]:
            raise AssertionError(f"reference[train] {dtype}: {row}")
        res[dtype] = row
    return res


def _train_flops(cfg, b: int, s: int, lora_r: int) -> dict:
    """Operations of one training step at (B, S) by the type they run in,
    counting what autograd computes. bf16: every layer's linears at S
    positions and a backward of twice that (input and weight gradients:
    LoRA differentiates the merged weights too), and the tied head's
    forward (bf16 inputs, f32 sums). f32 (TF32 off): the attention einsums
    over the whole S x S square (the causal mask comes after them) and
    twice that backward; the head's backward through ``_MmF32``, the input
    gradient always, the weight gradient only when the embedding trains
    (full fine-tune, `lora_r` 0); with LoRA the merges' A @ B and their
    two gradient products."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    q = cfg.num_attention_heads * cfg.head_dim
    kv = cfg.num_key_value_heads * cfg.head_dim
    weights = cfg.num_hidden_layers * (2 * h * q + 2 * h * kv + 3 * h * f)
    head = 2 * b * (s - 1) * h * cfg.vocab_size    # logits of S - 1 positions
    attn = 4 * b * s * s * q * cfg.num_hidden_layers
    f32 = 3.0 * attn + (head + 3.0 * 2 * lora_r * weights if lora_r
                        else 2.0 * head)
    return {"bf16": 3.0 * 2 * b * s * weights + head, "f32": f32}


def _train_rates(flops: dict, step_ms: float) -> dict:
    """TFLOP/s of a step of `step_ms`, and the operations' bound: each
    type's count at its peak rate (PEAK_FLOPS: 989 bf16, 67 f32)."""
    ops_ms = bound(0, flops)["bound_ms"]
    return {"tflop": {k: n / 1e12 for k, n in flops.items()},
            "tflops_per_s": sum(flops.values()) / step_ms * 1e3 / 1e12,
            "ops_bound_ms": ops_ms, "share_of_ops_bound": ops_ms / step_ms}


def _finetune(argv) -> dict:
    """One ``finetune`` command in this process: its JSON summary, wall
    seconds and peak device memory; its log lines are printed."""
    import contextlib
    import io

    from tts_inference_tpu_torch.training import finetune

    gc.collect()
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = finetune.main(argv)
    wall = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    for line in lines[:-1]:
        print(f"finetune {argv[0]}: {line}", flush=True)
    if rc != 0:
        raise AssertionError(f"finetune {argv}: {rc}")
    out = json.loads(lines[-1])
    out["wall_s"] = wall
    if cuda:
        out["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["peak_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    return out


def train_phase(dirs=None, extra=()) -> dict:
    """The fine-tune loop at full width, closed by serving its output:
    the tiny card check against the CPU (``train_reference_phase``); then
    ``finetune train --model-path D`` on the bf16 Orpheus-3B HF dir `dirs`
    (the checkpoint phase's, or written here by ``tools/make_checkpoint``)
    over a JSONL of TRAIN_RECORDS records (text + TRAIN_FRAMES frames),
    TRAIN_STEPS LoRA steps of ``train_step.CARD_*``'s shape with a step
    checkpoint every SAVE_EVERY: the mean loss of the last 5 steps below
    that of the first 5, step ms (median), tokens/s, TFLOP/s and the
    operations' bound (``_train_flops``, by type), peak memory, and the
    last two step dirs kept; FULL_STEPS steps of ``--full-finetune`` (step
    ms, TFLOP/s, peak memory); ``finetune merge`` (seconds, write GB/s);
    and ``cli serve --model-path merged --snac-path S``, 8 /ws/tts streams
    as in the serve phases (K1, K6, every launch a replay), where the
    booted leaves equal an in-memory ``merge_params`` on the card, greedy
    tokens of the served runtime equal those of an engine over that merge,
    the served runtime's streamed PCM of them passes
    ``tools/audio_fidelity`` against those tokens decoded whole, a greedy
    stream of
    the served runtime with frame-aligned decoding (``frame_protocol``)
    has no invalid frame by ``tools/analyze_tokens``, and every served
    stream holds its 40 frames.
    Every directory is removed in any case. `extra`: more ``cli serve``
    flags (the CPU rehearsal: ``--tiny --device cpu --max-output-len
    512``)."""
    import os
    import shutil
    import statistics

    import numpy as np

    from tts_inference_tpu_torch import cli, protocol, weights
    from tts_inference_tpu_torch.config import SamplingConfig
    from tts_inference_tpu_torch.engine.engine import GenerationEngine
    from tts_inference_tpu_torch.models.snac import to_pcm16
    from tts_inference_tpu_torch.runtime import load_model
    from tts_inference_tpu_torch.tools import analyze_tokens, audio_fidelity
    from tts_inference_tpu_torch.tools.make_checkpoint import (
        write_llama_checkpoint, write_snac_checkpoint, write_tokenizer)
    from tts_inference_tpu_torch.training import data as D
    from tts_inference_tpu_torch.training import lora as L
    from tts_inference_tpu_torch.training import train_step as T
    from tts_inference_tpu_torch.training.checkpoint import restore_params

    extra = list(extra)
    args = cli.build_parser().parse_args(["serve", *extra])
    cfg = cli._config(args)
    device = args.device or "cuda"
    t_start = time.perf_counter()
    res = {"reference": train_reference_phase(device)}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "train_phase")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        if dirs is None:
            model_dir, snac_dir = (os.path.join(root, n)
                                   for n in ("model", "snac"))
            write_llama_checkpoint(weights.init_llama_params(
                cfg.model, args.seed, device), cfg.model, model_dir)
            write_tokenizer(model_dir)
            write_snac_checkpoint(weights.init_snac_params(
                cfg.snac, args.seed + 1, device), cfg.snac, snac_dir)
        else:
            model_dir, snac_dir = dirs
        data = os.path.join(root, "records.jsonl")
        recs = D.synthetic_records(np.random.default_rng(0), TRAIN_RECORDS,
                                   TRAIN_FRAMES)
        with open(data, "w") as f:
            f.write("\n".join(json.dumps(r) for r in recs) + "\n")
        ft = (["--tiny"] if args.tiny else []) + [
            "--device", device, "--model-path", model_dir]
        b, s, r = T.CARD_BATCH, T.CARD_LEN, T.CARD_LORA_R
        shape = ["--max-len", str(s), "--batch-size", str(b), "--lora-r",
                 str(r), "--lora-alpha", str(T.CARD_LORA_ALPHA)]
        lora_dir, full_dir, merged_dir = (os.path.join(root, n)
                                          for n in ("lora", "full", "merged"))

        # LoRA
        lo = _finetune(["train", *ft, "--dataset", data, *shape,
                        "--steps", str(TRAIN_STEPS), "--save-every",
                        str(SAVE_EVERY), "--log-every", "5", "--out-dir",
                        lora_dir])
        first5, last5 = (statistics.fmean(lo["losses"][:5]),
                         statistics.fmean(lo["losses"][-5:]))
        med = statistics.median(lo["step_ms"])
        kept = sorted(os.listdir(os.path.join(lora_dir, "ckpts")), key=int)
        res["lora"] = {
            "first5_mean_loss": first5, "last5_mean_loss": last5,
            "step_ms_median": med, "step_ms_first": lo["step_ms"][0],
            "tokens_per_s": b * s / med * 1e3,
            "real_tokens_per_s": lo["tokens"] / sum(lo["step_ms"]) * 1e3,
            **_train_rates(_train_flops(cfg.model, b, s, r), med),
            "kept_steps": kept, "wall_s": lo["wall_s"],
            "peak_allocated_gb": lo.get("peak_allocated_gb"),
            "peak_reserved_gb": lo.get("peak_reserved_gb"),
            "losses": lo["losses"]}
        print("train[lora]:", json.dumps(res["lora"]), flush=True)
        if not last5 < first5:
            raise AssertionError(f"train[lora]: the loss did not fall: "
                                 f"{lo['losses']}")
        if kept != [str(TRAIN_STEPS - SAVE_EVERY), str(TRAIN_STEPS)]:
            raise AssertionError(f"train[lora]: step dirs {kept}")

        # full fine-tune: step time and memory
        fu = _finetune(["train", *ft, "--dataset", data, *shape,
                        "--steps", str(FULL_STEPS), "--save-every", "0",
                        "--log-every", "1", "--full-finetune", "--out-dir",
                        full_dir])
        shutil.rmtree(full_dir)
        res["full"] = {"step_ms": fu["step_ms"], "losses": fu["losses"],
                       "wall_s": fu["wall_s"],
                       "last_step": _train_rates(_train_flops(
                           cfg.model, b, s, 0), fu["step_ms"][-1]),
                       "peak_allocated_gb": fu.get("peak_allocated_gb"),
                       "peak_reserved_gb": fu.get("peak_reserved_gb")}
        print("train[full]:", json.dumps(res["full"]), flush=True)

        # merge
        mg = _finetune(["merge", *ft, "--adapter-dir", lora_dir,
                        "--out-dir", merged_dir])
        res["merge"] = {"wall_s": mg["wall_s"], "bytes": mg["bytes"],
                        "save_s": mg["save_s"],
                        "write_gb_per_s": mg["bytes"] / mg["save_s"] / 1e9,
                        "peak_allocated_gb": mg.get("peak_allocated_gb")}
        print("train[merge]:", json.dumps(res["merge"]), flush=True)

        # serve the merged dir; the same merge in memory on the card
        dev = torch.device(device)
        base, _ = load_model(cfg, dev, model_path=model_dir)
        adapter, meta = restore_params(os.path.join(lora_dir, "adapter"), dev)
        with torch.no_grad():
            merged = L.merge_params(base, adapter, L.lora_scale(
                meta["lora_r"], meta["lora_alpha"]))
        del base, adapter
        check = {}

        def on_boot(rt):
            check["leaves_equal"] = _assert_trees_equal(
                rt.engine.core.params, merged, "merged")
            prompt = rt.pipeline.build_prompt(_request(0)["text"],
                                              force_speech=True)
            sampling = _tiny_sampling()
            served = rt.engine.generate(prompt, sampling).token_ids
            with torch.no_grad():
                mem = GenerationEngine(merged, rt.config.model,
                                       rt.config.engine, device=rt.device
                                       ).generate(prompt, sampling).token_ids
            merged.clear()
            gc.collect()
            if served != mem or len(served) != sampling.max_tokens:
                raise AssertionError(f"train[serve]: greedy tokens of the "
                                     f"served merge {served} vs in memory "
                                     f"{mem}")
            check["greedy_tokens_equal"] = len(served)
            # the PCM: the served merge's stream (windowed decode) against
            # the in-memory merge's tokens decoded whole, by audio_fidelity
            streamed = np.frombuffer(b"".join(
                c.pcm for c in rt.pipeline.stream(
                    _request(0)["text"], sampling=sampling,
                    force_speech=True)), np.int16) / 32767.0
            ex = protocol.TokenExtractor()
            ex.started = True
            whole = to_pcm16(torch.from_numpy(rt.vocoder.decode_frames(
                *protocol.deinterleave_frames(ex.feed_many(mem)),
                noise_seed=0))).numpy() / 32767.0
            fid = audio_fidelity.fidelity_report(whole, streamed)
            check["pcm_fidelity"] = {k: fid[k] for k in (
                "mse", "max_diff", "corr", "std_ratio", "mel_mse",
                "mel_corr", "samples_a", "samples_b", "pass")}
            if not fid["pass"] or fid["samples_a"] != fid["samples_b"] \
                    or not fid["samples_a"]:
                raise AssertionError(f"train[serve]: audio_fidelity of the "
                                     f"served PCM {fid}")
            # frame-aligned decoding (the grammar emits SOS itself, so the
            # prompt does not force it): every frame valid, none cut
            plain = rt.pipeline.build_prompt(_request(0)["text"])
            rep = analyze_tokens.analyze(plain + rt.engine.generate(
                plain, SamplingConfig(greedy=True, max_tokens=MAX_TOKENS + 1,
                                      frame_protocol=True)).token_ids)
            ex = rep["extraction"]
            check["frame_protocol_stream"] = {
                "frames": ex["frames"], "census": rep["census"]["counts"],
                "violations": rep["offsets"]["violations"]}
            if rep["offsets"]["violations"] or not ex["frames"] \
                    or ex["codes"] % 7:
                raise AssertionError(f"train[serve]: analyze_tokens {rep}")
            print("train[serve]: booted leaves and greedy tokens equal to "
                  "the in-memory merge", json.dumps(check), flush=True)

        ph = serve_phase("train", ["serve", "--model-path", merged_dir,
                                   "--snac-path", snac_dir, *extra],
                         {"K1": PER_STEP}, generate=False, on_boot=on_boot)
        # the bench request samples any audio token at any position
        # (audio_only, no frame grammar): every stream must hold its 40
        # frames; codes outside their position's block are counted
        reps = [analyze_tokens.analyze(ids)
                for ids in ph["served_tokens"].values()]
        if len(reps) != N_STREAMS or any(
                r["extraction"]["frames"] != MAX_TOKENS // 7
                or r["census"]["counts"].get("audio") != MAX_TOKENS
                for r in reps):
            raise AssertionError(f"train[serve]: analyze_tokens {reps}")
        res["serve"] = {**check, **{k: ph[k] for k in (
            "ttfa_ms_p50", "ttfa_ms_p95", "aggregate_rtf", "launches",
            "decode_steps", "worst_gap_ms_max")},
            "per_stream_rtf_min": min(ph["per_stream_rtf"]),
            "served_streams_frames": MAX_TOKENS // 7,
            "served_codes_outside_their_block": sum(
                r["offsets"]["violations"] for r in reps)}
        print("train[serve]: analyze_tokens on the 8 served streams: "
              f"{MAX_TOKENS // 7} frames each, "
              f"{res['serve']['served_codes_outside_their_block']} of "
              f"{N_STREAMS * MAX_TOKENS} codes outside their position's "
              "block (no frame grammar in the bench request)", flush=True)
        _free(ph)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if dirs is not None:
            shutil.rmtree(os.path.dirname(dirs[0]), ignore_errors=True)
    res["wall_s"] = time.perf_counter() - t_start
    print(f"train: {res['wall_s']:.1f} s", flush=True)
    return res


def _free(phase: dict) -> None:
    """Drop a full-width runtime before the next one is built."""
    phase.pop("rt", None)
    phase.pop("sched", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# name → (cli argv, expected launches, serve_phase keywords)
SERVE_PHASES = {
    "dense": (["serve"], {"K1": PER_STEP}, {}),
    "paged_int8": (["serve", "--paged-kv", "--kv-int8", "--kv-on-demand",
                    "--kv-block-size", "128", "--kv-pool-tokens", "2048"],
                   {"K3b": PER_STEP},
                   {"generate": False, "min_preemptions": 1,
                    "resume": True}),
    "paged_bf16": (["serve", "--paged-kv"], {"K3a": PER_STEP}, {}),
    "int4": (["serve", "--quantize", "--weight-bits", "4", "--paged-kv",
              "--kv-int4"], {"K4": LINEARS, "K5": PER_STEP, "K2": HEAD},
             {"generate": False}),
    "int8w": (["serve", "--quantize"],
              {"K2": LINEARS_AND_HEAD, "K1": PER_STEP}, {"generate": False}),
    # int8w with the C++ extractor and deinterleave: bench.py's default
    # weights under `serve --native-protocol`
    "native": (["serve", "--quantize", "--native-protocol"],
               {"K2": LINEARS_AND_HEAD, "K1": PER_STEP}, {"generate": False}),
    # two waves sharing an opener: the first request misses, 15 hit
    "prefix": (["serve", "--prefix-cache"], {"K1": PER_STEP},
               {"waves": 2, "opener": OPENER, "prefix_counts": (1, 15)}),
    # the bf16 vocoder: K6-bf16 carries every residual unit
    "vocoder_bf16": (["serve", "--vocoder-bf16"], {"K1": PER_STEP},
                     {"vocoder_kernel": "K6-bf16"}),
}


def fidelity_phase() -> dict:
    """The JAX package's gate for the bf16 vocoder, on the card: the port's
    ``tools/vocoder_dtype_fidelity.py`` at full geometry (64 frames × 4
    rows), f32 (K6) against bf16 (K6-bf16), within its four thresholds."""
    from tts_inference_tpu_torch.tools import vocoder_dtype_fidelity as vdf

    res = vdf.run(frames=64, batch=4, seed=0, device="cuda")
    print("fidelity: f32 vs bf16 vocoder", json.dumps(res), flush=True)
    if not res["pass"]:
        raise AssertionError(f"bf16 vocoder fidelity {res}")
    return res


def float16_phase() -> dict:
    """The float16 vocoder (``SnacConfig(dtype="float16")``, which the JAX
    package computes and no serve flag reaches): the fidelity tool's decode
    of the same seeded codes (64 frames x 4 rows) in float16 against f32,
    within its four thresholds. Every launch counter is set to 0 just
    before and read just after: the 16-bit body in float16 (K6-f16) carries
    the 12 residual units of the float16 decode, K6 those of the f32 one,
    and nothing else runs a kernel."""
    from tts_inference_tpu_torch.tools import vocoder_dtype_fidelity as vdf

    counters = _launch_counters()
    for c in counters.values():
        c.reset()
    res = vdf.run(frames=64, batch=4, seed=0, device="cuda", dtype="float16")
    torch.cuda.synchronize()
    launches = {k: c.count for k, c in counters.items()}
    print("fidelity: f32 vs float16 vocoder", json.dumps(res), flush=True)
    print("float16 decode launches:", json.dumps(launches), flush=True)
    want = {k: 0 for k in launches}
    want["K6-f16"] = want["K6"] = UNITS_PER_CALL
    if launches != want:
        raise AssertionError(f"float16 decode launches {launches} != {want}")
    if not res["pass"]:
        raise AssertionError(f"float16 vocoder fidelity {res}")
    return {"launches": launches, "fidelity": res}


def vocoder_phase(dense=None) -> dict:
    """The bf16 vocoder: the `vocoder_bf16` serve phase (K6-bf16 on every
    unit of every call, every call a replay), its numbers beside the same
    run's dense phase, windowed vs batch decode in bf16 against its bound,
    and the fidelity gate. Prints each part's seconds."""
    t0 = time.perf_counter()
    ph = run_serve_phase("vocoder_bf16")
    t1 = time.perf_counter()
    print(f"serve[vocoder_bf16]: {t1 - t0:.1f} s", flush=True)
    keys = ("ttfa_ms_p50", "ttfa_ms_p95", "aggregate_rtf",
            "max_memory_allocated")
    for tag, p in (("vocoder_bf16", ph), ("dense", dense)):
        if p is not None:
            rtf = sorted(p["per_stream_rtf"])
            print(f"serve[vocoder_bf16] beside dense: {tag}",
                  json.dumps({**{k: p[k] for k in keys},
                              "per_stream_rtf_min": rtf[0],
                              "per_stream_rtf_median": rtf[len(rtf) // 2],
                              "per_stream_rtf_max": rtf[-1]}), flush=True)
    ph["exactness"] = exactness_phase(ph["rt"], tol=PCM16_TOL_BF16)
    t2 = time.perf_counter()
    print(f"exactness[bf16]: {t2 - t1:.1f} s", flush=True)
    _free(ph)
    ph["fidelity"] = fidelity_phase()
    print(f"fidelity: {time.perf_counter() - t2:.1f} s", flush=True)
    return ph


def run_serve_phase(name: str, eager: bool = False) -> dict:
    argv, expect, kw = SERVE_PHASES[name]
    return serve_phase(name if not eager else f"{name}_eager", argv, expect,
                       eager=eager, **kw)


def compare_phase() -> dict:
    """Each serve phase eagerly and then replayed, in this process: TTFA
    p50 / p95, per-stream and aggregate RTF, peak memory of both."""
    keys = ("ttfa_ms_p50", "ttfa_ms_p95", "aggregate_rtf", "wave_wall_s",
            "max_memory_allocated")
    out = {}
    for name in SERVE_PHASES:
        row = {}
        for tag, eager in (("eager", True), ("replayed", False)):
            ph = run_serve_phase(name, eager=eager)
            rtf = sorted(ph["per_stream_rtf"])
            row[tag] = {**{k: ph[k] for k in keys},
                        "per_stream_rtf_min": rtf[0],
                        "per_stream_rtf_median": rtf[len(rtf) // 2],
                        "per_stream_rtf_max": rtf[-1]}
            _free(ph)
        out[name] = row
        print(f"compare[{name}]:", json.dumps(row), flush=True)
    return out


KERNELS = (
    # key, name, source under tts_inference_tpu_torch/csrc, the TPU kernel
    ("K1", "decode_attention", "decode_attention.cu",
     "tts_inference_tpu/ops/pallas/decode_attention.py:97"),
    ("K6", "fused_residual_unit", "vocoder.cu",
     "tts_inference_tpu/ops/pallas/vocoder.py:212"),
    ("K6-bf16", "fused_residual_unit_bf16", "vocoder16.cuh",
     "tts_inference_tpu/ops/pallas/vocoder.py:212"),
    ("K6-f16", "fused_residual_unit_f16", "vocoder16.cuh",
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
                         "kernels, qmm, dense, checkpoint, train, paged, "
                         "quant, prefix, vocoder, native, compare = the serve "
                         "phases eager and replayed, gap = the paged_int8 "
                         "phase alone) and print no result line; the full "
                         "run takes no arguments")
    ap.add_argument("--port-root", default=None, metavar="DIR",
                    help="development, with --only gap: import the port "
                         "from DIR (a checkout of another commit), to time "
                         "two trees in one call")
    parsed = ap.parse_args(argv)
    only = set(parsed.only.split(",")) if parsed.only else None
    if parsed.port_root and only != {"gap"}:
        ap.error("--port-root goes with --only gap")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if parsed.port_root:
        sys.path.insert(0, str(Path(parsed.port_root).resolve()))
    # the port must be importable from here before anything is reported
    import tts_inference_tpu_torch.cli  # noqa: F401
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    build_phase()

    def on(phase: str) -> bool:
        return only is None or phase in only

    if only is not None and "gap" in only:
        gap_phase(parsed.port_root)
    kern = kernel_phase() if on("kernels") else None
    if only is not None and "qmm" in only:
        qmm_phase()
    if only is not None and "compare" in only:
        compare_phase()
    phases, graphs = {}, {}
    if on("dense"):
        dense = phases["dense"] = run_serve_phase("dense")
        graphs["dense"] = graph_phase("dense", dense["rt"])
        exactness_phase(dense["rt"])
        reference_phase(dense["rt"])
        _free(dense)
    if on("checkpoint"):
        # the train phase fine-tunes the checkpoint phase's HF dir
        phases["checkpoint"] = checkpoint_phase(keep=on("train"))
    if on("train"):
        phases["train"] = train_phase(phases.get("checkpoint", {}).get("dirs"))
    if on("paged"):
        phases["paged_int8"] = run_serve_phase("paged_int8")
        phases["soak_preempt"] = soak_phase(
            "paged_int8", phases["paged_int8"]["sched"], "preempt")
        # --only paged,soak: the churn twice, the steadiness check of its
        # RSS and TTFA drift
        for _ in range(2 if only is not None and "soak" in only else 1):
            phases["soak"] = soak_phase(
                "paged_int8", phases["paged_int8"]["sched"], "churn")
        graphs["paged_int8"] = graph_phase("paged_int8",
                                           phases["paged_int8"]["rt"])
        if graphs["paged_int8"]["preemptions"] < 1:
            raise AssertionError("graph[paged_int8]: no preemption")
        _free(phases["paged_int8"])
        phases["paged_bf16"] = run_serve_phase("paged_bf16")
        graphs["paged_bf16"] = graph_phase("paged_bf16",
                                           phases["paged_bf16"]["rt"])
        _free(phases["paged_bf16"])
        paged_reference_phase()
    if on("quant"):
        phases["int4"] = run_serve_phase("int4")
        graphs["int4"] = graph_phase("int4", phases["int4"]["rt"])
        _free(phases["int4"])
        phases["int8w"] = run_serve_phase("int8w")
        graphs["int8w"] = graph_phase("int8w", phases["int8w"]["rt"])
        _free(phases["int8w"])
        quant_reference_phase()
    if on("native"):
        t0 = time.perf_counter()
        phases["native"] = run_serve_phase("native")
        _free(phases["native"])
        keys = ("ttfa_ms_p50", "ttfa_ms_p95", "aggregate_rtf",
                "worst_gap_ms_p50", "worst_gap_ms_max",
                "max_memory_allocated")
        for tag in ("native", "int8w"):
            if tag in phases:
                rtf = sorted(phases[tag]["per_stream_rtf"])
                print(f"serve[native] beside int8w: {tag}",
                      json.dumps({**{k: phases[tag][k] for k in keys},
                                  "per_stream_rtf_min": rtf[0],
                                  "per_stream_rtf_max": rtf[-1]}),
                      flush=True)
        native_reference_phase()
        print(f"native: {time.perf_counter() - t0:.1f} s", flush=True)
    if on("prefix"):
        t0 = time.perf_counter()
        ph = phases["prefix"] = run_serve_phase("prefix")
        t1 = time.perf_counter()
        print(f"serve[prefix]: {t1 - t0:.1f} s", flush=True)
        if "dense" in phases:
            print("serve[prefix] TTFA ms (p50, p95) per wave",
                  ph["ttfa_ms_per_wave"], "; dense phase of this run",
                  (phases["dense"]["ttfa_ms_p50"],
                   phases["dense"]["ttfa_ms_p95"]), flush=True)
        prefix_reference_phase(ph["rt"])
        print(f"reference[prefix]: {time.perf_counter() - t1:.1f} s",
              flush=True)
        _free(ph)
    if on("vocoder"):
        if kern is None:   # --only vocoder: the 16-bit kernel cases too
            gen = torch.Generator(device="cuda").manual_seed(0)
            k6_16_phase(gen, torch.bfloat16)
            k6_16_phase(gen, torch.float16)
        phases["vocoder_bf16"] = vocoder_phase(phases.get("dense"))
        t0 = time.perf_counter()
        phases["vocoder_f16"] = float16_phase()
        print(f"float16: {time.perf_counter() - t0:.1f} s", flush=True)
    if only is not None:
        print(f"chip_smoke: phases {sorted(only)} passed; no result line "
              "without the full run", flush=True)
        return 0
    # each kernel's launches on the main path of the phase that runs it
    on_path = {"K1": "dense", "K6": "dense", "K6-bf16": "vocoder_bf16",
               "K6-f16": "vocoder_f16",
               "K3a": "paged_bf16",
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
