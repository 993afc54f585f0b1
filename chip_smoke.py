"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failed check raises, so the exit code is nonzero and
no result line is printed. The serve phases after the dense one (the
checkpoint and train boots, paged bf16, int4, int8w, native, prefix, the
bf16 vocoder, the deploy replicas) add ``SMALL_SERVE``'s flags, a smaller
census (max_seq 512), and paged_int8 takes max_seq 2,048, so that the run
keeps within its time limit on a slow host:

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
   after it, a graph phase runs eight requests (greedy and seeded; 70
   tokens each, 210 in paged_int8, whose pool must preempt) through a
   scheduler over an eager core (``EngineCore(..., graphs=False)``) and
   eager vocoder and over replayed ones on the phase's weights: tokens
   equal, or a greedy flip at an eager top-2 logit gap <= 1e-3, and the
   PCM of equal tokens within PCM16_TOL;
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
   (``tools/soak.py`` over that phase's scheduler, twice: 5 s of
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
18. tools phase: the measurement and diagnostic tools of
    ``tts_inference_tpu_torch/tools/`` at full width. On the dense phase's
    runtime, before it is freed: ``compare_backends`` (the engine's greedy
    tokens against the eager twin's: equal, or the first flip at a top-2
    logit gap within twice the model's own noise, as the prefix reference
    bounds one) and ``lookahead_sweep`` (40 frames on its vocoder: pass at
    lookahead 3 and 5, MSE at 0 above MSE at 3). Then ``step_bench
    --quantize`` at B 64, W 512 (every component non-null, kv_write on a
    paged cache only; each component's launches exactly what its chain
    replays), ``kv_kernel_bench`` at B 64 W 512 and B 4 W 12,288 (K3a, K3b,
    K5 beside their bounds), ``vocode_bench`` 64 × 16 in f32 and bf16 (12
    launches of K6 / K6-bf16 a call), ``quant_ladder --full-geometry
    --tokens 70 --utterances 1`` on the rungs bf16, int8 and int4_g128,
    each in its own process (no rung fails; K2 and K4 launch where their
    rungs need them), and ``sos_ablation`` and ``make_artifacts`` on the
    tiny model on the card, under ``build/tools_phase`` (the artifact gate
    passes); the launches of every kernel over the phase;
19. multigpu phase: the sharded path (``parallel/``, sharded serving and
    training) on the one card — the card count stays 1 and no number is a
    multi-GPU speed. Its kernel cases run in the kernel phase, after all
    the others: K1 at Hkv 4 and 2 (tp 2 and 4), K3b at Hkv 4, K5 at 2 and
    1 head pairs, K2 on the tp-2 shards of the seven linears and the
    14,470-row head shard, K4 on those linears at group 128 and on the two
    row shards at group 512 (o at the split group 256, down at 512), each
    against its plain version and timed. Then, at full Orpheus-3B width
    with int8 weights and a small engine (4 slots): an NCCL group of one
    (``Mesh(dp=1, tp=1)`` given explicitly, so every collective is a real
    NCCL call) whose scheduler captures its graphs at warmup with the
    collectives inside and serves four greedy requests with every launch a
    replay and no capture, its tokens equal to the plain core's, and which
    then runs three LoRA steps of the tiny model in f32 through the mesh
    code path, their losses and adapters within 1e-5 of the one-process
    step's; two ranks sharing the card over gloo (eager: gloo cannot be
    captured): two full-width LoRA steps of train_step.CARD_*'s shape at
    tp 2 and at dp 2, each rank's losses and gradients held to the
    one-process step within a bf16 bound (``two_rank_phase``), with step
    ms, all_reduce calls a step and peak memory a rank; then, on the tp-2
    runtime a sharded ``cli generate`` builds, rank 0's mirrored scheduler
    serving one greedy request (35 tokens) dense, paged int8 and with int4
    weights at group 512, and its single-stream engine generating through
    the mirror — the shard shapes held, K1 / K3b, K2 and K4 (int4)
    launched on both ranks, the tokens equal to the unsharded engine's up
    to a first flip within twice the model's own noise, the PCM equal to
    the whole decode of its tokens within PCM16_TOL, per-rank peak memory —
    and rank 1 killed mid-stream, after which rank 0's stream ends with
    "engine down"; ``tools/lockstep_overhead.py`` (the µs of mirroring a
    decode launch);
20. deploy phase: the deployment layer (``tts_inference_tpu_torch/
    deploy/``), every server a process of its own. ``deploy.launch
    --replicas 2`` over ``cli serve`` with ``SMALL_SERVE``'s smaller census
    (max_seq 512, two KV windows): its warm build (the
    build info names the kernel library this run built); two full-width
    replicas on the card (the card's free memory printed before the
    launch; each replica's device memory in the router's per-replica
    ``/metrics``; the card's free memory fallen by what they reserve; both
    pids in ``nvidia-smi --query-compute-apps`` where it lists them: a host
    whose processes run in a pid namespace of their own is listed as one
    pid);
    while they boot, a supervised ``cli serve --tiny
    --no-warmup`` killed, restarted and drained (``{"restarts": 1}``);
    one-chunk requests straight to replica0 and through the router in
    turns (the router hop's share of TTFA); the dense phase's 8 ``/ws/tts``
    streams through the router (full PCM, the router's ``served`` split
    summing to 8 with at least 1 on each, 0 late captures in each replica;
    TTFA, RTF and worst gap beside the dense phase's); replica0 SIGKILLed
    and 4 streams at once (all on replica1, full PCM); the seconds until
    replica0's ``/health`` answers again; SIGTERM (rc 0 within
    ``--drain-s``, the last line ``{"restarts": {"replica0": 1,
    "replica1": 0, "router": 0}}``, no child left, none of their pids in
    nvidia-smi and the card's memory back to before the launch); then
    ``tools/profile_ttfa.py --quantize`` at full width in a process of its
    own, every line printed, every number finite and positive, K1, K2 and
    K6 launched. The lockstep launcher has no leg here: its members use
    NCCL, one card each (the CPU tests run its gloo group);
21. long phase: ``bench.py --mode long``'s engine class through ``cli
    serve`` (``--quantize --paged-kv --max-batch-size 4 --max-input-len
    128 --prefill-buckets 128 --max-output-len 12032 --kv-pool-tokens
    48704``: max_seq 12,160, windows to 8,192 and max_seq): 4 concurrent
    ``/ws/tts`` streams of 8,379 tokens (1,197 frames, 102.1 s), every
    frame delivered, decode launches replayed at the 4,096, 8,192 and
    12,160 windows with no late capture, K3a on every layer of every
    decode step, K2 on every linear and the head, K6 12 a vocoder call;
    then the JAX package's long-audio test geometry on the tiny model
    (max_seq 14,400, blocks of 64): 2,016 frames through the pipeline with
    O(n) re-decode, the streamed PCM within PCM16_TOL of the batch decode,
    and 4,300 greedy tokens held to the CPU's choice at every step;
22. the card line, the kernels' JSON line, and last
    ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package. Exits nonzero
without a card. ``--only PHASES`` (kernels, qmm = K4 and K2 alone, dense,
checkpoint, train, paged, quant, native, prefix, vocoder = phase 17 with the 16-bit
kernel cases; tools = phase 18 with ``step_bench`` also at ``--paged-kv
--kv-int8`` and ``--quantize --weight-bits 4 --paged-kv --kv-int4`` and all
five ladder rungs, on a runtime of its own without the dense phase;
multigpu = phase 19 with its kernel cases; deploy = phase 20; long =
phase 21;
paged,soak runs the churn soak twice; gap = the paged_int8 serve
phase alone, with ``--port-root DIR`` from another checkout, to time two
trees in one call) runs some phases during development and prints no
result line.
"""

from __future__ import annotations

import asyncio
import collections
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


def _k1_case(w: int, gen: torch.Generator, hkv: int = 8):
    import torch.nn.functional as F

    from tts_inference_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)

    b, g, d, max_seq = 8, 3, 128, 4608
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
    return _report("K1 decode_attention", f"B8 Hkv{hkv} G3 D128 bf16 W{w}",
                   err, K1_TOL, ms, plain,
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


def _paged_case_inputs(b: int, w: int, gen: torch.Generator, hkv: int = 8):
    """Random paged-attention inputs at the serve path's Hkv 8 (a tp
    shard's `hkv`), G 3, D 128 and block 128: each slot holds a random
    number of blocks at random pool rows (slot 0 the whole window, slot 1
    one block), its table row is 0 past its last block, and the kernels
    read a column slice of a wider table, as the engine hands it."""
    g, d, bs = 3, 128, 128
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


def _k3_case(kind: str, b: int, w: int, gen: torch.Generator,
             hkv: int = 8):
    """K3a (bf16 pools), K3b (int8 pools) or K5 (int4 pools packed by head
    pair) at (B, W). Pools are written by the port's own pool_scatter and
    quantizers from random bf16 K/V. No PyTorch call computes attention
    over a block pool, so there is no library time."""
    from tts_inference_tpu_torch.models.llama import _quantize_kv, pool_scatter
    from tts_inference_tpu_torch.ops import paged_attention as pa
    from tts_inference_tpu_torch.ops import paged_attention_int4 as pa4

    g, d, bs = 3, 128, 128
    dev = "cuda"
    n, table, pos, rows, offs, q, kv = _paged_case_inputs(b, w, gen, hkv)
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
    return _report(name, f"B{b} Hkv{hkv} G3 D128 bs128 {what} W{w}", err,
                   K3_TOL, ms, plain_ms,
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


def _k2_head_case(gen: torch.Generator, tp: int = 1):
    """The tied head: the last 28,940 rows of a (156,940, 3072) int8
    embedding, read in place as a row slice, f32 logits; under tp a rank's
    block of the vocabulary partition (its text rows, then its 28,940 / tp
    rows of the sliced head) and the head slice of it."""
    from tts_inference_tpu_torch.models.quant import QuantEmbed
    from tts_inference_tpu_torch.ops.int4_matmul import w8_mm, w8_mm_reference
    from tts_inference_tpu_torch.parallel.mesh import vocab_shards

    vs = vocab_shards(156940, tp)
    v, h, base, m = vs.rows, 3072, vs.tc, 8
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


# per-rank (K, N) of the Orpheus-3B layer linears under tp 2: q, k and v,
# gate and up column shards; o and down row shards
TP2_LINEARS = {"q": (3072, 1536), "k/v": (3072, 512), "o": (1536, 3072),
               "gate/up": (3072, 4096), "down": (4096, 3072)}


def shard_kernel_cases(gen: torch.Generator) -> dict:
    """The kernels at the per-rank shapes of a sharded Orpheus-3B, against
    their plain versions with the tolerances of the cases above, timed:
    K1 at Hkv 4 and 2 (tp 2, tp 4; G 3), K3b at Hkv 4, K5 at 2 and 1 head
    pairs, K2 on the tp-2 shards of the seven linears and the tp-2 block of
    the vocabulary (14,470 rows of the sliced head), K4 on those linears at
    group 128 (K/tp is then whole groups in each packed half), and K4 on
    the two row shards at the default group 512: o 1536→3072 at the split
    group 256 (``parallel/mesh.shard_group``), down 4096→3072 at 512."""
    res = {}
    for tp in (2, 4):
        res[f"K1 tp{tp}"] = _k1_case(512, gen, hkv=8 // tp)
    res["K3b tp2"] = _k3_case("K3b", 8, 512, gen, hkv=4)
    for tp in (2, 4):
        res[f"K5 tp{tp}"] = _k3_case("K5", 8, 512, gen, hkv=8 // tp)
    for name, (k, n) in TP2_LINEARS.items():
        res[f"K2 {name} tp2"] = _k2_case(8, k, n, gen)
        res[f"K4 {name} tp2"] = _k4_case(8, k, n, 128, torch.bfloat16, gen)
    res["K2 head tp2"] = _k2_head_case(gen, tp=2)
    # after the cases above, which so keep drawing the inputs they drew
    for name, (k, n), g in (("o", TP2_LINEARS["o"], 256),
                            ("down", TP2_LINEARS["down"], 512)):
        res[f"K4 {name} tp2 g512"] = _k4_case(8, k, n, g, torch.bfloat16,
                                              gen)
    print(f"multigpu shard shapes [{card_line()}]:", json.dumps(
        {k: {f: v[f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms")}
         for k, v in res.items()}), flush=True)
    return res


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
    shard_kernel_cases(gen)

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


def _request(i: int, opener: str = "", max_tokens: int = MAX_TOKENS) -> dict:
    # bench.py's request: speech forced, audio tokens only, fixed budget
    return {"text": f"{opener}Stream {i}: the quick brown fox jumps over the "
                    "dog.",
            "force_speech": True, "audio_only": True,
            "max_tokens": max_tokens, "seed": 1000 + i, "benchmark": True}


async def _drive(port: int, generate: bool, waves: int = 1,
                 opener: str = "", streams: int = N_STREAMS,
                 max_tokens: int = MAX_TOKENS) -> dict:
    """`waves` waves of `streams` concurrent /ws/tts requests of
    `max_tokens` tokens, one after the other, then (with `generate`) one
    /generate; /metrics before the first wave, after the last and at the
    end."""
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
                await ws.send_json(_request(i, opener, max_tokens))
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
                    "text": _request(i, opener, max_tokens)["text"],
                    "worst_gap_ms": max(gaps, default=0.0)}

        out = {"streams": [], "waves": [], "wave_s": 0.0,
               "metrics_before": await metrics()}
        for w in range(waves):
            t0 = time.perf_counter()
            got = await asyncio.gather(*(
                one(w * streams + i) for i in range(streams)))
            wave_s = time.perf_counter() - t0
            out["waves"].append({"streams": got, "wave_s": wave_s})
            out["streams"] += got
            out["wave_s"] += wave_s
        out["metrics_waves"] = await metrics()
        if generate:
            t1 = time.perf_counter()
            async with sess.post(base + "/generate", json=_request(
                    waves * streams, opener, max_tokens)) as r:
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
    from tts_inference_tpu_torch.ops import _build

    return _build.launch_counters()


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
                resume: bool = False, max_tokens: int = MAX_TOKENS,
                streams: int = N_STREAMS, windows=()) -> dict:
    """Build `cli serve` (runtime + scheduler) from `argv`, put the port's
    aiohttp app on a localhost port and drive it: `waves` waves of
    `streams` (8) concurrent /ws/tts streams of `max_tokens` (280) tokens
    (texts starting with `opener`), then (with `generate`) one /generate,
    then /metrics. Every phase prints the scheduler core's decode launches
    by KV window; each window of `windows` must have one. `expect` maps
    each kernel of the phase's path to its launch count as a function of
    (layers, decode steps, forward passes); every kernel it does not name
    must not run, except `vocoder_kernel` (K6, or K6-bf16 under
    ``--vocoder-bf16``), which carries every residual unit of every
    vocoder call: 12 launches a call. Every vocoder call of the run (the vocode worker's and the fused
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
    pcm_bytes = (max_tokens // 7) * 2048 * 2
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
    by_window = collections.Counter()   # the core's decode launches
    launch = core._launch

    def _recording_launch(key, *a, **kw):
        if key[0] == "decode":
            by_window[key[2]] += 1
        return launch(key, *a, **kw)

    core._launch = _recording_launch
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
            return await _drive(port, generate, waves, opener, streams,
                                max_tokens)
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
        steps0 = sum(c.steps_launched for c in cores)
        prefills0 = sum(c.prefills for c in cores)
        by_window.clear()
        res = asyncio.run(run())
        steps = sum(c.steps_launched for c in cores) - steps0
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
    print(f"serve[{name}] decode launches by KV window (scheduler):",
          json.dumps(dict(sorted(by_window.items()))), flush=True)
    if not all(by_window[w] for w in windows):
        raise AssertionError(f"serve[{name}]: decode launches by window "
                             f"{dict(by_window)}; each of {list(windows)} "
                             "needs one")
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
             if s["bytes"] != pcm_bytes]
    if short:
        raise AssertionError(f"streams (index, PCM bytes, done) {short}: "
                             f"expected {pcm_bytes} bytes each")
    if generate and res["generate_samples"] != pcm_bytes // 2:
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
    audio_s = pcm_bytes / 2 / 24000
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
        "decode_launches_by_window": dict(sorted(by_window.items())),
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
    print(f"serve[{name}]: {waves} x {streams} x /ws/tts"
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


def _one_slot_cache(rt):
    """An empty one-slot cache of the runtime's kind and max_seq (paged: a
    table of its own blocks) on its device."""
    from tts_inference_tpu_torch.models import llama

    core, cfg, ecfg = rt.engine.core, rt.config.model, rt.config.engine
    if not ecfg.paged_kv:
        return llama.init_kv_cache(cfg, 1, core.max_seq, device=core.device,
                                   int8=ecfg.kv_cache_int8)
    nblk = core.max_seq // ecfg.kv_block_size
    cache = llama.init_paged_kv_cache(
        cfg, 1, core.max_seq, num_blocks=1 + nblk,
        block_size=ecfg.kv_block_size, int8=ecfg.kv_cache_int8,
        int4=ecfg.kv_cache_int4, device=core.device)
    cache.block_table[0] = torch.arange(1, 1 + nblk, dtype=torch.int32)
    return cache


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

    core, cfg, dev = rt.engine.core, rt.config.model, rt.engine.core.device
    cache = _one_slot_cache(rt)
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


def _forced_logits(rt, prompt, toks, sampling):
    """The logits the greedy sampler ranks at every step of `toks`, each
    given the prompt and the tokens before it (teacher-forced): one forward
    over prompt + toks[:-1] into a one-slot cache of the runtime's kind,
    then each step's repetition penalty (the prompt and toks[:i] seen) and
    the token range, as ``_allowed_logits`` applies them to one step.
    (steps, V - logits_base) on the runtime's device."""
    from tts_inference_tpu_torch.models import llama
    from tts_inference_tpu_torch.ops import sampling as S

    core, cfg, dev = rt.engine.core, rt.config.model, rt.engine.core.device
    base = core.logits_base
    cache = _one_slot_cache(rt)
    ids = torch.tensor([list(prompt) + list(toks[:-1])], dtype=torch.int32,
                       device=dev)
    n = torch.tensor([ids.shape[1]], dtype=torch.int32, device=dev)
    hidden, _ = llama.forward(core.params, cfg, ids, cache,
                              torch.zeros_like(n), n, kv_window=ids.shape[1])
    logits = llama.compute_logits(core.params, cfg,
                                  hidden[0, len(prompt) - 1:], base)
    steps, v = logits.shape
    # step i has seen token t when t is in the prompt or t's first step < i
    first = torch.full((v,), steps, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, torch.tensor(toks, device=dev) - base,
                          torch.arange(steps, device=dev), reduce="amin")
    first[[t - base for t in prompt if t >= base]] = -1
    seen = torch.arange(steps, device=dev)[:, None] > first[None, :]
    pen = S.apply_repetition_penalty(
        logits, seen, torch.full((steps,), sampling.repetition_penalty,
                                 device=dev))
    lo, hi = sampling.token_range
    col = base + torch.arange(v, device=dev)
    return pen.masked_fill(~((col >= lo) & (col < hi)), float("-inf"))


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
                         use_native: bool = False, params=None, **kw):
    """A scheduler of `config` over the runtime's weights (or `params`: a
    mesh rank's shard, with mesh= and the other Scheduler keywords in `kw`)
    and its vocoder, or `vocoder`, that keeps each finished request's raw
    token stream in `finished` (text → tokens)."""
    from tts_inference_tpu_torch.engine import scheduler as TS

    class Recording(TS.Scheduler):
        def _release(self, slot):
            st = self.slots[slot]
            if st is not None:
                finished[st.req.text] = list(st.token_ids)
            super()._release(slot)

    return Recording(rt.engine.core.params if params is None else params,
                     config, vocoder or rt.vocoder, rt.tokenizer,
                     device=rt.device, use_native=use_native, **kw)


GRAPH_FLIP_GAP = 1e-3   # eager top-2 logit gap below which a greedy flip passes


def _graph_run(rt, graphs: bool, max_tokens: int = MAX_TOKENS) -> dict:
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
        sampling=(SamplingConfig(greedy=True, max_tokens=max_tokens,
                                 token_range=audio) if i % 2 == 0 else
                  SamplingConfig(max_tokens=max_tokens, seed=500 + i,
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


# the graph phase's requests where no preemption is needed: 10 frames each
GRAPH_TOKENS = 70
# the paged_int8 phase's: 30 frames, which its pool of 16 blocks cannot
# hold for 8 streams of a ~62-token prompt (3 blocks each past 256
# positions, from the ~190th token), so it preempts
PAGED_GRAPH_TOKENS = 210


def graph_phase(name: str, rt, max_tokens: int = GRAPH_TOKENS) -> dict:
    """The replayed path against the eager one at full geometry, on the same
    card and weights: the same eight requests (greedy and seeded) through a
    scheduler over an eager core and over a replayed core. Every request's
    tokens must be equal; a greedy request may differ only where the eager
    model's top-2 logit gap is at most GRAPH_FLIP_GAP (the phase prints the
    step and the gap)."""
    with torch.no_grad():
        eager = _graph_run(rt, graphs=False, max_tokens=max_tokens)
        replayed = _graph_run(rt, graphs=True, max_tokens=max_tokens)
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
        if len(a) != max_tokens:
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
# scheduler (every graph captured, no late capture allowed). 15 s each since
# PR 16 (30 before), to keep the whole run inside its time limit.
SOAK = {"duration_s": 5.0, "target_streams": 8, "cancel_rate": 0.1,
        "seed": 0, "warm_s": 0.0}
SOAKS = {"preempt": {**SOAK, "max_tokens_range": (300, 900)},
         "churn": SOAK}


def soak_phase(name: str, scheduler, kind: str) -> dict:
    """The port's ``tools/soak.py`` over a served phase's warmed scheduler:
    randomized churn (mixed lengths and sampling, mid-stream cancels) for
    SOAK's duration at 8 target streams, at SOAKS[kind]'s lengths. Fails on error
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
    admission) and a hit wave of other suffixes — 35 tokens each (56
    before PR 16, which cut the decode launches from 6 to 3 to keep the
    whole run inside its time limit). After
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
                run = {"waves": _prefix_waves(core, waves, 13, 2, sampling,
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


# The serve phases after the dense one (which boots the `cli serve`
# defaults: 6 prompt buckets, KV windows 256 ... 4,096 and max_seq 4,608)
# boot a smaller census, so that the full run stays within its time limit
# on a slow host: prompts to 128 tokens (buckets 16 ... 128) and a
# 384-token budget (max_seq 512: windows 256 and 512), a third of the
# defaults' decode graphs; every request of these phases needs at most
# ~410 positions. A paged phase gets a pool of 4,096 tokens (32 blocks of
# 128: 8 streams of 3 blocks each, no held queue). paged_int8 keeps its
# 2,048-token pool and the default prompt buckets, so that its resumes
# re-prefill through the 512 bucket as before, and takes max_seq 2,048
# (windows 256 ... 1,024 and 2,048): its resume tier is 1,024 and 2,048.
SMALL_SERVE = ["--max-input-len", "128", "--prefill-buckets",
               "16,32,64,128", "--max-output-len", "384"]
SMALL_POOL = ["--kv-pool-tokens", "4096"]

# name → (cli argv, expected launches, serve_phase keywords)
SERVE_PHASES = {
    "dense": (["serve"], {"K1": PER_STEP}, {}),
    "paged_int8": (["serve", "--paged-kv", "--kv-int8", "--kv-on-demand",
                    "--kv-block-size", "128", "--kv-pool-tokens", "2048",
                    "--max-output-len", "1536"],
                   {"K3b": PER_STEP},
                   {"generate": False, "min_preemptions": 1,
                    "resume": True}),
    "paged_bf16": (["serve", "--paged-kv", *SMALL_SERVE, *SMALL_POOL],
                   {"K3a": PER_STEP}, {}),
    "int4": (["serve", "--quantize", "--weight-bits", "4", "--paged-kv",
              "--kv-int4", *SMALL_SERVE, *SMALL_POOL],
             {"K4": LINEARS, "K5": PER_STEP, "K2": HEAD},
             {"generate": False}),
    "int8w": (["serve", "--quantize", *SMALL_SERVE],
              {"K2": LINEARS_AND_HEAD, "K1": PER_STEP}, {"generate": False}),
    # int8w with the C++ extractor and deinterleave: bench.py's default
    # weights under `serve --native-protocol`
    "native": (["serve", "--quantize", "--native-protocol", *SMALL_SERVE],
               {"K2": LINEARS_AND_HEAD, "K1": PER_STEP}, {"generate": False}),
    # two waves sharing an opener: the first request misses, 15 hit
    "prefix": (["serve", "--prefix-cache", *SMALL_SERVE], {"K1": PER_STEP},
               {"waves": 2, "opener": OPENER, "prefix_counts": (1, 15)}),
    # the bf16 vocoder: K6-bf16 carries every residual unit
    "vocoder_bf16": (["serve", "--vocoder-bf16", *SMALL_SERVE],
                     {"K1": PER_STEP}, {"vocoder_kernel": "K6-bf16"}),
}


# ---- the long phase: bench.py --mode long's engine class --------------------

# `cli serve` at bench.py --mode long's geometry: 4 slots, int8 weights,
# paged bf16 KV, one prompt bucket of 128 and a 12,032-token budget
# (max_seq 12,160; --max-input-len 128, where the port's default is 512),
# the pool 4 x (128 + 12,032 + 16) tokens; 4 streams of 1,197 frames
# (102.1 s of audio, under the server's 120 s cap) that cross the 4,096 and
# 8,192 windows into max_seq
LONG_ARGV = ["serve", "--quantize", "--paged-kv", "--max-batch-size", "4",
             "--max-input-len", "128", "--prefill-buckets", "128",
             "--max-output-len", "12032", "--kv-pool-tokens", "48704"]
LONG_TOKENS = 8379
LONG_STREAMS = 4
LONG_WINDOWS = (4096, 8192, 12160)
# the tiny long geometry on the card: the JAX package's long-audio test
# (tests/test_long_audio.py): >= 2,000 frames through the pipeline, and
# greedy tokens against the CPU's to this depth, past the 4,096 window
LONG_TINY_FRAMES = 2016
LONG_TINY_GREEDY = 4300
LONG_TINY_WINDOWS = (4096, 8192, 14400)


def long_serve_phase() -> dict:
    """The long serve phase: `cli serve` at LONG_ARGV, 4 concurrent
    /ws/tts streams of LONG_TOKENS tokens. Every stream delivers all its
    frames (samples = frames x 2,048); the scheduler's decode launches
    replay at the 4,096, 8,192 and 12,160 windows with no late capture (and
    every vocoder call a replay); K3a carries every layer of every decode
    step, K2 every linear and the head, K6 12 units a vocoder call, and no
    other kernel runs."""
    ph = serve_phase("long", LONG_ARGV,
                     {"K3a": PER_STEP, "K2": LINEARS_AND_HEAD},
                     generate=False, max_tokens=LONG_TOKENS,
                     streams=LONG_STREAMS, windows=LONG_WINDOWS)
    core = ph["sched"].core
    want = {f"capture_decode_n{core.engine_cfg.decode_steps_per_call}_w{w}"
            for w in LONG_WINDOWS}
    if core.max_seq != 12160 or not want <= set(core.graph_census_ms):
        raise AssertionError(f"serve[long]: max_seq {core.max_seq}, census "
                             f"{sorted(core.graph_census_ms)} lacks "
                             f"{sorted(want)}")
    rtf = ph["per_stream_rtf"]
    print("serve[long] [" + card_line() + "]:", json.dumps({
        "streams": LONG_STREAMS, "tokens": LONG_TOKENS,
        "frames": LONG_TOKENS // 7,
        "audio_s_per_stream": (LONG_TOKENS // 7) * 2048 / 24000,
        "ttfa_ms_p50": ph["ttfa_ms_p50"], "ttfa_ms_p95": ph["ttfa_ms_p95"],
        "per_stream_rtf_min": min(rtf), "per_stream_rtf_max": max(rtf),
        "aggregate_rtf": ph["aggregate_rtf"],
        "worst_gap_ms_max": ph["worst_gap_ms_max"],
        "decode_launches_by_window": ph["decode_launches_by_window"],
        "launches": {k: n for k, n in ph["launches"].items() if n},
        "peak_allocated_gb": ph["max_memory_allocated"] / 1e9,
        "peak_reserved_gb": ph["max_memory_reserved"] / 1e9}), flush=True)
    return ph


def _long_tiny_config():
    """The JAX package's long-audio test geometry (``long_tiny_config``):
    the tiny model at Orpheus's vocabulary, max_seq 14,400, 2 slots, paged
    KV in blocks of 64 over 2 x 14,400 tokens, windows to 8,192."""
    from tts_inference_tpu_torch.config import (Config, EngineConfig,
                                                ModelConfig, SnacConfig,
                                                extended_kv_buckets)

    eng = EngineConfig(
        max_input_len=64, max_output_len=14400 - 64, max_batch_size=2,
        prefill_buckets=(16, 32, 64), decode_steps_per_call=14,
        paged_kv=True, kv_block_size=64, kv_pool_tokens=2 * 14400,
        kv_buckets=extended_kv_buckets((256, 512, 1024, 2048, 4096), 14400))
    return Config(model=ModelConfig.tiny(vocab_size=156940),
                  snac=SnacConfig(latent_dim=32, decoder_dim=64,
                                  codebook_dim=4), engine=eng)


def long_tiny_phase(device="cuda") -> dict:
    """The JAX package's long-audio test on the card: the tiny model at
    ``_long_tiny_config`` (graphs captured at boot), the weights copied
    from a CPU twin. (1) LONG_TINY_FRAMES frames through
    ``rt.pipeline.stream`` (engine → extractor → windowed lookahead):
    samples = frames x 2,048, the re-decoded frames O(n) (at most frames +
    windows x (left context + lookahead), under 3 x frames), the decode
    launches replays at the 4,096, 8,192 and 14,400 windows with no late
    capture, and the streamed PCM within PCM16_TOL of one batch decode of
    the same codes. (2) LONG_TINY_GREEDY greedy tokens on the card, past
    the 4,096 window, against the CPU's greedy choice at every step given
    the card's tokens before it (``_forced_logits``: one forward on the
    CPU): each the CPU's best, or within GRAPH_FLIP_GAP of its logit; the
    depth compared and any differing step are printed."""
    import numpy as np

    from tts_inference_tpu_torch import protocol
    from tts_inference_tpu_torch.config import SamplingConfig, StreamConfig
    from tts_inference_tpu_torch.models.snac import to_pcm16
    from tts_inference_tpu_torch.runtime import Runtime

    audio = (protocol.TOKEN_AUDIO_BASE,
             protocol.TOKEN_AUDIO_BASE + protocol.AUDIO_VOCAB)
    cfg = _long_tiny_config()
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu = Runtime.create(cfg, seed=0, device="cpu")
        gpu = Runtime.create(cfg, seed=0, device=device, warmup=True)
        _copy_tree(gpu.engine.core.params, cpu.engine.core.params)
        _copy_tree(gpu.vocoder.params, cpu.vocoder.params)
        core = gpu.engine.core
        boot_s = time.perf_counter() - t0
        # (1) the stream, its tokens and its decode launches recorded
        tokens, by_window = [], collections.Counter()
        stream, launch = gpu.engine.stream, core._launch

        def recording_stream(*a, **kw):
            for chunk in stream(*a, **kw):
                tokens.extend(int(t) for t in chunk)
                yield chunk

        def recording_launch(key, *a, **kw):
            if key[0] == "decode":
                by_window[key[2]] += 1
            return launch(key, *a, **kw)

        gpu.engine.stream, core._launch = recording_stream, recording_launch
        late0 = core.late_captures
        uses0 = (core.launches.copy(), core.replays.copy())
        sampling = SamplingConfig(max_tokens=LONG_TINY_FRAMES * 7 + 2,
                                  seed=11, token_range=audio)
        t1 = time.perf_counter()
        pcm = b"".join(c.pcm for c in gpu.pipeline.stream(
            "long audio capacity", "tara", sampling,
            StreamConfig(frames_per_chunk=16), force_speech=True))
        stream_s = time.perf_counter() - t1
        del gpu.engine.stream, core._launch
        m, la = gpu.pipeline.last_metrics, gpu.pipeline.last_lookahead
        spf = gpu.vocoder.cfg.samples_per_frame
        overhead = (la.stream_cfg.left_context_frames
                    + la.stream_cfg.lookahead_frames)
        uses = {"launches": dict(core.launches - uses0[0]),
                "replays": dict(core.replays - uses0[1])}
        res = {"boot_s": boot_s, "stream_s": stream_s, "frames": m.frames,
               "samples": len(pcm) // 2, "audio_s": len(pcm) / 2 / 24000,
               "decode_calls": la.decode_calls,
               "frames_decoded_total": la.frames_decoded_total,
               "frames_decoded_bound": m.frames + la.decode_calls * overhead,
               "decode_launches_by_window": dict(sorted(by_window.items())),
               "late_captures": core.late_captures - late0, "uses": uses}
        if (m.frames < LONG_TINY_FRAMES or len(pcm) // 2 != m.frames * spf
                or la.frames_decoded_total > res["frames_decoded_bound"]
                or la.frames_decoded_total >= 3 * m.frames
                or res["late_captures"]
                or uses["launches"] != uses["replays"]
                or not all(by_window[w] for w in LONG_TINY_WINDOWS)):
            raise AssertionError(f"long tiny stream: {res}")
        ex = protocol.TokenExtractor()
        ex.started = True
        codes = ex.feed_many(tokens)[:m.frames * protocol.FRAME_SIZE]
        l1, l2, l3 = protocol.deinterleave_frames(codes)
        batch = to_pcm16(torch.from_numpy(gpu.vocoder.decode_frames(
            l1, l2, l3, noise_seed=0))).numpy().astype(np.int32)
        streamed = np.frombuffer(pcm, np.int16).astype(np.int32)
        if batch.shape != streamed.shape:
            raise AssertionError(f"long tiny: batch {batch.shape} vs "
                                 f"streamed {streamed.shape}")
        diff = np.abs(batch - streamed)
        res.update(max_pcm16_diff=int(diff.max()),
                   samples_differing=int((diff > 0).sum()))
        if res["max_pcm16_diff"] > PCM16_TOL:
            raise AssertionError(f"long tiny: streamed vs batch PCM off by "
                                 f"{res['max_pcm16_diff']} LSB")
        # (2) greedy tokens, card against CPU, through the 4,096 crossing
        greedy = SamplingConfig(greedy=True, max_tokens=LONG_TINY_GREEDY,
                                token_range=audio)
        prompt = cpu.pipeline.build_prompt("long audio capacity",
                                           force_speech=True)
        t2 = time.perf_counter()
        toks = [t for c in gpu.engine.stream(prompt, greedy) for t in c]
        if len(toks) != LONG_TINY_GREEDY:
            raise AssertionError(f"long tiny greedy: {len(toks)} tokens")
        logits = _forced_logits(cpu, prompt, toks, greedy)
        best = logits.max(-1)
        picked = logits.gather(1, torch.tensor(toks)[:, None]
                               - cpu.engine.core.logits_base)[:, 0]
        steps = [i for i, (a, b) in enumerate(zip(
            (best.indices + cpu.engine.core.logits_base).tolist(), toks))
            if a != b]
        gaps = (best.values - picked)[steps].tolist()
        res.update(greedy_s=time.perf_counter() - t2,
                   greedy_compared=len(toks),
                   greedy_equal_depth=steps[0] if steps else len(toks),
                   greedy_differing_steps=steps,
                   greedy_differing_cpu_gaps=gaps)
        if any(g > GRAPH_FLIP_GAP for g in gaps):
            raise AssertionError(f"long tiny greedy: the card's token at "
                                 f"steps {steps} is not the CPU's best, "
                                 f"CPU logit gaps {gaps}")
    print(f"long[tiny] [{card_line()}]:", json.dumps(res), flush=True)
    return res


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


# ---- the tools phase: the measurement and diagnostic tools at full width ----

ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "build"
# step_bench flag sets at B 64, W 512 (bench.py's geometry): the full run
# takes bench.py's default weights; --only tools all three
STEP_BENCH = {"int8w": ["--quantize"],
              "paged_int8": ["--paged-kv", "--kv-int8"],
              "int4": ["--quantize", "--weight-bits", "4", "--paged-kv",
                       "--kv-int4"]}
STEP_KEYS = ("full_us_per_step", "matmuls_us_per_step",
             "attention_us_per_step", "head_sample_us_per_step",
             "kv_write_us_per_step", "residual_us_per_step")
# the ladder's rungs in the full run (--only tools: all five)
LADDER_RUNGS = ("bf16", "int8", "int4_g128")
# the kernels a rung must launch (K1: decode, K6: the vocoder) and must not
LADDER_KERNELS = {"bf16": ({"K1", "K6"}, {"K2", "K4"}),
                  "int8": ({"K1", "K2", "K6"}, {"K4"}),
                  "int8+kv8": ({"K1", "K2", "K6"}, {"K4"}),
                  "int4_g512": ({"K1", "K2", "K4", "K6"}, set()),
                  "int4_g128": ({"K1", "K2", "K4", "K6"}, set())}


def _check_launches(what: str, got: dict, want: dict) -> None:
    want = {k: v for k, v in want.items() if v}
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got} != {want}")


def _step_bench_launches(args, rep: dict) -> dict:
    """What each step_bench component must launch: every replay of a chain
    adds the chain's launches; the full step's first run (the capture) runs
    too. An attention kernel runs once per layer and step, the 7 linears
    of a layer once per layer and forward, the head once per forward."""
    from tts_inference_tpu_torch.config import ModelConfig

    nl, n = ModelConfig().num_hidden_layers, 7
    att = ("K5" if args.kv_int4 else "K3b" if args.kv_int8 else "K3a") \
        if args.paged_kv else "K1"
    lin = ("K4" if args.weight_bits == 4 else "K2") if args.quantize else None
    head = "K2" if args.quantize else None
    runs = (args.iters + 1) * max(args.steps // n, 1) * n   # decode steps
    want = {"full": {att: runs * nl}, "write": {}}
    if lin:
        want["full"][lin] = want["full"].get(lin, 0) + runs * 7 * nl
    if head:
        want["full"][head] = want["full"].get(head, 0) + runs
    nl_run = rep["component_layers"]
    want["matmuls"] = {lin: args.iters * args.reps * 7 * nl_run} if lin \
        else {}
    want["attention"] = {att: args.iters * max(args.reps // 8, 4) * nl_run}
    want["sample"] = {head: args.iters * max(args.reps // 4, 8)} if head \
        else {}
    return want


def step_bench_phase(name: str) -> dict:
    """``tools/step_bench.py`` at B 64, W 512 with the flags of `name`:
    every component non-null (kv_write: on a paged cache), each component's
    kernel launches exactly what its chain replays."""
    from tts_inference_tpu_torch.tools import step_bench as SB

    t0 = time.perf_counter()
    args = SB._parser().parse_args(["--batch", "64", "--window", "512",
                                    *STEP_BENCH[name]])
    rep = SB.measure(args)
    print(f"tools[step_bench {name}]:", json.dumps(rep), flush=True)
    for k in STEP_KEYS:
        if rep.get(k) is None and (args.paged_kv
                                   or k != "kv_write_us_per_step"):
            raise AssertionError(f"step_bench {name}: {k} is null")
    for comp, want in _step_bench_launches(args, rep).items():
        _check_launches(f"step_bench {name} {comp}", rep["launches"][comp],
                        want)
    gc.collect()
    torch.cuda.empty_cache()      # the engine's KV cache and graphs
    rep["wall_s"] = time.perf_counter() - t0
    print(f"tools[step_bench {name}]: {rep['wall_s']:.1f} s", flush=True)
    return rep


# kv bytes a key of one kv head costs (K and V rows together, scales
# included): bf16, int8 + two f32 scales, int4 (half a byte a value) + two
KV_BYTES_PER_KEY = {"bf16": lambda d: 4 * d, "int8": lambda d: 2 * d + 8,
                    "int4": lambda d: d + 8}
KV_KERNEL_OF = {"bf16": "K3a", "int8": "K3b", "int4": "K5"}


def kv_bench_phase() -> dict:
    """``tools/kv_kernel_bench.py`` at the 64-slot shape (B 64, W 512) and
    the long-audio one (B 4, W 12,288): K3a, K3b and K5, each timed by its
    chain's replays, beside the bound of the keys they read."""
    from tts_inference_tpu_torch.tools import kv_kernel_bench as KB

    out = {}
    for b, wb in ((64, 4), (4, 96)):
        args = KB._parser().parse_args(["--b", str(b), "--wb", str(wb)])
        rep = KB.measure(args)
        _check_launches(f"kv_kernel_bench B{b}", rep["launches"],
                        {k: KB.ITERS * args.reps
                         for k in KV_KERNEL_OF.values()})
        pos = torch.full((b,), rep["w"] - 1)
        rep["bound_us"] = {
            kind: _attention_bound(pos, args.hkv, args.g, args.d,
                                   KV_BYTES_PER_KEY[kind](args.d),
                                   2)["bound_ms"] * 1e3
            for kind in KV_KERNEL_OF}
        print(f"tools[kv_kernel_bench B{b} W{rep['w']}]:", json.dumps(rep),
              flush=True)
        out[f"B{b}_W{rep['w']}"] = rep
    return out


def vocode_bench_phase() -> dict:
    """``tools/vocode_bench.py`` at the scheduler's 64 × 16 bucket, f32 and
    bf16: 12 launches of K6 / K6-bf16 a call."""
    from tts_inference_tpu_torch.tools import vocode_bench as VB

    out = {}
    for dtype, flags, kern in (("float32", [], "K6"),
                               ("bfloat16", ["--bf16"], "K6-bf16")):
        rep = VB.measure(VB._parser().parse_args(
            ["--rows", "64", "--frames", "16", *flags]))
        print(f"tools[vocode_bench {dtype}]:", json.dumps(rep), flush=True)
        _check_launches(f"vocode_bench {dtype}", rep["launches"],
                        {kern: UNITS_PER_CALL * rep["calls"]})
        out[dtype] = rep
    return out


def ladder_phase(rungs) -> dict:
    """``tools/quant_ladder.py --full-geometry --tokens 70 --utterances
    1`` on `rungs`, each in its own process: no rung fails, each launches
    its kernels (K2 on the int8 rungs, K4 on the int4 ones) and none of
    another rung's; prints each rung's teacher-forced agreement and logit
    RMS."""
    from tts_inference_tpu_torch.tools import quant_ladder as QL

    t0 = time.perf_counter()
    out = QL.run_ladder(tiny=False, tokens=70, utterances=1, seed=0,
                        rungs=tuple((n, o) for n, o in QL.LADDER
                                    if n in rungs),
                        subprocess_rungs=True, device="cuda")
    for name, e in out["rungs"].items():
        if "error" in e:
            raise AssertionError(f"quant_ladder {name}: {e['error']}")
        must, must_not = LADDER_KERNELS[name]
        ran = set(e["launches"])
        if not must <= ran or ran & must_not:
            raise AssertionError(f"quant_ladder {name}: launches "
                                 f"{e['launches']}")
        print(f"tools[quant_ladder {name}]:", json.dumps(
            {k: v for k, v in e.items() if k != "utterances"}), flush=True)
    out["wall_s"] = time.perf_counter() - t0
    print(f"tools[quant_ladder]: {out['wall_s']:.1f} s", flush=True)
    return out


def tools_runtime_phase(rt) -> dict:
    """``compare_backends`` and ``lookahead_sweep`` on a full-width serving
    runtime (the dense phase's): the engine's greedy tokens equal the eager
    twin's, or the first differs where the twin's top-2 logit gap is
    within twice the model's own noise (``_own_noise``: the logits' change
    under a widened window and a split prefill), as the prefix reference
    bounds a flip; the lookahead sweep of 40 frames on the runtime's
    vocoder passes at lookahead 3 and 5, with MSE at 0 above MSE at 3."""
    import numpy as np

    from tts_inference_tpu_torch import protocol
    from tts_inference_tpu_torch.config import SamplingConfig
    from tts_inference_tpu_torch.ops import _build
    from tts_inference_tpu_torch.tools import compare_backends as CB
    from tts_inference_tpu_torch.tools import lookahead_sweep as LS

    t0 = time.perf_counter()
    before = _build.launch_counts()
    text, voice = "parity check", "tara"
    rep = CB.compare(rt, text, voice, 48)
    print("tools[compare_backends]:", json.dumps(
        {k: v for k, v in rep.items() if not k.endswith("_tokens")}),
        flush=True)
    if not rep["match"]:
        core = rt.engine.core
        sampling = SamplingConfig(
            greedy=True, repetition_penalty=1.0,
            token_range=(core.logits_base, rt.config.model.vocab_size))
        prompt = rt.pipeline.build_prompt(text, voice)
        eager, i = rep["eager_tokens"], rep["first_mismatch"]
        noise, _ = _own_noise(rt, [list(prompt) + eager[:i]], sampling,
                              len(prompt) // 2, False)
        gap = _top2_gap(rt, prompt, eager, i, sampling)
        rep["flip"] = {"step": i, "gap": gap, "noise": noise}
        print(f"tools[compare_backends]: first token difference at step {i}:"
              f" eager top-2 logit gap {gap}, own noise {noise} (bound "
              f"{2 * noise})", flush=True)
        if not noise <= PREFIX_NOISE_MAX or not gap <= 2 * noise:
            raise AssertionError(f"compare_backends: {rep['flip']}")
    rng = np.random.default_rng(0)
    codes = [int(rng.integers(0, rt.config.snac.codebook_size))
             + protocol.POSITION_OFFSETS[p]
             for _ in range(40) for p in range(protocol.FRAME_SIZE)]
    table = LS.sweep(rt.vocoder, codes)
    print("tools[lookahead_sweep]:", json.dumps(table), flush=True)
    if not (table[3]["pass"] and table[5]["pass"]
            and table[0]["mse"] > table[3]["mse"]):
        raise AssertionError(f"lookahead_sweep: {table}")
    res = {"compare_backends": rep, "lookahead_sweep": table,
           "launches": _build.launches_since(before),
           "wall_s": time.perf_counter() - t0}
    if not {"K1", "K6"} <= set(res["launches"]):
        raise AssertionError(f"compare_backends / lookahead_sweep: launches "
                             f"{res['launches']}")
    print(f"tools[runtime]: {res['wall_s']:.1f} s; launches",
          json.dumps(res["launches"]), flush=True)
    return res


def tools_tiny_phase() -> dict:
    """``sos_ablation`` and ``make_artifacts`` on the tiny model on the card,
    writing under ``build/tools_phase``: the ablation finds 6 frames after
    the first SOS and 3 after the last of a two-segment stream and writes
    both WAVs; the artifact gate passes."""
    import contextlib
    import io

    import numpy as np

    from tts_inference_tpu_torch import protocol as P
    from tts_inference_tpu_torch.tools import make_artifacts, sos_ablation

    root = BUILD / "tools_phase"
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)

    def frames(k):
        return [int(rng.integers(0, P.CODEBOOK_SIZE)) + P.POSITION_OFFSETS[p]
                + P.TOKEN_AUDIO_BASE for _ in range(k)
                for p in range(P.FRAME_SIZE)]

    toks = ([P.TOKEN_SOH, 100, P.TOKEN_EOT, P.TOKEN_EOH, P.TOKEN_SOS]
            + frames(3) + [P.TOKEN_DELIMITER, P.TOKEN_SOS] + frames(3)
            + [P.TOKEN_EOS])
    (root / "tokens.json").write_text(json.dumps({"token_ids": toks}))
    out = {}
    for name, main, argv in (
            ("sos_ablation", sos_ablation.main,
             ["--tokens-json", str(root / "tokens.json"), "--tiny",
              "--device", "cuda", "--out-dir", str(root / "ablation")]),
            ("make_artifacts", make_artifacts.main,
             ["--device", "cuda", "--out", str(root / "artifacts")])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        rep = json.loads(buf.getvalue()[buf.getvalue().index("{"):])
        print(f"tools[{name}]: rc {rc}", json.dumps(rep), flush=True)
        if rc != 0:
            raise AssertionError(f"{name}: rc {rc}")
        out[name] = rep
    abl = out["sos_ablation"]
    if (abl["first_sos"]["frames"], abl["last_sos"]["frames"]) != (6, 3) \
            or not all(Path(abl[s]["wav"]).is_file()
                       for s in ("first_sos", "last_sos")):
        raise AssertionError(f"sos_ablation: {abl}")
    art = out["make_artifacts"]
    if not art["passed"] or not Path(art["stream_wav"]).is_file():
        raise AssertionError(f"make_artifacts: {art}")
    return out


def tools_phase(full: bool, runtime_part=None) -> dict:
    """The measurement and diagnostic tools at full width: ``step_bench``
    (--quantize; with `full` also paged int8 and int4), ``kv_kernel_bench``
    at both shapes, ``vocode_bench`` f32 and bf16, ``quant_ladder``
    (LADDER_RUNGS; with `full` all five), ``sos_ablation`` and
    ``make_artifacts``; `runtime_part` is ``tools_runtime_phase``'s result
    (compare_backends, lookahead_sweep), run on the dense phase's runtime
    before it was freed. Prints the launches of every kernel over the
    phase (the ladder's rungs counted in their own processes)."""
    import collections

    from tts_inference_tpu_torch.ops import _build

    t0 = time.perf_counter()
    before = _build.launch_counts()
    res = {"step_bench": {name: step_bench_phase(name)
                          for name in (STEP_BENCH if full else ["int8w"])}}
    t1 = time.perf_counter()
    res["kv_kernel_bench"] = kv_bench_phase()
    res["vocode_bench"] = vocode_bench_phase()
    t2 = time.perf_counter()
    res["quant_ladder"] = ladder_phase(
        [n for n in dict(LADDER_KERNELS) if full or n in LADDER_RUNGS])
    t3 = time.perf_counter()
    res.update(tools_tiny_phase())
    launches = collections.Counter(_build.launches_since(before))
    for e in res["quant_ladder"]["rungs"].values():
        launches.update(e["launches"])
    if runtime_part is not None:
        launches.update(runtime_part["launches"])
    res["launches"] = dict(launches)
    missing = {"K1", "K2", "K3a", "K3b", "K4", "K5", "K6", "K6-bf16"} \
        - set(launches)
    if missing:
        raise AssertionError(f"tools: {sorted(missing)} never launched")
    res["wall_s"] = time.perf_counter() - t0
    print(f"tools: {res['wall_s']:.1f} s (step_bench {t1 - t0:.1f}, kv + "
          f"vocode {t2 - t1:.1f}, ladder {t3 - t2:.1f}, tiny "
          f"{time.perf_counter() - t3:.1f}); launches",
          json.dumps(res["launches"]), flush=True)
    return res


# ---- multigpu: tensor- and data-parallel serving on one card -------------------
# The card's machine has one H100, and NCCL refuses two ranks on one device:
# this phase shows the sharded path (an NCCL group of one with its
# collectives inside the captured graphs; two tp ranks sharing the card over
# gloo at full Orpheus-3B width), not a multi-GPU speed.

MG_ENGINE = dict(max_batch_size=4, max_input_len=128, max_output_len=256,
                 prefill_buckets=(128,), kv_buckets=(256,))
MG_TOKENS = 35                      # 5 frames a request
MG_DIR = Path(__file__).resolve().parent / "build" / "multigpu"


def _mg_config(**engine_over):
    """Orpheus-3B at full width with a small engine (4 slots, one prompt
    bucket, KV windows 256 and 384): the phase shows the sharded path, not
    the serve phases' geometry."""
    from tts_inference_tpu_torch.config import Config

    cfg = Config()
    return dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, **MG_ENGINE, **engine_over))


def _mg_requests(n: int = 4, max_tokens: int = MG_TOKENS, tag: str = ""):
    from tts_inference_tpu_torch import protocol
    from tts_inference_tpu_torch.config import SamplingConfig
    from tts_inference_tpu_torch.engine.scheduler import TTSRequest

    audio = (protocol.TOKEN_AUDIO_BASE,
             protocol.TOKEN_AUDIO_BASE + protocol.AUDIO_VOCAB)
    return [TTSRequest(
        text=f"Shard probe {tag}{i}: the quick brown fox jumps over it.",
        force_speech=True,
        sampling=SamplingConfig(greedy=True, max_tokens=max_tokens,
                                token_range=audio)) for i in range(n)]


def _mg_serve(sched, reqs) -> dict:
    """Step the scheduler by hand until the requests drain; each request's
    PCM (errors raise)."""
    for r in reqs:
        sched.submit(r)
    with torch.no_grad():
        for _ in range(20000):
            if not sched.step() and sched.n_queued == 0 \
                    and not sched.n_active:
                break
        else:
            raise AssertionError("multigpu: the scheduler did not drain")
    sched.drain_vocoder()
    pcm = {}
    for r in reqs:
        parts = []
        while True:
            kind, payload = r.events.get(timeout=120)
            if kind == "chunk":
                parts.append(payload.pcm)
            elif kind == "done":
                break
            else:
                raise AssertionError(f"{r.text}: {payload}")
        pcm[r.text] = b"".join(parts)
    return pcm


def _mg_graph_run(rt, cfg, params=None, mesh=None) -> dict:
    """Four greedy requests through a scheduler over `params` (a mesh
    rank's shard) or the runtime's: engine graphs captured at warmup, then
    served with every launch counted."""
    from tts_inference_tpu_torch.ops import _build

    finished = {}
    sched = _recording_scheduler(rt, cfg, finished, params=params,
                                 mesh=mesh)
    core = sched.core
    t0 = time.perf_counter()
    core.warmup_graphs(admission_ns=[sched.admission_steps,
                                     cfg.engine.decode_steps_per_call])
    warm = time.perf_counter() - t0
    census = dict(core.graph_census_ms)
    launches, replays = dict(core.launches), dict(core.replays)
    before = _build.launch_counts()
    _mg_serve(sched, _mg_requests())
    sched.stop()
    served = {k: core.launches[k] - launches.get(k, 0)
              for k in core.launches}
    replayed = {k: core.replays[k] - replays.get(k, 0) for k in core.replays}
    return {"tokens": finished, "census": census, "warmup_s": warm,
            "late_captures": core.late_captures, "served": served,
            "replayed": replayed, "kernels": _build.launches_since(before)}


def nccl_one_phase(rt, cfg) -> dict:
    """The sharded path on an NCCL group of one on cuda:0, Mesh(tp=1,
    dp=1) passed explicitly, so every collective (the row sums, the
    masked-embedding sum, the logits' and the token rows' gathers) is a real
    NCCL call: a --quantize scheduler captures its graphs at warmup with the
    collectives inside, serves four requests with every launch a replay and
    no capture, and its greedy tokens equal the plain core's (same card,
    same weights, graphs too)."""
    import torch.distributed as dist

    from tts_inference_tpu_torch import weights
    from tts_inference_tpu_torch.config import MeshConfig
    from tts_inference_tpu_torch.parallel import mesh as M
    from tts_inference_tpu_torch.parallel.multihost import init_multihost

    t0 = time.perf_counter()
    plain = _mg_graph_run(rt, cfg)
    dev = init_multihost(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda:0",
                         timeout_s=120)
    try:
        mesh = M.make_mesh(MeshConfig(dp=1, tp=1), device=dev)
        if mesh.backend != "nccl":
            raise AssertionError(f"multigpu[nccl]: backend {mesh.backend}")
        shard = weights.shard_params(rt.engine.core.params, cfg.model, mesh)
        got = _mg_graph_run(rt, cfg, params=shard, mesh=mesh)
        del shard
        train = _nccl_train_leg(mesh)
    finally:
        dist.destroy_process_group()
    res = {"graphs_captured": len(got["census"]),
           "capture_s": round(sum(got["census"].values()) / 1e3, 3),
           "plain_graphs": len(plain["census"]), "warmup_s": got["warmup_s"],
           "late_captures": got["late_captures"], "launches": got["served"],
           "replays": got["replayed"], "kernels": got["kernels"],
           "train": train, "wall_s": time.perf_counter() - t0}
    print(f"multigpu[nccl group of one] [{card_line()}]:", json.dumps(res),
          flush=True)
    print("multigpu[nccl] census (ms):", json.dumps(got["census"]),
          flush=True)
    if got["late_captures"] or got["served"] != got["replayed"] \
            or not got["served"].get("decode"):
        raise AssertionError(f"multigpu[nccl]: a launch was not a replay of "
                             f"a warmup graph: {res}")
    if not {"K1", "K2"} <= set(got["kernels"]):
        raise AssertionError(f"multigpu[nccl]: kernels {got['kernels']}")
    if got["tokens"] != plain["tokens"]:
        raise AssertionError("multigpu[nccl]: greedy tokens differ from the "
                             "plain core's")
    return res


def _tiny_lora_steps(base, cfg, mesh=None, steps: int = 3):
    """`steps` LoRA steps (r 4, lr 1e-3) of a model of `cfg` over `base`
    (cut to `mesh` when given) on one batch of 2 × 64 tokens from seed 0:
    each step's loss and the final adapters (whole)."""
    import numpy as np

    from tts_inference_tpu_torch import weights
    from tts_inference_tpu_torch.training import lora as L
    from tts_inference_tpu_torch.training import train_step as T

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    lens = np.array([64, 50], np.int32)
    dev = T.tree_leaves(base)[0].device
    if mesh is not None:
        base = weights.shard_params(base, cfg, mesh)
    lora = L.init_lora(torch.Generator(device=dev).manual_seed(1), cfg, base,
                       r=4, mesh=mesh)
    opt = T.make_optimizer(1e-3, steps)
    step = T.make_train_step(cfg, opt, base_params=base, mesh=mesh)
    state = T.init_train_state(lora, opt)
    losses = [float(step(state, tokens, lens)[1]) for _ in range(steps)]
    out = state.params
    if mesh is not None:
        with torch.no_grad():
            out = weights.gather_lora(out, cfg, mesh)
    return losses, [x.detach() for x in T.tree_leaves(out)]


def _nccl_train_leg(mesh) -> dict:
    """Three LoRA steps of the tiny model in f32 through the mesh code path
    on the NCCL group of one (every dp and tp sum, the vocab-parallel
    loss's max and sums, a real NCCL call) against the one-process step:
    each step's loss within 1e-5 relative, the adapters after step 3
    within 1e-5."""
    from tts_inference_tpu_torch import weights
    from tts_inference_tpu_torch.config import tiny_config

    cfg = dataclasses.replace(tiny_config().model, dtype="float32")
    base = weights.init_llama_params(cfg, 0, mesh.device)
    plain, plain_ad = _tiny_lora_steps(base, cfg)
    got, got_ad = _tiny_lora_steps(base, cfg, mesh)
    res = {"losses": got, "plain_losses": plain,
           "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(got, plain)),
           "adapter_max_diff": max(float((a - b).abs().max())
                                   for a, b in zip(got_ad, plain_ad))}
    if not (res["loss_rel"] <= 1e-5 and res["adapter_max_diff"] <= 1e-5
            and len(got_ad) == len(plain_ad) and got[-1] < got[0]):
        raise AssertionError(f"multigpu[nccl train]: {res}")
    return res


def _stop_follower(socks) -> None:
    """End the followers' replay of one core without closing the channel
    (the next run replays into a new core)."""
    import pickle

    from tts_inference_tpu_torch.parallel import lockstep as LS

    for s in socks:
        LS._send(s, pickle.dumps((LS._STOP, (), {})))


MG_RUNS = (("dense", {}),
           ("paged_int8", {"paged_kv": True, "kv_cache_int8": True,
                           "kv_block_size": 128}))
# the two-rank serve runs' streams (4 before PR 16, which added legs to the
# phase; cut to keep the whole run inside its time limit)
MG_REQUESTS = 1
MG_GEN_TEXT = "Mirror probe: the quick brown fox jumps over the lazy dog."
# the training legs: train_step.CARD_*'s step, MG_TRAIN_STEPS times on one
# batch, tp 2 and dp 2 over the two ranks
MG_TRAIN_LR, MG_TRAIN_STEPS = 1e-3, 2
MG_TRAIN_MESHES = (("tp2", 1, 2), ("dp2", 2, 1))
# a loss known to one rounding step of bf16 (2^-8 relative) passes
BF16_STEP = 2.0 ** -8


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def _rel(got, want) -> float:
    """||got − want|| / ||want|| over the leaves of two trees, in f32."""
    from tts_inference_tpu_torch.training.train_step import tree_leaves

    num = den = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        num += float((a.float() - b.float()).pow(2).sum())
        den += float(b.float().pow(2).sum())
    return (num / den) ** 0.5 if den else float(num > 0)


def _mg_train_batch(cfg):
    """The training batch of train_step.CARD_*'s shape: CARD_BATCH rows of
    CARD_LEN tokens from seed 7, the second row 3/4 long."""
    import numpy as np

    from tts_inference_tpu_torch.training import train_step as T

    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.model.vocab_size,
                          size=(T.CARD_BATCH, T.CARD_LEN)).astype(np.int32)
    lens = np.full((T.CARD_BATCH,), T.CARD_LEN, np.int32)
    lens[1] = T.CARD_LEN * 3 // 4
    return tokens, lens


def _mg_lora(base, cfg, mesh=None):
    """(adapters, train step) of train_step.CARD_*'s LoRA (bf16, r 16,
    α 32 on the 7 targets, adapters from seed 1) over `base` (this rank's
    shard under `mesh`)."""
    from tts_inference_tpu_torch.training import lora as L
    from tts_inference_tpu_torch.training import train_step as T

    dev = T.tree_leaves(base)[0].device
    r, alpha = T.CARD_LORA_R, T.CARD_LORA_ALPHA
    lora = L.init_lora(torch.Generator(device=dev).manual_seed(1), cfg.model,
                       base, r=r, alpha=alpha, mesh=mesh)
    opt = T.make_optimizer(MG_TRAIN_LR, MG_TRAIN_STEPS)
    step = T.make_train_step(cfg.model, opt, base_params=base,
                             lora_scale=L.lora_scale(r, alpha), mesh=mesh)
    return T.init_train_state(lora, opt), step


def _mg_train(base, cfg, mesh=None) -> dict:
    """MG_TRAIN_STEPS steps of ``_mg_lora`` on the one batch: each step's
    loss, ms, gradients (this rank's, after the step's sums; on the host)
    and collective calls (every torch.distributed.all_reduce, counted where
    it is called), and the peak memory."""
    import torch.distributed as dist

    dev = mesh.device if mesh is not None else torch.device("cuda")
    tokens, lens = _mg_train_batch(cfg)
    state, step = _mg_lora(base, cfg, mesh)
    calls = [0]
    real = dist.all_reduce

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    out = {"losses": [], "ms": [], "grads": [], "sums": []}
    torch.cuda.reset_peak_memory_stats(dev)
    dist.all_reduce = counted
    try:
        for _ in range(MG_TRAIN_STEPS):
            calls[0] = 0
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, loss = step(state, tokens, lens)
            out["losses"].append(float(loss))
            torch.cuda.synchronize(dev)
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["sums"].append(calls[0])
            out["grads"].append(_map_tree(
                lambda x: x.grad.detach().to("cpu", copy=True),
                state.params))
    finally:
        dist.all_reduce = real
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def _mg_train_rank(out: dict, cfg, dev) -> None:
    """The training legs on a rank: the bf16 Orpheus-3B weights made from
    seed 0 on the card, then MG_TRAIN_MESHES (tp 2: this rank's shard; dp
    2: the whole model and one row of the batch), each step's loss and
    gradients held to the one-process step's (MG_DIR / "train_ref.pt",
    cut to this rank's shard)."""
    from tts_inference_tpu_torch import weights
    from tts_inference_tpu_torch.config import MeshConfig
    from tts_inference_tpu_torch.parallel import mesh as M

    ref = torch.load(MG_DIR / "train_ref.pt")
    for name, dp, tp in MG_TRAIN_MESHES:
        mesh = M.make_mesh(MeshConfig(dp=dp, tp=tp), device=dev)
        base = weights.shard_params(weights.init_llama_params(
            cfg.model, 0, dev), cfg.model, mesh)
        got = _mg_train(base, cfg, mesh)
        del base
        want = [weights.shard_lora(_map_tree(lambda x: x.to(dev), g),
                                   cfg.model, mesh) for g in ref["grads"]]
        out["train_" + name] = {
            "losses": got["losses"], "ms": got["ms"], "sums": got["sums"],
            "peak_memory_bytes": got["peak_memory_bytes"],
            "loss_rel": [abs(a - b) / b for a, b in zip(got["losses"],
                                                          ref["losses"])],
            "grad_rel": [_rel(_map_tree(lambda x: x.to(dev), g), w)
                         for g, w in zip(got["grads"], want)]}
        del got, want
        torch.cuda.empty_cache()


def _mg_generate(rt, socks=None) -> dict:
    """The single-stream engine of `rt` (a mesh rank's runtime: its core
    mirrored over `socks`) generating MG_GEN_TEXT greedily, as ``cli
    generate`` does: the stream's tokens and PCM."""
    from tts_inference_tpu_torch.parallel import lockstep as LS

    req = _mg_requests(1, tag="gen")[0]
    eng = rt.engine
    toks = []
    stream = eng.stream

    def recording(*a, **k):
        for chunk in stream(*a, **k):
            toks.extend(chunk)
            yield chunk

    eng.stream = recording
    core = eng.core
    if socks is not None:
        eng.core = LS.MirroredCore(core, socks)
    try:
        t0 = time.perf_counter()
        with torch.no_grad():
            pcm, metrics = rt.pipeline.synthesize(
                MG_GEN_TEXT, sampling=req.sampling, force_speech=True)
        wall = time.perf_counter() - t0
    finally:
        eng.stream, eng.core = stream, core
    return {"tokens": toks, "pcm": pcm, "wall_s": wall,
            "ttfa_ms": metrics.ttfa_ms}


def _tp_rank(rank: int, port: int, lport: int) -> None:
    """One of two ranks sharing cuda:0 over gloo, at full width: the
    training legs (``_mg_train_rank``); then, on a tp-2 mesh, the runtime
    a sharded ``cli generate`` builds (int8 weights made from the seed on
    the card, cut to this rank's shard): rank 0 serves MG_REQUESTS greedy
    requests per MG_RUNS configuration through a mirrored, eager scheduler
    and runs the single-stream engine through the mirror, rank 1 replays;
    int4 weights at group 512 (o cut at the split group 256) serve as many
    the same way; then rank 0 kills rank 1 in the
    middle of a stream. Each rank writes its results under MG_DIR."""
    import os
    import signal

    from tts_inference_tpu_torch import weights
    from tts_inference_tpu_torch.config import MeshConfig
    from tts_inference_tpu_torch.engine.engine import EngineCore
    from tts_inference_tpu_torch.models.quant import quantize_llama_params
    from tts_inference_tpu_torch.ops import _build
    from tts_inference_tpu_torch.parallel import lockstep as LS
    from tts_inference_tpu_torch.parallel import mesh as M
    from tts_inference_tpu_torch.parallel.multihost import init_multihost
    from tts_inference_tpu_torch.runtime import Runtime

    t0 = time.perf_counter()
    out = {"rank": rank, "pid": os.getpid()}
    (MG_DIR / f"rank{rank}.pid").write_text(str(os.getpid()))
    dev = init_multihost(f"127.0.0.1:{port}", 2, rank, device="cuda:0",
                         backend="gloo", timeout_s=120)
    cfg = _mg_config()
    t1 = time.perf_counter()
    _mg_train_rank(out, cfg, dev)
    out["train_s"] = time.perf_counter() - t1
    mesh = M.make_mesh(MeshConfig(dp=1, tp=2), device=dev)
    t1 = time.perf_counter()
    rt = Runtime.create(cfg, seed=0, device=dev, quantize=True, mesh=mesh)
    shard = rt.engine.core.params
    lp = shard["layers"][0]
    out["shapes"] = {k: list(lp[k].w_i8.shape) for k in
                     ("wq", "wk", "wo", "w_gate", "w_down")}
    out["shapes"]["embed"] = list(shard["embed"].w_i8.shape)
    out["boot_s"] = time.perf_counter() - t1

    def int4_shard():
        full = quantize_llama_params(weights.init_llama_params(
            cfg.model, 0, dev), bits=4, free_source=True)
        sh = weights.shard_params(full, cfg.model, mesh)
        out["i4_groups"] = {k: sh["layers"][0][k].w_p.shape[0] * 2
                            // sh["layers"][0][k].scale.shape[0]
                            for k in ("wq", "wo", "w_down")}
        return sh

    runs = MG_RUNS + (("int4", {}),)
    if rank == 1:
        sock = LS.follower_channel("127.0.0.1", lport, process_id=1)
        for name, over in runs[:1] + (("generate", {}),) + runs[1:] \
                + (("kill", {}),):
            params = shard
            if name == "int4":
                params = int4_shard()
            before = _build.launch_counts()
            if name == "generate":
                n = LS.follower_loop(rt.engine.core, sock)
            else:
                c = dataclasses.replace(cfg, engine=dataclasses.replace(
                    cfg.engine, **over))
                core = EngineCore(params, c.model, c.engine, device=dev,
                                  mesh=mesh, graphs=False)
                n = LS.follower_loop(core, sock)
                del core
            out[name] = {"replayed": n,
                         "kernels": _build.launches_since(before)}
            out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
            (MG_DIR / "rank1.json").write_text(json.dumps(out))
        return
    socks = LS.coordinator_channel(lport, 1)
    for name, over in runs[:1] + (("generate", {}),) + runs[1:]:
        before = _build.launch_counts()
        t1 = time.perf_counter()
        if name == "generate":
            gen = _mg_generate(rt, socks)
            out[name] = {"tokens": gen["tokens"], "wall_s": gen["wall_s"],
                         "ttfa_ms": gen["ttfa_ms"],
                         "kernels": _build.launches_since(before),
                         "pcm": _pcm_vs_whole(rt, gen["pcm"], gen["tokens"])}
            _stop_follower(socks)
            continue
        c = dataclasses.replace(cfg, engine=dataclasses.replace(
            cfg.engine, **over))
        params = int4_shard() if name == "int4" else shard
        finished = {}
        sched = _recording_scheduler(
            rt, c, finished, params=params, mesh=mesh, graphs=False,
            wrap_core=lambda core: LS.MirroredCore(core, socks))
        pcm = _mg_serve(sched, _mg_requests(MG_REQUESTS, tag=name))
        sched.stop()
        out[name] = {"tokens": finished, "serve_s": time.perf_counter() - t1,
                     "kernels": _build.launches_since(before),
                     "pcm": {k: _pcm_vs_whole(rt, v, finished[k])
                             for k, v in pcm.items()}}
        _stop_follower(socks)
    # a follower lost mid-stream: the stream ends with "engine down"
    sched = _recording_scheduler(
        rt, cfg, {}, params=shard, mesh=mesh, graphs=False,
        wrap_core=lambda core: LS.MirroredCore(core, socks))
    req = _mg_requests(1, 250, "kill")[0]
    sched.submit(req)
    sched.start()
    events, t1, killed = [], time.perf_counter(), False
    while time.perf_counter() - t1 < 120:
        kind, payload = req.events.get(timeout=120)
        events.append(kind)
        if kind == "chunk" and not killed:
            os.kill(int((MG_DIR / "rank1.pid").read_text()), signal.SIGKILL)
            killed = True
        if kind in ("done", "error"):
            out["kill"] = {"last": [kind, str(payload)[:200]],
                           "chunks": events.count("chunk"),
                           "fatal": sched.fatal,
                           "seconds": time.perf_counter() - t1}
            break
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["wall_s"] = time.perf_counter() - t0
    (MG_DIR / "rank0.json").write_text(json.dumps(out))
    # the group lost a member: leave without tearing it down
    os._exit(0)


def _pcm_vs_whole(rt, pcm: bytes, tokens) -> dict:
    """A stream's served PCM against one whole decode of its tokens."""
    import numpy as np

    from tts_inference_tpu_torch import protocol
    from tts_inference_tpu_torch.models.snac import to_pcm16

    ex = protocol.TokenExtractor()
    ex.started = True
    l1, l2, l3 = protocol.deinterleave_frames(ex.feed_many(tokens))
    whole = to_pcm16(torch.from_numpy(rt.vocoder.decode_frames(
        l1, l2, l3, noise_seed=0))).numpy().astype(np.int32)
    got = np.frombuffer(pcm, np.int16).astype(np.int32)
    if got.shape != whole.shape:
        return {"samples": int(got.size), "whole": int(whole.size),
                "max_pcm16_diff": None}
    return {"samples": int(got.size),
            "max_pcm16_diff": int(np.abs(got - whole).max())}


def _mg_train_ref(cfg) -> dict:
    """The one-process training steps the ranks are held to, on this
    process: ``_mg_train`` over the whole bf16 model from seed 0, its
    losses and gradients saved to MG_DIR / "train_ref.pt" for the ranks;
    and the same steps in f32 over the same weights (the bf16 values): the
    bf16 step's own error at each step, |Δloss| / loss and ``_rel`` of the
    gradients against f32."""
    from tts_inference_tpu_torch import weights

    base = weights.init_llama_params(cfg.model, 0, "cuda")
    ref = _mg_train(base, cfg)
    torch.save({"losses": ref["losses"], "grads": ref["grads"]},
               MG_DIR / "train_ref.pt")
    f32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32"))
    base = _map_tree(lambda x: x.float(), base)
    exact = _mg_train(base, f32)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": ref["losses"], "ms": ref["ms"],
            "peak_memory_gb": round(ref["peak_memory_bytes"] / 1e9, 3),
            "f32_losses": exact["losses"],
            "f32_peak_memory_gb": round(exact["peak_memory_bytes"] / 1e9, 3),
            "own_error": {
                "loss": [abs(a - b) / b for a, b in zip(ref["losses"],
                                                        exact["losses"])],
                "grads": [_rel(a, b) for a, b in zip(ref["grads"],
                                                     exact["grads"])]}}


def _f32_twin(rt):
    """`rt`'s model with f32 activations over the same weights (quantized
    leaves as they are, the rest upcast), as ``_allowed_logits`` reads a
    runtime: what a bf16 model's own rounding error is measured against."""
    from types import SimpleNamespace

    from tts_inference_tpu_torch.models.quant import (QuantEmbed,
                                                      QuantLinear,
                                                      QuantLinearI4)

    def up(x):
        return x if isinstance(x, (QuantEmbed, QuantLinear,
                                   QuantLinearI4)) else x.float()

    core = rt.engine.core
    params = {k: [{n: up(w) for n, w in lp.items()} for lp in v]
              if k == "layers" else up(v) for k, v in core.params.items()}
    cfg = dataclasses.replace(rt.config, model=dataclasses.replace(
        rt.config.model, dtype="float32"))
    return dataclasses.replace(rt, config=cfg, engine=SimpleNamespace(
        core=SimpleNamespace(params=params, device=core.device,
                             max_seq=core.max_seq,
                             logits_base=core.logits_base)))


def _mg_flips(rt, c, got: dict, plain: dict, what: str) -> list:
    """Each stream of `got` whose tokens leave `plain`'s: its first flip
    step, the top-2 gap there and the model's own noise (on `rt`'s weights,
    configuration `c`): the larger of ``_own_noise``'s two no-ops and the
    bf16 model's error against its f32 twin at that step (``_f32_twin``:
    the sharded and the one-process logits are two bf16 roundings of the
    f32 ones). Raises unless the gap is within twice the noise."""
    from tts_inference_tpu_torch.config import SamplingConfig

    sampling = SamplingConfig(greedy=True, max_tokens=MG_TOKENS,
                              token_range=_mg_requests(1)[0]
                              .sampling.token_range)
    shim = dataclasses.replace(rt, config=c)
    twin = _f32_twin(shim)
    flips = []
    for text, toks in got.items():
        w = plain[text]
        if toks == w:
            continue
        i = next((k for k, (a, b) in enumerate(zip(toks, w)) if a != b),
                 min(len(toks), len(w)))
        prompt = rt.pipeline.build_prompt(text, force_speech=True)
        noise, _ = _own_noise(shim, [list(prompt) + w[:i]], sampling,
                              len(prompt) // 2, False)
        a = _allowed_logits(shim, prompt, w, i, sampling)
        ok = torch.isfinite(a)
        err = float((a - _allowed_logits(twin, prompt, w, i, sampling))[ok]
                    .abs().max())
        gap = _top2_gap(shim, prompt, w, i, sampling)
        flips.append({"step": i, "gap": gap, "noise": noise,
                      "f32_error": err})
        if not noise <= PREFIX_NOISE_MAX or not gap <= 2 * max(noise, err):
            raise AssertionError(f"multigpu[{what}]: {text}: tokens differ "
                                 f"at step {i}, top-2 gap {gap}, own noise "
                                 f"{noise}, bf16 error against f32 {err}")
    return flips


def two_rank_phase(rt, cfg) -> dict:
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    device), eager (gloo cannot be captured), at full width.

    Training: the step of train_step.CARD_* (bf16, B 2 × 512, LoRA r 16
    α 32 on the 7 targets, lr MG_TRAIN_LR) MG_TRAIN_STEPS times on one
    batch at tp 2 and at dp 2, held to the one-process bf16 steps (this
    process, same weights, adapters and batch) within twice the bf16
    step's own error — its distance from the same steps in f32 — at each
    step: the sharded and the one-process step are two bf16 roundings of
    the same f32 step, so each is that far from it and they are at most
    twice that apart. Each rank's loss (or within one bf16 step, 2^-8) and
    its gradients (this rank's block, after the step's sums); the later
    steps' errors include Adam's, which steps a gradient at rounding level
    by its noise's sign, on both sides. The loss falls. Step ms,
    all_reduce calls a step and peak memory a rank.

    Serving, on the tp-2 runtime a sharded ``cli generate`` builds: the
    kernels at the shard shapes no other phase launches (12 query / 4 kv
    heads a rank; q 3072→1536, kv 3072→512, o 1536→3072, gate/up
    3072→4096, down 4096→3072; the 14,470-row head shard), dense and paged
    int8 through the mirrored scheduler, int4 weights at group 512 (o's
    rows at the split group 256), and the single-stream engine through the
    mirror. Rank 0's greedy tokens equal the unsharded engine's (this
    process, same weights) up to a first flip whose top-2 logit gap is
    within twice the model's own noise (``_mg_flips``: the bf16
    row-parallel sums add in another order); its PCM equals the whole decode of its tokens within
    PCM16_TOL; K1 (dense, generate, int4) or K3b (paged), K2, and K4 (int4)
    launch on both ranks; killing rank 1 mid-stream ends rank 0's stream
    with "engine down"."""
    import multiprocessing as mp

    from tts_inference_tpu_torch.runtime import Runtime

    t0 = time.perf_counter()
    MG_DIR.mkdir(parents=True, exist_ok=True)
    for f in MG_DIR.glob("rank*"):
        f.unlink()
    train_ref = _mg_train_ref(cfg)
    print("multigpu[train, one process]:", json.dumps(train_ref), flush=True)
    ctx = mp.get_context("spawn")
    port, lport = _free_port(), _free_port()
    procs = [ctx.Process(target=_tp_rank, args=(r, port, lport))
             for r in range(2)]
    for p in procs:
        p.start()
    # the unsharded references, on this process, while the ranks run
    refs = {}
    for name, over in MG_RUNS:
        c = dataclasses.replace(cfg, engine=dataclasses.replace(
            cfg.engine, **over))
        finished = {}
        sched = _recording_scheduler(rt, c, finished, graphs=False)
        _mg_serve(sched, _mg_requests(MG_REQUESTS, tag=name))
        sched.stop()
        refs[name] = (c, finished)
    gen_ref = _mg_generate(rt)
    rt4 = {"rt": Runtime.create(cfg, seed=0, device="cuda", quantize=True,
                                weight_bits=4)}
    finished = {}
    sched = _recording_scheduler(rt4["rt"], cfg, finished, graphs=False)
    _mg_serve(sched, _mg_requests(MG_REQUESTS, tag="int4"))
    sched.stop()
    refs["int4"] = (cfg, finished)
    for p in procs:
        p.join(timeout=900)
    for p in procs:
        if p.is_alive():
            p.kill()
            raise AssertionError("multigpu[two ranks]: a rank hung")
    if procs[0].exitcode != 0 or procs[1].exitcode != -9:
        raise AssertionError(f"multigpu[two ranks]: rank exit codes "
                             f"{[p.exitcode for p in procs]} (want 0, -9)")
    r0, r1 = (json.loads((MG_DIR / f"rank{r}.json").read_text())
              for r in range(2))
    want = {"wq": [3072, 1536], "wk": [3072, 512], "wo": [1536, 3072],
            "w_gate": [3072, 4096], "w_down": [4096, 3072],
            "embed": [78470, 3072]}
    if r0["shapes"] != want or r1["shapes"] != want:
        raise AssertionError(f"multigpu: shard shapes {r0['shapes']}")
    if r0["i4_groups"] != {"wq": 512, "wo": 256, "w_down": 512}:
        raise AssertionError(f"multigpu[int4]: groups {r0['i4_groups']}")
    res = {"peak_memory_gb": [round(r["peak_memory_bytes"] / 1e9, 3)
                              for r in (r0, r1)],
           "boot_s": [round(r["boot_s"], 1) for r in (r0, r1)],
           "train_s": [round(r["train_s"], 1) for r in (r0, r1)],
           "train_reference": train_ref}
    own = train_ref["own_error"]
    bad = []
    for leg, _, _ in MG_TRAIN_MESHES:
        rows = [r["train_" + leg] for r in (r0, r1)]
        res["train_" + leg] = {
            "losses": rows[0]["losses"], "ms": [r["ms"] for r in rows],
            "all_reduce_calls": [r["sums"] for r in rows],
            "peak_memory_gb": [round(r["peak_memory_bytes"] / 1e9, 3)
                               for r in rows],
            "loss_rel": [r["loss_rel"] for r in rows],
            "grad_rel": [r["grad_rel"] for r in rows]}
        for who, row in zip(("rank0", "rank1"), rows):
            ok = row["losses"][-1] < row["losses"][0] and all(
                lr <= max(2 * le, BF16_STEP) and gr <= 2 * ge
                for lr, gr, le, ge in zip(row["loss_rel"], row["grad_rel"],
                                          own["loss"], own["grads"]))
            if not ok:
                bad.append(f"train {leg} {who}")
    print(f"multigpu[train, two ranks on one card, gloo] [{card_line()}]:",
          json.dumps({k: res[k] for k in res if k.startswith("train")}),
          flush=True)
    if bad:
        raise AssertionError(f"multigpu: {bad} beyond twice the bf16 "
                             f"step's own error {own}")
    for name in [n for n, _ in MG_RUNS] + ["int4"]:
        c, plain = refs[name]
        attn = "K3b" if name == "paged_int8" else "K1"
        mm = {"K2", "K4"} if name == "int4" else {"K2"}
        for who, r in (("rank0", r0), ("rank1", r1)):
            if not all(r[name]["kernels"].get(k) for k in {attn, *mm}):
                raise AssertionError(f"multigpu[{name}]: {who} launched "
                                     f"{r[name]['kernels']}")
        flips = _mg_flips(rt4["rt"] if name == "int4" else rt, c,
                          r0[name]["tokens"], plain, name)
        pcm = r0[name]["pcm"]
        worst = [v["max_pcm16_diff"] for v in pcm.values()]
        if None in worst or max(worst) > PCM16_TOL:
            raise AssertionError(f"multigpu[{name}]: served PCM vs whole "
                                 f"decode {pcm}")
        res[name] = {"equal_streams": len(plain) - len(flips),
                     "flips": flips, "serve_s": r0[name]["serve_s"],
                     "max_pcm16_diff": max(worst),
                     "kernels_rank0": r0[name]["kernels"],
                     "kernels_rank1": r1[name]["kernels"]}
    _free(rt4)
    gen = r0["generate"]
    for who, r in (("rank0", r0), ("rank1", r1)):
        if not (r["generate"]["kernels"].get("K1")
                and r["generate"]["kernels"].get("K2")):
            raise AssertionError(f"multigpu[generate]: {who} launched "
                                 f"{r['generate']['kernels']}")
    flips = _mg_flips(rt, cfg, {MG_GEN_TEXT: gen["tokens"]},
                      {MG_GEN_TEXT: gen_ref["tokens"]}, "generate")
    if gen["pcm"]["max_pcm16_diff"] is None \
            or gen["pcm"]["max_pcm16_diff"] > PCM16_TOL \
            or len(gen["tokens"]) != MG_TOKENS:
        raise AssertionError(f"multigpu[generate]: {len(gen['tokens'])} "
                             f"tokens, PCM vs whole decode {gen['pcm']}")
    res["generate"] = {"equal": not flips, "flips": flips,
                       "wall_s": gen["wall_s"], "ttfa_ms": gen["ttfa_ms"],
                       "max_pcm16_diff": gen["pcm"]["max_pcm16_diff"],
                       "kernels_rank0": gen["kernels"],
                       "kernels_rank1": r1["generate"]["kernels"]}
    kill = r0["kill"]
    res["kill"] = kill
    if kill["last"][0] != "error" or "engine down" not in kill["last"][1] \
            or not kill["fatal"]:
        raise AssertionError(f"multigpu[kill]: {kill}")
    res["wall_s"] = time.perf_counter() - t0
    print(f"multigpu[two ranks on one card, gloo] [{card_line()}]:",
          json.dumps(res), flush=True)
    return res


def lockstep_overhead_phase() -> dict:
    """``tools/lockstep_overhead.py`` at full width on the card: the µs the
    mirror adds under its lock per decode launch, and the interleaved A/B
    of a plain core against a MirroredCore (the follower a drained
    socketpair)."""
    import contextlib
    import io

    from tts_inference_tpu_torch.tools import lockstep_overhead as LO

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = LO.main(["--iters", "25"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"multigpu[lockstep_overhead] [{card_line()}]:", json.dumps(line),
          flush=True)
    if rc != 0 or not line["mirror_cost_us_per_call"] > 0:
        raise AssertionError(f"lockstep_overhead: rc {rc}, {line}")
    return line


def multigpu_phase() -> dict:
    """The sharded path on the one card: an NCCL group of one (serving and
    training), two ranks over gloo (training at tp 2 and dp 2; serving
    int8 and int4, and generating, at tp 2), the cost of the lockstep
    mirror. The card count stays 1; no number here is a multi-GPU
    speed."""
    from tts_inference_tpu_torch.runtime import Runtime

    t0 = time.perf_counter()
    cfg = _mg_config()
    rt = {"rt": Runtime.create(cfg, seed=0, device="cuda", quantize=True)}
    res = {"nccl": nccl_one_phase(rt["rt"], cfg),
           "two_ranks": two_rank_phase(rt["rt"], cfg)}
    _free(rt)
    res["lockstep_overhead"] = lockstep_overhead_phase()
    res["wall_s"] = time.perf_counter() - t0
    print(f"multigpu: {res['wall_s']:.1f} s", flush=True)
    return res


# ---- the deploy phase: the launcher, its router and the TTFA anatomy -------

DEPLOY_DIR = BUILD / "deploy_phase"
DEPLOY_ARGS = ("--ready-timeout-s", "300", "--health-interval", "1",
               "--drain-s", "60")
DEPLOY_DRAIN_S = 60.0


def _free_port_block(n: int) -> int:
    """A port p with p .. p + n free (the replicas take port + 1 ..)."""
    import socket

    for _ in range(50):
        p = _free_port()
        if p + n >= 65535:
            continue
        try:
            for q in range(p + 1, p + n + 1):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", q))
            return p
        except OSError:
            continue
    raise RuntimeError("no free block of ports")


def _children(ppid: int) -> dict:
    """pid → argv of the live processes whose parent is `ppid`."""
    out = {}
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            stat = (d / "stat").read_text().rsplit(")", 1)[1].split()
            if int(stat[1]) != ppid or stat[0] == "Z":
                continue
            argv = (d / "cmdline").read_bytes().split(b"\0")
        except (OSError, ValueError, IndexError):
            continue
        out[int(d.name)] = [a.decode() for a in argv if a]
    return out


def _pid_gone(pid: int) -> bool:
    """The process exited (gone, or a zombie its parent has not reaped)."""
    try:
        return Path(f"/proc/{pid}/stat").read_text().rsplit(
            ")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def _on_port(kids: dict, port: int) -> int:
    """The child whose argv carries ``--port <port>``."""
    (pid,) = [p for p, a in kids.items()
              if "--port" in a and a[a.index("--port") + 1] == str(port)]
    return pid


def _compute_apps() -> list:
    """(pid, "N MiB") of each process ``nvidia-smi --query-compute-apps``
    lists on the card."""
    res = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv"], capture_output=True, text=True, check=True)
    return [(int(pid), mem.strip()) for pid, mem in (
        line.split(",") for line in res.stdout.strip().splitlines()[1:])]


def _listed(pid: int, apps: list) -> bool:
    return any(p == pid for p, _ in apps)


def _get_json(url: str, timeout: float = 5.0):
    """(status, JSON body) of a GET; (None, None) when nothing answers."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, None
    except OSError:
        return None, None


def _await(pred, proc, timeout: float, what: str, log: Path):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        if proc.poll() is not None:
            raise AssertionError(f"deploy: the launcher exited rc "
                                 f"{proc.returncode} while waiting for "
                                 f"{what}:\n{log.read_text()[-4000:]}")
        time.sleep(0.2)
    raise AssertionError(f"deploy: no {what} in {timeout:.0f} s:\n"
                         f"{log.read_text()[-4000:]}")


def _launch(argv, log: Path):
    """``deploy.launch`` in a session of its own (its children share its
    process group), output to `log`."""
    return subprocess.Popen(
        [sys.executable, "-m", "tts_inference_tpu_torch.deploy.launch",
         *argv], cwd=ROOT, stdout=open(log, "w"), stderr=subprocess.STDOUT,
        start_new_session=True)


def _drain(proc, log: Path, timeout: float) -> tuple:
    """SIGTERM the launcher: (rc, seconds to exit, its last line)."""
    import signal

    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=timeout)
    lines = [ln for ln in log.read_text().splitlines() if ln.strip()]
    return rc, time.perf_counter() - t0, json.loads(lines[-1])


def _kill_group(proc, pids=()) -> None:
    """Whatever a failed phase left: the launcher's process group and any
    child that left it."""
    import os
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    for pid in pids:
        if not _pid_gone(pid):
            os.kill(pid, signal.SIGKILL)


def _replica_metrics(port: int) -> list:
    """The per-replica entries of the router's /metrics."""
    status, body = _get_json(f"http://127.0.0.1:{port}/metrics", 30.0)
    if status != 200:
        raise AssertionError(f"deploy: router /metrics answered {status}")
    return body["per_replica"]


def _late(entry: dict) -> dict:
    """A replica's late captures (its scheduler core's and its vocoder's),
    from its /metrics as the router passes it through."""
    g = entry["metrics"]["graphs"]
    return {k: v for k, v in g.items() if k.endswith("late_captures")}


HOP_PAIRS = 4          # one-chunk requests direct and through the router


async def _first_audio_ms(port: int, i: int) -> float:
    """TTFA (ms, client clock) of one request of one chunk (28 tokens)."""
    import aiohttp

    async with aiohttp.ClientSession() as sess:
        t0 = time.perf_counter()
        first = None
        async with sess.ws_connect(f"http://127.0.0.1:{port}/ws/tts") as ws:
            await ws.send_json(dict(_request(i), max_tokens=28))
            async for msg in ws:
                if msg.type == aiohttp.WSMsgType.BINARY:
                    first = first or time.perf_counter()
                    continue
                data = json.loads(msg.data)
                if "error" in data:
                    raise AssertionError(f"hop request {i}: {data}")
                if data.get("done"):
                    break
    if first is None:
        raise AssertionError(f"hop request {i}: no audio")
    return (first - t0) * 1e3


def _hop_ms(router: int, replica: int) -> dict:
    """The router hop's share of TTFA: one-chunk requests, one at a time,
    straight to `replica` and through the router (which sends an idle
    router's request to the first replica), in turns."""
    direct, routed = [], []
    for k in range(HOP_PAIRS):
        direct.append(asyncio.run(_first_audio_ms(replica, 2 * k)))
        routed.append(asyncio.run(_first_audio_ms(router, 2 * k + 1)))
    d, r = sorted(direct)[HOP_PAIRS // 2], sorted(routed)[HOP_PAIRS // 2]
    return {"direct_ms": direct, "routed_ms": routed,
            "hop_ms_median": r - d}


def replicas_leg(card: str, dense=None, during_boot=None) -> dict:
    """Two full-width replicas of ``cli serve`` (``SMALL_SERVE``) behind
    the router, with the warm build; traffic, failover, restart, drain.
    `during_boot()` starts work that runs while the replicas boot and
    returns its future; its result is out["during_boot"]."""
    import os
    import signal

    from tts_inference_tpu_torch.ops import _build

    DEPLOY_DIR.mkdir(parents=True, exist_ok=True)
    info_path, log = DEPLOY_DIR / "build_info.json", DEPLOY_DIR / "launch.log"
    info_path.unlink(missing_ok=True)
    port = _free_port_block(2)
    rports = (port + 1, port + 2)
    out = {}
    apps0, free0 = _compute_apps(), torch.cuda.mem_get_info()[0]
    t0, wall0 = time.perf_counter(), time.time()
    proc = _launch(["--host", "127.0.0.1", "--port", str(port),
                    "--replicas", "2", "--build-info", str(info_path),
                    *DEPLOY_ARGS, "--", *SMALL_SERVE], log)
    pids: list = []
    try:
        beside = during_boot() if during_boot is not None else None

        def ready():
            st, body = _get_json(f"http://127.0.0.1:{port}/health")
            return st == 200 and all(r["up"] for r in body["replicas"])

        _await(ready, proc, 420, "two ready replicas behind the router", log)
        out["ready_s"] = time.perf_counter() - t0
        if beside is not None:
            out["during_boot"] = beside.result()
        info = json.loads(info_path.read_text())
        lib = info["kernel_library"]
        if not lib or lib["path"] != str(_build.library_path()) or not \
                Path(lib["path"]).exists():
            raise AssertionError(f"deploy: build_info names {lib}, the "
                                 f"library is {_build.library_path()}")
        out["warm_build"] = {
            "kernel_library": lib,
            "done_s_after_launch": info_path.stat().st_mtime - wall0,
            "warm_build_s": info["load_timings"].get("warm_build_s")}
        kids = _children(proc.pid)
        pids = [_on_port(kids, p) for p in rports]
        apps, free = _compute_apps(), torch.cuda.mem_get_info()[0]
        per = _replica_metrics(port)
        mem = [e["metrics"].get("device_memory", {}) for e in per]
        if not all(m.get("reserved_bytes.all.current") for m in mem):
            raise AssertionError(f"deploy: device memory per replica {mem}")
        out["replica_reserved_gb"] = [
            m["reserved_bytes.all.current"] / 1e9 for m in mem]
        # on the card: the card's free memory fell by what they reserve,
        # and nvidia-smi lists both pids — except where a pid namespace
        # hides them (nvidia-smi then lists all of its processes under one
        # pid)
        need = sum(m["reserved_bytes.all.current"] for m in mem)
        listed = all(_listed(p, apps) for p in pids)
        hidden = {p for p, _ in apps} <= {p for p, _ in apps0}
        out.update(nvidia_smi_before=apps0, nvidia_smi=apps,
                   pids_listed=listed, free_gb_drop=(free0 - free) / 1e9)
        print(f"deploy[replicas] [{card}]: ready {out['ready_s']:.1f} s "
              f"after the launch (warm build {json.dumps(out['warm_build'])}"
              f"); replica pids {pids}, reserved GB per replica (their "
              f"/metrics through the router) {out['replica_reserved_gb']}; "
              f"nvidia-smi compute apps before {apps0}, now {apps} (the "
              f"replicas' pids {'listed' if listed else 'not listed'}); "
              f"card free memory {free0 / 1e9:.2f} -> {free / 1e9:.2f} GB",
              flush=True)
        if not (listed or hidden) or free0 - free < need:
            raise AssertionError(f"deploy: replicas {pids} not on the card: "
                                 f"nvidia-smi {apps0} -> {apps}, free "
                                 f"{free0} -> {free}, reserved {need}")

        # -- the router hop, then 8 streams through the router -------------
        out["hop"] = _hop_ms(port, rports[0])
        print(f"deploy[hop] [{card}]: one-chunk TTFA ms straight to replica0 "
              f"{[round(x, 1) for x in out['hop']['direct_ms']]}, through "
              f"the router {[round(x, 1) for x in out['hop']['routed_ms']]}"
              f": the hop's share (median) "
              f"{out['hop']['hop_ms_median']:.1f} ms", flush=True)
        st, health = _get_json(f"http://127.0.0.1:{port}/health")
        split0 = [r["served"] for r in health["replicas"]]
        res = asyncio.run(_drive(port, False))
        short = [s["bytes"] for s in res["streams"]
                 if s["bytes"] != PCM_BYTES]
        st, health = _get_json(f"http://127.0.0.1:{port}/health")
        split = [r["served"] - s0 for r, s0 in zip(health["replicas"],
                                                     split0)]
        late = [_late(e) for e in _replica_metrics(port)]
        p50, p95 = _ttfa(res["streams"])
        gaps = sorted(s["worst_gap_ms"] for s in res["streams"])
        audio_s = PCM_BYTES / 2 / 24000
        out.update(ttfa_ms_p50=p50, ttfa_ms_p95=p95,
                   aggregate_rtf=len(res["streams"]) * audio_s
                   / res["wave_s"], worst_gap_ms_max=gaps[-1],
                   served_split=split, late_captures=late)
        print(f"deploy[replicas] [{card}]: 8 streams through the router: "
              f"PCM short {short}, served split {split}, late captures "
              f"{late}; TTFA ms p50 {p50:.1f} p95 {p95:.1f}, aggregate RTF "
              f"{out['aggregate_rtf']:.3f}, worst gap {gaps[-1]:.1f} ms",
              flush=True)
        if dense is not None:
            print("deploy[replicas] beside the dense phase (one server, "
                  "this run): TTFA ms p50 / p95 "
                  f"{dense['ttfa_ms_p50']:.1f} / {dense['ttfa_ms_p95']:.1f},"
                  f" aggregate RTF {dense['aggregate_rtf']:.3f}, worst gap "
                  f"{dense['worst_gap_ms_max']:.1f} ms", flush=True)
        if short or sum(split) != N_STREAMS or min(split) < 1 or any(
                v for d in late for v in d.values()):
            raise AssertionError(f"deploy: PCM short {short}, split {split}"
                                 f", late captures {late}")

        # -- failover: replica0 killed, 4 streams at once ------------------
        t_kill = time.perf_counter()
        os.kill(pids[0], signal.SIGKILL)
        _await(lambda: _pid_gone(pids[0]), proc, 60, "replica0's exit", log)
        res4 = asyncio.run(_drive(port, False, streams=4))
        st, health = _get_json(f"http://127.0.0.1:{port}/health")
        after = [r["served"] - s0 for r, s0 in zip(health["replicas"],
                                                     split0)]
        short = [s["bytes"] for s in res4["streams"]
                 if s["bytes"] != PCM_BYTES]
        out["failover"] = {"served_split_after": after,
                           "ttfa_ms_p50": _ttfa(res4["streams"])[0],
                           "failures": [r["failures"]
                                        for r in health["replicas"]]}
        print(f"deploy[failover] [{card}]: replica0 SIGKILLed; 4 streams "
              f"through the router, PCM short {short}, served split "
              f"{split} -> {after}, router failures "
              f"{out['failover']['failures']}", flush=True)
        if short or after[0] != split[0] or after[1] != split[1] + 4:
            raise AssertionError(f"deploy: failover split {split} -> "
                                 f"{after}, PCM short {short}")

        # -- restart: the launcher brings replica0 back -------------------
        _await(lambda: _get_json(
            f"http://127.0.0.1:{rports[0]}/health")[0] == 200, proc, 420,
            "replica0's restart", log)
        out["restart_s"] = time.perf_counter() - t_kill
        new = _on_port(_children(proc.pid), rports[0])
        pids.append(new)
        print(f"deploy[restart] [{card}]: replica0 back (pid {new}) "
              f"{out['restart_s']:.1f} s after the kill", flush=True)

        # -- drain --------------------------------------------------------
        every = list(_children(proc.pid))
        rc, drain_s, last = _drain(proc, log, DEPLOY_DRAIN_S + 60)
        left = [p for p in every + pids if not _pid_gone(p)]
        apps, free = _compute_apps(), torch.cuda.mem_get_info()[0]
        out.update(drain_rc=rc, drain_s=drain_s, last_line=last,
                   nvidia_smi_after=apps)
        want = {"restarts": {"replica0": 1, "replica1": 0, "router": 0}}
        # gone from the card: no pid of theirs listed, and the free memory
        # back to before the launch (within 1 GiB)
        back = (not any(_listed(p, apps) for p in every + pids)
                and free >= free0 - 2 ** 30)
        print(f"deploy[drain] [{card}]: rc {rc} in {drain_s:.1f} s (drain "
              f"limit {DEPLOY_DRAIN_S:.0f} s); last line {json.dumps(last)};"
              f" children left {left}; nvidia-smi compute apps {apps} "
              f"(before the launch {apps0}); card free memory "
              f"{free / 1e9:.2f} GB (before {free0 / 1e9:.2f})", flush=True)
        if rc != 0 or drain_s > DEPLOY_DRAIN_S or last != want or left or \
                not back:
            raise AssertionError(f"deploy: drain rc {rc} in {drain_s:.1f} s,"
                                 f" last line {last}, left {left}, apps "
                                 f"{apps}, free {free} (before {free0})")
    finally:
        _kill_group(proc, pids)
    return out


def supervised_leg(card: str) -> dict:
    """One supervised ``cli serve --tiny --no-warmup`` on the card (no
    request reaches it, so no graph is captured): killed, restarted,
    drained."""
    import os
    import signal

    log = DEPLOY_DIR / "supervised.log"
    port = _free_port()
    t0 = time.perf_counter()
    proc = _launch(["--host", "127.0.0.1", "--port", str(port),
                    "--skip-build", *DEPLOY_ARGS, "--", "--tiny",
                    "--no-warmup"], log)
    pids: list = []
    try:
        def serving(not_pid=None):
            kids = _children(proc.pid)
            ok = _get_json(f"http://127.0.0.1:{port}/health")[0] == 200
            live = [p for p in kids if p != not_pid]
            return live[0] if ok and len(kids) == 1 and live else None

        pids.append(_await(serving, proc, 240, "the tiny server", log))
        ready_s = time.perf_counter() - t0
        t_kill = time.perf_counter()
        os.kill(pids[0], signal.SIGKILL)
        pids.append(_await(lambda: serving(pids[0]), proc, 240,
                           "the restarted tiny server", log))
        restart_s = time.perf_counter() - t_kill
        rc, drain_s, last = _drain(proc, log, DEPLOY_DRAIN_S + 60)
        left = [p for p in pids if not _pid_gone(p)]
        print(f"deploy[supervised] [{card}]: tiny server ready {ready_s:.1f}"
              f" s; killed, back in {restart_s:.1f} s (pid {pids[0]} -> "
              f"{pids[1]}); SIGTERM: rc {rc} in {drain_s:.1f} s, last line "
              f"{json.dumps(last)}, left {left}", flush=True)
        if rc != 0 or last != {"restarts": 1} or left:
            raise AssertionError(f"deploy: supervised rc {rc}, {last}, "
                                 f"left {left}")
    finally:
        _kill_group(proc, pids)
    return {"ready_s": ready_s, "restart_s": restart_s, "drain_s": drain_s}


def ttfa_leg(card: str) -> dict:
    """``tools/profile_ttfa.py`` at full width with int8 weights, in a
    process of its own: every line, every number finite and positive, and
    K1, K2 and K6 launched."""
    from tts_inference_tpu_torch.tools.profile_ttfa import numbers_ok

    res = subprocess.run(
        [sys.executable, "-m", "tts_inference_tpu_torch.tools.profile_ttfa",
         "--quantize", "--iters", "3"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    for line in lines:
        print(f"deploy[profile_ttfa] [{card}]: {line}", flush=True)
    if res.returncode != 0 or not lines:
        raise AssertionError(f"profile_ttfa: rc {res.returncode}\n"
                             f"{res.stderr[-4000:]}")
    report = json.loads(lines[-1])
    ran = report["launches"]
    if not numbers_ok(report) or not all(ran.get(k, 0) > 0
                                         for k in ("K1", "K2", "K6")):
        raise AssertionError(f"profile_ttfa: {report}")
    return report


def deploy_phase(dense=None) -> dict:
    """The deployment layer on the card: ``deploy.launch --replicas 2``
    (warm build, two full-width replicas behind the router, 8 streams,
    failover, restart, drain), one supervised tiny server (while the
    replicas boot), and ``tools/profile_ttfa.py``."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    card = card_line()
    print(f"deploy [{card}]: card memory free {free / 1e9:.2f} of "
          f"{total / 1e9:.2f} GB before the launch (this process reserves "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB)", flush=True)
    from concurrent.futures import ThreadPoolExecutor

    # the tiny server's drill runs while the two replicas boot (it times
    # nothing the phase reports beside the replicas' numbers)
    with ThreadPoolExecutor(1) as pool:
        res = {"free_gb_before": free / 1e9,
               "replicas": replicas_leg(
                   card, dense,
                   during_boot=lambda: pool.submit(supervised_leg, card))}
    res["supervised"] = res["replicas"].pop("during_boot")
    res["profile_ttfa"] = ttfa_leg(card)
    res["wall_s"] = time.perf_counter() - t0
    print(f"deploy: {res['wall_s']:.1f} s", flush=True)
    return res


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
                         "quant, prefix, vocoder, native, tools = the "
                         "measurement and diagnostic tools with every flag "
                         "set and rung, multigpu = the sharded serving path "
                         "and its kernel shapes, deploy = the launcher, "
                         "its router and the TTFA anatomy, long = "
                         "bench.py --mode long's serve and the tiny long "
                         "stream, compare = the "
                         "serve phases eager and replayed, gap = the "
                         "paged_int8 phase alone) and print no result "
                         "line; the full run takes no arguments")
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
    t_run = time.perf_counter()
    times: dict = {}

    def stamp(label):
        """The seconds since the last stamp, under the blocks then ending
        (0 for a block that did not run), printed as each block ends."""
        now = time.perf_counter()
        times[label] = round(now - stamp.t, 1)
        stamp.t = now
        if times[label]:
            print(f"chip_smoke: block {label} {times[label]} s, "
                  f"{now - t_run:.1f} s in all", flush=True)

    stamp.t = t_run
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
    stamp("build, kernels")
    if on("dense"):
        dense = phases["dense"] = run_serve_phase("dense")
        graphs["dense"] = graph_phase("dense", dense["rt"])
        exactness_phase(dense["rt"])
        reference_phase(dense["rt"])
        if on("tools"):
            phases["tools_runtime"] = tools_runtime_phase(dense["rt"])
        _free(dense)
    stamp("dense")
    if on("checkpoint"):
        # the train phase fine-tunes the checkpoint phase's HF dir
        phases["checkpoint"] = checkpoint_phase(SMALL_SERVE,
                                                keep=on("train"))
    stamp("checkpoint")
    if on("train"):
        phases["train"] = train_phase(
            phases.get("checkpoint", {}).get("dirs"), SMALL_SERVE)
    stamp("train")
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
                                           phases["paged_int8"]["rt"],
                                           PAGED_GRAPH_TOKENS)
        if graphs["paged_int8"]["preemptions"] < 1:
            raise AssertionError("graph[paged_int8]: no preemption")
        _free(phases["paged_int8"])
        phases["paged_bf16"] = run_serve_phase("paged_bf16")
        graphs["paged_bf16"] = graph_phase("paged_bf16",
                                           phases["paged_bf16"]["rt"])
        _free(phases["paged_bf16"])
        paged_reference_phase()
    stamp("paged")
    if on("quant"):
        phases["int4"] = run_serve_phase("int4")
        graphs["int4"] = graph_phase("int4", phases["int4"]["rt"])
        _free(phases["int4"])
        phases["int8w"] = run_serve_phase("int8w")
        graphs["int8w"] = graph_phase("int8w", phases["int8w"]["rt"])
        _free(phases["int8w"])
        quant_reference_phase()
    stamp("quant")
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
    stamp("native")
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
    stamp("prefix")
    if on("vocoder"):
        if kern is None:   # --only vocoder: the 16-bit kernel cases too
            gen = torch.Generator(device="cuda").manual_seed(0)
            k6_16_phase(gen, torch.bfloat16)
            k6_16_phase(gen, torch.float16)
        phases["vocoder_bf16"] = vocoder_phase(phases.get("dense"))
        t0 = time.perf_counter()
        phases["vocoder_f16"] = float16_phase()
        print(f"float16: {time.perf_counter() - t0:.1f} s", flush=True)
    stamp("vocoder")
    if on("tools"):
        if "tools_runtime" not in phases:      # --only tools: boot one
            from tts_inference_tpu_torch.config import Config
            from tts_inference_tpu_torch.runtime import Runtime

            rt = {"rt": Runtime.create(Config(), seed=0, device="cuda",
                                       warmup=True)}
            phases["tools_runtime"] = tools_runtime_phase(rt["rt"])
            _free(rt)
        phases["tools"] = tools_phase(only is not None,
                                      phases["tools_runtime"])
    stamp("tools")
    if on("multigpu"):
        if kern is None:    # --only multigpu: the shard-shape kernel cases
            shard_kernel_cases(torch.Generator(device="cuda").manual_seed(0))
        phases["multigpu"] = multigpu_phase()
    stamp("multigpu")
    if on("deploy"):
        phases["deploy"] = deploy_phase(phases.get("dense"))
    stamp("deploy")
    if on("long"):
        phases["long"] = long_serve_phase()
        _free(phases["long"])
        phases["long_tiny"] = long_tiny_phase()
    stamp("long")
    print("chip_smoke: seconds by block", json.dumps(times), "total",
          round(time.perf_counter() - t_run, 1), flush=True)
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
