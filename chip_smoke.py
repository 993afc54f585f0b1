"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failed check raises, so the exit code is nonzero and
no result line is printed:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build of the hand-written kernels from ``tts_inference_tpu_torch/csrc``;
3. kernel phase: each kernel against its plain PyTorch version on the card,
   at the serve paths' shapes, with max |Δ| and µs per call of both (K1,
   K6; K3a and K3b over pools filled by the port's own pool writes);
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
10. the card line, the kernels' JSON line, and last
    ``{"ok": true, "device": {...}}``.

Imports nothing of JAX. Exits nonzero without a card.
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
K3_TOL = 2e-2    # K3a/K3b: bf16 queries and outputs; compared in f32
K6_TOL = 1e-4    # f32 with TF32 off on both sides


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time per call, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def _k1_case(w: int, gen: torch.Generator):
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
    print(f"K1 decode_attention B8 Hkv8 G3 D128 bf16 W{w}: "
          f"max|d|={err:.3e} kernel {ms * 1e3:.1f} us plain "
          f"{plain * 1e3:.1f} us", flush=True)
    if not err <= K1_TOL:
        raise AssertionError(f"K1 W={w}: max|d| {err} > {K1_TOL}")
    return err, ms, plain


def _k3_case(int8: bool, b: int, w: int, gen: torch.Generator):
    """K3a (bf16 pools) or K3b (int8 pools) at (B, W) with the serve path's
    Hkv 8, G 3, D 128 and block 128. Pools are written by the port's own
    pool_scatter / _quantize_kv from random bf16 K/V; each slot holds a
    random number of blocks at random pool rows (slot 0 the whole window,
    slot 1 one block), its table row is 0 past its last block, and the
    kernel reads a column slice of a wider table, as the engine hands it."""
    from tts_inference_tpu_torch.models.llama import _quantize_kv, pool_scatter
    from tts_inference_tpu_torch.ops import paged_attention as pa

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
    if int8:
        pools = [torch.zeros(n, hkv, bs, d, dtype=torch.int8, device=dev)
                 for _ in range(2)]
        scales = [torch.zeros(n, hkv, bs, device=dev) for _ in range(2)]
        for pool, sc, x in zip(pools, scales, kv):
            xq, xs = _quantize_kv(x)
            pool_scatter(pool, rows, offs, xq)
            pool_scatter(sc, rows, offs, xs)
        args = (q, *pools, *scales, table[:, :wb], pos)
        kern = pa.paged_decode_attention_int8
        plain = pa.paged_decode_attention_int8_reference
    else:
        pools = [torch.zeros(n, hkv, bs, d, dtype=torch.bfloat16, device=dev)
                 for _ in range(2)]
        for pool, x in zip(pools, kv):
            pool_scatter(pool, rows, offs, x)
        args = (q, *pools, table[:, :wb], pos)
        kern = pa.paged_decode_attention
        plain = pa.paged_decode_attention_reference
    got = kern(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ms = time_ms(lambda: kern(*args))
    plain_ms = time_ms(lambda: plain(*args))
    name = "K3b paged_decode_attention_int8" if int8 \
        else "K3a paged_decode_attention"
    print(f"{name} B{b} Hkv8 G3 D128 bs128 {'int8' if int8 else 'bf16'} "
          f"W{w}: max|d|={err:.3e} kernel {ms * 1e3:.1f} us plain "
          f"{plain_ms * 1e3:.1f} us", flush=True)
    if not err <= K3_TOL:
        raise AssertionError(f"{name} B={b} W={w}: max|d| {err} > {K3_TOL}")
    return err, ms, plain_ms


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
    print(f"K6 fused_residual_unit B8 C{c} T{t} dil{dil} f32: "
          f"max|d|={err:.3e} kernel {ms * 1e3:.1f} us plain "
          f"{plain * 1e3:.1f} us", flush=True)
    if not err <= K6_TOL:
        raise AssertionError(f"K6 C={c} dil={dil}: max|d| {err} > {K6_TOL}")
    return err, ms, plain


def kernel_phase() -> dict:
    """Each kernel against its plain version at the serve path's shapes."""
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
    # long: 4 slots, 12,160 positions = 95 blocks); 64 paged int8 slots
    k3a = {(b, w): _k3_case(False, b, w, gen)
           for b, w in ((8, 512), (8, 2048), (8, 4608), (4, 12160))}
    k3b = {(b, w): _k3_case(True, b, w, gen)
           for b, w in ((8, 512), (8, 2048), (8, 4608), (64, 512))}
    return {
        "K1": {"max_abs_err": max(e for e, _, _ in k1.values()),
               # the window the serve phase's decode steps mostly read
               "ms": k1[512][1], "plain_ms": k1[512][2]},
        "K3a": {"max_abs_err": max(e for e, _, _ in k3a.values()),
                "ms": k3a[(8, 512)][1], "plain_ms": k3a[(8, 512)][2]},
        "K3b": {"max_abs_err": max(e for e, _, _ in k3b.values()),
                "ms": k3b[(8, 512)][1], "plain_ms": k3b[(8, 512)][2]},
        "K6": {"max_abs_err": max(e for e, _, _ in k6.values()),
               # all 12 units of one 8-row, 16-frame vocoder call
               "ms": sum(m for _, m, _ in k6.values()),
               "plain_ms": sum(p for _, _, p in k6.values())},
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
    from tts_inference_tpu_torch.ops import (decode_attention,
                                             paged_attention, vocoder)

    return {"K1": decode_attention.launches, "K3a": paged_attention.launches,
            "K3b": paged_attention.launches_int8, "K6": vocoder.launches}


def serve_phase(name: str, argv, attention: str, generate: bool = True,
                min_preemptions: int = 0) -> dict:
    """Build `cli serve` (runtime + scheduler) from `argv`, put the port's
    aiohttp app on a localhost port and drive it: 8 concurrent /ws/tts
    streams, then (with `generate`) one /generate, then /metrics. The
    `attention` kernel (K1, K3a or K3b) must carry every decode step of
    every layer in that window and the other two none; K6 must run."""
    from aiohttp import web

    from tts_inference_tpu_torch import cli
    from tts_inference_tpu_torch.serving.app import create_app

    args = cli.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    rt, scheduler = cli.build_serving(args)
    core = scheduler.core
    print(f"serve[{name}]: runtime + warmup {time.perf_counter() - t0:.1f} s "
          f"on {rt.device}; {rt.config.model.num_hidden_layers} layers, "
          f"hidden {rt.config.model.hidden_size}, {core.batch} slots, "
          f"max_seq {core.max_seq}, cache {type(core.cache).__name__}"
          f"{' int8' if core.cache.quantized else ''}, free KV tokens "
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
        res = asyncio.run(run())
        steps = sum(c.decode_steps for c in cores) - steps0
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
    others = [k for k in ("K1", "K3a", "K3b") if k != attention]
    if on_cuda and not (launches[attention] >= layers * steps > 0
                        and launches["K6"] > 0
                        and all(launches[k] == 0 for k in others)):
        raise AssertionError(f"serve[{name}] kernel launches {launches}: "
                             f"need {attention} >= {layers} x {steps} steps, "
                             f"K6 > 0, {others} == 0")
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
        "decode_steps": steps, "launches": launches,
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

    from tts_inference_tpu import protocol
    from tts_inference_tpu.config import SamplingConfig
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
    elif isinstance(dst, list):
        for d, s in zip(dst, src):
            _copy_tree(d, s)
    elif dst is not None:
        dst.copy_(src)


def _tiny_pair(device, **engine_over):
    """The tiny_config() runtime on the CPU and on `device` (the card), with
    the same weights (the card's copied from the CPU's)."""
    from tts_inference_tpu.config import tiny_config
    from tts_inference_tpu_torch.runtime import Runtime

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(cfg.engine,
                                                              **engine_over))
    cpu = Runtime.create(cfg, seed=0, device="cpu")
    gpu = Runtime.create(cfg, seed=0, device=device)
    _copy_tree(gpu.engine.core.params, cpu.engine.core.params)
    _copy_tree(gpu.vocoder.params, cpu.vocoder.params)
    return cpu, gpu


def _tiny_sampling():
    from tts_inference_tpu import protocol
    from tts_inference_tpu.config import SamplingConfig

    return SamplingConfig(
        greedy=True, max_tokens=70,
        token_range=(protocol.TOKEN_AUDIO_BASE,
                     protocol.TOKEN_AUDIO_BASE + protocol.AUDIO_VOCAB))


def _cpu_top2_gap(rt, prompt, toks, i, sampling) -> float:
    """The CPU's logit gap between the best and the second-best allowed
    token at greedy step i: prompt + toks[:i] prefilled into a paged int8
    cache, then the repetition penalty and the token range applied as the
    sampler applies them."""
    from tts_inference_tpu_torch.models import llama
    from tts_inference_tpu_torch.ops import sampling as S

    core, cfg = rt.engine.core, rt.config.model
    bs = rt.config.engine.kv_block_size
    nblk = core.max_seq // bs
    cache = llama.init_paged_kv_cache(cfg, 1, core.max_seq,
                                      num_blocks=1 + nblk, block_size=bs,
                                      int8=True)
    cache.block_table[0] = torch.arange(1, 1 + nblk, dtype=torch.int32)
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


def _tiny_check(name: str, device, flip_gap=None, **engine_over) -> dict:
    """Greedy tokens of the tiny slice equal on the card and the CPU, and
    PCM within PCM16_TOL. With `flip_gap`, a differing token is allowed
    where the CPU's top-2 logit gap is at most flip_gap (a one-level int8
    rounding flip between the machines); the phase prints the step and the
    gap, and compares no PCM then."""
    import numpy as np

    cpu, gpu = _tiny_pair(device, **engine_over)
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
    from tts_inference_tpu import protocol
    from tts_inference_tpu.config import SamplingConfig, StreamConfig
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

    from tts_inference_tpu.config import tiny_config
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


def _free(phase: dict) -> None:
    """Drop a full-width runtime before the next one is built."""
    phase.pop("rt", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main() -> int:
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
    kern = kernel_phase()
    dense = serve_phase("dense", ["serve"], "K1")
    exactness_phase(dense["rt"])
    reference_phase(dense["rt"])
    _free(dense)
    paged8 = serve_phase(
        "paged_int8", ["serve", "--paged-kv", "--kv-int8", "--kv-on-demand",
                       "--kv-block-size", "128", "--kv-pool-tokens", "2048"],
        "K3b", generate=False, min_preemptions=1)
    _free(paged8)
    paged = serve_phase("paged_bf16", ["serve", "--paged-kv"], "K3a")
    _free(paged)
    paged_reference_phase()
    launches = {k: ph["launches"][k] for k, ph in (
        ("K1", dense), ("K6", dense), ("K3a", paged), ("K3b", paged8))}
    kernels = [
        {"name": "decode_attention", "route": "cuda",
         "source": "tts_inference_tpu_torch/csrc/decode_attention.cu",
         "replaces": "tts_inference_tpu/ops/pallas/decode_attention.py:97",
         "launches": launches["K1"], **kern["K1"]},
        {"name": "fused_residual_unit", "route": "cuda",
         "source": "tts_inference_tpu_torch/csrc/vocoder.cu",
         "replaces": "tts_inference_tpu/ops/pallas/vocoder.py:212",
         "launches": launches["K6"], **kern["K6"]},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "tts_inference_tpu_torch/csrc/paged_attention.cu",
         "replaces": "tts_inference_tpu/ops/pallas/paged_attention.py:224",
         "launches": launches["K3a"], **kern["K3a"]},
        {"name": "paged_decode_attention_int8", "route": "cuda",
         "source": "tts_inference_tpu_torch/csrc/paged_attention.cu",
         "replaces": "tts_inference_tpu/ops/pallas/paged_attention.py:286",
         "launches": launches["K3b"], **kern["K3b"]},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
