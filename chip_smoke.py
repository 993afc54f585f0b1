"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failed check raises, so the exit code is nonzero and
no result line is printed:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build of the hand-written kernels from ``tts_inference_tpu_torch/csrc``;
3. kernel phase: each kernel against its plain PyTorch version on the card,
   at the serve path's shapes, with max |Δ| and µs per call of both;
4. serve phase: the full Orpheus-3B + SNAC 24 kHz geometry with seeded
   random weights behind the port's aiohttp server (``cli serve``
   defaults: 8 slots, max_seq 4608); 8 concurrent ``/ws/tts`` requests and
   one ``/generate``; launch counts prove both kernels carried the path;
5. streaming exactness: windowed lookahead decode vs one batch decode;
6. reference: the slice at ``tiny_config()`` on the card against the same
   weights on the CPU (plain versions), and finite full-geometry logits;
7. the card line, the kernels' JSON line, and last
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX. Exits nonzero without a card.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time

import torch

K1_TOL = 2e-2    # bf16 inputs; compared in f32
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
    return {
        "K1": {"max_abs_err": max(e for e, _, _ in k1.values()),
               # the window the serve phase's decode steps mostly read
               "ms": k1[512][1], "plain_ms": k1[512][2]},
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


async def _drive(port: int) -> dict:
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
        t1 = time.perf_counter()
        async with sess.post(base + "/generate",
                             json=_request(N_STREAMS)) as r:
            if r.status != 200:
                raise AssertionError(f"/generate: {r.status} "
                                     f"{await r.text()}")
            wav = await r.read()
        gen_s = time.perf_counter() - t1
    with wave.open(io.BytesIO(wav)) as w:
        gen_samples = w.getnframes()
    return {"streams": streams, "wave_s": wave_s, "generate_s": gen_s,
            "generate_samples": gen_samples}


def serve_phase(argv) -> dict:
    """Build `cli serve` (runtime + scheduler), put the port's aiohttp app
    on a localhost port and drive it: 8 concurrent /ws/tts streams, then
    one /generate."""
    from aiohttp import web

    from tts_inference_tpu_torch import cli
    from tts_inference_tpu_torch.ops import decode_attention, vocoder
    from tts_inference_tpu_torch.serving.app import create_app

    args = cli.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    rt, scheduler = cli.build_serving(args)
    print(f"serve: runtime + warmup {time.perf_counter() - t0:.1f} s on "
          f"{rt.device}; {rt.config.model.num_hidden_layers} layers, hidden "
          f"{rt.config.model.hidden_size}, {scheduler.core.batch} slots, "
          f"max_seq {scheduler.core.max_seq}", flush=True)
    port = _free_port()
    cores = (scheduler.core, rt.engine.core)

    async def run() -> dict:
        runner = web.AppRunner(create_app(rt, scheduler))
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        try:
            return await _drive(port)
        finally:
            await runner.cleanup()

    scheduler.start()
    try:
        if rt.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        # counts cover exactly the main path's run
        decode_attention.launches.reset()
        vocoder.launches.reset()
        steps0 = sum(c.decode_steps for c in cores)
        res = asyncio.run(run())
        steps = sum(c.decode_steps for c in cores) - steps0
        k1, k6 = decode_attention.launches.count, vocoder.launches.count
    finally:
        scheduler.stop()

    layers = rt.config.model.num_hidden_layers
    for i, s in enumerate(res["streams"]):
        if s["bytes"] != PCM_BYTES:
            raise AssertionError(f"stream {i}: {s['bytes']} PCM bytes, "
                                 f"expected {PCM_BYTES}")
    if res["generate_samples"] != PCM_BYTES // 2:
        raise AssertionError(f"/generate: {res['generate_samples']} samples")
    on_cuda = rt.device.type == "cuda"
    if on_cuda and not (k1 >= layers * steps > 0 and k6 > 0):
        raise AssertionError(f"kernel launches K1 {k1} (need >= {layers} x "
                             f"{steps} steps), K6 {k6}")
    audio_s = PCM_BYTES / 2 / 24000
    ttfa = sorted(s["ttfa_ms"] for s in res["streams"])
    out = {
        "ttfa_ms_p50": ttfa[len(ttfa) // 2],
        "ttfa_ms_p95": ttfa[min(len(ttfa) - 1,
                                int(round(0.95 * (len(ttfa) - 1))))],
        "per_stream_rtf": [audio_s / s["wall_s"] for s in res["streams"]],
        "aggregate_rtf": N_STREAMS * audio_s / res["wave_s"],
        "wave_wall_s": res["wave_s"],
        "generate_wall_s": res["generate_s"],
        "decode_steps": steps, "k1_launches": k1, "k6_launches": k6,
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if on_cuda else None),
    }
    print("serve: 8 x /ws/tts + /generate ok:", json.dumps(out), flush=True)
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


def reference_phase(rt) -> dict:
    """What comes out is right on a small input: the slice at
    ``tiny_config()`` (f32) with the same weights on the card (both
    kernels) and on the CPU (their plain versions, which the CPU tests hold
    against the JAX package) gives the same greedy tokens and PCM within
    PCM16_TOL; the full-geometry model gives finite logits of the expected
    shape through prefill and a K1 decode step."""
    import numpy as np

    from tts_inference_tpu import protocol
    from tts_inference_tpu.config import SamplingConfig, tiny_config
    from tts_inference_tpu_torch.models import llama
    from tts_inference_tpu_torch.runtime import Runtime

    cfg = tiny_config()
    cpu = Runtime.create(cfg, seed=0, device="cpu")
    gpu = Runtime.create(cfg, seed=0, device=rt.device)
    _copy_tree(gpu.engine.core.params, cpu.engine.core.params)
    _copy_tree(gpu.vocoder.params, cpu.vocoder.params)
    sampling = SamplingConfig(
        greedy=True, max_tokens=70,
        token_range=(protocol.TOKEN_AUDIO_BASE,
                     protocol.TOKEN_AUDIO_BASE + protocol.AUDIO_VOCAB))
    res = {}
    with torch.no_grad():
        prompt = cpu.pipeline.build_prompt("hello", force_speech=True)
        toks = [[t for c in r.engine.stream(prompt, sampling) for t in c]
                for r in (cpu, gpu)]
        if toks[0] != toks[1] or len(toks[0]) != sampling.max_tokens:
            raise AssertionError(f"tiny greedy tokens: card {toks[1]} vs "
                                 f"CPU {toks[0]}")
        pcm = [np.frombuffer(b"".join(
            c.pcm for c in r.pipeline.stream("hello", sampling=sampling,
                                             force_speech=True)),
            np.int16).astype(np.int32) for r in (cpu, gpu)]
        if pcm[0].shape != pcm[1].shape or pcm[0].size != 10 * 2048:
            raise AssertionError(f"tiny PCM: card {pcm[1].shape} vs CPU "
                                 f"{pcm[0].shape}")
        diff = np.abs(pcm[0] - pcm[1])
        res["tiny"] = {"tokens": len(toks[0]),
                       "max_pcm16_diff": int(diff.max()),
                       "samples_differing": int((diff > 0).sum()),
                       "samples": int(diff.size)}
        if res["tiny"]["max_pcm16_diff"] > PCM16_TOL:
            raise AssertionError(f"tiny PCM off by {diff.max()} LSB")

        core = rt.engine.core
        mcfg = rt.config.model
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
    serve = serve_phase(["serve"])
    exactness_phase(serve["rt"])
    reference_phase(serve["rt"])
    kernels = [
        {"name": "decode_attention", "route": "cuda",
         "source": "tts_inference_tpu_torch/csrc/decode_attention.cu",
         "replaces": "tts_inference_tpu/ops/pallas/decode_attention.py:97",
         "launches": serve["k1_launches"], **kern["K1"]},
        {"name": "fused_residual_unit", "route": "cuda",
         "source": "tts_inference_tpu_torch/csrc/vocoder.cu",
         "replaces": "tts_inference_tpu/ops/pallas/vocoder.py:212",
         "launches": serve["k6_launches"], **kern["K6"]},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
