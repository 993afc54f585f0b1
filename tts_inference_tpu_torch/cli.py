"""CLI entry points of the port: ``generate``, ``serve``, ``dump-tokens``,
``quantize`` and ``devices``.

    python -m tts_inference_tpu_torch.cli serve --model-path HF_DIR \\
        --snac-path SNAC_DIR [--lora-path ADAPTER] [--tokenizer-path DIR]
    python -m tts_inference_tpu_torch.cli quantize --model-path HF_DIR \\
        --quantize [--weight-bits 4] --out QDIR
    python -m tts_inference_tpu_torch.cli generate --text "hi" --tiny \\
        --device cpu --force-speech --audio-only --output out.wav

Without ``--model-path`` / ``--snac-path`` the defaults are the JAX
package's ``cli serve`` defaults: Orpheus-3B geometry with seeded random
bf16 weights, 8 continuous-batching slots, max_seq 4608, the f32 SNAC 24 kHz
vocoder. A checkpoint's own ``config.json`` wins over them; the tokenizer
comes from ``--tokenizer-path``, else the model dir, else bytes. The KV
cache and admission options map onto ``EngineConfig`` as the JAX CLI maps
them (``--paged-kv``, ``--kv-int8``, ``--kv-int4``, ``--kv-on-demand``,
``--kv-pool-tokens``, ``--kv-block-size``, ``--kv-buckets``,
``--prefill-buckets``, ``--max-input-len``, ``--prefix-cache``,
``--admission-policy``, ``--reserved-short-slots``, ``--short-tokens``);
``--quantize [--weight-bits 4]`` quantizes the LM weights at boot (kernels
K2 and K4) unless the checkpoint is pre-quantized; ``--vocoder-bf16`` runs
the vocoder in bf16 (K6's bf16 kernel); ``serve --native-protocol``
extracts tokens and de-interleaves windows in the C++ runtime built from
``native/tts_runtime.cpp`` (an error when it cannot be built). Without
``--device`` every command but ``devices`` runs on ``cuda`` and fails when
there is none; ``--device cpu`` asks for the CPU.

``--tp T --dp D`` runs a command over T·D devices, one process each
(``parallel/``): without ``--coordinator`` this process starts the T·D − 1
followers itself (the same command with ``--coordinator 127.0.0.1:<free
port> --process-id i``); with ``--coordinator HOST:PORT --num-processes N
--process-id I`` each process of a multi-host group is started by hand.
NCCL on cards (one process a card), gloo on the CPU. ``serve`` serves one
engine sharded over them: process 0 serves the API and mirrors every
engine launch to the others over the lockstep side channel
(``--lockstep-port``, ``--lockstep-bind``) and exits nonzero when a
follower dies. ``generate`` and ``dump-tokens`` mirror the single-stream
engine's launches the same way: process 0 prints the command's JSON (and
writes the WAV), the followers print nothing. ``quantize`` cuts the
quantized weights as the mesh serves them and gathers the shards back to
process 0, which writes the one checkpoint the unsharded command writes.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Optional


def _add_runtime_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model-path",
                   help="HF checkpoint dir (safetensors), or a dir written by "
                        "`quantize`")
    p.add_argument("--snac-path", help="SNAC checkpoint dir")
    p.add_argument("--lora-path", help="LoRA adapter dir to merge at load")
    p.add_argument("--tokenizer-path",
                   help="tokenizer dir (tokenizer.json; defaults to the "
                        "model dir)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random-weight runtime (tests, CPU)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; an error when there is "
                        "none — ask for the CPU with --device cpu)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--max-input-len", type=int, default=None)
    p.add_argument("--max-output-len", type=int, default=None)
    p.add_argument("--max-batch-size", type=int, default=None)
    p.add_argument("--prefill-buckets", default=None,
                   help="comma-separated prompt buckets, e.g. 64,128")
    p.add_argument("--kv-buckets", default=None,
                   help="comma-separated KV attention-window buckets "
                        "(default: doubling series extended to max_seq_len)")
    p.add_argument("--paged-kv", action="store_true",
                   help="paged KV cache: a block pool shared by the slots, "
                        "per-slot block tables, capacity-gated admission "
                        "(kernel K3a, or K3b with --kv-int8)")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV cache with per-position scales")
    p.add_argument("--kv-int4", action="store_true",
                   help="with --paged-kv: int4 KV pools packed by head pair "
                        "(kernel K5)")
    p.add_argument("--quantize", action="store_true",
                   help="weight-only quantization of the LM at boot")
    p.add_argument("--weight-bits", type=int, default=8, choices=(8, 4),
                   help="with --quantize: 8 = per-channel int8 (default, "
                        "kernel K2), 4 = per-group int4 layer linears "
                        "(kernel K4; embedding and head stay int8)")
    p.add_argument("--kv-on-demand", action="store_true",
                   help="with --paged-kv: reserve only the prefill window at "
                        "admission, grow blocks per decode launch, and on "
                        "pool exhaustion preempt the youngest stream and "
                        "resume it bit-identically")
    p.add_argument("--kv-pool-tokens", type=int, default=None,
                   help="paged KV pool size in tokens (default "
                        "max(max_seq, slots x max_seq / 2))")
    p.add_argument("--kv-block-size", type=int, default=None,
                   help="paged KV block size in tokens (divides max_seq; "
                        "default 128, or 64 with --tiny, whose max_seq is "
                        "320)")
    p.add_argument("--admission-policy", choices=("fifo", "sjf"),
                   default=None,
                   help="'sjf' = shortest job first with aging")
    p.add_argument("--reserved-short-slots", type=int, default=None,
                   help="slots only short requests (max_tokens <= "
                        "--short-tokens) may occupy")
    p.add_argument("--short-tokens", type=int, default=None,
                   help="'short request' threshold in tokens")
    p.add_argument("--prefix-cache", action="store_true",
                   help="cache KV for repeated prompt prefixes (the "
                        "reference's vLLM enable_prefix_caching analog)")
    p.add_argument("--vocoder-bf16", action="store_true",
                   help="run the SNAC vocoder in bfloat16 (f32 sums in the "
                        "residual units' pointwise product, f32 PCM out; "
                        "kernel K6's bf16 variant); gate its fidelity with "
                        "tools/vocoder_dtype_fidelity.py")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree (mesh tp axis, one process "
                        "per device)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel degree (request slots over "
                        "replicas)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process mesh: the process group's TCP "
                        "rendezvous (served by process 0); process 0 owns "
                        "the engine's calls and mirrors them to the others "
                        "(parallel/lockstep.py). Without it, --tp/--dp > 1 "
                        "start their followers on this host")
    p.add_argument("--num-processes", type=int, default=1,
                   help="total processes in the group")
    p.add_argument("--process-id", type=int, default=0,
                   help="this process's index (0 = the one that answers)")
    p.add_argument("--lockstep-port", type=int, default=18765,
                   help="TCP side-channel port on the coordinator host for "
                        "mirrored EngineCore calls")
    p.add_argument("--lockstep-bind", default=None,
                   help="interface the coordinator binds the side channel "
                        "to (default: the --coordinator host). The channel "
                        "carries pickled descriptors — keep it on a trusted "
                        "private network and set TTS_LOCKSTEP_TOKEN on all "
                        "processes (shared-token handshake)")


def _sharded(args) -> bool:
    return bool(args.coordinator) or (args.tp, args.dp) != (1, 1)


def _config(args):
    """The Config the flags ask for, as the JAX CLI maps them."""
    from tts_inference_tpu_torch.config import (Config, extended_kv_buckets,
                                                tiny_config)

    cfg = tiny_config() if args.tiny else Config()
    eng_over = {}
    if args.max_input_len:
        eng_over["max_input_len"] = args.max_input_len
    if args.prefill_buckets:
        eng_over["prefill_buckets"] = tuple(
            int(x) for x in args.prefill_buckets.split(","))
    if args.kv_buckets:
        eng_over["kv_buckets"] = tuple(
            int(x) for x in args.kv_buckets.split(","))
    if args.max_output_len:
        eng_over["max_output_len"] = args.max_output_len
    if args.max_batch_size:
        eng_over["max_batch_size"] = args.max_batch_size
    for flag, field in (("prefix_cache", "prefix_cache"),
                        ("paged_kv", "paged_kv"),
                        ("kv_int8", "kv_cache_int8"),
                        ("kv_int4", "kv_cache_int4"),
                        ("kv_on_demand", "kv_on_demand")):
        if getattr(args, flag):
            eng_over[field] = True
    if args.tiny and args.paged_kv and args.kv_block_size is None:
        eng_over["kv_block_size"] = 64
    for flag, field in (("kv_pool_tokens", "kv_pool_tokens"),
                        ("kv_block_size", "kv_block_size"),
                        ("admission_policy", "admission_policy"),
                        ("reserved_short_slots", "reserved_short_slots"),
                        ("short_tokens", "short_request_tokens")):
        if getattr(args, flag) is not None:
            eng_over[field] = getattr(args, flag)
    if eng_over:
        cfg = dataclasses.replace(
            cfg, engine=dataclasses.replace(cfg.engine, **eng_over))
    if args.vocoder_bf16:
        cfg = dataclasses.replace(
            cfg, snac=dataclasses.replace(cfg.snac, dtype="bfloat16"))
    if not args.kv_buckets:
        # long-audio engines need window buckets past the default 4096 so
        # mid-length decodes don't read the full max_seq window
        cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
            cfg.engine, kv_buckets=extended_kv_buckets(
                cfg.engine.kv_buckets, cfg.engine.max_seq_len)))
    if (args.tp, args.dp) != (1, 1):
        from tts_inference_tpu_torch.config import MeshConfig
        from tts_inference_tpu_torch.parallel.mesh import validate_tp

        validate_tp(cfg.model, args.tp)
        if cfg.engine.max_batch_size % args.dp:
            raise ValueError(f"batch {cfg.engine.max_batch_size} not "
                             f"divisible by dp={args.dp}")
        cfg = dataclasses.replace(cfg, mesh=MeshConfig(dp=args.dp,
                                                       tp=args.tp))
    return cfg


def _build_runtime(args):
    from tts_inference_tpu_torch.runtime import Runtime

    return Runtime.create(_config(args), model_path=args.model_path,
                          snac_path=args.snac_path, lora_path=args.lora_path,
                          tokenizer_path=args.tokenizer_path, seed=args.seed,
                          device=args.device, warmup=not args.no_warmup,
                          quantize=args.quantize,
                          weight_bits=args.weight_bits)


def _sampling(args):
    from tts_inference_tpu_torch import protocol
    from tts_inference_tpu_torch.config import SamplingConfig

    return SamplingConfig(
        temperature=args.temperature, top_p=args.top_p,
        repetition_penalty=args.repetition_penalty,
        max_tokens=args.max_tokens, greedy=args.greedy, seed=args.seed,
        token_range=((protocol.TOKEN_AUDIO_BASE,
                      protocol.TOKEN_AUDIO_BASE + protocol.AUDIO_VOCAB)
                     if args.audio_only else None),
    )


def _generate(rt, args) -> int:
    from tts_inference_tpu_torch.utils.audio import duration_s, write_wav

    t0 = time.perf_counter()
    pcm, metrics = rt.pipeline.synthesize(args.text, args.voice,
                                          _sampling(args),
                                          force_speech=args.force_speech)
    wall = time.perf_counter() - t0
    write_wav(args.output, pcm)
    print(json.dumps({
        "output": args.output,
        "device": str(rt.device),
        "audio_duration_s": round(duration_s(pcm), 3),
        "wall_s": round(wall, 3),
        "ttfa_ms": round(metrics.ttfa_ms, 1),
        "ttft_ms": round(metrics.ttft_ms, 1),
        "tokens": metrics.tokens,
        "tokens_per_sec": round(metrics.tokens_per_sec, 1),
        "rtf": round(metrics.rtf, 3),
        "chunks": metrics.chunks,
    }))
    return 0


def _dump_tokens(rt, args) -> int:
    from tts_inference_tpu_torch.config import SamplingConfig

    prompt = rt.pipeline.build_prompt(args.text, args.voice)
    res = rt.engine.generate(
        prompt, SamplingConfig(max_tokens=args.max_tokens, seed=args.seed))
    print(json.dumps({"prompt_ids": prompt, "token_ids": res.token_ids,
                      "timings": res.timings}))
    return 0


def cmd_generate(args) -> int:
    if _sharded(args):
        return _single_stream_sharded(args, _generate)
    return _generate(_build_runtime(args), args)


def cmd_dump_tokens(args) -> int:
    if _sharded(args):
        return _single_stream_sharded(args, _dump_tokens)
    return _dump_tokens(_build_runtime(args), args)


def cmd_quantize(args) -> int:
    """Offline weight quantization: checkpoint in → pre-quantized checkpoint
    out (``params.safetensors`` + ``metadata.json``). A boot from the output
    skips the quantization. The int4 group is ``TTS_INT4_GROUP`` (512 by
    default), as in the JAX package. Under ``--tp/--dp`` every process
    loads and quantizes as a sharded runtime does and keeps its shard; the
    shards are gathered back to process 0 (int4 row shards at the
    checkpoint's group), which writes; the others write nothing."""
    import torch

    from tts_inference_tpu_torch.models.quant import (QuantEmbed,
                                                      QuantLinear,
                                                      i4_group_of,
                                                      quantize_llama_params,
                                                      to_plain)
    from tts_inference_tpu_torch.runtime import default_device, load_model
    from tts_inference_tpu_torch.training.checkpoint import save_params

    with _process_group(args) as (cfg, dev, mesh):
        t0 = time.perf_counter()
        if dev is None:
            dev = torch.device(args.device) if args.device \
                else default_device()
        # sharded: a checkpoint whole on the host, as Runtime.create loads
        src = dev if mesh is None or not args.model_path \
            else torch.device("cpu")
        params, cfg = load_model(cfg, src, model_path=args.model_path,
                                 lora_path=args.lora_path, seed=args.seed,
                                 quantize=args.quantize,
                                 weight_bits=args.weight_bits)
        load_s = time.perf_counter() - t0
        if not isinstance(params.get("embed"), (QuantEmbed, QuantLinear)):
            params = quantize_llama_params(params, bits=args.weight_bits,
                                           free_source=True)
        if mesh is not None:
            from tts_inference_tpu_torch import weights

            group = i4_group_of(params)
            shard = weights.shard_params(params, cfg.model, mesh)
            del params
            with torch.no_grad():
                params = weights.gather_params(shard, cfg.model, mesh,
                                               i4_group=group)
            del shard
            if mesh.rank != 0:
                return 0
        t1 = time.perf_counter()
        nbytes = save_params(args.out, to_plain(params), metadata={
            "vocab_size": cfg.model.vocab_size,
            "quantized": args.weight_bits,
            "model_config": dataclasses.asdict(cfg.model),
        })
        print(json.dumps({"out": args.out, "weight_bits": args.weight_bits,
                          "device": str(dev), "bytes": nbytes,
                          "load_model_s": round(load_s, 3),
                          "save_s": round(time.perf_counter() - t1, 3),
                          "wall_s": round(time.perf_counter() - t0, 1)}))
    return 0


def cmd_devices(args) -> int:
    """Device visibility check: the JAX CLI's keys for the torch devices."""
    import torch

    if torch.cuda.is_available():
        devices = [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                   for i in range(torch.cuda.device_count())]
        platform = "gpu"
    else:
        devices, platform = ["cpu"], "cpu"
    print(json.dumps({"platform": platform, "devices": devices,
                      "device_count": len(devices)}))
    return 0


def build_serving(args):
    """The runtime and (by default) the continuous-batching scheduler that
    ``serve`` puts behind its HTTP/WS app."""
    rt = _build_runtime(args)
    scheduler = None
    if args.multi_stream:
        from tts_inference_tpu_torch.engine.scheduler import Scheduler

        scheduler = Scheduler(rt.engine.core.params, rt.config, rt.vocoder,
                              rt.tokenizer, seed=args.seed, device=rt.device,
                              use_native=args.native_protocol)
        if not args.no_warmup:
            info = scheduler.warmup()
            # the scheduler's graph census, then the single-stream engine's
            single = {k: rt.load_timings[k] for k in (
                "graphs_compiled", "graph_census_ms") if k in rt.load_timings}
            print(json.dumps({"warmup": info, "single_stream": single}),
                  flush=True)
    return rt, scheduler


def cmd_serve(args) -> int:
    from tts_inference_tpu_torch.serving.app import run_app

    if _sharded(args):
        return _serve_sharded(args)
    rt, scheduler = build_serving(args)
    return run_app(rt, host=args.host, port=args.port, scheduler=scheduler)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start_followers(args, n: int) -> list:
    """The one-process-per-device form of a single-host mesh: start the
    n − 1 followers (this command with a local coordinator) and point this
    process's arguments at it as process 0."""
    args.coordinator = f"127.0.0.1:{_free_port()}"
    args.num_processes, args.process_id = n, 0
    args.lockstep_port = _free_port()
    base = [sys.executable, "-m", "tts_inference_tpu_torch.cli",
            *args.argv, "--coordinator", args.coordinator,
            "--num-processes", str(n), "--lockstep-port",
            str(args.lockstep_port)]
    return [subprocess.Popen(base + ["--process-id", str(i)])
            for i in range(1, n)]


def _watch_followers(children: list, mirror: list,
                     stopping: threading.Event) -> None:
    """When a follower exits while this process serves: fail the mirror, so
    that the next mirrored call raises at once and the scheduler's fatal
    path ends every stream with "engine down" and the server with rc 13;
    an idle server (no call to fail) exits 14 after a grace period."""
    def watch():
        while not stopping.is_set():
            for i, c in enumerate(children, start=1):
                rc = c.poll()
                if rc is None:
                    continue
                msg = f"follower process {i} exited rc={rc}"
                if mirror:
                    mirror[0]._fail(RuntimeError(msg))
                    if stopping.wait(5.0):
                        return
                print(f"fatal: {msg}", flush=True)
                os._exit(14)
            time.sleep(0.2)

    threading.Thread(target=watch, daemon=True,
                     name="follower-watch").start()


@contextlib.contextmanager
def _process_group(args, watch: Optional[list] = None):
    """(config, device, mesh) of this process in the (dp, tp) mesh the flags
    ask for, with the default process group up (``init_multihost``); the
    followers started here when there is no ``--coordinator``, and waited
    for (``watch``: the serve's mirror, failed when one dies) on the way
    out. Without ``--tp/--dp/--coordinator``: (config, None, None)."""
    cfg = _config(args)     # validate_tp and dp | batch before any process
    if not _sharded(args):
        yield cfg, None, None
        return
    from tts_inference_tpu_torch.parallel.multihost import (init_multihost,
                                                            make_global_mesh)

    n = args.tp * args.dp
    children: list = []
    stopping = threading.Event()
    if not args.coordinator:
        if not str(args.device).startswith("cpu"):
            import torch

            if torch.cuda.device_count() < n:
                raise SystemExit(
                    f"--tp {args.tp} --dp {args.dp} needs {n} cards on this "
                    f"host, found {torch.cuda.device_count()} (one process "
                    "per card: NCCL refuses two ranks on one device)")
        children = _start_followers(args, n)
        if watch is not None:
            print(json.dumps({"lockstep_followers": [c.pid for c in children]}),
                  flush=True)
            _watch_followers(children, watch, stopping)
    elif args.num_processes < 2:
        raise SystemExit("--coordinator requires --num-processes >= 2")
    if args.num_processes % args.tp or (
            args.dp != 1 and args.num_processes != n):
        raise SystemExit(f"--tp {args.tp} --dp {args.dp} does not lay out "
                         f"over {args.num_processes} processes")
    try:
        dev = init_multihost(args.coordinator, args.num_processes,
                             args.process_id, device=args.device)
        mesh = make_global_mesh(tp=args.tp, device=dev)
        yield (dataclasses.replace(cfg, mesh=dataclasses.replace(
            cfg.mesh, dp=mesh.dp, tp=mesh.tp)), dev, mesh)
        if watch is None:
            # a command that ends: its followers end with it
            for c in children:
                try:
                    c.wait(timeout=120)
                except subprocess.TimeoutExpired:
                    pass
            bad = [c.returncode for c in children if c.returncode != 0]
            if bad:
                raise SystemExit(f"a follower process failed: rc {bad}")
    finally:
        stopping.set()
        for c in children:
            if c.poll() is None:
                c.terminate()
        for c in children:
            try:
                c.wait(timeout=30)
            except subprocess.TimeoutExpired:
                c.kill()


def _sharded_runtime(args, cfg, dev, mesh):
    """This process's runtime over its shard, no warmup (the warmup's
    engine launches must be mirrored)."""
    from tts_inference_tpu_torch.runtime import Runtime

    return Runtime.create(cfg, model_path=args.model_path,
                          snac_path=args.snac_path, lora_path=args.lora_path,
                          tokenizer_path=args.tokenizer_path, seed=args.seed,
                          device=dev, warmup=False, quantize=args.quantize,
                          weight_bits=args.weight_bits, mesh=mesh)


def _single_stream_sharded(args, run) -> int:
    """`generate` / `dump-tokens` over a (dp, tp) mesh of processes:
    process 0 runs the command with its single-stream engine's core
    mirrored to the others (``parallel/lockstep.py``); they replay its
    launches and print nothing."""
    from tts_inference_tpu_torch.parallel import lockstep as LS

    with _process_group(args) as (cfg, dev, mesh):
        rt = _sharded_runtime(args, cfg, dev, mesh)
        host = args.coordinator.rsplit(":", 1)[0]
        if args.process_id != 0:
            sock = LS.follower_channel(host, args.lockstep_port,
                                       process_id=args.process_id)
            LS.follower_loop(rt.engine.core, sock)
            return 0
        mirror = LS.MirroredCore(rt.engine.core, LS.coordinator_channel(
            args.lockstep_port, args.num_processes - 1,
            bind=args.lockstep_bind or host))
        rt.engine.core = mirror
        try:
            if not args.no_warmup:
                rt.warmup()
            return run(rt, args)
        finally:
            mirror.close()


def _serve_sharded(args) -> int:
    """`serve` over a (dp, tp) mesh of processes (parallel/lockstep.py):
    process 0 serves the API with a mirrored scheduler, the others replay
    its engine calls."""
    from tts_inference_tpu_torch import protocol
    from tts_inference_tpu_torch.engine.engine import EngineCore
    from tts_inference_tpu_torch.engine.scheduler import Scheduler
    from tts_inference_tpu_torch.parallel import lockstep as LS
    from tts_inference_tpu_torch.serving.app import run_app

    if not args.multi_stream:
        raise SystemExit("lockstep serving requires the scheduler (drop "
                         "--single-stream)")
    mirror: list = []
    with _process_group(args, watch=mirror) as (cfg, dev, mesh):
        # the single-stream engine's launches are not mirrored: no runtime
        # warmup (the scheduler's, mirrored, covers every launch it makes)
        rt = _sharded_runtime(args, cfg, dev, mesh)
        graphs = not mesh.gather_by_sum     # gloo cannot be captured
        host = args.coordinator.rsplit(":", 1)[0]
        if args.process_id != 0:
            sock = LS.follower_channel(host, args.lockstep_port,
                                       process_id=args.process_id)
            print(json.dumps({"lockstep_follower": args.process_id,
                              "status": "connected"}), flush=True)
            core = EngineCore(rt.engine.core.params, rt.config.model,
                              rt.config.engine, eos_id=protocol.TOKEN_EOS,
                              seed=args.seed, device=dev, mesh=mesh,
                              graphs=graphs)
            try:
                n_calls = LS.follower_loop(core, sock)
            except ConnectionError as e:
                # the coordinator died: exit nonzero, for a supervisor to
                # restart the whole group
                print(json.dumps({"lockstep_follower": args.process_id,
                                  "error": str(e)}), flush=True)
                return 1
            print(json.dumps({"lockstep_follower": args.process_id,
                              "replayed_calls": n_calls}), flush=True)
            return 0
        # the side channel on the coordinator's own interface by default,
        # never 0.0.0.0 unless asked
        socks = LS.coordinator_channel(args.lockstep_port,
                                       args.num_processes - 1,
                                       bind=args.lockstep_bind or host)

        def wrap(core):
            mirror.append(LS.MirroredCore(core, socks))
            return mirror[0]

        scheduler = Scheduler(rt.engine.core.params, rt.config, rt.vocoder,
                              rt.tokenizer, seed=args.seed, device=dev,
                              use_native=args.native_protocol, mesh=mesh,
                              wrap_core=wrap, graphs=graphs)
        if not args.no_warmup:
            info = scheduler.warmup()
            print(json.dumps({"warmup": info}), flush=True)
        try:
            return run_app(rt, host=args.host, port=args.port,
                           scheduler=scheduler, lockstep=True)
        finally:
            mirror[0].close()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tts_inference_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="text → WAV")
    _add_runtime_args(g)
    g.add_argument("--text", required=True)
    g.add_argument("--voice", default="tara")
    g.add_argument("--output", default="output.wav")
    g.add_argument("--temperature", type=float, default=0.6)
    g.add_argument("--top-p", type=float, default=0.95)
    g.add_argument("--repetition-penalty", type=float, default=1.1)
    g.add_argument("--max-tokens", type=int, default=1200)
    g.add_argument("--greedy", action="store_true")
    g.add_argument("--force-speech", action="store_true",
                   help="append [DELIMITER, SOS] to the prompt (needed with "
                        "random weights)")
    g.add_argument("--audio-only", action="store_true",
                   help="constrain sampling to the audio token range")
    g.set_defaults(fn=cmd_generate)

    d = sub.add_parser("dump-tokens", help="raw LM token stream")
    _add_runtime_args(d)
    d.add_argument("--text", required=True)
    d.add_argument("--voice", default="tara")
    d.add_argument("--max-tokens", type=int, default=256)
    d.set_defaults(fn=cmd_dump_tokens)

    q = sub.add_parser("quantize",
                       help="offline weight quantization → a checkpoint "
                            "that boots without quantizing")
    _add_runtime_args(q)
    q.add_argument("--out", required=True,
                   help="output checkpoint dir (serve/generate "
                        "--model-path this)")
    q.set_defaults(fn=cmd_quantize)

    dv = sub.add_parser("devices", help="device visibility check")
    dv.set_defaults(fn=cmd_devices)

    s = sub.add_parser("serve", help="HTTP/WS streaming server")
    _add_runtime_args(s)
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--multi-stream", action="store_true", default=True,
                   help="continuous-batching scheduler (default)")
    s.add_argument("--single-stream", dest="multi_stream",
                   action="store_false",
                   help="serialized single-engine mode")
    s.add_argument("--native-protocol", action="store_true",
                   help="C++ token extractor + deinterleave in the "
                        "scheduler hot path (native/tts_runtime.cpp)")
    s.set_defaults(fn=cmd_serve)
    return ap


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    args.argv = argv
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
