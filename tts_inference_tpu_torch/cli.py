"""CLI entry points of the port: ``generate`` and ``serve``.

    python -m tts_inference_tpu_torch.cli serve --port 8000
    python -m tts_inference_tpu_torch.cli generate --text "hi" --tiny \\
        --device cpu --force-speech --audio-only --output out.wav

Defaults are the JAX package's ``cli serve`` defaults: Orpheus-3B geometry
with seeded random bf16 weights, 8 continuous-batching slots, max_seq 4608,
the f32 SNAC 24 kHz vocoder. The KV cache and admission options map onto
``EngineConfig`` as the JAX CLI maps them (``--paged-kv``, ``--kv-int8``,
``--kv-int4``, ``--kv-on-demand``, ``--kv-pool-tokens``, ``--kv-block-size``,
``--admission-policy``, ``--reserved-short-slots``, ``--short-tokens``);
``--quantize [--weight-bits 4]`` quantizes the LM weights at boot (kernels K2
and K4). Without ``--device`` both commands run on ``cuda`` and fail when
there is none; ``--device cpu`` asks for the CPU.
Options of configurations that are not ported yet are accepted by the
parser and rejected with the ROADMAP item that ports them — the port never
runs a different path silently.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

# flag → the ROADMAP.md item that ports it
UNPORTED = {
    "prefix_cache": "prefix cache (ROADMAP.md Queue 1 item 12)",
    "vocoder_bf16": "bf16 vocoder (ROADMAP.md Queue 1 item 14)",
    "tp": "tensor parallelism (ROADMAP.md Queue 1 item 15, multi-GPU)",
    "dp": "data parallelism (ROADMAP.md Queue 1 item 15, multi-GPU)",
}


def _add_runtime_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--tiny", action="store_true",
                   help="tiny random-weight runtime (tests, CPU)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; an error when there is "
                        "none — ask for the CPU with --device cpu)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--max-output-len", type=int, default=None)
    p.add_argument("--max-batch-size", type=int, default=None)
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
    for flag in ("prefix_cache", "vocoder_bf16"):
        p.add_argument("--" + flag.replace("_", "-"), action="store_true",
                       help=f"not ported yet: {UNPORTED[flag]}")
    p.add_argument("--tp", type=int, default=1,
                   help=f"not ported yet: {UNPORTED['tp']}")
    p.add_argument("--dp", type=int, default=1,
                   help=f"not ported yet: {UNPORTED['dp']}")


def check_ported(args) -> None:
    """Reject options whose configuration is not ported yet."""
    for flag, item in UNPORTED.items():
        val = getattr(args, flag, None)
        if (flag in ("tp", "dp") and val not in (None, 1)) or val is True:
            opt = "--" + flag.replace("_", "-")
            raise SystemExit(f"{opt} is not ported to tts_inference_tpu_torch "
                             f"yet: {item}")


def _build_runtime(args):
    from tts_inference_tpu_torch.config import (Config, extended_kv_buckets,
                                          tiny_config)
    from tts_inference_tpu_torch.runtime import Runtime

    check_ported(args)
    cfg = tiny_config() if args.tiny else Config()
    eng_over = {}
    if args.max_output_len:
        eng_over["max_output_len"] = args.max_output_len
    if args.max_batch_size:
        eng_over["max_batch_size"] = args.max_batch_size
    for flag, field in (("paged_kv", "paged_kv"),
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
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, kv_buckets=extended_kv_buckets(
            cfg.engine.kv_buckets, cfg.engine.max_seq_len)))
    return Runtime.create(cfg, seed=args.seed, device=args.device,
                          warmup=not args.no_warmup, quantize=args.quantize,
                          weight_bits=args.weight_bits)


def cmd_generate(args) -> int:
    from tts_inference_tpu_torch import protocol
    from tts_inference_tpu_torch.config import SamplingConfig
    from tts_inference_tpu_torch.utils.audio import duration_s, write_wav

    rt = _build_runtime(args)
    sampling = SamplingConfig(
        temperature=args.temperature, top_p=args.top_p,
        repetition_penalty=args.repetition_penalty,
        max_tokens=args.max_tokens, greedy=args.greedy, seed=args.seed,
        token_range=((protocol.TOKEN_AUDIO_BASE,
                      protocol.TOKEN_AUDIO_BASE + protocol.AUDIO_VOCAB)
                     if args.audio_only else None),
    )
    t0 = time.perf_counter()
    pcm, metrics = rt.pipeline.synthesize(args.text, args.voice, sampling,
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
        "rtf": round(metrics.rtf, 3),
        "chunks": metrics.chunks,
    }))
    return 0


def build_serving(args):
    """The runtime and (by default) the continuous-batching scheduler that
    ``serve`` puts behind its HTTP/WS app."""
    rt = _build_runtime(args)
    scheduler = None
    if args.multi_stream:
        from tts_inference_tpu_torch.engine.scheduler import Scheduler

        scheduler = Scheduler(rt.engine.core.params, rt.config, rt.vocoder,
                              rt.tokenizer, seed=args.seed, device=rt.device)
        if not args.no_warmup:
            print(json.dumps({"warmup": scheduler.warmup()}), flush=True)
    return rt, scheduler


def cmd_serve(args) -> int:
    from tts_inference_tpu_torch.serving.app import run_app

    rt, scheduler = build_serving(args)
    return run_app(rt, host=args.host, port=args.port, scheduler=scheduler)


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

    s = sub.add_parser("serve", help="HTTP/WS streaming server")
    _add_runtime_args(s)
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--multi-stream", action="store_true", default=True,
                   help="continuous-batching scheduler (default)")
    s.add_argument("--single-stream", dest="multi_stream",
                   action="store_false",
                   help="serialized single-engine mode")
    s.set_defaults(fn=cmd_serve)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
