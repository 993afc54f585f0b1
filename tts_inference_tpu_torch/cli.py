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
    "tp": "tensor parallelism (ROADMAP.md Queue 1 item 15, multi-GPU)",
    "dp": "data parallelism (ROADMAP.md Queue 1 item 15, multi-GPU)",
}


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


def _config(args):
    """The Config the flags ask for, as the JAX CLI maps them."""
    from tts_inference_tpu_torch.config import (Config, extended_kv_buckets,
                                                tiny_config)

    check_ported(args)
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
    return cfg


def _build_runtime(args):
    from tts_inference_tpu_torch.runtime import Runtime

    return Runtime.create(_config(args), model_path=args.model_path,
                          snac_path=args.snac_path, lora_path=args.lora_path,
                          tokenizer_path=args.tokenizer_path, seed=args.seed,
                          device=args.device, warmup=not args.no_warmup,
                          quantize=args.quantize,
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
        "tokens_per_sec": round(metrics.tokens_per_sec, 1),
        "rtf": round(metrics.rtf, 3),
        "chunks": metrics.chunks,
    }))
    return 0


def cmd_dump_tokens(args) -> int:
    from tts_inference_tpu_torch.config import SamplingConfig

    rt = _build_runtime(args)
    prompt = rt.pipeline.build_prompt(args.text, args.voice)
    res = rt.engine.generate(
        prompt, SamplingConfig(max_tokens=args.max_tokens, seed=args.seed))
    print(json.dumps({"prompt_ids": prompt, "token_ids": res.token_ids,
                      "timings": res.timings}))
    return 0


def cmd_quantize(args) -> int:
    """Offline weight quantization: checkpoint in → pre-quantized checkpoint
    out (``params.safetensors`` + ``metadata.json``). A boot from the output
    skips the quantization. The int4 group is ``TTS_INT4_GROUP`` (512 by
    default), as in the JAX package."""
    import torch

    from tts_inference_tpu_torch.models.quant import (QuantEmbed,
                                                      QuantLinear,
                                                      quantize_llama_params,
                                                      to_plain)
    from tts_inference_tpu_torch.runtime import default_device, load_model
    from tts_inference_tpu_torch.training.checkpoint import save_params

    t0 = time.perf_counter()
    cfg = _config(args)
    dev = torch.device(args.device) if args.device else default_device()
    params, cfg = load_model(cfg, dev, model_path=args.model_path,
                             lora_path=args.lora_path, seed=args.seed,
                             quantize=args.quantize,
                             weight_bits=args.weight_bits)
    load_s = time.perf_counter() - t0
    if not isinstance(params.get("embed"), (QuantEmbed, QuantLinear)):
        params = quantize_llama_params(params, bits=args.weight_bits,
                                       free_source=True)
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
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
