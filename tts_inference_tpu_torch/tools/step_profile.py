"""Where a decode step's time goes, or a vocoder call's, on the card.

    python -m tts_inference_tpu_torch.tools.step_profile [runtime flags]
    python -m tts_inference_tpu_torch.tools.step_profile --quantize \\
        --weight-bits 4 --paged-kv --kv-int4
    python -m tts_inference_tpu_torch.tools.step_profile --vocoder

Takes the runtime flags of ``cli serve`` (full Orpheus-3B geometry with
seeded random weights unless ``--tiny``). Admits one prompt into every slot,
then times decode launches (``decode_steps_per_call`` steps each, all slots)
two ways: the host clock around a launch that ends in a synchronise (wall),
and ``torch.profiler`` over one launch (kernels launched, device time by
kernel family). Prints one JSON line; every number is per decode step.

With ``--vocoder`` it times one vocoder call instead, as the serve path makes
it with every slot streaming: ``--vocoder-rows`` windows of
``--vocoder-frames`` frames (8 rows of 14 frames, which decode in the
16-frame bucket) through ``SnacDecoder.decode_frames_batch``, the same two
ways; every number is per call.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

FAMILIES = (      # kernel-name fragment → family, first match wins
    ("qmm_rows", "K2 w8_mm rows (head)"),
    ("attention_mma", "attention (K1/K3a/K3b/K5)"),
    ("attention_chunk", "attention (f32 queries)"),
    ("attention_combine", "attention combine"),
    ("gemm", "library matmul"), ("gemv", "library matmul"),
    ("cutlass", "library matmul"), ("nvjet", "library matmul"),
)


VOCODER_FAMILIES = (
    ("residual_unit_kernel", "K6 fused_residual_unit"),
    ("conv", "library convolutions"), ("cudnn", "library convolutions"),
    ("xmma", "library convolutions"), ("cutlass", "library convolutions"),
    ("gemm", "library convolutions"), ("nvjet", "library convolutions"),
)


def _vocoder_family(name: str) -> str:
    for frag, fam in VOCODER_FAMILIES:
        if frag in name:
            return fam
    return "elementwise, gathers, noise, copies"


def _profile(fn, family, per: int = 1) -> dict:
    """Kernels launched by fn() and their device time, by family, over
    `per` units of work (torch.profiler over the one call)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fam_us = collections.Counter()
    fam_n = collections.Counter()
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            fam = family(ev.key)
            fam_us[fam] += ev.device_time_total
            fam_n[fam] += ev.count
    return {
        "kernels": sum(fam_n.values()) / per,
        "device_ms": sum(fam_us.values()) / per / 1e3,
        "device_ms_by_family": {k: v / per / 1e3
                                for k, v in fam_us.most_common()},
        "kernels_by_family": {k: v / per for k, v in fam_n.most_common()},
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()}


def vocoder_call(rt, args, flags) -> dict:
    """One batched vocoder call: wall by the host clock, kernels by the
    profiler."""
    rng = np.random.default_rng(0)
    n, size = args.vocoder_frames, rt.config.snac.codebook_size
    layers = [tuple(rng.integers(0, size, m * n) for m in (1, 2, 4))
              for _ in range(args.vocoder_rows)]

    def call():
        return rt.vocoder.decode_frames_batch(
            layers, first_frames=[0] * len(layers),
            noise_seeds=list(range(len(layers))))

    on_card = rt.device.type == "cuda"
    audio = call()
    walls = []
    for _ in range(args.launches):
        t0 = time.perf_counter()
        call()           # ends in the device → host copy: synchronised
        walls.append((time.perf_counter() - t0) * 1e3)
    out = {"flags": flags, "device": str(rt.device),
           "rows": len(layers), "frames": n,
           "bucket_frames": rt.vocoder.bucket_frames(n),
           "samples_per_row": int(audio[0].shape[0]),
           "wall_ms_per_call": float(np.median(walls))}
    if on_card:
        prof = _profile(call, _vocoder_family)
        out.update(kernels_per_call=prof["kernels"],
                   device_ms_per_call=prof["device_ms"],
                   device_ms_per_call_by_family=prof["device_ms_by_family"],
                   kernels_per_call_by_family=prof["kernels_by_family"],
                   card=prof["card"])
    return out


def _family(name: str) -> str:
    # first template argument of the matmul kernels: 0 = int4, 1 = int8
    # (in, out), 2 = int8 (out, in) rows, the tied head
    fmt = re.search(r"qmm_(?:kn|stream)<(?:\(int\))?(\d)", name)
    if fmt:
        return ("K4 int4_mm", "K2 w8_mm",
                "K2 w8_mm rows (head)")[int(fmt.group(1))]
    for frag, fam in FAMILIES:
        if frag in name:
            return fam
    return "elementwise, norms, rope, cache writes, sampling"


def main(argv=None) -> int:
    from tts_inference_tpu_torch import cli
    from tts_inference_tpu_torch.config import SamplingConfig
    from tts_inference_tpu_torch.engine.engine import EngineCore
    from tts_inference_tpu_torch.ops import sampling as S

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    cli._add_runtime_args(ap)
    ap.add_argument("--launches", type=int, default=5,
                    help="timed decode launches (or vocoder calls)")
    ap.add_argument("--vocoder", action="store_true",
                    help="profile one vocoder call instead of a decode step")
    ap.add_argument("--vocoder-rows", type=int, default=8)
    ap.add_argument("--vocoder-frames", type=int, default=14)
    args = ap.parse_args(argv)
    args.no_warmup = True
    flags = [a for a in (argv or sys.argv[1:])]
    with torch.no_grad():
        rt = cli._build_runtime(args)
        if args.vocoder:
            print(json.dumps(vocoder_call(rt, args, flags)), flush=True)
            return 0
        core = EngineCore(rt.engine.core.params, rt.config.model,
                          rt.config.engine, device=rt.device)
        sp = S.SamplingParams.from_config(
            SamplingConfig(greedy=True), core.batch, device=core.device)
        prompt = rt.pipeline.build_prompt("Where does the time go?",
                                          force_speech=True)
        n = rt.config.engine.decode_steps_per_call
        slots = list(range(core.batch))
        _, tok, act = core.prefill_decode_launch(
            [prompt] * core.batch, slots, sp,
            np.zeros(core.batch, np.int32), np.zeros(core.batch, bool), n=n,
            reserve_extra=[n * (args.launches + 4)] * core.batch)
        on_card = core.device.type == "cuda"

        def sync():
            if on_card:
                torch.cuda.synchronize()

        def launch():
            nonlocal tok, act
            _, tok, act = core.decode_steps_launch(sp, tok, act, n)

        launch()
        sync()
        walls, enqueues = [], []
        for _ in range(args.launches):
            t0 = time.perf_counter()
            launch()
            t1 = time.perf_counter()
            sync()
            walls.append((time.perf_counter() - t0) / n * 1e3)
            enqueues.append((t1 - t0) / n * 1e3)
        out = {"flags": flags,
               "device": str(core.device), "slots": core.batch,
               "steps_per_launch": n,
               "wall_ms_per_step": float(np.median(walls)),
               "host_enqueue_ms_per_step": float(np.median(enqueues))}
        if on_card:
            prof = _profile(launch, _family, per=n)
            out.update(
                kernels_per_step=prof["kernels"],
                device_ms_per_step=prof["device_ms"],
                device_ms_per_step_by_family=prof["device_ms_by_family"],
                kernels_per_step_by_family=prof["kernels_by_family"],
                card=prof["card"])
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
