"""Where a decode step's time goes, on the card.

    python -m tts_inference_tpu_torch.tools.step_profile [runtime flags]
    python -m tts_inference_tpu_torch.tools.step_profile --quantize \\
        --weight-bits 4 --paged-kv --kv-int4

Takes the runtime flags of ``cli serve`` (full Orpheus-3B geometry with
seeded random weights unless ``--tiny``). Admits one prompt into every slot,
then times decode launches (``decode_steps_per_call`` steps each, all slots)
two ways: the host clock around a launch that ends in a synchronise (wall),
and ``torch.profiler`` over one launch (kernels launched, device time by
kernel family). Prints one JSON line; every number is per decode step.
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
    ("qmm_reduce", "K4/K2 split reduce"),
    ("attention_chunk", "attention (K1/K3/K5)"),
    ("attention_combine", "attention combine"),
    ("gemm", "library matmul"), ("gemv", "library matmul"),
    ("cutlass", "library matmul"), ("nvjet", "library matmul"),
)


def _family(name: str) -> str:
    if "qmm_kn" in name:     # template argument 0 = int4, 1 = int8
        return "K4 int4_mm" if re.search(r"<(\(int\))?0>", name) \
            else "K2 w8_mm"
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
                    help="timed decode launches")
    args = ap.parse_args(argv)
    args.no_warmup = True
    with torch.no_grad():
        rt = cli._build_runtime(args)
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
        out = {"flags": [a for a in (argv or sys.argv[1:])],
               "device": str(core.device), "slots": core.batch,
               "steps_per_launch": n,
               "wall_ms_per_step": float(np.median(walls)),
               "host_enqueue_ms_per_step": float(np.median(enqueues))}
        if on_card:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                launch()
                sync()
            fam_us = collections.Counter()
            fam_n = collections.Counter()
            for ev in prof.key_averages():
                if ev.device_type == torch.autograd.DeviceType.CUDA:
                    fam = _family(ev.key)
                    fam_us[fam] += ev.device_time_total
                    fam_n[fam] += ev.count
            total_us = sum(fam_us.values())
            out.update(
                kernels_per_step=sum(fam_n.values()) / n,
                device_ms_per_step=total_us / n / 1e3,
                device_ms_per_step_by_family={
                    k: v / n / 1e3 for k, v in fam_us.most_common()},
                kernels_per_step_by_family={
                    k: v / n for k, v in fam_n.most_common()},
                card=subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"], capture_output=True,
                    text=True).stdout.strip())
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
