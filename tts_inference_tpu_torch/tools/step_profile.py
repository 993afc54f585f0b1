"""Where a decode step's time goes, or a vocoder call's or a train
step's, on the card.

    python -m tts_inference_tpu_torch.tools.step_profile [runtime flags]
    python -m tts_inference_tpu_torch.tools.step_profile --quantize \\
        --weight-bits 4 --paged-kv --kv-int4
    python -m tts_inference_tpu_torch.tools.step_profile --vocoder

Takes the runtime flags of ``cli serve`` (full Orpheus-3B geometry with
seeded random weights unless ``--tiny``). Two engine cores over the same
weights, one launching eagerly (``graphs=False``) and one replaying CUDA
graphs (the serve path on a card), each admit one prompt into every slot
and then time decode launches (``decode_steps_per_call`` steps each, all
slots): the host clock around a launch that ends in a synchronise (wall)
and up to the return of the launch (enqueue), ``torch.profiler`` over one
launch (kernels, device time by kernel family; for the replay, the graph's
kernels), and, for the replay, CUDA events around launches (device time of
the replay as the stream runs it). Prints one JSON line with an "eager" and
a "replayed" part; every number is per decode step. ``--prefill-len n``
admits n tokens instead of the short prompt, which sets the KV window the
decode runs at.

It takes the place of the JAX package's ``tools/profile_decode.py``: its
``--steps`` are ``--launches`` × 7, its ``--batch`` is ``--max-batch-size``,
its ``--prefill-len``, ``--quantize``, ``--weight-bits``, ``--paged-kv``,
``--kv-int8``, ``--kv-int4`` and ``--tiny`` keep their names, its ``--cpu``
is ``--device cpu``; its ``--trace-dir`` has no counterpart (the profile is
read in process and summed by kernel family).

With ``--train`` it times LoRA steps of the fine-tune instead (``python
-m tts_inference_tpu_torch.tools.step_profile --train``: the shape of
``chip_smoke.py``'s train phase, ``train_step.CARD_*``; ``--tiny --device
cpu`` runs 48-token sequences on the CPU without the profile).

With ``--vocoder`` it times one vocoder call instead, as the serve path makes
it with every slot streaming: ``--vocoder-rows`` windows of
``--vocoder-frames`` frames (8 rows of 14 frames, which decode in the
16-frame bucket) through ``SnacDecoder.decode_frames_batch``, by a decoder
that replays the call's CUDA graph (the serve path) and one that launches
eagerly (``--graphs`` / ``--eager``: only that one), in the vocoder's dtype
(``--vocoder-bf16``: bf16); wall (launch to host copy), enqueue (up to the
return of the launch) and kernels, every number per call.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import re
import subprocess
import sys
import time
from typing import Optional

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
    ("unit16_kernel<__nv_bfloat16", "K6-bf16 fused_residual_unit"),
    ("unit16_kernel<__half", "K6-f16 fused_residual_unit"),
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
    """One batched vocoder call, replayed and eager: wall and enqueue by the
    host clock, kernels by the profiler."""
    from tts_inference_tpu_torch.models.snac import SnacDecoder

    rng = np.random.default_rng(0)
    n, size = args.vocoder_frames, rt.config.snac.codebook_size
    layers = [tuple(rng.integers(0, size, m * n) for m in (1, 2, 4))
              for _ in range(args.vocoder_rows)]
    on_card = rt.device.type == "cuda"
    out = {"flags": flags, "device": str(rt.device),
           "dtype": rt.config.snac.dtype, "rows": len(layers), "frames": n,
           "bucket_frames": rt.vocoder.bucket_frames(n)}
    modes = [m for m, on in (("replayed", args.graphs), ("eager", args.eager))
             if on] or ["replayed", "eager"]
    for tag in modes:
        voc = SnacDecoder(rt.vocoder.params, rt.vocoder.cfg,
                          graphs=tag == "replayed",
                          graph_max_frames=rt.vocoder.graph_max_frames)

        def launch():
            return voc.decode_frames_batch_launch(
                layers, first_frames=[0] * len(layers),
                noise_seeds=list(range(len(layers))))

        with voc.warming():
            audio = voc.decode_frames_batch_fetch(launch())
        walls, enqueues = [], []
        for _ in range(args.launches):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            handle = launch()
            t1 = time.perf_counter()
            voc.decode_frames_batch_fetch(handle)   # waits for the copy
            walls.append((time.perf_counter() - t0) * 1e3)
            enqueues.append((t1 - t0) * 1e3)
        row = {"samples_per_row": int(audio[0].shape[0]),
               "wall_ms_per_call": float(np.median(walls)),
               "enqueue_ms_per_call": float(np.median(enqueues)),
               "replays": dict(voc.replays)}
        if on_card:
            prof = _profile(lambda: voc.decode_frames_batch_fetch(launch()),
                            _vocoder_family)
            row.update(kernels_per_call=prof["kernels"],
                       device_ms_per_call=prof["device_ms"],
                       device_ms_per_call_by_family=prof["device_ms_by_family"],
                       kernels_per_call_by_family=prof["kernels_by_family"])
            out["card"] = prof["card"]
        out[tag] = row
        del voc
        gc.collect()
    return out


def decode_launches(rt, core, launches: int,
                    prefill_len: Optional[int] = None) -> dict:
    """Admit a prompt into every slot of `core` (`prefill_len` tokens of id
    1 when given: it sets the cache depth, so the KV window the decode
    runs at), then time `launches` decode launches; per decode step."""
    from tts_inference_tpu_torch.config import SamplingConfig
    from tts_inference_tpu_torch.ops import sampling as S

    sp = S.SamplingParams.from_config(
        SamplingConfig(greedy=True), core.batch, device=core.device)
    prompt = ([1] * prefill_len if prefill_len else
              rt.pipeline.build_prompt("Where does the time go?",
                                       force_speech=True))
    n = rt.config.engine.decode_steps_per_call
    _, tok, act = core.prefill_decode_launch(
        [prompt] * core.batch, list(range(core.batch)), sp,
        np.zeros(core.batch, np.int32), np.zeros(core.batch, bool), n=n,
        reserve_extra=[n * (2 * launches + 8)] * core.batch)
    on_card = core.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def launch():
        nonlocal tok, act
        _, tok, act = core.decode_steps_launch(sp, tok, act, n)

    launch()        # the replayed core captures the graph of this window
    sync()
    walls, enqueues = [], []
    for _ in range(launches):
        t0 = time.perf_counter()
        launch()
        t1 = time.perf_counter()
        sync()
        walls.append((time.perf_counter() - t0) / n * 1e3)
        enqueues.append((t1 - t0) / n * 1e3)
    out = {"wall_ms_per_step": float(np.median(walls)),
           "host_enqueue_ms_per_step": float(np.median(enqueues)),
           "graphs": len(core.graph_census_ms) if core.use_graphs else 0,
           "capture_ms": sum(core.graph_census_ms.values())
           if core.use_graphs else 0.0}
    if on_card:
        prof = _profile(launch, _family, per=n)
        out.update(
            kernels_per_step=prof["kernels"],
            device_ms_per_step=prof["device_ms"],
            device_ms_per_step_by_family=prof["device_ms_by_family"],
            kernels_per_step_by_family=prof["kernels_by_family"],
            card=prof["card"])
        if core.use_graphs:
            # the replay as the stream runs it: events around launches
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                launch()
            end.record()
            torch.cuda.synchronize()
            out["event_ms_per_step"] = start.elapsed_time(end) / (
                launches * n)
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


TRAIN_FAMILIES = (      # kernel-name fragment → family, first match wins
    ("multi_tensor_apply", "optimizer (AdamW)"),
    ("softmax", "softmax, log_softmax"),
    ("gemm", "library matmul"), ("gemv", "library matmul"),
    ("cutlass", "library matmul"), ("nvjet", "library matmul"),
    ("xmma", "library matmul"),
    ("reduce_kernel", "reductions (norms, loss, casts' sums)"),
    ("index", "gathers, scatters, cache writes"),
    ("scatter", "gathers, scatters, cache writes"),
    ("gather", "gathers, scatters, cache writes"),
)


def _train_family(name: str) -> str:
    for frag, fam in TRAIN_FAMILIES:
        if frag in name:
            return fam
    return "elementwise (casts, merges, rope, activations)"


def train_steps(args) -> dict:
    """LoRA steps of the fine-tune (``training/train_step.py`` at
    ``CARD_BATCH`` sequences of ``CARD_LEN`` tokens, 48 with ``--tiny``, of
    synthetic text + 60 frames; r ``CARD_LORA_R`` on the 7 targets) on the
    runtime's weights: the host clock over ``--launches`` steps after two
    warm ones (each step ends in a synchronise: the loss is read), and
    ``torch.profiler`` over one: device ms by kernel family, kernels, and
    the device's busy share (device ms over the median wall)."""
    from tts_inference_tpu_torch import cli
    from tts_inference_tpu_torch.runtime import load_model, model_tokenizer
    from tts_inference_tpu_torch.training import data as D
    from tts_inference_tpu_torch.training import lora as L
    from tts_inference_tpu_torch.training import train_step as T

    cfg = cli._config(args)
    dev = torch.device(args.device or "cuda")
    params, cfg = load_model(cfg, dev, model_path=args.model_path,
                             seed=args.seed)
    b, s, r = T.CARD_BATCH, 48 if args.tiny else T.CARD_LEN, T.CARD_LORA_R
    recs = D.synthetic_records(np.random.default_rng(0), 2 * b, 60)
    tokens, lens = next(D.batches(model_tokenizer(args.model_path), recs,
                                  b, s))
    ad = L.init_lora(torch.Generator(device=dev).manual_seed(1), cfg.model,
                     params, r=r)
    opt = T.make_optimizer(2e-4, 100)
    step = T.make_train_step(cfg.model, opt, base_params=params,
                             lora_scale=L.lora_scale(r, T.CARD_LORA_ALPHA))
    state = T.init_train_state(ad, opt)

    def one():
        float(step(state, tokens, lens)[1])      # reads the loss: a sync

    for _ in range(2):
        one()
    walls = []
    for _ in range(args.launches):
        t0 = time.perf_counter()
        one()
        walls.append((time.perf_counter() - t0) * 1e3)
    out = {"device": str(dev), "batch": b, "len": s, "lora_r": r,
           "step_wall_ms": float(np.median(walls)), "step_wall_ms_all": walls}
    if dev.type == "cuda":
        prof = _profile(one, _train_family)
        out.update(prof, busy_share=prof["device_ms"] / out["step_wall_ms"],
                   peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def main(argv=None) -> int:
    from tts_inference_tpu_torch import cli
    from tts_inference_tpu_torch.engine.engine import EngineCore

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    cli._add_runtime_args(ap)
    ap.add_argument("--launches", type=int, default=5,
                    help="timed decode launches (or vocoder calls)")
    ap.add_argument("--vocoder", action="store_true",
                    help="profile one vocoder call instead of a decode step")
    ap.add_argument("--vocoder-rows", type=int, default=8)
    ap.add_argument("--vocoder-frames", type=int, default=14)
    ap.add_argument("--graphs", action="store_true",
                    help="with --vocoder: only the replayed call")
    ap.add_argument("--eager", action="store_true",
                    help="with --vocoder: only the eager call")
    ap.add_argument("--train", action="store_true",
                    help="profile a LoRA train step instead")
    ap.add_argument("--prefill-len", type=int, default=None,
                    help="decode profile: prompt length per slot (default: "
                         "the envelope of a short sentence); sets the cache "
                         "depth, and so the KV window the decode runs at")
    args = ap.parse_args(argv)
    args.no_warmup = True
    flags = [a for a in (argv or sys.argv[1:])]
    if args.train:
        print(json.dumps({"flags": flags, **train_steps(args)}), flush=True)
        return 0
    with torch.no_grad():
        rt = cli._build_runtime(args)
        if args.vocoder:
            print(json.dumps(vocoder_call(rt, args, flags)), flush=True)
            return 0
        on_card = rt.device.type == "cuda"
        out = {"flags": flags, "device": str(rt.device),
               "slots": rt.config.engine.max_batch_size,
               "steps_per_launch": rt.config.engine.decode_steps_per_call}
        for tag, graphs in (("eager", False), ("replayed", True)):
            core = EngineCore(rt.engine.core.params, rt.config.model,
                              rt.config.engine, device=rt.device,
                              graphs=graphs)
            out[tag] = decode_launches(rt, core, args.launches,
                                       args.prefill_len)
            del core
            gc.collect()
        if on_card:
            out["card"] = out["eager"].pop("card")
            out["replayed"].pop("card")
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
