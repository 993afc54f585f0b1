"""Where the time of one 16-bit K6 unit goes, on the card.

    python -m tts_inference_tpu_torch.tools.vocoder_probe \\
        [--source FILE] [--variants ",K6_NO_STAGE1,K6_NO_PRODUCT"] \\
        [--dtype bf16|f16] [--shapes serve,b1]

Builds one copy of a vocoder source (default: the served
``csrc/vocoder.cu``, or ``csrc/vocoder_f16.cu`` with ``--dtype f16``) per
variant, each with its ``-D`` switches (a variant
is a ``+``-joined list; the empty variant is the whole kernel), under
``build/vocoder_probe/``, and times ``tts_fused_residual_unit_bf16`` (or
``_f16``) of each at the serve path's shapes: the 12 units of an 8-row,
16-frame vocoder call (``serve``: C 512 / 256 / 128 / 64 at dilations 1, 3,
9) and the first chunk at batch 1 (``b1``: one row of 8 frames, the same
widths and dilations). The switches of the source skip a stage and leave
its buffers as they are: ``K6_NO_STAGE1`` (no snakes or taps; the product
multiplies whatever lies in the y2 buffers), ``K6_NO_PRODUCT`` (stage 1
and the epilogue, no pointwise product), ``K6_NO_EPILOGUE`` (no outputs)
— wrong results, the time of what is left. The variants are timed in turns (every variant at one shape, then
the next shape), as device µs per call by CUDA-graph replay, beside the
card's name and power limit. One JSON line per shape and a summary line;
the library the port serves with is not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from tts_inference_tpu_torch.ops import _build, vocoder

PROBE_DIR = _build.BUILD_DIR.parent / "vocoder_probe"
WIDTHS = ((512, 32), (256, 256), (128, 1024), (64, 2048))   # (C, T per frame)
SHAPES = {"serve": (8, 16), "b1": (1, 8)}                    # (rows, frames)


def build(source: Path, defines) -> ctypes.CDLL:
    """`source` built alone with `defines` into a library of its own."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(defines).encode())
    out = PROBE_DIR / f"libk6probe-{h.hexdigest()[:12]}.so"
    if not out.exists():
        _build._run([_build._nvcc(), *_build.NVCC_FLAGS,
                     f"-I{_build.CSRC}", *(f"-D{d}" for d in defines),
                     "-shared", "-o", str(out), str(source)])
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # the 16-bit body takes the wrapper's plan; the earlier bf16 kernel
    # (one block per tile, no plan) does not
    lib.planned = "vocoder16.cuh" in source.read_text()
    plan = [i, i, i] if lib.planned else []
    for name in ("tts_fused_residual_unit_bf16", "tts_fused_residual_unit_f16"):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, ll, ll, ll,
                           *plan, p]
            fn.restype = i
    return lib


def time_ms(fn, iters: int = 10, replays: int = 5) -> float:
    """Mean device ms per call: `iters` calls captured in a CUDA graph,
    `replays` replays between two events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def unit_inputs(b: int, c: int, t: int, dtype, gen: torch.Generator):
    """x as the decoder keeps it (channel-first, viewed (B, T, C)), valid
    lengths, and the unit's parameters, seeded."""
    dev = "cuda"

    def u(shape, scale):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * scale).to(dtype)

    x = torch.randn(b, c, t, generator=gen, device=dev).to(dtype) \
        .transpose(1, 2)
    valid = torch.full((b,), t, dtype=torch.int32, device=dev)
    p = [(0.5 + torch.rand(c, generator=gen, device=dev)).to(dtype),
         u((c, 1, 7), 7 ** -0.5), u((c,), 0.1),
         (0.5 + torch.rand(c, generator=gen, device=dev)).to(dtype),
         u((c, c, 1), c ** -0.5), u((c,), 0.1)]
    return x, valid, p


def launcher(lib, dtype, x, valid, p, dil: int):
    fn = getattr(lib, "tts_fused_residual_unit_"
                 + ("bf16" if dtype == torch.bfloat16 else "f16"))
    out = torch.empty_like(x)
    b, t, c = x.shape
    sb, st, sc = x.stride()
    args = (x.data_ptr(), valid.data_ptr(), *(w.data_ptr() for w in p),
            out.data_ptr(), b, t, c, dil, sb, st, sc)
    if lib.planned:
        x_tma, w_tma = vocoder.paths16(x, p[4])
        args += (*vocoder.plan16(b, t, c, vocoder._sm_count(x.device)),
                 int(x_tma) | int(w_tma) << 1)

    def call():   # the stream of the moment: a capture runs on its own
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        return out   # kept alive as long as the call
        if err:
            raise RuntimeError(f"{fn.__name__}: cudaError_t {err}")

    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", default=None,
                    help="default: csrc/vocoder.cu (bf16) or "
                         "csrc/vocoder_f16.cu (f16)")
    ap.add_argument("--variants", default=",K6_NO_STAGE1,K6_NO_PRODUCT",
                    help="comma list of variants; a variant is a +-joined "
                         "list of defines, the empty one the whole kernel")
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f16"))
    ap.add_argument("--shapes", default="serve,b1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vocoder_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    if args.source is None:
        args.source = str(_build.CSRC / ("vocoder.cu" if args.dtype == "bf16"
                                         else "vocoder_f16.cu"))
    variants = [v for v in args.variants.split(",")]
    libs = {v: build(Path(args.source), [d for d in v.split("+") if d])
            for v in variants}
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float16
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {}
    for shape in args.shapes.split(","):
        rows, frames = SHAPES[shape]
        for c, t_frame in WIDTHS:
            for dil in (1, 3, 9):
                x, valid, p = unit_inputs(rows, c, frames * t_frame, dtype,
                                          gen)
                ms = {v: time_ms(launcher(libs[v], dtype, x, valid, p, dil))
                      for v in variants}
                for v, m in ms.items():
                    totals.setdefault(shape, {}).setdefault(v, 0.0)
                    totals[shape][v] += m
                print(json.dumps({
                    "shape": shape, "rows": rows, "frames": frames, "c": c,
                    "t": frames * t_frame, "dil": dil, "dtype": args.dtype,
                    "us": {v or "whole": round(m * 1e3, 2)
                           for v, m in ms.items()}}), flush=True)
    print(json.dumps({"card": card.strip(), "source": args.source,
                      "total_us": {s: {v or "whole": round(m * 1e3, 1)
                                       for v, m in d.items()}
                                   for s, d in totals.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
