"""Where the time of one K4 / K2 call goes, on the card.

    python -m tts_inference_tpu_torch.tools.qmm_probe [--defines A,B]
    python -m tts_inference_tpu_torch.tools.qmm_probe --time --defines A,B

Builds a copy of the kernel library with ``-DQMM_TRACE`` (thread 0 of every
block of the tensor-core kernel stamps the card's nanosecond timer at each
phase), runs ``int4_mm`` / ``w8_mm`` through it at the serve path's decode
and prefill shapes over weights that were not read before, and prints for
each phase the earliest, median and latest time over the blocks, in µs from
the first block's entry, and for block 0, in thousands of SM cycles from its
first request, when each of its first 16 units was requested, seen to have
landed, and multiplied. ``--defines`` adds probe switches of the source:
``QMM_NO_MMA``, ``QMM_NO_DEQUANT``, ``QMM_NO_CONSUME`` (the stages are
streamed and nothing is multiplied), ``QMM_NO_BULK`` (x and K4's scales by
``cp.async`` of all producer lanes), ``QMM_STAGES=n`` (depth of the ring at
a decode step) — wrong results, and the time of what is left. With
``--time`` nothing is traced: the served library and a copy built with the
switches are timed in turns at the same shapes (device µs per call, CUDA
graph replay over weights that rotate through more than the L2 holds; run
it from the repository root, it uses ``chip_smoke.time_ms``). The library
the port serves with is not touched.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

PHASES = ("entry", "requested", "first stage landed", "last product",
          "partial tile ready", "met the tile's blocks", "end")


def probe_library(defines=(), traced: bool = True):
    """A copy of the matmul kernels built with `defines` (and the stamps)."""
    from tts_inference_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    defines = [*(["QMM_TRACE"] if traced else []), *defines]
    out = _build.BUILD_DIR / ("libqmm_" + "_".join(defines) + ".so")
    _build._run([_build._nvcc(), *_build.NVCC_FLAGS,
                 *(f"-D{d}" for d in defines), "-shared", "-o", str(out),
                 str(_build.CSRC / "quant_matmul.cu")])
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tts_quant_matmul.argtypes = [
        p, p, p, p, p, p, i, i, i, i, ll, i, i, i, i, i, i, i, i, p]
    lib.tts_quant_matmul.restype = i
    if traced:
        lib.tts_qmm_trace.argtypes = [ctypes.c_void_p]
        lib.tts_qmm_trace.restype = ctypes.c_int
        lib.tts_qmm_trace_units.argtypes = [ctypes.c_void_p]
        lib.tts_qmm_trace_units.restype = ctypes.c_int
    return lib


def trace(lib, fn, blocks: int, units0: int = 16) -> dict:
    """Run `fn` once and read the stamps of its `blocks` blocks; `units0`:
    the units of block 0's run (the buffers keep older launches' stamps)."""
    fn()
    torch.cuda.synchronize()
    buf = np.zeros((1024, 8), np.uint64)
    err = lib.tts_qmm_trace(buf.ctypes.data)
    if err:
        raise RuntimeError(f"tts_qmm_trace: cudaError_t {err}")
    t = buf[:min(blocks, 1024), :len(PHASES)].astype(np.int64)
    t0 = t[:, 0].min()
    out = {}
    for i, name in enumerate(PHASES):
        col = t[:, i][t[:, i] >= t0]       # blocks that passed this phase
        if col.size:
            out[name] = [round(float(v - t0) / 1e3, 2) for v in
                         (col.min(), np.median(col), col.max())]
    # block 0, unit by unit: requested, seen landed, multiplied
    units = np.zeros((1024, 3, 16), np.uint64)
    err = lib.tts_qmm_trace_units(units.ctypes.data)
    if err:
        raise RuntimeError(f"tts_qmm_trace_units: cudaError_t {err}")
    first = units[0, :, :units0].astype(np.int64)
    first = first - first.min()
    out["block 0 by unit, SM kilocycles: requested / landed / multiplied"] = [
        [round(float(v) / 1e3, 2) for v in row[:units0]] for row in first]
    return out


def timed(shapes, defines, gen) -> int:
    """Device µs per call of the served library and of a copy built with
    `defines`, in turns (served, probe, served, probe) at each shape."""
    import chip_smoke
    from tts_inference_tpu_torch.models.quant import (quantize_linear,
                                                      quantize_linear_i4)
    from tts_inference_tpu_torch.ops import _build
    from tts_inference_tpu_torch.ops import int4_matmul as Q

    libs = (("served", _build.load()),
            ("+".join(defines) or "copy", probe_library(defines, False)))
    for m, k, n in shapes:
        x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        ws = [chip_smoke._qmm_weight(k, n, torch.bfloat16, gen)
              for _ in range(chip_smoke._copies(k * n // 2))]
        q4 = [quantize_linear_i4(w, 512) for w in ws]
        q8 = [quantize_linear(w) for w in ws[:len(ws) // 2 + 1]]
        for name, lib in libs * 2:
            _build._lib = lib
            print(json.dumps({
                "m": m, "k": k, "n": n, "library": name,
                "K4_us": round(1e3 * chip_smoke.time_ms(
                    Q.int4_mm, rotate=[(x, q.w_p, q.scale) for q in q4]), 2),
                "K2_us": round(1e3 * chip_smoke.time_ms(
                    Q.w8_mm, rotate=[(x, q.w_i8, q.scale) for q in q8]), 2),
            }), flush=True)
    _build._lib = libs[0][1]
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--defines", default="", help="comma list of further "
                    "-D switches of csrc/quant_matmul.cu for a probe build "
                    "whose results are wrong and whose times show what a "
                    "phase costs: QMM_NO_MMA, QMM_NO_DEQUANT, "
                    "QMM_NO_CONSUME, QMM_NO_BULK, QMM_STAGES=n")
    ap.add_argument("--time", action="store_true", help="trace nothing: "
                    "time the served library and the probe build in turns")
    args = ap.parse_args(argv)
    defines = [d for d in args.defines.split(",") if d]
    from tts_inference_tpu_torch.models.quant import (quantize_linear,
                                                      quantize_linear_i4)
    from tts_inference_tpu_torch.ops import _build
    from tts_inference_tpu_torch.ops import int4_matmul as Q

    if not torch.cuda.is_available():
        print("qmm_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    print("defines:", defines, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = ((8, 3072, 3072), (8, 3072, 1024), (8, 3072, 8192),
              (8, 8192, 3072), (512, 3072, 3072))
    if args.time:
        return timed(shapes, defines, gen)
    lib = probe_library(defines)
    _build._lib = lib          # the wrappers launch through the traced copy
    sms = Q.workspace(torch.device("cuda", 0)).sms
    for m, k, n in shapes:
        x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        for name, fmt in (("K4", Q.FMT_I4), ("K2", Q.FMT_I8)):
            # one warm-up weight, one that no cache has seen
            ws = [torch.randn(k, n, generator=gen, device="cuda").bfloat16()
                  * k ** -0.5 for _ in range(2)]
            if fmt == Q.FMT_I4:
                qs = [quantize_linear_i4(w, 512) for w in ws]
                calls = [lambda q=q: Q.int4_mm(x, q.w_p, q.scale) for q in qs]
            else:
                qs = [quantize_linear(w) for w in ws]
                calls = [lambda q=q: Q.w8_mm(x, q.w_i8, q.scale) for q in qs]
            calls[0]()
            p = Q.plan(fmt, m, k, n, 512, sms)
            print(json.dumps({"kernel": name, "m": m, "k": k, "n": n,
                              "blocks": p.blocks, "units": p.units,
                              "us_min_median_max": trace(
                                  lib, calls[1], p.blocks,
                                  min(16, p.units // p.blocks))}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
