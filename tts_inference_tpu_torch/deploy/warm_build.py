"""The warm build of a launch: what a first boot on the card pays once and
later boots reuse, done once before any server starts.

    python -m tts_inference_tpu_torch.deploy.warm_build \\
        --build-info build_info.json [cli serve flags]

The JAX package's launcher ran ``cli aot-compile`` here, which filled the
persistent XLA cache. The port has no such cache: its CUDA graphs are
captured by each process at boot and cannot persist. What persists is the
kernel library (``ops/_build.py``), built by ``nvcc`` into ``build/`` at
first use and reused by every later process of the checkout; a process that
finds it missing builds its own, so N servers started on a fresh checkout
would each run ``nvcc`` over every source. This module, which the launcher
runs in a subprocess (the supervisor itself never makes a CUDA context):

1. loads the kernel library (``_build.load()``: built here if missing; the
   CPU runs the kernels' plain versions and needs none);
2. builds the runtime the serve flags ask for without capturing graphs, as
   ``aot-compile`` loaded it — the boot's weights, quantization and
   tokenizer paths are exercised before any server starts. Under
   ``--tp/--dp/--coordinator`` each process builds its own shard at boot
   (it needs the process group), so only the configuration is resolved;
3. writes ``--build-info`` (``runtime.write_build_info``): the configs, the
   device, the boot timings, and the kernel library's path with the
   seconds its build took here (0.0 when it was already built).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0], allow_abbrev=False)
    ap.add_argument("--build-info", default="build_info.json")
    own, serve_argv = ap.parse_known_args(argv)

    from tts_inference_tpu_torch import cli
    from tts_inference_tpu_torch.runtime import (default_device,
                                                 write_build_info)

    serve = cli.build_parser().parse_args(["serve", *serve_argv])
    t0 = time.perf_counter()
    dev = (torch.device(serve.device) if serve.device is not None
           else default_device())
    library = None
    if dev.type == "cuda":
        from tts_inference_tpu_torch.ops import _build

        _build.load()
        library = {"path": str(_build.library_path()),
                   "build_seconds": _build.build_seconds}
    extra = {"kernel_library": library, "serve_argv": serve_argv}
    if cli._sharded(serve):
        cfg = cli._config(serve)
        write_build_info(own.build_info, cfg, dev,
                         {"runtime": "built per process at boot (sharded)"},
                         **extra)
    else:
        serve.no_warmup = True
        rt = cli._build_runtime(serve)
        rt.load_timings["warm_build_s"] = time.perf_counter() - t0
        rt.write_build_info(own.build_info, **extra)
    print(f"[warm_build] {os.path.abspath(own.build_info)} in "
          f"{time.perf_counter() - t0:.1f} s; kernel library {library}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
