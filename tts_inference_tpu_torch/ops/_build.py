"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file (with the ``csrc/*.cuh`` headers they share) is
compiled by ``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per source and all
of them started together, and linked into ONE shared library with a plain C
interface, which is loaded with ctypes. The build runs at first use (never at import: the CPU tests import every
module, and no CUDA toolkit is needed to run them), into
``build/tts_kernels/`` under the repository root, named by a hash of the
sources so an edited kernel is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tts_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log: str = ""          # nvcc's output (ptxas register / smem report)
build_seconds: float = 0.0   # 0.0 when the library was already built


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or CUDA_HOME)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtts_kernels-{h.hexdigest()[:16]}.so"


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tts_decode_attention_splits.argtypes = [i]
    lib.tts_decode_attention_splits.restype = i
    lib.tts_decode_attention.argtypes = [
        p, p, p, p, p, p, i, i, i, i, i, ll, ll, ctypes.c_float, i, p]
    lib.tts_decode_attention.restype = i
    lib.tts_paged_attention_splits.argtypes = [i, i]
    lib.tts_paged_attention_splits.restype = i
    lib.tts_paged_attention.argtypes = [
        p, p, p, p, ll, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
    lib.tts_paged_attention.restype = i
    lib.tts_paged_attention_int8.argtypes = [
        p, p, p, p, p, p, ll, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
    lib.tts_paged_attention_int8.restype = i
    lib.tts_fused_residual_unit.argtypes = [
        p, p, p, p, p, p, p, p, p, i, i, i, i, ll, ll, ll, p]
    lib.tts_fused_residual_unit.restype = i
    lib.tts_paged_attention_int4.argtypes = [
        p, p, p, p, p, p, ll, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
    lib.tts_paged_attention_int4.restype = i
    lib.tts_quant_matmul_splits.argtypes = [p, i, i, i, i, ll, i, i, i]
    lib.tts_quant_matmul_splits.restype = i
    lib.tts_quant_matmul.argtypes = [
        p, p, p, p, p, i, i, i, i, ll, i, i, i, i, p]
    lib.tts_quant_matmul.restype = i


def _run(cmd) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    return log


def _compile(path: Path) -> str:
    """One ``nvcc -c`` per source, all at once, then one link; returns the
    compilers' output."""
    nvcc = _nvcc()
    tag = f"{path.stem}.{os.getpid()}"
    srcs = _sources()
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    tmp = BUILD_DIR / f"{tag}.tmp"
    try:
        with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
            logs = list(pool.map(
                lambda so: _run([nvcc, *NVCC_FLAGS, "-c", str(so[0]), "-o",
                                 str(so[1])]), zip(srcs, objs)))
        logs.append(_run([nvcc, "-shared", "-o", str(tmp),
                          *(str(o) for o in objs)]))
        os.replace(tmp, path)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return "".join(logs)


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first call in this process."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            build_log = _compile(path)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a cudaError_t other than cudaSuccess."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


class LaunchCounter:
    """Count of a wrapper's kernel launches (thread-safe: the scheduler and
    the vocode worker launch from different threads)."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n
