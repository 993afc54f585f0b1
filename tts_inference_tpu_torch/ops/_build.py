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
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

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
    lib.tts_decode_attention.argtypes = [
        p, p, p, p, p, p, p, i, i, i, i, i, i, ll, ll, ctypes.c_float, i, p]
    lib.tts_decode_attention.restype = i
    lib.tts_paged_attention.argtypes = [
        p, p, p, p, ll, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i,
        p]
    lib.tts_paged_attention.restype = i
    lib.tts_paged_attention_int8.argtypes = [
        p, p, p, p, p, p, ll, p, p, p, p, i, i, i, i, i, i, i,
        ctypes.c_float, i, p]
    lib.tts_paged_attention_int8.restype = i
    lib.tts_fused_residual_unit.argtypes = [
        p, p, p, p, p, p, p, p, p, i, i, i, i, ll, ll, ll, p]
    lib.tts_fused_residual_unit.restype = i
    lib.tts_fused_residual_unit_max_dilation.argtypes = [i]
    lib.tts_fused_residual_unit_max_dilation.restype = i
    for t16 in ("bf16", "f16"):
        fn = getattr(lib, f"tts_fused_residual_unit_{t16}")
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, ll, ll, ll,
                       i, i, i, p]
        fn.restype = i
        fn = getattr(lib, f"tts_fused_residual_unit_{t16}_max_dilation")
        fn.argtypes = [i]
        fn.restype = i
    lib.tts_paged_attention_int4.argtypes = [
        p, p, p, p, p, p, ll, p, p, p, p, i, i, i, i, i, i, i,
        ctypes.c_float, i, p]
    lib.tts_paged_attention_int4.restype = i
    lib.tts_quant_matmul.argtypes = [
        p, p, p, p, p, p, i, i, i, i, ll, i, i, i, i, i, i, i, i, p]
    lib.tts_quant_matmul.restype = i
    lib.tts_empty_kernel.argtypes = [p]
    lib.tts_empty_kernel.restype = i


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


_recording = threading.local()   # .deltas: the dict record_launches fills


class LaunchCounter:
    """Count of a wrapper's kernel launches (thread-safe: the scheduler and
    the vocode worker launch from different threads). Inside
    ``record_launches`` a launch of this thread is recorded instead of
    counted: a CUDA-graph capture records what one replay launches, and each
    replay adds that."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        deltas = getattr(_recording, "deltas", None)
        if deltas is not None:
            deltas[self] = deltas.get(self, 0) + n
            return
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n


def launch_counters() -> Dict[str, LaunchCounter]:
    """Every kernel wrapper's launch counter, by the kernel's name in the
    port's kernel table."""
    from tts_inference_tpu_torch.ops import (decode_attention, int4_matmul,
                                             paged_attention,
                                             paged_attention_int4, vocoder)

    return {"K1": decode_attention.launches, "K3a": paged_attention.launches,
            "K3b": paged_attention.launches_int8,
            "K5": paged_attention_int4.launches, "K6": vocoder.launches,
            "K6-bf16": vocoder.launches_bf16, "K6-f16": vocoder.launches_f16,
            "K4": int4_matmul.launches, "K2": int4_matmul.launches_w8}


def launch_counts() -> Dict[str, int]:
    return {k: c.count for k, c in launch_counters().items()}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The kernels launched since `before` (a ``launch_counts()``), those
    that ran only."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


@contextlib.contextmanager
def record_launches():
    """Within the block, this thread's launches go into the yielded dict
    (counter → launches) and are not counted. Other threads count as
    always."""
    prev = getattr(_recording, "deltas", None)
    _recording.deltas = deltas = {}
    try:
        yield deltas
    finally:
        _recording.deltas = prev
