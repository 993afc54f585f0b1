"""ctypes binding for the C++ streaming runtime (``native/tts_runtime.cpp``).

Port of ``tts_inference_tpu/utils/native.py`` with the same public names:
``NativeExtractor`` and ``native_deinterleave`` are drop-in equivalents of
``protocol.TokenExtractor`` and ``protocol.deinterleave_frames``,
``native_emission_window`` of the lookahead's emission rule.

The library is built at first use from the repository's
``native/tts_runtime.cpp`` with ``native/Makefile``'s flags, into
``build/native/`` under the repository root, named by a hash of the source
and the flags. The compiler writes a temporary file that is moved into
place under a file lock, so processes that build at once never load a
half-written library. Unlike the JAX module there is no fallback: when the
library cannot be built or loaded, ``load`` (and every name here that needs
it) raises, and ``available`` says False.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "tts_runtime.cpp"
BUILD_DIR = _REPO / "build" / "native"
# native/Makefile: CXXFLAGS ?= -O3 -std=c++17 -fPIC -Wall -Wextra; -shared
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

_lock = threading.Lock()
_libs: dict = {}     # source path → the loaded library


def library_path(source: Path) -> Path:
    h = hashlib.sha256(Path(source).read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libtts_runtime-{h.hexdigest()[:16]}.so"


def _build(source: Path, path: Path) -> None:
    """Compile `source` to `path` unless another process did meanwhile."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", str(tmp),
               str(source)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=120)
            if res.returncode != 0:
                raise RuntimeError(f"native runtime build failed "
                                   f"({res.returncode}): {' '.join(cmd)}\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)


def _declare(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ex_create.restype = ctypes.c_void_p
    lib.ex_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ex_destroy.argtypes = [ctypes.c_void_p]
    lib.ex_started.argtypes = [ctypes.c_void_p]
    lib.ex_finished.argtypes = [ctypes.c_void_p]
    lib.ex_total_codes.argtypes = [ctypes.c_void_p]
    lib.ex_total_codes.restype = ctypes.c_int64
    lib.ex_restarts.argtypes = [ctypes.c_void_p]
    lib.ex_restarts.restype = ctypes.c_int64
    lib.ex_feed.restype = ctypes.c_int64
    lib.ex_feed.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int64, i32p,
                            ctypes.c_int64]
    lib.ex_codes.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                             i32p]
    lib.deinterleave.argtypes = [i32p, ctypes.c_int64, i32p, i32p, i32p]
    lib.emission_window.restype = ctypes.c_int
    lib.emission_window.argtypes = [ctypes.c_int64] * 6 + [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]


def load() -> ctypes.CDLL:
    """The native library, built on first use; raises RuntimeError when the
    source is missing or the build or the load fails."""
    source = Path(SOURCE)
    with _lock:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        if not source.is_file():
            raise RuntimeError(f"native runtime source {source} not found")
        path = library_path(source)
        if not path.exists():
            _build(source, path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"native runtime {path} did not load: "
                               f"{e}") from e
        _declare(lib)
        _libs[source] = lib
        return lib


def available() -> bool:
    try:
        load()
    except RuntimeError:
        return False
    return True


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeExtractor:
    """C++ twin of protocol.TokenExtractor (same semantics)."""

    def __init__(self, restart_on_sos: bool = False, started: bool = False):
        self._lib = load()
        self._h = self._lib.ex_create(int(restart_on_sos), int(started))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ex_destroy(h)
            self._h = None

    @property
    def started(self) -> bool:
        return bool(self._lib.ex_started(self._h))

    @property
    def finished(self) -> bool:
        return bool(self._lib.ex_finished(self._h))

    @property
    def total_codes(self) -> int:
        return int(self._lib.ex_total_codes(self._h))

    @property
    def restart_count(self) -> int:
        return int(self._lib.ex_restarts(self._h))

    def feed_many(self, tokens) -> List[int]:
        # both arrays stay referenced until the call returns
        toks = np.ascontiguousarray(tokens, dtype=np.int32)
        out = np.empty(max(len(toks), 1), dtype=np.int32)
        n = self._lib.ex_feed(self._h, _i32ptr(toks), len(toks),
                              _i32ptr(out), len(out))
        return out[:n].tolist()

    def codes_range(self, lo: int, hi: int) -> np.ndarray:
        out = np.empty(max(hi - lo, 0), dtype=np.int32)
        if hi > lo:
            self._lib.ex_codes(self._h, lo, hi, _i32ptr(out))
        return out


def native_deinterleave(codes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    lib = load()
    flat = np.ascontiguousarray(codes, dtype=np.int32)
    n = len(flat) // 7
    flat = flat[: n * 7]
    l1 = np.empty(n, np.int32)
    l2 = np.empty(2 * n, np.int32)
    l3 = np.empty(4 * n, np.int32)
    lib.deinterleave(_i32ptr(flat), n, _i32ptr(l1), _i32ptr(l2), _i32ptr(l3))
    return l1, l2, l3


def native_emission_window(
        samples_emitted: int, total_frames: int, samples_per_frame: int,
        lookahead: int, left_context: int, frames_per_chunk: int,
        flush: bool) -> Optional[Tuple[int, int, int, int]]:
    lib = load()
    out = (ctypes.c_int64 * 4)()
    ok = lib.emission_window(samples_emitted, total_frames,
                             samples_per_frame, lookahead, left_context,
                             frames_per_chunk, int(flush), out)
    if not ok:
        return None
    return tuple(int(x) for x in out)
