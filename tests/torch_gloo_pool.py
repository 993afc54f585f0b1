"""A pool of gloo worker processes for the port's sharded tests.

One pool per test module (a module-scoped fixture): `size` processes,
started once, form one gloo process group over localhost; `run(fn, **kw)`
sends every worker the same call of ``tests.torch_mesh_work.<fn>(**kw)``
and returns each rank's result, in rank order. Workers run torch on one
thread. A call that raises on any rank raises here with that rank's
traceback; a call that hangs in a collective errors out after the group's
timeout.
"""

from __future__ import annotations

import os
import secrets
import shutil
import socket
import subprocess
import sys
import tempfile
import traceback
from multiprocessing.connection import Client, Listener

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class GlooPool:
    def __init__(self, size: int = 4, timeout_s: int = 120):
        self.size = size
        self.timeout_s = timeout_s
        key = secrets.token_bytes(16)
        self._listener = Listener(("127.0.0.1", 0), authkey=key)
        host, port = self._listener.address
        # the group meets through a file, so no port can be taken meanwhile
        self._dir = tempfile.mkdtemp(prefix="gloo_pool_")
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   TTS_POOL_ADDR=f"{host}:{port}", TTS_POOL_KEY=key.hex(),
                   TTS_POOL_GROUP=os.path.join(self._dir, "store"),
                   TTS_POOL_SIZE=str(size), TTS_POOL_TIMEOUT=str(timeout_s),
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        self._procs = [subprocess.Popen(
            [sys.executable, "-m", "tests.torch_gloo_pool", str(r)],
            cwd=ROOT, env=env) for r in range(size)]
        conns = {}
        for _ in range(size):
            c = self._listener.accept()
            conns[c.recv()] = c
        self._conns = [conns[r] for r in range(size)]

    def run(self, fn: str, **kw) -> list:
        for c in self._conns:
            c.send((fn, kw))
        out, errs = [], []
        for r, c in enumerate(self._conns):
            if not c.poll(self.timeout_s + 60):
                raise TimeoutError(f"pool rank {r}: no answer to {fn}")
            ok, val = c.recv()
            (out if ok else errs).append(val if ok else f"rank {r}:\n{val}")
        if errs:
            raise RuntimeError(f"{fn} failed:\n" + "\n".join(errs))
        return out

    def close(self) -> None:
        for c in self._conns:
            try:
                c.send(None)
            except OSError:
                pass
        for p in self._procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
        self._listener.close()
        shutil.rmtree(self._dir, ignore_errors=True)


def _worker(rank: int) -> None:
    import datetime
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    host, port = os.environ["TTS_POOL_ADDR"].rsplit(":", 1)
    conn = Client((host, int(port)),
                  authkey=bytes.fromhex(os.environ["TTS_POOL_KEY"]))
    conn.send(rank)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.environ['TTS_POOL_GROUP']}",
        world_size=int(os.environ["TTS_POOL_SIZE"]), rank=rank,
        timeout=datetime.timedelta(
            seconds=int(os.environ["TTS_POOL_TIMEOUT"])))
    work = importlib.import_module("tests.torch_mesh_work")
    while True:
        msg = conn.recv()
        if msg is None:
            break
        fn, kw = msg
        try:
            conn.send((True, getattr(work, fn)(**kw)))
        except Exception:  # noqa: BLE001 — reported to the test
            conn.send((False, traceback.format_exc()))
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]))
