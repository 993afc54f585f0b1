"""Warm-lifecycle launcher of the port's server: one supervised ``cli
serve``, N replicas behind the front router, or a lockstep group.

Port of ``deploy/launch.py`` with its flags, policies and last JSON lines
(``{"restarts": n}``, ``{"restarts": {name: n}}``, ``{"group_restarts":
n}``); every process it starts runs the port:

    python -m tts_inference_tpu_torch.deploy.launch --port 8000 \
        -- [serve flags]
    python -m tts_inference_tpu_torch.deploy.launch --port 8000 \
        --replicas 2 -- [serve flags]
    python -m tts_inference_tpu_torch.deploy.launch --port 8000 \
        --lockstep-processes 2 -- --tp 2 [serve flags]

The arguments after ``--`` pass through verbatim to ``cli serve`` (the
port's spellings: ``--device cpu`` for the CPU). Phases:

1. **warm build** (once, before any child starts; ``--skip-build`` skips
   it): ``deploy/warm_build.py`` in a subprocess with the serve flags loads
   the kernel library (built there if missing, so N children never each
   run ``nvcc``), builds the runtime without capturing graphs and writes
   ``--build-info``. CUDA graphs are captured by each server at boot and
   cannot persist, so the JAX launcher's ``aot-compile`` has no port.
2. **serve**: spawns the children, waits for ``GET /health`` to go ready.
3. **watch**: polls /health every ``--health-interval``; a crashed or
   unresponsive child is restarted with exponential backoff.
4. **drain**: SIGTERM/SIGINT forwards to the children and waits up to
   ``--drain-s`` for in-flight requests before killing.

Each kind of child command is built by one function (``serve_cmd``,
``router_cmd``, ``lockstep_cmd``, ``warm_build_cmd``).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

CLI = "tts_inference_tpu_torch.cli"


def serve_cmd(host: str, port: int, serve_args) -> list:
    """One server: ``cli serve`` on host:port with the serve flags."""
    return [sys.executable, "-m", CLI, "serve", "--host", host,
            "--port", str(port), *serve_args]


def router_cmd(host: str, port: int, replica_ports) -> list:
    """The front router on host:port over the local replicas' ports."""
    return [sys.executable, "-m", "tts_inference_tpu_torch.deploy.router",
            "--host", host, "--port", str(port),
            *sum((["--replica", f"http://127.0.0.1:{p}"]
                  for p in replica_ports), [])]


def lockstep_cmd(rank: int, n: int, coordinator_port: int,
                 lockstep_port: int, host: str, port: int,
                 serve_args) -> list:
    """Member `rank` of an n-process lockstep group; rank 0 serves the API
    on host:port and hosts the ``torch.distributed`` rendezvous."""
    cmd = [sys.executable, "-m", CLI, "serve",
           "--coordinator", f"127.0.0.1:{coordinator_port}",
           "--num-processes", str(n), "--process-id", str(rank),
           "--lockstep-port", str(lockstep_port), *serve_args]
    if rank == 0:
        cmd += ["--host", host, "--port", str(port)]
    return cmd


def warm_build_cmd(build_info: str, serve_args) -> list:
    """The warm build with the serve flags (``deploy/warm_build.py``)."""
    return [sys.executable, "-m", "tts_inference_tpu_torch.deploy.warm_build",
            "--build-info", build_info, *serve_args]


def warm_build(args, serve_args) -> None:
    cmd = warm_build_cmd(args.build_info, serve_args)
    print(f"[launch] warm build: {' '.join(cmd)}", flush=True)
    subprocess.run(cmd, check=True)


def http_ok(url: str, timeout: float = 2.0) -> bool:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status == 200
    except Exception:
        return False


class Launcher:
    def __init__(self, args, serve_args):
        self.args = args
        self.serve_args = serve_args
        self.proc: subprocess.Popen | None = None
        self.stopping = False
        self.restarts = 0

    # -- phases --------------------------------------------------------------

    def spawn(self) -> None:
        cmd = serve_cmd(self.args.host, self.args.port, self.serve_args)
        print(f"[launch] serve: {' '.join(cmd)}", flush=True)
        self.proc = subprocess.Popen(cmd)

    def wait_ready(self, timeout: float) -> bool:
        url = f"http://127.0.0.1:{self.args.port}/health"
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.proc is not None and self.proc.poll() is not None:
                return False
            if http_ok(url):
                print("[launch] ready", flush=True)
                return True
            time.sleep(0.5)
        return False

    def drain(self) -> None:
        if self.proc is None or self.proc.poll() is not None:
            return
        print(f"[launch] draining (≤{self.args.drain_s}s)…", flush=True)
        self.proc.send_signal(signal.SIGTERM)
        try:
            self.proc.wait(timeout=self.args.drain_s)
        except subprocess.TimeoutExpired:
            print("[launch] drain timeout — killing", flush=True)
            self.proc.kill()
            self.proc.wait()

    # -- supervision ----------------------------------------------------------

    def run(self) -> int:
        def on_term(signum, frame):
            self.stopping = True
            self.drain()

        signal.signal(signal.SIGTERM, on_term)
        signal.signal(signal.SIGINT, on_term)

        if not self.args.skip_build:
            warm_build(self.args, self.serve_args)

        backoff = 1.0
        url = f"http://127.0.0.1:{self.args.port}/health"
        while not self.stopping:
            self.spawn()
            if not self.wait_ready(self.args.ready_timeout_s):
                if self.stopping:
                    break
                print("[launch] server failed to become ready", flush=True)
            else:
                backoff = 1.0
                misses = 0
                while not self.stopping:
                    time.sleep(self.args.health_interval)
                    if self.proc.poll() is not None:
                        print(f"[launch] server exited "
                              f"rc={self.proc.returncode}", flush=True)
                        break
                    if http_ok(url):
                        misses = 0
                    else:
                        misses += 1
                        if misses >= self.args.health_misses:
                            print("[launch] health check failing — "
                                  "restarting", flush=True)
                            self.drain()
                            break
            if self.stopping:
                break
            self.restarts += 1
            if (self.args.max_restarts is not None
                    and self.restarts > self.args.max_restarts):
                print("[launch] restart limit reached", flush=True)
                return 1
            print(f"[launch] restart #{self.restarts} in {backoff:.0f}s",
                  flush=True)
            time.sleep(backoff)
            backoff = min(backoff * 2, 60.0)
        self.drain()
        print(json.dumps({"restarts": self.restarts}), flush=True)
        return 0


class _Managed:
    """One supervised child process with health URL + restart backoff."""

    def __init__(self, name: str, cmd: list, health_url: str,
                 ready_timeout_s: float = 600.0):
        self.name = name
        self.cmd = cmd
        self.health_url = health_url
        self.ready_timeout_s = ready_timeout_s
        self.proc: subprocess.Popen | None = None
        self.backoff = 1.0
        self.restarts = 0
        self.misses = 0
        self.next_spawn = 0.0   # monotonic deadline for a pending respawn
        self.ready = False      # first /health 200 seen since last spawn
        self.ready_deadline = 0.0

    def spawn(self) -> None:
        print(f"[launch] {self.name}: {' '.join(self.cmd)}", flush=True)
        self.proc = subprocess.Popen(self.cmd)
        self.misses = 0
        self.ready = False
        self.ready_deadline = time.monotonic() + self.ready_timeout_s

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def drain(self, drain_s: float) -> None:
        if not self.alive():
            return
        self.proc.send_signal(signal.SIGTERM)
        try:
            self.proc.wait(timeout=drain_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


class ReplicaLauncher:
    """N serving replicas (ports port+1..port+N) behind the front router
    (``deploy/router.py``) on `port`. Each child is supervised
    independently: a crashed/unhealthy replica restarts with backoff while
    the router keeps serving from the rest. The replicas share the
    process's devices: nothing pins a replica to a card."""

    def __init__(self, args, serve_args):
        self.args = args
        self.serve_args = serve_args
        self.stopping = False
        ports = [args.port + 1 + i for i in range(args.replicas)]
        self.children = [
            _Managed(
                f"replica{i}", serve_cmd("127.0.0.1", p, serve_args),
                f"http://127.0.0.1:{p}/health",
                ready_timeout_s=args.ready_timeout_s,
            )
            for i, p in enumerate(ports)
        ]
        self.children.append(_Managed(
            "router", router_cmd(args.host, args.port, ports),
            f"http://127.0.0.1:{args.port}/health",
            # router /health is 503 until a replica comes up — give it the
            # same startup grace as the replicas themselves
            ready_timeout_s=args.ready_timeout_s,
        ))

    def run(self) -> int:
        def on_term(signum, frame):
            self.stopping = True

        signal.signal(signal.SIGTERM, on_term)
        signal.signal(signal.SIGINT, on_term)
        if not self.args.skip_build:
            # one warm build: every replica loads the library it built
            warm_build(self.args, self.serve_args)
        for c in self.children:
            c.spawn()
        total_restarts = 0
        try:
            while not self.stopping:
                time.sleep(self.args.health_interval)
                now = time.monotonic()
                for c in self.children:
                    if c.next_spawn:
                        if now >= c.next_spawn:
                            c.next_spawn = 0.0
                            c.spawn()
                        continue
                    bad = not c.alive()
                    if not bad:
                        if http_ok(c.health_url):
                            c.ready = True
                            c.misses = 0
                            c.backoff = 1.0
                        elif not c.ready:
                            # startup grace: a freshly spawned server is
                            # loading/compiling — only the ready timeout
                            # (not the miss counter) can fail it
                            bad = now >= c.ready_deadline
                        else:
                            c.misses += 1
                            bad = c.misses >= self.args.health_misses
                    if bad:
                        print(f"[launch] {c.name} unhealthy — restart "
                              f"in {c.backoff:.0f}s", flush=True)
                        c.drain(self.args.drain_s)
                        c.restarts += 1
                        total_restarts += 1
                        if (self.args.max_restarts is not None
                                and total_restarts > self.args.max_restarts):
                            print("[launch] restart limit reached",
                                  flush=True)
                            return 1
                        c.next_spawn = now + c.backoff
                        c.backoff = min(c.backoff * 2, 60.0)
        finally:
            for c in self.children:
                c.drain(self.args.drain_s)
            print(json.dumps({
                "restarts": {c.name: c.restarts for c in self.children}
            }), flush=True)
        return 0


class LockstepLauncher:
    """Supervise a lockstep serving group (``cli serve --coordinator``:
    one engine sharded over the members' devices, process 0 serving the
    API). The group is one failure domain: if ANY member exits or process
    0's /health fails, every member is drained and the WHOLE group respawns
    with backoff — a partial group can never complete a collective, and
    the members exit on their own when a peer is lost (the coordinator
    returns 13 when a mirrored call finds the follower gone, a follower
    returns 1 when the coordinator's channel drops, and the follower's
    collective watchdog exits 17), so group restart is the only correct
    supervision policy. The respawned group meets at the same
    ``--coordinator-port`` and ``--lockstep-port``. Single-host form (one
    host's processes); multi-host deployments run one of these per host
    with the same --coordinator address. On cards the members use NCCL,
    one card each."""

    def __init__(self, args, serve_args):
        self.args = args
        self.serve_args = serve_args
        self.stopping = False
        self.restarts = 0
        n = args.lockstep_processes
        self.children = []
        for pid in range(n):
            cmd = lockstep_cmd(pid, n, args.coordinator_port,
                               args.lockstep_port, args.host, args.port,
                               serve_args)
            self.children.append(_Managed(
                f"lockstep{pid}", cmd,
                f"http://127.0.0.1:{args.port}/health" if pid == 0 else "",
                ready_timeout_s=args.ready_timeout_s,
            ))

    def _spawn_all(self) -> None:
        for c in self.children:
            c.spawn()

    def _drain_all(self) -> None:
        # coordinator first: its teardown sends the followers a clean stop
        for c in self.children:
            c.drain(self.args.drain_s)

    def run(self) -> int:
        def on_term(signum, frame):
            self.stopping = True

        signal.signal(signal.SIGTERM, on_term)
        signal.signal(signal.SIGINT, on_term)
        if not self.args.skip_build:
            warm_build(self.args, self.serve_args)
        backoff = 1.0
        self._spawn_all()
        head = self.children[0]
        try:
            while not self.stopping:
                time.sleep(self.args.health_interval)
                now = time.monotonic()
                bad = None
                for c in self.children:
                    if not c.alive():
                        bad = f"{c.name} exited rc={c.proc.returncode}"
                        break
                if bad is None and head.health_url:
                    if http_ok(head.health_url):
                        head.ready = True
                        head.misses = 0
                        backoff = 1.0
                    elif not head.ready:
                        if now >= head.ready_deadline:
                            bad = "group never became ready"
                    else:
                        head.misses += 1
                        if head.misses >= self.args.health_misses:
                            bad = "coordinator health failing"
                if bad is None:
                    continue
                print(f"[launch] lockstep group unhealthy ({bad}) — "
                      f"group restart in {backoff:.0f}s", flush=True)
                self._drain_all()
                self.restarts += 1
                if (self.args.max_restarts is not None
                        and self.restarts > self.args.max_restarts):
                    print("[launch] restart limit reached", flush=True)
                    return 1
                time.sleep(backoff)
                backoff = min(backoff * 2, 60.0)
                if not self.stopping:
                    self._spawn_all()
        finally:
            self._drain_all()
            print(json.dumps({"group_restarts": self.restarts}), flush=True)
        return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="warm-lifecycle supervisor for the port's TTS server "
                    "(args after `--` pass through to cli serve and the "
                    "warm build)"
    )
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--build-info", default="build_info.json")
    ap.add_argument("--skip-build", action="store_true",
                    help="skip the warm build (kernel library + runtime "
                         "load + build info)")
    ap.add_argument("--ready-timeout-s", type=float, default=1800.0,
                    help="a full-width boot (weights, graph capture) "
                         "takes tens of seconds")
    ap.add_argument("--health-interval", type=float, default=5.0)
    ap.add_argument("--health-misses", type=int, default=3)
    ap.add_argument("--drain-s", type=float, default=30.0)
    ap.add_argument("--max-restarts", type=int, default=None)
    ap.add_argument("--replicas", type=int, default=1,
                    help="N serving replicas (ports port+1..port+N) behind "
                         "the front router on --port (scale-out serving)")
    ap.add_argument("--lockstep-processes", type=int, default=0,
                    help="supervise an N-process lockstep serving group "
                         "(cli serve --coordinator): one failure domain, "
                         "any member loss restarts the whole group")
    ap.add_argument("--coordinator-port", type=int, default=12355,
                    help="torch.distributed TCP rendezvous port (process "
                         "0's store) for --lockstep-processes")
    ap.add_argument("--lockstep-port", type=int, default=18765,
                    help="mirrored-call side-channel port for --lockstep-"
                         "processes")
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        i = argv.index("--")
        own, serve_args = argv[:i], argv[i + 1:]
    else:
        own, serve_args = argv, []
    args = ap.parse_args(own)
    if args.lockstep_processes >= 2:
        return LockstepLauncher(args, serve_args).run()
    if args.replicas > 1:
        return ReplicaLauncher(args, serve_args).run()
    return Launcher(args, serve_args).run()


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
