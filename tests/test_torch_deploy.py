"""The port's deployment layer (tts_inference_tpu_torch/deploy/): the front
router held to deploy/router.py on the six cases of tests/test_router.py,
the commands each launcher mode builds, the launcher's supervision policies
over a stub server (tests/torch_stub_server.py, run by
tests/torch_launch_driver.py), and two real launches on the CPU: one
supervised `cli serve --tiny` with its warm build, and a two-member lockstep
group (gloo) that loses its follower and comes back."""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from argparse import Namespace
from pathlib import Path

import pytest

aiohttp = pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

import deploy.router as jax_router  # noqa: E402
from tts_inference_tpu_torch.deploy import launch  # noqa: E402
from tts_inference_tpu_torch.deploy import router as port_router  # noqa: E402

from tests.test_router import run, stub_replica  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
DRIVER = str(REPO / "tests" / "torch_launch_driver.py")
ROUTERS = pytest.mark.parametrize("mod", [jax_router, port_router],
                                  ids=["deploy", "port"])


# ---- the router: tests/test_router.py's six cases on both modules ----------


async def start_stack(mod, replica_specs, **router_kw):
    """Stub replica servers + a router client of `mod` in one loop."""
    servers, hit_maps, urls = [], [], []
    for spec in replica_specs:
        if spec is None:            # a dead replica: nothing listens here
            urls.append("http://127.0.0.1:1")
            hit_maps.append(None)
            continue
        app, hits = spec
        srv = TestServer(app)
        await srv.start_server()
        servers.append(srv)
        hit_maps.append(hits)
        urls.append(f"http://127.0.0.1:{srv.port}")
    router = mod.Router(urls, **router_kw)
    client = TestClient(TestServer(mod.make_app(router)))
    await client.start_server()

    async def teardown():
        await client.close()
        for s in servers:
            await s.close()

    return client, router, hit_maps, teardown


@ROUTERS
def test_http_dispatch_spreads_load(mod):
    async def go():
        client, _, hits, teardown = await start_stack(
            mod, [stub_replica("a", delay_s=0.15),
                  stub_replica("b", delay_s=0.15)])
        try:
            resps = await asyncio.gather(*(
                client.post("/generate", json={"i": i}) for i in range(4)))
            served = []
            for r in resps:
                assert r.status == 200
                served.append((await r.json())["replica"])
            assert set(served) == {"a", "b"}, served
            assert hits[0]["generate"] == 2 and hits[1]["generate"] == 2
        finally:
            await teardown()

    run(go())


@ROUTERS
def test_failover_and_health(mod):
    async def go():
        client, _, hits, teardown = await start_stack(
            mod, [None, stub_replica("live")], cooldown_s=30.0)
        try:
            r = await client.post("/generate", json={"x": 1})
            assert r.status == 200
            assert (await r.json())["replica"] == "live"
            h = await client.get("/health")
            assert h.status == 200
            body = await h.json()
            assert body["replicas"][0]["up"] is False
            assert body["status"] == "ok"
            r2 = await client.post("/generate", json={"x": 2})
            assert (await r2.json())["replica"] == "live"
            assert hits[1]["generate"] == 2
        finally:
            await teardown()

    run(go())


@ROUTERS
def test_all_replicas_down_returns_503(mod):
    async def go():
        client, _, _, teardown = await start_stack(mod, [None, None])
        try:
            assert (await client.post("/generate", json={})).status == 503
            assert (await client.get("/health")).status == 503
        finally:
            await teardown()

    run(go())


@ROUTERS
def test_ws_passthrough_text_and_binary(mod):
    async def go():
        client, _, hits, teardown = await start_stack(
            mod, [stub_replica("w")])
        try:
            ws = await client.ws_connect("/ws/tts")
            await ws.send_str("hello")
            msg = await ws.receive(timeout=10)
            assert msg.type == aiohttp.WSMsgType.TEXT
            assert msg.data == "w:hello"
            await ws.send_bytes(b"\x01\x02\x03")
            msg = await ws.receive(timeout=10)
            assert msg.type == aiohttp.WSMsgType.BINARY
            assert msg.data == b"\x03\x02\x01"
            await ws.close()
            assert hits[0]["ws"] == 1
        finally:
            await teardown()

    run(go())


@ROUTERS
def test_ws_failover_to_live_replica(mod):
    async def go():
        client, _, _, teardown = await start_stack(
            mod, [None, stub_replica("w2")], cooldown_s=30.0)
        try:
            ws = await client.ws_connect("/ws/tts")
            await ws.send_str("x")
            assert (await ws.receive(timeout=10)).data == "w2:x"
            await ws.close()
        finally:
            await teardown()

    run(go())


@ROUTERS
def test_metrics_aggregation(mod):
    async def go():
        client, _, _, teardown = await start_stack(
            mod, [stub_replica("a"), stub_replica("b")])
        try:
            await client.post("/generate", json={})
            body = await (await client.get("/metrics")).json()
            agg = body["aggregate"]
            assert agg["replicas_up"] == 2
            assert agg["replicas_total"] == 2
            assert agg["slots"] == 8          # 4 per stub replica
            assert len(body["per_replica"]) == 2
            assert all("metrics" in e for e in body["per_replica"])
        finally:
            await teardown()

    run(go())


def test_router_passes_a_replicas_card_metrics_through():
    """The port's server nests device memory and its graph census on a
    card; the router keeps them per replica and sums only the scheduler's
    slots, active and queued streams."""
    from aiohttp import web

    card = {"scheduler": {"slots": 8, "active": 1, "queued": 0},
            "graphs": {"graphs_compiled": 7, "late_captures": 0},
            "device_memory": {"allocated_bytes.all.current": 123}}

    async def metrics(request):
        return web.json_response(card)

    async def health(request):
        return web.json_response({"status": "ok"})

    def replica():
        app = web.Application()
        app.add_routes([web.get("/metrics", metrics),
                        web.get("/health", health)])
        return app, {}

    async def go():
        client, _, _, teardown = await start_stack(
            port_router, [replica(), replica()])
        try:
            body = await (await client.get("/metrics")).json()
            assert body["aggregate"]["slots"] == 16
            assert body["aggregate"]["active"] == 2
            assert "late_captures" not in json.dumps(body["aggregate"])
            for e in body["per_replica"]:
                assert e["metrics"] == card
        finally:
            await teardown()

    run(go())


# ---- the commands each mode builds ------------------------------------------

SERVE_ARGS = ["--tiny", "--device", "cpu", "--no-warmup", "--quantize"]


def _args(**kw) -> Namespace:
    base = dict(host="0.0.0.0", port=8000, build_info="build_info.json",
                skip_build=True, ready_timeout_s=60.0, health_interval=1.0,
                health_misses=3, drain_s=10.0, max_restarts=None,
                replicas=1, lockstep_processes=0, coordinator_port=12355,
                lockstep_port=18765)
    base.update(kw)
    return Namespace(**base)


def _runs_the_port(cmd) -> None:
    assert cmd[:2] == [sys.executable, "-m"], cmd
    assert cmd[2].startswith("tts_inference_tpu_torch."), cmd
    assert not any(a.startswith("tts_inference_tpu.") or a.startswith(
        "deploy.") for a in cmd), cmd


def _passes_through(cmd, serve_args) -> bool:
    n = len(serve_args)
    return any(cmd[i:i + n] == serve_args for i in range(len(cmd) - n + 1))


def _mode_commands(kind: str) -> list:
    """(name, command) of what a launch of this kind spawns."""
    if kind == "serve":
        return [("serve", launch.serve_cmd("0.0.0.0", 8000, SERVE_ARGS))]
    if kind == "replicas":
        rl = launch.ReplicaLauncher(_args(replicas=3), SERVE_ARGS)
        return [(c.name, c.cmd) for c in rl.children]
    if kind == "lockstep":
        ll = launch.LockstepLauncher(_args(lockstep_processes=3),
                                     [*SERVE_ARGS, "--tp", "3"])
        return [(c.name, c.cmd) for c in ll.children]
    return [("warm_build", launch.warm_build_cmd("b.json", SERVE_ARGS))]


@pytest.mark.parametrize("kind", ["serve", "replicas", "lockstep",
                                  "warm_build"])
def test_every_command_runs_the_port(kind):
    cmds = _mode_commands(kind)
    for name, cmd in cmds:
        _runs_the_port(cmd)
        if name == "router":
            assert cmd[2] == "tts_inference_tpu_torch.deploy.router"
            assert cmd[cmd.index("--port") + 1] == "8000"
            assert [cmd[i + 1] for i, a in enumerate(cmd)
                    if a == "--replica"] == [
                f"http://127.0.0.1:{8001 + i}" for i in range(3)]
            continue
        want = SERVE_ARGS + (["--tp", "3"] if kind == "lockstep" else [])
        assert _passes_through(cmd, want), (name, cmd)
    if kind == "replicas":
        assert [n for n, _ in cmds] == ["replica0", "replica1", "replica2",
                                        "router"]
        for i, (_, cmd) in enumerate(cmds[:3]):
            assert cmd[2:4] == ["tts_inference_tpu_torch.cli", "serve"]
            assert cmd[cmd.index("--port") + 1] == str(8001 + i)
            assert cmd[cmd.index("--host") + 1] == "127.0.0.1"
    if kind == "lockstep":
        for rank, (_, cmd) in enumerate(cmds):
            assert cmd[cmd.index("--coordinator") + 1] == "127.0.0.1:12355"
            assert cmd[cmd.index("--process-id") + 1] == str(rank)
            assert cmd[cmd.index("--num-processes") + 1] == "3"
            assert cmd[cmd.index("--lockstep-port") + 1] == "18765"
            assert ("--port" in cmd) == (rank == 0)
    if kind == "warm_build":
        cmd = cmds[0][1]
        assert cmd[2] == "tts_inference_tpu_torch.deploy.warm_build"
        assert cmd[3:5] == ["--build-info", "b.json"]


def test_deploy_imports_without_jax_deploy_or_bench():
    """The port's deploy modules and the TTFA tool import with jax, the JAX
    package and the repo's own deploy/, tools/, bench and benchmarks
    poisoned."""
    mods = ["tts_inference_tpu_torch.deploy",
            "tts_inference_tpu_torch.deploy.router",
            "tts_inference_tpu_torch.deploy.launch",
            "tts_inference_tpu_torch.deploy.warm_build",
            "tts_inference_tpu_torch.tools.profile_ttfa"]
    bad = ("jax", "tts_inference_tpu", "deploy", "tools", "bench",
           "benchmarks")
    code = ("import sys\n"
            f"for b in {bad!r}: sys.modules[b] = None\n"
            "import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = {bad!r}\n"
            "assert not any(k in bad or k.startswith(tuple(b + '.' for b in"
            " bad)) for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


# ---- supervision policies over the stub server ------------------------------


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                PYTHONUNBUFFERED="1")


def _free_ports(n: int) -> int:
    """A port p with p .. p + n all free (the replicas take port + 1 ..)."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            p = s.getsockname()[1]
        if p + n >= 65535:
            continue
        try:
            for q in range(p + 1, p + n + 1):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", q))
            return p
        except OSError:
            continue
    raise RuntimeError("no free block of ports")


LOCAL = ("--host", "127.0.0.1", "--port")


def _start(log: Path, *argv, driver: bool = True) -> subprocess.Popen:
    head = [sys.executable, DRIVER] if driver else [
        sys.executable, "-m", "tts_inference_tpu_torch.deploy.launch"]
    return subprocess.Popen([*head, *argv], cwd=log.parent, env=_env(),
                            stdout=open(log, "w"), stderr=subprocess.STDOUT,
                            start_new_session=True)


def _http(url: str, body=None, timeout: float = 5.0):
    """(status, bytes, content type) of a GET (or a POST of `body`)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), None
    except (OSError, urllib.error.URLError):
        return None, b"", None


def _wait(pred, proc, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        assert proc.poll() is None, f"launcher exited while waiting: {what}"
        time.sleep(0.1)
    raise AssertionError(f"timed out: {what}")


def _stub_pid(port: int, not_pid=None):
    """The pid a stub on `port` answers /health with (None while it does not
    answer, or answers as `not_pid`)."""
    status, body, _ = _http(f"http://127.0.0.1:{port}/health", timeout=1.0)
    pid = json.loads(body)["pid"] if status == 200 else None
    return pid if pid != not_pid else None


def _children(ppid: int) -> dict:
    """pid → argv of the processes whose parent is `ppid`."""
    out = {}
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            stat = (d / "stat").read_text()
            if int(stat.rsplit(")", 1)[1].split()[1]) != ppid:
                continue
            argv = (d / "cmdline").read_bytes().split(b"\0")
        except (OSError, ValueError, IndexError):
            continue
        out[int(d.name)] = [a.decode() for a in argv if a]
    return out


def _stop(proc, timeout: float = 60.0) -> int:
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def _last_line(log: Path) -> dict:
    lines = [ln for ln in log.read_text().splitlines() if ln.strip()]
    return json.loads(lines[-1])


@pytest.fixture
def reap():
    """Kill every process group a test started, whatever happened."""
    procs = []
    yield procs.append
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()


def test_one_server_restarts_after_a_kill(tmp_path, reap):
    port = _free_ports(0)
    log = tmp_path / "launch.log"
    proc = _start(log, *LOCAL, str(port), "--skip-build",
                  "--health-interval", "0.2")
    reap(proc)
    pid = _wait(lambda: _stub_pid(port), proc, 30, "first server")
    os.kill(pid, signal.SIGKILL)
    _wait(lambda: _stub_pid(port, not_pid=pid), proc, 30, "restarted server")
    assert _stop(proc) == 0
    assert _last_line(log) == {"restarts": 1}


def test_max_restarts_gives_rc_1(tmp_path, reap):
    port = _free_ports(0)
    log = tmp_path / "launch.log"
    proc = _start(log, *LOCAL, str(port), "--skip-build",
                  "--health-interval", "0.2", "--max-restarts", "1",
                  "--", "--exit-after", "0.5")
    reap(proc)
    assert proc.wait(timeout=60) == 1
    text = log.read_text()
    assert "restart limit reached" in text
    assert text.count('{"stub"') == 2       # the first spawn and one restart


def test_replica_restarts_while_the_router_serves(tmp_path, reap):
    port = _free_ports(2)
    log = tmp_path / "launch.log"
    proc = _start(log, *LOCAL, str(port), "--replicas", "2",
                  "--skip-build", "--health-interval", "0.2")
    reap(proc)
    pids = [_wait(lambda p=p: _stub_pid(p), proc, 30, f"replica on {p}")
            for p in (port + 1, port + 2)]
    _wait(lambda: _http(f"http://127.0.0.1:{port}/health")[0] == 200, proc,
          30, "router")
    os.kill(pids[0], signal.SIGKILL)
    # at once: every request lands on the live replica
    for _ in range(4):
        status, body, _ = _http(f"http://127.0.0.1:{port}/generate", {})
        assert status == 200
        assert json.loads(body)["pid"] == pids[1]
    _wait(lambda: _stub_pid(port + 1, not_pid=pids[0]), proc, 30,
          "replica0 restarted")
    assert _stub_pid(port + 2) == pids[1]
    assert _stop(proc) == 0
    assert _last_line(log) == {"restarts": {"replica0": 1, "replica1": 0,
                                            "router": 0}}


def test_lockstep_member_exit_restarts_the_group(tmp_path, reap):
    port = _free_ports(0)
    log = tmp_path / "launch.log"
    proc = _start(log, *LOCAL, str(port), "--lockstep-processes", "2",
                  "--skip-build", "--health-interval", "0.2")
    reap(proc)
    head = _wait(lambda: _stub_pid(port), proc, 30, "coordinator")
    members = _wait(lambda: len(_children(proc.pid)) == 2
                    and _children(proc.pid), proc, 30, "two members")
    (follower,) = [p for p in members if p != head]
    os.kill(follower, signal.SIGKILL)
    new_head = _wait(lambda: _stub_pid(port, not_pid=head), proc, 30,
                     "group respawned")
    now = _wait(lambda: len(_children(proc.pid)) == 2
                and _children(proc.pid), proc, 30, "two new members")
    assert head not in now and follower not in now and new_head in now
    assert _stop(proc) == 0
    assert _last_line(log) == {"group_restarts": 1}


# ---- real launches of the port's server on the CPU --------------------------

TINY = ["--tiny", "--device", "cpu", "--no-warmup"]


def test_launcher_serves_the_port_and_drains(tmp_path, reap):
    """deploy.launch over `cli serve --tiny --device cpu --no-warmup`, with
    its warm build: build_info.json is the port's, /generate returns a WAV,
    SIGTERM drains with rc 0 and {"restarts": 0}."""
    port = _free_ports(0)
    log = tmp_path / "launch.log"
    info = tmp_path / "build_info.json"
    proc = _start(log, *LOCAL, str(port), "--health-interval", "0.5",
                  "--build-info", str(info), "--", *TINY, driver=False)
    reap(proc)
    _wait(lambda: _http(f"http://127.0.0.1:{port}/health")[0] == 200, proc,
          240, "server ready")
    built = json.loads(info.read_text())
    assert built["framework"] == "tts_inference_tpu_torch"
    assert built["backend"] == "cpu" and built["kernel_library"] is None
    assert built["serve_argv"] == TINY
    assert built["load_timings"]["warm_build_s"] > 0
    status, body, ctype = _http(
        f"http://127.0.0.1:{port}/generate",
        {"text": "launcher check", "force_speech": True, "max_tokens": 40,
         "audio_only": True}, timeout=120)
    assert status == 200 and ctype == "audio/wav", body[:300]
    assert body[:4] == b"RIFF"
    assert _stop(proc) == 0
    assert _last_line(log) == {"restarts": 0}
    assert "[launch] warm build:" in log.read_text()


def test_lockstep_group_comes_back_after_a_follower_dies(tmp_path, reap):
    """Two tiny members of `cli serve --tp 2` (gloo) under
    --lockstep-processes 2: SIGKILL the follower, the launcher drains and
    respawns the group on the same rendezvous and side-channel ports, and
    the new group serves; SIGTERM gives {"group_restarts": 1}."""
    port = _free_ports(0)
    cport, lport = _free_ports(0), _free_ports(0)
    log = tmp_path / "launch.log"
    proc = _start(log, *LOCAL, str(port), "--lockstep-processes", "2",
                  "--coordinator-port", str(cport), "--lockstep-port",
                  str(lport), "--skip-build", "--health-interval", "0.5",
                  "--drain-s", "15", "--", *TINY, "--tp", "2",
                  driver=False)
    reap(proc)

    def healthy_group():
        kids = _children(proc.pid)
        ok = _http(f"http://127.0.0.1:{port}/health")[0] == 200
        return ok and len(kids) == 2 and kids

    first = _wait(healthy_group, proc, 240, "group ready")
    (follower,) = [p for p, a in first.items() if "--port" not in a]
    os.kill(follower, signal.SIGKILL)
    def respawned():
        kids = healthy_group()
        return kids if kids and not set(kids) & set(first) else None

    _wait(respawned, proc, 240, "group respawned")
    status, body, ctype = _http(
        f"http://127.0.0.1:{port}/generate",
        {"text": "group check", "force_speech": True, "max_tokens": 21,
         "audio_only": True}, timeout=120)
    assert status == 200 and ctype == "audio/wav", body[:300]
    assert _stop(proc, timeout=90) == 0
    assert _last_line(log) == {"group_restarts": 1}
