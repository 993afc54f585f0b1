"""Lockstep serving of the port (twins of tests/test_lockstep_serve.py's
fast cases, the in-place memo case, and the two-process `cli serve --tp 2`
end to end, which runs here at tiny size — the JAX package marks its twin
slow).

Process 0 owns the scheduler and the API and mirrors every
device-entering EngineCore call to the followers over the side channel
(tts_inference_tpu_torch/parallel/lockstep.py); device tensors cross as
handles, host operands by value.
"""

from __future__ import annotations

import asyncio
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_gloo_pool import free_port
from tts_inference_tpu_torch import protocol as P
from tts_inference_tpu_torch.parallel import lockstep as LS

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its decode loops (the
    mirror's cost, the follower replays) run beside other files' worker
    pools, and wait on starved OpenMP threads when all cores are taken."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the handle table and the wire ----------------------------------------


def test_handle_table_roundtrip():
    a_tab, b_tab = LS._HandleTable(), LS._HandleTable()
    out = (torch.arange(4), {"x": torch.ones(2), "y": 3})
    a_tab.register_outputs(out)
    # the follower registers its own twin under the same ids
    twin = (torch.arange(4), {"x": torch.ones(2), "y": 3})
    b_tab.register_outputs(twin)
    args = (out[0], np.int32(5), [out[1]["x"], "s"])
    enc = LS._encode(a_tab, args)
    assert isinstance(enc[0], LS._Ref) and isinstance(enc[2][0], LS._Ref)
    assert enc[1] == 5 and enc[2][1] == "s"
    dec = LS._decode(b_tab, pickle.loads(pickle.dumps(enc)))
    assert dec[0] is twin[0] and dec[2][0] is twin[1]["x"]


def test_handle_table_window_eviction():
    tab = LS._HandleTable(window=4)
    ts = [torch.full((2,), i) for i in range(6)]
    for t in ts:
        tab.register_outputs(t)
    assert tab.hid_for(ts[0]) is None          # evicted
    assert tab.hid_for(ts[5]) == 5
    np.testing.assert_array_equal(tab.lookup(5).numpy(), [5, 5])


def test_unregistered_tensor_falls_back_to_value():
    """A host-built operand (the SamplingParams tensors) crosses by value
    and is rebuilt as a tensor on the follower's device."""
    tab = LS._HandleTable()
    enc = LS._encode(tab, (torch.full((3,), 2.5), torch.ones(2).bfloat16()))
    assert isinstance(enc[0], LS._TensorVal)
    assert isinstance(enc[0].val, np.ndarray)
    np.testing.assert_allclose(enc[0].val, 2.5)
    dec = LS._decode(LS._HandleTable(), pickle.loads(pickle.dumps(enc)))
    assert isinstance(dec[0], torch.Tensor) and dec[0].dtype == torch.float32
    assert dec[1].dtype == torch.bfloat16


def test_repeated_operand_wire_value_is_memoized():
    """A repeated operand is fetched once (the same cached _TensorVal);
    a registered output still encodes as a _Ref; eviction past the window
    re-fetches."""
    tab = LS._HandleTable(window=2)
    a = torch.full((3,), 2.5)
    w1 = LS._encode(tab, (a,))[0]
    assert LS._encode(tab, (a,))[0] is w1
    tab.register_outputs((a,))
    assert isinstance(LS._encode(tab, (a,))[0], LS._Ref)
    d = torch.full((3,), 7.0)
    w_d = LS._encode(tab, (d,))[0]
    LS._encode(tab, (torch.zeros(2),))
    LS._encode(tab, (torch.ones(2),))       # window full: d evicted
    w_d2 = LS._encode(tab, (d,))[0]
    assert w_d2 is not w_d
    np.testing.assert_allclose(w_d2.val, 7.0)


def test_memo_sees_a_row_rewritten_in_place():
    """A SamplingParams row rewritten in place between two mirrored calls
    keeps the tensor's id but bumps its version: the second call ships the
    new value (a memo on identity alone would replay the stale one)."""
    from tts_inference_tpu_torch.config import SamplingConfig
    from tts_inference_tpu_torch.ops import sampling as S

    class Core:
        def __init__(self):
            self.seen = []

        def decode_steps_launch(self, sp, tok, act):
            self.seen.append(sp.temperature.clone())
            return tok.clone(), tok.clone(), act.clone()

    a, b = socket.socketpair()
    follower = Core()
    th = threading.Thread(target=LS.follower_loop, args=(follower, b))
    th.start()
    mirrored = LS.MirroredCore(Core(), [a])
    sp = S.SamplingParams.from_config(SamplingConfig(), 4)
    tok, act = torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=bool)
    mirrored.decode_steps_launch(sp, tok, act)
    sp.temperature[2] = 0.0                 # the row rewritten in place
    mirrored.decode_steps_launch(sp, tok, act)
    mirrored.close()
    th.join(timeout=30)
    assert len(follower.seen) == 2
    np.testing.assert_allclose(follower.seen[0].numpy(), 0.6)
    np.testing.assert_allclose(follower.seen[1].numpy(), [0.6, 0.6, 0.0,
                                                          0.6])


def test_mirrored_core_replays_on_follower():
    """In process: a coordinator MirroredCore over a socketpair and a
    follower EngineCore replaying it give the same tokens as a third core
    driven by hand, and the follower's host state advanced identically."""
    from tts_inference_tpu_torch import weights
    from tts_inference_tpu_torch.config import SamplingConfig, tiny_config
    from tts_inference_tpu_torch.engine.engine import EngineCore
    from tts_inference_tpu_torch.ops import sampling as S

    cfg = tiny_config()
    params = weights.init_llama_params(cfg.model, 0)

    def core():
        return EngineCore(params, cfg.model, cfg.engine,
                          eos_id=P.TOKEN_EOS, seed=0)

    core_a, core_b, core_c = core(), core(), core()
    sa, sb = socket.socketpair()
    replayed = {}
    th = threading.Thread(
        target=lambda: replayed.update(n=LS.follower_loop(core_b, sb)))
    th.start()
    mirrored = LS.MirroredCore(core_a, [sa])
    sp = S.SamplingParams.from_config(SamplingConfig(greedy=True), 4)

    def run(c):
        t0, tok, act = c.prefill_decode_launch(
            [[7, 8, 9], [10, 11]], [0, 1], sp, np.zeros(4, np.int32),
            np.zeros(4, bool), n=4)
        t1, _, _ = c.decode_steps_launch(sp, tok, act)
        return np.concatenate([t0.numpy(), t1.numpy()], axis=1)

    with torch.no_grad():
        a = run(mirrored)
        mirrored.close()
        th.join(timeout=60)
        want = run(core_c)
    assert replayed["n"] == 2
    np.testing.assert_array_equal(a, want)
    np.testing.assert_array_equal(core_b._len_bounds, core_c._len_bounds)


# ---- failure semantics ------------------------------------------------------


def test_mirrored_core_peer_lost_is_fatal_and_sticky():
    """A dead follower channel turns every mirrored call into an instant
    LockstepPeerLost — never a hang, never a retry."""
    class StubCore:
        def reset_and_seed(self, slots):
            return None

    sa, sb = socket.socketpair()
    sb.close()                           # the follower died
    m = LS.MirroredCore(StubCore(), [sa])
    with pytest.raises(LS.LockstepPeerLost):
        for _ in range(8):               # the first send may be buffered
            m.reset_and_seed([0])
            time.sleep(0.02)
    assert m.peer_lost is not None
    t0 = time.perf_counter()
    with pytest.raises(LS.LockstepPeerLost):
        m.reset_and_seed([0])            # sticky and instant
    assert time.perf_counter() - t0 < 1.0
    with pytest.raises(LS.LockstepPeerLost):
        m.lockstep_check()
    m.close()                            # no-op on a failed mirror
    sa.close()


def test_handshake_rejects_strangers_and_wrong_token(monkeypatch):
    """A port scanner cannot take a follower slot; a wrong-token follower
    fails fast; the real follower still gets in."""
    monkeypatch.setenv("TTS_LOCKSTEP_TOKEN", "sesame")
    port = free_port()
    out = {}
    th = threading.Thread(target=lambda: out.update(
        socks=LS.coordinator_channel(port, 1, timeout_s=60)), daemon=True)
    th.start()
    deadline = time.time() + 30
    stranger = None
    while time.time() < deadline:
        try:
            stranger = socket.create_connection(("127.0.0.1", port),
                                                timeout=1)
            break
        except OSError:
            time.sleep(0.05)
    assert stranger is not None
    stranger.sendall(b"GET / HTTP/1.1\r\n\r\n" + b"\x00" * 40)
    monkeypatch.setenv("TTS_LOCKSTEP_TOKEN", "wrong")
    with pytest.raises((RuntimeError, OSError)):
        LS.follower_channel("127.0.0.1", port, timeout_s=3)
    monkeypatch.setenv("TTS_LOCKSTEP_TOKEN", "sesame")
    f = LS.follower_channel("127.0.0.1", port, timeout_s=30)
    th.join(timeout=30)
    assert not th.is_alive() and len(out["socks"]) == 1
    stranger.close()
    f.close()
    for c in out["socks"]:
        c.close()


def test_scheduler_fatal_on_lockstep_loss():
    """LockstepPeerLost in the scheduler loop: every live request errors,
    new submits are refused with "engine down", run_forever returns and
    on_fatal fires."""
    from tts_inference_tpu_torch import weights
    from tts_inference_tpu_torch.config import (SamplingConfig, StreamConfig,
                                                tiny_config)
    from tts_inference_tpu_torch.engine.scheduler import (Scheduler,
                                                          TTSRequest)
    from tts_inference_tpu_torch.models.snac import SnacDecoder
    from tts_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    cfg = tiny_config()
    sched = Scheduler(weights.init_llama_params(cfg.model, 0), cfg,
                      SnacDecoder(weights.init_snac_params(cfg.snac, 1),
                                  cfg.snac), ByteTokenizer(), device="cpu")

    def bad_step():
        raise LS.LockstepPeerLost("follower 1 gone")

    sched.step = bad_step
    req = TTSRequest(text="x", sampling=SamplingConfig(max_tokens=8),
                     stream_cfg=StreamConfig(), force_speech=True)
    sched.submit(req)
    fatal_seen = []
    sched.on_fatal = fatal_seen.append
    sched.run_forever()                  # returns (does not loop) on fatal
    kind, payload = req.events.get(timeout=5)
    assert kind == "error" and "follower 1 gone" in payload
    assert "engine down" in payload
    assert sched.fatal is not None and fatal_seen
    req2 = TTSRequest(text="y", sampling=SamplingConfig(max_tokens=8),
                      stream_cfg=StreamConfig(), force_speech=True)
    sched.submit(req2)
    kind2, payload2 = req2.events.get(timeout=5)
    assert kind2 == "error" and "engine down" in payload2


def test_health_reports_fatal():
    """/health answers 503 with the scheduler's fatal error, for a
    supervisor to restart the group."""
    from aiohttp.test_utils import TestClient, TestServer

    from tts_inference_tpu_torch.serving.app import create_app

    class Sched:
        fatal = None

    sched = Sched()

    async def go():
        async with TestClient(TestServer(create_app(None, sched))) as c:
            ok = await c.get("/health")
            sched.fatal = "lockstep follower lost"
            down = await c.get("/health")
            return ok.status, down.status, await down.json()

    ok, down, body = asyncio.run(go())
    assert ok == 200 and down == 503
    assert body == {"status": "fatal", "error": "lockstep follower lost"}


# ---- tools ------------------------------------------------------------------


def test_lockstep_overhead_tiny_cpu(capsys):
    from tts_inference_tpu_torch.tools import lockstep_overhead

    assert lockstep_overhead.main(["--tiny", "--device", "cpu", "--iters",
                                   "20"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["followers"] == 1 and line["desc_bytes"] > 0
    assert line["mirror_cost_us_per_call"] > 0


def test_dryrun_multichip():
    """Four gloo processes: a LoRA training step, a sharded serving tick and
    a mirrored paged-int8 scheduler tick equal the unsharded ones."""
    from tts_inference_tpu_torch.parallel.dryrun import dryrun_multichip

    line = dryrun_multichip(4)
    assert line["ok"] and line["dp"] * line["tp"] == 4
    assert line["scheduler_tokens"] == 24
    train = line["train"]
    assert train["adapter_leaves"] == 2 * 7 * 2
    assert abs(train["loss"] - train["loss_unsharded"]) <= \
        1e-5 * train["loss_unsharded"]


def test_cli_serve_mesh_needs_a_card_per_process():
    """On cards, one process per card: `serve --tp 2` on a host with fewer
    cards is refused before any process starts (NCCL refuses two ranks on
    one device); the CPU takes any count (--device cpu, below)."""
    from tts_inference_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["serve", "--tiny", "--tp", "2"])
    assert "needs 2 cards on this host" in str(e.value.code)


# ---- end to end: `cli serve --tp 2`, two processes ---------------------------

# greedy: a sampled token may flip between batch splits on the CPU
# (tests/torch_mesh_work.py::_requests)
REQ = {"text": "lockstep serving check", "force_speech": True,
       "max_tokens": 64, "seed": 7, "audio_only": True, "temperature": 0}


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                PYTHONUNBUFFERED="1")


def _serve(port: int, log: Path, *extra) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "tts_inference_tpu_torch.cli", "serve",
         "--tiny", "--device", "cpu", "--no-warmup", "--host", "127.0.0.1",
         "--port", str(port), *extra],
        cwd=REPO, env=_env(), stdout=open(log, "w"),
        stderr=subprocess.STDOUT)


async def _health(sess, base, proc, timeout=180):
    import aiohttp

    deadline = time.monotonic() + timeout
    while True:
        try:
            async with sess.get(base + "/health") as r:
                if r.status == 200:
                    return
        except aiohttp.ClientError:
            pass
        assert time.monotonic() < deadline, "server did not start"
        assert proc.poll() is None, "server exited"
        await asyncio.sleep(0.3)


async def _ws(sess, base, req) -> tuple:
    """(PCM bytes, the last text message) of one /ws/tts request."""
    import aiohttp

    pcm, last = b"", None
    async with sess.ws_connect(base + "/ws/tts") as ws:
        await ws.send_json(req)
        async for msg in ws:
            if msg.type == aiohttp.WSMsgType.BINARY:
                pcm += msg.data
            else:
                last = json.loads(msg.data)
                break
    return pcm, last


@pytest.fixture(scope="module")
def sharded_server(tmp_path_factory):
    log = tmp_path_factory.mktemp("lockstep") / "serve.log"
    port = free_port()
    proc = _serve(port, log, "--tp", "2")
    yield proc, port, log
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()


def test_cli_serve_tp2_matches_single_process(sharded_server, tmp_path):
    """`cli serve --tiny --device cpu --tp 2` starts its follower itself and
    streams, over /ws/tts, the PCM bytes of single-process serving (two
    requests: slot reuse too); the token debug endpoint answers 503."""
    import aiohttp

    proc, port, _ = sharded_server
    single_port = free_port()
    single = _serve(single_port, tmp_path / "single.log")

    async def go():
        out = {}
        async with aiohttp.ClientSession() as sess:
            for name, p, pr in (("sharded", port, proc),
                                ("single", single_port, single)):
                base = f"http://127.0.0.1:{p}"
                await _health(sess, base, pr)
                out[name] = [await _ws(sess, base, REQ),
                             await _ws(sess, base, dict(REQ, seed=8))]
            async with sess.post(f"http://127.0.0.1:{port}/dump-tokens",
                                 json={"text": "x"}) as r:
                out["dump"] = r.status
        return out

    try:
        out = asyncio.run(asyncio.wait_for(go(), 300))
    finally:
        single.terminate()
        single.wait(timeout=30)
    for (pcm_a, done_a), (pcm_b, done_b) in zip(out["sharded"],
                                                out["single"]):
        assert done_a["done"] and done_b["done"]
        assert len(pcm_a) == 64 // 7 * P.SAMPLES_PER_FRAME * 2
        assert pcm_a == pcm_b
    assert out["dump"] == 503


def test_follower_death_fails_streams_and_the_server(sharded_server):
    """Kill the follower mid-stream: the client's stream ends with an
    "engine down" error (never a hang) and the server exits nonzero on its
    own, for a supervisor to restart the group."""
    import aiohttp

    proc, port, log = sharded_server
    pids = next(json.loads(line)["lockstep_followers"]
                for line in log.read_text().splitlines()
                if line.startswith('{"lockstep_followers"'))

    async def go():
        async with aiohttp.ClientSession() as sess:
            base = f"http://127.0.0.1:{port}"
            await _health(sess, base, proc)
            async with sess.ws_connect(base + "/ws/tts") as ws:
                await ws.send_json(dict(REQ, max_tokens=2000))
                killed = False
                async for msg in ws:
                    if msg.type == aiohttp.WSMsgType.BINARY:
                        if not killed:      # mid-stream: the first chunk
                            os.kill(pids[0], signal.SIGKILL)
                            killed = True
                        continue
                    last = json.loads(msg.data)
                    if "error" in last:
                        return last
                    # the stream won the race: the next one must fail
                    await ws.send_json(REQ)

    last = asyncio.run(asyncio.wait_for(go(), 120))
    assert "engine down" in last["error"], last
    rc = proc.wait(timeout=60)
    assert rc not in (0, None)
