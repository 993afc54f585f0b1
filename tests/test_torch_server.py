"""The reference's server cases (``tests/test_server.py``) against the port's
``serving/app.py::create_app`` over a tiny CPU runtime, in process through
``aiohttp.test_utils``: the wire contracts of ``/``, ``/health``,
``/metrics``, ``/test``, ``/ws/tts``, ``/ws/audio``, ``/ws``, ``/generate``,
``/generate-batch`` and ``/dump-tokens`` in single-stream and scheduler
mode, disconnects mid-stream, and ``parse_request``'s limits, casts and
fuzz. One more case: ``/metrics`` reports the scheduler core's prefix-cache
counters when the cache is on.

The port's service name is its own (``tts_inference_tpu_torch``); every
other expectation is the reference's."""

import asyncio
import base64
import dataclasses
import io
import json
import wave

import numpy as np
import pytest
import torch

aiohttp = pytest.importorskip("aiohttp")
from aiohttp import WSMsgType  # noqa: E402
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from tts_inference_tpu_torch import protocol as P  # noqa: E402
from tts_inference_tpu_torch.config import tiny_config  # noqa: E402
from tts_inference_tpu_torch.engine.scheduler import Scheduler  # noqa: E402
from tts_inference_tpu_torch.runtime import Runtime  # noqa: E402
from tts_inference_tpu_torch.serving.app import create_app  # noqa: E402

REQ = {
    "text": "hello websocket",
    "voice": "tara",
    "temperature": 0.6,
    "top_p": 0.95,
    "frames_per_chunk": 2,
    "benchmark": True,
    "force_speech": True,
    "audio_only": True,
    "lookahead_frames": 3,
    "max_tokens": 70,
    "seed": 7,
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its runtimes run beside
    other files' servers, which wait on starved OpenMP threads when all
    cores are taken."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rt(_one_thread):
    return Runtime.create(tiny_config(), seed=0, device="cpu")


def _scheduler(rt, config=None):
    return Scheduler(rt.engine.core.params, config or rt.config, rt.vocoder,
                     rt.tokenizer, device="cpu")


@pytest.fixture()
def client(rt):
    loop = asyncio.new_event_loop()
    client = TestClient(TestServer(create_app(rt)), loop=loop)
    loop.run_until_complete(client.start_server())
    yield client, loop
    loop.run_until_complete(client.close())
    loop.close()


def _serve(rt, scheduler, go):
    """Run coroutine `go(client)` against the app with `scheduler`."""
    scheduler.start()
    loop = asyncio.new_event_loop()
    c = TestClient(TestServer(create_app(rt, scheduler=scheduler)), loop=loop)
    loop.run_until_complete(c.start_server())
    try:
        return loop.run_until_complete(go(c))
    finally:
        loop.run_until_complete(c.close())
        loop.close()
        scheduler.stop()


async def _ws_pcm(c, req, timeout=300):
    """One /ws/tts exchange; returns the PCM bytes."""
    ws = await c.ws_connect("/ws/tts")
    await ws.send_json(req)
    chunks = []
    while True:
        msg = await ws.receive(timeout=timeout)
        if msg.type == WSMsgType.BINARY:
            chunks.append(msg.data)
        else:
            data = json.loads(msg.data)
            assert "error" not in data, data
            if data.get("done"):
                break
    await ws.close()
    return b"".join(chunks)


def test_index_and_health(client):
    c, loop = client

    async def go():
        r = await c.get("/")
        info = await r.json()
        assert "/ws/tts" in info["endpoints"]
        h = await (await c.get("/health")).json()
        assert h["status"] == "ok"
        m = await (await c.get("/metrics")).json()
        assert m["service"] == "tts_inference_tpu_torch"
        assert m["mode"] in ("single", "scheduler")
        assert "requests_served" in m and "uptime_s" in m
        t = await c.get("/test")
        assert "WebSocket" in await t.text()

    loop.run_until_complete(go())


def test_ws_tts_binary_protocol(client):
    """JSON request → binary chunks → done JSON with server_metrics."""
    c, loop = client

    async def go():
        ws = await c.ws_connect("/ws/tts")
        await ws.send_json(REQ)
        chunks, done = [], None
        while True:
            msg = await ws.receive(timeout=180)
            if msg.type == WSMsgType.BINARY:
                chunks.append(msg.data)
            elif msg.type == WSMsgType.TEXT:
                data = json.loads(msg.data)
                assert "error" not in data, data
                if data.get("done"):
                    done = data
                    break
            else:
                raise AssertionError(msg)
        await ws.close()
        return chunks, done

    chunks, done = loop.run_until_complete(go())
    assert len(chunks) >= 2
    total = sum(len(c_) for c_ in chunks)
    assert done["chunks"] == len(chunks)
    assert done["bytes"] == total
    # 70 tokens → 10 frames → 10*2048 samples *2 bytes
    assert total == 10 * P.SAMPLES_PER_FRAME * 2
    sm = done["server_metrics"]
    for k in ("server_ttft_ms", "server_ttfa_ms", "server_rtf",
              "tokens_per_sec"):
        assert k in sm, sm
    assert sm["tokens"] == 70


def test_ws_audio_base64_protocol(client):
    c, loop = client

    async def go():
        ws = await c.ws_connect("/ws/audio")
        await ws.send_json(REQ)
        chunks, eos = [], None
        while True:
            msg = await ws.receive(timeout=180)
            data = json.loads(msg.data)
            assert "error" not in data, data
            if data.get("event") == "EOS":
                eos = data
                break
            chunks.append((data["chunk_index"],
                           base64.b64decode(data["audio"])))
        await ws.close()
        return chunks, eos

    chunks, eos = loop.run_until_complete(go())
    assert eos["total_chunks"] == len(chunks)
    assert [i for i, _ in chunks] == list(range(1, len(chunks) + 1))


def test_ws_token_debug(client):
    c, loop = client

    async def go():
        ws = await c.ws_connect("/ws")
        await ws.send_json({**REQ, "max_tokens": 10})
        toks, eos = [], None
        while True:
            msg = await ws.receive(timeout=180)
            data = json.loads(msg.data)
            if data.get("event") == "EOS":
                eos = data
                break
            toks.extend(data["tokens"])
        await ws.close()
        return toks, eos

    toks, eos = loop.run_until_complete(go())
    assert eos["total_tokens"] == len(toks) >= 10


def test_generate_wav_and_headers(client):
    c, loop = client

    async def go():
        r = await c.post("/generate", json=REQ)
        body = await r.read()
        return r, body

    r, body = loop.run_until_complete(go())
    assert r.status == 200
    assert r.headers["Content-Type"] == "audio/wav"
    for h in ("X-TTFT-Ms", "X-TTFA-Ms", "X-Audio-Duration-Ms",
              "X-Total-Time-Ms", "X-Decode-Time-Ms", "X-Real-Time-Factor",
              "X-Chunks"):
        assert h in r.headers, h
    with wave.open(io.BytesIO(body)) as w:
        assert w.getframerate() == P.SAMPLE_RATE
        assert w.getnframes() == 10 * P.SAMPLES_PER_FRAME


def test_generate_batch_headers(client):
    c, loop = client

    async def go():
        r = await c.post("/generate-batch", json=REQ)
        await r.read()
        return r

    r = loop.run_until_complete(go())
    assert r.status == 200
    assert r.headers["X-Tokens"] == "70"
    assert r.headers["X-Frames"] == "10"


def test_generate_errors(client):
    c, loop = client

    async def go():
        r1 = await c.post("/generate", json={"text": ""})
        r2 = await c.post("/generate", data=b"not json")
        # without force_speech random weights emit no SOS → no audio → 500
        r3 = await c.post("/generate", json={
            "text": "x", "max_tokens": 10, "seed": 1, "audio_only": True,
        })
        return r1.status, r2.status, r3.status, await r3.json()

    s1, s2, s3, body3 = loop.run_until_complete(go())
    assert s1 == 400 and s2 == 400 and s3 == 500
    assert "error" in body3


def test_dump_tokens(client):
    c, loop = client

    async def go():
        r = await c.post("/dump-tokens", json={**REQ, "max_tokens": 8})
        return r.status, await r.json()

    status, data = loop.run_until_complete(go())
    assert status == 200
    assert data["prompt_ids"][0] == P.TOKEN_SOH
    assert len(data["token_ids"]) >= 8
    assert "tokens_per_sec" in data["timings"]


def test_ws_tts_streaming_equals_batch_decode(client, rt):
    """Audio over the wire equals an offline synthesize with the same
    seed."""
    c, loop = client
    wire = loop.run_until_complete(_ws_pcm(c, REQ, timeout=180))

    from tts_inference_tpu_torch.config import SamplingConfig, StreamConfig

    sampling = SamplingConfig(
        temperature=0.6, top_p=0.95, max_tokens=70, seed=7,
        token_range=(P.TOKEN_AUDIO_BASE, P.TOKEN_AUDIO_BASE + P.AUDIO_VOCAB),
    )
    offline, _ = rt.pipeline.synthesize(
        "hello websocket", "tara", sampling,
        StreamConfig(frames_per_chunk=2, lookahead_frames=3),
        force_speech=True,
    )
    np.testing.assert_array_equal(
        np.frombuffer(wire, np.int16), np.frombuffer(offline, np.int16))


def test_multistream_concurrent_ws(rt):
    """Scheduler mode: two concurrent WS streams both complete with the
    right amount of audio."""

    async def go(c):
        return await asyncio.gather(
            _ws_pcm(c, {**REQ, "seed": 21, "max_tokens": 35}),
            _ws_pcm(c, {**REQ, "seed": 22, "max_tokens": 70}))

    a, b = _serve(rt, _scheduler(rt), go)
    assert len(a) == 5 * P.SAMPLES_PER_FRAME * 2
    assert len(b) == 10 * P.SAMPLES_PER_FRAME * 2


def test_disconnect_mid_stream_then_recover(rt):
    """Closing the socket mid-stream must not wedge the single-stream
    server: the next request completes."""
    loop = asyncio.new_event_loop()
    c = TestClient(TestServer(create_app(rt)), loop=loop)
    loop.run_until_complete(c.start_server())
    try:
        async def go():
            ws = await c.ws_connect("/ws/tts")
            await ws.send_json({**REQ, "max_tokens": 140})
            await ws.receive(timeout=180)     # one frame, then vanish
            await ws.close()

            ws2 = await c.ws_connect("/ws/tts")
            await ws2.send_json({**REQ, "max_tokens": 35})
            got = 0
            while True:
                msg = await ws2.receive(timeout=180)
                if msg.type == WSMsgType.BINARY:
                    got += len(msg.data)
                else:
                    data = json.loads(msg.data)
                    if data.get("error"):
                        # the abandoned generation may still hold the engine
                        # for a moment: retry once
                        await asyncio.sleep(3)
                        await ws2.send_json({**REQ, "max_tokens": 35})
                        continue
                    if data.get("done"):
                        break
            await ws2.close()
            return got

        got = loop.run_until_complete(go())
        assert got == 5 * P.SAMPLES_PER_FRAME * 2
    finally:
        loop.run_until_complete(c.close())
        loop.close()


def test_disconnect_mid_stream_scheduler_mode(rt):
    async def go(c):
        ws = await c.ws_connect("/ws/tts")
        await ws.send_json({**REQ, "max_tokens": 700, "seed": 31})
        await ws.receive(timeout=300)
        await ws.close()   # the cancellation frees the slot
        return await _ws_pcm(c, {**REQ, "max_tokens": 35, "seed": 32})

    got = _serve(rt, _scheduler(rt), go)
    assert len(got) == 5 * P.SAMPLES_PER_FRAME * 2


def test_parse_request_capacity_limits():
    """Hard caps of 2000 characters and 120 s of audio."""
    from tts_inference_tpu_torch.config import SamplingConfig, StreamConfig
    from tts_inference_tpu_torch.serving.app import (AUDIO_RANGE,
                                                     parse_request)

    defaults = SamplingConfig(max_tokens=10_000_000)
    sdefaults = StreamConfig()

    text, voice, sampling, stream_cfg, opts = parse_request(
        {"text": "x" * (P.MAX_TEXT_CHARS + 500), "max_tokens": 10_000_000},
        defaults, sdefaults,
    )
    assert len(text) == P.MAX_TEXT_CHARS
    # 120 s of audio = 120*24000/2048 frames * 7 tokens/frame
    cap = int(P.MAX_AUDIO_SECONDS * P.SAMPLE_RATE
              / P.SAMPLES_PER_FRAME * P.FRAME_SIZE)
    assert sampling.max_tokens == cap
    assert voice == "tara" and not opts["benchmark"]

    _, _, s2, _, _ = parse_request({"text": "hi", "max_tokens": 70},
                                   defaults, sdefaults)
    assert s2.max_tokens == 70

    _, _, s3, _, _ = parse_request({"text": "hi", "audio_only": True},
                                   defaults, sdefaults)
    assert s3.token_range == AUDIO_RANGE

    _, _, _, sc, _ = parse_request(
        {"text": "hi", "frames_per_chunk": 9, "lookahead_frames": 2},
        defaults, sdefaults,
    )
    assert sc.frames_per_chunk == 9 and sc.lookahead_frames == 2


def test_parse_request_casts_and_clamps_wire_values():
    """A float or negative wire value is cast or clamped in parse_request,
    never raised inside the scheduler's admission wave."""
    from tts_inference_tpu_torch.config import SamplingConfig, StreamConfig
    from tts_inference_tpu_torch.serving.app import parse_request

    defaults, sdef = SamplingConfig(), StreamConfig()
    _, _, s, sc, _ = parse_request(
        {"text": "hi", "force_speech": True,
         "first_chunk_lookahead": 0.5,
         "frames_per_chunk": 0, "lookahead_frames": -3,
         "max_tokens": -5, "temperature": -1.0, "top_p": 7,
         "seed": 3.0, "repetition_penalty": 0},
        defaults, sdef,
    )
    assert isinstance(sc.first_chunk_lookahead, int)
    assert sc.first_chunk_lookahead == 0
    assert sc.frames_per_chunk >= 1
    assert sc.lookahead_frames >= 0
    assert s.max_tokens >= 1
    assert s.temperature >= 0.0 and 0.0 <= s.top_p <= 1.0
    assert isinstance(s.seed, int) and s.repetition_penalty > 0
    _, _, _, sc2, _ = parse_request({"text": "x"}, defaults, sdef)
    assert sc2.first_chunk_lookahead == sdef.first_chunk_lookahead


def test_parse_request_fuzz():
    """Junk on every wire field either raises cleanly or yields well-typed,
    clamped values."""
    import random

    from tts_inference_tpu_torch.config import SamplingConfig, StreamConfig
    from tts_inference_tpu_torch.serving.app import parse_request

    defaults, sdef = SamplingConfig(), StreamConfig()
    junk = [None, -1, 0, 1.5, -3.7, 1e18, "abc", "", [], {}, True, "7",
            float("nan"), float("inf")]
    fields = ["temperature", "top_p", "repetition_penalty", "max_tokens",
              "seed", "frames_per_chunk", "lookahead_frames",
              "first_chunk_lookahead", "frame_protocol", "audio_only",
              "benchmark", "force_speech", "voice", "text"]
    rng = random.Random(0)
    raised = 0
    for _ in range(300):
        data = {f: rng.choice(junk) for f in rng.sample(fields, 5)}
        try:
            _, voice, s, sc, opts = parse_request(data, defaults, sdef)
        except (TypeError, ValueError, OverflowError):
            raised += 1
            continue
        assert isinstance(voice, str)
        assert isinstance(s.max_tokens, int) and s.max_tokens >= 1
        assert s.temperature >= 0.0 and 0.0 <= s.top_p <= 1.0
        assert s.repetition_penalty > 0
        assert s.seed is None or isinstance(s.seed, int)
        assert isinstance(sc.frames_per_chunk, int) and sc.frames_per_chunk >= 1
        assert isinstance(sc.lookahead_frames, int) and sc.lookahead_frames >= 0
        assert sc.first_chunk_lookahead is None or (
            isinstance(sc.first_chunk_lookahead, int)
            and sc.first_chunk_lookahead >= 0)
        for v in opts.values():
            assert isinstance(v, bool)
    assert 0 < raised < 300


def test_metrics_reports_prefix_cache_counters(rt):
    """With the prefix cache on, /metrics carries the scheduler core's
    prefix_hits and prefix_misses: three requests of one text miss once
    and hit twice; without it the keys are absent."""
    cfg = dataclasses.replace(rt.config, engine=dataclasses.replace(
        rt.config.engine, prefix_cache=True))

    async def go(c):
        before = (await (await c.get("/metrics")).json())["scheduler"]
        for seed in (41, 42, 43):
            await _ws_pcm(c, {**REQ, "max_tokens": 14, "seed": seed})
        after = (await (await c.get("/metrics")).json())["scheduler"]
        return before, after

    before, after = _serve(rt, _scheduler(rt, cfg), go)
    assert (before["prefix_hits"], before["prefix_misses"]) == (0, 0)
    assert (after["prefix_hits"], after["prefix_misses"]) == (2, 1)

    async def plain(c):
        return (await (await c.get("/metrics")).json())["scheduler"]

    assert "prefix_hits" not in _serve(rt, _scheduler(rt), plain)
