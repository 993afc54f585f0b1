"""HTTP/WebSocket serving layer of the port (aiohttp).

The port's own server: the wire contracts and the request parsing of
``tts_inference_tpu/serving/app.py``, over the port's runtime and scheduler.
Under lockstep serving (``lockstep=True``, ``cli serve --tp/--dp``) the
endpoints that drive the single-stream engine answer 503, as the JAX
package's do.

Preserves the reference's wire contracts so its surviving benchmark clients
run unmodified against this server:

- `WS /ws/tts`  — production protocol (PIPELINE_REPORT.md:563-569,667-691):
  client sends one JSON request, server streams **binary** int16 PCM chunks,
  then `{"done": true, "chunks": N, "duration_s": …, "bytes": …,
  "server_metrics": {…}}` (metrics included when `benchmark: true`).
  Clients: plot_metrics/benchmark_with_wandb.py, comprehensive_sweep.py.
- `WS /ws/audio` — base64 JSON protocol (`modal_audio_stream.py:448-498`):
  `{"audio": <b64>, "chunk_index": n}` … `{"event": "EOS", "total_chunks"}`.
- `WS /ws`       — token-debug stream (`modal_audio_stream.py:675-722`).
- `POST /generate` — WAV + `X-TTFT-Ms`/`X-TTFA-Ms`/`X-Audio-Duration-Ms`/
  `X-Total-Time-Ms`/`X-Decode-Time-Ms`/`X-Real-Time-Factor`/`X-Chunks`
  headers (`modal_audio_stream.py:581-672`).
- `POST /generate-batch` — WAV + `X-Audio-Duration-Ms`/`X-Total-Time-Ms`/
  `X-Tokens`/`X-Frames` (`modal_audio_stream.py:506-578`).
- `POST /dump-tokens`, `GET /`, `GET /health`, `GET /test` (HTML player).

Concurrency: generation runs in a worker thread (the device loop is
blocking); an asyncio lock serializes access to the single engine slot and
busy requests get the reference's 503/`{"error": "Generation in progress"}`
behavior — but checked atomically inside the event loop, fixing the
reference's check-then-acquire race (SURVEY.md §5.2). With a Scheduler
attached (serve --multi-stream) requests queue into continuous-batching
slots instead and the lock disappears.
"""

from __future__ import annotations

import asyncio
import base64
import concurrent.futures
import contextlib
import dataclasses
import json
import time
from typing import AsyncIterator, Optional, Tuple

import torch
from aiohttp import WSMsgType, web

from tts_inference_tpu_torch import protocol
from tts_inference_tpu_torch.config import SamplingConfig, StreamConfig
from tts_inference_tpu_torch.engine.scheduler import TTSRequest
from tts_inference_tpu_torch.utils.audio import wav_bytes

AUDIO_RANGE = (
    protocol.TOKEN_AUDIO_BASE,
    protocol.TOKEN_AUDIO_BASE + protocol.AUDIO_VOCAB,
)


def parse_request(data: dict, defaults: SamplingConfig,
                  stream_defaults: StreamConfig
                  ) -> Tuple[str, str, SamplingConfig, StreamConfig, dict]:
    """Per-request JSON fields (reference contract:
    comprehensive_sweep.py:143-150 + our extensions)."""
    text = (data.get("text") or "")[: protocol.MAX_TEXT_CHARS]
    voice = str(data.get("voice", "tara"))
    # capacity limits (reference: spec.md:133-135 — 2000 chars / 120 s audio)
    max_audio_tokens = int(
        protocol.MAX_AUDIO_SECONDS * protocol.SAMPLE_RATE
        / protocol.SAMPLES_PER_FRAME * protocol.FRAME_SIZE
    )
    # every numeric field is cast AND clamped here: stream geometry reaches
    # the scheduler's slicing — a float or negative value from the wire must
    # never become a shape (one malformed request would otherwise fail the
    # whole admission wave)
    sampling = dataclasses.replace(
        defaults,
        temperature=max(
            0.0, float(data.get("temperature", defaults.temperature))
        ),
        top_p=min(1.0, max(
            0.0, float(data.get("top_p", defaults.top_p))
        )),
        repetition_penalty=max(0.01, float(
            data.get("repetition_penalty", defaults.repetition_penalty)
        )),
        max_tokens=max(1, min(
            int(data.get("max_tokens", defaults.max_tokens)),
            max_audio_tokens,
        )),
        seed=(lambda v: None if v is None else int(v))(
            data.get("seed", defaults.seed)
        ),
        token_range=AUDIO_RANGE if data.get("audio_only") else defaults.token_range,
        frame_protocol=bool(
            data.get("frame_protocol", defaults.frame_protocol)
        ),
    )
    stream_cfg = dataclasses.replace(
        stream_defaults,
        frames_per_chunk=max(1, int(
            data.get("frames_per_chunk", stream_defaults.frames_per_chunk)
        )),
        lookahead_frames=max(0, int(
            data.get("lookahead_frames", stream_defaults.lookahead_frames)
        )),
        first_chunk_lookahead=(lambda v: None if v is None else max(0, int(v)))(
            data.get("first_chunk_lookahead",
                     stream_defaults.first_chunk_lookahead)
        ),
    )
    opts = {
        "benchmark": bool(data.get("benchmark", False)),
        "force_speech": bool(data.get("force_speech", False)),
    }
    return text, voice, sampling, stream_cfg, opts


class Server:
    def __init__(self, runtime, scheduler=None, lockstep=False):
        self.rt = runtime
        self.scheduler = scheduler            # multi-stream mode when set
        # lockstep serving (parallel/lockstep.py): the single-stream engine's
        # launches are not mirrored to the follower processes, so the token
        # debug endpoints that drive it are refused
        self.lockstep = lockstep
        self.lock = asyncio.Lock()
        self.started_at = time.time()
        self.requests_served = 0
        # the most recently finished request's metrics (/metrics →
        # last_request); a handler reads its own request's from chunk_stream
        self._last_metrics = None
        # dedicated pool for per-request event pumps: each live scheduler
        # stream parks one thread for its lifetime; the default executor
        # (~cpu+4 workers) would starve other run_in_executor users at
        # high stream counts
        self._pump_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=128, thread_name_prefix="ws-pump"
        )

    # ---- generation bridge (blocking device loop → async chunks) ---------

    async def chunk_stream(
        self, text: str, voice: str, sampling: SamplingConfig,
        stream_cfg: StreamConfig, force_speech: bool,
        result: Optional[dict] = None,
    ) -> AsyncIterator:
        """The request's audio chunks; once they end, ``result["metrics"]``
        holds this request's ``StreamMetrics`` (None for a request
        cancelled before it finished)."""
        if result is None:
            result = {}
        if self.scheduler is not None:
            async for chunk in self._scheduler_stream(
                text, voice, sampling, stream_cfg, force_speech, result
            ):
                yield chunk
            return
        loop = asyncio.get_running_loop()
        # unbounded: if the client disconnects mid-stream the consumer stops
        # draining, and a bounded queue would park the worker thread forever
        # on a put that never completes (generation is already bounded by
        # max_tokens, so the worker always terminates)
        q: asyncio.Queue = asyncio.Queue()
        DONE, ERR = object(), object()

        def worker():
            try:
                for chunk in self.rt.pipeline.stream(
                    text, voice, sampling, stream_cfg,
                    force_speech=force_speech,
                ):
                    asyncio.run_coroutine_threadsafe(
                        q.put(("chunk", chunk)), loop
                    ).result()
                result["metrics"] = self._last_metrics = \
                    self.rt.pipeline.last_metrics
                asyncio.run_coroutine_threadsafe(q.put((DONE, None)), loop).result()
            except Exception as e:  # noqa: BLE001 — surfaced to the client
                asyncio.run_coroutine_threadsafe(q.put((ERR, e)), loop).result()

        task = loop.run_in_executor(None, worker)
        try:
            while True:
                kind, payload = await q.get()
                if kind is DONE:
                    break
                if kind is ERR:
                    raise payload
                yield payload
        finally:
            await task

    async def _scheduler_stream(
        self, text, voice, sampling, stream_cfg, force_speech, result
    ) -> AsyncIterator:
        """Multi-stream path: submit to the continuous-batching scheduler and
        drain the request's event queue without blocking the event loop."""
        req = TTSRequest(
            text=text, voice=voice, sampling=sampling,
            stream_cfg=stream_cfg, force_speech=force_speech,
        )
        self.scheduler.submit(req)
        loop = asyncio.get_running_loop()
        # one persistent pump thread per request (not one executor hop per
        # EVENT — at 8 live WS streams the per-event submit+park round
        # trips serialized chunk delivery)
        aq: asyncio.Queue = asyncio.Queue()
        timeout_s = self.rt.config.server.request_timeout_s

        def pump():
            # Short-poll instead of one long blocking get: a cancelled
            # request (client disconnect) whose terminal event never comes
            # (e.g. still queued behind a long backlog) must release this
            # pool worker promptly, not after the full request timeout.
            deadline = time.monotonic() + timeout_s
            while True:
                try:
                    item = req.events.get(timeout=0.25)
                except Exception:
                    if req.cancelled:
                        item = ("done", None)
                    elif time.monotonic() > deadline:
                        item = ("error", "request timed out")
                    else:
                        continue
                try:
                    # bounded: if the event loop stopped, exit instead of
                    # parking this worker forever on an orphaned future
                    asyncio.run_coroutine_threadsafe(
                        aq.put(item), loop
                    ).result(timeout=30.0)
                except Exception:
                    return
                if item[0] in ("done", "error"):
                    return

        task = loop.run_in_executor(self._pump_pool, pump)
        try:
            while True:
                kind, payload = await aq.get()
                if kind == "chunk":
                    yield payload
                elif kind == "done":
                    result["metrics"] = payload
                    if payload is not None:
                        self._last_metrics = payload
                    return
                else:
                    raise RuntimeError(payload)
        except BaseException:
            req.cancel()
            raise
        finally:
            await task

    def metrics(self):
        if self.scheduler is not None:
            return self._last_metrics
        return self.rt.pipeline.last_metrics

    def _slot(self):
        """Serialize on the single-stream engine; no-op under the scheduler
        (requests queue into slots instead)."""
        if self.scheduler is not None:
            return contextlib.nullcontext()
        return self.lock

    # ---- HTTP ------------------------------------------------------------

    async def index(self, request: web.Request) -> web.Response:
        return web.json_response({
            "service": "tts_inference_tpu_torch",
            "model": "orpheus-3b (pytorch/cuda)",
            "endpoints": ["/ws/tts", "/ws/audio", "/ws", "/generate",
                          "/generate-batch", "/dump-tokens", "/health",
                          "/test"],
            "sample_rate": protocol.SAMPLE_RATE,
            "uptime_s": round(time.time() - self.started_at, 1),
            "requests_served": self.requests_served,
        })

    async def health(self, request: web.Request) -> web.Response:
        fatal = getattr(self.scheduler, "fatal", None)
        if fatal:
            # the engine is unrecoverable (a lockstep follower was lost):
            # say so to the supervisor instead of pretending to be up
            return web.json_response({"status": "fatal", "error": fatal},
                                     status=503)
        return web.json_response({"status": "ok", "busy": self.lock.locked()})

    _LOCKSTEP_TOKENS = ("token debug endpoints are unavailable under "
                        "lockstep multi-process serving")

    async def metrics_endpoint(self, request: web.Request) -> web.Response:
        """Fleet-level observability (SURVEY.md §5.5): server counters,
        scheduler occupancy/queue depth, KV-pool headroom, device memory
        (``torch.cuda.memory_stats``) when the runtime is on a card — the standing
        numbers a supervisor polls, complementing the per-request
        `server_metrics` payload the reference defines."""
        body: dict = {
            "service": "tts_inference_tpu_torch",
            "uptime_s": round(time.time() - self.started_at, 1),
            "requests_served": self.requests_served,
            "mode": "scheduler" if self.scheduler is not None else "single",
            "busy": self.lock.locked(),
        }
        m = self.metrics()
        body["last_request"] = m.as_wire() if m is not None else None
        if self.scheduler is not None:
            s = self.scheduler
            core = s.core
            sch: dict = {
                "slots": len(s.slots),
                "active": s.n_active,
                "queued": s.n_queued,
                "vocode_pending": s._vocode_pending,
            }
            if core.engine_cfg.paged_kv:
                sch["kv_free_tokens"] = core.free_tokens()
                if core.engine_cfg.kv_on_demand:
                    sch["preemptions"] = s.preemptions
            if core.engine_cfg.prefix_cache:
                sch["prefix_hits"] = core.prefix_hits
                sch["prefix_misses"] = core.prefix_misses
            sch.update(s.counters)
            body["scheduler"] = sch
        # the CUDA-graph census of the engine core that serves, and the
        # vocoder's (on the CPU: the keys the card would capture)
        core = (self.scheduler.core if self.scheduler is not None
                else self.rt.engine.core)
        voc = self.rt.vocoder.census()
        voc.pop("vocoder_graph_census_ms")
        body["graphs"] = {"graphs_compiled": len(core.graph_census_ms),
                          "late_captures": core.late_captures,
                          "launches": dict(core.launches),
                          "replays": dict(core.replays), **voc}
        if self.rt.device.type == "cuda":
            stats = torch.cuda.memory_stats(self.rt.device)
            body["device_memory"] = {
                k: int(v) for k, v in stats.items()
                if "bytes" in k and k.endswith((".all.current", ".all.peak"))}
        return web.json_response(body)

    async def test_page(self, request: web.Request) -> web.Response:
        return web.Response(text=TEST_PAGE, content_type="text/html")

    def _busy(self) -> bool:
        # scheduler mode queues requests instead of rejecting them
        if self.scheduler is not None:
            return False
        return self.lock.locked()

    def _token_slot(self):
        """Token endpoints (/dump-tokens, /ws) drive the shared
        single-stream GenerationEngine even in scheduler mode, so they must
        ALWAYS serialize on the lock — two concurrent token requests would
        otherwise mutate the same EngineCore's cache/sampling state
        from separate executor threads."""
        return self.lock

    async def generate(self, request: web.Request) -> web.Response:
        """Streaming-path WAV endpoint (reference /generate)."""
        try:
            data = await request.json()
        except Exception:
            return web.json_response({"error": "Invalid JSON"}, status=400)
        text, voice, sampling, scfg, opts = parse_request(
            data, self.rt.config.sampling, self.rt.config.stream
        )
        if not text:
            return web.json_response({"error": "No text provided"}, status=400)
        if self._busy():
            return web.json_response(
                {"error": "Generation in progress, try again later"},
                status=503,
            )
        res: dict = {}
        async with self._slot():
            t0 = time.perf_counter()
            chunks = []
            async for chunk in self.chunk_stream(
                text, voice, sampling, scfg, opts["force_speech"], res
            ):
                chunks.append(chunk.pcm)
            total_ms = (time.perf_counter() - t0) * 1000.0
        m = res["metrics"]
        pcm = b"".join(chunks)
        if not pcm:
            return web.json_response(
                {"error": "No audio generated", "tokens": m.tokens,
                 "text": text[:100]},
                status=500,
            )
        self.requests_served += 1
        return web.Response(
            body=wav_bytes(pcm),
            content_type="audio/wav",
            headers={
                "Content-Disposition": "attachment; filename=output.wav",
                "X-TTFT-Ms": f"{m.ttft_ms:.2f}",
                "X-TTFA-Ms": f"{m.ttfa_ms:.2f}",
                "X-Audio-Duration-Ms": f"{m.audio_duration_ms:.2f}",
                "X-Total-Time-Ms": f"{total_ms:.2f}",
                "X-Decode-Time-Ms": f"{sum(m.decode_times_ms):.2f}",
                "X-Real-Time-Factor": f"{m.rtf:.4f}",
                "X-Chunks": str(m.chunks),
            },
        )

    async def generate_batch(self, request: web.Request) -> web.Response:
        """Collect-all-then-decode-once endpoint (reference /generate-batch)."""
        try:
            data = await request.json()
        except Exception:
            return web.json_response({"error": "Invalid JSON"}, status=400)
        text, voice, sampling, _, opts = parse_request(
            data, self.rt.config.sampling, self.rt.config.stream
        )
        if not text:
            return web.json_response({"error": "No text provided"}, status=400)
        if self._busy():
            return web.json_response({"error": "Generation in progress"},
                                     status=503)
        # batch mode: one decode at the end = frames_per_chunk → ∞
        scfg = dataclasses.replace(
            self.rt.config.stream, frames_per_chunk=10**9
        )
        res: dict = {}
        async with self._slot():
            t0 = time.perf_counter()
            chunks = []
            async for chunk in self.chunk_stream(
                text, voice, sampling, scfg, opts["force_speech"], res
            ):
                chunks.append(chunk.pcm)
            total_ms = (time.perf_counter() - t0) * 1000.0
        m = res["metrics"]
        pcm = b"".join(chunks)
        if not pcm:
            return web.json_response(
                {"error": f"Not enough tokens: {m.tokens}"}, status=500
            )
        self.requests_served += 1
        return web.Response(
            body=wav_bytes(pcm),
            content_type="audio/wav",
            headers={
                "Content-Disposition": "attachment; filename=batch_output.wav",
                "X-Audio-Duration-Ms": f"{m.audio_duration_ms:.2f}",
                "X-Total-Time-Ms": f"{total_ms:.2f}",
                "X-Tokens": str(m.tokens),
                "X-Frames": str(m.frames),
            },
        )

    async def dump_tokens(self, request: web.Request) -> web.Response:
        try:
            data = await request.json()
        except Exception:
            return web.json_response({"error": "Invalid JSON"}, status=400)
        text, voice, sampling, _, _ = parse_request(
            data, self.rt.config.sampling, self.rt.config.stream
        )
        if not text:
            return web.json_response({"error": "No text provided"}, status=400)
        if self.lockstep:
            return web.json_response({"error": self._LOCKSTEP_TOKENS},
                                     status=503)
        if self._busy():
            return web.json_response({"error": "Generation in progress"},
                                     status=503)
        async with self._token_slot():
            loop = asyncio.get_running_loop()
            prompt = self.rt.pipeline.build_prompt(text, voice)
            res = await loop.run_in_executor(
                None, lambda: self.rt.engine.generate(prompt, sampling)
            )
        return web.json_response({
            "prompt_ids": prompt,
            "token_ids": res.token_ids,
            "timings": res.timings,
        })

    # ---- WebSockets --------------------------------------------------------

    async def ws_tts(self, request: web.Request) -> web.WebSocketResponse:
        """Production protocol: binary PCM chunks + done JSON."""
        # no heartbeat, as in the JAX package: clients keep their own pings
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        try:
            async for msg in ws:
                if msg.type != WSMsgType.TEXT:
                    continue
                data = json.loads(msg.data)
                text, voice, sampling, scfg, opts = parse_request(
                    data, self.rt.config.sampling, self.rt.config.stream
                )
                if not text:
                    await ws.send_json({"error": "No text provided"})
                    continue
                if self._busy():
                    await ws.send_json(
                        {"error": "Generation in progress, try again later"}
                    )
                    continue
                res: dict = {}
                async with self._slot():
                    n_chunks, n_bytes = 0, 0
                    async for chunk in self.chunk_stream(
                        text, voice, sampling, scfg, opts["force_speech"], res
                    ):
                        await ws.send_bytes(chunk.pcm)
                        n_chunks += 1
                        n_bytes += len(chunk.pcm)
                m = res["metrics"]
                done = {
                    "done": True,
                    "chunks": n_chunks,
                    "duration_s": round(m.audio_duration_ms / 1000.0, 3),
                    "bytes": n_bytes,
                }
                if opts["benchmark"]:
                    done["server_metrics"] = m.as_wire()
                self.requests_served += 1
                await ws.send_json(done)
        except Exception as e:  # noqa: BLE001
            if not ws.closed:
                try:
                    await ws.send_json({"error": str(e)})
                except Exception:
                    pass
        return ws

    async def ws_audio(self, request: web.Request) -> web.WebSocketResponse:
        """Legacy base64-JSON protocol (modal_audio_stream.py:448-498)."""
        # no heartbeat, as in the JAX package: clients keep their own pings
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        try:
            async for msg in ws:
                if msg.type != WSMsgType.TEXT:
                    continue
                data = json.loads(msg.data)
                text, voice, sampling, scfg, opts = parse_request(
                    data, self.rt.config.sampling, self.rt.config.stream
                )
                if not text:
                    await ws.send_json({"error": "No text provided"})
                    continue
                if self._busy():
                    await ws.send_json(
                        {"error": "Generation in progress, try again later"}
                    )
                    continue
                async with self._slot():
                    chunk_index = 0
                    async for chunk in self.chunk_stream(
                        text, voice, sampling, scfg, opts["force_speech"]
                    ):
                        chunk_index += 1
                        await ws.send_json({
                            "audio": base64.b64encode(chunk.pcm).decode(),
                            "chunk_index": chunk_index,
                        })
                self.requests_served += 1
                await ws.send_json({
                    "event": "EOS",
                    "total_chunks": chunk_index,
                })
        except Exception as e:  # noqa: BLE001
            if not ws.closed:
                try:
                    await ws.send_json({"error": str(e)})
                except Exception:
                    pass
        return ws

    async def ws_tokens(self, request: web.Request) -> web.WebSocketResponse:
        """Token-debug stream (modal_audio_stream.py:675-722): raw token ids
        as JSON messages, then EOS summary."""
        # no heartbeat, as in the JAX package: clients keep their own pings
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        try:
            async for msg in ws:
                if msg.type != WSMsgType.TEXT:
                    continue
                data = json.loads(msg.data)
                text, voice, sampling, _, _ = parse_request(
                    data, self.rt.config.sampling, self.rt.config.stream
                )
                if not text:
                    await ws.send_json({"error": "No text provided"})
                    continue
                if self.lockstep:
                    await ws.send_json({"error": self._LOCKSTEP_TOKENS})
                    continue
                if self._busy():
                    await ws.send_json(
                        {"error": "Generation in progress, try again later"}
                    )
                    continue
                async with self._token_slot():
                    loop = asyncio.get_running_loop()
                    prompt = self.rt.pipeline.build_prompt(text, voice)
                    total = 0

                    q: asyncio.Queue = asyncio.Queue()

                    def worker():
                        try:
                            for tok_chunk in self.rt.engine.stream(
                                prompt, sampling
                            ):
                                asyncio.run_coroutine_threadsafe(
                                    q.put(tok_chunk), loop
                                ).result()
                        finally:
                            asyncio.run_coroutine_threadsafe(
                                q.put(None), loop
                            ).result()

                    task = loop.run_in_executor(None, worker)
                    while True:
                        tok_chunk = await q.get()
                        if tok_chunk is None:
                            break
                        total += len(tok_chunk)
                        await ws.send_json({"tokens": tok_chunk})
                    await task
                await ws.send_json({"event": "EOS", "total_tokens": total})
        except Exception as e:  # noqa: BLE001
            if not ws.closed:
                try:
                    await ws.send_json({"error": str(e)})
                except Exception:
                    pass
        return ws


def create_app(runtime, scheduler=None, lockstep=False) -> web.Application:
    server = Server(runtime, scheduler, lockstep=lockstep)
    app = web.Application()
    app["server"] = server
    app.add_routes([
        web.get("/", server.index),
        web.get("/health", server.health),
        web.get("/metrics", server.metrics_endpoint),
        web.get("/test", server.test_page),
        web.post("/generate", server.generate),
        web.post("/tts", server.generate),   # alias (tensorrt_tts/inference.py POST /tts)
        web.post("/generate-batch", server.generate_batch),
        web.post("/dump-tokens", server.dump_tokens),
        web.get("/ws/tts", server.ws_tts),
        web.get("/ws/audio", server.ws_audio),
        web.get("/ws", server.ws_tokens),
    ])
    return app


def run_app(runtime, host: str = "0.0.0.0", port: int = 8000,
            scheduler=None, lockstep=False) -> int:
    """Serve until shutdown; stops the scheduler's threads on the way out.
    Returns 0 on a clean stop, 13 when the scheduler declared the engine
    unrecoverable (a lockstep follower lost), for a supervisor to restart
    the group."""
    loop = asyncio.new_event_loop()
    if scheduler is not None:
        # a fatal engine loss takes the server down, rather than leaving an
        # API up that can only answer with errors
        scheduler.on_fatal = lambda msg: loop.call_soon_threadsafe(loop.stop)
        scheduler.start()
    try:
        web.run_app(create_app(runtime, scheduler, lockstep=lockstep),
                    host=host, port=port, loop=loop)
    except RuntimeError:
        # on_fatal stopped the loop under the running app
        if scheduler is None or scheduler.fatal is None:
            raise
    finally:
        if scheduler is not None:
            scheduler.stop()
    if scheduler is not None and scheduler.fatal is not None:
        print(f"fatal: {scheduler.fatal}", flush=True)
        return 13
    return 0


TEST_PAGE = """<!doctype html>
<html><head><title>tts_inference_tpu_torch</title></head>
<body style="font-family: sans-serif; max-width: 640px; margin: 2em auto">
<h2>TTS — streaming test client</h2>
<textarea id="text" rows="3" style="width:100%">Hello from the GPU.</textarea>
<div>
  voice <input id="voice" value="tara"/>
  <button onclick="go()">Speak</button>
  <span id="status"></span>
</div>
<script>
async function go() {
  const status = document.getElementById('status');
  const ws = new WebSocket((location.protocol === 'https:' ? 'wss://' : 'ws://') + location.host + '/ws/tts');
  const ctx = new (window.AudioContext || window.webkitAudioContext)({sampleRate: 24000});
  let t = ctx.currentTime;
  ws.binaryType = 'arraybuffer';
  ws.onopen = () => {
    status.textContent = 'generating…';
    ws.send(JSON.stringify({
      text: document.getElementById('text').value,
      voice: document.getElementById('voice').value,
    }));
  };
  ws.onmessage = (ev) => {
    if (typeof ev.data === 'string') {
      const m = JSON.parse(ev.data);
      if (m.done) { status.textContent = 'done: ' + m.chunks + ' chunks, ' + m.duration_s + 's'; ws.close(); }
      if (m.error) { status.textContent = 'error: ' + m.error; ws.close(); }
      return;
    }
    const pcm = new Int16Array(ev.data);
    const buf = ctx.createBuffer(1, pcm.length, 24000);
    const ch = buf.getChannelData(0);
    for (let i = 0; i < pcm.length; i++) ch[i] = pcm[i] / 32767;
    const src = ctx.createBufferSource();
    src.buffer = buf; src.connect(ctx.destination);
    t = Math.max(t, ctx.currentTime + 0.05);
    src.start(t); t += buf.duration;
  };
}
</script></body></html>
"""
