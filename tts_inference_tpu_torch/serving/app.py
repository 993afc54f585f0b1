"""HTTP/WebSocket serving layer for the port (aiohttp).

Reuses ``tts_inference_tpu.serving.app`` — its wire contracts (``/ws/tts``
binary PCM + done JSON, ``/generate`` WAV + X-* headers, ``/ws/audio``,
``/ws``, ``/generate-batch``, ``/dump-tokens``) and its request parsing —
through a subclass that overrides the two methods that reach into jax:
``_scheduler_stream`` (the JAX ``TTSRequest``) and ``metrics_endpoint``
(jax device memory stats; here ``torch.cuda.memory_stats()``).
"""

from __future__ import annotations

import asyncio
import time
from typing import AsyncIterator

import torch
from aiohttp import web

from tts_inference_tpu.serving import app as base
from tts_inference_tpu_torch.engine.scheduler import TTSRequest


class Server(base.Server):
    async def _scheduler_stream(self, text, voice, sampling, stream_cfg,
                                force_speech) -> AsyncIterator:
        """Submit to the scheduler and drain the request's event queue from
        one pump thread, without blocking the event loop."""
        req = TTSRequest(text=text, voice=voice, sampling=sampling,
                         stream_cfg=stream_cfg, force_speech=force_speech)
        self.scheduler.submit(req)
        loop = asyncio.get_running_loop()
        aq: asyncio.Queue = asyncio.Queue()
        timeout_s = self.rt.config.server.request_timeout_s

        def pump():
            # short polls: a cancelled request whose terminal event never
            # comes must release this worker promptly
            deadline = time.monotonic() + timeout_s
            while True:
                try:
                    item = req.events.get(timeout=0.25)
                except Exception:  # queue.Empty
                    if req.cancelled:
                        item = ("done", None)
                    elif time.monotonic() > deadline:
                        item = ("error", "request timed out")
                    else:
                        continue
                try:
                    asyncio.run_coroutine_threadsafe(
                        aq.put(item), loop).result(timeout=30.0)
                except Exception:  # event loop gone
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
                    self._last_metrics = payload
                    return
                else:
                    raise RuntimeError(payload)
        except BaseException:
            req.cancel()
            raise
        finally:
            await task

    async def metrics_endpoint(self, request: web.Request) -> web.Response:
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
            sch = {"slots": len(s.slots), "active": s.n_active,
                   "queued": s.n_queued, "vocode_pending": s._vocode_pending}
            ecfg = s.core.engine_cfg
            if ecfg.paged_kv:
                sch["kv_free_tokens"] = s.core.free_tokens()
                if ecfg.kv_on_demand:
                    sch["preemptions"] = s.preemptions
            body["scheduler"] = sch
        if self.rt.device.type == "cuda":
            stats = torch.cuda.memory_stats(self.rt.device)
            body["device_memory"] = {
                k: int(v) for k, v in stats.items()
                if "bytes" in k and k.endswith((".all.current", ".all.peak"))}
        return web.json_response(body)


def create_app(runtime, scheduler=None) -> web.Application:
    server = Server(runtime, scheduler)
    app = web.Application()
    app["server"] = server
    app.add_routes([
        web.get("/", server.index),
        web.get("/health", server.health),
        web.get("/metrics", server.metrics_endpoint),
        web.get("/test", server.test_page),
        web.post("/generate", server.generate),
        web.post("/tts", server.generate),
        web.post("/generate-batch", server.generate_batch),
        web.post("/dump-tokens", server.dump_tokens),
        web.get("/ws/tts", server.ws_tts),
        web.get("/ws/audio", server.ws_audio),
        web.get("/ws", server.ws_tokens),
    ])
    return app


def run_app(runtime, host: str = "0.0.0.0", port: int = 8000,
            scheduler=None) -> int:
    """Serve until shutdown; stops the scheduler's threads on the way out."""
    loop = asyncio.new_event_loop()
    if scheduler is not None:
        scheduler.start()
    try:
        web.run_app(create_app(runtime, scheduler), host=host, port=port,
                    loop=loop)
    finally:
        if scheduler is not None:
            scheduler.stop()
    return 0
