"""Replica front router: least-loaded dispatch over N serving replicas.

Port of ``deploy/router.py`` (same routes, dispatch order, cooldown, probe
loop, ``/health`` and ``/metrics``): one ``cli serve`` process per replica,
one WS/HTTP router in front.

    python -m tts_inference_tpu_torch.deploy.router --port 8000 \
        --replica http://127.0.0.1:8001 --replica http://127.0.0.1:8002

or, spawning the replicas too: ``python -m
tts_inference_tpu_torch.deploy.launch --replicas N ...``.

Design:
- **Least-loaded dispatch**: the router tracks in-flight requests per
  replica (its own counter — no metrics round-trip on the hot path) and
  routes each new request/socket to the live replica with the fewest.
- **Failover**: a replica that refuses connections is marked down for
  `--cooldown-s` and the request retries on the next-least-loaded one;
  `/health` is green while ≥1 replica is up. A background prober brings
  cooled-down replicas back when their /health answers.
- **Transparent proxy**: HTTP bodies and WS frames (binary PCM + JSON
  control) pass through unmodified, so the reference's benchmark clients
  work against the router exactly as against a single server.
- `/metrics` sums the replicas' ``scheduler`` slots, active and queued
  streams, and nests each replica's whole ``/metrics`` body — on a card
  its device memory and its graph census with ``late_captures`` too, which
  stay per replica.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import sys
import time
from typing import List, Optional

import aiohttp
from aiohttp import WSMsgType, web

HOP_HEADERS = {
    "host", "connection", "upgrade", "sec-websocket-key",
    "sec-websocket-version", "sec-websocket-extensions",
    "transfer-encoding", "content-length", "keep-alive",
}


class Replica:
    def __init__(self, base: str):
        self.base = base.rstrip("/")
        self.inflight = 0
        # unverified until the first successful probe/response — /health
        # must not claim a replica that was never seen alive (a green
        # router answering 503 is worse than a briefly-red one)
        self.down_until = float("inf")
        self.served = 0
        self.failures = 0

    @property
    def up(self) -> bool:
        return time.monotonic() >= self.down_until

    def mark_down(self, cooldown_s: float) -> None:
        self.failures += 1
        self.down_until = time.monotonic() + cooldown_s

    def mark_up(self) -> None:
        self.down_until = 0.0


class Router:
    def __init__(self, replicas: List[str], cooldown_s: float = 5.0,
                 probe_interval_s: float = 2.0):
        self.replicas = [Replica(r) for r in replicas]
        self.cooldown_s = cooldown_s
        self.probe_interval_s = probe_interval_s
        self._session: Optional[aiohttp.ClientSession] = None
        self._probe_task: Optional[asyncio.Task] = None

    # -- lifecycle -----------------------------------------------------------

    async def startup(self, app) -> None:
        self._session = aiohttp.ClientSession()
        await self._probe_once()          # /health accurate from t0
        self._probe_task = asyncio.create_task(self._probe_loop())

    async def cleanup(self, app) -> None:
        if self._probe_task:
            self._probe_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._probe_task
        if self._session:
            await self._session.close()

    async def _probe_once(self) -> None:
        """Probe every not-up replica; revive the ones answering /health."""
        for r in self.replicas:
            if r.up:
                continue
            try:
                async with self._session.get(
                    f"{r.base}/health",
                    timeout=aiohttp.ClientTimeout(total=2.0),
                ) as resp:
                    if resp.status == 200:
                        r.mark_up()
            except Exception:
                r.down_until = max(
                    r.down_until, time.monotonic() + self.cooldown_s)

    async def _probe_loop(self) -> None:
        """Bring down/unverified replicas back as soon as /health answers."""
        while True:
            await asyncio.sleep(self.probe_interval_s)
            await self._probe_once()

    # -- dispatch ------------------------------------------------------------

    def pick_order(self) -> List[Replica]:
        """Live replicas, least-loaded first; cooled-down ones last (a
        request only reaches them when everything live already failed)."""
        live = sorted((r for r in self.replicas if r.up),
                      key=lambda r: r.inflight)
        down = sorted((r for r in self.replicas if not r.up),
                      key=lambda r: r.inflight)
        return live + down

    # -- HTTP proxy ----------------------------------------------------------

    @staticmethod
    def _fwd_headers(headers) -> dict:
        return {k: v for k, v in headers.items()
                if k.lower() not in HOP_HEADERS}

    async def proxy_http(self, request: web.Request) -> web.StreamResponse:
        body = await request.read()
        last_err: Optional[Exception] = None
        for r in self.pick_order():
            url = f"{r.base}{request.rel_url}"
            r.inflight += 1
            try:
                async with self._session.request(
                    request.method, url, data=body,
                    headers=self._fwd_headers(request.headers),
                    timeout=aiohttp.ClientTimeout(total=None, connect=5.0),
                ) as resp:
                    out = web.StreamResponse(
                        status=resp.status,
                        headers=self._fwd_headers(resp.headers),
                    )
                    await out.prepare(request)
                    async for chunk in resp.content.iter_chunked(1 << 15):
                        await out.write(chunk)
                    await out.write_eof()
                    r.served += 1
                    r.mark_up()
                    return out
            except (aiohttp.ClientConnectionError,
                    asyncio.TimeoutError) as e:
                # connection-level failure BEFORE any byte reached the
                # client → safe to fail over to the next replica
                r.mark_down(self.cooldown_s)
                last_err = e
            finally:
                r.inflight -= 1
        raise web.HTTPServiceUnavailable(
            text=json.dumps({"error": "no live replica",
                             "last": repr(last_err)}),
            content_type="application/json",
        )

    # -- WS proxy ------------------------------------------------------------

    async def proxy_ws(self, request: web.Request) -> web.WebSocketResponse:
        last_err: Optional[Exception] = None
        for r in self.pick_order():
            url = f"{r.base}{request.rel_url}"
            r.inflight += 1
            try:
                upstream = await self._session.ws_connect(
                    url, timeout=aiohttp.ClientWSTimeout(ws_close=10.0),
                )
            except (aiohttp.ClientError, asyncio.TimeoutError) as e:
                r.inflight -= 1
                r.mark_down(self.cooldown_s)
                last_err = e
                continue
            ws = web.WebSocketResponse()
            await ws.prepare(request)
            r.mark_up()               # WS accepted — replica is live
            try:
                await self._pump_ws(ws, upstream)
                r.served += 1
                return ws
            finally:
                r.inflight -= 1
                with contextlib.suppress(Exception):
                    await upstream.close()
        raise web.HTTPServiceUnavailable(
            text=json.dumps({"error": "no live replica",
                             "last": repr(last_err)}),
            content_type="application/json",
        )

    @staticmethod
    async def _pump_ws(client: web.WebSocketResponse,
                       upstream) -> None:
        """Bidirectional frame pump until either side closes."""

        async def c2u():
            async for msg in client:
                if msg.type == WSMsgType.TEXT:
                    await upstream.send_str(msg.data)
                elif msg.type == WSMsgType.BINARY:
                    await upstream.send_bytes(msg.data)
                elif msg.type in (WSMsgType.CLOSE, WSMsgType.ERROR):
                    break
            with contextlib.suppress(Exception):
                await upstream.close()

        async def u2c():
            async for msg in upstream:
                if msg.type == WSMsgType.TEXT:
                    await client.send_str(msg.data)
                elif msg.type == WSMsgType.BINARY:
                    await client.send_bytes(msg.data)
                elif msg.type in (WSMsgType.CLOSE, WSMsgType.ERROR):
                    break
            with contextlib.suppress(Exception):
                await client.close()

        await asyncio.gather(c2u(), u2c())

    # -- aggregate endpoints --------------------------------------------------

    async def health(self, request: web.Request) -> web.Response:
        ok = any(r.up for r in self.replicas)
        return web.json_response(
            {"status": "ok" if ok else "down",
             "replicas": [{"base": r.base, "up": r.up,
                           "inflight": r.inflight, "served": r.served,
                           "failures": r.failures}
                          for r in self.replicas]},
            status=200 if ok else 503,
        )

    async def metrics(self, request: web.Request) -> web.Response:
        per: List[dict] = []
        for r in self.replicas:
            entry: dict = {"base": r.base, "up": r.up,
                           "inflight": r.inflight, "served": r.served}
            if r.up:
                try:
                    async with self._session.get(
                        f"{r.base}/metrics",
                        timeout=aiohttp.ClientTimeout(total=5.0),
                    ) as resp:
                        entry["metrics"] = await resp.json()
                except Exception as e:
                    entry["metrics_error"] = repr(e)
            per.append(entry)
        agg = {"replicas_up": sum(r.up for r in self.replicas),
               "replicas_total": len(self.replicas),
               "inflight": sum(r.inflight for r in self.replicas)}
        for e in per:
            sch = (e.get("metrics") or {}).get("scheduler") or {}
            for k in ("slots", "active", "queued"):
                if k in sch:
                    agg[k] = agg.get(k, 0) + sch[k]
        return web.json_response({"aggregate": agg, "per_replica": per})


def make_app(router: Router) -> web.Application:
    app = web.Application()
    app.on_startup.append(router.startup)
    app.on_cleanup.append(router.cleanup)
    app.add_routes([
        web.get("/health", router.health),
        web.get("/metrics", router.metrics),
        web.get("/ws/tts", router.proxy_ws),
        web.get("/ws/audio", router.proxy_ws),
        web.get("/ws", router.proxy_ws),
        web.route("*", "/{tail:.*}", router.proxy_http),
    ])
    return app


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--replica", action="append", required=True,
                    help="replica base URL (repeatable)")
    ap.add_argument("--cooldown-s", type=float, default=5.0)
    ap.add_argument("--probe-interval-s", type=float, default=2.0)
    args = ap.parse_args(argv)
    router = Router(args.replica, args.cooldown_s, args.probe_interval_s)
    web.run_app(make_app(router), host=args.host, port=args.port,
                print=lambda *a: print(f"[router] listening "
                                       f"on :{args.port} -> "
                                       f"{args.replica}", flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
