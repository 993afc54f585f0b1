"""Load generator: drives /ws/tts from its own process, on its own clock.

Reads one job (JSON) on stdin: the server's port, the generated requests,
the window and the check's sample sizes. Prints `START <t0>` (t0 on
CLOCK_MONOTONIC, which the benchmark process shares) when the ramp
begins, then one JSON line: every request's record — due, sent, each binary
message's arrival and size, done or error, the done message's server
metrics — and the PCM of the requests the check compares.

Open loop: each request is sent at its due time whatever the server does.
Closed loop: each client sends its next request when the last one ends;
at the window's end the clients stop and close their streams.

Imports neither torch nor the port."""

from __future__ import annotations

import asyncio
import base64
import json
import sys
import time

import aiohttp

from ttsbench.sample import choose


def _request(r: dict) -> dict:
    body = {"text": r["text"], "voice": r["voice"],
            "max_tokens": r["max_tokens"], "audio_only": True,
            "force_speech": True, "benchmark": True}
    if r["greedy"]:
        body["temperature"] = 0.0
    return body


async def _one(session, url: str, r: dict, rec: dict, pcm: dict,
               deadline: float) -> None:
    rec.update(id=r["id"], greedy=r["greedy"], max_tokens=r["max_tokens"],
               chunks=[], done=None, error=None, server=None)
    buf = bytearray()
    pcm[r["id"]] = buf
    rec["sent"] = time.monotonic()
    try:
        async with session.ws_connect(url, max_msg_size=0) as ws:
            await ws.send_str(json.dumps(_request(r)))
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    rec["error"] = "no answer by the drain's end"
                    return
                msg = await ws.receive(timeout=left)
                now = time.monotonic()
                if msg.type == aiohttp.WSMsgType.BINARY:
                    rec["chunks"].append((now, len(msg.data)))
                    buf.extend(msg.data)
                elif msg.type == aiohttp.WSMsgType.TEXT:
                    data = json.loads(msg.data)
                    if data.get("done"):
                        rec["done"] = now
                        rec["server"] = data.get("server_metrics")
                        rec["bytes"] = data.get("bytes")
                    else:
                        rec["error"] = str(data.get("error", data))
                    return
                else:
                    rec["error"] = f"connection ended: {msg.type.name}"
                    return
    except asyncio.TimeoutError:
        rec["error"] = "no answer by the drain's end"
    except aiohttp.ClientError as e:
        rec["error"] = f"{type(e).__name__}: {e}"


async def _open(job, session, url, t0, records, pcm):
    end = t0 + job["ramp_s"] + job["seconds"]
    deadline = end + job["drain_s"]
    tasks = []
    for r in sorted(job["requests"], key=lambda r: r["due_s"]):
        due = t0 + r["due_s"]
        wait = due - time.monotonic()
        if wait > 0:
            await asyncio.sleep(wait)
        rec = {"due": due}
        records.append(rec)
        tasks.append(asyncio.create_task(
            _one(session, url, r, rec, pcm, deadline)))
    await asyncio.gather(*tasks)


async def _closed(job, session, url, t0, records, pcm):
    end = t0 + job["ramp_s"] + job["seconds"]

    async def client(start, reqs):
        await asyncio.sleep(max(0.0, t0 + start - time.monotonic()))
        for r in reqs:
            if time.monotonic() >= end:
                return
            rec = {"due": time.monotonic()}
            records.append(rec)
            await _one(session, url, r, rec, pcm, end + job["drain_s"])

    tasks = [asyncio.create_task(client(s, c))
             for s, c in zip(job["starts_s"], job["clients"])]
    await asyncio.sleep(max(0.0, end - time.monotonic()))
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    for rec in records:
        if rec.get("done") is None and rec.get("error") is None:
            rec["cut"] = True     # in flight at the window's end


async def main_async(job) -> dict:
    url = f"http://127.0.0.1:{job['port']}/ws/tts"
    records, pcm = [], {}
    conn = aiohttp.TCPConnector(limit=0)
    async with aiohttp.ClientSession(connector=conn) as session:
        t0 = time.monotonic() + 0.2
        print(f"START {t0!r}", flush=True)
        await asyncio.sleep(max(0.0, t0 - time.monotonic()))
        if job["loop"] == "open":
            await _open(job, session, url, t0, records, pcm)
        else:
            await _closed(job, session, url, t0, records, pcm)
    finished = [r for r in records if r.get("done") and not r.get("error")]
    chosen = choose(finished, job["seed"], job["check"]["greedy"],
                    job["check"]["sampled"])
    return {"t0": t0, "records": records,
            "pcm": {str(i): base64.b64encode(bytes(pcm[i])).decode()
                    for i in chosen}}


def main() -> int:
    job = json.loads(sys.stdin.read())
    out = asyncio.run(main_async(job))
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
