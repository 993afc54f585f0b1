"""A stand-in for one `cli serve` process, for the launcher's policy tests
(tests/test_torch_deploy.py): answers GET /health (with its pid) and
/metrics, POST /generate (its pid and port), and can be told to stop
answering /health (POST /sick) or to exit (POST /exit?rc=N). Without
--port it listens nowhere and sleeps (a lockstep follower). SIGTERM exits
0. Unknown flags (the serve flags that pass through) are ignored;
--exit-after S exits 3 after S seconds."""

import argparse
import json
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

state = {"sick": False}


class Handler(BaseHTTPRequestHandler):
    def _json(self, status, body):
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        path = urlparse(self.path).path
        if path == "/health":
            if state["sick"]:
                self._json(503, {"status": "sick"})
            else:
                self._json(200, {"status": "ok", "pid": os.getpid()})
        elif path == "/metrics":
            self._json(200, {"pid": os.getpid(), "scheduler": {
                "slots": 1, "active": 0, "queued": 0}})
        else:
            self._json(404, {})

    def do_POST(self):
        url = urlparse(self.path)
        n = int(self.headers.get("Content-Length") or 0)
        self.rfile.read(n)
        if url.path == "/generate":
            self._json(200, {"pid": os.getpid(),
                             "port": self.server.server_port})
        elif url.path == "/sick":
            state["sick"] = True
            self._json(200, {})
        elif url.path == "/exit":
            rc = int(parse_qs(url.query).get("rc", ["1"])[0])
            self._json(200, {})
            threading.Timer(0.05, os._exit, (rc,)).start()
        else:
            self._json(404, {})

    def log_message(self, *a):
        pass


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--exit-after", type=float, default=None)
    args, _ = ap.parse_known_args()
    signal.signal(signal.SIGTERM, lambda *a: os._exit(0))
    if args.exit_after is not None:
        threading.Timer(args.exit_after, os._exit, (3,)).start()
    print(json.dumps({"stub": os.getpid(), "port": args.port}), flush=True)
    if args.port is None:
        while True:
            time.sleep(3600)
    ThreadingHTTPServer((args.host, args.port), Handler).serve_forever()


if __name__ == "__main__":
    sys.exit(main())
