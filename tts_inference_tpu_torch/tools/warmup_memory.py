"""Device memory of a booted server, by what holds it.

Boots ``cli serve``'s runtime and scheduler from the given flags, warmups
included, and prints one JSON line: the allocated and reserved bytes after
the boot and their peaks, the scheduler core's KV cache, and for each
engine core (the scheduler's and the single-stream engine's) what its
eager pass before the first capture and each graph capture added to the
reserved bytes, the resume tier's captures apart. An out-of-memory error
is reported in the line (``"oom"``) with the capture it struck.

Run on the card, one boot per process (random weights from ``--seed``):

    python tts_inference_tpu_torch/tools/warmup_memory.py --paged-kv \\
        --kv-int8 --kv-on-demand --kv-block-size 128 --max-batch-size 32

Options other than ``--port-root`` are ``cli serve``'s. ``--port-root DIR``
imports the port from another checkout, to set two trees side by side in
one call; run the file as a script for that, not with ``-m``.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

GB = 1e9


def _cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size()
               for ts in (cache.k, cache.v, cache.k_scale, cache.v_scale)
               for t in ts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        epilog="other options: cli serve's")
    ap.add_argument("--port-root", default=None, metavar="DIR",
                    help="import the port from DIR (default: this checkout)")
    args, rest = ap.parse_known_args(argv)
    root = Path(args.port_root or Path(__file__).resolve().parents[2])
    sys.path.insert(0, str(root.resolve()))

    import torch

    if not torch.cuda.is_available():
        print("warmup_memory: no CUDA device", file=sys.stderr)
        return 2
    from tts_inference_tpu_torch import cli
    from tts_inference_tpu_torch.engine import engine as E

    events = []

    def mem():
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()

    def record(core, what, before):
        after = mem()
        events.append({"core": "scheduler" if core.batch > 1
                       else "single_stream", "what": what,
                       "allocated_gb": (after[0] - before[0]) / GB,
                       "reserved_gb": (after[1] - before[1]) / GB})

    prepare, capture = E.EngineCore._prepare, E.EngineCore._capture
    pending = []    # the capture under way, for an out-of-memory report

    def _prepare(self):
        if threading.get_ident() in self._prepared:
            return prepare(self)
        before = mem()
        out = prepare(self)
        record(self, "eager_pass", before)
        return out

    def _capture(self, key):
        self._prepare()         # its own event, before the capture's
        before = mem()
        pending[:] = [E._census_name(key)]
        g = capture(self, key)
        record(self, E._census_name(key), before)
        pending.clear()
        return g

    E.EngineCore._prepare, E.EngineCore._capture = _prepare, _capture
    serve = cli.build_parser().parse_args(["serve", *rest])
    t0 = time.perf_counter()
    out = {"tree": str(root), "argv": rest}
    try:
        rt, sched = cli.build_serving(serve)
    except torch.cuda.OutOfMemoryError as e:
        out.update(oom=True, at=pending[:1], error=str(e).split("\n")[0],
                   allocated_gb=torch.cuda.memory_allocated() / GB,
                   reserved_gb=torch.cuda.memory_reserved() / GB,
                   max_reserved_gb=torch.cuda.max_memory_reserved() / GB,
                   captures=len(events))
        print(json.dumps(out), flush=True)
        return 1
    alloc, res = mem()
    core = sched.core
    out.update(
        oom=False, boot_s=time.perf_counter() - t0, slots=core.batch,
        max_seq=core.max_seq, cache=type(core.cache).__name__,
        free_kv_tokens=core.free_tokens(),
        kv_cache_gb=_cache_bytes(core.cache) / GB,
        allocated_gb=alloc / GB, reserved_gb=res / GB,
        max_allocated_gb=torch.cuda.max_memory_allocated() / GB,
        max_reserved_gb=torch.cuda.max_memory_reserved() / GB)
    for tag in ("scheduler", "single_stream"):
        ev = [e for e in events if e["core"] == tag]
        caps = [e for e in ev if e["what"] != "eager_pass"]
        out[tag] = {
            "eager_pass_reserved_gb": sum(e["reserved_gb"] for e in ev
                                          if e["what"] == "eager_pass"),
            "captures": len(caps),
            "captures_reserved_gb": sum(e["reserved_gb"] for e in caps),
            "resume_tier_reserved_gb": {
                e["what"]: e["reserved_gb"] for e in caps
                if e["what"].startswith("capture_prefill_resume_")},
            "largest": sorted(({"what": e["what"],
                                "reserved_gb": e["reserved_gb"]}
                               for e in caps),
                              key=lambda e: -e["reserved_gb"])[:4]}
    print(json.dumps(out), flush=True)
    del rt, sched
    return 0


if __name__ == "__main__":
    sys.exit(main())
