"""Run one cell of the benchmark once and print its result line.

    python3 -m ttsbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (`BENCHMARK.json`) names a configuration (`configs/<name>.json`)
and a traffic mix (`traffic/<name>.json`). The run makes the weights on
the card from the seed, builds the port's runtime and scheduler, warms up
the cell's shapes, serves `/ws/tts` with the port's server in this process
and drives it from a load-generator process over a ramp and the window.
Then the reference judges a sample of the finished requests, and the last
line of standard output is the result. With `--trace 1` the host's times
are read over the window's first half and three stretches of 2 s in its
second half are profiled, and the cell's per-layer metrics are reported.
"""

from __future__ import annotations

import time

T_START = time.monotonic()     # set-up counts from here

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "tts_inference_tpu"}
# A traced run: the window's first half is left untraced, and the host-side
# per-layer metrics (the tick profile, the requests' first chunks) are read
# over it alone; the traced stretches, their number and length below, are
# spread over the second half (a stretch's stop holds the launches for
# some seconds while CUPTI flushes, which would show in the host's times)
TRACE_STRETCHES = 3
TRACE_S = 2.0


def cache_dirs() -> None:
    """Kernel and build caches at fixed paths inside the checkout (the
    port's own nvcc build is `build/tts_kernels`)."""
    for var, sub in (("TRITON_CACHE_DIR", "build/triton"),
                     ("TORCH_EXTENSIONS_DIR", "build/torch_extensions")):
        os.environ.setdefault(var, str(ROOT / sub))
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def load_cell(name: str) -> tuple:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    model = json.loads(
        (HERE / "configs" / f"{cell['config']}.json").read_text())
    mix = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    ends = {m["name"] for m in bench["end_to_end"]
            if name in m.get("workloads", [name])}
    layers = [m["name"] for m in bench["per_layer"]
              if name in m.get("workloads", [name])
              and m["moves"] in ends]
    return cell, model, mix, ends, layers


def reader(metric: str) -> Callable:
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"ttsbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class LoadGen:
    """The load-generator process and a thread reading its output."""

    def __init__(self, job: Dict):
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ttsbench.loadgen"], cwd=ROOT, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.t0: Optional[float] = None
        self.started = threading.Event()
        self.lines: list = []
        self.proc.stdin.write(json.dumps(job))
        self.proc.stdin.close()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            if line.startswith("START ") and self.t0 is None:
                self.t0 = float(line.split()[1])
                self.started.set()
            else:
                self.lines.append(line)
        self.started.set()

    def result(self, timeout: float) -> Dict:
        self.proc.wait(timeout=timeout)
        self.reader.join(timeout=30)
        if self.proc.returncode != 0 or not self.lines:
            raise RuntimeError(f"load generator exited "
                               f"{self.proc.returncode}")
        return json.loads(self.lines[-1])


def note(msg: str) -> None:
    """A progress line on standard error, seconds since the start."""
    print(f"[ttsbench {time.monotonic() - T_START:8.2f}s] {msg}",
          file=sys.stderr, flush=True)


def _sleep_until(t: float) -> None:
    time.sleep(max(0.0, t - time.monotonic()))


def run_cell(model: Dict, mix: Dict, seed: int, seconds: float,
             trace: bool, device: str, layer_metrics=(),
             control: Optional[Dict] = None, fault: Callable = None) -> Dict:
    """One run of a cell: the result's fields, with `checks` (each number
    compared and its limit) and `metrics` (end to end, or per layer when
    traced). `control` switches a precision below the configuration's (the
    port's int8 weights, or the reference vocoder in TF32 in the port's
    place); `fault(system)` breaks the timed path. Both are for the tests
    of the check, never a benchmark run."""
    import torch

    from ttsbench import check, families, serve, stats, traffic, weights
    from ttsbench.tracing import Trace

    dev = torch.device(device)
    family = families.of(model)
    note("weights")
    params = family.make_weights(model, seed, dev)
    snac = weights.make_snac(seed ^ 0x5AC, dev)
    system = serve.build(model, mix, params, snac, dev, seed, control,
                         log_launches=trace)
    tr = Trace() if trace else None
    if trace:
        tr.warm()
    note("built and warmed up")
    if fault is not None:
        fault(system)
    sched = system.scheduler
    system.start()
    gen = traffic.generate(mix, seed, seconds)
    job = dict(gen, port=system.port, drain_s=mix["drain_s"], seed=seed,
               check=mix["check"])
    requests = {r["id"]: r for r in (
        gen["requests"] if gen["loop"] == "open"
        else [r for c in gen["clients"] for r in c])}
    lg = LoadGen(job)
    try:
        if not lg.started.wait(120) or lg.t0 is None:
            raise RuntimeError("the load generator did not start")
        setup_s = lg.t0 - T_START
        note(f"ramp starts; set-up {setup_s:.2f}s")
        w0 = lg.t0 + mix["ramp_s"]
        w1 = w0 + seconds
        tick = None
        if trace:
            _sleep_until(w0)
            sched.enable_tick_profile()
            quiet = w0 + seconds / 2
            for k in range(TRACE_STRETCHES):
                _sleep_until(quiet + k * seconds / 2 / TRACE_STRETCHES)
                if k == 0:
                    tick = sched.tick_profile
                system.log.on = True
                with system.log.lock:
                    tr.start()
                note("trace on")
                time.sleep(TRACE_S)
                faulthandler.dump_traceback_later(120)
                with system.log.lock:
                    tr.stop()
                faulthandler.cancel_dump_traceback_later()
                system.log.on = False
                note("trace off")
            _sleep_until(w1)
        out = lg.result(timeout=seconds + mix["ramp_s"] + mix["drain_s"]
                        + 120)
    finally:
        if lg.proc.poll() is None:
            lg.proc.kill()
            lg.proc.wait()
    note("load generator done")
    late = sched.core.late_captures + system.runtime.vocoder.late_captures
    peak = (torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else 0)
    run = {"model": model, "out": out, "job": job, "tick": tick,
           "log": system.log, "trace": None,
           "quiet_until": (lg.t0 + mix["ramp_s"] + seconds / 2
                           if trace else None)}
    if trace:
        system.log.finish()
        faulthandler.dump_traceback_later(120)
        run["trace"] = tr.reduce()
        faulthandler.cancel_dump_traceback_later()
        note(f"trace reduced: {len(run['trace']['ops'])} device operations")
    served = system.served
    system.stop()
    system = sched = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    note("reference check")
    nums = check.compare(model, params, snac, requests, served, out,
                         vocoder_control=bool(control and control.get(
                             "tf32_vocoder")))
    verdict = check.judge(nums, model["check"])
    note("checked")
    attempted, failed = stats.counts(out, job)
    if trace:
        metrics = {}
        for name in layer_metrics:
            v = reader(name)(run)
            if v is not None and math.isfinite(v):
                metrics[name] = v
    else:
        metrics = {"setup_s": setup_s}
        if job["loop"] == "open":
            metrics["ttfa_p95_ms"] = stats.pct(stats.ttfa_ms(out, job), 95)
            metrics["gap_p95_ms"] = stats.pct(stats.gaps_ms(out, job), 95)
        else:
            metrics["audio_s_per_s"] = stats.audio_s_per_s(out, job)
    lateness = [(r["sent"] - r["due"]) * 1e3 for r in out["records"]]
    res = {"correct": verdict["correct"], "attempted": attempted,
           "failed": failed, "metrics": metrics, "memory_peak_bytes": peak,
           "late_captures": late, "checks": verdict["lines"],
           "lateness_ms": max(lateness, default=0.0)
           if gen["loop"] == "open" else 0.0}
    if trace:
        from ttsbench import tracing

        red = run["trace"]
        res["busy_s"] = tracing.busy_s(red)
        res["window_s"] = tracing.window_s(red)
        res["breakdown"] = tracing.breakdown(red)
        res["trace_linked_ops"] = (red["linked"], len(red["ops"]))
        res["tick_profile"] = tick
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="serve and judge the check's controls in place of "
                         "the configuration's precisions: the port's int8 "
                         "weights and the reference vocoder in TF32 (for "
                         "the limits; never in a benchmark run)")
    args = ap.parse_args(argv)
    cache_dirs()
    cell, model, mix, ends, layers = load_cell(args.workload)
    from ttsbench import families

    families.of(model)      # a block no family serves: refused here
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    control = ({"quantize": True, "tf32_vocoder": True} if args.control
               else None)
    res = run_cell(model, mix, args.seed, args.seconds, bool(args.trace),
                   "cuda", layers, control)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules outside the port: {bad}", file=sys.stderr)
        return 3
    unread = [m for m in layers if m not in res["metrics"]]
    if args.trace and unread:
        # a metric BENCHMARK.json lists for this cell read nothing: its
        # reader no longer finds what it reads (a span, a kernel's name)
        print(f"per-layer metrics that read nothing: {unread}",
              file=sys.stderr)
        return 4
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    unit = {m["name"]: m["unit"]
            for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {k: {"value": v, "unit": unit[k]}
               for k, v in res["metrics"].items()
               if args.trace or k in ends}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["window_s"]
        line["breakdown"] = res["breakdown"]
    diag = {"late_captures": res["late_captures"],
            "lateness_ms": res["lateness_ms"]}
    if args.trace:
        diag["trace_linked_ops"] = res["trace_linked_ops"]
        diag["tick_profile"] = res["tick_profile"]
    print(f"diagnostics {json.dumps(diag)}", file=sys.stderr)
    checks = {k: {"value": _num(v["value"]), "limit": v["limit"]}
              for k, v in res["checks"].items()}
    line["checks"] = checks
    for k, v in checks.items():
        at = "limit >=" if k == "requests_compared" else "limit"
        print(f"check {k} {v['value']} {at} {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def _num(v):
    return None if isinstance(v, float) and not math.isfinite(v) else v


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:    # noqa: BLE001 — no result line, a nonzero exit
        import traceback

        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # the server's and the scheduler's threads are stopped; leave without
    # waiting on the interpreter's shutdown of idle pools
    os._exit(code)
