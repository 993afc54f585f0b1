"""Scheduler soak: sustained randomized churn with leak and drift gates.

Port of ``tts_inference_tpu/tools/soak.py``. It drives the continuous-
batching scheduler under randomized concurrent load — mixed request
lengths, mixed sampling configs and mid-stream cancels — and gates on:

- no error events,
- no slot leak: no live slot, no KV block held (paged) and the vocode queue
  drained at the end,
- every submission accounted for (a done or error event each),
- bounded host RSS growth and TTFA drift between the second and the last
  quartile of completions (the JAX tool's thresholds).

The report also counts what the run exercised: preemptions, resumes and
how many of them replayed a CUDA graph, and late captures.

Run (CPU, tiny, on a paged on-demand pool that preempts):

    python -m tts_inference_tpu_torch.tools.soak --tiny --device cpu \\
        --duration 20 --paged-kv --kv-int8 --kv-on-demand \\
        --kv-block-size 32 --kv-pool-tokens 512

and on the card at full geometry (seeded random weights) without
``--tiny --device cpu``. Options other than the soak's own go to the
runtime as ``cli serve`` reads them (``--paged-kv``, ``--kv-int8``,
``--kv-on-demand``, ``--kv-pool-tokens``, ``--kv-block-size``,
``--native-protocol``, ``--quantize``, ``--no-warmup``, ...).
"""

from __future__ import annotations

import argparse
import json
import random
import resource
import sys
import threading
import time
from typing import List

DRIFT_LIMIT = 0.5        # the JAX tool's TTFA drift limit
RSS_LIMIT_MB = 4096.0    # the JAX tool's host RSS growth limit


def _rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _wait_events(req, timeout: float) -> None:
    """Drain a request's events until done or error."""
    while req.events.get(timeout=timeout)[0] not in ("done", "error"):
        pass


def _settle(scheduler, timeout: float = 30.0) -> None:
    """Wait until the scheduler thread has released every slot: a done
    event can reach its consumer just before the release that follows."""
    deadline = time.perf_counter() + timeout
    while (scheduler.n_active or scheduler.n_queued
           or any(s is not None for s in scheduler.slots)) \
            and time.perf_counter() < deadline:
        time.sleep(0.01)


def run_soak(scheduler, *, duration_s: float = 20.0, warm_s: float = 5.0,
             target_streams: int = 4, max_tokens_range=(14, 70),
             cancel_rate: float = 0.1, seed: int = 0,
             drift_limit: float = DRIFT_LIMIT,
             rss_limit_mb: float = RSS_LIMIT_MB) -> dict:
    """Churn `scheduler` (started) for `duration_s` after a `warm_s` warm
    phase; returns the report (``ok``: every gate passed; ``hard_ok``: the
    gates that do not depend on timing or on the host's allocator — no
    error, no leak, queue drained, every submission accounted for)."""
    from tts_inference_tpu_torch import protocol as P
    from tts_inference_tpu_torch.config import SamplingConfig, StreamConfig
    from tts_inference_tpu_torch.engine.scheduler import TTSRequest

    rng = random.Random(seed)
    audio_range = (P.TOKEN_AUDIO_BASE, P.TOKEN_AUDIO_BASE + P.AUDIO_VOCAB)
    scfg = StreamConfig(frames_per_chunk=2, lookahead_frames=3,
                        left_context_frames=4)
    results: List[dict] = []
    errors: List[str] = []
    lock = threading.Lock()

    # warm phase: first-use captures and allocations land here, so that the
    # drift and RSS gates measure sustained load. target_streams concurrent
    # requests per round, short and long.
    if warm_s > 0:
        warm_dl = time.perf_counter() + warm_s
        round_i = 0
        while time.perf_counter() < warm_dl:
            mt = max_tokens_range[round_i % 2]
            batch = [TTSRequest(
                text=f"warm {round_i}-{j}", sampling=SamplingConfig(
                    max_tokens=mt, seed=j, token_range=audio_range),
                stream_cfg=scfg, force_speech=True)
                for j in range(target_streams)]
            for r in batch:
                scheduler.submit(r)
            for r in batch:
                _wait_events(r, timeout=150)
            round_i += 1
        scheduler.drain_vocoder(timeout=60)

    core = scheduler.core
    rss0 = _rss_mb()
    pre0 = scheduler.preemptions
    res0 = (core.launches["resume"], core.replays["resume"],
            core.late_captures)

    def consume(req, cancelled):
        t0 = time.perf_counter()
        ttfa = None
        try:
            while True:
                kind, payload = req.events.get(timeout=120)
                if kind == "chunk" and ttfa is None:
                    ttfa = (time.perf_counter() - t0) * 1e3
                elif kind == "done":
                    with lock:
                        results.append({"ttfa_ms": ttfa,
                                        "tokens": payload.tokens,
                                        "cancelled": cancelled})
                    return
                elif kind == "error":
                    with lock:
                        errors.append(str(payload))
                    return
        except Exception as e:  # noqa: BLE001 — counted as an error
            with lock:
                errors.append(f"consumer timeout/crash: {e}")

    deadline = time.perf_counter() + duration_s
    threads: List[threading.Thread] = []
    submitted = 0
    while time.perf_counter() < deadline:
        if sum(t.is_alive() for t in threads) >= target_streams:
            time.sleep(0.005)
            continue
        mt = rng.randint(*max_tokens_range)
        greedy = rng.random() < 0.2
        req = TTSRequest(
            text=f"soak {submitted}",
            sampling=SamplingConfig(
                max_tokens=mt, seed=submitted, greedy=greedy,
                repetition_penalty=1.0 if greedy else 1.1,
                token_range=audio_range,
                frame_protocol=rng.random() < 0.3),
            stream_cfg=scfg, force_speech=True, noise_seed=submitted)
        cancel = rng.random() < cancel_rate
        scheduler.submit(req)
        if cancel:
            delay = rng.uniform(0.01, 0.3)

            def canceller(r=req, d=delay):
                time.sleep(d)
                r.cancel()
            threading.Thread(target=canceller, daemon=True).start()
        t = threading.Thread(target=consume, args=(req, cancel), daemon=True)
        t.start()
        threads.append(t)
        submitted += 1
    for t in threads:
        t.join(timeout=180)
    scheduler.drain_vocoder(timeout=60)
    _settle(scheduler)

    rss1 = _rss_mb()
    done = [r for r in results if not r["cancelled"] and r["ttfa_ms"]]
    # drift: the second quartile of completions against the last (the
    # first is biased fast: the system starts empty)
    q = max(1, len(done) // 4)
    ref_q = [r["ttfa_ms"] for r in done[q: 2 * q]]
    last_q = [r["ttfa_ms"] for r in done[-q:]]
    drift = ((sum(last_q) / len(last_q)) / (sum(ref_q) / len(ref_q)) - 1.0
             if ref_q and last_q else 0.0)
    held = sum(s is not None for s in scheduler.slots)
    pool = None
    if core.engine_cfg.paged_kv:
        pool = (core.cache.num_blocks - 1) * core.engine_cfg.kv_block_size
    free = core.free_tokens()
    report = {
        "submitted": submitted,
        "completed": len(results),
        "errors": len(errors),
        "error_samples": errors[:3],
        "slots_active_at_end": scheduler.n_active,
        "slots_held_at_end": held,
        "kv_tokens_held_at_end": (pool - free) if pool is not None else 0,
        "vocode_pending_at_end": scheduler._vocode_pending,
        "rss_growth_mb": round(rss1 - rss0, 1),
        "rss_limit_mb": rss_limit_mb,
        "ttfa_drift": round(drift, 3),
        "drift_limit": drift_limit,
        "preemptions": scheduler.preemptions - pre0,
        "resumes": core.launches["resume"] - res0[0],
        "resume_replays": core.replays["resume"] - res0[1],
        "late_captures": core.late_captures - res0[2],
    }
    report["hard_ok"] = (not errors and scheduler.n_active == 0 and held == 0
                         and report["kv_tokens_held_at_end"] == 0
                         and scheduler._vocode_pending == 0
                         and len(results) == submitted)
    # one-sided: getting faster over the run is not a failure
    report["ok"] = (report["hard_ok"] and drift <= drift_limit
                    and (rss1 - rss0) <= rss_limit_mb)
    return report


def main(argv=None) -> int:
    from tts_inference_tpu_torch import cli

    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        epilog="other options: the runtime's, as `cli serve` reads them")
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--cancel-rate", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0,
                    help="the churn's random seed (the weights' is 0)")
    args, rest = ap.parse_known_args(argv)
    serve = cli.build_parser().parse_args(["serve", *rest])
    _, sched = cli.build_serving(serve)
    sched.start()
    try:
        report = run_soak(sched, duration_s=args.duration,
                          target_streams=args.streams,
                          cancel_rate=args.cancel_rate, seed=args.seed)
    finally:
        sched.stop()
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
