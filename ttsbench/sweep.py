"""The knee sweep of an open-loop cell: one set-up, then a geometric
ladder of rates, each a ramp and a window of the cell's traffic at that
rate; prints one JSON line per rate (TTFA and gap tails, failures) and
stops once the tails are far past the limits. The knee is the highest
rate with `ttfa_p95_ms` ≤ 500 and `gap_p95_ms` ≤ 427 (one 5-frame chunk
of audio) and no failure.

    python3 -m ttsbench.sweep --workload <cell> --seed <n> --seconds <s> \
        --rates 1,1.5,2,...
"""

from __future__ import annotations

import argparse
import json
import sys

from ttsbench import run

TTFA_LIMIT_MS, GAP_LIMIT_MS = 500.0, 427.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    run.cache_dirs()
    import torch

    from ttsbench import families, serve, stats, traffic, weights

    cell, model, mix, _, _ = run.load_cell(args.workload)
    dev = torch.device("cuda")
    params = families.of(model).make_weights(model, args.seed, dev)
    system = serve.build(model, mix, params,
                         weights.make_snac(args.seed ^ 0x5AC, dev), dev,
                         args.seed)
    system.start()
    over = 0
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        m = dict(mix, rate_per_s=rate)
        gen = traffic.generate(m, args.seed + i, args.seconds)
        job = dict(gen, port=system.port, drain_s=m["drain_s"],
                   seed=args.seed, check={"greedy": 0, "sampled": 0})
        lg = run.LoadGen(job)
        out = lg.result(timeout=args.seconds + m["ramp_s"] + m["drain_s"]
                        + 120)
        att, failed = stats.counts(out, job)
        row = {"rate_per_s": rate, "attempted": att, "failed": failed,
               "ttfa_p50_ms": stats.pct(stats.ttfa_ms(out, job), 50),
               "ttfa_p95_ms": stats.pct(stats.ttfa_ms(out, job), 95),
               "gap_p50_ms": stats.pct(stats.gaps_ms(out, job), 50),
               "gap_p95_ms": stats.pct(stats.gaps_ms(out, job), 95),
               "audio_s_per_s": stats.audio_s_per_s(out, job)}
        print(json.dumps(row), flush=True)
        # past the knee by far: the queue grows through the window
        if failed or (row["ttfa_p95_ms"] or 1e9) > 6 * TTFA_LIMIT_MS:
            over += 1
            if over >= 2:
                break
    system.stop()
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:   # noqa: BLE001
        import traceback

        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    run.os._exit(code)
