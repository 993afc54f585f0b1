"""Measure the lockstep mirroring cost in the dispatch path.

Port of ``tts_inference_tpu/tools/lockstep_overhead.py``. ``MirroredCore``
pickles every device-entering EngineCore call to the followers (handle
table encode + pickle + TCP sendall) under its lock, before the local
launch (``parallel/lockstep.py``). Two measurements:

1. **Serialization cost, alone**: one real decode-launch descriptor, and
   the time of exactly what ``mirrored()`` adds — ``_encode`` +
   ``pickle.dumps`` + ``_send`` over a loopback socketpair drained by a
   thread. This is the time under the lock.
2. **End to end, interleaved A/B**: the same launch-and-fetch decode loop
   through a plain EngineCore and a MirroredCore, taken in turns (plain,
   mirrored, plain, …) so that drift cancels; the per-pair differences are
   summarized by their median.

The follower is a drained socketpair: exactly the bytes a follower gets,
with no second process (the replay is what the lockstep tests check).

Usage:
    python -m tts_inference_tpu_torch.tools.lockstep_overhead   # the card
    python -m tts_inference_tpu_torch.tools.lockstep_overhead --tiny \\
        --device cpu
"""

from __future__ import annotations

import argparse
import json
import pickle
import socket
import statistics
import sys
import threading
import time

import numpy as np


def _drained_pair():
    """A socket whose peer a thread reads and drops; (socket, stop)."""
    a, b = socket.socketpair()

    def drain():
        try:
            while b.recv(1 << 20):
                pass
        except OSError:
            pass

    th = threading.Thread(target=drain, daemon=True)
    th.start()

    def stop():
        a.close()
        b.close()
        th.join(timeout=5)

    return a, stop


def _timed_call(core, sp, tok, act):
    """One decode launch and the fetch of its tokens (the scheduler fetches
    every launch's tokens before it acts on them)."""
    from tts_inference_tpu_torch.utils import to_numpy

    t0 = time.perf_counter()
    out = core.decode_steps_launch(sp, tok, act)
    to_numpy(out[0])
    return time.perf_counter() - t0, out[1], out[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--iters", type=int, default=200,
                    help="A/B pairs for the end-to-end leg")
    ap.add_argument("--followers", type=int, default=1)
    ap.add_argument("--quantize", action="store_true", default=None,
                    help="int8 weights (default: on at full width)")
    args = ap.parse_args(argv)

    import torch

    from tts_inference_tpu_torch import protocol, weights
    from tts_inference_tpu_torch.config import (Config, SamplingConfig,
                                                tiny_config)
    from tts_inference_tpu_torch.engine.engine import EngineCore
    from tts_inference_tpu_torch.models.quant import quantize_llama_params
    from tts_inference_tpu_torch.ops import sampling as S
    from tts_inference_tpu_torch.parallel import lockstep as LS
    from tts_inference_tpu_torch.runtime import default_device

    dev = torch.device(args.device) if args.device else default_device()
    cfg = tiny_config() if args.tiny else Config()
    quantize = (not args.tiny) if args.quantize is None else args.quantize
    params = weights.init_llama_params(cfg.model, 0, dev)
    if quantize:
        params = quantize_llama_params(params, bits=8, free_source=True)
    core = EngineCore(params, cfg.model, cfg.engine,
                      eos_id=protocol.TOKEN_EOS, seed=0)
    sp = S.SamplingParams.from_config(
        SamplingConfig(greedy=True,
                       token_range=(protocol.TOKEN_AUDIO_BASE,
                                    protocol.TOKEN_AUDIO_BASE
                                    + protocol.AUDIO_VOCAB)),
        core.batch, device=dev)
    prompts = [[protocol.TOKEN_SOS, 5, 6, 7]] * core.batch
    with torch.no_grad():
        toks0, tok, act = core.prefill_decode_launch(
            prompts, list(range(core.batch)), sp,
            np.zeros(core.batch, np.int32), np.zeros(core.batch, bool), n=2)
    toks0.cpu()

    socks, stops = [], []
    for _ in range(args.followers):
        s, stop = _drained_pair()
        socks.append(s)
        stops.append(stop)
    mirrored = LS.MirroredCore(core, socks)
    mirrored._table.register_outputs((tok, act))

    # leg 1: what mirrored() adds under its lock, alone
    table = mirrored._table
    wire_us = []
    for _ in range(max(200, args.iters)):
        t0 = time.perf_counter()
        desc = pickle.dumps(("decode_steps_launch",
                             LS._encode(table, (sp, tok, act)),
                             LS._encode(table, {})),
                            protocol=pickle.HIGHEST_PROTOCOL)
        for s in socks:
            LS._send(s, desc)
        wire_us.append((time.perf_counter() - t0) * 1e6)

    # leg 2: end to end, interleaved
    with torch.no_grad():
        for _ in range(8):   # both paths warm (graphs captured on a card)
            _, tok, act = _timed_call(core, sp, tok, act)
            _, tok, act = _timed_call(mirrored, sp, tok, act)
        deltas_us, plain_ms = [], []
        for _ in range(args.iters):
            a, tok, act = _timed_call(core, sp, tok, act)
            b, tok, act = _timed_call(mirrored, sp, tok, act)
            plain_ms.append(a * 1e3)
            deltas_us.append((b - a) * 1e6)

    mirrored.close()
    for stop in stops:
        stop()

    med_plain = statistics.median(plain_ms)
    med_delta = statistics.median(deltas_us)
    print(json.dumps({
        "config": "tiny" if args.tiny else "full",
        "device": str(dev),
        "batch": core.batch,
        "followers": args.followers,
        "iters": args.iters,
        "desc_bytes": len(desc),
        # encode + pickle + sendall: what holds the mirror's lock
        "mirror_cost_us_per_call": round(statistics.median(wire_us), 1),
        "mirror_cost_us_p95": round(
            statistics.quantiles(wire_us, n=20)[18], 1),
        # launch + fetch through MirroredCore minus plain, in turns
        "e2e_plain_ms_per_launch": round(med_plain, 3),
        "e2e_delta_us_median": round(med_delta, 1),
        "e2e_overhead_pct": round(med_delta / 10.0 / med_plain, 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
