"""What the engine's and the vocoder's CUDA graphs share: the process-wide
capture lock and the captured-launch record; and the measurement tools'
chained timer, which captures a chain of calls into a graph of its own."""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

import torch

# one capture at a time in the process (a rule of torch.cuda.graph): the
# runtime's two cores and the vocoder could otherwise capture late from
# different threads
CAPTURE_LOCK = threading.Lock()


class Graph:
    """A captured launch: the CUDA graph, its output tensors (every replay
    overwrites them) and the kernel launches one replay stands for."""

    def __init__(self, graph, outputs, launches: dict):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches

    def replay(self):
        self.graph.replay()
        for counter, n in self.launches.items():
            counter.add(n)
        return self.outputs


def replay_ms(run: Callable[[], Any], iters: int, device) -> float:
    """Milliseconds of the best of `iters` calls of `run`: between two CUDA
    events on a CUDA device (the device's time for what `run` enqueues,
    graph replays for the measurement tools), under the host clock on the
    CPU (a time of the CPU, not of a device)."""
    on_card = torch.device(device).type == "cuda"
    best = float("inf")
    for _ in range(iters):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize(device)
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            run()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def chained_ms(step: Callable[[Any], Any], carry, reps: int, iters: int,
               device) -> float:
    """Milliseconds per call of `step` in a chain of `reps` calls, each fed
    the one before's output (``carry = step(carry)``, as the JAX tools chain
    them in a ``lax.scan``); the best of `iters` runs of the chain
    (``replay_ms``).

    On a CUDA device the chain is captured once into a CUDA graph, after
    one eager call that does what a capture must not (the kernel build,
    library handles, the kernels' workspaces; its launches are not
    counted), and each run replays the graph: a device time, with no host
    enqueue in it. Every replay adds the chain's kernel launches to their
    counters. On the CPU the chain runs eagerly."""
    from tts_inference_tpu_torch.ops import _build

    def chain():
        c = carry
        for _ in range(reps):
            c = step(c)
        return c

    if torch.device(device).type != "cuda":
        return replay_ms(chain, iters, device) / reps
    with CAPTURE_LOCK:
        with _build.record_launches():
            step(carry)
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread of the process may keep launching
        with _build.record_launches() as launches, torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            outputs = chain()
    return replay_ms(Graph(graph, outputs, launches).replay, iters,
                     device) / reps
