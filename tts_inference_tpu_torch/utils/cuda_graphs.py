"""What the engine's and the vocoder's CUDA graphs share: the process-wide
capture lock and the captured-launch record."""

from __future__ import annotations

import threading

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
