"""Device→host transfers queued at launch time."""

from __future__ import annotations

import numpy as np
import torch


class HostCopy:
    """A device→host copy queued right after its producer.

    The port of JAX's ``copy_to_host_async``: a non-blocking copy into pinned
    memory on the current stream plus a CUDA event, so a later ``numpy()``
    waits for that copy only, not for whatever was launched after it. On the
    CPU it just holds the tensor.
    """

    def __init__(self, t: torch.Tensor):
        self.device_tensor = t
        self._event = None
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def copy_async(*tensors: torch.Tensor):
    """Queue device→host copies; returns one HostCopy per tensor."""
    return tuple(HostCopy(t) for t in tensors)


def to_numpy(x) -> np.ndarray:
    """HostCopy | tensor | array → numpy (waits for a queued copy)."""
    if isinstance(x, HostCopy):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
