"""Process-group set-up for sharded serving: one process per device.

Port of ``tts_inference_tpu/parallel/multihost.py``. The JAX package forms
a ``jax.distributed`` cluster and lays one global mesh over every process's
devices; here every device is a process of its own, so even one host's
mesh is several processes, and ``init_multihost`` forms their default
``torch.distributed`` group over TCP (no cluster manager: the coordinator's
address, the world size and this process's rank are given). The backend is
NCCL when the process's device is a card and gloo on the CPU; ``backend=``
overrides it, which the one-card check uses to run two ranks on one card
(NCCL refuses two ranks on one device, gloo does not).

``make_global_mesh`` lays the (dp, tp) mesh over all processes with tp
inner, so that a tp group is tp consecutive ranks and never leaves a host:
tensor-parallel collectives stay on the host's NVLink, and only the dp axis
(the token rows of each launch) crosses hosts.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

from tts_inference_tpu_torch.config import MeshConfig


def local_rank(process_id: int) -> int:
    """This process's index among its host's processes: ``LOCAL_RANK`` when
    set, else process_id modulo the host's card count (a host runs one
    process per card, with consecutive ids)."""
    env = os.environ.get("LOCAL_RANK")
    if env is not None:
        return int(env)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return int(process_id) % max(n, 1)


def process_device(process_id: int, device=None) -> torch.device:
    """The device a process serves from: `device` when given ("cpu", or
    "cuda" for ``cuda:{local_rank}``), else ``cuda:{local_rank}``."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank(process_id))
    return dev


def init_multihost(coordinator: str, num_processes: int, process_id: int, *,
                   device=None, backend: Optional[str] = None,
                   timeout_s: int = 120) -> torch.device:
    """Join (or form) the default process group at ``tcp://coordinator``
    (HOST:PORT, served by process 0). Returns this process's device, which
    becomes the current CUDA device on a card. `backend`: "nccl" or
    "gloo", default NCCL on a card and gloo on the CPU."""
    import torch.distributed as dist

    dev = process_device(process_id, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=int(timeout_s)), **kw)
    return dev


def make_global_mesh(tp: Optional[int] = None, device=None):
    """The (dp, tp) mesh over every process of the default group, tp inside
    a host: tp may not exceed the host's device count (the host's cards
    under NCCL; under gloo every process is a device of the one host).
    Default tp: the host's device count."""
    import torch.distributed as dist

    from tts_inference_tpu_torch.parallel import mesh as M

    world = dist.get_world_size()
    nccl = str(dist.get_backend()) == "nccl"
    n_local = torch.cuda.device_count() if nccl else world
    tp = int(tp) if tp else n_local
    if tp > n_local:
        raise ValueError(
            f"tp={tp} exceeds local device count {n_local}: a tp group "
            "would span hosts and its collectives would leave NVLink")
    if n_local % tp:
        raise ValueError(f"tp={tp} does not divide local count {n_local}")
    if world % tp:
        raise ValueError(f"tp={tp} does not divide global {world}")
    return M.make_mesh(MeshConfig(dp=world // tp, tp=tp), device=device)


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0
