"""The collectives of sharded serving, called by the model and the engine.

The JAX package has no counterpart: XLA inserts its collectives from the
shardings. Here the forward pass sums the row-parallel products and the
masked embedding lookup over tp (``all_reduce_tp``), gathers the logits
over tp (``all_gather_tp``), and the engine gathers each launch's token
rows over dp (``all_gather_dp``). Every function is the identity, and
issues nothing, when no mesh is given: the one-card path has no collective
and no extra copy. With a mesh they always issue their collective, even on
an axis of one member (an NCCL group of one is a real NCCL call).

NCCL calls run on the current stream and are captured into CUDA graphs
like any kernel. gloo supports only ``all_reduce`` and ``broadcast`` on
CUDA tensors, so under gloo a gather is a sum over a zeroed buffer in which
each rank placed its block (exact: every element is one value plus zeros);
the choice is the mesh's (``Mesh.gather_by_sum``), made once from the
backend. gloo cannot be captured: a collective on a gloo group inside a
CUDA-graph capture raises.

Training differentiates through these calls, and a raw collective is the
identity to autograd. So the model calls them through three functions
that autograd sees (Megatron's f and g, and the gather): ``copy_to_tp``
(the identity forward, a tp sum of the gradient backward — before a
column-parallel product, whose input is replicated), ``reduce_from_tp``
(a tp sum forward, the identity backward — after a row-parallel product or
the masked embedding lookup) and ``gather_from_tp`` (``all_gather_tp``
forward, the rank's own slice of the gradient backward). Where no gradient
is asked for (``no_grad``, the serve path, its captured graphs) they issue
exactly the calls above and no other: ``copy_to_tp`` none.

``local_only()`` turns the collectives of this thread into local stand-ins
of the right shapes and no communication: the engine's eager pass before a
second thread's first capture uses it, so that it issues no collective the
other ranks would have to match.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_local = threading.local()


@contextlib.contextmanager
def local_only():
    prev = getattr(_local, "on", False)
    _local.on = True
    try:
        yield
    finally:
        _local.on = prev


def _is_local() -> bool:
    return getattr(_local, "on", False)


def _check_capture(mesh) -> None:
    if mesh.gather_by_sum and torch.cuda.is_available() \
            and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "a gloo collective cannot be captured into a CUDA graph: build "
            "the engine with graphs=False on a gloo group")


def all_reduce_tp(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Sum of x over the tp group, in place (x must be a fresh tensor)."""
    if mesh is None or _is_local():
        return x
    import torch.distributed as dist

    _check_capture(mesh)
    dist.all_reduce(x, group=mesh.tp_group)
    return x


def _gather(x: torch.Tensor, mesh, group, n: int, i: int) -> torch.Tensor:
    """(n, *x.shape): member j's x at index j."""
    if x.dtype == torch.bool:
        return _gather(x.to(torch.uint8), mesh, group, n, i).bool()
    x = x.contiguous()
    if mesh.gather_by_sum or _is_local():
        out = x.new_zeros((n,) + tuple(x.shape))
        out[i].copy_(x)
        if not _is_local():
            import torch.distributed as dist

            _check_capture(mesh)
            dist.all_reduce(out, group=group)
        return out
    import torch.distributed as dist

    out = x.new_empty((n,) + tuple(x.shape))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def all_gather_tp(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """(tp, *x.shape): every tp member's x, in tp-rank order; x[None]
    without a mesh."""
    if mesh is None:
        return x[None]
    return _gather(x, mesh, mesh.tp_group, mesh.tp, mesh.tp_rank)


def all_gather_dp(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The dp members' x concatenated along dim 0, in dp-rank order (each
    member's slot rows, back to the whole slot batch); x without a mesh."""
    if mesh is None:
        return x
    g = _gather(x, mesh, mesh.dp_group, mesh.dp, mesh.dp_rank)
    return g.reshape((-1,) + tuple(x.shape[1:]))


def _grad_wanted(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_tp(g.clone(memory_format=torch.contiguous_format),
                             ctx.mesh), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_tp(x.clone(memory_format=torch.contiguous_format),
                             mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.i = mesh.tp_rank
        return all_gather_tp(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.i], None


def copy_to_tp(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """x, whose gradient is summed over tp: the replicated input of a
    column-parallel product (each rank's gradient of it is a partial
    sum)."""
    if mesh is None or not _grad_wanted(x):
        return x
    return _CopyToTP.apply(x, mesh)


def reduce_from_tp(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The sum of x over tp (``all_reduce_tp``, in place on a fresh x where
    no gradient is wanted); the gradient passes through unchanged."""
    if mesh is None or not _grad_wanted(x):
        return all_reduce_tp(x, mesh)
    return _ReduceFromTP.apply(x, mesh)


def gather_from_tp(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``all_gather_tp(x)``; the gradient of the gathered tensor gives each
    rank its own slice (every rank computes the same thing from it)."""
    if mesh is None or not _grad_wanted(x):
        return all_gather_tp(x, mesh)
    return _GatherFromTP.apply(x, mesh)


def all_reduce_dp(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Sum of x over the dp group, in place (x must be a fresh tensor); no
    gradient (the train step sums its counts and gradients with it)."""
    if mesh is None or _is_local():
        return x
    import torch.distributed as dist

    _check_capture(mesh)
    dist.all_reduce(x, group=mesh.dp_group)
    return x


def all_reduce_max_tp(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Elementwise max of x over tp, in place; no gradient (the
    vocab-parallel softmax's shift)."""
    if mesh is None or _is_local():
        return x
    import torch.distributed as dist

    _check_capture(mesh)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.tp_group)
    return x
