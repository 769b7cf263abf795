"""Collectives on a named mesh axis (the port's counterpart of the
``jax.lax`` collectives that the JAX package's ``shard_map`` bodies call).

==========================  =======================================
JAX                         here
==========================  =======================================
``lax.all_gather(tiled)``   :func:`all_gather` (rows, concatenated)
``lax.psum_scatter``        :func:`reduce_scatter`
``lax.psum``                :func:`all_reduce`
==========================  =======================================

Each is autograd-aware: the backward of :func:`all_gather` is a
reduce-scatter of the cotangents (JAX's transpose of ``all_gather`` is
``psum_scatter``), that of :func:`reduce_scatter` an all-gather, that of
:func:`all_reduce` an all-reduce. Under this convention every rank
backpropagates its own copy of a replicated loss, so a caller scales the
loss by the reciprocal of the number of copies (:mod:`.dp`).

Host staging: a gloo group reduces through host memory, and not every
gloo collective takes a CUDA tensor. Whenever the group's backend is gloo
and the tensor lies on a card, the collective copies it to the host, runs
there and copies the result back; ``HOST_STAGED`` counts those calls by
operation, and the first one prints a line that says so. NCCL groups run
on the card.
"""

from __future__ import annotations

import collections
import warnings

import torch
import torch.distributed as dist

# operation -> collectives that went through host memory (gloo on a card)
HOST_STAGED: collections.Counter = collections.Counter()


def group_of(mesh, axis_name: str):
    """The process group of ``mesh``'s axis ``axis_name``."""
    return mesh.get_group(axis_name)


def _size(group) -> int:
    return dist.get_world_size(group)


def _staged(t: torch.Tensor, group, op: str) -> bool:
    if t.device.type == "cpu" or dist.get_backend(group) != "gloo":
        return False
    if not HOST_STAGED:
        print("parallel: gloo group: collectives on CUDA tensors stage "
              "through host memory", flush=True)
    HOST_STAGED[op] += 1
    return True


def _all_gather_raw(x: torch.Tensor, group) -> torch.Tensor:
    n = _size(group)
    host = _staged(x, group, "all_gather")
    src = x.detach().contiguous()
    src = src.cpu() if host else src
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    with warnings.catch_warnings():
        # newer releases rename it all_gather_single; the old name stays
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, src, group=group)
    return out.to(x.device) if host else out


def _reduce_scatter_raw(x: torch.Tensor, group) -> torch.Tensor:
    n = _size(group)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: {x.shape[0]} rows do not divide "
                         f"over {n} ranks")
    host = _staged(x, group, "reduce_scatter")
    src = x.detach().contiguous()
    src = src.cpu() if host else src
    out = src.new_empty((x.shape[0] // n, *x.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                   group=group)
    return out.to(x.device) if host else out


def _all_reduce_raw(x: torch.Tensor, group) -> torch.Tensor:
    host = _staged(x, group, "all_reduce")
    out = x.detach().cpu().clone() if host else \
        x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.device) if host else out


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Overwrite ``t`` in place with global rank ``src``'s copy."""
    if dist.get_world_size(group) == 1:
        return t
    if _staged(t, group, "broadcast"):
        host = t.detach().cpu()
        dist.broadcast(host, src=src, group=group)
        t.data.copy_(host)
    elif t.is_contiguous():
        dist.broadcast(t.data, src=src, group=group)
    else:
        buf = t.detach().contiguous()
        dist.broadcast(buf, src=src, group=group)
        t.data.copy_(buf)
    return t


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather_raw(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _reduce_scatter_raw(ct, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter_raw(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _all_gather_raw(ct, ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_raw(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce_raw(ct, ctx.group), None


def all_gather(x: torch.Tensor, mesh, axis_name: str = "idx") -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along rows, in axis order."""
    group = group_of(mesh, axis_name)
    if _size(group) == 1:
        return x
    return _AllGather.apply(x, group)


def reduce_scatter(x: torch.Tensor, mesh,
                   axis_name: str = "idx") -> torch.Tensor:
    """The sum over the axis of ``x``, of which each rank keeps its block of
    rows."""
    group = group_of(mesh, axis_name)
    if _size(group) == 1:
        return x
    return _ReduceScatter.apply(x, group)


def all_reduce(x: torch.Tensor, mesh, axis_names="idx") -> torch.Tensor:
    """The sum of ``x`` over one axis or several (a tuple of names).
    Integer tensors sum exactly; nothing is cast."""
    names = (axis_names,) if isinstance(axis_names, str) else axis_names
    for name in names:
        group = group_of(mesh, name)
        if _size(group) > 1:
            x = (_AllReduce.apply(x, group) if x.requires_grad
                 else _all_reduce_raw(x, group))
    return x
