"""Data parallelism over the ``dp`` (and ``dcn``) axes (counterpart of
``ragraph_tpu/parallel/dp.py``).

In the JAX package a batch sharded over ``dp`` is still one global array,
so every mean in the loss is global and XLA inserts the gradient
all-reduce. Here each rank holds its share of the batch, so the global
mean is built explicitly: a rank's loss is a numerator over its share and
a count, the counts are all-reduced apart from the numerators, and each
rank backpropagates ``numerator / global count``. A rank's share is a mean
over equal slices when it gives no count (the global mean is then the mean
of the shares).

Every rank of an ``idx`` group holds a copy of the same loss, and the
backward of the collectives (:mod:`.collectives`) sums the copies'
cotangents; so each rank backpropagates ``1 / |idx|`` of its loss. After
the backward, gradients of replicated parameters are summed over every
axis, those of ``idx``-sharded parameters (embedding tables) over the
data-parallel axes only. Replicated parameters then take the same update
on every rank and stay equal.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np
import torch

from ragraph_tpu_torch.parallel.collectives import all_reduce
from ragraph_tpu_torch.parallel.mesh import (axis_index, axis_names,
                                             axis_size, dp_extent, dp_spec)


def _share(mesh, n: int, axes: tuple) -> slice:
    extent = int(np.prod([axis_size(mesh, a) for a in axes]))
    if n % extent:
        return slice(0, n)
    i = 0
    for a in axes:
        i = i * axis_size(mesh, a) + axis_index(mesh, a)
    b = n // extent
    return slice(i * b, (i + 1) * b)


def dp_rows(mesh, n: int) -> slice:
    """This rank's share of ``n`` rows over the data-parallel axes: a
    contiguous block when the extent divides ``n``, else all of them (the
    leaf stays replicated, as ``shard_batch`` leaves it in JAX)."""
    return _share(mesh, n, dp_spec(mesh))


def shard_batch(mesh, batch, axis_name=None):
    """This rank's share of every leaf's leading axis (tensors and numpy
    arrays in dicts, lists, tuples and dataclasses). ``axis_name`` (a name
    or a tuple of names) defaults to the data-parallel axes; leaves the
    extent does not divide, and scalars, stay whole."""
    axes = (dp_spec(mesh) if axis_name is None else
            (axis_name,) if isinstance(axis_name, str) else tuple(axis_name))

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(place(v) for v in x)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: place(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init})
        if getattr(x, "ndim", 0) >= 1:
            return x[_share(mesh, x.shape[0], axes)]
        return x

    return place(batch)


def backward_global_mean(mesh, num: torch.Tensor,
                         count: torch.Tensor | None = None) -> torch.Tensor:
    """Backpropagate this rank's part of the global loss ``Σ num / max(Σ
    count, 1)`` (sums over the data-parallel axes), or with no ``count``
    of the mean of the ranks' ``num``; returns the global loss, detached
    and the same on every rank."""
    dp_axes = tuple(a for a in dp_spec(mesh) if a in axis_names(mesh))
    if count is None:
        total = torch.full((), float(dp_extent(mesh)), device=num.device)
    else:
        total = torch.clamp_min(
            all_reduce(count.detach().float(), mesh, dp_axes), 1.0)
    (num / total / axis_size(mesh, "idx")).backward()
    return all_reduce(num.detach().float(), mesh, dp_axes) / total


def backward_row_share(mesh, terms: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """:func:`backward_global_mean` of the weighted mean ``Σ terms·w /
    max(Σ w, 1)`` of a batch whose rows every rank holds whole: the rank's
    numerator and count run over its :func:`dp_rows` share."""
    rows = dp_rows(mesh, terms.shape[0])
    return backward_global_mean(mesh, (terms * weights)[rows].sum(),
                                weights[rows].sum())


def _grads(params) -> list:
    return [p.grad if p.grad is not None else torch.zeros_like(p)
            for p in params]


def sync_grads(mesh, replicated: Iterable[torch.Tensor] = (),
               sharded: Iterable[torch.Tensor] = ()) -> None:
    """Sum the gradients of ``replicated`` parameters over every axis and
    those of ``idx``-sharded ones over the data-parallel axes, in place,
    with one collective per kind and axis."""
    dp_axes = tuple(a for a in dp_spec(mesh) if a in axis_names(mesh))
    for params, axes in ((list(replicated), axis_names(mesh)),
                         (list(sharded), dp_axes)):
        if not params or all(axis_size(mesh, a) == 1 for a in axes):
            continue
        grads = _grads(params)
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        flat = all_reduce(flat, mesh, axes)
        off = 0
        for p, g in zip(params, grads):
            n = g.numel()
            p.grad = flat[off:off + n].view_as(g).to(g.dtype)
            off += n


def make_dp_train_step(mesh, loss_fn: Callable, optimizer):
    """A replicated-params / sharded-batch step.

    ``loss_fn(params, batch, key)`` sees this rank's share of the batch
    (:func:`shard_batch`) and returns a mean over it, or a ``(numerator,
    count)`` pair whose global ratio is the loss; ``optimizer`` is a
    ``torch.optim`` optimizer over the leaf tensors of ``params``, which
    every rank holds equal. The step returns the global loss::

        step = make_dp_train_step(mesh, loss_fn, optimizer)
        loss = step(params, batch, key)
    """
    def step(params, batch, key=None):
        optimizer.zero_grad(set_to_none=True)
        out = loss_fn(params, shard_batch(mesh, batch), key)
        num, count = out if isinstance(out, tuple) else (out, None)
        loss = backward_global_mean(mesh, num, count)
        sync_grads(mesh, [p for g in optimizer.param_groups
                          for p in g["params"]])
        optimizer.step()
        return loss

    return step
