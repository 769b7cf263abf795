"""Building the toy-graph library directly on a row-sharded store
(counterpart of ``ragraph_tpu/parallel/sharded_library.py``), so that a
store of up to 10M rows never has to exist on one device.

- The sharded store is a :class:`ToyGraphLibrary` with ``mesh`` set whose
  arrays hold this rank's rows of a store of exactly ``capacity`` rows (no
  dump row): rank ``d`` owns the logical rows ``[d*C/D, (d+1)*C/D)``. Row
  numbering is the single-device store's, so ``retrieve`` (through
  :mod:`.sharded_index`) and row-for-row comparisons work unchanged.
- An append sees the replicated batch of new entries on every rank,
  computes the same global compacting positions ``fill + cumsum(valid) -
  valid`` everywhere, and writes only the rows that land in its own range;
  the rest, invalid and overflowing rows included, are dropped. No entry
  moves between ranks.
- ``fill`` stays replicated: every rank computes the same ``min(fill +
  valid.sum(), capacity)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ragraph_tpu_torch.parallel.mesh import axis_index, axis_size
from ragraph_tpu_torch.rag.library import (LibraryConfig, ToyGraphLibrary,
                                           build_library_with)


def sharded_library_init(mesh, capacity: int, emb_size: int,
                         num_classes: int, num_anchors: int = 10,
                         axis_name: str = "idx",
                         device: str | torch.device = "cuda"
                         ) -> ToyGraphLibrary:
    """An empty store of ``capacity`` rows sharded over ``axis_name``; each
    rank allocates only its own ``capacity / D`` rows on ``device``.
    ``capacity`` must be a multiple of the axis size."""
    n_shards = axis_size(mesh, axis_name)
    if capacity % n_shards:
        raise ValueError(
            f"capacity {capacity} not divisible by {n_shards} '{axis_name}' "
            f"shards")
    rows = capacity // n_shards

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return ToyGraphLibrary(
        keys=z(rows, emb_size), values=z(rows, emb_size),
        labels=z(rows, num_classes), positions=z(rows, num_anchors),
        fill=torch.zeros((), dtype=torch.int32, device=device),
        capacity=capacity, mesh=mesh, axis_name=axis_name)


def sharded_library_append(mesh, lib: ToyGraphLibrary, keys, values, labels,
                           positions, valid,
                           axis_name: str = "idx") -> ToyGraphLibrary:
    """Compacting append onto a row-sharded store (see module doc), in
    place as :func:`~ragraph_tpu_torch.rag.library.library_append`: valid
    rows pack densely after ``fill`` in global row order; invalid and
    overflow rows are dropped."""
    rows_local = lib.keys.shape[0]
    d = axis_index(mesh, axis_name)
    valid = valid.bool()
    vi = valid.to(torch.int32)
    gpos = lib.fill + torch.cumsum(vi, dim=0) - vi
    mine = valid & (gpos < lib.capacity) & (gpos // rows_local == d)
    src = torch.nonzero(mine).flatten()
    dst = (gpos[src] - d * rows_local).long()
    with torch.no_grad():
        for store, new in ((lib.keys, keys), (lib.values, values),
                           (lib.labels, labels), (lib.positions, positions)):
            store[dst] = new.detach()[src].to(store.dtype)
    new_fill = torch.clamp_max(lib.fill + vi.sum(), lib.capacity) \
        .to(torch.int32)
    return dataclasses.replace(lib, fill=new_fill)


def build_sharded_library(mesh, lib: ToyGraphLibrary, encoder_fn: Callable,
                          batches, cfg: LibraryConfig,
                          generator: torch.Generator | None = None,
                          draws_per_batch=None,
                          axis_name: str = "idx") -> ToyGraphLibrary:
    """The sharded store's :func:`~ragraph_tpu_torch.rag.library.
    build_library`: every rank builds the (small, replicated) entries from
    the same draws, and only the appends are sharded."""
    return build_library_with(
        lib, encoder_fn, batches, cfg, generator, draws_per_batch,
        append_fn=lambda lb, *entries: sharded_library_append(
            mesh, lb, *entries, axis_name=axis_name))
