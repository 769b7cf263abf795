"""Device meshes and placement (counterpart of
``ragraph_tpu/parallel/mesh.py``).

The JAX package drives every device from one process and lets ``shard_map``
and GSPMD insert the collectives. PyTorch's idiom is one process per rank:
a ``torch.distributed`` process group and a
:class:`~torch.distributed.device_mesh.DeviceMesh` whose dimension names play
the part of the JAX mesh's axis names:

- ``dp``  — data parallelism over the batch;
- ``idx`` — the retrieval-index axis: library rows and embedding-table rows
  sharded over the ranks, local top-k and a global merge
  (:mod:`.sharded_index`);
- ``dcn`` — the slice-major data-parallel axis of a multi-slice mesh
  (:func:`make_multislice_mesh`).

Layouts are plain tensors. A tensor sharded over an axis is, on each rank,
the rank's own block of rows ``[r*b, (r+1)*b)`` of the global array, ``r``
its index on the axis and ``b = ceil(R / size)`` (the last blocks padded
with zero rows when the axis does not divide ``R``); a replicated tensor is
the same on every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _require_group() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: call "
            "ragraph_tpu_torch.parallel.init_distributed() (or "
            "torch.distributed.init_process_group) first")
    return dist.get_world_size()


def make_mesh(dp: int | None = None, idx: int | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A ``(dp, idx)`` mesh over the world's ranks, ``idx`` the inner
    (fastest-varying) dimension as in the JAX package's reshape.

    Defaults as the JAX package's: every rank on ``idx`` when neither is
    given, else the complement of the one given. ``dp * idx`` must equal the
    world size.
    """
    n = _require_group()
    if dp is None and idx is None:
        dp, idx = 1, n
    elif dp is None:
        dp = n // idx
    elif idx is None:
        idx = n // dp
    if dp * idx != n:
        raise ValueError(f"dp*idx = {dp}*{idx} != {n} ranks")
    return init_device_mesh(device_type, (dp, idx),
                            mesh_dim_names=("dp", "idx"))


def make_multislice_mesh(num_slices: int, dp: int | None = None,
                         idx: int | None = None,
                         device_type: str = "cuda") -> DeviceMesh:
    """A ``(dcn, dp, idx)`` mesh: ``dcn`` the slice-major data-parallel
    axis, ``dp`` and ``idx`` within a slice. GPUs have no slices, so the
    ranks are laid out by the plain reshape of the JAX package's non-TPU
    branch: ``num_slices`` consecutive groups of ``dp * idx`` ranks."""
    n = _require_group()
    if num_slices < 1 or n % num_slices:
        raise ValueError(f"{n} ranks not divisible into {num_slices} "
                         f"slices")
    per_slice = n // num_slices
    if dp is None and idx is None:
        dp, idx = 1, per_slice
    elif dp is None:
        dp = per_slice // idx
    elif idx is None:
        idx = per_slice // dp
    if dp * idx != per_slice:
        raise ValueError(f"dp*idx = {dp}*{idx} != {per_slice} "
                         f"ranks per slice")
    return init_device_mesh(device_type, (num_slices, dp, idx),
                            mesh_dim_names=("dcn", "dp", "idx"))


def axis_names(mesh: DeviceMesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh: DeviceMesh | None, name: str) -> int:
    """The mesh's extent on ``name``; 1 for no mesh or an absent axis."""
    if mesh is None or name not in axis_names(mesh):
        return 1
    return int(mesh.size(axis_names(mesh).index(name)))


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's index on axis ``name`` (JAX's ``lax.axis_index``)."""
    return 0 if name not in axis_names(mesh) else \
        int(mesh.get_local_rank(name))


def mesh_shape(mesh: DeviceMesh) -> dict:
    """``{axis name: extent}``, as JAX's ``mesh.shape``."""
    return {a: axis_size(mesh, a) for a in axis_names(mesh)}


def dp_spec(mesh: DeviceMesh) -> tuple:
    """The axes a batch's leading dimension splits over: ``("dcn", "dp")``
    on a multi-slice mesh, ``("dp",)`` on a flat one (JAX's
    ``P(("dcn", "dp"))`` and ``P("dp")``)."""
    return ("dcn", "dp") if "dcn" in axis_names(mesh) else ("dp",)


def dp_extent(mesh: DeviceMesh) -> int:
    return int(np.prod([axis_size(mesh, a) for a in dp_spec(mesh)]))


def rows_per_shard(n_rows: int, n_shards: int) -> int:
    return -(-n_rows // n_shards)


def shard_rows(mesh: DeviceMesh, x: torch.Tensor,
               axis_name: str = "idx") -> torch.Tensor:
    """This rank's block of ``x``'s rows on ``axis_name`` (a copy; zero
    rows pad the block when the axis does not divide the row count)."""
    n_shards = axis_size(mesh, axis_name)
    b = rows_per_shard(x.shape[0], n_shards)
    lo = axis_index(mesh, axis_name) * b
    block = x[lo:lo + b]
    if block.shape[0] < b:
        block = torch.cat([block, block.new_zeros(
            (b - block.shape[0], *x.shape[1:]))])
    return block.clone()


def replicate(mesh: DeviceMesh, tree):
    """``tree`` made equal on every rank: each tensor (in dicts, lists,
    tuples and dataclasses) is broadcast from rank 0 of the world into a
    copy, and the parameters and buffers of a ``torch.nn.Module`` in place.
    Returns the tree."""
    from ragraph_tpu_torch.parallel.collectives import broadcast_
    del mesh    # the mesh spans the world, whose rank 0 is the source
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                broadcast_(t)
        return tree
    if isinstance(tree, dict):
        return {k: replicate(None, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(None, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: replicate(None, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, torch.Tensor):
        out = tree.detach().clone()
        broadcast_(out)
        return out
    return tree
