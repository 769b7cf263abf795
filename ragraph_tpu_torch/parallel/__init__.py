"""Multi-device execution of the port on ``torch.distributed`` (counterpart
of ``ragraph_tpu/parallel``): one process per rank, a process group, a
``DeviceMesh`` with the JAX mesh's axis names, and explicit collectives
where the JAX package's ``shard_map`` and GSPMD inserted them.

Launch a CLI with ``python -m torch.distributed.run --nproc-per-node N -m
ragraph_tpu_torch.cli.edge ... --mesh dp=D,idx=I``; each rank reads
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (:func:`init_distributed`).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ragraph_tpu_torch.parallel.mesh import (  # noqa: F401
    axis_index, axis_size, dp_spec, make_mesh, make_multislice_mesh,
    mesh_shape, replicate, shard_rows)
from ragraph_tpu_torch.parallel.sharded_index import (  # noqa: F401
    sharded_cosine_topk, sharded_gather_rows, sharded_retrieve)
from ragraph_tpu_torch.parallel.dp import (  # noqa: F401
    make_dp_train_step, shard_batch)
from ragraph_tpu_torch.parallel.sharded_library import (  # noqa: F401
    build_sharded_library, sharded_library_append, sharded_library_init)
from ragraph_tpu_torch.parallel.edge_sharded import (  # noqa: F401
    ShardedEdges, shard_edges_by_receiver, sharded_lightgcn_propagate,
    sharded_propagate_per_step)
from ragraph_tpu_torch.parallel.sharded_selection import (  # noqa: F401
    kth_largest_psum, sharded_huge_k_fuse, sharded_kth_largest)


def init_distributed(device: str = "cuda",
                     backend: str | None = None) -> torch.device:
    """Join (or start) the process group and return this rank's device.

    Under ``torch.distributed.run`` the rank, world size and local rank come
    from ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` and the rendezvous from
    ``MASTER_ADDR``/``MASTER_PORT``; without them the process is a world of
    one. ``device="cuda"`` takes ``cuda:LOCAL_RANK``; on a machine with
    fewer cards than local ranks only a gloo group may share them (NCCL
    refuses two ranks on one card), and then rank ``r`` takes card ``r mod
    count`` and says so. ``device="cpu"`` runs every rank on the CPU.
    ``backend`` defaults to NCCL on CUDA and gloo on the CPU. A group that
    already exists is joined as it is.
    """
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if kind == "cpu" and backend != "gloo":
        raise ValueError(f"backend {backend!r} cannot run on the CPU; use "
                         f"gloo")
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    if kind == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is False; pass "
                           "--device cpu to run the ranks on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    count = torch.cuda.device_count()
    if local >= count:
        if dist.get_backend() != "gloo":
            raise RuntimeError(
                f"local rank {local} has no card of its own ({count} "
                f"visible) and backend {dist.get_backend()} cannot share "
                f"one; pass --dist-backend gloo")
        print(f"parallel: rank {dist.get_rank()} shares cuda:{local % count}"
              f" (gloo)", flush=True)
        local %= count
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def barrier() -> None:
    """Wait for every rank of the world (a no-op outside a group)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def is_writer() -> bool:
    """Whether this process writes results, logs and checkpoints: rank 0,
    or a process outside any group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def parse_mesh(spec: str) -> dict:
    """``"dp=D,idx=I"`` as ``{"dp": D, "idx": I}``; a malformed spec exits
    with the JAX CLIs' message."""
    out = {}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        if k.strip() not in ("dp", "idx") or not v.strip().isdigit():
            raise SystemExit(f"--mesh expects dp=D,idx=I, got {spec!r}")
        out[k.strip()] = int(v)
    return out


def mesh_from_args(spec: str | None, device: str,
                   backend: str | None = None):
    """The CLIs' ``--mesh``: ``(mesh or None, device)``. With a spec the
    world size (``WORLD_SIZE``, else 1) must be ``dp * idx``, checked before
    the process group is joined (:func:`init_distributed`)."""
    if not spec:
        return None, None
    dims = parse_mesh(spec)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    dp, idx = dims.get("dp"), dims.get("idx")
    if dp is not None and idx is not None and dp * idx != world:
        raise ValueError(f"dp*idx = {dp}*{idx} != {world} ranks")
    dev = init_distributed(device, backend)
    return make_mesh(device_type=dev.type, **dims), dev
