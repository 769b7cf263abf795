"""The multi-device paths on one process group, each rank's kernels held to
the single-device answer; one JSON file per rank.

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m ragraph_tpu_torch.bench.multi_device --out DIR \\
        [--meshes 1x2,2x1] [--parts edge,retrieval,huge_k,library] \\
        [--device cpu --small]

On the card every rank takes ``cuda:0`` over a gloo group (NCCL refuses
two ranks on one card), whose collectives go through host memory: their
times say nothing of NCCL. What runs on the card is each rank's own work,
through the hand-written kernels on shard-local inputs. Parts (``edge``
runs on every mesh of ``--meshes``, the others on ``dp=1,idx=<world>``):

- ``edge``: at U = I = 131,072, 2^20 interactions, D = 64, 3 layers, batch
  2,048: one RAGraph pretrain step and one finetune step (its library
  built through the sharded propagation; its retrieval, kernel C, whole on
  every rank) with the tables row-sharded over ``idx`` and the batch over
  ``dp``, an SGD step of rate 0.1 so that the tables show the gradients;
  rank 0 takes the same steps on one device and holds the loss, every
  gradient and every parameter to them (f32 propagation: the bf16 one
  rounds each layer's cotangent, and a sum over the ranks in another
  order can move a rounding by one bf16 step), then one pretrain step in
  bf16 whose loss must equal one device's; kernel A's launches per rank per
  step, forward and backward;
- ``retrieval``: 2,048 queries against 262,144 rows of 64, k = 10, rows
  sharded: the local top-k by kernel C (``"approx"``) and by kernels D-G
  (``"bucket"``), against one device's answer of the same method, and the
  wall time of each beside one device's;
- ``huge_k``: the koubei ``vanilla`` shape, two chunks of 512 queries
  against 524,288 rows, k = 100,000, f32 and bf16: the threshold bit for
  bit one device's ``rowwise_kth_largest`` of the same scores, the fusion's
  count exact and its mean to 1e-5 relative;
- ``library``: the node CLI's library (capacity 65,536, hidden 256) built
  sharded from 1,500 synthetic graphs: rows and ``fill`` equal to one
  device's build, and ``retrieve`` (kernel C on each shard) equal: its
  scores within ``TOL_SCORE``, its rows where no score ties.

``chip_smoke.py`` (phase 14) runs it and reads the files.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ragraph_tpu_torch import native, parallel
from ragraph_tpu_torch.bench.main_path import make_rows, xavier_tables
from ragraph_tpu_torch.convert import params_from_jax
from ragraph_tpu_torch.data.edgelist import load_edge_dataset
from ragraph_tpu_torch.models.edge import (EdgeGraphArrays, EdgeModelConfig,
                                           RAGraphEdge)
from ragraph_tpu_torch.ops.selection import rowwise_kth_largest
from ragraph_tpu_torch.ops.similarity import l2_normalize
from ragraph_tpu_torch.ops.topk import cosine_topk
from ragraph_tpu_torch.parallel.collectives import HOST_STAGED, all_gather
from ragraph_tpu_torch.parallel.mesh import axis_size
from ragraph_tpu_torch.train.trainer import EdgeTrainer, param_leaves

FULL = dict(n_users=1 << 17, n_items=1 << 17, n_inter=1 << 20, d=64,
            layers=3, batch=2048, q=2048, r=1 << 18, k=10, huge_q=512,
            huge_r=1 << 19, huge_k=100_000, lib_graphs=1500,
            lib_cap=65536, lib_hidden=256, lib_batch=16)
SMALL = dict(n_users=512, n_items=512, n_inter=8192, d=16, layers=3,
             batch=256, q=64, r=4096, k=10, huge_q=32, huge_r=4096,
             huge_k=1000, lib_graphs=40, lib_cap=2048, lib_hidden=32,
             lib_batch=8)
TOL_SCORE = 1e-5
TOL_GRAD = (1e-4, 1e-9)
TOL_LOSS = 1e-5
TOL_TABLE = 1e-6     # an SGD step of 0.1 times gradients within TOL_GRAD
TOL_MEAN = 1e-5


def fail(msg: str):
    raise AssertionError(f"rank {dist.get_rank()}: {msg}")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(dev, fn, together: bool = True):
    """``fn()`` and its wall milliseconds; ``together``: every rank starts
    it at once (a collective: all ranks must call it)."""
    if together:
        parallel.barrier()
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def counted(dev, fn, together: bool = True):
    """``fn()``, its wall ms and the kernel launches it made."""
    native.reset_launches()
    out, ms = timed(dev, fn, together)
    return out, ms, dict(native.LAUNCHES)


def close(name, got, want, rtol, atol):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        fail(f"{name}: {int(bad.sum())} of {bad.numel()} beyond rtol {rtol} "
             f"atol {atol}, largest error {float(err.max()):.3e}")
    return float(err.max()) if err.numel() else 0.0


# -- edge ---------------------------------------------------------------------

def edge_data(size, dev, seed=0):
    rng = np.random.default_rng(seed)
    n_u, n_i = size["n_users"], size["n_items"]
    train, test = make_rows(rng, n_u, n_i, size["n_inter"])
    ds = load_edge_dataset(train, test, num_users=n_u, num_items=n_i)
    tables = params_from_jax(xavier_tables(rng, n_u, n_i, size["d"]), dev)
    first = next(ds.train_batches(size["batch"],
                                  np.random.default_rng(seed + 1)))
    batch = tuple(torch.from_numpy(a).to(dev) for a in first)
    return ds, EdgeGraphArrays.from_dataset(ds, dev), tables, batch, {}


def _grads(trainer, params):
    """Each trainable leaf's gradient, whole."""
    out = {}
    for name, t in param_leaves(params):
        if t.grad is None:
            continue
        g = t.grad
        if trainer.mesh is not None and trainer._is_table(name, t):
            g = all_gather(g, trainer.mesh, "idx")[: trainer._rows[name]]
        out[name] = g.detach()
    return out


def edge_step(mesh, size, dev, data, phase, dtype):
    """One SGD step of ``phase`` on ``mesh`` (``None``: one device) with
    ``dtype`` propagation; returns the loss, the gradients and the
    parameters, whole, the step's launches and ms, and this rank's
    replicated leaves."""
    ds, graph, tables, batch, shards = data
    cfg = EdgeModelConfig(emb_size=size["d"], num_layers=size["layers"],
                          batch_size=size["batch"], propagate_dtype=dtype)
    n_idx = axis_size(mesh, "idx")
    if n_idx > 1 and n_idx not in shards:
        shards[n_idx] = graph.with_sharding(n_idx)
    model = RAGraphEdge(cfg, shards[n_idx] if n_idx > 1 else graph,
                        phase=phase, mesh=mesh)
    pre = (tables["user_embedding"], tables["item_embedding"])
    build_ms = None
    together = mesh is not None
    if phase == "finetune":
        _, build_ms = timed(dev, lambda: model.make_resource_graph(*pre),
                            together)
    params = model.init_params(torch.Generator(dev).manual_seed(3),
                               pretrained_tables=pre)
    trainer = EdgeTrainer(model, ds, logger=lambda *a, **k: None, mesh=mesh)
    leaves, _ = trainer.prepare(params)
    opt = torch.optim.SGD([t for _, t in param_leaves(leaves)
                           if t.requires_grad], lr=0.1)
    gen = torch.Generator(dev).manual_seed(7)
    (loss, _), ms, launches = counted(
        dev, lambda: trainer.step(leaves, opt, batch, gen), together)
    return {"loss": loss.float().cpu(), "grads": _grads(trainer, leaves),
            "params": dict(param_leaves(trainer.whole_params(leaves))),
            "local": {n: t.detach().clone() for n, t in param_leaves(leaves)
                      if not trainer._is_table(n, t)},
            "ms": ms, "launches": launches, "library_ms": build_ms}


def part_edge(meshes, size, dev, rank):
    data = edge_data(size, dev)
    out = {}
    single = {}
    for dp, idx in meshes:
        mesh = parallel.make_mesh(dp=dp, idx=idx, device_type=dev.type)
        for phase, dtype in (("pretrain", "f32"), ("finetune", "f32"),
                             ("pretrain", "bf16")):
            key = f"{phase}-{dtype}"
            got = edge_step(mesh, size, dev, data, phase, dtype)
            rec = {"loss": float(got["loss"]), "step_ms": got["ms"],
                   "launches": got["launches"],
                   "library_ms": got["library_ms"]}
            # replicated leaves equal on every rank, bit for bit
            for name, t in got["local"].items():
                ref = t.clone()
                parallel.replicate(mesh, ref)
                if not torch.equal(ref, t):
                    fail(f"edge {dp}x{idx} {key}: replicated {name} "
                         f"differs from rank 0's")
            if rank == 0:
                if key not in single:
                    single[key] = edge_step(None, size, dev, data, phase,
                                            dtype)
                one = single[key]
                rec["single_step_ms"] = one["ms"]
                rec["single_launches"] = one["launches"]
                rec["loss_err"] = close(f"edge {dp}x{idx} {key} loss",
                                        got["loss"], one["loss"], TOL_LOSS, 0)
            if rank == 0 and dtype == "f32":
                rec["grad_err"] = max(
                    close(f"edge {dp}x{idx} {key} grad {n}", got["grads"][n],
                          one["grads"][n], *TOL_GRAD)
                    for n in one["grads"])
                if set(got["grads"]) != set(one["grads"]):
                    fail(f"edge {dp}x{idx} {key}: gradients of "
                         f"{sorted(got['grads'])} vs {sorted(one['grads'])}")
                rec["param_err"] = max(
                    close(f"edge {dp}x{idx} {key} param {n}",
                          got["params"][n], one["params"][n], 0, TOL_TABLE)
                    for n in one["params"])
            out[f"{dp}x{idx}/{key}"] = rec
            del got
    return out


# -- retrieval ------------------------------------------------------------------

def tie_rows(got_i, want_i):
    """Rows whose index sets differ. Called after the scores were held
    equal within TOL_SCORE, so such rows differ only among tied scores."""
    a, b = got_i.cpu().sort(dim=1).values, want_i.cpu().sort(dim=1).values
    return int((a != b).any(dim=1).sum())


def part_retrieval(size, dev, rank, world):
    mesh = parallel.make_mesh(dp=1, idx=world, device_type=dev.type)
    gen = torch.Generator(dev).manual_seed(11)
    q = torch.randn(size["q"], size["d"], generator=gen, device=dev)
    keys = torch.randn(size["r"], size["d"], generator=gen, device=dev)
    rows = size["r"] // world
    local = keys[rank * rows:(rank + 1) * rows].contiguous()
    out = {}
    for method in ("approx", "bucket"):
        def run():
            return parallel.sharded_cosine_topk(mesh, q, local, size["k"],
                                                local_method=method)
        counted(dev, run)                      # warm-up
        (s, i), ms, launches = counted(dev, run)
        reps = [timed(dev, run)[1] for _ in range(3)]
        rec = {"launches": launches, "ms": sorted(reps + [ms])[2]}
        if rank == 0:
            s1, i1 = cosine_topk(q, keys, size["k"], method=method)
            rec["single_ms"] = sorted(
                timed(dev, lambda: cosine_topk(q, keys, size["k"],
                                               method=method), False)[1]
                for _ in range(4))[2]
            rec["max_abs_err"] = close(f"retrieval {method} scores", s, s1,
                                       0, TOL_SCORE)
            rec["tie_rows"] = tie_rows(i, i1)
        out[method] = rec
    return out


# -- huge k ---------------------------------------------------------------------

def part_huge_k(size, dev, rank, world):
    from ragraph_tpu_torch.parallel.sharded_selection import (
        kth_largest_psum, sharded_huge_k_fuse)
    mesh = parallel.make_mesh(dp=1, idx=world, device_type=dev.type)
    gen = torch.Generator(dev).manual_seed(12)
    r, k = size["huge_r"], size["huge_k"]
    keys_n = l2_normalize(torch.randn(r, size["d"], generator=gen,
                                      device=dev))
    values = torch.randn(r, size["d"], generator=gen, device=dev)
    q = torch.randn(2 * size["huge_q"], size["d"], generator=gen, device=dev)
    rows = r // world
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        kn = keys_n.to(dtype)
        kl, vl = (t[rank * rows:(rank + 1) * rows].contiguous()
                  for t in (kn, values))
        rec = {"ms": [], "single_ms": [], "mean_err": 0.0}
        for c in range(2):
            qc = q[c * size["huge_q"]:(c + 1) * size["huge_q"]]
            (mean, count), ms, launches = counted(
                dev, lambda: sharded_huge_k_fuse(mesh, qc, kl, vl, k))
            rec["ms"].append(ms)
            qn = l2_normalize(qc).to(dtype)
            kth = kth_largest_psum(qn @ kl.T, k, mesh, r)
            if rank != 0:
                continue
            # one device: the same score blocks, whole
            def single():
                full = torch.cat([qn @ kn[i * rows:(i + 1) * rows].T
                                  for i in range(world)], dim=1)
                kth1 = rowwise_kth_largest(full, k)
                member = full >= kth1
                cnt = member.sum(dim=1, keepdim=True)
                return kth1, cnt, (member.to(values.dtype) @ values).float() \
                    / cnt.clamp(min=1)
            (kth1, cnt1, mean1), ms1 = timed(dev, single, False)
            rec["single_ms"].append(ms1)
            view = torch.int16 if dtype == torch.bfloat16 else torch.int32
            if not torch.equal(kth.view(view), kth1.view(view)):
                fail(f"huge-k {dtype} chunk {c}: threshold differs from "
                     f"rowwise_kth_largest")
            if not torch.equal(count.cpu(), cnt1[:, 0].int().cpu()):
                fail(f"huge-k {dtype} chunk {c}: member counts differ")
            rec["mean_err"] = max(rec["mean_err"], close(
                f"huge-k {dtype} chunk {c} mean", mean, mean1, TOL_MEAN,
                1e-7))
        out[str(dtype).split(".")[-1]] = rec
    return out


# -- library --------------------------------------------------------------------

def part_library(size, dev, rank, world):
    from ragraph_tpu_torch.data.batching import stacked_batches
    from ragraph_tpu_torch.data.synthetic import synthetic_tu_dataset
    from ragraph_tpu_torch.models.ragraph_node import (RAGraphNode,
                                                       RAGraphNodeConfig)
    from ragraph_tpu_torch.rag.library import LibraryConfig, retrieve
    mesh = parallel.make_mesh(dp=1, idx=world, device_type=dev.type)
    ds = synthetic_tu_dataset(seed=0, num_graphs=size["lib_graphs"],
                              num_classes=3, feat_dim=16)
    cfg = RAGraphNodeConfig(emb_size=size["lib_hidden"], num_class=3,
                            library=LibraryConfig(level="node",
                                                  retrieve_num=4,
                                                  toy_graph_hop=2))
    task = RAGraphNode(cfg, feature_dim=ds.num_node_attributes, device=dev)
    state = task.init_state(torch.Generator().manual_seed(0),
                            library_capacity=size["lib_cap"])

    def batches():
        return stacked_batches(ds.graphs, size["lib_batch"], num_classes=3,
                               num_graph_classes=3, device=dev)

    lib0 = parallel.sharded_library_init(mesh, size["lib_cap"],
                                         size["lib_hidden"], 3,
                                         num_anchors=cfg.library.num_anchors,
                                         device=dev)
    lib, ms, launches = counted(dev, lambda: parallel.build_sharded_library(
        mesh, lib0, task.encoder_fn(state), batches(), cfg.library,
        torch.Generator(dev).manual_seed(1)))
    q = torch.randn(size["q"], size["lib_hidden"],
                    generator=torch.Generator(dev).manual_seed(13),
                    device=dev)
    (v, lab), first_ms, rl = counted(
        dev, lambda: retrieve(lib, q, cfg.library))
    launches = {k: launches.get(k, 0) + rl.get(k, 0)
                for k in set(launches) | set(rl)}
    rms = timed(dev, lambda: retrieve(lib, q, cfg.library))[1]
    k = cfg.library.retrieve_num
    s, i = parallel.sharded_cosine_topk(mesh, q, lib.keys, k,
                                        valid_mask=lib.valid_mask)
    whole = {n: all_gather(getattr(lib, n), mesh, "idx")
             for n in ("keys", "values", "labels", "positions")}
    rec = {"fill": int(lib.fill), "build_ms": ms, "retrieve_ms": rms,
           "retrieve_first_ms": first_ms, "launches": launches}
    if rank == 0:
        one, ms1 = timed(dev, lambda: task.build_library(
            state, batches(), torch.Generator(dev).manual_seed(1)), False)
        lib1 = one.library
        rec.update(single_build_ms=ms1, single_fill=int(lib1.fill))
        if int(lib1.fill) != int(lib.fill):
            fail(f"library fill {int(lib.fill)} vs one device's "
                 f"{int(lib1.fill)}")
        for n, t in whole.items():
            if not torch.equal(t, getattr(lib1, n)[: lib1.capacity]):
                fail(f"library {n} differ from one device's build")
        retrieve(lib1, q, cfg.library)
        (v1, lab1), rms1 = timed(dev, lambda: retrieve(lib1, q, cfg.library),
                                 False)
        rec["single_retrieve_ms"] = rms1
        # the store holds repeated rows (a node sampled twice), so equal
        # scores may pick other rows: hold the scores, then the values and
        # labels of every query whose rows are the same
        s1, i1 = cosine_topk(q, lib1.keys[: lib1.capacity], k,
                             valid_mask=lib1.valid_mask)
        rec["max_abs_err"] = close("library retrieve scores", s, s1, 0,
                                   TOL_SCORE)
        same = (i.sort(dim=1).values == i1.sort(dim=1).values).all(dim=1)
        rec["tie_rows"] = int((~same).sum())

        def by_row(x, idx):     # retrieved rows in the order of their ids
            perm = idx.argsort(dim=1)[..., None]
            return torch.take_along_dim(x, perm, dim=1)[same]
        close("library retrieve values", by_row(v, i), by_row(v1, i1), 0,
              TOL_SCORE)
        close("library retrieve labels", by_row(lab, i), by_row(lab1, i1),
              0, 0)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--meshes", default="1x2,2x1")
    ap.add_argument("--parts", default="edge,retrieval,huge_k,library")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    dev = parallel.init_distributed(args.device, "gloo")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rank, world = dist.get_rank(), dist.get_world_size()
    size = SMALL if args.small else FULL
    meshes = [tuple(int(x) for x in m.split("x"))
              for m in args.meshes.split(",") if m]
    parts = args.parts.split(",")
    rec = {"rank": rank, "world": world, "device": str(dev)}
    t0 = time.perf_counter()
    if "edge" in parts:
        rec["edge"] = part_edge(meshes, size, dev, rank)
    if "retrieval" in parts:
        rec["retrieval"] = part_retrieval(size, dev, rank, world)
    if "huge_k" in parts:
        rec["huge_k"] = part_huge_k(size, dev, rank, world)
    if "library" in parts:
        rec["library"] = part_library(size, dev, rank, world)
    rec["seconds"] = time.perf_counter() - t0
    rec["host_staged"] = dict(HOST_STAGED)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    parallel.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
