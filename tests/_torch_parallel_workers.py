"""Rank processes of the port's multi-device tests. Imports no JAX.

:func:`run_world` starts ``world`` processes of this file, each joining one
gloo group through a file in the test's temporary directory (so that xdist
workers never compete for a port), and each runs a list of cases, named
functions of this module, on numpy inputs. Every rank returns its results;
the tests compare them with the JAX package on a JAX mesh of the same
shape.

    python tests/_torch_parallel_workers.py RANK WORLD INIT_FILE CASES OUT
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_world(world: int, cases: list, tmp_dir: str, timeout: float = 300,
              tag: str = "w") -> list:
    """Run ``cases`` (``[(name, function name, kwargs)]``) on a gloo world
    of ``world`` CPU ranks; returns each rank's ``{name: result}``."""
    os.makedirs(tmp_dir, exist_ok=True)
    cases_path = os.path.join(tmp_dir, f"{tag}_cases.pkl")
    with open(cases_path, "wb") as f:
        pickle.dump(cases, f)
    init = os.path.join(tmp_dir, f"{tag}_pg")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    logs = [open(os.path.join(tmp_dir, f"{tag}_rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world), init,
         cases_path, tmp_dir, tag], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        text = open(os.path.join(tmp_dir, f"{tag}_rank{bad[0]}.log")).read()
        raise RuntimeError(f"ranks {bad} of {world} failed:\n{text[-6000:]}")
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"{tag}_out{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# -- helpers (rank side) ------------------------------------------------------

def _mesh(dp, idx):
    from ragraph_tpu_torch.parallel import make_mesh
    return make_mesh(dp=dp, idx=idx, device_type="cpu")


def _t(a):
    import torch
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _gather_local(mesh, t):
    """This rank's row block made whole (for comparing sharded stores)."""
    from ragraph_tpu_torch.parallel.collectives import all_gather
    return _np(all_gather(t, mesh, "idx"))


# -- cases ----------------------------------------------------------------------

def collectives(dp, idx, x):
    """The autograd convention: every rank backpropagates 1/|idx| of a
    replicated loss of the gathered rows, and the reduce-scatter in the
    all-gather's backward sums the copies; a reduce-scatter's backward is
    an all-gather, an all-reduce's an all-reduce."""
    from ragraph_tpu_torch.parallel.collectives import (all_gather,
                                                        all_reduce,
                                                        reduce_scatter)
    from ragraph_tpu_torch.parallel.mesh import axis_index
    m = _mesh(dp, idx)
    r = axis_index(m, "idx")
    b = x.shape[0] // idx
    xl = _t(x[r * b:(r + 1) * b]).requires_grad_(True)
    full = all_gather(xl, m, "idx")
    ((full ** 2).sum() / idx).backward()
    xs = _t(x * (r + 1)).requires_grad_(True)
    part = reduce_scatter(xs, m, "idx")
    (part * (r + 1)).sum().backward()
    xa = _t(x * (r + 1)).requires_grad_(True)
    tot = all_reduce(xa, m, "idx")
    ((tot ** 2).sum() / idx).backward()
    counts = all_reduce(_t(np.full((2, 3), r + 1, np.int32)), m, "idx")
    return {"full": _np(full), "grad_gather": _np(xl.grad),
            "part": _np(part), "grad_scatter": _np(xs.grad),
            "tot": _np(tot), "grad_reduce": _np(xa.grad),
            "counts": _np(counts), "counts_dtype": str(counts.dtype)}


def mesh_info(dp, idx):
    from ragraph_tpu_torch.parallel import dp_spec, mesh_shape
    from ragraph_tpu_torch.parallel.mesh import axis_index
    m = _mesh(dp, idx)
    return {"shape": mesh_shape(m), "spec": dp_spec(m),
            "index": {a: axis_index(m, a) for a in ("dp", "idx")}}


def multislice_info(slices, dp, idx, w0, x, y, lr):
    """The (dcn, dp, idx) mesh's axes and spec, and a dp step over dcn x
    dp of a linear regression."""
    import torch
    from ragraph_tpu_torch.parallel import (dp_spec, make_dp_train_step,
                                            make_multislice_mesh, mesh_shape)
    m = make_multislice_mesh(slices, dp=dp, idx=idx, device_type="cpu")
    w = _t(w0).requires_grad_(True)
    opt = torch.optim.SGD([w], lr=lr)
    step = make_dp_train_step(
        m, lambda p, b, key: ((b[0] @ p - b[1]) ** 2).mean(), opt)
    loss = step(w, (_t(x), _t(y)))
    return {"names": tuple(m.mesh_dim_names), "shape": mesh_shape(m),
            "spec": dp_spec(m), "loss": float(loss), "w": _np(w)}


def dp_step(dp, idx, w0, x, y, lr, weighted=False):
    """One SGD step of a linear regression, its batch split over dp; with
    ``weighted`` the loss is a (numerator, count) pair over masked rows."""
    import torch
    from ragraph_tpu_torch.parallel import make_dp_train_step
    m = _mesh(dp, idx)
    w = _t(w0).requires_grad_(True)
    opt = torch.optim.SGD([w], lr=lr)

    def loss_fn(p, batch, key):
        xx, yy = batch[0], batch[1]
        per = ((xx @ p - yy) ** 2).mean(dim=1)
        if not weighted:
            return per.mean()
        mask = batch[2]
        return (per * mask).sum(), mask.sum()

    batch = (_t(x), _t(y)) if not weighted else (
        _t(x), _t(y), _t((np.arange(len(x)) % 5 != 0) & (np.arange(len(x))
                                                         < 40)).float())
    loss = make_dp_train_step(m, loss_fn, opt)(w, batch)
    return {"loss": float(loss), "w": _np(w)}


def topk(dp, idx, q, keys, k, local_method="auto", valid=None,
         score_dtype="input", rescore_pad=0):
    from ragraph_tpu_torch.parallel import shard_rows, sharded_cosine_topk
    m = _mesh(dp, idx)
    kw = {}
    if valid is not None:
        kw["valid_mask"] = shard_rows(m, _t(valid))
    s, i = sharded_cosine_topk(m, _t(q), shard_rows(m, _t(keys)), k,
                               local_method=local_method,
                               score_dtype=score_dtype,
                               rescore_pad=rescore_pad, **kw)
    return {"scores": _np(s), "idx": _np(i)}


def gather_rows(dp, idx, vals, ids):
    from ragraph_tpu_torch.parallel import shard_rows, sharded_gather_rows
    m = _mesh(dp, idx)
    return _np(sharded_gather_rows(m, shard_rows(m, _t(vals)), _t(ids)))


def retrieve(dp, idx, q, keys, values, labels, k):
    from ragraph_tpu_torch.parallel import shard_rows, sharded_retrieve
    m = _mesh(dp, idx)
    v, lab = sharded_retrieve(m, _t(q), shard_rows(m, _t(keys)),
                              shard_rows(m, _t(values)),
                              shard_rows(m, _t(labels)), k)
    return {"values": _np(v), "labels": _np(lab)}


def library_append(dp, idx, capacity, e, c, a, entries, query, k):
    """A sharded store through a list of appends, made whole, and a
    ``retrieve`` from it."""
    from ragraph_tpu_torch.parallel import (sharded_library_append,
                                            sharded_library_init)
    from ragraph_tpu_torch.rag.library import LibraryConfig, retrieve
    m = _mesh(dp, idx)
    lib = sharded_library_init(m, capacity, e, c, num_anchors=a,
                               device="cpu")
    for ent in entries:
        lib = sharded_library_append(m, lib, *(_t(x) for x in ent))
    v, lab = retrieve(lib, _t(query), LibraryConfig(retrieve_num=k))
    return {"fill": int(lib.fill),
            **{n: _gather_local(m, getattr(lib, n)) for n in
               ("keys", "values", "labels", "positions")},
            "ret_values": _np(v), "ret_labels": _np(lab)}


def library_build(dp, idx, capacity, level, seed):
    """The sharded build of a library from a synthetic dataset against the
    single-device build of the same draws, made whole; and a retrieve of
    both, with the structure-weighted search and row noise."""
    import torch
    from ragraph_tpu_torch.data.batching import stacked_batches
    from ragraph_tpu_torch.data.synthetic import synthetic_tu_dataset
    from ragraph_tpu_torch.parallel import (build_sharded_library,
                                            sharded_library_init)
    from ragraph_tpu_torch.rag.library import (LibraryConfig, build_library,
                                               library_init, retrieve)
    m = _mesh(dp, idx)
    ds = synthetic_tu_dataset(seed=11, num_graphs=12, num_classes=3,
                              feat_dim=8, min_nodes=5, max_nodes=9)
    if level == "node":     # the fewshot library's structure search
        cfg = LibraryConfig(level=level, num_inverse_sample=2,
                            num_augment_scale=1, use_positions=True,
                            num_anchors=4, structure_weight=0.001,
                            semantic_weight=0.999, retrieve_num=3)
    else:                   # the graph task's library, Gaussian noise
        cfg = LibraryConfig(level=level, num_inverse_sample=0,
                            num_augment_scale=0, use_positions=False,
                            num_anchors=4, noise_mode="gaussian",
                            toy_graph_hop=0, retrieve_num=3)
    w = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(8, 16)).astype(np.float32))

    def enc(f, adj, node_mask=None):
        return f @ w * 0.1 + adj @ f @ w

    def batches():
        return stacked_batches(ds.graphs, 4, num_classes=3,
                               num_graph_classes=3)

    lib1 = build_library(library_init(capacity, 16, 3, num_anchors=4), enc,
                         batches(), cfg, torch.Generator().manual_seed(seed))
    lib2 = build_sharded_library(
        m, sharded_library_init(m, capacity, 16, 3, num_anchors=4,
                                device="cpu"),
        enc, batches(), cfg, torch.Generator().manual_seed(seed))
    q = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=(6, 16)).astype(np.float32))
    pos = torch.from_numpy(np.random.default_rng(seed + 2).random(
        (6, 4)).astype(np.float32))
    out = {"fill": (int(lib1.fill), int(lib2.fill))}
    for n in ("keys", "values", "labels", "positions"):
        out[n] = (_np(getattr(lib1, n))[:capacity],
                  _gather_local(m, getattr(lib2, n)))
    for lib, tag in ((lib1, "single"), (lib2, "sharded")):
        v, lab = retrieve(lib, q, cfg, add_noise=True,
                          generator=torch.Generator().manual_seed(3),
                          search_positions=pos)
        out[f"retrieve_{tag}"] = (_np(v), _np(lab))
    return out


def kth(dp, idx, x, k, dtype):
    """``sharded_kth_largest`` of a column-sharded matrix, as raw bits."""
    import torch
    from ragraph_tpu_torch.parallel import sharded_kth_largest
    from ragraph_tpu_torch.parallel.mesh import axis_index
    m = _mesh(dp, idx)
    xt = _t(x).to(getattr(torch, dtype))
    cols = xt.shape[1] // idx
    i = axis_index(m, "idx")
    got = sharded_kth_largest(m, xt[:, i * cols:(i + 1) * cols].contiguous(),
                              k)
    bits = got.view(torch.int16 if dtype == "bfloat16" else torch.int32)
    return _np(bits)


def huge_k(dp, idx, q, keys_n, values, k, valid=None, bf16=False):
    import torch
    from ragraph_tpu_torch.parallel import shard_rows, sharded_huge_k_fuse
    m = _mesh(dp, idx)
    kn = _t(keys_n)
    if bf16:
        kn = kn.to(torch.bfloat16)
    vm = None if valid is None else shard_rows(m, _t(valid))
    mean, count = sharded_huge_k_fuse(m, _t(q), shard_rows(m, kn),
                                      shard_rows(m, _t(values)), k,
                                      valid_mask=vm)
    return {"mean": _np(mean), "count": _np(count)}


def propagate(dp, idx, send, recv, w, emb, layers):
    """Sharded LightGCN layers and the embedding gradient of a replicated
    loss, with the local walk plans' long rows of each order."""
    import torch
    from ragraph_tpu_torch.parallel import (shard_edges_by_receiver,
                                            sharded_lightgcn_propagate)
    from ragraph_tpu_torch.parallel.dp import backward_global_mean, sync_grads
    from ragraph_tpu_torch.parallel.mesh import axis_index
    m = _mesh(dp, idx)
    n = emb.shape[0]
    sh = shard_edges_by_receiver(send, recv, w, n, idx)
    x = _t(emb).requires_grad_(True)
    outs = sharded_lightgcn_propagate(m, x, sh, layers, bf16=False)
    loss = (sum(outs) ** 2).sum()
    backward_global_mean(m, loss)
    sync_grads(m, [x])
    local = sh.local(axis_index(m, "idx"), x.device)
    return {"layers": [_np(h) for h in outs], "grad": _np(x.grad),
            "recv_long": _np(local.recv_plan.long_rows),
            "send_long": _np(local.send_plan.long_rows),
            "edges_per_shard": sh.edges_per_shard}


def edge_step(dp, idx, cls_name, phase, cfg_kw, tparams, batch, masks,
              resources=None, steps=1):
    """``steps`` EdgeTrainer steps with the tables placed over idx and the
    batch over dp (``dp=0``: one device, no mesh); the losses, the whole
    params, and each replicated leaf as this rank holds it."""
    import torch
    from ragraph_tpu_torch.convert import params_from_jax
    from ragraph_tpu_torch.data.edgelist import load_edge_dataset
    from ragraph_tpu_torch.data.synthetic import synthetic_edge_stream
    from ragraph_tpu_torch.models import edge as tedge
    from ragraph_tpu_torch.train.trainer import EdgeTrainer, param_leaves
    m = _mesh(dp, idx) if dp else None
    train, stages = synthetic_edge_stream(seed=0)
    ds = load_edge_dataset(train, stages[0])
    g = tedge.EdgeGraphArrays.from_dataset(ds, "cpu")
    if idx > 1:
        g = g.with_sharding(idx)
    model = getattr(tedge, cls_name)(tedge.EdgeModelConfig(**cfg_kw), g,
                                     phase=phase, mesh=m)
    if resources is not None:
        model.resource_keys, model.resource_values = (
            _t(r) for r in resources)
    trainer = EdgeTrainer(model, ds, logger=lambda *a, **k: None, mesh=m)
    params, opt = trainer.prepare(params_from_jax(tparams, "cpu"))
    losses = []
    for _ in range(steps):
        loss, _ = trainer.step(params, opt, tuple(_t(b) for b in batch),
                               None, edge_masks=tuple(_t(x) for x in masks))
        losses.append(float(loss))
    whole = trainer.whole_params(params)
    return {"losses": losses,
            "params": {n: _np(t) for n, t in param_leaves(whole)},
            "local": {n: _np(t) for n, t in param_leaves(params)
                      if not trainer._is_table(n, t)}}


def trainer_resume(dp, idx, ck_dir, epochs_a, epochs_b):
    """Train ``epochs_a`` epochs with a checkpoint, then resume to
    ``epochs_b``, on the mesh; and (rank 0) the same on one device."""
    import torch
    from ragraph_tpu_torch.data.edgelist import load_edge_dataset
    from ragraph_tpu_torch.data.synthetic import synthetic_edge_stream
    from ragraph_tpu_torch.models import edge as tedge
    from ragraph_tpu_torch.parallel import barrier, is_writer
    from ragraph_tpu_torch.train.trainer import EdgeTrainer
    m = _mesh(dp, idx)
    train, stages = synthetic_edge_stream(seed=1, num_users=24, num_items=40,
                                          num_stages=1)
    ds = load_edge_dataset(train, [(u, i) for (u, i, *_) in stages[0]])
    cfg = tedge.EdgeModelConfig(emb_size=8, num_layers=2, batch_size=32,
                                edge_dropout=0.2, early_stop_patience=100)
    g = tedge.EdgeGraphArrays.from_dataset(ds, "cpu")

    def run(mesh, n, ck):
        arrays = g.with_sharding(idx) if mesh is not None else g
        model = tedge.GraphPro(cfg, arrays, phase="pretrain", mesh=mesh)
        params = model.init_params(torch.Generator().manual_seed(0))
        t = EdgeTrainer(model, ds, logger=lambda *a, **k: None, mesh=mesh)
        r = t.train(params, torch.Generator().manual_seed(1), num_epochs=n,
                    rng=np.random.default_rng(7), checkpoint_dir=ck,
                    checkpoint_every=epochs_a)
        return ({n: _np(t) for n, t in r.best_params.items()},
                [h["loss"] for h in r.history], r.epochs_run)

    out = {}
    run(m, epochs_a, os.path.join(ck_dir, "mesh"))
    barrier()           # rank 0's checkpoint is on disk for every rank
    out["mesh"] = run(m, epochs_b, os.path.join(ck_dir, "mesh"))
    if is_writer():
        run(None, epochs_a, os.path.join(ck_dir, "single"))
        out["single"] = run(None, epochs_b, os.path.join(ck_dir, "single"))
    return out


def restore(dp, idx, path, table, gate):
    import torch
    from ragraph_tpu_torch.parallel import shard_rows
    from ragraph_tpu_torch.train.checkpoint import (restore_sharded,
                                                    save_checkpoint)
    from ragraph_tpu_torch.parallel import barrier, is_writer
    m = _mesh(dp, idx)
    if is_writer():
        save_checkpoint(path, {"user_embedding": _t(table),
                               "gate": _t(gate), "step": 7})
    barrier()
    template = {"user_embedding": shard_rows(m, torch.zeros(table.shape)),
                "gate": torch.zeros(gate.shape, dtype=torch.float64),
                "step": 0}
    out = restore_sharded(path, template, m)
    return {"user_embedding": _np(out["user_embedding"]),
            "gate": _np(out["gate"]), "gate_dtype": str(out["gate"].dtype),
            "step": out["step"]}


def cli(argv_module, argv, spy=None):
    """A CLI's ``main`` in this rank, with ``spy`` (``"huge_k"``) counting
    the sharded huge-k fusion's calls and forcing every retrieval into the
    huge-k branch."""
    import importlib
    mod = importlib.import_module(argv_module)
    calls = {"n": 0}
    if spy == "huge_k":
        from ragraph_tpu_torch.models.edge import ragraph_edge
        from ragraph_tpu_torch.parallel import sharded_selection
        ragraph_edge._BIG_K_ELEMS = 0
        real = sharded_selection.sharded_huge_k_fuse

        def counted(*a, **kw):
            calls["n"] += 1
            return real(*a, **kw)
        sharded_selection.sharded_huge_k_fuse = counted
    out = mod.main(argv)
    if hasattr(out, "recalls"):
        out = (out.recalls, out.ndcgs)
    return {"out": out, "calls": calls["n"]}


def main() -> int:
    rank, world, init, cases_path, out_dir, tag = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5], sys.argv[6])
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    results = {}
    for name, fn, kwargs in cases:
        results[name] = globals()[fn](**kwargs)
        dist.barrier()
    with open(os.path.join(out_dir, f"{tag}_out{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
