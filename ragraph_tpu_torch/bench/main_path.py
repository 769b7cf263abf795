"""The main path's steps beside plain PyTorch ops, one JSON line.

    python -m ragraph_tpu_torch.bench.main_path [--device cpu --small]

At U = I = 131,072 nodes, 2^20 interactions (2^21 directed edges), D = 64,
3 layers, batch 2,048, random tables from a seed:

- a pretrain step (forward, backward, Adam apart) and a finetune step
  (which retrieves for all 262,144 nodes through kernel C), each beside the
  same step on plain ops: ``index_add_`` propagation in f32 with autograd's
  backward, and an f32 ``matmul`` + ``torch.topk`` retrieval;
- the exact top-k of one 2,048-query chunk against R = 262,144 rows, k = 10,
  through kernel C and through the bucket kernels D-G, beside the f32
  ``matmul`` + ``torch.topk``.

``chip_smoke.py`` takes its input data and its step timings from here.
"""

from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np
import torch

from ragraph_tpu_torch import native
from ragraph_tpu_torch.bench import timing
from ragraph_tpu_torch.convert import params_from_jax
from ragraph_tpu_torch.data.edgelist import load_edge_dataset
from ragraph_tpu_torch.device import resolve_device
from ragraph_tpu_torch.models.edge import (EdgeGraphArrays, EdgeModelConfig,
                                           RAGraphEdge)
from ragraph_tpu_torch.ops import topk
from ragraph_tpu_torch.ops.bucket_topk import bucketed_exact_topk
from ragraph_tpu_torch.ops.fused_retrieval import fused_cosine_topk
from ragraph_tpu_torch.ops.similarity import l2_normalize
from ragraph_tpu_torch.train.trainer import EdgeTrainer

U = I = 1 << 17
M = 1 << 20                 # interactions; 2^21 directed edges
D = 64
FT_ROWS = 1 << 15           # a stage's finetune split
K = 10
SMALL = dict(n_users=256, n_items=256, n_inter=4096, ft_rows=512, batch=128)


def make_rows(rng, n_users, n_items, n_inter):
    """Training rows ``(user, item, time)`` and two test items per user."""
    t0 = 1_600_000_000
    users = rng.integers(0, n_users, n_inter)
    items = rng.integers(0, n_items, n_inter)
    times = t0 + rng.integers(0, 30 * 24 * 3600, n_inter)
    train = list(zip(users.tolist(), items.tolist(), times.tolist()))
    tu = np.repeat(np.arange(n_users), 2)
    ti = rng.integers(0, n_items, len(tu))
    test = list(zip(tu.tolist(), ti.tolist()))
    return train, test


def xavier_tables(rng, n_users, n_items, d):
    def one(n):
        b = math.sqrt(6.0 / (n + d))
        return rng.uniform(-b, b, (n, d)).astype(np.float32)
    return {"user_embedding": one(n_users), "item_embedding": one(n_items)}


def finetune_rows(rng, n_users=U, n_items=I, n_rows=FT_ROWS):
    """A stage-sized finetune split and its test rows, after the pretrain
    rows in time."""
    t0 = 1_600_000_000 + 30 * 24 * 3600
    users = rng.integers(0, n_users, n_rows)
    items = rng.integers(0, n_items, n_rows)
    times = t0 + rng.integers(0, 24 * 3600, n_rows)
    ft = list(zip(users.tolist(), items.tolist(), times.tolist()))
    tu = rng.choice(n_users, max(n_users // 8, 1), replace=False)
    ti = rng.integers(0, n_items, len(tu))
    stage = list(zip(tu.tolist(), ti.tolist(),
                     (t0 + 24 * 3600 + np.arange(len(tu))).tolist()))
    return ft, stage


def time_step(model, params, batch, gen, reps, device="cuda"):
    """Milliseconds of one training step's forward (``cal_loss``), backward
    and Adam update, each between its own marks, averaged over ``reps``."""
    trainer = EdgeTrainer(model, None, logger=lambda *_: None)
    leaves, optimizer = trainer.prepare(params)
    graph, resources = trainer._graph_and_resources()
    box = {}

    def forward():
        optimizer.zero_grad(set_to_none=True)
        box["loss"], _ = model.cal_loss(leaves, batch, gen, graph=graph,
                                        resources=resources)

    fwd, bwd, opt = timing.split_ms(
        [forward, lambda: box["loss"].backward(), optimizer.step], reps,
        device)
    return {"forward": fwd, "backward": bwd, "optimizer": opt,
            "step": fwd + bwd + opt}


def step_timings(ft_model, ft_params, model, params, batch, gen,
                 device="cuda", reps=(10, 3, 5, 2)) -> dict:
    """A pretrain step and a finetune step, then the same two on plain
    PyTorch ops (``index_add_`` propagation in f32, matmul + ``torch.topk``
    retrieval). The models' configurations are restored afterwards."""
    out = {"pretrain_step_ms": time_step(model, params, batch, gen, reps[0],
                                         device),
           "finetune_step_ms": time_step(ft_model, ft_params, batch, gen,
                                         reps[1], device)}
    threshold = topk.AUTO_APPROX_THRESHOLD
    cfgs = [m.cfg for m in (model, ft_model)]
    for m in (model, ft_model):
        m.cfg = dataclasses.replace(m.cfg, segsum_impl="scatter",
                                    propagate_dtype="f32")
    topk.AUTO_APPROX_THRESHOLD = 1 << 62    # "auto" takes matmul + topk
    try:
        out["pretrain_step_plain_ms"] = time_step(model, params, batch, gen,
                                                  reps[2], device)
        out["finetune_step_plain_ms"] = time_step(ft_model, ft_params, batch,
                                                  gen, reps[3], device)
    finally:
        topk.AUTO_APPROX_THRESHOLD = threshold
        for m, cfg in zip((model, ft_model), cfgs):
            m.cfg = cfg
    return out


def topk_timings(q, keys, k, device="cuda") -> dict:
    """The exact top-k of unit ``q (Q, E)`` against unit ``keys (R, E)``
    through kernel C, through kernels D-G, and by an f32 matmul and
    ``torch.topk``."""
    qb, kb = q.to(torch.bfloat16).float(), keys.to(torch.bfloat16).float()
    scores = qb @ kb.T
    out = {
        "fused_kernel_C": timing.timed_ms(
            lambda: fused_cosine_topk(q, keys, k), reps=10, device=device),
        "bucket_kernels_D_to_G": timing.timed_ms(
            lambda: bucketed_exact_topk(q, keys, k), reps=10, device=device),
        "plain_f32_matmul": timing.timed_ms(
            lambda: torch.matmul(qb, kb.T), reps=5, device=device),
        "plain_topk": timing.timed_ms(
            lambda: torch.topk(scores, k, dim=1), reps=5, device=device)}
    out["plain_f32_matmul_topk"] = out["plain_f32_matmul"] + out["plain_topk"]
    return out


def build(device, small: bool = False, seed: int = 0):
    """The pretrain and the finetune model with their parameters and one
    batch, on random data of the main path's size."""
    size = SMALL if small else dict(n_users=U, n_items=I, n_inter=M,
                                    ft_rows=FT_ROWS, batch=2048)
    n_u, n_i = size["n_users"], size["n_items"]
    rng = np.random.default_rng(seed)
    train, test = make_rows(rng, n_u, n_i, size["n_inter"])
    ds = load_edge_dataset(train, test, num_users=n_u, num_items=n_i)
    cfg = EdgeModelConfig(emb_size=D, num_layers=3, batch_size=size["batch"])
    model = RAGraphEdge(cfg, EdgeGraphArrays.from_dataset(ds, device),
                        phase="pretrain")
    params = params_from_jax(xavier_tables(rng, n_u, n_i, D), device)
    first = next(ds.train_batches(cfg.batch_size,
                                  np.random.default_rng(seed + 1)))
    batch = tuple(torch.from_numpy(a).to(device) for a in first)

    ft_rows, stage_rows = finetune_rows(rng, n_u, n_i, size["ft_rows"])
    ft_ds = load_edge_dataset(ft_rows, stage_rows, num_users=n_u,
                              num_items=n_i, phase="finetune")
    ft_model = RAGraphEdge(cfg, EdgeGraphArrays.from_dataset(ft_ds, device),
                           phase="finetune")
    pre = (params["user_embedding"], params["item_embedding"])
    ft_model.make_resource_graph(*pre)
    ft_params = ft_model.init_params(
        torch.Generator(device).manual_seed(seed + 2), pretrained_tables=pre)
    return ft_model, ft_params, model, params, batch


def run(device, small: bool = False, seed: int = 0) -> dict:
    ft_model, ft_params, model, params, batch = build(device, small, seed)
    gen = torch.Generator(device).manual_seed(seed + 3)
    native.reset_launches()
    reps = (2, 1, 1, 1) if small else (10, 3, 5, 2)
    steps = step_timings(ft_model, ft_params, model, params, batch, gen,
                         device, reps)
    n = model.graph.num_nodes
    q = l2_normalize(torch.randn(min(model.cfg.batch_size, n), D,
                                 generator=gen, device=device))
    keys = l2_normalize(torch.randn(n, D, generator=gen, device=device))
    tk = topk_timings(q, keys, K, device)
    for name, parts in steps.items():
        print(f"{name:26s} forward {parts['forward']:9.3f} backward "
              f"{parts['backward']:8.3f} optimizer {parts['optimizer']:7.3f} "
              f"step {parts['step']:9.3f}")
    for name, t in tk.items():
        print(f"top-{K} {name:24s} {t:9.3f}")
    return {"bench": "main_path", "users": model.graph.num_users,
            "items": model.graph.num_items, "edges": model.graph.num_edges,
            "D": D, "layers": model.cfg.num_layers,
            "batch": model.cfg.batch_size, "topk_Q": int(q.shape[0]),
            "topk_R": n, "k": K, "device": timing.device_record(device),
            timing.times_key(device): {**steps, "exact_topk": tk},
            "launches": dict(native.LAUNCHES)}


def main(argv=None) -> dict:
    args = timing.bench_parser(__doc__.splitlines()[0]).parse_args(argv)
    device = resolve_device(args.device or "cuda")
    return timing.emit(run(device, args.small, args.seed), args.out)


if __name__ == "__main__":
    main()
    sys.exit(0)
