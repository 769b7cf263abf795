#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its serving path on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. build every kernel in ``ragraph_tpu_torch/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged small shapes;
3. drive the RAGraph-edge serving path at serving scale (U = I = 131,072,
   2^20 interactions, D = 64, 3 layers): ``generate`` -> library ->
   ``generate`` with RAG -> recall/ndcg@20 -> ``recommend_from``; count each
   kernel's launches in that run and require every count to be positive;
4. run a small graph through the same path on the card and on the CPU
   (plain versions) and require the embeddings to agree; run the
   ``vanilla`` CLI on the synthetic stream on the card;
5. time each kernel, its plain version and one PyTorch library call that
   computes the same function, beside its bound.

It prints per-stage milliseconds, a ``{"kernels": [...]}`` line, the card's
name and power limit, and last ``{"ok": true, "device": {...}}``. It imports
nothing of JAX and needs the repository beside it.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import warnings

import numpy as np

SEED = 0
U = I = 1 << 17
M = 1 << 20                 # interactions; 2^21 directed edges
D = 64
CHUNK = 2048                # EdgeModelConfig().batch_size: one RAG chunk
HBM_BYTES_PER_MS = 3.35e9   # H100 SXM: 3.35 TB/s
BF16_FLOP_PER_MS = 989e9    # dense bf16 tensor-core peak
F32_FLOP_PER_MS = 67e9      # f32 outside the tensor cores

# Tolerances: |err| <= atol + rtol * max|plain|.
TOL_SEGSUM = (1e-5, 1e-6)   # f32 sums of the same terms in another order
TOL_E2E = (1e-5, 1e-6)      # small-graph embeddings, card vs CPU, f32
TOL_SCORE = 1e-5            # exact bf16 products, f32 sums of <= 256 terms


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class StageTimer:
    """Per-stage milliseconds between CUDA events recorded on an idle
    stream before a stage and after it; a stage's host work (evaluation
    bookkeeping, PageRank's convergence checks) falls between them too."""

    def __init__(self):
        self.ms = {}

    def __call__(self, name, fn):
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        self.ms[name] = start.elapsed_time(end)
        return out


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


def check_close(name, got, ref, rtol_atol):
    import torch
    rtol, atol = rtol_atol
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    tol = atol + rtol * (float(ref.abs().max()) if ref.numel() else 0.0)
    ok = bool(torch.isfinite(got).all()) and err <= tol
    print(f"  {name}: max_abs_err={err:.3e} tol={tol:.3e} "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def check_topk(name, q, keys, k, valid=None):
    """Kernel C against its plain version: scores within TOL_SCORE, and
    where the indices differ, the kernel's pick must score within
    TOL_SCORE of the plain pick (a tie)."""
    import torch

    from ragraph_tpu_torch.ops.fused_retrieval import (
        NEG_INF, fused_cosine_topk, fused_cosine_topk_plain)
    s, i = fused_cosine_topk(q, keys, k, valid_mask=valid)
    torch.cuda.synchronize()
    ps, pi = fused_cosine_topk_plain(q, keys, k, valid_mask=valid)
    err = float((s - ps).abs().max())
    bad = err > TOL_SCORE or not bool(torch.isfinite(s).all())
    # no key twice in a row's live entries
    live_i = torch.where(s > NEG_INF, i.long(),
                         -1 - torch.arange(k, device=i.device))
    srt = torch.sort(live_i, dim=1).values
    bad |= bool((srt[:, 1:] == srt[:, :-1]).any())
    diff = i != pi
    n_tie = int(diff.sum())
    if n_tie:
        qb = q.to(torch.bfloat16).float()
        kb = keys.to(torch.bfloat16).float()
        rows = diff.nonzero()[:, 0]
        true = (qb[rows] * kb[i[diff].long()]).sum(1)
        live = ps[diff] > NEG_INF
        tie_err = float(((true - ps[diff]).abs() * live).max())
        bad |= tie_err > TOL_SCORE
        bad |= bool(((s[diff] <= NEG_INF) & (i[diff] != 0)).any())
    print(f"  {name}: max_abs_err={err:.3e} tol={TOL_SCORE:.0e} "
          f"index_ties={n_tie} {'ok' if not bad else 'MISMATCH'}", flush=True)
    if bad:
        fail(f"{name} disagrees with its plain version")
    return err


def segsum_checks(rng, dev, n, e, d, hub):
    """Kernels A (bf16, f32, backward) and B on a ragged random graph."""
    import torch

    from ragraph_tpu_torch.ops import csr_segment as cs
    recv = np.sort(rng.integers(0, n, e))
    if hub:  # one long segment: many passes of the 32-edge loop
        recv[: e // 3] = n // 2
        recv = np.sort(recv)
    send = rng.integers(0, n, e)
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr[1:], recv, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    perm = np.argsort(send, kind="stable")
    sip = np.zeros(n + 1, np.int64)
    np.add.at(sip[1:], send, 1)
    sip = np.cumsum(sip).astype(np.int32)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    table = t(rng.normal(size=(n, d)), torch.float32)
    w_np = rng.random(e)
    w = t(w_np, torch.float32)
    idx, ip = t(send, torch.int32), t(indptr, torch.int32)
    args = (w, t(w_np[perm], torch.float32), idx, ip,
            t(recv[perm], torch.int32), t(sip, torch.int32))
    tag = f"n={n} E={e} D={d}"
    for bf16 in (True, False):
        got = cs.gather_scale_segsum(table, *args, bf16=bf16)
        ref = cs.gather_scale_segsum_plain(table, w, idx, ip, bf16)
        check_close(f"A bf16={bf16} {tag}", got, ref, TOL_SEGSUM)
    # backward: the same kernel on the sender-order arrays
    x = table.clone().requires_grad_(True)
    ct = t(rng.normal(size=(n, d)), torch.float32)
    cs.gather_scale_segsum(x, *args, bf16=False).backward(ct)
    xp = table.clone().requires_grad_(True)
    cs.gather_scale_segsum_plain(xp, w, idx, ip, False).backward(ct)
    check_close(f"A backward {tag}", x.grad, xp.grad, TOL_SEGSUM)
    msgs = t(rng.normal(size=(e, d)), torch.float32)
    got = cs.sorted_segment_sum_grad(msgs, ip, t(recv, torch.int32))
    check_close(f"B {tag}", got, cs.segment_sum_plain(msgs, ip), TOL_SEGSUM)


def phase_kernel_checks(rng, dev, graph):
    import torch

    from ragraph_tpu_torch.ops import csr_segment as cs
    from ragraph_tpu_torch.ops.fused_retrieval import fused_cosine_topk
    from ragraph_tpu_torch.ops.similarity import l2_normalize
    print("phase 2: kernels against their plain versions", flush=True)
    errs = {}
    g = graph
    w = g.edge_norm * 0.5 + g.time_norm * 0.5
    w_send = g.edge_norm_send * 0.5 + g.time_norm_send * 0.5
    table = torch.randn(g.num_nodes, D, generator=torch.Generator(dev)
                        .manual_seed(SEED), device=dev)
    args = (w, w_send, g.senders, g.recv_indptr, g.recv_of_send,
            g.send_indptr)
    errs["A"] = 0.0
    for bf16 in (True, False):
        got = cs.gather_scale_segsum(table, *args, bf16=bf16)
        ref = cs.gather_scale_segsum_plain(table, w, g.senders,
                                           g.recv_indptr, bf16)
        err = check_close(f"A bf16={bf16} main shape", got, ref, TOL_SEGSUM)
        if bf16:
            errs["A"] = err
    msgs = table[g.senders.long()] * g.edge_norm[:, None]
    got = cs.sorted_segment_sum_grad(msgs, g.recv_indptr, g.receivers)
    errs["B"] = check_close("B main shape", got,
                            cs.segment_sum_plain(msgs, g.recv_indptr),
                            TOL_SEGSUM)
    del msgs, got
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    q = l2_normalize(torch.randn(CHUNK, D, generator=gen, device=dev))
    keys = l2_normalize(torch.randn(g.num_nodes, D, generator=gen,
                                    device=dev))
    errs["C"] = check_topk(f"C Q={CHUNK} R={g.num_nodes} k=10", q, keys, 10)

    for n, e, d, hub in ((37, 1001, 64, False), (300, 4099, 18, True),
                         (5, 3, 2, False), (64, 777, 130, True),
                         (129, 2000, 256, False)):
        segsum_checks(rng, dev, n, e, d, hub)
    for q_len, r_len, e, k, n_valid in (
            (1, 1000, 64, 10, None), (77, 1000, 64, 1, None),
            (130, 4097, 64, 50, None), (65, 3000, 64, 128, None),
            (33, 1000, 64, 10, 400), (9, 500, 64, 10, 5),
            (3, 3, 64, 10, None), (70, 1234, 8, 10, None),
            (40, 900, 136, 50, None), (20, 700, 256, 128, 300)):
        q = l2_normalize(torch.randn(q_len, e, generator=gen, device=dev))
        keys = l2_normalize(torch.randn(r_len, e, generator=gen, device=dev))
        valid = None
        if n_valid is not None:
            valid = torch.zeros(r_len, dtype=torch.bool, device=dev)
            valid[torch.randperm(r_len, generator=gen,
                                 device=dev)[:n_valid]] = True
        check_topk(f"C Q={q_len} R={r_len} E={e} k={k} valid={n_valid}",
                   q, keys, k, valid)
    # exact ties: duplicated keys must come out lowest index first
    keys = l2_normalize(torch.randn(1, 64, generator=gen, device=dev))
    keys = keys.repeat(300, 1)
    q = l2_normalize(torch.randn(4, 64, generator=gen, device=dev))
    check_topk("C ties R=300 k=10", q, keys, 10)
    _, i = fused_cosine_topk(q, keys, 10)
    if not bool((i == torch.arange(10, device=dev)).all()):
        fail(f"C ties: expected indices 0..9, got {i[0].tolist()}")
    return errs


def phase_main_path(dev, ds, graph, params):
    import torch

    from ragraph_tpu_torch import native
    from ragraph_tpu_torch.models.edge import EdgeModelConfig, RAGraphEdge
    from ragraph_tpu_torch.train.metrics import RankingEvaluator
    print("phase 3: serving path at U = I = 131,072, 2^21 edges, D = 64",
          flush=True)
    cfg = EdgeModelConfig(emb_size=D, num_layers=3)
    model = RAGraphEdge(cfg, graph, phase="vanilla")
    gen = torch.Generator(dev).manual_seed(SEED)
    timer = StageTimer()
    native.reset_launches()
    u0, i0 = timer("generate", lambda: model.generate(params))
    keys, values = timer("make_resource_graph",
                         lambda: model.make_resource_graph(u0, i0, gen))
    ue, ie = timer("generate_rag", lambda: model.generate(params))
    result = timer("evaluate_recall_ndcg_at_20",
                   lambda: RankingEvaluator(ks=(20,)).evaluate(
                       ue, ie, ds.test_user_dict, ds.user_hist_dict))
    requests = {}
    rng = np.random.default_rng(SEED + 2)
    for b in (256, 4096):
        users = rng.choice(U, b, replace=False)
        rows, cols = [], []
        for r, u in enumerate(users.tolist()):
            hist = ds.user_hist_dict.get(u, [])
            rows += [r] * len(hist)
            cols += hist
        requests[b] = (users, torch.from_numpy(users).to(dev),
                       torch.tensor(rows, dtype=torch.int64, device=dev),
                       torch.tensor(cols, dtype=torch.int64, device=dev))
    recs = {}
    for b, (users, uid, hr, hc) in requests.items():
        recs[b] = (users, timer(f"recommend_from_B{b}", lambda: model
                                .recommend_from(ue, ie, uid, k=20,
                                                hist_rows=hr, hist_cols=hc)))
    launches = dict(native.LAUNCHES)

    # the same stages again, warm: the first pass also pays first-call
    # allocations
    model.resource_keys = model.resource_values = None
    timer("generate_warm", lambda: model.generate(params))
    timer("make_resource_graph_warm",
          lambda: model.make_resource_graph(u0, i0, gen))
    timer("generate_rag_warm", lambda: model.generate(params))
    for b, (users, uid, hr, hc) in requests.items():
        timer(f"recommend_from_B{b}_warm", lambda: model.recommend_from(
            ue, ie, uid, k=20, hist_rows=hr, hist_cols=hc))

    for name, t, shape in (("generate user", u0, (U, D)),
                           ("generate item", i0, (I, D)),
                           ("library keys", keys, (U + I, D)),
                           ("library values", values, (U + I, D)),
                           ("rag user", ue, (U, D)), ("rag item", ie, (I, D))):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            fail(f"{name}: shape {tuple(t.shape)} (want {shape}) or "
                 f"non-finite values")
    if float((ue - u0).abs().max()) == 0.0:
        fail("RAG fusion left the user embeddings unchanged")
    recall = float(result["recall"][0])
    ndcg = float(result["ndcg"][0])
    if not (math.isfinite(recall) and math.isfinite(ndcg)):
        fail(f"recall@20={recall} ndcg@20={ndcg} not finite")
    for b, (users, (s, items)) in recs.items():
        if not bool(torch.isfinite(s).all()):
            fail(f"recommend_from B={b}: non-finite scores")
        items = items.cpu().numpy()
        for r, u in enumerate(users.tolist()):
            if set(items[r].tolist()) & set(ds.user_hist_dict.get(u, [])):
                fail(f"recommend_from B={b}: history item returned "
                     f"for user {u}")
    print(f"  recall@20={recall:.6f} ndcg@20={ndcg:.6f}", flush=True)
    print(json.dumps({"stages_ms": timer.ms, "recall@20": recall,
                      "ndcg@20": ndcg}), flush=True)
    print(json.dumps({"launches": launches}), flush=True)
    want = {"csr_gather_scale_segsum": 6, "csr_segment_sum": 3,
            "fused_cosine_topk": -(-(U + I) // CHUNK)}
    for name, n in want.items():
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the main path")
        if launches[name] != n:
            print(f"  note: {name} launched {launches[name]} times, "
                  f"expected {n}", flush=True)
    return launches


def phase_small_agreement(dev):
    """The same path on a small graph, on the card and on the CPU."""
    import torch

    from ragraph_tpu_torch.convert import params_from_jax
    from ragraph_tpu_torch.data.edgelist import load_edge_dataset
    from ragraph_tpu_torch.models.edge import (EdgeGraphArrays,
                                               EdgeModelConfig, RAGraphEdge)
    print("phase 4: small graph, card against CPU", flush=True)
    rng = np.random.default_rng(SEED + 3)
    train, test = make_rows(rng, 256, 256, 4096)
    ds = load_edge_dataset(train, test, num_users=256, num_items=256)
    tables = xavier_tables(rng, 256, 256, D)
    cfg = EdgeModelConfig(emb_size=D, segsum_impl="fused",
                          propagate_dtype="f32")
    out = {}
    for where in (dev, torch.device("cpu")):
        g = EdgeGraphArrays.from_dataset(ds, where)
        model = RAGraphEdge(cfg, g, phase="vanilla")
        params = params_from_jax(tables, where)
        u0, i0 = model.generate(params)
        model.make_resource_graph(u0, i0)
        out[where.type] = [t.cpu() for t in model.generate(params)]
    for name, a, b in zip(("user", "item"), out["cuda"], out["cpu"]):
        check_close(f"small graph {name} embeddings", a, b, TOL_E2E)


def phase_cli(dev):
    """The port's ``vanilla`` CLI on the synthetic stream, on the card."""
    import tempfile

    from ragraph_tpu_torch.cli import edge as cli
    from ragraph_tpu_torch.train.checkpoint import save_checkpoint
    print("phase 4: vanilla CLI on the card (synthetic stream)", flush=True)
    rng = np.random.default_rng(SEED + 5)
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(f"{tmp}/pretrain_RAGraph_SYNTH",
                        xavier_tables(rng, 64, 128, D))
        recalls, ndcgs = cli.main(["vanilla", "--data-path", "SYNTH",
                                   "--save-dir", tmp,
                                   "--device", str(dev)])
    if len(recalls) != 4 or not np.isfinite(recalls + ndcgs).all():
        fail(f"vanilla CLI: recalls {recalls} ndcgs {ndcgs}")
    print(f"  recall@20 per stage {recalls}", flush=True)


def phase_timing(dev, graph, errs, launches):
    import torch

    from ragraph_tpu_torch.ops import csr_segment as cs
    from ragraph_tpu_torch.ops.fused_retrieval import (
        fused_cosine_topk, fused_cosine_topk_plain)
    from ragraph_tpu_torch.ops.similarity import l2_normalize
    print("phase 5: timing at the main path's shapes", flush=True)
    g = graph
    n, e = g.num_nodes, g.num_edges
    gen = torch.Generator(dev).manual_seed(SEED + 4)
    table = torch.randn(n, D, generator=gen, device=dev)
    w = g.edge_norm * 0.5 + g.time_norm * 0.5
    w_send = g.edge_norm_send * 0.5 + g.time_norm_send * 0.5
    args = (w, w_send, g.senders, g.recv_indptr, g.recv_of_send,
            g.send_indptr)
    kernels = []

    # A: gather_scale_segsum, bf16 (the main path's setting)
    a_ms = cuda_ms(lambda: cs.gather_scale_segsum(table, *args, bf16=True))
    a_plain = cuda_ms(lambda: cs.gather_scale_segsum_plain(
        table, w, g.senders, g.recv_indptr, True), reps=5)
    tb = table.to(torch.bfloat16).float()
    wb = w.to(torch.bfloat16).float()
    with warnings.catch_warnings():    # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(g.recv_indptr.long(), g.senders.long(),
                                      wb, size=(n, n))
    a_lib = cuda_ms(lambda: torch.sparse.mm(csr, tb), reps=5)
    a_bytes = 4 * n * D + 4 * e + 4 * e + 4 * (n + 1) + 4 * n * D
    a_ops = 2 * e * D
    kernels.append(dict(
        name="csr_gather_scale_segsum", route="cuda",
        source="ragraph_tpu_torch/csrc/csr_segment.cu",
        replaces="ragraph_tpu/ops/pallas_segment.py:199",
        launches=launches.get("csr_gather_scale_segsum", 0),
        max_abs_err=errs["A"], ms=a_ms, plain_ms=a_plain,
        bound_ms=max(a_bytes / HBM_BYTES_PER_MS, a_ops / F32_FLOP_PER_MS),
        bound_by="bytes" if a_bytes / HBM_BYTES_PER_MS
        >= a_ops / F32_FLOP_PER_MS else "operations",
        library_ms=a_lib))
    del csr, tb

    # B: sorted_segment_sum_grad on pre-scaled f32 messages
    msgs = table[g.senders.long()] * g.edge_norm[:, None]
    b_ms = cuda_ms(lambda: cs.sorted_segment_sum_grad(msgs, g.recv_indptr,
                                                      g.receivers))
    b_plain = cuda_ms(lambda: cs.segment_sum_plain(msgs, g.recv_indptr),
                      reps=5)
    lengths = (g.recv_indptr[1:] - g.recv_indptr[:-1]).long()
    b_lib = cuda_ms(lambda: torch.segment_reduce(msgs, "sum",
                                                 lengths=lengths, axis=0),
                    reps=5)
    b_bytes = 4 * e * D + 4 * (n + 1) + 4 * n * D
    b_ops = e * D
    kernels.append(dict(
        name="csr_segment_sum", route="cuda",
        source="ragraph_tpu_torch/csrc/csr_segment.cu",
        replaces="ragraph_tpu/ops/pallas_segment.py:169",
        launches=launches.get("csr_segment_sum", 0),
        max_abs_err=errs["B"], ms=b_ms, plain_ms=b_plain,
        bound_ms=max(b_bytes / HBM_BYTES_PER_MS, b_ops / F32_FLOP_PER_MS),
        bound_by="bytes" if b_bytes / HBM_BYTES_PER_MS
        >= b_ops / F32_FLOP_PER_MS else "operations",
        library_ms=b_lib))
    del msgs

    # C: one RAG chunk of 2,048 queries against the 262,144-row library
    q = l2_normalize(torch.randn(CHUNK, D, generator=gen, device=dev))
    keys = l2_normalize(torch.randn(n, D, generator=gen, device=dev))
    c_ms = cuda_ms(lambda: fused_cosine_topk(q, keys, 10), reps=10)
    c_plain = cuda_ms(lambda: fused_cosine_topk_plain(q, keys, 10), reps=3,
                      warmup=1)
    qb = q.to(torch.bfloat16).float()
    kb = keys.to(torch.bfloat16).float()
    scores = qb @ kb.T
    c_mm = cuda_ms(lambda: torch.matmul(qb, kb.T), reps=5)
    c_topk = cuda_ms(lambda: torch.topk(scores, 10, dim=1), reps=5)
    qh, kh = q.to(torch.bfloat16), keys.to(torch.bfloat16)
    c_mm_bf16 = cuda_ms(lambda: torch.matmul(qh, kh.T), reps=5)
    del scores
    c_bytes = 2 * CHUNK * D + 2 * n * D + 8 * CHUNK * 10
    c_ops = 2 * CHUNK * n * D
    kernels.append(dict(
        name="fused_cosine_topk", route="cuda",
        source="ragraph_tpu_torch/csrc/fused_retrieval.cu",
        replaces="ragraph_tpu/ops/pallas_retrieval.py:130",
        launches=launches.get("fused_cosine_topk", 0),
        max_abs_err=errs["C"], ms=c_ms, plain_ms=c_plain,
        bound_ms=max(c_bytes / HBM_BYTES_PER_MS, c_ops / BF16_FLOP_PER_MS),
        bound_by="bytes" if c_bytes / HBM_BYTES_PER_MS
        >= c_ops / BF16_FLOP_PER_MS else "operations",
        library_ms=c_mm + c_topk))
    print(json.dumps({"detail_ms": {
        "C_library_f32_matmul": c_mm, "C_library_topk": c_topk,
        "C_bf16_matmul_bf16_out": c_mm_bf16}}), flush=True)
    return kernels


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from ragraph_tpu_torch import native
    from ragraph_tpu_torch.convert import params_from_jax
    from ragraph_tpu_torch.data.edgelist import load_edge_dataset
    from ragraph_tpu_torch.models.edge import EdgeGraphArrays

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} card {torch.cuda.get_device_name(0)}",
          flush=True)

    print("phase 1: build", flush=True)
    _, seconds, log = native.build(verbose=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip(), flush=True)
    native.lib()
    print(f"  build_seconds={seconds:.1f}", flush=True)

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    train, test = make_rows(rng, U, I, M)
    ds = load_edge_dataset(train, test, num_users=U, num_items=I)
    del train, test
    graph = EdgeGraphArrays.from_dataset(ds, dev)
    params = params_from_jax(xavier_tables(rng, U, I, D), dev)
    print(f"  data_seconds={time.perf_counter() - t0:.1f} "
          f"edges={graph.num_edges} nodes={graph.num_nodes}", flush=True)
    if graph.num_edges != 2 * M or graph.num_nodes != U + I:
        fail("main-path graph has the wrong size")

    errs = phase_kernel_checks(rng, dev, graph)
    launches = phase_main_path(dev, ds, graph, params)
    phase_small_agreement(dev)
    phase_cli(dev)
    kernels = phase_timing(dev, graph, errs, launches)

    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
