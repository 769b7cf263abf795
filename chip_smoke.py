#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its serving, ops, training,
probe, node, model-zoo and host-data paths on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. build every kernel in ``ragraph_tpu_torch/csrc`` with nvcc, count
   the tensor-core instructions (``HGMMA``/``HMMA``) in the machine code of
   kernels C, D, F and J (``cuobjdump -sass``), and require no stack frame
   and no spill in any of kernels E's and G's instantiations (their top-k
   lists live in registers; ``-Xptxas -v``) nor in the walk that kernels A
   and K run at the main path's width;
2. hold each of the twelve kernels against its plain PyTorch version on the
   card, at its path's shapes and at ragged small shapes (kernels A and K
   also on two skewed graphs of the same size, phase 2b, degree exponents
   0.8 and 1.0, with rows of up to about 37,000 and 160,000 edges, which
   their walk cuts into pieces, held to float64 sums; K bit for bit kernel
   A, and two calls of either giving the same bits); kernel D's maxima
   against the maxima of kernel F's scores, bit for bit; the bucket family
   against a dense reference, its top-1 bit for bit kernel D's largest
   maximum; the three probe kernels also against their neighbours (J
   within ``TOL_SCORE`` of kernel F's scores and not above kernel D's
   maxima by more, K against kernel A, L exact); E and G bit for bit at
   every k of ``K_SWEEP`` on ragged, tied and exhausted inputs; kernel C
   at an edge finetune step's shape (238,735 queries against as many
   keys) in one call, bit for bit its calls of 4,096 queries; kernel H
   at its tile, group and supergroup edges, at widths 1 to 512 and past
   2^31 elements, two calls giving the same bits; the edge-dropout kernel
   ``rg_edge_weights`` bit for bit the composition it replaces (the int64
   hash, the fold, ``torch.where``) at edge-taobao's 17,590,808 edges and
   at ragged sizes, timed beside it and beside its bytes bound;
3. drive the RAGraph-edge serving path at serving scale (U = I = 131,072,
   2^20 interactions, D = 64, 3 layers): ``generate`` -> library ->
   ``generate`` with RAG -> recall/ndcg@20 -> ``recommend_from``; count each
   kernel's launches in that run and require every count to be positive;
4. the retrieval tiers on the same graph, each with its launches counted
   from zero: the exact tier (all 128 chunks of the refresh's queries
   through ``cosine_topk(method="auto", recall_target=1.0)``, held against
   the fused kernel, then a ``torch.profiler`` window over eight chunks
   for the device's busy share), the huge-k tier (a RAG ``generate`` with
   the koubei ``vanilla`` config, ``retrieve_num=100000`` against a 524,288-row
   library, both ``selection_dtype`` values, held against ``torch.topk``)
   and the int8 tier (one chunk, pre-quantized table, ``rescore_pad=22``);
   the ops path on the 2^21 edges: ``sorted_segment_sum`` (the prefix sum,
   kernel H) against kernel B's sums and ``segsum_packed2_w`` (kernel I)
   against kernel A's; then the three probe scripts
   (``ragraph_tpu_torch.bench.exact_phases``, ``packed_table_gather``,
   ``onehot_gather``) through their ``main``, the path of kernels J, K, L;
5. run a small graph through the serving path and through one training
   step of each phase on the card and on the CPU (plain versions) and
   require embeddings, losses and gradients to agree; a small node
   ``forward`` likewise; run the ``vanilla``, ``pretrain`` and ``finetune``
   edge CLI on the synthetic stream on the card;
6. train at full width (U = I = 131,072, 2^21 edges, D = 64, 3 layers,
   batch 2,048, edge dropout 0.5): ``EdgeTrainer.train`` in the pretrain
   phase for whole epochs of 512 steps, then one stage of
   ``staged_finetune`` on 2^15 interactions (16 steps an epoch, each
   retrieving for all 262,144 nodes through kernel C); the loss must be
   finite and fall, every gradient finite and non-zero, and the launches
   per step as counted;
7. time each kernel, its plain version and one PyTorch library call that
   computes the same function, beside its bound, by a loop of calls and by
   device time alone; A's parts (the cast, the kernel, the backward) and K
   on the main path's graph and on the skewed one; E and G at k = 20 and
   50;
8. time a pretrain step and a finetune step (forward, backward, optimizer
   apart) beside the same step on plain PyTorch ops;
9. the static node pipeline at full width (3,000 synthetic graphs written
   as TU text files, hidden 256, batch 16, a 65,536-row library):
   ``cli.node vanilla`` and ``finetune``, kernel C launched once per
   ``retrieve``, the library filled into its capacity clamp, a falling
   loss and an accuracy above 0.5, with the stages timed;
10. node pretraining and the graph level on the same files: ``cli.node
   pretrain`` (3 epochs of ``lp``, a falling loss; one epoch of all six
   terms), then ``cli.node vanilla --level graph`` and ``finetune --level
   graph`` (``--epochs 10 --test-times 1``) from that checkpoint with a
   65,536-row library: kernel C launched once per forward and held to its
   plain version on the run's graph queries and store, timed there beside
   its bound, an accuracy above 0.5, the pretrain step and the graph
   ``retrieve`` timed;
11. the fewshot pipeline on the same files: ``cli.node pretrain
   --encoder-layers 2`` (2 epochs of ``lp``, a falling loss), then
   ``cli.fewshot vanilla`` and ``finetune`` at ``--level node`` and
   ``--level graph`` from that checkpoint (hidden 256, 5 shots, a
   65,536-row library, ``--epochs 5 --test-times 2``): the checkpoint
   loaded, the library's fill after each append, a loss falling in each
   task, accuracies above chance, and no kernel launched (the fewshot
   retrieval is the structure branch: two matmuls and ``torch.topk``); the
   library build, one structure ``retrieve``, the finetune step and each
   run timed;
12. the edge model zoo, run right after phase 6 (it starts from phase 6's
   pretrain tables and rows): (a) one ``cal_loss`` and backward
   of each of 13 zoo classes (the plugins SGL, SimGCL, MixGCF and
   LightGCN, ROLAND, EvolveGCN-H and -O, GP in both prompt modes, and the
   crosses SGL x ROLAND, MixGCF x EvolveGCN-O, SimGCL x graphprompt,
   LightGCN x gpf) on phase 5's small graph, on the card (kernel A)
   against CPU tensors (its plain version), the masks, noise, mixing
   weights and initial weights handed over as data, within ``TOL_GRAD``;
   (b) at phase 6's full width, one step of each class in the finetune
   phase from phase 6's pretrain tables: kernel A's launches per step as
   the code implies (``ZOO_A_PER_STEP``), none of kernel B, every gradient
   (the tables, ``gru.*``, ``prompt_vec``, the gate) finite and non-zero,
   and each step timed beside the RAGraph pretrain step; (c) an epoch of
   512 steps of SGL, SimGCL and MixGCF pretraining and one
   ``staged_dynamic`` stage each of ROLAND and SGL x EvolveGCN-H, launches
   as counted and the metrics finite; (d) ``cli.edge pretrain`` and
   ``finetune`` of five zoo configurations on the synthetic stream, each
   writing the JAX CLI's files;
13. the single-device utilities, after phase 11: (a) the host data path at
   the main path's size: the train rows written as a reference edge file
   and parsed in C++ and in numpy (equal arrays), an epoch's negatives
   (512 batches of 2,048) drawn by each (none in its user's history, the
   C++ draws repeated bit for bit from one seed), ``build_csr_native``
   against the dataset's CSR, and a pretrain epoch with the trainer's
   defaults (C++ sampler, prefetch; kernel A 6 launches a step) in turns
   with one that draws numpy negatives in line; (b) the IVF index at
   ``benchmarks/bench_10m_index.py``'s shape (10,000,000 bf16 keys of 128,
   8,192 clusters of capacity 2,560, 5 iterations; 256 queries, nprobe
   16, k = 10): build seconds, dropped rows, search ms, peak memory, and
   recall@10 against the exact tier (kernels D-G), beside kernel C's brute
   force (its recall and its scores against the exact tier's); (c)
   ``cli.edge finetune --pre-model-path x.pt`` from a reference-style
   ``.pt`` with its run log, the span totals, and ``op_profile`` of
   one pretrain step listing kernel A's launches.

14. the multi-device paths, after phase 13, with every rank on this card
   over a gloo group (collectives staged through host memory, so their
   times are not NCCL's) and the kernels built before the ranks start:
   (a-d) ``ragraph_tpu_torch.bench.multi_device`` under
   ``torch.distributed.run``, a world of two ranks (meshes ``dp=1,idx=2``
   and ``dp=2,idx=1``) and one of four (``dp=2,idx=2``): (a) a RAGraph
   pretrain and finetune step at phase 6's width with the tables over
   ``idx`` and the batch over ``dp``, held on rank 0 to the same step on
   one device (loss, every gradient, every parameter), replicated
   parameters equal on every rank, kernel A 6 launches per rank per step;
   (b) the refresh chunk's top-k (2,048 x 262,144 x 64, k = 10) by kernel C
   and by D-G on each half of the rows against one device's answer; (c)
   the huge-k fusion at the koubei shape (two chunks of 512 against
   524,288 rows, k = 100,000, f32 and bf16): the threshold bit for bit one
   device's, the count exact, the mean to 1e-5; (d) the node CLI's library
   (65,536 rows, hidden 256) built sharded, equal to one device's build,
   ``retrieve`` through kernel C on each shard equal; (e) ``cli.edge
   finetune`` (which pretrains first) with ``--mesh dp=1,idx=2
   --dist-backend gloo`` in two ranks, one launch writing the JAX CLI's
   files and a run log, and a world of one rank on NCCL (``--mesh
   dp=1,idx=1``) giving the single-device result. The launches of (a-d)
   join the kernels line, summed over the ranks.
15. every width and every k (the counterparts take every shape the JAX
   functions take): (a) after phase 11, ``cli.node finetune --hidden 512``
   on phase 9's files (kernel C on 512-wide rows in chunks of 128 columns,
   once per ``retrieve``, held to its plain version; accuracy above 0.5);
   (b) after phase 14, phase 6's path at ``emb_size`` 100: pretrain steps
   (kernel A 6 launches a step), finetune steps at ``retrieve_num`` 10
   (C 128 a step, rows padded to 104 columns) and at 1,000 (the selection
   family: the score matrix and ``select_topk``, 128 each a step), the
   first batch's loss lower after the steps; (c) kernel C and D-G at
   widths 4, 12, 100, 264, 512, 1,000 and k of 129, 256, 1,000, 4,096
   (ragged Q and R, fewer valid rows than k, k > R; D against F and the
   score matrix's bucket maxima against D bit for bit; E and G past 128
   and at k = 20,000 bit for bit their plain versions), the refresh chunk
   at E = 100 and k = 10 and 1,000, and A, B, I at widths 1, 3, 65, 514,
   640, 1,024 on phase 2's graph and phase 2b's skewed graph; (d) the new
   shapes' device times beside their one-call yardsticks and bounds, and
   the selection family's two kernels in the kernels line.

It prints per-stage milliseconds, a ``{"kernels": [...]}`` line, the card's
name and power limit, and last ``{"ok": true, "device": {...}}``. It imports
nothing of JAX and needs the repository beside it.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
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
# Exact bf16 products, f32 sums of <= 256 terms in two different orders:
# kernels C, D, F and J (the tensor cores' order, csrc/rg_mma.cuh) against
# their plain versions (sequential sums), J against kernel F, the bucket
# family against its dense reference and the exact tier against C. Each
# check prints its largest error.
TOL_SCORE = 1e-5
# No difference at all: kernels E and G against their plain versions (they
# only select), and kernel D's maxima against kernel F's scores and the
# bucket family's top-1 (D and F take the same tensor-core sums for a
# query and a key, so the exact tier's bucket choice holds).
TOL_BUCKET = 0.0
# Kernel H against its plain version (torch.cumsum in f32): two f32 sums of
# up to 2^21 terms in different orders, so the error follows the size of the
# prefix: rtol times max|prefix|. torch.cumsum itself is about 3e-5 of the
# largest prefix away from a float64 sum at 2^21 rows; H is held to the
# float64 sum ten times closer.
TOL_PREFIX = (1e-4, 0.0)
TOL_PREFIX_F64 = (1e-5, 0.0)
# The prefix-difference segment sum against kernel B's direct sums: each
# bound reads a prefix that is within 1e-5 of the largest prefix's size, so
# the error of their difference is absolute in that size, twice over.
TOL_PREFIX_DIFF = 2e-5
# One training step on the card against the same step on the CPU, f32:
# |err| <= atol + rtol * max|CPU value|, per gradient.
TOL_GRAD = (1e-4, 1e-9)
PRETRAIN_EPOCHS = 2         # of 512 steps
FT_ROWS = 1 << 15           # a stage's finetune split: 16 steps an epoch
FT_EPOCHS = 2
K_PATH = 10                 # EdgeModelConfig().retrieve_num
C_CELL_ROWS = 238_735       # edge-amazon's nodes: its queries and library
C_CELL_CHUNK = 4096         # edge-amazon's finetune rag_chunk
P_MAX = 32                  # bucketed_exact_topk's default capacity


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    from ragraph_tpu_torch.bench.timing import timed_ms
    return timed_ms(fn, reps, warmup, "cuda")


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: the stream is held while the
    calls are queued (``ragraph_tpu_torch.bench.timing.device_ms``).
    ``cuda_ms`` instead also counts the host's time between launches, which
    sets the pace of a loop of calls shorter than their Python wrappers."""
    from ragraph_tpu_torch.bench.timing import device_ms as timed
    return timed(fn, reps)


def StageTimer():
    """Per-stage milliseconds between CUDA events
    (``ragraph_tpu_torch.bench.timing.StageTimer``)."""
    from ragraph_tpu_torch.bench import timing
    return timing.StageTimer("cuda")


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
    plan = cs.walk_plan(ip)
    tag = (f"n={n} E={e} D={d} longest row {int(np.diff(indptr).max())}, "
           f"{len(plan.pieces)} pieces")
    for bf16 in (True, False):
        got = cs.gather_scale_segsum(table, *args, bf16=bf16)
        ref = cs.gather_scale_segsum_plain(table, w, idx, ip, bf16)
        check_close(f"A bf16={bf16} {tag}", got, ref, TOL_SEGSUM)
        check_same(f"A bf16={bf16} {tag}, a second call", got,
                   cs.gather_scale_segsum(table, *args, bf16=bf16))
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


def segsum_f64(table, w, idx, indptr, bf16):
    """Kernel A's plain version (``gather_scale_segsum_plain``: the same
    bf16-rounded rows and weights) with its terms summed in float64."""
    import torch

    from ragraph_tpu_torch.ops import csr_segment as cs
    t, ww = table.float(), w.float()
    if bf16:
        t = t.to(torch.bfloat16).float()
        ww = ww.to(torch.bfloat16).float()
    out = torch.zeros(len(indptr) - 1, t.shape[1], dtype=torch.float64,
                      device=t.device)
    return out.index_add_(0, cs._segment_ids(indptr, len(idx)),
                          t[idx.long()].double() * ww.double()[:, None])


SKEW_ALPHAS = (0.8, 1.0)     # degree exponents of phase 2b's graphs


def phase_skewed(rng, dev):
    """Kernels A and K on graphs with hub rows: N = 262,144 rows, 2^21
    edges, receivers and senders each drawn with probability proportional
    to (rank + 1)^-alpha (``bench.csr_walk.skewed_graph``), at each exponent
    of ``SKEW_ALPHAS``: the largest row about 37,000 edges at 0.8 and
    160,000 at 1.0. Returns the 0.8 graph, which phase 7 times."""
    import torch

    from ragraph_tpu_torch.bench import csr_walk
    t0 = time.perf_counter()
    print("phase 2b: kernels A and K on skewed graphs", flush=True)
    errs, kept = {}, None
    for alpha in SKEW_ALPHAS:
        g_rng = rng if alpha == csr_walk.ALPHA \
            else np.random.default_rng(SEED + 41)
        sk = {k: torch.from_numpy(v).to(dev) for k, v in
              csr_walk.skewed_graph(g_rng, alpha=alpha).items()}
        errs[f"alpha={alpha}"] = skewed_checks(sk, dev, alpha)
        if alpha == csr_walk.ALPHA:
            kept = sk
        del sk
        torch.cuda.empty_cache()
    print(json.dumps({"skewed_max_abs_err": errs,
                      "skewed_phase_s": time.perf_counter() - t0}),
          flush=True)
    return kept


def skewed_checks(sk, dev, alpha):
    """On one skewed graph ``sk``: A's forward (bf16 and f32) and backward
    (the same op in sender order) and K, with the parity split and with
    both weights, against the plain versions' terms summed in float64 at
    TOL_SEGSUM (the plain versions' own f32 ``index_add_`` strays by up to
    about 1e-2 over a row of 37,000 terms and 0.3 over one of 160,000,
    printed beside); K with the parity split equal to A bit for bit; two calls giving the same bits; empty
    rows zero rows. Returns the largest errors."""
    import torch

    from ragraph_tpu_torch.bench import csr_walk
    from ragraph_tpu_torch.ops import csr_segment as cs
    from ragraph_tpu_torch.ops import probes as pr
    deg = {side: csr_walk.degree_summary(sk[f"{side}_indptr"])
           for side in ("recv", "send")}
    plans = {side: cs.walk_plan(sk[f"{side}_indptr"])
             for side in ("recv", "send")}
    for side, plan in plans.items():
        deg[side]["pieces"] = len(plan.pieces)
    print(json.dumps({"skewed_graph_degrees": deg, "alpha": alpha}),
          flush=True)
    if not all(deg[side]["long_rows"] and deg[side]["pieces"]
               for side in deg):
        fail(f"the skewed graph (alpha {alpha}) has no row that the walk "
             f"cuts into pieces")
    gen = torch.Generator(dev).manual_seed(SEED + 40)
    n = len(sk["recv_indptr"]) - 1
    table = torch.randn(n, D, generator=gen, device=dev)
    ct = torch.randn(n, D, generator=gen, device=dev)
    args = (sk["w"], sk["w_send"], sk["senders"], sk["recv_indptr"],
            sk["recv_of_send"], sk["send_indptr"])
    fwd = (sk["w"], sk["senders"], sk["recv_indptr"])
    bwd = (sk["w_send"], sk["recv_of_send"], sk["send_indptr"])
    empty = sk["recv_indptr"][1:] == sk["recv_indptr"][:-1]
    tag = f"alpha={alpha}"

    def held(name, got, f64, f32_plain):
        err = check_close(f"{name} {tag}", got, f64.float(), TOL_SEGSUM)
        print(f"    the plain version's f32 sums against float64: "
              f"{float((f32_plain - f64).abs().max()):.3e}", flush=True)
        return err

    errs = {}
    planned = {"recv_plan": plans["recv"], "send_plan": plans["send"]}
    for bf16 in (True, False):
        x = table.clone().requires_grad_(True)
        got = cs.gather_scale_segsum(x, *args, bf16=bf16, **planned)
        errs[f"A_bf16={bf16}"] = held(
            f"A skewed bf16={bf16}", got.detach(),
            segsum_f64(table, *fwd, bf16),
            cs.gather_scale_segsum_plain(table, *fwd, bf16))
        check_same(f"A skewed bf16={bf16} {tag}, a second call",
                   got.detach(),
                   cs.gather_scale_segsum(table, *args, bf16=bf16, **planned))
        if not bool((got.detach()[empty] == 0).all()):
            fail(f"A skewed {tag}: an empty row is not a zero row")
        # the backward: the same op in sender order on the cotangent (with
        # bf16 the cotangent is rounded too, as in the JAX custom VJP)
        got.backward(ct)
        errs[f"A_backward_bf16={bf16}"] = held(
            f"A skewed backward bf16={bf16}", x.grad,
            segsum_f64(ct, *bwd, bf16),
            cs.gather_scale_segsum_plain(ct, *bwd, bf16))
        x2 = table.clone().requires_grad_(True)
        cs.gather_scale_segsum(x2, *args, bf16=bf16, **planned).backward(ct)
        check_same(f"A skewed backward bf16={bf16} {tag}, a second call",
                   x.grad, x2.grad)
        del x, x2, got
    tp = pr.pack_table(table)
    par = (sk["senders"] & 1).float()
    half = (sk["senders"] >> 1).contiguous()
    k_args = (tp, sk["w"] * (1 - par), sk["w"] * par, half,
              sk["recv_indptr"])
    got = pr.packed_table_segsum(*k_args, plans["recv"])
    errs["K"] = held("K skewed", got, segsum_f64(table, *fwd, True),
                     pr.packed_table_segsum_plain(*k_args))
    check_same(f"K skewed {tag} against kernel A", got,
               cs._csr_gather_scale(table, *fwd, True, plans["recv"]))
    check_same(f"K skewed {tag}, a second call (making its own plan)", got,
               pr.packed_table_segsum(*k_args))
    if not bool((got[empty] == 0).all()):
        fail(f"K skewed {tag}: an empty row is not a zero row")
    both = (tp, sk["w"], 1 - sk["w"], half, sk["recv_indptr"])
    rows = tp.float()[half.long()].double()
    wl = sk["w"].to(torch.bfloat16).double()[:, None]
    wh = (1 - sk["w"]).to(torch.bfloat16).double()[:, None]
    f64 = torch.zeros(n, D, dtype=torch.float64, device=dev).index_add_(
        0, cs._segment_ids(sk["recv_indptr"], len(half)),
        rows[:, :D] * wl + rows[:, D:] * wh)
    del rows
    errs["K_both_weights"] = held(
        "K skewed both weights", pr.packed_table_segsum(*both), f64,
        pr.packed_table_segsum_plain(*both))
    del f64, got
    return errs


def pack_half_split(msgs, block):
    """``(n, D)`` rows into the ``(n/2, 2D)`` half-split layout kernel I
    reads: packed row ``c*B + i`` = ``[row c*2B + i | row c*2B + B + i]``."""
    import torch
    n, d = msgs.shape
    m3 = msgs.reshape(n // (2 * block), 2, block, d)
    return torch.cat([m3[:, 0], m3[:, 1]], dim=2).reshape(n // 2, 2 * d) \
        .contiguous()


def random_indptr(rng, dev, n_edges, n_segs, hub):
    """CSR bounds of ``n_edges`` sorted random segment ids; with more
    segments than edges most are empty or hold one row; ``hub`` puts a
    third of the edges into one segment."""
    import torch
    ids = np.sort(rng.integers(0, n_segs, n_edges))
    if hub:
        ids[: n_edges // 3] = n_segs // 2
        ids = np.sort(ids)
    indptr = np.zeros(n_segs + 1, np.int64)
    np.add.at(indptr[1:], ids, 1)
    return torch.from_numpy(np.cumsum(indptr).astype(np.int32)).to(dev)


def prefix_checks(gen, dev, n, d, dtype, repeat=False, misaligned=False):
    """Kernel H against its plain version and a float64 sum, inclusive and
    exclusive, with the grand total; with ``repeat``, a second call must
    give the same bits. With ``misaligned``, ``x`` is a contiguous view one
    element into a flat buffer (no vector loads), and it must give the same
    bits as an aligned copy: the order of the adds follows the shape."""
    import torch

    from ragraph_tpu_torch.ops import prefix_sum as ps
    if misaligned:
        flat = torch.randn(n * d + 1, generator=gen, device=dev).to(dtype)
        x = flat[1:].view(n, d)
    else:
        x = torch.randn(n, d, generator=gen, device=dev).to(dtype)
    exact = torch.cumsum(x.double(), 0)
    tag = (f"N={n} D={d} {str(dtype).split('.')[-1]}"
           + (" misaligned" if misaligned else ""))
    worst = 0.0
    for exclusive in (False, True):
        got, total = ps.prefix_sum(x, exclusive)
        if repeat:
            again, total_again = ps.prefix_sum(x, exclusive)
            if not (torch.equal(got, again)
                    and torch.equal(total, total_again)):
                fail(f"H {tag} exclusive={exclusive}: two calls differ")
            del again
        if misaligned:
            aligned, total_aligned = ps.prefix_sum(x.clone(), exclusive)
            if not (torch.equal(got, aligned)
                    and torch.equal(total, total_aligned)):
                fail(f"H {tag} exclusive={exclusive}: differs from the "
                     f"aligned copy's bits")
            del aligned
        torch.cuda.synchronize()
        ref, ref_total = ps.prefix_sum_plain(x, exclusive)
        what = "exclusive" if exclusive else "inclusive"
        worst = max(worst, check_close(f"H {what} {tag}", got, ref,
                                       TOL_PREFIX))
        ref64 = (torch.cat([torch.zeros_like(exact[:1]), exact[:-1]])
                 if exclusive else exact)
        check_close(f"H {what} {tag} against float64", got.double(), ref64,
                    TOL_PREFIX_F64)
        del ref, ref64
        # the total is held to the size of the largest prefix too
        scale = float(exact.abs().max())
        t_err = float((total.double() - exact[-1:]).abs().max())
        if t_err > TOL_PREFIX_F64[0] * scale \
                or float((total - ref_total).abs().max()) \
                > TOL_PREFIX[0] * scale:
            fail(f"H total {tag}: error {t_err:.3e} at prefix size "
                 f"{scale:.3e}")
    return worst


def kernel_h_tiles():
    """Kernel H's tile rows, tiles a group and groups a supergroup, read
    from its source (``kTileRows``, ``kGroup``, ``kSuper``), so that the
    edge checks follow the kernel."""
    import re

    from ragraph_tpu_torch import native
    src = (native.CSRC / "prefix_sum.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);",
                               src).group(1))
                 for name in ("kTileRows", "kGroup", "kSuper"))


def prefix_big_check(gen, dev, n=(1 << 25) + 7, step=1 << 20, tail=4096):
    """Kernel H past 2^31 elements (64-bit offsets): 2^25 + 7 rows of 64
    bf16 columns, 4.3 GB in, 8.6 GB out each way. Inclusive and exclusive
    held to the plain version row chunk by row chunk; the prefix at every
    chunk's last row, the last rows and the total to float64 sums."""
    import torch

    from ragraph_tpu_torch.ops import prefix_sum as ps
    x = torch.empty(n, D, dtype=torch.bfloat16, device=dev)
    for r in range(0, n, step):
        x[r:r + step] = torch.randn(min(step, n - r), D, generator=gen,
                                    device=dev)
    got, total = ps.prefix_sum(x, False)
    excl, excl_total = ps.prefix_sum(x, True)
    torch.cuda.synchronize()
    ref, ref_total = ps.prefix_sum_plain(x, False)
    scale = float(ref.abs().max())
    err = float((total - ref_total).abs().max())
    err_excl = max(float(excl[0].abs().max()),
                   float((excl_total - ref_total).abs().max()))
    for r in range(0, n, step):
        hi = min(n, r + step)
        err = max(err, float((got[r:hi] - ref[r:hi]).abs().max()))
        lo = max(r, 1)      # exclusive row r is inclusive row r - 1
        err_excl = max(err_excl, float((excl[lo:hi]
                                        - ref[lo - 1:hi - 1]).abs().max()))
    del ref, excl
    torch.cuda.empty_cache()
    run64 = torch.zeros(D, dtype=torch.float64, device=dev)
    err64 = 0.0
    for r in range(0, n - tail, step):
        hi = min(n - tail, r + step)
        run64 = run64 + x[r:hi].double().sum(0)
        err64 = max(err64, float((got[hi - 1].double() - run64).abs().max()))
    exact = run64 + torch.cumsum(x[n - tail:].double(), 0)
    err64 = max(err64, float((got[n - tail:].double() - exact).abs().max()))
    t_err = float((total[0].double() - exact[-1]).abs().max())
    tol, tol64 = TOL_PREFIX[0] * scale, TOL_PREFIX_F64[0] * scale
    ok = (err <= tol and err_excl <= tol and err64 <= tol64
          and t_err <= tol64 and bool(torch.isfinite(got).all()))
    print(f"  H N={n} D={D} bfloat16 ({n * D} elements): against the plain "
          f"version inclusive {err:.3e}, exclusive {err_excl:.3e} (tol "
          f"{tol:.3e}); against float64 {err64:.3e}, total {t_err:.3e} "
          f"(tol {tol64:.3e}) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("kernel H past 2^31 elements disagrees")
    del x, got


def prefix_segsum_checks(rng, gen, dev, n, n_segs, d, hub):
    """``sorted_segment_sum`` (kernel H and the boundary difference)
    against the plain segment sum: empty and single-row segments, a hub."""
    import torch

    from ragraph_tpu_torch.ops import csr_segment as cs
    from ragraph_tpu_torch.ops import prefix_sum as ps
    ip = random_indptr(rng, dev, n, n_segs, hub)
    msgs = torch.randn(n, d, generator=gen, device=dev)
    got = ps.sorted_segment_sum(msgs, ip[:-1], ip[1:])
    torch.cuda.synchronize()
    ref = cs.segment_sum_plain(msgs, ip)
    scale = float(torch.cumsum(msgs.double(), 0).abs().max())
    err = float((got - ref).abs().max())
    tol = TOL_PREFIX_DIFF * max(scale, 1.0)
    empty = (ip[1:] == ip[:-1])
    ok = err <= tol and bool((got[empty] == 0).all())
    print(f"  H segment sum n={n} segs={n_segs} D={d} hub={hub}: "
          f"max_abs_err={err:.3e} tol={tol:.3e} (prefix size {scale:.3e}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("sorted_segment_sum disagrees with the plain segment sum")


def packed_checks(rng, gen, dev, n, n_segs, d, block, hub, dtype):
    """Kernel I against its plain version, with and without the bf16
    switch, f32 or bf16 rows."""
    import torch

    from ragraph_tpu_torch.ops import csr_segment as cs
    ip = random_indptr(rng, dev, n, n_segs, hub)
    msgs = torch.randn(n, d, generator=gen, device=dev).to(dtype)
    w = torch.rand(n, generator=gen, device=dev)
    msgs2 = pack_half_split(msgs, block)
    tag = (f"n={n} segs={n_segs} D={d} B={block} hub={hub} "
           f"{str(dtype).split('.')[-1]}")
    for bf16 in (True, False):
        got = cs.segsum_packed2_w(msgs2, w, ip, n, block=block, bf16=bf16)
        torch.cuda.synchronize()
        ref = cs.segsum_packed2_w_plain(msgs2, w, ip, n, block, bf16)
        check_close(f"I bf16={bf16} {tag}", got, ref, TOL_SEGSUM)


def hi_kernel_checks(rng, dev, graph):
    """Kernels H and I at the path's shape (2^21 x 64 messages, packed
    (2^20, 128)) and at ragged shapes."""
    import torch

    from ragraph_tpu_torch.ops import csr_segment as cs
    errs = {}
    gen = torch.Generator(dev).manual_seed(SEED + 20)
    g = graph
    n = g.num_edges
    errs["H"] = prefix_checks(gen, dev, n, D, torch.float32, repeat=True)
    prefix_checks(gen, dev, n, D, torch.bfloat16, repeat=True)
    torch.cuda.empty_cache()
    # H's tile (T rows), group (G tiles) and supergroup edges at the path's
    # width, f32 and bf16, and at D = 65 (two slabs, the second one column
    # wide); every width at a group edge; D = 512 (eight slabs) past a
    # supergroup edge, f32 and bf16, and past a group edge in bf16; bf16
    # where D is no multiple of 8 (four columns a thread at D = 36, loaded
    # one at a time at 3 and 33); inputs one element off alignment, bit for
    # bit their aligned copies; one past 2^31 elements
    t_rows, group, super_ = kernel_h_tiles()
    grp = group * t_rows
    sup = super_ * grp
    for n_rows in (1, t_rows - 1, t_rows, t_rows + 1, grp - 1, grp, grp + 1,
                   sup - 1, sup, sup + 1):
        for d, dtype in ((D, torch.float32), (D, torch.bfloat16),
                         (65, torch.float32)):
            prefix_checks(gen, dev, n_rows, d, dtype)
    for d in (1, 3, 33, 64, 65, 512):
        prefix_checks(gen, dev, grp + 1, d, torch.float32)
    for d in (3, 33, 36, 512):
        prefix_checks(gen, dev, grp + 1, d, torch.bfloat16, repeat=d == 33)
    for dtype in (torch.float32, torch.bfloat16):
        prefix_checks(gen, dev, sup + 1, 512, dtype)
        torch.cuda.empty_cache()
        prefix_checks(gen, dev, sup + 1, D, dtype, misaligned=True)
    prefix_checks(gen, dev, grp + 1, 36, torch.float32, misaligned=True)
    torch.cuda.empty_cache()
    prefix_big_check(gen, dev)
    torch.cuda.empty_cache()
    for n_rows, n_segs, d, hub in ((1000, 300, 16, False),
                                   (1000, 4000, 8, False),
                                   (50001, 700, 64, True), (5, 9, 2, False),
                                   (4099, 64, 512, True)):
        prefix_segsum_checks(rng, gen, dev, n_rows, n_segs, d, hub)

    table = torch.randn(g.num_nodes, D, generator=gen, device=dev)
    w = g.edge_norm * 0.5 + g.time_norm * 0.5
    msgs2 = pack_half_split(table[g.senders.long()], 512)
    if tuple(msgs2.shape) != (n // 2, 2 * D):
        fail(f"packed messages have shape {tuple(msgs2.shape)}")
    for bf16 in (True, False):
        got = cs.segsum_packed2_w(msgs2, w, g.recv_indptr, n, bf16=bf16)
        torch.cuda.synchronize()
        ref = cs.segsum_packed2_w_plain(msgs2, w, g.recv_indptr, n, 512,
                                        bf16)
        err = check_close(f"I bf16={bf16} main shape", got, ref, TOL_SEGSUM)
        if bf16:
            errs["I"] = err
    del msgs2, got, ref
    torch.cuda.empty_cache()
    for n_e, n_segs, d, block, hub, dtype in (
            (512, 96, 16, 128, False, torch.float32),
            (2048, 5000, 2, 512, False, torch.float32),   # empty, one-row
            (4096, 40, 512, 256, True, torch.float32),    # a hub, D = 512
            (1024, 3, 130, 128, True, torch.bfloat16),
            (6144, 700, 64, 1024, False, torch.bfloat16)):
        packed_checks(rng, gen, dev, n_e, n_segs, d, block, hub, dtype)
    for bad_n, bad_block in ((1000, 512), (1024, 0)):
        try:
            cs.segsum_packed2_w(torch.zeros(bad_n // 2, 8, device=dev),
                                torch.zeros(bad_n, device=dev),
                                torch.zeros(2, dtype=torch.int32, device=dev),
                                bad_n, block=bad_block)
        except ValueError:
            continue
        fail(f"segsum_packed2_w took n={bad_n} block={bad_block}")
    return errs


def check_same(name, got, ref):
    """Tolerance TOL_BUCKET: every value equal (``ref`` a plain version, or
    the other kernel of a pair that must agree bit for bit)."""
    import torch
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} against {tuple(ref.shape)}")
    if got.dtype.is_floating_point:
        err = float((got - ref).abs().max()) if got.numel() else 0.0
        ok = bool(torch.isfinite(got).all()) and err <= TOL_BUCKET
    else:
        err = int((got != ref).sum())
        ok = err == 0
    print(f"  {name}: max_abs_err={err:.3e} tol={TOL_BUCKET:.0e} "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{name} disagrees")
    return float(err)


def dense_topk(q, keys, k, valid=None):
    """The bucket path's reference at small sizes: every score by the plain
    versions' sequential sum, a stable sort, (-inf, 0) in exhausted
    slots."""
    import torch

    from ragraph_tpu_torch.ops.score_tile import fma_chain
    scores = fma_chain(q.to(torch.bfloat16)[:, None, :],
                        keys.to(torch.bfloat16)[None, :, :])
    if valid is not None:
        scores = torch.where(valid[None, :], scores, -torch.inf)
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    s, i = s[:, :k], i[:, :k]
    if s.shape[1] < k:      # fewer rows than k
        s = torch.nn.functional.pad(s, (0, k - s.shape[1]), value=-torch.inf)
        i = torch.nn.functional.pad(i, (0, k - i.shape[1]), value=0)
    return s, torch.where(torch.isinf(s), 0, i).to(torch.int32)


def check_bucket_family(name, q, keys, k, valid=None, p_max=P_MAX):
    """``bucketed_exact_topk`` against the dense reference: scores within
    TOL_SCORE, and an index that differs points at a valid key that scores
    within TOL_SCORE of the reference's pick. Where the tier runs kernel D
    (k buckets or more), each row's top-1 score is bitwise the row's
    largest bucket maximum: the overflow rounds included, every candidate
    carries kernel F's bits, which are D's."""
    import torch

    from ragraph_tpu_torch.ops.bucket_topk import (LANE, bucket_max,
                                                   bucketed_exact_topk)
    from ragraph_tpu_torch.ops.score_tile import fma_chain
    s, i = bucketed_exact_topk(q, keys, k, valid_mask=valid, p_max=p_max)
    torch.cuda.synchronize()
    ps, pi = dense_topk(q, keys, k, valid)
    live = torch.isfinite(ps)
    bad = not torch.equal(torch.isfinite(s), live)
    err = float((s[live] - ps[live]).abs().max()) if live.any() else 0.0
    bad |= err > TOL_SCORE or bool((i[~live] != 0).any())
    diff = (i != pi) & live
    tie_err = 0.0
    if diff.any():
        rows = diff.nonzero()[:, 0]
        picked = fma_chain(q.to(torch.bfloat16)[rows],
                            keys.to(torch.bfloat16)[i[diff].long()])
        tie_err = float((picked - ps[diff]).abs().max())
        bad |= tie_err > TOL_SCORE
        if valid is not None:
            bad |= not bool(valid[i[diff].long()].all())
    top1 = "dense branch"
    if -(-keys.shape[0] // LANE) >= k:
        d_top = bucket_max(keys.to(torch.bfloat16).contiguous(),
                           q.to(torch.bfloat16).contiguous(),
                           valid).amax(0)
        row_live = live[:, 0]
        top_err = float((s[row_live, 0] - d_top[row_live]).abs().max()) \
            if row_live.any() else 0.0
        bad |= top_err > TOL_BUCKET
        top1 = f"top1_vs_D={top_err:.3e}"
    print(f"  {name}: max_abs_err={err:.3e} tol={TOL_SCORE:.0e} "
          f"index_ties={int(diff.sum())} (tie max_abs_err={tie_err:.3e}) "
          f"{top1} tol={TOL_BUCKET:.0e} {'ok' if not bad else 'MISMATCH'}",
          flush=True)
    if bad:
        fail(f"{name} disagrees with the dense reference or with kernel D")


def bucket_stages(q, keys, k):
    """The tensors each of D, E, F, G reads on the bucket path, made by the
    path's own code: what the checks and the timings feed the kernels."""
    import torch

    from ragraph_tpu_torch.ops import bucket_topk as bt
    qh = q.to(torch.bfloat16).contiguous()
    kh = keys.to(torch.bfloat16).contiguous()
    bm, assign, ids, cand = bt.bucket_candidates(qh, kh, k, None, P_MAX)
    return dict(qh=qh, kh=kh, bm=bm, ids=ids, assign=assign, cand=cand)


def d_equals_f(tag, kh, qh, valid, queries):
    """Kernel D's maxima of ``queries`` (indices into ``qh``) against the
    maxima of kernel F's scores when every one of them is listed in every
    bucket: equal bit for bit."""
    import torch

    from ragraph_tpu_torch.ops import bucket_topk as bt
    nb = -(-kh.shape[0] // bt.LANE)
    d = bt.bucket_max(kh, qh, valid)[:, queries]
    assign = queries.to(torch.int32).repeat(nb, 1)
    f = bt.bucket_rescore(assign, qh, kh, valid).amax(2)
    return check_same(f"D against max of F {tag} P={queries.numel()}", d, f)


# k of kernels E's and G's checks: each side of their list lengths (one
# warp list of 32, 64 or 128), k = 16 and 17 (the old kernels' bound),
# the configs' 10, 20 and 50, and the limit
K_SWEEP = (1, 4, 7, 10, 16, 17, 20, 32, 33, 50, 64, 65, 128)


def eg_kernel_checks(gen, dev):
    """Kernels E and G against their plain versions, values and indices
    bit for bit (TOL_BUCKET), at every k of K_SWEEP: value ties on a coarse
    grid, a column (row) with nothing in it, one exhausted halfway, one of
    equal values, fewer rows (columns) than k, widths that are not a
    multiple of 4 (4-byte loads), and rows past the 50,000 values G once
    held in shared memory."""
    import torch

    from ragraph_tpu_torch.ops import bucket_topk as bt

    def make(shape, grid):
        x = torch.randn(shape, generator=gen, device=dev)
        return torch.round(x * 2) if grid else x

    def same(tag, fn, plain, x):
        worst = 0.0
        for k in K_SWEEP:
            for got, ref, what in zip(fn(x, k), plain(x, k), "vi"):
                if got.shape != ref.shape:
                    fail(f"{tag} k={k} {what}: shape {tuple(got.shape)}")
                if what == "v":
                    err = float((got - ref).abs().max()) if got.numel() \
                        else 0.0
                    ok = bool(torch.isfinite(got).all()) and err <= TOL_BUCKET
                else:
                    err = float((got != ref).sum())
                    ok = err == 0
                if not ok:
                    fail(f"{tag} k={k} {what} disagrees with its plain "
                         f"version ({err:.3e})")
                worst = max(worst, err)
        print(f"  {tag} k={','.join(map(str, K_SWEEP))}: "
              f"max_abs_err={worst:.3e} tol={TOL_BUCKET:.0e} ok", flush=True)

    for n_r, n_q, grid in ((300, 130, True), (50, 33, False),
                           (1000, 40, True), (2, 1, False),
                           (777, 2049, False), (5, 64, True),
                           (2048, 2048, False)):
        x = make((n_r, n_q), grid)
        x[:, 0] = bt.NEG_INF                # a column with nothing in it
        x[n_r // 2:, -1] = bt.NEG_INF
        if n_q > 2:
            x[:, 1] = 0.5                   # a column of equal values
        same(f"E R={n_r} Q={n_q} grid={grid}",
             bt.column_topk, bt.column_topk_plain, x)
    for n_q, w, grid in ((70, 260, True), (9, 16384, True),
                         (3, 50000, False), (2, 100000, False),
                         (1, 1, False), (300, 1280, False), (5, 1283, True),
                         (4, 7, False)):
        x = make((n_q, w), grid)
        x[0] = bt.NEG_INF
        x[-1, w // 2:] = bt.NEG_INF
        if n_q > 2:
            x[1] = 0.5                      # a row of equal values
        same(f"G Q={n_q} W={w} grid={grid}",
             bt.row_topk, bt.row_topk_plain, x)


def bucket_kernel_checks(gen, dev, q_path, keys_path):
    """Kernels D and F against their plain versions (TOL_SCORE) and D
    against F (bit for bit); E and G against their plain versions (bit for
    bit); the four with the glue against a dense reference."""
    import torch

    from ragraph_tpu_torch.ops import bucket_topk as bt
    from ragraph_tpu_torch.ops.similarity import l2_normalize
    errs = {}

    def unit(n, e):
        return l2_normalize(torch.randn(n, e, generator=gen, device=dev))

    def mask(n, spec):
        """``spec``: None, ("rand", n_valid) or ("first", n_valid)."""
        if spec is None:
            return None
        if spec[0] == "first":
            return torch.arange(n, device=dev) < spec[1]
        valid = torch.zeros(n, dtype=torch.bool, device=dev)
        valid[torch.randperm(n, generator=gen, device=dev)[:spec[1]]] = True
        return valid

    # D and F on ragged shapes: R not a multiple of 128, masks that thin out
    # or empty whole buckets, E at both limits, empty and out-of-range
    # slots, one to three m64 tiles of slots; then D against F with every
    # query in every bucket
    tol = (0.0, TOL_SCORE)
    for n_q, n_r, e, spec, p_max in (
            (70, 1000, 64, None, 5), (5, 130, 8, ("rand", 60), 3),
            (64, 128, 256, None, 32), (1, 4097, 136, ("rand", 900), 7),
            (130, 2048, 64, ("first", 200), 33),
            (3, 300, 64, ("rand", 100), 4), (20, 640, 16, None, 130)):
        qh, kh = unit(n_q, e).bfloat16(), unit(n_r, e).bfloat16()
        valid = mask(n_r, spec)
        tag = f"Q={n_q} R={n_r} E={e} valid={spec}"
        check_close(f"D {tag}", bt.bucket_max(kh, qh, valid),
                    bt.bucket_max_plain(kh, qh, valid), tol)
        nb = -(-n_r // bt.LANE)
        assign = torch.randint(-1, n_q + 4, (nb, p_max), generator=gen,
                               device=dev, dtype=torch.int32)
        check_close(f"F {tag} P={p_max}",
                    bt.bucket_rescore(assign, qh, kh, valid),
                    bt.bucket_rescore_plain(assign, qh, kh, valid), tol)
        d_equals_f(tag, kh, qh, valid, torch.arange(n_q, device=dev))
    eg_kernel_checks(gen, dev)

    # the path's shape, each kernel on what the path hands it
    st = bucket_stages(q_path, keys_path, K_PATH)
    tag = f"Q={CHUNK} R={keys_path.shape[0]} k={K_PATH}"
    errs["D"] = check_close(f"D {tag}", st["bm"],
                            bt.bucket_max_plain(st["kh"], st["qh"]), tol)
    # the first 64 queries (the first warpgroup of D's first query block),
    # then 64 that sit in its second warpgroup
    for lo in (0, 64):
        d_equals_f(tag, st["kh"], st["qh"], None,
                   torch.arange(lo, lo + 64, device=dev))
    errs["E"] = max(check_same(f"E {tag} {what}", got, ref)
                    for got, ref, what in zip(
                        bt.column_topk(st["bm"], K_PATH),
                        bt.column_topk_plain(st["bm"], K_PATH), "vi"))
    errs["F"] = check_close(
        f"F {tag} P={st['assign'].shape[1]}",
        bt.bucket_rescore(st["assign"], st["qh"], st["kh"]),
        bt.bucket_rescore_plain(st["assign"], st["qh"], st["kh"]), tol)
    errs["G"] = max(check_same(f"G {tag} {what}", got, ref)
                    for got, ref, what in zip(
                        bt.row_topk(st["cand"], K_PATH),
                        bt.row_topk_plain(st["cand"], K_PATH), "vi"))
    del st

    # the four together, with the glue, on ragged shapes
    for n_q, n_r, e, k, spec, same, p_max in (
            (100, 4000, 64, 10, None, False, P_MAX),   # R % 128 != 0
            (13, 3000, 48, 4, ("rand", 1500), False, P_MAX),
            (16, 2000, 64, 8, ("first", 200), False, P_MAX),  # 2 buckets < k
            (9, 700, 16, 6, ("first", 4), False, P_MAX),      # 4 rows < k
            (300, 2048, 32, 6, None, True, 4),         # overflow of p_max
            (8, 200, 16, 10, None, False, P_MAX),      # fewer buckets than k
            (4100, 1024, 16, 3, None, False, P_MAX)):  # two query passes
        q, keys = unit(n_q, e), unit(n_r, e)
        if same:
            q = q[:1].repeat(n_q, 1)
        check_bucket_family(
            f"D-G Q={n_q} R={n_r} E={e} k={k} valid={spec} "
            f"same_queries={same} p_max={p_max}", q, keys, k,
            mask(n_r, spec), p_max)
    for fn, x, what in ((bt.column_topk, torch.zeros(4, 4, device=dev),
                         "k = 0"),
                        (bt.row_topk, torch.zeros(4, 4, device=dev),
                         "k = 0"),
                        (bt.column_topk, torch.zeros(0, 4, device=dev),
                         "no rows"),
                        (bt.row_topk, torch.zeros(4, 0, device=dev),
                         "no columns")):
        try:
            fn(x, 0 if what.startswith("k") else 1)
        except ValueError:
            continue
        fail(f"{fn.__name__} took {what}")
    return errs


def probe_inputs(dev, small=False):
    """The three probe scripts' own inputs at their own shapes (or at the
    scripts' ``--small`` shapes), by the scripts' own input functions."""
    from ragraph_tpu_torch.bench import (exact_phases, onehot_gather,
                                         packed_table_gather)
    return {"J": exact_phases.make_inputs(dev, small=small),
            "K": packed_table_gather.make_inputs(dev, small=small),
            "L": onehot_gather.make_inputs(dev, small=small)}


def j_checks(dev, tag, kh, qh, picks, n_slots):
    """Kernel J against its plain version and kernel F's scores, each within
    TOL_SCORE, and not above kernel D's bucket maxima by more."""
    import torch

    from ragraph_tpu_torch.ops import bucket_topk as bt
    from ragraph_tpu_torch.ops import probes as pr
    n_r = kh.shape[0]
    nb = -(-n_r // bt.LANE)
    d_max = bt.bucket_max(kh, qh)
    # kernel F's scores of the first n_slots queries against every key
    assign = torch.arange(n_slots, device=dev, dtype=torch.int32) \
        .repeat(nb, 1)
    panels = bt.bucket_rescore(assign, qh, kh)      # (nb, slots, 128)
    tol = (0.0, TOL_SCORE)
    worst = 0.0
    for pick in picks:
        got = pr.matmul_probe(kh, qh, pick)
        torch.cuda.synchronize()
        worst = max(worst, check_close(
            f"J {tag} pick_row={pick}", got,
            pr.matmul_probe_plain(kh, qh, pick), tol))
        live = (torch.arange(nb, device=dev) * bt.LANE + pick) < n_r
        check_close(f"J {tag} pick_row={pick} against kernel F",
                    got[live][:, :n_slots], panels[:, :, pick][live], tol)
        over = float((got[live] - d_max[live]).max()) if live.any() else 0.0
        print(f"  J {tag} pick_row={pick}: max(J - kernel D's bucket "
              f"maximum)={over:.3e} (tol {TOL_SCORE:.0e})", flush=True)
        if over > TOL_SCORE:
            fail(f"J {tag} pick_row={pick}: a product above kernel D's "
                 f"bucket maximum")
    return worst


def j_kernel_checks(gen, dev, kh, qh):
    """Kernel J at the script's shape and at ragged small shapes; the worst
    error against the plain version at the script's shape."""
    import torch

    from ragraph_tpu_torch.ops import probes as pr
    from ragraph_tpu_torch.ops.similarity import l2_normalize
    worst = j_checks(dev, f"Q={qh.shape[0]} R={kh.shape[0]} E={kh.shape[1]}",
                     kh, qh, (0, 77), 16)
    for n_q, n_r, e, picks in ((70, 1000, 64, (5, 104)), (5, 130, 8, (1, 127)),
                               (64, 128, 256, (64,)), (1, 4097, 136, (0, 63)),
                               (130, 2048, 64, (15, 16))):
        j_checks(dev, f"Q={n_q} R={n_r} E={e}",
                 l2_normalize(torch.randn(n_r, e, generator=gen, device=dev))
                 .bfloat16(),
                 l2_normalize(torch.randn(n_q, e, generator=gen, device=dev))
                 .bfloat16(), picks, min(n_q, 8))
    for bad in (-1, 128):
        try:
            pr.matmul_probe(kh, qh, bad)
        except ValueError:
            continue
        fail(f"matmul_probe took pick_row={bad}")
    return worst


def probe_kernel_checks(rng, dev, inputs):
    """Kernels J, K and L against their plain versions at the scripts' shapes
    and at ragged small shapes; J against kernels F and D
    (:func:`j_kernel_checks`); K against kernel A bit for bit; L at
    tolerance 0."""
    import torch

    from ragraph_tpu_torch.ops import csr_segment as cs
    from ragraph_tpu_torch.ops import probes as pr
    errs = {}
    gen = torch.Generator(dev).manual_seed(SEED + 30)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    kh, qh = inputs["J"]["keys"], inputs["J"]["q_bf"]
    errs["J"] = j_kernel_checks(gen, dev, kh, qh)

    def k_checks(tag, table, w, send, indptr):
        """K with the parity split against its plain version and against
        kernel A on (table, w, send), bit for bit; then with both weights
        non-zero."""
        tp = pr.pack_table(table)
        par = (send & 1).float()
        half = (send >> 1).contiguous()
        args = (tp, w * (1 - par), w * par, half, indptr)
        got = pr.packed_table_segsum(*args)
        torch.cuda.synchronize()
        err = check_close(f"K {tag}", got, pr.packed_table_segsum_plain(*args),
                          TOL_SEGSUM)
        # one walk and one order of sums: K with the parity split is kernel
        # A on (table, w, send) to the bit
        diff = check_same(f"K {tag} against kernel A", got,
                          cs._csr_gather_scale(table, w, send, indptr, True))
        empty = indptr[1:] == indptr[:-1]
        if not bool((got[empty] == 0).all()):
            fail(f"K {tag}: an empty segment is not a zero row")
        both = (tp, w, 1 - w, half, indptr)
        check_close(f"K {tag} both weights", pr.packed_table_segsum(*both),
                    pr.packed_table_segsum_plain(*both), TOL_SEGSUM)
        return err, diff

    kin = inputs["K"]
    errs["K"], errs["K_vs_A"] = k_checks(
        f"N={kin['table'].shape[0]} D={kin['table'].shape[1]} "
        f"E={kin['send'].shape[0]}", kin["table"], kin["w"], kin["send"],
        kin["indptr"])
    for n_tab, n_rows, e, d, hub in ((64, 37, 1001, 64, False),
                                     (300, 700, 4099, 18, True),
                                     (6, 5, 3, 2, False),
                                     (64, 64, 777, 128, True),
                                     (1000, 129, 2000, 100, False)):
        k_checks(f"table={n_tab} rows={n_rows} E={e} D={d} hub={hub}",
                 torch.randn(n_tab, d, generator=gen, device=dev),
                 torch.rand(e, generator=gen, device=dev),
                 t(rng.integers(0, n_tab, e), torch.int32),
                 random_indptr(rng, dev, e, n_rows, hub))
    try:
        pr.packed_table_segsum(torch.zeros(4, 2 * 130, device=dev), kin["w"],
                               kin["w"], kin["send"], kin["indptr"])
    except ValueError:
        pass
    else:
        fail("packed_table_segsum took D = 130")

    lin = inputs["L"]
    got = pr.onehot_block_gather(lin["col"], lin["table"])
    torch.cuda.synchronize()
    errs["L"] = check_same(
        f"L blocks={lin['col'].shape[0]} P={lin['col'].shape[1]} "
        f"D={lin['table'].shape[1]}", got.float(),
        pr.onehot_block_gather_plain(lin["col"], lin["table"]).float())
    check_same("L against table[senders]", got[lin["slot"]].float(),
               lin["table"][lin["senders"].long()].float())
    del got
    for n, e, d in ((300, 1000, 8), (128, 5, 512), (1000, 4099, 72),
                    (129, 0, 64)):
        send = np.sort(rng.integers(0, n, e))
        col, p, _, slot = pr.build_onehot_layout(send, n)
        col = col.copy()
        col[0, -1], col[-1, -2] = -1, 500       # outside [0, 128): zero rows
        col_t = t(col, torch.int32)
        table = torch.randn(n, d, generator=gen, device=dev).bfloat16()
        got = pr.onehot_block_gather(col_t, table)
        torch.cuda.synchronize()
        check_same(f"L N={n} E={e} D={d} P={p}", got.float(),
                   pr.onehot_block_gather_plain(col_t, table).float())
        if e:
            check_same(f"L N={n} E={e} D={d} against table[senders]",
                       got[t(slot, torch.int64)].float(),
                       table[t(send, torch.int64)].float())
    return errs


def phase_kernel_checks(rng, dev, graph, probes):
    import torch

    from ragraph_tpu_torch.ops import csr_segment as cs
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
        check_same(f"A bf16={bf16} main shape, a second call", got,
                   cs.gather_scale_segsum(table, *args, bf16=bf16))
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
    errs.update(bucket_kernel_checks(gen, dev, q, keys))
    del q, keys
    errs.update(hi_kernel_checks(rng, dev, graph))
    errs.update(probe_kernel_checks(rng, dev, probes))

    for n, e, d, hub in ((37, 1001, 64, False), (300, 4099, 18, True),
                         (5, 3, 2, False), (64, 777, 130, True),
                         (129, 2000, 256, False)):
        segsum_checks(rng, dev, n, e, d, hub)
    c_kernel_checks(gen, dev)
    edge_weights_checks(dev)
    return errs


EW_EDGES = 17_590_808       # edge-taobao's directed edges
EW_RAGGED = (1, 31, (1 << 20) + 3)
EW_BYTES_PER_EDGE = 28      # norms, time softmax, weight a order; send_perm


def edge_weights_checks(dev):
    """``rg_edge_weights`` against the composition it replaces
    (``edge_weights_plain`` on the card: the int64 hash, the fold and
    ``torch.where``), bit for bit, at edge-taobao's 17,590,808 edges and at
    ragged sizes: both orders and receiver order alone, one and two draws,
    no time and the fold at two coefficients, and inputs 4 bytes off the
    16-byte boundary (its 4-byte path). Then its device time beside the
    composition's and its bytes bound, 28 bytes a directed edge read or
    written once."""
    import torch

    from ragraph_tpu_torch.ops.edge_weights import (edge_weights,
                                                    edge_weights_plain)
    gen = torch.Generator(dev).manual_seed(SEED + 23)
    salts = torch.randint(0, 1 << 32, (2,), generator=gen, device=dev)
    cases = mismatched = 0
    timing = None
    for n in EW_RAGGED + (EW_EDGES,):
        for offset in ((0, 1) if n == 31 else (0,)):
            def rand(scale=1.0):
                return (torch.rand(n + offset, generator=gen, device=dev)
                        * scale)[offset:]
            en, en_s = rand(), rand()
            tn, tn_s = rand(1e-3), rand(1e-3)
            perm = torch.cat([torch.zeros(offset, dtype=torch.int32,
                                          device=dev),
                              torch.randperm(n, generator=gen, device=dev)
                              .int()])[offset:]
            for n_draws in (1, 2):
                draws = [(salts[0], 0.5), (salts[1], 0.9)][:n_draws]
                for c in (None, 1.0, 0.5 / (0.5 * 0.9)):
                    for send in (True, False):
                        args = (draws, en, tn, c) + (
                            (perm, en_s, tn_s) if send else ())
                        got = edge_weights(*args)
                        want = edge_weights_plain(*args)
                        for g_, w_ in zip(got, want):
                            if (g_ is None) != (w_ is None):
                                fail(f"rg_edge_weights n={n}: sender order "
                                     f"{g_ is None} against {w_ is None}")
                            if g_ is not None:
                                mismatched += int((g_.view(torch.int32)
                                                   != w_.view(torch.int32))
                                                  .sum())
                        cases += 1
            if n == EW_EDGES:
                draws = [(salts[0], 0.5)]
                args = (draws, en, tn, 1.0, perm, en_s, tn_s)
                two = ([(salts[0], 0.5), (salts[1], 0.9)], en, tn,
                       0.5 / (0.5 * 0.9), perm, en_s, tn_s)
                bound = EW_BYTES_PER_EDGE * n / HBM_BYTES_PER_MS
                dev_ms = device_ms(lambda: edge_weights(*args))
                timing = {
                    "edges": n, "bound_ms": bound,
                    "device_ms": dev_ms, "share": bound / dev_ms,
                    "ms": cuda_ms(lambda: edge_weights(*args)),
                    "two_draws_device_ms": device_ms(
                        lambda: edge_weights(*two)),
                    "composition_device_ms": device_ms(
                        lambda: edge_weights_plain(*args), reps=5),
                    "composition_ms": cuda_ms(
                        lambda: edge_weights_plain(*args), reps=5),
                    "two_draws_composition_device_ms": device_ms(
                        lambda: edge_weights_plain(*two), reps=5)}
            del en, en_s, tn, tn_s, perm
    torch.cuda.synchronize()
    print(f"  rg_edge_weights: {cases} cases at n = "
          f"{EW_RAGGED + (EW_EDGES,)}, bit mismatches {mismatched} "
          f"{'ok' if mismatched == 0 else 'MISMATCH'}", flush=True)
    if mismatched:
        fail("rg_edge_weights disagrees with the composition it replaces")
    print(json.dumps({"edge_weights_timing": timing}), flush=True)
    return timing


def c_kernel_checks(gen, dev):
    """Kernel C at ragged shapes (Q = 1 and 3, R = 3, E = 8, 136 and 256,
    k = 1 and 128, valid masks), at the edges of its pipeline (fewer key
    tiles than ring stages: R = 3, 129, 257; Q not a multiple of the
    block's queries, in blocks of 64 and of 128; k = 16 and 17, the switch
    between the lane and the warp insert; a valid mask that empties whole
    tiles; E = 512 in chunks) and on exact ties. At every shape its scores
    are bit for bit the score matrix's at the same indices."""
    import torch

    from ragraph_tpu_torch.ops.fused_retrieval import fused_cosine_topk
    from ragraph_tpu_torch.ops.similarity import l2_normalize
    big = 17_001   # 133 blocks of 128 queries: the plan takes blocks of 128
    for q_len, r_len, e, k, n_valid in (
            (1, 1000, 64, 10, None), (77, 1000, 64, 1, None),
            (130, 4097, 64, 50, None), (65, 3000, 64, 128, None),
            (33, 1000, 64, 10, 400), (9, 500, 64, 10, 5),
            (3, 3, 64, 10, None), (70, 1234, 8, 10, None),
            (40, 900, 136, 50, None), (20, 700, 256, 128, 300),
            (5, 129, 64, 10, None), (300, 257, 64, 16, None),
            (70, 257, 136, 17, None), (200, 2000, 64, 16, "tiles"),
            (200, 2000, 64, 17, "tiles"), (50, 1500, 512, 10, None),
            (7, 600, 1000, 20, "tiles"), (big, 3000, 64, 10, "tiles"),
            (big, 1000, 64, 17, None), (big, 1000, 256, 20, None),
            (big, 600, 512, 10, None)):
        q = l2_normalize(torch.randn(q_len, e, generator=gen, device=dev))
        keys = l2_normalize(torch.randn(r_len, e, generator=gen, device=dev))
        valid = None
        if n_valid == "tiles":
            # tiles 1-3 and the last 100 keys empty, half of the rest
            valid = torch.rand(r_len, generator=gen, device=dev) < 0.5
            valid[128:512] = False
            valid[-100:] = False
        elif n_valid is not None:
            valid = torch.zeros(r_len, dtype=torch.bool, device=dev)
            valid[torch.randperm(r_len, generator=gen,
                                 device=dev)[:n_valid]] = True
        name = f"C Q={q_len} R={r_len} E={e} k={k} valid={n_valid}"
        check_topk(name, q, keys, k, valid)
        c_equals_score_matrix(name, q, keys, k, valid)
    # exact ties: duplicated keys must come out lowest index first
    keys = l2_normalize(torch.randn(1, 64, generator=gen, device=dev))
    keys = keys.repeat(300, 1)
    q = l2_normalize(torch.randn(4, 64, generator=gen, device=dev))
    check_topk("C ties R=300 k=10", q, keys, 10)
    _, i = fused_cosine_topk(q, keys, 10)
    if not bool((i == torch.arange(10, device=dev)).all()):
        fail(f"C ties: expected indices 0..9, got {i[0].tolist()}")
    c_one_call_checks(gen, dev)


def c_equals_score_matrix(name, q, keys, k, valid=None):
    """Kernel C's scores bit for bit the score matrix's
    (``score_tile.score_matrix``, kernel D's tile) at C's indices, for
    every live entry: the two take the same k16 steps in the same order."""
    import torch

    from ragraph_tpu_torch.ops.fused_retrieval import NEG_INF, \
        fused_cosine_topk
    from ragraph_tpu_torch.ops.score_tile import bf16_rows, score_matrix
    s, i = fused_cosine_topk(q, keys, k, valid_mask=valid)
    sm = score_matrix(bf16_rows(keys), bf16_rows(q), valid)
    live = s > NEG_INF
    same = torch.equal(s[live], sm.gather(1, i.long())[live])
    print(f"  {name}: scores {'bit for bit' if same else 'MISMATCH'} the "
          f"score matrix's", flush=True)
    if not same:
        fail(f"{name}: scores differ from the score matrix's")


def c_one_call_checks(gen, dev, n=C_CELL_ROWS, chunk=C_CELL_CHUNK):
    """Kernel C at an edge finetune step's shape (every node's query
    against a library of as many unit rows, E = 64): one call over all
    queries equals the calls over ``chunk`` rows each bit for bit, scores
    and indices, at k = 10 and 20; the device time of each."""
    import torch

    from ragraph_tpu_torch.ops.fused_retrieval import fused_cosine_topk
    from ragraph_tpu_torch.ops.similarity import l2_normalize
    q = l2_normalize(torch.randn(n, D, generator=gen, device=dev))
    keys = l2_normalize(torch.randn(n, D, generator=gen, device=dev))

    def chunked(k):
        parts = [fused_cosine_topk(q[s:s + chunk], keys, k)
                 for s in range(0, n, chunk)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    for k in (K_PATH, 2 * K_PATH):
        s1, i1 = fused_cosine_topk(q, keys, k)
        s2, i2 = chunked(k)
        same = torch.equal(s1, s2) and torch.equal(i1, i2)
        one_ms = device_ms(lambda: fused_cosine_topk(q, keys, k), reps=3)
        chunked_ms = device_ms(lambda: chunked(k), reps=3)
        print(f"  C Q=R={n} E={D} k={k}: one call {one_ms:.3f} ms (device), "
              f"{-(-n // chunk)} calls of {chunk} {chunked_ms:.3f} ms; "
              f"{'bit for bit' if same else 'MISMATCH'}", flush=True)
        print(json.dumps({"c_one_call": {
            "rows": n, "k": k, "one_call_device_ms": one_ms,
            "chunked_device_ms": chunked_ms, "chunk": chunk,
            "bit_for_bit": same}}), flush=True)
        if not same:
            fail(f"C at Q=R={n} k={k}: one call differs from the calls of "
                 f"{chunk}")
    del q, keys


def phase_sass(lib_path):
    """Kernels C, D, F and J must run on the tensor cores: ``cuobjdump
    -sass`` of the built library, and in every instantiation of C's partial
    kernel and of D's, F's and J's kernels at least one ``HGMMA`` or
    ``HMMA`` instruction."""
    from ragraph_tpu_torch import native
    tool = os.path.join(os.path.dirname(native._nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass failed: {res.stderr.strip()[:500]}")
    counts, func = {}, None      # mangled kernel name -> instructions
    for line in res.stdout.splitlines():
        if "Function :" in line:
            func = line.split("Function :", 1)[1].strip()
            counts[func] = 0
        elif func is not None and ("HGMMA" in line or "HMMA" in line):
            counts[func] += 1
    found = {}
    for kernel in ("topk_partial_kernel", "bucket_max_kernel",
                   "bucket_rescore_kernel", "mm_probe_kernel"):
        mine = {f: n for f, n in counts.items() if kernel in f}
        for f, n in mine.items():
            print(f"  SASS {f}: {n} HGMMA/HMMA instructions", flush=True)
        if not mine or any(n == 0 for n in mine.values()):
            fail(f"{kernel}: no tensor-core instruction in its machine code "
                 f"({mine})")
        found[kernel] = mine
    print(json.dumps({"sass_tensor_core_instructions": found}), flush=True)


def phase_register_lists(log):
    """Kernels E and G keep their top-k lists in registers, and kernels A
    and K their row loads: in the ``-Xptxas -v`` build log every
    instantiation of E's and G's kernels (list lengths 32, 64, 128, two
    load widths: six each) and the walk of a 64-wide bf16 row that A and K
    run on the main path must show no stack frame and no spill."""
    import re
    walks = (r"walk_kernelINS_9TableRowsI13__nv_bfloat16Li16EEELi8ELi1E",
             r"walk_kernelINS_10PackedRowsILi16EEELi8ELi1E")
    found, func = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            func = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and func and (re.search(r"(column|row)_topk_kernelILi", func)
                           or any(re.search(w, func) for w in walks)):
            found[func] = tuple(int(g) for g in m.groups())
        func = None
    for f, (frame, st, ld) in found.items():
        print(f"  ptxas {f}: {frame} bytes stack frame, {st} bytes spill "
              f"stores, {ld} bytes spill loads", flush=True)
    if len(found) != 14:
        fail(f"kernels E, G, A and K: {len(found)} of 14 instantiations "
             f"found in the ptxas log")
    if any(any(v) for v in found.values()):
        fail("a kernel of E, G, A or K has a stack frame or spills")


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
    return launches, keys


def layer0_queries(params):
    """The RAG queries of a vanilla-phase ``generate``: layer 0, the tables
    themselves."""
    import torch
    return torch.cat([params["user_embedding"], params["item_embedding"]])


def phase_exact_tier(dev, params, keys):
    """Every chunk of the refresh's queries through the exact tier, as
    ``_fuse_rag`` would call it with exact results asked for."""
    import torch

    from ragraph_tpu_torch import native
    from ragraph_tpu_torch.ops import bucket_topk as bt
    from ragraph_tpu_torch.ops.score_tile import fma_chain
    from ragraph_tpu_torch.ops.fused_retrieval import fused_cosine_topk
    from ragraph_tpu_torch.ops.similarity import l2_normalize
    from ragraph_tpu_torch.ops.topk import cosine_topk
    queries = layer0_queries(params)
    keys_n = l2_normalize(keys)
    n = queries.shape[0]
    n_chunks = -(-n // CHUNK)
    print(f"phase 4a: exact tier, {n_chunks} chunks of {CHUNK} queries "
          f"against {keys_n.shape[0]} rows, k = {K_PATH}", flush=True)
    if keys_n.shape[0] != U + I or n_chunks != 128:
        fail("exact tier: not the refresh's 128 chunks at R = 262,144")

    def bucket_tier():
        return [cosine_topk(queries[s:s + CHUNK], keys_n, K_PATH,
                            keys_normalized=True, method="auto",
                            recall_target=1.0) for s in range(0, n, CHUNK)]

    timer = StageTimer()
    native.reset_launches()
    out = timer("exact_tier", bucket_tier)
    launches = dict(native.LAUNCHES)
    timer("exact_tier_warm", bucket_tier)
    q_n = l2_normalize(queries)
    ref = timer("fused_kernel_same_chunks", lambda: [
        fused_cosine_topk(q_n[s:s + CHUNK], keys_n, K_PATH)
        for s in range(0, n, CHUNK)])
    print(json.dumps({"exact_tier_ms": timer.ms, "launches": launches}),
          flush=True)
    # kernel F's launches past one a chunk: the rounds for the queries
    # beyond P_MAX in a bucket, from each chunk's bucket demand
    kh = keys_n.to(torch.bfloat16).contiguous()
    nb = -(-kh.shape[0] // bt.LANE)
    rounds = 0
    for s0 in range(0, n, CHUNK):
        qh = l2_normalize(queries[s0:s0 + CHUNK]).to(torch.bfloat16)
        bvals, ids = bt.column_topk(bt.bucket_max(kh, qh.contiguous()),
                                    K_PATH)
        ids = torch.where(bvals <= bt.NEG_INF, nb, ids)
        demand = int(torch.bincount(ids.reshape(-1), minlength=nb + 1)[:nb]
                     .max())
        rounds += max(1, -(-demand // P_MAX)) - 1
    del kh
    print(f"  exact tier: bucket_rescore launched "
          f"{launches.get('bucket_rescore', 0)} times = {n_chunks} chunks + "
          f"{rounds} overflow rounds", flush=True)
    want = {"bucket_max": n_chunks, "column_topk": n_chunks,
            "bucket_rescore": n_chunks + rounds, "row_topk": n_chunks}
    for name, n_want in want.items():
        if launches.get(name, 0) != n_want:
            fail(f"exact tier: kernel {name} launched "
                 f"{launches.get(name, 0)} times, expected {n_want}")
    s, i = (torch.cat([o[j] for o in out]) for j in (0, 1))
    cs, ci = (torch.cat([o[j] for o in ref]) for j in (0, 1))
    if s.shape != (n, K_PATH) or not bool(torch.isfinite(s).all()):
        fail("exact tier: wrong shape or non-finite scores")
    err = float((s - cs).abs().max())
    diff = i != ci
    bad = err > TOL_SCORE
    tie_err = 0.0
    if diff.any():      # another index only where the score is (all but) the
        rows = diff.nonzero()[:, 0]     # same: the tier's pick by its order
        picked = fma_chain(q_n.to(torch.bfloat16)[rows],
                            keys_n.to(torch.bfloat16)[i[diff].long()])
        tie_err = float((picked - cs[diff]).abs().max())
        bad |= tie_err > TOL_SCORE
    print(f"  exact tier against kernel C: max_abs_err={err:.3e} "
          f"tol={TOL_SCORE:.0e} index_ties={int(diff.sum())} "
          f"(tie max_abs_err={tie_err:.3e}) "
          f"{'ok' if not bad else 'MISMATCH'}", flush=True)
    if bad:
        fail("exact tier disagrees with the fused kernel")
    exact_tier_profile(queries, keys_n)
    return launches


def exact_tier_profile(queries, keys_n, n_chunks=8):
    """A ``torch.profiler`` window over ``n_chunks`` chunks of the exact
    tier, after a warm pass: the device's busy share (kernel and copy time
    over the span from the first device event to the last), the host-clock
    time of the window (tracing on) and the device time by kernel name.
    It measures and decides nothing: a profiler that does not start, or a
    trace without device time, prints "not measured", while an error of
    the tier itself ends the script as anywhere else."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ragraph_tpu_torch.ops.topk import cosine_topk

    def run():
        for s0 in range(0, n_chunks * CHUNK, CHUNK):
            cosine_topk(queries[s0:s0 + CHUNK], keys_n, K_PATH,
                        keys_normalized=True, method="auto",
                        recall_target=1.0)
        torch.cuda.synchronize()

    def not_measured(why):
        print(json.dumps({"exact_tier_profile": f"not measured ({why})"}),
              flush=True)

    run()
    # only the profiler's own set-up and the reading of its trace may fail
    # quietly; an error of the kernels or the glue in run() ends the script
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except Exception as exc:
        not_measured(f"{type(exc).__name__}: {exc}")
        return
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    try:
        prof.stop()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        by_name = {}            # names cut to 100 characters, summed
        for e in events:
            by_name[e.name[:100]] = (by_name.get(e.name[:100], 0.0)
                                     + e.time_range.elapsed_us() / 1e3)
        busy = sum(by_name.values())
        span = (max(e.time_range.end for e in events)
                - min(e.time_range.start for e in events)) / 1e3 \
            if events else 0.0
    except Exception as exc:
        not_measured(f"{type(exc).__name__}: {exc}")
        return
    if not busy > 0 or not span > 0:
        not_measured("no device time in the trace")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:14]
    print(json.dumps({"exact_tier_profile": {
        "chunks": n_chunks, "host_window_ms_tracing_on": wall_ms,
        "device_span_ms": span, "device_busy_ms": busy,
        "device_busy_share_of_span": busy / span,
        "device_ms_by_name": dict(top)}}),
        flush=True)


def phase_huge_k(dev, graph, params):
    """A RAG ``generate`` with the koubei ``vanilla`` config: k = 100,000 of
    a 524,288-row library by the k-th-score threshold, 512 chunks of 512
    queries, for both selection dtypes."""
    import dataclasses

    import torch

    from ragraph_tpu_torch import native
    from ragraph_tpu_torch.models.edge import RAGraphEdge, edge_config_for
    from ragraph_tpu_torch.models.edge import ragraph_edge
    from ragraph_tpu_torch.ops.selection import rowwise_kth_largest
    from ragraph_tpu_torch.ops.similarity import l2_normalize
    cfg = edge_config_for("koubei", "vanilla", emb_size=D)
    k, chunk, w = cfg.retrieve_num, cfg.rag_chunk, cfg.retrieve_weight
    print(f"phase 4b: huge-k tier, koubei vanilla: retrieve_num={k} "
          f"rag_chunk={chunk} num_augment_scale={cfg.num_augment_scale}",
          flush=True)
    model = RAGraphEdge(cfg, graph, phase="vanilla")
    gen = torch.Generator(dev).manual_seed(SEED + 6)
    timer = StageTimer()
    native.reset_launches()
    plain = torch.cat(timer("generate", lambda: model.generate(params)))
    keys, values = timer("make_resource_graph", lambda: model
                         .make_resource_graph(*plain.split([U, I]), gen))
    k = min(k, keys.shape[0])
    if tuple(keys.shape) != (2 * (U + I), D) \
            or k * D <= ragraph_edge._BIG_K_ELEMS:
        fail(f"huge-k tier: library {tuple(keys.shape)}, k * E = {k * D}")
    fused = {}
    for sel in ("f32", "bf16"):
        model.cfg = dataclasses.replace(cfg, selection_dtype=sel)
        fused[sel] = torch.cat(timer(f"generate_huge_k_{sel}",
                                     lambda: model.generate(params)))
    launches = dict(native.LAUNCHES)
    if launches.get("csr_gather_scale_segsum", 0) <= 0:
        fail("huge-k tier: the propagation kernel was not launched")

    # a few chunks against torch.topk at the same k
    queries = layer0_queries(params)
    keys_n = l2_normalize(keys)
    n_chunks = -(-queries.shape[0] // chunk)
    v_max = float(values.abs().max())
    detail = {}
    for sel in ("f32", "bf16"):
        model.cfg = dataclasses.replace(cfg, selection_dtype=sel)
        kn = keys_n.to(torch.bfloat16) if sel == "bf16" else keys_n
        if tuple(fused[sel].shape) != (U + I, D) \
                or not bool(torch.isfinite(fused[sel]).all()):
            fail(f"huge-k {sel}: wrong shape or non-finite embeddings")
        worst = {"mean_err": 0.0, "index_err": 0.0, "extra_members": 0}
        for c in (0, n_chunks // 2, n_chunks - 1):
            rows = slice(c * chunk, (c + 1) * chunk)
            qc = queries[rows]
            mean = model._fuse_rag(qc, torch.zeros_like(qc)) / w
            # the full run holds the same fusion of the same rows
            whole = (1.0 - w) * plain[rows] + w * mean
            if float((fused[sel][rows] - whole).abs().max()) > 1e-6:
                fail(f"huge-k {sel} chunk {c}: generate disagrees with its "
                     f"own chunk")
            scores = l2_normalize(qc).to(kn.dtype) @ kn.T
            top_v, top_i = torch.topk(scores, k, dim=1)
            kth = rowwise_kth_largest(scores, k)
            if not torch.equal(kth, top_v[:, -1:]):
                fail(f"huge-k {sel} chunk {c}: the threshold is not "
                     f"torch.topk's k-th value")
            member = scores >= top_v[:, -1:]
            count = member.sum(dim=1, keepdim=True)
            ref = (member.to(values.dtype) @ values) / count
            # same members, the same product: 1e-3 of the means' scale
            # covers a sum taken in another order
            scale = float(ref.abs().max())
            worst["mean_err"] = max(worst["mean_err"],
                                    float((mean - ref).abs().max()) / scale)
            # the index path on 16 rows: values[topk].mean, which differs by
            # the members tied at the k-th score, at most 2 V (c - k) / c
            index_mean = values[top_i[:16]].mean(dim=1)
            extra = (count[:16] - k).float()
            slack = 2.0 * v_max * extra / count[:16] + 1e-3 * scale
            over = ((mean[:16] - index_mean).abs() - slack).max()
            worst["index_err"] = max(worst["index_err"], float(over))
            worst["extra_members"] = max(worst["extra_members"],
                                         int((count - k).max()))
            del scores, top_v, top_i, member, index_mean
        ok = worst["mean_err"] <= 1e-3 and worst["index_err"] <= 0.0
        print(f"  huge-k {sel} against torch.topk: mean rel_err="
              f"{worst['mean_err']:.3e} tol=1e-03, index path beyond its "
              f"tie slack by {worst['index_err']:.3e} (tol 0), up to "
              f"{worst['extra_members']} members tied past k "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"huge-k {sel} disagrees with the index path")
        # the selection beside its library yardstick, one chunk
        scores = l2_normalize(queries[:chunk]).to(kn.dtype) @ kn.T
        detail[f"kth_largest_{sel}_ms"] = cuda_ms(
            lambda: rowwise_kth_largest(scores, k), reps=3, warmup=1)
        detail[f"library_topk_kth_{sel}_ms"] = cuda_ms(
            lambda: torch.topk(scores, k, dim=1)[0][:, -1:], reps=3,
            warmup=1)
        del scores
    if float((fused["f32"] - plain).abs().max()) == 0.0:
        fail("huge-k fusion left the embeddings unchanged")
    print(json.dumps({"huge_k_ms": timer.ms, "launches": launches,
                      "selection_ms": detail}), flush=True)


def phase_int8(dev, params, keys):
    """One chunk through the int8 tier: a pre-quantized table and an exact
    rescore of k + 22 candidates."""
    import torch

    from ragraph_tpu_torch.ops.similarity import l2_normalize
    from ragraph_tpu_torch.ops.topk import cosine_topk, quantize_keys_i8
    print(f"phase 4c: int8 tier, one chunk of {CHUNK} queries against "
          f"{keys.shape[0]} rows, rescore_pad=22", flush=True)
    qc = layer0_queries(params)[:CHUNK]
    keys_n = l2_normalize(keys)
    timer = StageTimer()
    table = timer("quantize_keys_i8",
                  lambda: quantize_keys_i8(keys_n, normalized=True))
    exact_s, exact_i = cosine_topk(qc, keys_n, K_PATH, keys_normalized=True,
                                   method="exact")
    kw = dict(keys_normalized=True, method="approx", score_dtype="int8")
    for _ in range(2):      # the second pass is warm
        _, plain_i = timer("int8_topk", lambda: cosine_topk(
            qc, table, K_PATH, **kw))
        s, i = timer("int8_topk_rescore_pad_22", lambda: cosine_topk(
            qc, table, K_PATH, rescore_pad=22, rescore_keys=keys_n, **kw))

    def recall(idx):
        return float((idx[:, :, None] == exact_i[:, None, :]).any(dim=2)
                     .float().mean())

    r_plain, r_rescore = recall(plain_i), recall(i)
    true = (l2_normalize(qc)[:, None, :] * keys_n[i]).sum(dim=-1)
    err = float((s - true).abs().max())
    print(json.dumps({"int8_ms": timer.ms, "recall@10_int8": r_plain,
                      "recall@10_int8_rescore_pad_22": r_rescore}),
          flush=True)
    print(f"  int8 rescored scores against f32 cosines: max_abs_err="
          f"{err:.3e} tol={TOL_SCORE:.0e}", flush=True)
    if tuple(i.shape) != (CHUNK, K_PATH) or err > TOL_SCORE \
            or not r_rescore >= r_plain or r_rescore < 0.5:
        fail(f"int8 tier: recall {r_plain} -> {r_rescore}, score error {err}")


def phase_ops_path(dev, graph):
    """The public ops path on the 2^21 edges: ``sorted_segment_sum`` (kernel
    H, then the boundary difference) against kernel B's sums of the same
    messages, and ``segsum_packed2_w`` (kernel I) against kernel A's sums
    over the same edges."""
    import torch

    from ragraph_tpu_torch import native, ops
    from ragraph_tpu_torch.ops import csr_segment as cs
    g = graph
    n = g.num_edges
    print(f"phase 4d: ops path, {n} messages x {D}, packed "
          f"({n // 2}, {2 * D})", flush=True)
    gen = torch.Generator(dev).manual_seed(SEED + 21)
    table = torch.randn(g.num_nodes, D, generator=gen, device=dev)
    w = g.edge_norm * 0.5 + g.time_norm * 0.5
    w_send = g.edge_norm_send * 0.5 + g.time_norm_send * 0.5
    rows = table[g.senders.long()]
    msgs = rows * w[:, None]
    msgs2 = pack_half_split(rows, 512)
    del rows
    timer = StageTimer()
    native.reset_launches()
    by_prefix = timer("sorted_segment_sum", lambda: ops.sorted_segment_sum(
        msgs, g.recv_indptr[:-1], g.recv_indptr[1:]))
    by_packed = timer("segsum_packed2_w", lambda: ops.segsum_packed2_w(
        msgs2, w, g.recv_indptr, n))
    launches = dict(native.LAUNCHES)
    for name in ("prefix_sum", "csr_segsum_packed2_w"):
        if launches.get(name, 0) != 1:
            fail(f"ops path: kernel {name} launched "
                 f"{launches.get(name, 0)} times, expected 1")
    timer("sorted_segment_sum_warm", lambda: ops.sorted_segment_sum(
        msgs, g.recv_indptr[:-1], g.recv_indptr[1:]))
    timer("segsum_packed2_w_warm", lambda: ops.segsum_packed2_w(
        msgs2, w, g.recv_indptr, n))
    direct = timer("kernel_B_same_messages",
                   lambda: cs.csr_segment_sum(msgs, g.recv_indptr))
    fused = timer("kernel_A_same_edges", lambda: cs.gather_scale_segsum(
        table, w, w_send, g.senders, g.recv_indptr, g.recv_of_send,
        g.send_indptr, bf16=True, recv_plan=g.recv_plan,
        send_plan=g.send_plan))
    scale = float(torch.cumsum(msgs.double(), 0).abs().max())
    err = float((by_prefix - direct).abs().max())
    tol = TOL_PREFIX_DIFF * scale
    ok = err <= tol and bool(torch.isfinite(by_prefix).all())
    print(f"  sorted_segment_sum (H) against kernel B: max_abs_err={err:.3e} "
          f"tol={tol:.3e} = {TOL_PREFIX_DIFF:.0e} x prefix size {scale:.3e}; "
          f"sums reach {float(direct.abs().max()):.3e} "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok or tuple(by_prefix.shape) != (g.num_nodes, D):
        fail("sorted_segment_sum disagrees with kernel B")
    check_close("segsum_packed2_w (I) against kernel A", by_packed, fused,
                TOL_SEGSUM)
    print(json.dumps({"ops_path_ms": timer.ms, "launches": launches}),
          flush=True)
    return launches


def fixed_masks(graph, salt, keep):
    """The hash masks of one salt in both edge orders, on the graph's
    device: the same bits on the card and on the CPU."""
    import torch

    from ragraph_tpu_torch.models.edge.base import hash_edge_mask
    ids = torch.arange(graph.num_edges, device=graph.device)
    return (hash_edge_mask(salt, ids, keep),
            hash_edge_mask(salt, graph.send_perm, keep))


def loss_and_grads(model, params, batch, masks, generator=None):
    """One ``cal_loss`` and backward on fresh leaves: the loss and every
    gradient by parameter name."""
    from ragraph_tpu_torch.train.trainer import map_params, param_leaves
    leaves = map_params(lambda t: t.detach().clone().requires_grad_(True),
                        params)
    loss, _ = model.cal_loss(leaves, batch, generator, edge_masks=masks)
    loss.backward()
    return loss.detach(), {name: t.grad for name, t in param_leaves(leaves)}


def phase_small_training_agreement(dev):
    """One training step of each phase on a small graph: loss and gradients
    on the card against the same step on CPU tensors (plain versions)."""
    import torch

    from ragraph_tpu_torch.bench.main_path import make_rows, xavier_tables
    from ragraph_tpu_torch.convert import params_from_jax
    from ragraph_tpu_torch.data.edgelist import load_edge_dataset
    from ragraph_tpu_torch.models.edge import (EdgeGraphArrays,
                                               EdgeModelConfig, RAGraphEdge)
    from ragraph_tpu_torch.train.trainer import map_params
    print("phase 5: one training step, card against CPU", flush=True)
    rng = np.random.default_rng(SEED + 7)
    train, test = make_rows(rng, 256, 256, 4096)
    ds = load_edge_dataset(train, test, num_users=256, num_items=256)
    tables = xavier_tables(rng, 256, 256, D)
    batch = [rng.integers(0, 256, 512) for _ in range(3)]
    for phase, extra in (("pretrain", {}), ("finetune", {}),
                         ("finetune", dict(use_lora=True,
                                           lora_init_scale=1.0,
                                           lora_rank=8))):
        cfg = EdgeModelConfig(emb_size=D, segsum_impl="fused",
                              propagate_dtype="f32", **extra)
        out, init = [], None
        for where in (torch.device("cpu"), dev):
            g = EdgeGraphArrays.from_dataset(ds, where)
            model = RAGraphEdge(cfg, g, phase=phase)
            base = params_from_jax(tables, where)
            if phase == "finetune":
                model.make_resource_graph(base["user_embedding"],
                                          base["item_embedding"])
                # the CPU's initial gate and factors go to the card as data
                init = init or model.init_params(
                    torch.Generator(where).manual_seed(SEED),
                    pretrained_tables=(base["user_embedding"],
                                       base["item_embedding"]))
                base = map_params(lambda t: t.to(where), init)
            b = tuple(torch.from_numpy(a).to(where) for a in batch)
            out.append(loss_and_grads(
                model, base, b, fixed_masks(g, 0x9E3779B1, 0.5)))
        (cl, cg), (gl, gg) = out
        tag = f"{phase} {extra or ''}".strip()
        check_close(f"small graph {tag} loss", gl.cpu()[None], cl[None],
                    TOL_GRAD)
        for name in cg:
            if gg[name] is None or float(cg[name].abs().max()) == 0.0:
                fail(f"small graph {tag}: no gradient for {name}")
            check_close(f"small graph {tag} grad {name}", gg[name].cpu(),
                        cg[name], TOL_GRAD)


def phase_small_agreement(dev):
    """The same path on a small graph, on the card and on the CPU."""
    import torch

    from ragraph_tpu_torch.bench.main_path import make_rows, xavier_tables
    from ragraph_tpu_torch.convert import params_from_jax
    from ragraph_tpu_torch.data.edgelist import load_edge_dataset
    from ragraph_tpu_torch.models.edge import (EdgeGraphArrays,
                                               EdgeModelConfig, RAGraphEdge)
    print("phase 5: small graph, card against CPU", flush=True)
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


def cli_files(save_dir):
    """``(result files, run logs)`` a CLI left in ``save_dir``, sorted: the
    run logs are the ``train_log_<stamp>.txt`` files, one for each second
    in which a mode started."""
    files = sorted(os.listdir(save_dir))
    logs = [f for f in files if f.startswith("train_log_")
            and f.endswith(".txt")]
    return [f for f in files if f not in logs], logs


def phase_cli(dev):
    """The port's CLI on the synthetic stream, on the card: ``vanilla`` from
    given tables, then ``pretrain``, ``finetune`` and ``vanilla`` in order
    from the tables ``pretrain`` wrote."""
    import os
    import tempfile

    from ragraph_tpu_torch.bench.main_path import xavier_tables
    from ragraph_tpu_torch.cli import edge as cli
    from ragraph_tpu_torch.train.checkpoint import save_checkpoint
    print("phase 5: CLI on the card (synthetic stream)", flush=True)
    rng = np.random.default_rng(SEED + 5)
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(f"{tmp}/pretrain_RAGraph_SYNTH",
                        xavier_tables(rng, 64, 128, D))
        recalls, ndcgs = cli.main(["vanilla", "--data-path", "SYNTH",
                                   "--save-dir", tmp,
                                   "--device", str(dev)])
    if len(recalls) != 4 or not np.isfinite(recalls + ndcgs).all():
        fail(f"vanilla CLI: recalls {recalls} ndcgs {ndcgs}")
    print(f"  vanilla: recall@20 per stage {recalls}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        args = ["--data-path", "SYNTH", "--save-dir", tmp, "--device",
                str(dev), "--batch-size", "128", "--epochs", "3"]
        cli.main(["pretrain"] + args)
        staged = cli.main(["finetune"] + args)
        recalls, ndcgs = cli.main(["vanilla"] + args)
        files, logs = cli_files(tmp)
    want = ["finetune_RAGraph_SYNTH.json", "pretrain_RAGraph_SYNTH.json",
            "pretrain_RAGraph_SYNTH.pkl"]
    if files != want or not logs:
        fail(f"CLI wrote {files} and run logs {logs}, expected {want} and "
             f"train_log_*.txt")
    if len(staged.recalls) != 4 or len(recalls) != 4 or not np.isfinite(
            staged.recalls + staged.ndcgs + recalls + ndcgs).all():
        fail(f"CLI: finetune {staged.recalls}, vanilla {recalls}")
    print(f"  pretrain -> finetune: recall@20 per stage {staged.recalls}; "
          f"vanilla {recalls}", flush=True)


def phase_probe_scripts():
    """The three probe scripts and the main-path script's top-k arm, each
    through its ``main`` as ``python -m ragraph_tpu_torch.bench.<name>``
    runs it, with the launches counted from zero: the path of kernels J, K
    and L."""
    from ragraph_tpu_torch import native
    from ragraph_tpu_torch.bench import (exact_phases, onehot_gather,
                                         packed_table_gather)
    print("phase 4e: the probe scripts (kernels J, K, L)", flush=True)
    launches, records = {}, {}
    for mod, kernel, keys in (
            (exact_phases, "mm_probe", ("ms", "dependent_over_independent")),
            (packed_table_gather, "packed_table_segsum",
             ("ms", "max_rel_diff")),
            (onehot_gather, "onehot_gather", ("ms", "mismatched", "P"))):
        native.reset_launches()
        rec = mod.main([])
        got = dict(native.LAUNCHES)
        if got.get(kernel, 0) <= 0 or got != rec["launches"]:
            fail(f"{mod.__name__}: launches {got}, its record says "
                 f"{rec['launches']}")
        if rec["device"]["platform"] != "gpu" or any(k not in rec
                                                     for k in keys):
            fail(f"{mod.__name__}: record lacks one of {keys} or was not "
                 f"taken on the card")
        launches[kernel] = got[kernel]
        records[rec["bench"]] = rec
    rec = records["exact_phases"]
    thr = rec["ms"]["throughput"]
    # the probe must take every product: no faster than the whole product at
    # the bf16 tensor-core peak
    bound = 2 * rec["R"] * rec["Q"] * rec["E"] / BF16_FLOP_PER_MS
    share = 100 * bound / thr["matmul_proxy"]
    print(f"  matmul proxy (J) {thr['matmul_proxy']:.4f} ms per batch, its "
          f"tensor-core bound {bound:.4f} ms ({share:.1f}% of the bf16 "
          f"peak)", flush=True)
    if thr["matmul_proxy"] < bound:
        fail(f"matmul proxy {thr['matmul_proxy']:.4f} ms is below its bound "
             f"{bound:.4f} ms: the probe does not take every product")
    return launches


def write_tu_dataset(root, ds):
    """``ds`` as raw TU text files under ``root/<name>/``."""
    import os
    base = os.path.join(root, ds.name)
    os.makedirs(base, exist_ok=True)
    off, edges, indicator = 0, [], []
    for gid, g in enumerate(ds.graphs):
        r, c = np.nonzero(g.adj)
        edges.append(np.stack([r, c], axis=1) + off + 1)
        indicator.append(np.full(g.adj.shape[0], gid + 1))
        off += g.adj.shape[0]
    prefix = os.path.join(base, ds.name)
    np.savetxt(prefix + "_A.txt", np.concatenate(edges), fmt="%d",
               delimiter=", ")
    np.savetxt(prefix + "_graph_indicator.txt", np.concatenate(indicator),
               fmt="%d")
    np.savetxt(prefix + "_graph_labels.txt",
               np.array([g.graph_label for g in ds.graphs]), fmt="%d")
    np.savetxt(prefix + "_node_labels.txt", np.concatenate(
        [g.node_labels.argmax(axis=1) for g in ds.graphs]), fmt="%d")
    np.savetxt(prefix + "_node_attributes.txt", np.concatenate(
        [g.features for g in ds.graphs]), fmt="%.9g", delimiter=", ")


def phase_small_node_agreement(dev):
    """A small node ``forward`` (training-free and finetune mode) on the
    card against the same state on the CPU. The store has 40,000 rows, so
    the card retrieves through kernel C and the CPU through its plain
    version; their f32 sums differ in order, which can swap two rows whose
    bf16 scores are all but equal, so agreement is asked of 99% of the
    nodes, at 1e-4."""
    import copy

    import torch

    from ragraph_tpu_torch import native
    from ragraph_tpu_torch.data.batching import flat_batches, stacked_batches
    from ragraph_tpu_torch.data.synthetic import synthetic_tu_dataset
    from ragraph_tpu_torch.models.ragraph_node import (
        RAGraphNode, RAGraphNodeConfig, RAGraphNodeState)
    from ragraph_tpu_torch.rag.library import LibraryConfig
    print("phase 5: small node forward, card against CPU", flush=True)
    ds = synthetic_tu_dataset(seed=SEED + 40, num_graphs=40)
    libcfg = LibraryConfig(retrieve_num=4, num_augment_scale=0)
    for finetune in (False, True):
        cfg = RAGraphNodeConfig(emb_size=64, finetune=finetune,
                                library=libcfg)
        cpu_task = RAGraphNode(cfg, 16, device="cpu")
        state = cpu_task.init_state(torch.Generator().manual_seed(SEED),
                                    library_capacity=40_000)
        state = cpu_task.build_library(
            state, stacked_batches(ds.graphs[:30], 8, num_classes=3),
            torch.Generator().manual_seed(SEED + 1))
        graph = next(flat_batches(ds.graphs[30:], 10, num_classes=3))
        with torch.no_grad():
            want = cpu_task.forward(state, graph)
        task = RAGraphNode(cfg, 16, device=dev)
        on_card = RAGraphNodeState(copy.deepcopy(state.encoder).to(dev),
                                   copy.deepcopy(state.decoder).to(dev),
                                   state.library.to(dev))
        native.reset_launches()
        with torch.no_grad():
            got = task.forward(on_card, graph.to(dev)).cpu()
        if native.LAUNCHES.get("fused_cosine_topk", 0) != 1:
            fail("small node forward: kernel C was not launched once")
        real = graph.node_mask
        err = (got - want).abs().amax(dim=1)[real]
        share = float((err <= 1e-4).float().mean())
        print(f"  finetune={finetune}: {int(real.sum())} nodes, "
              f"{share:.4f} agree within 1e-4, max_abs_err="
              f"{float(err.max()):.3e}", flush=True)
        if share < 0.99 or not bool(torch.isfinite(got).all()):
            fail(f"small node forward (finetune={finetune}) disagrees "
                 f"with the CPU")


NODE_GRAPHS = 3000          # 1,500 train graphs x 4 copies x 10 = 60,000 rows
NODE_HIDDEN = 256
NODE_BATCH = 16
NODE_CAPACITY = 65536       # the CLI's default


def mesh_refusal(name, main, argv):
    """A ``--mesh`` whose ``dp * idx`` is not the world size (this process
    is a world of one) is refused before the process joins a group; phase
    14 runs ``--mesh`` itself."""
    import torch.distributed as dist
    try:
        main(argv + ["--mesh", "dp=2,idx=1"])
    except ValueError as e:
        if "dp*idx = 2*1 != 1 ranks" not in str(e):
            fail(f"{name} --mesh dp=2,idx=1: {e}")
    else:
        fail(f"{name} --mesh dp=2,idx=1 ran in a world of one")
    if dist.is_initialized():
        fail(f"{name}: a refused --mesh joined a process group")


def node_dataset():
    """The node and graph phases' data: ``NODE_GRAPHS`` synthetic graphs,
    and the (train, val, test) graph counts of the CLI's split."""
    from ragraph_tpu_torch.data.synthetic import synthetic_tu_dataset
    ds = synthetic_tu_dataset(seed=0, num_graphs=NODE_GRAPHS, num_classes=3,
                              feat_dim=16, name="SYNTH3000")
    n_train = int(.5 * NODE_GRAPHS)
    n_val = int(.8 * NODE_GRAPHS) - n_train
    return ds, (n_train, n_val, NODE_GRAPHS - n_train - n_val)


@contextlib.contextmanager
def uncounted():
    """Kernel launches made inside are a check's, not the run's."""
    from ragraph_tpu_torch import native
    before = dict(native.LAUNCHES)
    try:
        yield
    finally:
        native.LAUNCHES.clear()
        native.LAUNCHES.update(before)


class TimedObserver:
    """Base of the phases' ``cli.node.RunObserver``s: each stage's seconds
    between two device synchronisations, in ``out["<stage>_s"]``."""

    def __init__(self):
        self.out = {}

    @contextlib.contextmanager
    def stage(self, name):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        self.out.setdefault(f"{name}_s", []).append(time.perf_counter() - t0)

    def after(self, name, **o):
        hook = getattr(self, f"after_{name}", None)
        if hook is not None:
            with uncounted():
                hook(**o)


def phase_node_path(dev, tu_root, hidden=NODE_HIDDEN,
                    modes=("vanilla", "finetune"), label="phase 9"):
    """The static node pipeline at full width: hidden 256, batch 16, a
    65,536-row library that the train split fills to 60,000 rows and the val
    append runs into the clamp. ``cli.node vanilla`` and ``finetune`` run on
    the dataset read from the TU text files under ``tu_root``, each with an
    observer that times the CLI's own stages and, between them, holds
    kernel C to its plain version on the run's queries and store. Returns
    kernel C's largest error at these shapes. Phase 15a runs ``finetune``
    alone at ``hidden`` 512 (kernel C's tile in chunks of 128 columns)."""
    import copy

    import torch

    from ragraph_tpu_torch import native
    from ragraph_tpu_torch.bench import timing
    from ragraph_tpu_torch.cli import node as cli
    from ragraph_tpu_torch.data.batching import flat_batches
    from ragraph_tpu_torch.models.ragraph_node import RAGraphNodeState
    from ragraph_tpu_torch.ops.similarity import l2_normalize
    from ragraph_tpu_torch.rag.library import retrieve
    print(f"{label}: node path, {NODE_GRAPHS} graphs, hidden {hidden}, "
          f"batch {NODE_BATCH}, library capacity {NODE_CAPACITY}", flush=True)
    ds, (n_train, n_val, n_test) = node_dataset()
    val_batches, test_batches = -(-n_val // NODE_BATCH), \
        -(-n_test // NODE_BATCH)

    class Probe(TimedObserver, cli.RunObserver):
        """Times the CLI's stages and checks the state between them."""

        def __init__(self, mode):
            super().__init__()
            self.mode, self.c_err = mode, 0.0
            self.out["finetune_losses"] = []

        def check_retrieval(self, when, task, state, libcfg, val, pad):
            """Kernel C at the shape ``retrieve`` gives it: one padded val
            batch's embeddings against the live store, normalised as
            ``cosine_topk`` normalises them, under the store's valid mask."""
            g0 = next(flat_batches(val.graphs, NODE_BATCH, pad, num_classes=3,
                                   device=dev))
            with torch.no_grad():
                emb = state.encoder.inference(g0.features, g0.adj,
                                              g0.node_mask)
            lib = state.library
            k = libcfg.retrieve_num
            self.c_err = max(self.c_err, check_topk(
                f"C node shape {when}: Q={emb.shape[0]} R={lib.capacity} "
                f"E={emb.shape[1]} k={k} valid={int(lib.fill)}",
                l2_normalize(emb), l2_normalize(lib.live()[0]), k,
                lib.valid_mask))
            return g0, emb

        def after_library_build_train(self, task, state, libcfg, train, val,
                                      pad):
            fill = int(state.library.fill)
            want = len(train.graphs) * (1 + libcfg.num_augment_scale) \
                * libcfg.num_inverse_sample
            if fill != want or fill <= 32_768:
                fail(f"node library holds {fill} rows after the train "
                     f"split, expected {want}")
            self.out["library_rows_train"] = fill
            self.out["library_rows_per_s"] = \
                fill / self.out["library_build_train_s"][-1]
            g0, emb = self.check_retrieval("after the train build", task,
                                           state, libcfg, val, pad)
            native.reset_launches()
            rag_emb, rag_labels = retrieve(state.library, emb, libcfg)
            torch.cuda.synchronize()
            n_c = native.LAUNCHES.get("fused_cosine_topk", 0)
            if n_c != 1:
                fail(f"retrieve launched kernel C {n_c} times, not once")
            k = libcfg.retrieve_num
            if tuple(rag_emb.shape) != (pad, k, hidden) \
                    or tuple(rag_labels.shape) != (pad, k, 3) \
                    or not bool(torch.isfinite(rag_emb).all()):
                fail(f"retrieve returned {tuple(rag_emb.shape)} and "
                     f"{tuple(rag_labels.shape)}")
            # every retrieved label row is a one-hot row of the store
            if not bool((rag_labels[g0.node_mask].sum(dim=-1) == 1).all()):
                fail("retrieve returned a row outside the live store")
            self.out["retrieve_ms"] = cuda_ms(
                lambda: retrieve(state.library, emb, libcfg))
            self.out["retrieve_queries"] = pad
            self.out["retrieve_rows"] = NODE_CAPACITY

        def after_finetune_epoch(self, losses):
            self.out["finetune_losses"].append(
                float(torch.stack(losses).mean()))

        def after_finetune(self, task, state, optimizer, batches):
            # the step's split, on a copy so that the run's weights stay
            # the CLI's own
            twin = RAGraphNodeState(copy.deepcopy(state.encoder),
                                    copy.deepcopy(state.decoder),
                                    state.library)
            opt = task.make_optimizer(twin, 1e-3)
            box = {}

            def forward():
                opt.zero_grad(set_to_none=True)
                box["loss"] = task.loss(twin, batches[0])

            fwd, bwd, step = timing.split_ms(
                [forward, lambda: box["loss"].backward(), opt.step], 5, dev)
            self.out["finetune_step_ms"] = {
                "forward": fwd, "backward": bwd, "optimizer": step,
                "step": fwd + bwd + step}
            # the finetuned parameters (the pretraining heads take no part)
            for name, prm in list(twin.encoder.gcn.named_parameters("gcn")) \
                    + list(twin.decoder.named_parameters()):
                if name.startswith("gcn.bns"):
                    continue    # the batch norms run only in pretraining
                if prm.grad is None \
                        or not bool(torch.isfinite(prm.grad).all()) \
                        or float(prm.grad.abs().max()) == 0.0:
                    fail(f"node finetune step: gradient of {name} missing, "
                         f"non-finite or all zero")

        def after_library_build_val(self, task, state, libcfg, train, val,
                                    pad):
            if int(state.library.fill) != NODE_CAPACITY:
                fail(f"node library holds {int(state.library.fill)} rows "
                     f"after the val append, expected the capacity "
                     f"{NODE_CAPACITY}")
            self.check_retrieval("after the val append", task, state, libcfg,
                                 val, pad)

    out, c_err = {}, 0.0
    tmp = f"{tu_root}/node{hidden}"
    common = ["--dataset", ds.name, "--data-root", tu_root, "--save-dir",
              f"{tmp}/modelset", "--results-dir", f"{tmp}/results",
              "--hidden", str(hidden), "--batch-size",
              str(NODE_BATCH), "--library-capacity", str(NODE_CAPACITY),
              "--test-times", "1", "--device", str(dev)]
    runs = {"vanilla": ([], test_batches),
            "finetune": (["--epochs", "2"], 2 * val_batches + test_batches)}
    for mode in modes:
        extra, want_c = runs[mode]
        probe = Probe(mode)
        native.reset_launches()
        t0 = time.perf_counter()
        mean = cli.main([mode] + common + extra, observer=probe)
        torch.cuda.synchronize()
        res = probe.out
        res["cli_s"] = time.perf_counter() - t0
        launches = dict(native.LAUNCHES)
        res["accuracy"], res["launches"] = mean / 100.0, launches
        out[mode], c_err = res, max(c_err, probe.c_err)
        with open(f"{tmp}/results/{mode}_node_{ds.name}.json") as f:
            written = json.load(f)
        if sorted(written) != ["accuracy", "mean", "std"] \
                or written["mean"] != mean:
            fail(f"cli.node {mode}: result file holds {written}")
        if launches.get("fused_cosine_topk", 0) != want_c:
            fail(f"cli.node {mode}: kernel C launched "
                 f"{launches.get('fused_cosine_topk', 0)} times, "
                 f"expected {want_c} (one per retrieve)")
        if not mean / 100.0 > 0.5:
            fail(f"cli.node {mode}: accuracy {mean / 100.0} is not above "
                 f"0.5 (chance 0.33)")
        for stage in ("library_build_train_s", "library_build_val_s",
                      "test_accuracy_s"):
            if len(res.get(stage, ())) != 1:
                fail(f"cli.node {mode}: stage {stage} ran "
                     f"{len(res.get(stage, ()))} times, not once")
            res[stage] = res[stage][0]
        print(f"  cli.node {mode}: accuracy {mean / 100.0:.4f} in "
              f"{res['cli_s']:.1f} s (checks included), launches "
              f"{launches}", flush=True)
    losses = out["finetune"]["finetune_losses"]
    if len(losses) != 2 or not np.isfinite(losses).all() \
            or not losses[-1] < losses[0]:
        fail(f"node finetune: losses {losses} are not finite and falling")
    if "finetune_step_ms" not in out["finetune"] \
            or out.get("vanilla", {}).get("finetune_losses"):
        fail("cli.node: the finetune stages ran in the wrong mode")
    if "vanilla" in modes:
        mesh_refusal("cli.node", cli.main, ["vanilla"] + common)
    print(json.dumps({"node_path" if hidden == NODE_HIDDEN
                      else f"node_path_hidden_{hidden}": out}), flush=True)
    return c_err


ALL_TERMS = "lp+dgi+graphcl:edge+graphcl:mask+graphcl:node+graphcl:subgraph"
GRAPH_EPOCHS = 10


def phase_graph_level(dev, tu_root):
    """Node pretraining and the graph level at full width, on phase 9's TU
    files: ``cli.node pretrain`` (hidden 256, batch 16 padded to 384 nodes,
    ``--lp-samples 100``) for 3 epochs of ``lp`` (a finite, falling loss),
    then one epoch of all six terms into the same checkpoint (a finite
    loss); then ``cli.node vanilla --level graph`` and ``finetune --level
    graph`` reading that checkpoint, with a 65,536-row library. For time the
    two run ``--epochs 10 --test-times 1`` (the CLI's defaults are 50 and
    5). Each graph-level forward retrieves its batch of 16 graph queries
    through kernel C: one launch per forward, counted; C is held to its
    plain version on the run's own queries and store and timed alone at
    that shape beside a ``matmul`` + ``topk`` and two bounds: the valid rows
    read once (the answer depends on nothing else) and the whole store read
    once (what C reads). Returns C's largest error and the phase's
    numbers."""
    import torch

    from ragraph_tpu_torch import native
    from ragraph_tpu_torch.cli import node as cli
    from ragraph_tpu_torch.data.batching import stacked_batches
    from ragraph_tpu_torch.ops.fused_retrieval import (
        fused_cosine_topk, fused_cosine_topk_plain)
    from ragraph_tpu_torch.ops.similarity import l2_normalize
    from ragraph_tpu_torch.rag.library import retrieve
    print(f"phase 10: node pretraining and the graph level, {NODE_GRAPHS} "
          f"graphs, hidden {NODE_HIDDEN}, batch {NODE_BATCH}, library "
          f"capacity {NODE_CAPACITY}", flush=True)
    ds, (n_train, n_val, n_test) = node_dataset()
    steps = -(-NODE_GRAPHS // NODE_BATCH)
    val_batches, test_batches = -(-n_val // NODE_BATCH), \
        -(-n_test // NODE_BATCH)
    tmp = f"{tu_root}/graph"
    common = ["--dataset", ds.name, "--data-root", tu_root, "--save-dir",
              f"{tmp}/modelset", "--results-dir", f"{tmp}/results",
              "--hidden", str(NODE_HIDDEN), "--batch-size", str(NODE_BATCH),
              "--device", str(dev)]
    out, c_err = {}, 0.0

    # -- pretraining: 3 epochs of lp, then one of every term
    for tag, terms, epochs in (("lp", "lp", 3), ("all", ALL_TERMS, 1)):
        probe = TimedObserver()
        native.reset_launches()
        path = cli.main(["pretrain", "--pretrain-loss", terms,
                         "--pretrain-epochs", str(epochs), "--lp-samples",
                         "100"] + common, observer=probe)
        with open(f"{tmp}/results/pretrain_{ds.name}.json") as f:
            written = json.load(f)
        losses = written["epoch_losses"]
        if written["loss_terms"] != terms.split("+") \
                or len(losses) != epochs or not np.isfinite(losses).all() \
                or (epochs > 1 and not losses[-1] < losses[0]) \
                or not path.endswith(f"model_{ds.name}.pkl"):
            fail(f"cli.node pretrain {terms}: wrote {written} to {path}")
        epoch_s = probe.out["pretrain_epoch_s"]
        # an epoch's wall time over its steps (the host's tuple sampling
        # included); the first epoch also warms up
        step_ms = [1e3 * t / steps for t in epoch_s]
        out[f"pretrain_{tag}"] = {
            "epoch_losses": losses, "epoch_s": epoch_s,
            "steps_per_epoch": steps, "step_ms": step_ms,
            "launches": dict(native.LAUNCHES)}
        print(f"  cli.node pretrain {terms}: losses {losses}, step ms "
              f"{[round(t, 3) for t in step_ms]}", flush=True)
    out["pretrain_step_ms"] = float(np.mean(out["pretrain_lp"]["step_ms"][1:]))

    # -- the graph level, reading that checkpoint
    class Probe(TimedObserver, cli.RunObserver):
        def __init__(self):
            super().__init__()
            self.c_err, self.out["finetune_losses"] = 0.0, []

        def after_library_build_train(self, task, state, libcfg, train, val,
                                      pad):
            lib = state.library
            if int(lib.fill) != n_train:
                fail(f"graph library holds {int(lib.fill)} rows after the "
                     f"train split, expected {n_train}")
            batch = next(stacked_batches(val.graphs, NODE_BATCH,
                                         num_classes=3, num_graph_classes=3,
                                         device=dev))
            with torch.no_grad():
                emb = state.encoder.inference(batch["features"],
                                              batch["adj"],
                                              batch["node_mask"])
            m = batch["node_mask"].to(emb.dtype)[:, :, None]
            query = (emb * m).sum(1) / torch.clamp_min(m.sum(1), 1.0)
            k = libcfg.retrieve_num
            q_n, keys_n = l2_normalize(query), l2_normalize(lib.live()[0])
            valid = lib.valid_mask
            self.c_err = check_topk(
                f"C graph shape: Q={query.shape[0]} R={lib.capacity} "
                f"E={query.shape[1]} k={k} valid={int(lib.fill)}", q_n,
                keys_n, k, valid)
            native.reset_launches()
            rag_emb, rag_labels = retrieve(lib, query, libcfg)
            torch.cuda.synchronize()
            if native.LAUNCHES.get("fused_cosine_topk", 0) != 1:
                fail("graph retrieve did not launch kernel C once")
            if tuple(rag_emb.shape) != (NODE_BATCH, k, NODE_HIDDEN) \
                    or not bool((rag_labels.sum(-1) == 1).all()):
                fail(f"graph retrieve returned {tuple(rag_emb.shape)} and "
                     f"labels outside the store")
            self.out["graph_retrieve_ms"] = cuda_ms(
                lambda: retrieve(lib, query, libcfg))
            # C alone at this shape: the bf16 rows it reads
            qh, kh = q_n.to(torch.bfloat16), keys_n.to(torch.bfloat16)
            qf, kf = qh.float(), kh.float()
            n_q, e = qh.shape
            r, fill = kh.shape[0], int(lib.fill)

            def library():
                sc = torch.where(valid[None, :], qf @ kf.T, -torch.inf)
                return torch.topk(sc, k, dim=1)

            def bound(rows):
                """(ms, what binds) for ``rows`` bf16 store rows read once
                beside the valid mask, the queries and the lists."""
                b = 2 * n_q * e + 2 * rows * e + r + 8 * n_q * k
                b_ms, o_ms = (b / HBM_BYTES_PER_MS,
                              2 * n_q * rows * e / BF16_FLOP_PER_MS)
                return max(b_ms, o_ms), "bytes" if b_ms >= o_ms \
                    else "operations"
            # the answer depends on the valid rows only; C reads and scores
            # every row of the store and masks the empty ones
            bound_ms, bound_by = bound(fill)
            store_ms, store_by = bound(r)
            self.out["C_graph_shape"] = {
                "queries": n_q, "rows": r, "width": e, "k": k,
                "valid_rows": fill,
                "ms": cuda_ms(lambda: fused_cosine_topk(qh, kh, k, valid)),
                "device_ms": device_ms(
                    lambda: fused_cosine_topk(qh, kh, k, valid)),
                "plain_ms": cuda_ms(lambda: fused_cosine_topk_plain(
                    qh, kh, k, valid), reps=5),
                "library_ms": cuda_ms(library),
                "library_device_ms": device_ms(library),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "store_bound_ms": store_ms, "store_bound_by": store_by,
                "max_abs_err": self.c_err}

        def after_finetune_epoch(self, losses):
            self.out["finetune_losses"].append(
                float(torch.stack(losses).mean()))

        def after_library_build_val(self, task, state, libcfg, train, val,
                                    pad):
            if int(state.library.fill) != n_train + n_val:
                fail(f"graph library holds {int(state.library.fill)} rows "
                     f"after the val append, expected {n_train + n_val}")

    run = ["--level", "graph", "--library-capacity", str(NODE_CAPACITY),
           "--test-times", "1"] + common
    for mode, extra, want_c in (
            ("vanilla", [], test_batches),
            ("finetune", ["--epochs", str(GRAPH_EPOCHS)],
             GRAPH_EPOCHS * val_batches + test_batches)):
        probe = Probe()
        native.reset_launches()
        t0 = time.perf_counter()
        mean = cli.main([mode] + run + extra, observer=probe)
        torch.cuda.synchronize()
        res = probe.out
        res["cli_s"] = time.perf_counter() - t0
        res["accuracy"], res["launches"] = mean / 100.0, dict(native.LAUNCHES)
        c_err = max(c_err, probe.c_err)
        with open(f"{tmp}/results/{mode}_graph_{ds.name}.json") as f:
            written = json.load(f)
        if sorted(written) != ["accuracy", "mean", "std"] \
                or written["mean"] != mean:
            fail(f"cli.node {mode} --level graph: result file {written}")
        n_c = res["launches"].get("fused_cosine_topk", 0)
        if n_c != want_c:
            fail(f"cli.node {mode} --level graph: kernel C launched {n_c} "
                 f"times, expected {want_c} (one per forward)")
        if not mean / 100.0 > 0.5:
            fail(f"cli.node {mode} --level graph: accuracy {mean / 100.0} "
                 f"is not above 0.5 (chance 0.33)")
        out[f"graph_{mode}"] = res
        print(f"  cli.node {mode} --level graph: accuracy "
              f"{mean / 100.0:.4f} in {res['cli_s']:.1f} s (checks "
              f"included), kernel C launched {n_c} times", flush=True)
    losses = out["graph_finetune"]["finetune_losses"]
    if len(losses) != GRAPH_EPOCHS or not np.isfinite(losses).all() \
            or not losses[-1] < losses[0]:
        fail(f"graph finetune: losses {losses} are not finite and falling")
    out["graph_retrieve_ms"] = out["graph_vanilla"]["graph_retrieve_ms"]
    out["accuracy"] = {m: out[f"graph_{m}"]["accuracy"]
                       for m in ("vanilla", "finetune")}
    print(json.dumps({"graph_level": out}), flush=True)
    print(json.dumps({"pretrain_step_ms": out["pretrain_step_ms"],
                      "graph_retrieve_ms": out["graph_retrieve_ms"],
                      "graph_accuracy": out["accuracy"]}), flush=True)
    return c_err, out


FEWSHOT_EPOCHS = 5
FEWSHOT_TASKS = 2


def phase_fewshot(dev, tu_root):
    """The fewshot pipeline at full width on phase 9's TU files: ``cli.node
    pretrain --encoder-layers 2`` (2 epochs of ``lp``, a finite, falling
    loss), then ``cli.fewshot vanilla`` and ``finetune`` at ``--level
    node`` and ``--level graph`` reading that checkpoint, at the CLI's
    widths (hidden 256, 5 shots, batch 16, a 65,536-row library, 5
    retrieved rows), cut for time to ``--epochs 5 --test-times 2`` (the
    CLI's defaults are 50 and 5). Each run must load the checkpoint, not
    fall back; the train append must fill 40 rows per train graph and the
    val append reach the capacity; the finetune loss must be finite and
    fall in each task; every accuracy must be finite and above chance.
    The fewshot retrieval takes the structure branch of ``retrieve`` (two
    matmuls and ``torch.topk``, as the JAX package's ``jax.lax.top_k``), so
    the phase must launch kernel C, and every other kernel, zero times. It
    times the library build, the structure ``retrieve`` of one batch alone
    with its two products apart, the finetune step and each CLI run."""
    import copy

    import torch

    from ragraph_tpu_torch import native
    from ragraph_tpu_torch.bench import timing
    from ragraph_tpu_torch.cli import fewshot as fs_cli
    from ragraph_tpu_torch.cli import node as node_cli
    from ragraph_tpu_torch.data.batching import flat_batches, stacked_batches
    from ragraph_tpu_torch.models.ragraph_fewshot import RAGraphFewshotState
    from ragraph_tpu_torch.ops.shortest_path import position_aware_codes
    from ragraph_tpu_torch.ops.similarity import l2_normalize
    from ragraph_tpu_torch.rag.library import retrieve
    print(f"phase 11: the fewshot pipeline, {NODE_GRAPHS} graphs, hidden "
          f"{NODE_HIDDEN}, batch {NODE_BATCH}, library capacity "
          f"{NODE_CAPACITY}", flush=True)
    ds, (n_train, n_val, _) = node_dataset()
    tmp = f"{tu_root}/fewshot"
    common = ["--dataset", ds.name, "--data-root", tu_root, "--save-dir",
              f"{tmp}/modelset", "--results-dir", f"{tmp}/results",
              "--hidden", str(NODE_HIDDEN), "--batch-size", str(NODE_BATCH),
              "--device", str(dev)]
    out = {}
    t_phase = time.perf_counter()
    native.reset_launches()

    # -- a two-layer encoder: 2 epochs of lp
    probe = TimedObserver()
    path = node_cli.main(["pretrain", "--encoder-layers", "2",
                          "--pretrain-loss", "lp", "--pretrain-epochs", "2",
                          "--lp-samples", "100"] + common, observer=probe)
    with open(f"{tmp}/results/pretrain_{ds.name}.json") as f:
        losses = json.load(f)["epoch_losses"]
    ckpt = node_cli.load_encoder_state(f"{tmp}/modelset", ds.name)
    if len(losses) != 2 or not np.isfinite(losses).all() \
            or not losses[-1] < losses[0] or ckpt is None \
            or "gcn.convs.1.lin.weight" not in ckpt:
        fail(f"cli.node pretrain --encoder-layers 2: losses {losses}, "
             f"checkpoint {path} with {sorted(ckpt or {})}")
    out["pretrain"] = {"epoch_losses": losses,
                       "epoch_s": probe.out["pretrain_epoch_s"]}
    print(f"  cli.node pretrain --encoder-layers 2: losses {losses}",
          flush=True)

    class Probe(TimedObserver, node_cli.RunObserver):
        """Times the CLI's stages and checks the state between them."""

        def __init__(self, level):
            super().__init__()
            self.level = level
            self.out["finetune_losses"] = []

        def after_checkpoint(self, encoder_state):
            if encoder_state is None or not all(
                    torch.equal(encoder_state[k], ckpt[k]) for k in ckpt):
                fail(f"cli.fewshot --level {self.level} did not load the "
                     f"two-layer checkpoint")
            self.out["checkpoint_loaded"] = True

        def query_batch(self, val, pad):
            """The features, adjacency and mask of the first val batch as
            the level's forward takes it."""
            if self.level == "node":
                g = next(flat_batches(val.graphs, NODE_BATCH, pad,
                                      num_classes=3, device=dev))
                return g.features, g.adj, g.node_mask
            b = next(stacked_batches(val.graphs, NODE_BATCH, num_classes=3,
                                     num_graph_classes=3, device=dev))
            return b["features"], b["adj"], b["node_mask"]

        def after_library_build_train(self, task, state, libcfg, train, val,
                                      pad):
            fill = int(state.library.fill)
            want = len(train.graphs) * (1 + libcfg.num_augment_scale) \
                * libcfg.num_inverse_sample
            if len(train.graphs) != n_train or fill != want:
                fail(f"fewshot library holds {fill} rows after the train "
                     f"split of {len(train.graphs)} graphs, expected {want}")
            self.out.setdefault("library_rows_train", []).append(fill)
            self.out.setdefault("library_rows_per_s", []).append(
                fill / self.out["library_build_train_s"][-1])
            if "retrieve_ms" in self.out:
                return
            # the structure retrieve of one batch alone, at the run's shape
            f, a, m = self.query_batch(val, pad)
            with torch.no_grad():
                emb = task._encode(state, f, a, m)
            rows = emb.reshape(-1, emb.shape[-1])
            pos = position_aware_codes(
                a, m, libcfg.num_anchors, libcfg.dis_q,
                generator=torch.Generator(dev).manual_seed(0))
            pos = pos.reshape(rows.shape[0], -1)
            lib = state.library
            keys, _, _, positions = lib.live()
            before = dict(native.LAUNCHES)
            rag_emb, rag_labels = retrieve(lib, rows, libcfg,
                                           search_positions=pos)
            torch.cuda.synchronize()
            k = libcfg.retrieve_num
            if dict(native.LAUNCHES) != before:
                fail(f"the fewshot retrieve launched a kernel: "
                     f"{native.LAUNCHES}")
            real = m.reshape(-1)
            if tuple(rag_emb.shape) != (rows.shape[0], k, NODE_HIDDEN) \
                    or not bool(torch.isfinite(rag_emb).all()) \
                    or not bool((rag_labels[real].sum(-1) == 1).all()):
                fail(f"fewshot retrieve returned {tuple(rag_emb.shape)} "
                     f"and labels outside the store")
            qn, kn = l2_normalize(rows), l2_normalize(keys)
            pn, rn = l2_normalize(pos), l2_normalize(positions)
            self.out.update({
                "retrieve_queries": rows.shape[0],
                "retrieve_rows": lib.capacity, "retrieve_width": rows.shape[1],
                "position_width": pos.shape[1],
                "retrieve_ms": cuda_ms(lambda: retrieve(
                    lib, rows, libcfg, search_positions=pos)),
                "retrieve_device_ms": device_ms(lambda: retrieve(
                    lib, rows, libcfg, search_positions=pos)),
                "semantic_product_device_ms": device_ms(lambda: qn @ kn.T),
                "position_product_device_ms": device_ms(lambda: pn @ rn.T)})

        def after_finetune_epoch(self, losses):
            self.out["finetune_losses"].append(
                float(torch.stack(losses).mean()))

        def after_finetune(self, task, state, optimizer, batches):
            if "finetune_step_ms" in self.out:
                return
            # the step's split, on a copy so that the run's weights stay
            # the CLI's own
            twin = RAGraphFewshotState(copy.deepcopy(state.encoder),
                                       state.library, state.support)
            opt = task.make_optimizer(twin)
            loss_fn = task.loss_node if self.level == "node" \
                else task.loss_graph
            gen = torch.Generator(dev).manual_seed(1)
            box = {}

            def forward():
                opt.zero_grad(set_to_none=True)
                box["loss"] = loss_fn(twin, batches[0], gen)

            fwd, bwd, step = timing.split_ms(
                [forward, lambda: box["loss"].backward(), opt.step], 5, dev)
            self.out["finetune_step_ms"] = {
                "forward": fwd, "backward": bwd, "optimizer": step,
                "step": fwd + bwd + step}
            for name, prm in twin.encoder.gcn.convs.named_parameters():
                if prm.grad is None \
                        or not bool(torch.isfinite(prm.grad).all()) \
                        or float(prm.grad.abs().max()) == 0.0:
                    fail(f"fewshot finetune step: gradient of {name} "
                         f"missing, non-finite or all zero")

        def after_library_build_val(self, task, state, libcfg, train, val,
                                    pad):
            if int(state.library.fill) != NODE_CAPACITY:
                fail(f"fewshot library holds {int(state.library.fill)} rows "
                     f"after the val append, expected the capacity "
                     f"{NODE_CAPACITY}")

    run = ["--shots", "5", "--library-capacity", str(NODE_CAPACITY),
           "--retrieve-num", "5", "--test-times", str(FEWSHOT_TASKS)] \
        + common
    for level in ("node", "graph"):
        for mode, extra in (("vanilla", []),
                            ("finetune", ["--epochs", str(FEWSHOT_EPOCHS)])):
            probe = Probe(level)
            t0 = time.perf_counter()
            mean = fs_cli.main([mode, "--level", level] + run + extra,
                               observer=probe)
            torch.cuda.synchronize()
            res = probe.out
            res["cli_s"] = time.perf_counter() - t0
            with open(f"{tmp}/results/fewshot_{mode}_{level}_{ds.name}"
                      f"_shot5.json") as f:
                written = json.load(f)
            accs = np.array(written["accuracy"]) / 100.0
            if sorted(written) != ["accuracy", "mean", "std"] \
                    or written["mean"] != mean or len(accs) != FEWSHOT_TASKS \
                    or not np.isfinite(accs).all() or not (accs > 1 / 3).all():
                fail(f"cli.fewshot {mode} --level {level}: result file "
                     f"{written} (chance 0.33)")
            if not res.get("checkpoint_loaded"):
                fail(f"cli.fewshot {mode} --level {level}: no checkpoint")
            losses = res["finetune_losses"]
            if mode == "finetune":
                per_task = [losses[i:i + FEWSHOT_EPOCHS] for i in
                            range(0, len(losses), FEWSHOT_EPOCHS)]
                if len(per_task) != FEWSHOT_TASKS \
                        or not np.isfinite(losses).all() \
                        or not all(t[-1] < t[0] for t in per_task):
                    fail(f"cli.fewshot finetune --level {level}: losses "
                         f"{losses} are not finite and falling per task")
            elif losses:
                fail(f"cli.fewshot vanilla --level {level} finetuned")
            res["accuracy"] = accs.tolist()
            res["accuracy_mean"], res["accuracy_std"] = \
                float(accs.mean()), float(accs.std())
            out[f"{mode}_{level}"] = res
            print(f"  cli.fewshot {mode} --level {level}: accuracy "
                  f"{accs.mean():.4f} +- {accs.std():.4f} in "
                  f"{res['cli_s']:.1f} s (checks included)", flush=True)
    out["launches"] = dict(native.LAUNCHES)
    if out["launches"].get("fused_cosine_topk", 0) != 0 \
            or any(out["launches"].values()):
        fail(f"phase 11 launched kernels {out['launches']}: the fewshot "
             f"path takes the structure branch, which runs none")
    mesh_refusal("cli.fewshot", fs_cli.main, ["vanilla"] + common)
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"fewshot": out}), flush=True)
    print(json.dumps({
        "fewshot_library_build_s": {
            k: out[k]["library_build_train_s"] for k in out
            if isinstance(out[k], dict) and "library_build_train_s" in out[k]},
        "fewshot_retrieve_ms": {
            lvl: out[f"vanilla_{lvl}"]["retrieve_ms"]
            for lvl in ("node", "graph")},
        "fewshot_finetune_step_ms": {
            lvl: out[f"finetune_{lvl}"]["finetune_step_ms"]["step"]
            for lvl in ("node", "graph")},
        "fewshot_cli_s": {k: out[k]["cli_s"] for k in out
                          if isinstance(out[k], dict) and "cli_s" in out[k]},
        "fewshot_accuracy": {k: [out[k]["accuracy_mean"],
                                 out[k]["accuracy_std"]] for k in out
                             if isinstance(out[k], dict)
                             and "accuracy_mean" in out[k]},
        "fewshot_launches": out["launches"],
        "fewshot_phase_s": out["phase_s"]}), flush=True)
    return out


def phase_timing(dev, graph, errs, launches, probes, skewed):
    import torch

    from ragraph_tpu_torch.ops import csr_segment as cs
    from ragraph_tpu_torch.ops.fused_retrieval import (
        fused_cosine_topk, fused_cosine_topk_plain)
    from ragraph_tpu_torch.ops.similarity import l2_normalize
    print("phase 7: timing at the main path's shapes", flush=True)
    # the card's clock and temperature after the earlier phases' load: the
    # latency-bound kernels' times follow the SM clock
    state = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,"
         "power.draw", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60)
    print(json.dumps({"card_state_before_timing": state.stdout.strip()}),
          flush=True)
    g = graph
    n, e = g.num_nodes, g.num_edges
    gen = torch.Generator(dev).manual_seed(SEED + 4)
    table = torch.randn(n, D, generator=gen, device=dev)
    w = g.edge_norm * 0.5 + g.time_norm * 0.5
    w_send = g.edge_norm_send * 0.5 + g.time_norm_send * 0.5
    args = (w, w_send, g.senders, g.recv_indptr, g.recv_of_send,
            g.send_indptr)
    planned = {"recv_plan": g.recv_plan, "send_plan": g.send_plan}
    kernels = []

    # A: gather_scale_segsum, bf16 (the main path's setting), with the
    # graph's walk plans as the model hands them in
    a_ms = cuda_ms(lambda: cs.gather_scale_segsum(table, *args, bf16=True,
                                                  **planned))
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
        library_ms=a_lib,
        device_ms=device_ms(lambda: cs.gather_scale_segsum(
            table, *args, bf16=True, **planned)),
        library_device_ms=device_ms(lambda: torch.sparse.mm(csr, tb), 5)))
    del csr, tb
    # A's parts (the cast, the kernel, the backward) and K on the same
    # edges, by device time, on this graph and on the skewed one; the rows
    # each lane group gathers from L2
    from ragraph_tpu_torch.bench import csr_walk
    uni = {"senders": g.senders, "recv_indptr": g.recv_indptr, "w": w,
           "recv_of_send": g.recv_of_send, "send_indptr": g.send_indptr,
           "w_send": w_send}
    walk_ms = {name: csr_walk.time_graph(arrs, D, gen, dev)
               for name, arrs in (("uniform", uni), ("skewed", skewed))}
    walk_ms["l2_row_bytes"] = {"A": 2 * D * e, "K": 4 * D * e}
    print(json.dumps({"csr_walk_device_ms": walk_ms}), flush=True)
    for name, rec in walk_ms.items():
        if name != "l2_row_bytes" and not (rec["K_equals_A"]
                                           and rec["A_repeat_equal"]):
            fail(f"kernels A and K on the {name} graph: K equal to A "
                 f"{rec['K_equals_A']}, A repeated {rec['A_repeat_equal']}")
    del uni

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
        library_ms=b_lib,
        device_ms=device_ms(lambda: cs.sorted_segment_sum_grad(
            msgs, g.recv_indptr, g.receivers)),
        library_device_ms=device_ms(lambda: torch.segment_reduce(
            msgs, "sum", lengths=lengths, axis=0), 5)))
    del msgs

    # H: the exclusive prefix of the 2^21 x 64 f32 messages, as
    # sorted_segment_sum asks for it
    from ragraph_tpu_torch.ops import prefix_sum as ps
    rows = table[g.senders.long()]
    msgs = rows * w[:, None]
    h_ms = cuda_ms(lambda: ps.prefix_sum(msgs, True))
    h_plain = cuda_ms(lambda: ps.prefix_sum_plain(msgs, True), reps=2,
                      warmup=1)
    h_lib = cuda_ms(lambda: torch.cumsum(msgs, 0), reps=2, warmup=1)
    h_bytes = 4 * e * D + 4 * e * D + 4 * D
    h_ops = e * D
    h_device = device_ms(lambda: ps.prefix_sum(msgs, True))
    # the same messages in bf16: 2 bytes an element in instead of 4
    msgs_bf16 = msgs.to(torch.bfloat16)
    h_bf16_bound = (2 * e * D + 4 * e * D + 4 * D) / HBM_BYTES_PER_MS
    h_bf16_device = device_ms(lambda: ps.prefix_sum(msgs_bf16, False))
    kernels.append(dict(
        name="prefix_sum", route="cuda",
        source="ragraph_tpu_torch/csrc/prefix_sum.cu",
        replaces="ragraph_tpu/ops/pallas_segment.py:75",
        launches=launches.get("prefix_sum", 0),
        max_abs_err=errs["H"], ms=h_ms, plain_ms=h_plain,
        bound_ms=max(h_bytes / HBM_BYTES_PER_MS, h_ops / F32_FLOP_PER_MS),
        bound_by="bytes" if h_bytes / HBM_BYTES_PER_MS
        >= h_ops / F32_FLOP_PER_MS else "operations",
        library_ms=h_lib, device_ms=h_device,
        library_device_ms=device_ms(lambda: torch.cumsum(msgs, 0), 2),
        device_share_of_bound=(h_bytes / HBM_BYTES_PER_MS) / h_device,
        bf16_input_device_ms=h_bf16_device,
        bf16_input_bound_ms=h_bf16_bound,
        bf16_input_share_of_bound=h_bf16_bound / h_bf16_device))
    ip = g.recv_indptr
    detail_hi = {
        "H_sorted_segment_sum_with_boundary_difference": cuda_ms(
            lambda: ps.sorted_segment_sum(msgs, ip[:-1], ip[1:])),
        "H_inclusive_bf16_input": cuda_ms(
            lambda: ps.prefix_sum(msgs_bf16, False)),
        "B_same_messages": b_ms}
    del msgs, msgs_bf16

    # I: the packed (2^20, 128) f32 rows of the same edges, bf16 switch on.
    # Its one-call yardstick: the packed rows read as (E, D) hold edge e's
    # row at 2 * ((e // 2B) * B + e % B) + (e // B) % 2 (B = 512), so a CSR
    # matrix of the weights at those columns times that view is one
    # torch.sparse.mm; rows and weights rounded to bf16 outside the timing,
    # as kernel I rounds them.
    blk = 512
    msgs2 = pack_half_split(rows, blk)
    del rows
    eid = torch.arange(e, device=dev)
    pos = 2 * ((eid // (2 * blk)) * blk + eid % blk) + (eid // blk) % 2
    i_view = msgs2.to(torch.bfloat16).float().view(e, D)
    with warnings.catch_warnings():    # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        i_csr = torch.sparse_csr_tensor(
            ip.long(), pos, w.to(torch.bfloat16).float(), size=(n, e))
    del eid, pos
    check_close("I's library call (torch.sparse.mm) against kernel I",
                torch.sparse.mm(i_csr, i_view),
                cs.segsum_packed2_w(msgs2, w, ip, e), TOL_SEGSUM)
    i_lib = cuda_ms(lambda: torch.sparse.mm(i_csr, i_view), reps=5)
    i_ms = cuda_ms(lambda: cs.segsum_packed2_w(msgs2, w, ip, e))
    i_plain = cuda_ms(lambda: cs.segsum_packed2_w_plain(msgs2, w, ip, e, 512,
                                                        True), reps=3)
    i_bytes = 4 * e * D + 4 * e + 4 * (n + 1) + 4 * n * D
    i_ops = 2 * e * D
    kernels.append(dict(
        name="csr_segsum_packed2_w", route="cuda",
        source="ragraph_tpu_torch/csrc/csr_segment.cu",
        replaces="ragraph_tpu/ops/pallas_segment.py:302",
        launches=launches.get("csr_segsum_packed2_w", 0),
        max_abs_err=errs["I"], ms=i_ms, plain_ms=i_plain,
        bound_ms=max(i_bytes / HBM_BYTES_PER_MS, i_ops / F32_FLOP_PER_MS),
        bound_by="bytes" if i_bytes / HBM_BYTES_PER_MS
        >= i_ops / F32_FLOP_PER_MS else "operations",
        library_ms=i_lib,
        device_ms=device_ms(lambda: cs.segsum_packed2_w(msgs2, w, ip, e)),
        library_device_ms=device_ms(lambda: torch.sparse.mm(i_csr, i_view),
                                    5)))
    del i_csr, i_view
    detail_hi.update({
        "I_bf16_rows": cuda_ms(lambda m=msgs2.to(torch.bfloat16):
                               cs.segsum_packed2_w(m, w, ip, e)),
        "A_same_edges": a_ms})
    del msgs2
    torch.cuda.empty_cache()

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
    # kernel J on C's inputs: the same tensor-core product with the top-k
    # epilogue and the merge launch left out
    from ragraph_tpu_torch.ops import probes as pr
    j_at_c = cuda_ms(lambda: pr.matmul_probe(kh, qh, 0), reps=10)
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
        library_ms=c_mm + c_topk,
        device_ms=device_ms(lambda: fused_cosine_topk(q, keys, 10)),
        library_device_ms=device_ms(lambda: torch.matmul(qb, kb.T), 5)
        + device_ms(lambda: torch.topk(scores, 10, dim=1), 5)))
    del scores
    detail = {"C_library_f32_matmul": c_mm, "C_library_topk": c_topk,
              "C_bf16_matmul_bf16_out": c_mm_bf16,
              "J_at_C_shape_E64": j_at_c,
              "C_minus_J_at_C_shape": c_ms - j_at_c,
              **detail_hi}

    # D-G on the same chunk and library, each on what the bucket path hands
    # it; the family as a whole beside kernel C and the library calls
    from ragraph_tpu_torch.ops import bucket_topk as bt
    st = bucket_stages(q, keys, K_PATH)
    qh, kh, bm, cand = (st[x] for x in ("qh", "kh", "bm", "cand"))
    # kernel F's first launch; the queries past P_MAX in a bucket take
    # further ones (bucket_rescore_rounds)
    rounds = st["assign"].shape[1] // P_MAX
    assign = st["assign"][:, :P_MAX].contiguous()
    nb, p_max = assign.shape
    n_live = int((assign < CHUNK).sum())    # slots that hold a query
    w = cand.shape[1]
    shapes = {
        # name: (bytes in + out, operations, peak rate of their type)
        "bucket_max": (2 * n * D + 2 * CHUNK * D + 4 * nb * CHUNK,
                       2 * CHUNK * n * D, BF16_FLOP_PER_MS),
        "column_topk": (4 * nb * CHUNK + 8 * CHUNK * K_PATH,
                        nb * CHUNK, F32_FLOP_PER_MS),
        "bucket_rescore": (4 * nb * p_max + 2 * CHUNK * D + 2 * n * D
                           + 4 * nb * p_max * bt.LANE,
                           2 * n_live * bt.LANE * D, BF16_FLOP_PER_MS),
        # E and G: one comparison a value read
        "row_topk": (4 * CHUNK * w + 8 * CHUNK * K_PATH,
                     CHUNK * w, F32_FLOP_PER_MS),
    }
    runs = {
        # name: (key in errs, TPU kernel, kernel, plain version, library)
        "bucket_max": ("D", 61, lambda: bt.bucket_max(kh, qh),
                       lambda: bt.bucket_max_plain(kh, qh), None),
        "column_topk": ("E", 112, lambda: bt.column_topk(bm, K_PATH),
                        lambda: bt.column_topk_plain(bm, K_PATH),
                        lambda: torch.topk(bm, K_PATH, dim=0)),
        "bucket_rescore": ("F", 87,
                           lambda: bt.bucket_rescore(assign, qh, kh),
                           lambda: bt.bucket_rescore_plain(assign, qh, kh),
                           None),
        "row_topk": ("G", 170, lambda: bt.row_topk(cand, K_PATH),
                     lambda: bt.row_topk_plain(cand, K_PATH),
                     lambda: torch.topk(cand, K_PATH, dim=1)),
    }
    for name, (key, line, kernel, plain, library) in runs.items():
        n_bytes, n_ops, rate = shapes[name]
        by_bytes, by_ops = n_bytes / HBM_BYTES_PER_MS, n_ops / rate
        kernels.append(dict(
            name=name, route="cuda",
            source="ragraph_tpu_torch/csrc/bucket_topk.cu",
            replaces=f"ragraph_tpu/ops/bucket_topk.py:{line}",
            launches=launches.get(name, 0), max_abs_err=errs[key],
            ms=cuda_ms(kernel, reps=10), plain_ms=cuda_ms(plain, reps=2,
                                                          warmup=1),
            bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            library_ms=None if library is None else cuda_ms(library,
                                                            reps=5)))
        kernels[-1].update(
            device_ms=device_ms(kernel),
            library_device_ms=None if library is None else device_ms(library))
    # E and G at k = 20 and 50 on inputs of the path's shapes (E's input
    # does not depend on k; G's is each k's own candidate matrix), each
    # beside torch.topk on the same input
    sweep = []
    for kk in (20, 50):
        cand_k = bucket_stages(q, keys, kk)["cand"]
        for name, kernel, library, n_bytes, n_ops in (
                ("column_topk", lambda: bt.column_topk(bm, kk),
                 lambda: torch.topk(bm, kk, dim=0),
                 4 * nb * CHUNK + 8 * CHUNK * kk, nb * CHUNK),
                ("row_topk", lambda: bt.row_topk(cand_k, kk),
                 lambda: torch.topk(cand_k, kk, dim=1),
                 4 * cand_k.numel() + 8 * CHUNK * kk, cand_k.numel())):
            by_bytes = n_bytes / HBM_BYTES_PER_MS
            by_ops = n_ops / F32_FLOP_PER_MS
            sweep.append(dict(
                name=name, k=kk, shape=list(bm.shape if name[0] == "c"
                                            else cand_k.shape),
                ms=cuda_ms(kernel, reps=10), device_ms=device_ms(kernel),
                bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                library_ms=cuda_ms(library, reps=5),
                library_device_ms=device_ms(library)))
        del cand_k
    print(json.dumps({"topk_k_sweep": sweep}), flush=True)
    rank = torch.zeros(CHUNK * K_PATH, dtype=torch.int64, device=dev)
    detail.update({
        "bucket_family_ms": cuda_ms(
            lambda: bt.bucketed_exact_topk(q, keys, K_PATH), reps=10),
        "bucket_family_kernel_C_same_inputs_ms": c_ms,
        "bucket_family_library_f32_matmul_topk_ms": c_mm + c_topk,
        "bucket_glue_invert_pairs_ms": cuda_ms(
            lambda: bt.invert_pairs(st["ids"], nb, P_MAX), reps=10),
        # the host read alone: the largest bucket demand brought to the host
        "bucket_demand_host_read_ms": cuda_ms(lambda: int(rank.max()),
                                              reps=20),
        "bucket_live_slots": n_live,
        "bucket_overflow_pairs": CHUNK * K_PATH - n_live,
        "bucket_rescore_rounds": rounds})
    del st, qh, kh, bm, assign, cand
    torch.cuda.empty_cache()

    # J, K, L at their scripts' shapes, on the scripts' own inputs
    jk, jq = probes["J"]["keys"], probes["J"]["q_bf"]
    r_j, e_j = jk.shape
    q_j = jq.shape[0]
    kin, lin = probes["K"], probes["L"]
    tp = pr.pack_table(kin["table"])
    par = (kin["send"] & 1).float()
    k_args = (tp, kin["w"] * (1 - par), kin["w"] * par,
              (kin["send"] >> 1).contiguous(), kin["indptr"])
    k_plan = cs.walk_plan(kin["indptr"])
    n_k, d_k = kin["table"].shape
    e_k = kin["send"].shape[0]
    # K's library call: the packed table read as its (N, D) rows, times a CSR
    # with both halves' bf16-rounded weights of every edge (2E nonzeros)
    k_dense = tp.view(n_k, d_k).float()
    k_cols = torch.stack([2 * k_args[3].long(), 2 * k_args[3].long() + 1], 1)
    k_vals = torch.stack([k_args[1], k_args[2]], 1).to(torch.bfloat16).float()
    with warnings.catch_warnings():    # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        k_csr = torch.sparse_csr_tensor(
            2 * kin["indptr"].long(), k_cols.reshape(-1), k_vals.reshape(-1),
            size=(n_k, n_k))
    k_ref = pr.packed_table_segsum(*k_args)
    k_lib_diff = float((torch.sparse.mm(k_csr, k_dense) - k_ref).abs().max())
    if not k_lib_diff <= 5e-4 * float(k_ref.abs().max()):
        fail(f"K's library call (torch.sparse.mm) differs from the kernel "
             f"by {k_lib_diff:.3e}")
    del k_cols, k_vals, k_ref
    nb_l, p_l = lin["col"].shape
    n_l, d_l = lin["table"].shape
    l_idx = lin["senders"].long()
    probe_runs = {
        # name: (key in errs, source line of the TPU kernel, kernel, plain
        # version, library call, bytes, operations, peak rate)
        "mm_probe": (
            "J", "benchmarks/bench_exact_phases.py:212",
            lambda: pr.matmul_probe(jk, jq, 0),
            lambda: pr.matmul_probe_plain(jk, jq, 0),
            lambda: torch.matmul(jk, jq.T),
            2 * r_j * e_j + 2 * q_j * e_j + 4 * -(-r_j // 128) * q_j,
            2 * r_j * q_j * e_j, BF16_FLOP_PER_MS),
        "packed_table_segsum": (
            "K", "experiments/packed_table_gather_bench.py:46",
            lambda: pr.packed_table_segsum(*k_args, k_plan),
            lambda: pr.packed_table_segsum_plain(*k_args),
            lambda: torch.sparse.mm(k_csr, k_dense),
            2 * n_k * d_k + 4 * e_k + 8 * e_k + 4 * (n_k + 1)
            + 4 * n_k * d_k, 4 * e_k * d_k, F32_FLOP_PER_MS),
        "onehot_gather": (
            "L", "experiments/onehot_gather_bench.py:59",
            lambda: pr.onehot_block_gather(lin["col"], lin["table"]),
            lambda: pr.onehot_block_gather_plain(lin["col"], lin["table"]),
            lambda: torch.index_select(lin["table"], 0, l_idx),
            4 * nb_l * p_l + 2 * n_l * d_l + 2 * nb_l * p_l * d_l, 0,
            F32_FLOP_PER_MS),
    }
    for name, (key, line, kernel, plain, library, n_bytes, n_ops,
               rate) in probe_runs.items():
        by_bytes, by_ops = n_bytes / HBM_BYTES_PER_MS, n_ops / rate
        kernels.append(dict(
            name=name, route="cuda",
            source="ragraph_tpu_torch/csrc/probes.cu", replaces=line,
            launches=launches.get(name, 0), max_abs_err=errs[key],
            ms=cuda_ms(kernel, reps=10),
            plain_ms=cuda_ms(plain, reps=2, warmup=1),
            bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            library_ms=None if library is None else cuda_ms(library,
                                                            reps=5),
            device_ms=device_ms(kernel),
            library_device_ms=None if library is None else device_ms(
                library, 5)))
    detail.update({
        "K_kernel_A_same_edges": cuda_ms(lambda: cs._csr_gather_scale(
            kin["table"], kin["w"], kin["send"], kin["indptr"], True,
            k_plan)),
        "K_max_abs_diff_to_kernel_A": errs["K_vs_A"],
        "K_max_abs_diff_to_library": k_lib_diff,
        "J_kernel_D_same_inputs": cuda_ms(lambda: bt.bucket_max(jk, jq),
                                          reps=10)})
    print(json.dumps({"detail_ms": detail}), flush=True)
    return kernels


def check_step(name, trainer, params, batch, gen, want_launches,
               grad_names):
    """One ``EdgeTrainer.step`` with the launches counted from zero, then
    the gradients it left: finite and non-zero for ``grad_names``."""
    import torch

    from ragraph_tpu_torch import native
    from ragraph_tpu_torch.train.trainer import param_leaves
    leaves, optimizer = trainer.prepare(params)
    native.reset_launches()
    loss, aux = trainer.step(leaves, optimizer, batch, gen)
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    for kernel, n in want_launches.items():
        if launches.get(kernel, 0) != n:
            fail(f"{name} step: kernel {kernel} launched "
                 f"{launches.get(kernel, 0)} times, expected {n}")
    if not math.isfinite(float(loss)):
        fail(f"{name} step: loss {float(loss)}")
    norms = {}
    for leaf, t in param_leaves(leaves):
        if leaf.split(".")[0] not in grad_names:
            continue
        if t.grad is None or not bool(torch.isfinite(t.grad).all()) \
                or float(t.grad.abs().max()) == 0.0:
            fail(f"{name} step: gradient of {leaf} missing, non-finite or "
                 f"all zero")
        norms[leaf] = float(t.grad.norm())
    if set(g.split(".")[0] for g in norms) != set(grad_names):
        fail(f"{name} step: gradients {sorted(norms)}, expected "
             f"{sorted(grad_names)}")
    rec = float(aux["rec_loss"])
    print(f"  {name} step: loss={float(loss):.6f} rec={rec:.6f} "
          f"launches={launches} grad norms="
          + json.dumps({k: round(v, 9) for k, v in norms.items()}),
          flush=True)
    return launches


def phase_training(dev, train_rows, ds, graph):
    """Training at full width: pretrain epochs through ``EdgeTrainer.train``,
    then one stage of ``staged_finetune``."""
    import torch

    from ragraph_tpu_torch import native
    from ragraph_tpu_torch.bench.main_path import finetune_rows
    from ragraph_tpu_torch.data.edgelist import load_edge_dataset
    from ragraph_tpu_torch.models.edge import (EdgeGraphArrays,
                                               EdgeModelConfig, RAGraphEdge,
                                               staged_finetune)
    from ragraph_tpu_torch.train.trainer import EdgeTrainer
    cfg = EdgeModelConfig(emb_size=D, num_layers=3)
    steps = M // cfg.batch_size
    print(f"phase 6: training at U = I = {U}, {graph.num_edges} edges, D = "
          f"{D}, {cfg.num_layers} layers, batch {cfg.batch_size}, "
          f"edge_dropout {cfg.edge_dropout}: {PRETRAIN_EPOCHS} pretrain "
          f"epochs of {steps} steps, then one finetune stage", flush=True)
    log_lines = []

    def log(msg):
        log_lines.append(msg)
        print(f"  {msg}", flush=True)

    timer = StageTimer()
    model = RAGraphEdge(cfg, graph, phase="pretrain")
    params = model.init_params(torch.Generator(dev).manual_seed(SEED + 10))
    trainer = EdgeTrainer(model, ds, logger=log)
    gen = torch.Generator(dev).manual_seed(SEED + 11)
    first = next(ds.train_batches(cfg.batch_size,
                                  np.random.default_rng(SEED + 12)))
    batch = tuple(torch.from_numpy(a).to(dev) for a in first)
    check_step("pretrain", trainer, params, batch, gen,
               {"csr_gather_scale_segsum": 2 * cfg.num_layers,
                "edge_weights": 1},
               ("user_embedding", "item_embedding"))

    native.reset_launches()
    result = timer("pretrain", lambda: trainer.train(
        params, gen, num_epochs=PRETRAIN_EPOCHS,
        rng=np.random.default_rng(SEED + 13)))
    launches = dict(native.LAUNCHES)
    # per epoch: 512 steps of 3 forward and 3 backward launches, and the
    # evaluation's generate (3)
    want_a = PRETRAIN_EPOCHS * (steps * 2 * cfg.num_layers + cfg.num_layers)
    if launches.get("csr_gather_scale_segsum", 0) != want_a:
        fail(f"pretrain: kernel A launched "
             f"{launches.get('csr_gather_scale_segsum', 0)} times, "
             f"expected {want_a}")
    losses = [h["loss"] for h in result.history]
    if result.epochs_run != PRETRAIN_EPOCHS \
            or not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"pretrain: losses {losses} are not finite and falling")
    recall = float(result.best_perform["recall"][0])
    if not math.isfinite(recall):
        fail(f"pretrain: best recall {recall}")
    tables = {k: result.best_params[k].cpu().numpy()
              for k in ("user_embedding", "item_embedding")}
    if any(not np.isfinite(t).all() for t in tables.values()) or float(
            np.abs(tables["user_embedding"]
                   - params["user_embedding"].cpu().numpy()).max()) == 0.0:
        fail("pretrain: tables non-finite or unchanged")
    train_launches = dict(launches)

    # one finetune step apart: launches per step and the gate's gradient
    rng = np.random.default_rng(SEED + 14)
    ft_rows, stage_rows = finetune_rows(rng, U, I, FT_ROWS)
    ft_ds = load_edge_dataset(ft_rows, stage_rows, num_users=U, num_items=I,
                              phase="finetune")
    ft_model = RAGraphEdge(cfg, EdgeGraphArrays.from_dataset(ft_ds, dev),
                           phase="finetune")
    pre = tuple(torch.from_numpy(tables[k]).to(dev)
                for k in ("user_embedding", "item_embedding"))
    ft_model.make_resource_graph(*pre)
    ft_params = ft_model.init_params(
        torch.Generator(dev).manual_seed(SEED + 15), pretrained_tables=pre)
    ft_trainer = EdgeTrainer(ft_model, ft_ds, logger=log)
    # a step retrieves for every node in one launch of kernel C
    check_step("finetune", ft_trainer, ft_params, batch, gen,
               {"csr_gather_scale_segsum": 2 * cfg.num_layers,
                "fused_cosine_topk": 1, "edge_weights": 1},
               ("user_embedding", "item_embedding", "gating_weight",
                "gating_bias"))

    native.reset_launches()
    staged = timer("staged_finetune_one_stage", lambda: staged_finetune(
        train_rows, ft_rows, [stage_rows], tables,
        cfg_factory=lambda phase: cfg, seed=SEED, device=dev,
        num_epochs=FT_EPOCHS, logger=log,
        val_rows=[(u, items[0]) for u, items
                  in ds.test_user_dict.items()]))
    launches = dict(native.LAUNCHES)
    ft_steps = FT_ROWS // cfg.batch_size
    # a step retrieves for every node (one launch), and so does each
    # epoch's evaluation; the two for_tune generates and the library build
    # propagate without retrieval
    want = {"fused_cosine_topk": FT_EPOCHS * (ft_steps + 1),
            "csr_gather_scale_segsum": 2 * cfg.num_layers + FT_EPOCHS * (
                ft_steps * 2 * cfg.num_layers + cfg.num_layers),
            "csr_segment_sum": cfg.num_layers}
    for kernel, n in want.items():
        if launches.get(kernel, 0) != n:
            fail(f"staged finetune: kernel {kernel} launched "
                 f"{launches.get(kernel, 0)} times, expected {n}")
    ft_losses = [float(m.split("loss=")[1].split()[0]) for m in log_lines
                 if m.startswith("epoch") and "loss=" in m][PRETRAIN_EPOCHS:]
    if len(staged.recalls) != 1 or not np.isfinite(
            staged.recalls + staged.ndcgs + ft_losses).all() \
            or len(ft_losses) != FT_EPOCHS:
        fail(f"staged finetune: recalls {staged.recalls} losses {ft_losses}")
    print(json.dumps({
        "training_ms": timer.ms, "pretrain_losses": losses,
        "pretrain_epoch_train_s": [h["train_time"] for h in result.history],
        "pretrain_recall@20": recall, "finetune_losses": ft_losses,
        "finetune_recall@20": staged.recalls[0],
        "pretrain_launches": train_launches,
        "staged_launches": launches}), flush=True)
    return (ft_model, ft_params, model, params, batch), tables


# A launches per training step of each zoo class at ZOO_LAYERS layers: two
# launches (forward and backward) per layer of each masked forward of the
# step. SGL runs three forwards (the dropout, two views), SimGCL two views
# and its crosses a third plain forward for BPR, the rest one; GP sums with
# index_add_ and launches none.
ZOO_LAYERS = 3
ZOO_A_PER_STEP = {"SGL": 18, "SimGCL": 12, "MixGCF": 6, "LightGCNPlugin": 6,
                  "Roland": 6, "EvolveGCNH": 6, "EvolveGCNO": 6,
                  "GP-graphprompt": 0, "GP-gpf": 0, "SGL-roland": 18,
                  "MixGCF-evolvegcn_o": 6, "SimGCL-graphprompt": 18,
                  "LightGCNPlugin-gpf": 6}
ZOO_N_NEGS = 16             # EdgeModelConfig().n_negs: MixGCF's candidates
ZOO_CLI_EPOCHS = 3


def zoo_classes():
    """``(name, class, dynamic mode)`` of the zoo classes phase 12 drives:
    the plugins, the dynamic models, GP in both modes and four crosses."""
    import functools

    from ragraph_tpu_torch.models import edge as e
    return [
        ("SGL", e.SGLPlugin, None), ("SimGCL", e.SimGCLPlugin, None),
        ("MixGCF", e.MixGCFPlugin, None),
        ("LightGCNPlugin", e.LightGCNPlugin, None),
        ("Roland", e.Roland, "roland"),
        ("EvolveGCNH", e.EvolveGCNH, "evolvegcn_h"),
        ("EvolveGCNO", e.EvolveGCNO, "evolvegcn_o"),
        ("GP-graphprompt", functools.partial(e.GraphPromptEdge,
                                             prompt_mode="graphprompt"),
         None),
        ("GP-gpf", functools.partial(e.GraphPromptEdge, prompt_mode="gpf"),
         None),
        ("SGL-roland", e.make_dynamic(e.SGLPlugin, "roland"), "roland"),
        ("MixGCF-evolvegcn_o", e.make_dynamic(e.MixGCFPlugin,
                                              "evolvegcn_o"), "evolvegcn_o"),
        ("SimGCL-graphprompt", e.make_prompted(e.SimGCLPlugin,
                                               "graphprompt"), None),
        ("LightGCNPlugin-gpf", e.make_prompted(e.LightGCNPlugin, "gpf"),
         None)]


def zoo_forwards(model) -> int:
    """Masked forwards of one training step of ``model``, by its loss."""
    from ragraph_tpu_torch.models import edge as e
    if isinstance(model, e.GraphPromptEdge):
        return 0
    if isinstance(model, e.SGLPlugin):
        return 3
    if isinstance(model, e.SimGCLPlugin):
        return 3 if model.bpr_in_cal_loss else 2
    return 1


def set_dynamic_state(model, mode, params, last_emb):
    """ROLAND's meta layers (kernel A's forward alone, detached) or
    EvolveGCN-H's previous embeddings."""
    import torch
    if mode == "roland":
        with torch.no_grad():
            layers = (model.forward_lgn(params, return_layers=True)
                      if hasattr(model, "forward_lgn")
                      else model.propagated_plain(params))
        model.set_meta_layers(layers)
    elif mode == "evolvegcn_h":
        model.set_last_emb(last_emb)


def zoo_draws(model, masks, noise, mix):
    """The step's draws as data: the masks as ``edge_masks`` (the dropout's
    pair at keep 0.5, which is also SimGCL's fixed rate; SGL's three pairs;
    GP's receiver-order mask), SimGCL's noise and MixGCF's mixing weights
    through the model's draw methods."""
    import torch

    from ragraph_tpu_torch.models import edge as e
    if isinstance(model, e.SimGCLPlugin):
        it = iter(noise)
        model._perturb_noise = lambda gen, layer, shape, device: \
            torch.from_numpy(next(it)).to(device)
    if isinstance(model, e.MixGCFPlugin):
        model._mix_weights = lambda gen, shape, device: \
            torch.from_numpy(mix).to(device)
    if isinstance(model, e.GraphPromptEdge):
        return (masks[0][0], None)
    if isinstance(model, e.SGLPlugin):
        return tuple(masks)
    return masks[0]


def phase_small_zoo_agreement(dev):
    """Phase 12a: one ``cal_loss`` and backward of each zoo class on phase
    5's small graph, on the card (kernel A) and on CPU tensors (its plain
    version), with the masks, noise, mixing weights and initial weights
    handed over as data."""
    import torch

    from ragraph_tpu_torch.bench.main_path import make_rows, xavier_tables
    from ragraph_tpu_torch.convert import params_from_jax
    from ragraph_tpu_torch.data.edgelist import load_edge_dataset
    from ragraph_tpu_torch.models.edge import EdgeGraphArrays, EdgeModelConfig
    from ragraph_tpu_torch.train.trainer import map_params
    print("phase 12a: one step of each zoo class, card against CPU",
          flush=True)
    rng = np.random.default_rng(SEED + 21)
    n = 256
    train, test = make_rows(rng, n, n, 4096)
    ds = load_edge_dataset(train, test, num_users=n, num_items=n)
    tables = xavier_tables(rng, n, n, D)
    b = 512
    batch = [rng.integers(0, n, b) for _ in range(3)]
    negs = rng.integers(0, n, (b, ZOO_N_NEGS))
    noise = [rng.random((2 * n, D)).astype(np.float32)
             for _ in range(2 * ZOO_LAYERS)]
    mix = rng.random((b, 1, ZOO_LAYERS + 1, 1)).astype(np.float32)
    last = (0.1 * rng.normal(size=(2 * n, D))).astype(np.float32)
    cfg = EdgeModelConfig(emb_size=D, num_layers=ZOO_LAYERS,
                          segsum_impl="fused", propagate_dtype="f32",
                          n_negs=ZOO_N_NEGS)
    for name, cls, mode in zoo_classes():
        out, init = [], None
        for where in (torch.device("cpu"), dev):
            g = EdgeGraphArrays.from_dataset(ds, where)
            model = cls(cfg, g, phase="finetune")
            base = params_from_jax(tables, where)
            # the CPU's initial GRU, gate and prompt go to the card as data
            init = init or model.init_params(
                torch.Generator(where).manual_seed(SEED),
                pretrained_tables=(base["user_embedding"],
                                   base["item_embedding"]))
            params = map_params(lambda t: t.to(where), init)
            set_dynamic_state(model, mode, params,
                              torch.from_numpy(last).to(where))
            masks = [fixed_masks(g, salt, keep) for salt, keep in (
                (0x9E3779B1, 0.5), (0x85EBCA6B, 0.9), (0xC2B2AE35, 0.9))]
            edge_masks = zoo_draws(model, masks, noise, mix)
            neg = negs if getattr(model, "multi_negs", False) else batch[2]
            bt = tuple(torch.from_numpy(a).to(where)
                       for a in (batch[0], batch[1], neg))
            out.append(loss_and_grads(model, params, bt, edge_masks))
        (cl, cg), (gl, gg) = out
        check_close(f"zoo {name} loss", gl.cpu()[None], cl[None], TOL_GRAD)
        for leaf in cg:
            if gg[leaf] is None or float(cg[leaf].abs().max()) == 0.0:
                fail(f"zoo {name}: no gradient for {leaf}")
            check_close(f"zoo {name} grad {leaf}", gg[leaf].cpu(), cg[leaf],
                        TOL_GRAD)


def zoo_batch(ds, dev, n_negs, seed):
    """The first batch of a seeded epoch, on the card."""
    import torch
    first = next(ds.train_batches(2048, np.random.default_rng(seed),
                                  n_negs=n_negs))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in first)


def phase_zoo(dev, train_rows, ds, graph, pre_tables, trained):
    """Phase 12: the edge model zoo at full width (U = I = 131,072, 2^21
    edges, D = 64, 3 layers, batch 2,048, edge dropout 0.5, 16 MixGCF
    candidates). (b) one step of each class in the finetune phase from
    phase 6's pretrain tables, kernel A's launches per step as counted and
    every gradient finite and non-zero, each step timed beside the RAGraph
    pretrain step; (c) an epoch of SGL, SimGCL and MixGCF pretraining and
    one ``staged_dynamic`` stage of ROLAND and of SGL x EvolveGCN-H; (d) the
    CLI's ``pretrain`` and ``finetune`` of five zoo configurations on the
    synthetic stream. Returns kernel A's launches over (b)-(d)."""
    import torch

    from ragraph_tpu_torch import native
    from ragraph_tpu_torch.bench.main_path import finetune_rows, time_step
    from ragraph_tpu_torch.data.edgelist import load_edge_dataset
    from ragraph_tpu_torch.models import edge as e
    from ragraph_tpu_torch.train.trainer import EdgeTrainer
    cfg = e.EdgeModelConfig(emb_size=D, num_layers=ZOO_LAYERS)
    steps = M // cfg.batch_size
    print(f"phase 12: the edge model zoo at U = I = {U}, {graph.num_edges} "
          f"edges, D = {D}, {cfg.num_layers} layers, batch "
          f"{cfg.batch_size}, edge_dropout {cfg.edge_dropout}", flush=True)
    a_name = "csr_gather_scale_segsum"
    a_total = 0
    timer = StageTimer()
    pre = tuple(torch.from_numpy(pre_tables[k]).to(dev)
                for k in ("user_embedding", "item_embedding"))
    last_emb = torch.cat(pre, dim=0)
    # phase 6's RAGraph pretrain step (its model, params, batch), to set
    # the zoo's steps beside
    step_ms = {"RAGraph-pretrain": time_step(
        *trained[2:5], torch.Generator(dev).manual_seed(SEED + 22), 5,
        dev)["step"]}

    def log(msg):
        pass

    # (b) one step of each class
    for i, (name, cls, mode) in enumerate(zoo_classes()):
        model = cls(cfg, graph, phase="finetune")
        params = model.init_params(torch.Generator(dev).manual_seed(
            SEED + 30 + i), pretrained_tables=pre)
        native.reset_launches()
        set_dynamic_state(model, mode, params, last_emb)
        torch.cuda.synchronize()
        meta = native.LAUNCHES.get(a_name, 0)
        if meta != (ZOO_LAYERS if mode == "roland" else 0):
            fail(f"zoo {name}: the meta layers launched kernel A {meta} "
                 f"times")
        a_total += meta
        want = 2 * ZOO_LAYERS * zoo_forwards(model)
        if want != ZOO_A_PER_STEP[name]:
            fail(f"zoo {name}: the code implies {want} launches of A a "
                 f"step, the table {ZOO_A_PER_STEP[name]}")
        batch = zoo_batch(ds, dev, ZOO_N_NEGS if getattr(
            model, "multi_negs", False) else 1, SEED + 12)
        gen = torch.Generator(dev).manual_seed(SEED + 50 + i)
        launches = check_step(
            f"zoo {name}", EdgeTrainer(model, ds, logger=log), params, batch,
            gen, {a_name: want, "csr_segment_sum": 0}, tuple(params))
        a_total += launches.get(a_name, 0)
        native.reset_launches()
        step_ms[name] = time_step(model, params, batch, gen, 5, dev)["step"]
        a_total += native.LAUNCHES.get(a_name, 0)
        del model, params
    print(json.dumps({"zoo_step_ms": step_ms}), flush=True)

    # (c) an epoch of pretraining of each plugin
    epoch = {}
    for name, cls in (("SGL", e.SGLPlugin), ("SimGCL", e.SimGCLPlugin),
                      ("MixGCF", e.MixGCFPlugin)):
        model = cls(cfg, graph, phase="pretrain")
        params = model.init_params(torch.Generator(dev).manual_seed(SEED))
        native.reset_launches()
        res = timer(f"{name}_pretrain_epoch", lambda: EdgeTrainer(
            model, ds, logger=log).train(
                params, torch.Generator(dev).manual_seed(SEED + 1),
                num_epochs=1, rng=np.random.default_rng(SEED + 2)))
        n_a = native.LAUNCHES.get(a_name, 0)
        a_total += n_a
        want = steps * ZOO_A_PER_STEP[name] + ZOO_LAYERS
        loss = res.history[0]["loss"]
        if n_a != want or not math.isfinite(loss) \
                or not math.isfinite(res.best_perform["recall"][0]):
            fail(f"zoo {name} pretrain epoch: loss {loss}, kernel A "
                 f"{n_a} launches, expected {want}")
        epoch[name] = {"loss": loss,
                       "recall@20": float(res.best_perform["recall"][0]),
                       "train_s": res.history[0]["train_time"]}
        del model, params

    # (c) one staged_dynamic stage each of ROLAND and SGL x EvolveGCN-H
    rng = np.random.default_rng(SEED + 14)
    ft_rows, stage_rows = finetune_rows(rng, U, I, FT_ROWS)
    val_rows = [(u, items[0]) for u, items in ds.test_user_dict.items()]
    ft_steps = FT_ROWS // cfg.batch_size
    stages = {}
    for name, cls, mode, per_step in (
            ("Roland", e.Roland, "roland", 2 * ZOO_LAYERS),
            ("SGL-evolvegcn_h", e.make_dynamic(e.SGLPlugin, "evolvegcn_h"),
             "evolvegcn_h", 6 * ZOO_LAYERS)):
        native.reset_launches()
        res = timer(f"staged_dynamic_{name}", lambda: e.staged_dynamic(
            train_rows, ft_rows, [stage_rows], pre_tables,
            lambda phase: cfg, SEED, cls, device=dev, mode=mode,
            num_epochs=FT_EPOCHS, logger=log, val_rows=val_rows))
        n_a = native.LAUNCHES.get(a_name, 0)
        a_total += n_a
        # the meta layers (ROLAND), each epoch's steps and evaluation, and
        # the stage's last generate
        want = (ZOO_LAYERS if mode == "roland" else 0) + FT_EPOCHS * (
            ft_steps * per_step + ZOO_LAYERS) + ZOO_LAYERS
        if n_a != want or len(res.recalls) != 1 \
                or not np.isfinite(res.recalls + res.ndcgs).all():
            fail(f"staged_dynamic {name}: recalls {res.recalls} ndcgs "
                 f"{res.ndcgs}, kernel A {n_a} launches, expected {want}")
        stages[name] = {"recall@20": res.recalls[0],
                        "ndcg@20": res.ndcgs[0], "launches_A": n_a}

    # (d) the CLI on the synthetic stream
    native.reset_launches()
    cli_recalls = timer("cli", lambda: zoo_cli(dev))
    a_total += native.LAUNCHES.get(a_name, 0)
    if a_total <= 0:
        fail("phase 12 never launched kernel A")
    print(json.dumps({"zoo_ms": timer.ms, "zoo_pretrain_epoch": epoch,
                      "zoo_staged_dynamic": stages,
                      "zoo_cli_recall@20": cli_recalls,
                      "zoo_launches_A": a_total}), flush=True)
    return a_total


ZOO_CLI = (("SGL", ["--dynamic", "roland"]),
           ("SimGCL", ["--prompt", "graphprompt"]),
           ("GP", ["--prompt", "gpf"]), ("evolvegcn_o", []), ("MixGCF", []))


def zoo_cli(dev):
    """``cli.edge pretrain`` then ``finetune`` of five zoo configurations on
    the synthetic stream, on the card; each writes the JAX CLI's files.
    Returns each configuration's recall@20 per stage."""
    from ragraph_tpu_torch.cli import edge as cli
    out = {}
    for model, extra in ZOO_CLI:
        with tempfile.TemporaryDirectory() as tmp:
            args = ["--data-path", "SYNTH", "--save-dir", tmp, "--device",
                    str(dev), "--batch-size", "128", "--epochs",
                    str(ZOO_CLI_EPOCHS), "--model", model]
            cli.main(["pretrain"] + args)
            res = cli.main(["finetune"] + args + extra)
            files, logs = cli_files(tmp)
        tag = "-".join([model] + extra[1::2])
        want = sorted([f"finetune_{tag}_SYNTH.json",
                       f"pretrain_{model}_SYNTH.json",
                       f"pretrain_{model}_SYNTH.pkl"])
        if files != want or not logs:
            fail(f"CLI {tag} wrote {files} and run logs {logs}, expected "
                 f"{want} and train_log_*.txt")
        if len(res.recalls) != 4 or not np.isfinite(
                res.recalls + res.ndcgs).all():
            fail(f"CLI {tag}: recalls {res.recalls} ndcgs {res.ndcgs}")
        out[tag] = res.recalls
    return out


def phase_step_timing(dev, trained):
    """A pretrain step and a finetune step beside the same step on plain
    PyTorch ops: ``index_add_`` propagation in f32 with autograd's backward,
    and a matmul with ``torch.topk`` for the retrieval
    (``ragraph_tpu_torch.bench.main_path.step_timings``)."""
    import torch

    from ragraph_tpu_torch.bench.main_path import step_timings
    gen = torch.Generator(dev).manual_seed(SEED + 16)
    print(json.dumps(step_timings(*trained, gen, dev)), flush=True)


# Phase 13b: the shape of benchmarks/bench_10m_index.py
IVF_R = 10_000_000
IVF_E = 128
IVF_GEN_CLUSTERS = 1024     # the keys' centres (x 2.0, plus unit noise)
IVF_P = 8192
IVF_CAP = 2560
IVF_ITERS = 5
IVF_NPROBE = 16
IVF_Q = 256
IVF_K = 10
IVF_GEN_ROWS = 1 << 20      # keys drawn and normalised this many at a time
IVF_RECALL_MIN = 0.6        # IVF against the exact answer
APPROX_RECALL_MIN = 0.99    # kernel C against the exact tier (D-G)


def write_edge_file(path, users, items, times):
    """The rows as a reference edge file: ``user \\t items \\t times``, one
    line a user, in user order; returns the rows in the file's order."""
    order = np.argsort(users, kind="stable")
    u, it, t = users[order], items[order], times[order]
    cut = np.flatnonzero(np.diff(u)) + 1
    with open(path, "w") as f:
        for lo, hi in zip(np.r_[0, cut], np.r_[cut, len(u)]):
            f.write(f"{u[lo]}\t{' '.join(map(str, it[lo:hi].tolist()))}\t"
                    f"{' '.join(map(str, t[lo:hi].tolist()))}\n")
    return u, it, t


def phase_host_data(dev, ds, graph):
    """13a: the C++ parser, sampler and CSR assembly against the numpy paths
    at the main path's size, then a pretrain epoch with the trainer's
    defaults (C++ sampler, prefetch) beside one with the numpy sampler in
    line. Returns ``(kernel A's launches, the trainer, its best params)``."""
    import torch

    from ragraph_tpu_torch import native
    from ragraph_tpu_torch.data.edgelist import parse_edge_file
    from ragraph_tpu_torch.models.edge import EdgeModelConfig, RAGraphEdge
    from ragraph_tpu_torch.train import profiling
    from ragraph_tpu_torch.train import trainer as trainer_mod
    from ragraph_tpu_torch.train.trainer import EdgeTrainer
    from ragraph_tpu_torch.utils import native as host
    cfg = EdgeModelConfig(emb_size=D, num_layers=3)
    steps = ds.num_edges // cfg.batch_size
    print(f"phase 13a: host data path at {ds.num_edges} interactions, "
          f"U = I = {ds.num_users}; {steps} batches of {cfg.batch_size}",
          flush=True)
    out = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        with profiling.span(name):
            r = fn()
        out[f"{name}_s"] = time.perf_counter() - t0
        return r

    timed("cpp_build", host.get_lib)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "train.txt")
        want = timed("write_edge_file", lambda: write_edge_file(
            path, ds.edgelist[:, 0], ds.edgelist[:, 1], ds.edge_time))
        got = timed("parse_cpp", lambda: host.parse_edge_file_native(path))
        rows = timed("parse_numpy", lambda: parse_edge_file(
            path, use_native=False))
    py = np.asarray(rows, dtype=np.int64).T
    for name, g, p, w in zip(("users", "items", "times"), got, py, want):
        if not (np.array_equal(g, p) and np.array_equal(g, w)):
            fail(f"13a: the C++ parser's {name} differ from the numpy "
                 f"parser's or the file's")
    del rows, py

    perm = np.random.default_rng(SEED + 20).permutation(ds.num_edges)
    batches = [ds.edgelist[perm[s:s + cfg.batch_size], 0].astype(np.int32)
               for s in range(0, steps * cfg.batch_size, cfg.batch_size)]

    def epoch_negs(native_path, seed):
        rng = np.random.default_rng(seed)
        return [ds.sample_negatives(b, rng, use_native=native_path)
                for b in batches]

    cpp = timed("negatives_cpp", lambda: epoch_negs(True, SEED + 21))
    nump = timed("negatives_numpy", lambda: epoch_negs(False, SEED + 21))
    again = epoch_negs(True, SEED + 21)
    if not all(np.array_equal(a, b) for a, b in zip(cpp, again)):
        fail("13a: the C++ sampler did not repeat from the same seed")
    for tag, negs in (("C++", cpp), ("numpy", nump)):
        keys = np.concatenate([b.astype(np.int64)[:, None] * ds.num_items + n
                               for b, n in zip(batches, negs)]).ravel()
        pos = np.minimum(np.searchsorted(ds._hist_keys, keys),
                         len(ds._hist_keys) - 1)
        if (ds._hist_keys[pos] == keys).any() or keys.size != steps * (
                cfg.batch_size):
            fail(f"13a: a {tag} negative is in its user's train history")
    del cpp, nump, again

    u = ds.edgelist[:, 0]
    it = ds.edgelist[:, 1] + ds.num_users
    indptr, indices = timed("csr_cpp", lambda: host.build_csr_native(
        np.concatenate([it, u]), np.concatenate([u, it]), ds.num_nodes))
    if not (np.array_equal(indptr, ds.recv_indptr)
            and np.array_equal(indices, ds.senders)):
        fail("13a: build_csr_native differs from the dataset's CSR")

    model = RAGraphEdge(cfg, graph, phase="pretrain")
    params = model.init_params(torch.Generator(dev).manual_seed(SEED + 22))
    trainer = EdgeTrainer(model, ds, logger=lambda *_: None)

    def epoch(tag, run):
        native.reset_launches()
        res = timed(f"{tag}_{run}", lambda: trainer.train(
            params, torch.Generator(dev).manual_seed(SEED + 23),
            num_epochs=1, rng=np.random.default_rng(SEED + 24)))
        out[f"{tag}_{run}_train_s"] = res.history[0]["train_time"]
        out[f"{tag}_{run}_step_ms"] = (res.history[0]["train_time"] * 1e3
                                       / steps)
        if not math.isfinite(res.history[0]["loss"]):
            fail(f"13a: {tag} epoch loss {res.history[0]['loss']}")
        return res, dict(native.LAUNCHES)

    @contextlib.contextmanager
    def numpy_inline():
        """The trainer as it ran before: numpy negatives drawn in line with
        the steps."""
        saved = trainer_mod.prefetch
        trainer_mod.prefetch = lambda it, depth: contextlib.nullcontext(it)
        ds.sample_negatives = functools.partial(type(ds).sample_negatives,
                                                ds, use_native=False)
        try:
            yield
        finally:
            trainer_mod.prefetch = saved
            del ds.sample_negatives

    # in turns: the old way, the defaults twice, the old way
    with numpy_inline():
        epoch("epoch_numpy_inline", 1)
    result, launches = epoch("epoch_defaults", 1)
    epoch("epoch_defaults", 2)
    with numpy_inline():
        epoch("epoch_numpy_inline", 2)
    a = launches.get("csr_gather_scale_segsum", 0)
    if a != steps * 2 * cfg.num_layers + cfg.num_layers:
        fail(f"13a: kernel A launched {a} times in the epoch, expected "
             f"{steps} x {2 * cfg.num_layers} + {cfg.num_layers}")
    profiling.assert_all_finite(result.best_params, "13a's trained params")
    out.update(a_launches_per_step=(a - cfg.num_layers) / steps,
               epoch_loss=result.history[0]["loss"],
               parse_rows=int(len(got[0])))
    print(json.dumps({"host_data": out}), flush=True)
    return a, trainer, result.best_params


def phase_ivf(dev):
    """13b: the IVF index at benchmarks/bench_10m_index.py's shape, beside
    the exact tier (D-G, the answer) and kernel C's brute force. Returns
    the kernels' launches in the two checked calls."""
    import torch

    from ragraph_tpu_torch import native
    from ragraph_tpu_torch.ops.similarity import l2_normalize
    from ragraph_tpu_torch.ops.topk import cosine_topk
    from ragraph_tpu_torch.rag.ivf import build_ivf, ivf_search
    from ragraph_tpu_torch.train import profiling
    print(f"phase 13b: IVF at R = {IVF_R}, E = {IVF_E} bf16, P = {IVF_P}, "
          f"cap = {IVF_CAP}, iters = {IVF_ITERS}; search nprobe = "
          f"{IVF_NPROBE}, Q = {IVF_Q}, k = {IVF_K}", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(dev).manual_seed(SEED + 30)
    t0 = time.perf_counter()
    centers = torch.randn((IVF_GEN_CLUSTERS, IVF_E), generator=gen,
                          device=dev) * 2.0
    keys_n = torch.empty((IVF_R, IVF_E), dtype=torch.bfloat16, device=dev)
    for lo in range(0, IVF_R, IVF_GEN_ROWS):
        n = min(IVF_GEN_ROWS, IVF_R - lo)
        pick = torch.randint(0, IVF_GEN_CLUSTERS, (n,), generator=gen,
                             device=dev)
        rows = (centers[pick] + torch.randn((n, IVF_E), generator=gen,
                                            device=dev)).to(torch.bfloat16)
        keys_n[lo:lo + n] = l2_normalize(rows.float()).to(torch.bfloat16)
    queries = torch.randn((IVF_Q, IVF_E), generator=gen, device=dev)
    torch.cuda.synchronize()
    out = {"keys_s": time.perf_counter() - t0}

    t0 = time.perf_counter()
    with profiling.span("ivf_build"):
        index = build_ivf(keys_n, torch.Generator(dev).manual_seed(SEED + 31),
                          num_clusters=IVF_P, capacity=IVF_CAP,
                          iters=IVF_ITERS, normalized=True)
        torch.cuda.synchronize()
    out["ivf_build_s"] = time.perf_counter() - t0
    dropped, valid = int(index.dropped), int(index.valid.sum())
    out.update(dropped=dropped, dropped_share=dropped / IVF_R,
               indexed=valid)
    if valid + dropped != IVF_R:
        fail(f"13b: {valid} indexed + {dropped} dropped != {IVF_R}")

    with profiling.span("ivf_search"):
        s_ivf, ivf_ids = ivf_search(index, queries, IVF_K, nprobe=IVF_NPROBE)
        out["ivf_search_ms"] = cuda_ms(lambda: ivf_search(
            index, queries, IVF_K, nprobe=IVF_NPROBE), reps=10, warmup=2)
    del index
    torch.cuda.empty_cache()

    native.reset_launches()
    s_e, exact_ids = cosine_topk(queries, keys_n, IVF_K, method="bucket",
                                 keys_normalized=True)
    s_c, c_ids = cosine_topk(queries, keys_n, IVF_K, method="approx",
                             keys_normalized=True)
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    want = ("bucket_max", "column_topk", "bucket_rescore", "row_topk",
            "fused_cosine_topk")
    if any(launches.get(k, 0) < 1 for k in want):
        fail(f"13b: launches {launches}, expected each of {want}")
    out["exact_ms"] = cuda_ms(lambda: cosine_topk(
        queries, keys_n, IVF_K, method="bucket", keys_normalized=True),
        reps=10, warmup=1)
    out["approx_ms"] = cuda_ms(lambda: cosine_topk(
        queries, keys_n, IVF_K, method="approx", keys_normalized=True),
        reps=10, warmup=1)

    def recall(ids):
        hit = (ids[:, :, None].long() == exact_ids[:, None, :].long())
        return float(hit.any(-1).float().mean())

    out["ivf_recall@10"] = recall(ivf_ids)
    out["approx_recall@10"] = recall(c_ids)
    out["approx_max_abs_err"] = float((s_c - s_e).abs().max())
    out["ivf_scores_finite"] = bool(torch.isfinite(s_ivf).all())
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["launches"] = launches
    print(json.dumps({"ivf_10m": out}), flush=True)
    if out["ivf_recall@10"] < IVF_RECALL_MIN or not out["ivf_scores_finite"]:
        fail(f"13b: IVF recall@10 {out['ivf_recall@10']} below "
             f"{IVF_RECALL_MIN} or non-finite scores")
    if out["approx_recall@10"] < APPROX_RECALL_MIN \
            or out["approx_max_abs_err"] > TOL_SCORE:
        fail(f"13b: kernel C's recall@10 {out['approx_recall@10']} against "
             f"the exact tier is below {APPROX_RECALL_MIN}, or its scores "
             f"differ by {out['approx_max_abs_err']}")
    del keys_n
    torch.cuda.empty_cache()
    return launches


def phase_utilities(dev, trainer, params):
    """13c: ``cli.edge finetune`` from a reference-style ``.pt`` on the card,
    its run log, the span totals, and ``op_profile`` of one pretrain
    step listing kernel A's launch."""
    import glob

    import torch

    from ragraph_tpu_torch.bench.main_path import xavier_tables
    from ragraph_tpu_torch.cli import edge as edge_cli
    from ragraph_tpu_torch.train import profiling
    print("phase 13c: cli.edge finetune --pre-model-path x.pt, run log, "
          "span totals, op_profile", flush=True)
    with tempfile.TemporaryDirectory() as d:
        tables = xavier_tables(np.random.default_rng(SEED + 40), 64, 128, D)
        pt = os.path.join(d, "x.pt")
        torch.save({"state_dict": {f"{k}.weight": torch.from_numpy(v)
                                   for k, v in tables.items()}}, pt)
        # the span's totals are recorded under a profiler (CPU activity)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]), \
                profiling.span("cli_finetune_pt"):
            res = edge_cli.main(["finetune", "--data-path", "SYNTH",
                                 "--batch-size", "128", "--epochs", "3",
                                 "--pre-model-path", pt, "--save-dir", d])
        totals = profiling.phase_totals()
        logs = glob.glob(os.path.join(d, "train_log_*.txt"))
        if not np.isfinite(res.recalls).all() or len(res.recalls) != 4:
            fail(f"13c: finetune from .pt gave recalls {res.recalls}")
        if not logs or "avg recall" not in open(logs[0]).read():
            fail(f"13c: no run log with the result in {d}: {logs}")

    leaves, optimizer = trainer.prepare(params)
    batch = trainer._to_device(*next(trainer.dataset.train_batches(
        trainer.cfg.batch_size, np.random.default_rng(SEED + 42))))
    gen = torch.Generator(dev).manual_seed(SEED + 41)
    rows = profiling.op_profile(
        lambda: trainer.step(leaves, optimizer, batch, gen)[0], iters=3,
        min_ms=0.0)
    a_rows = [r for r in rows if "walk_kernel" in r["name"]]
    print(json.dumps({"op_profile_top": rows[:8], "kernel_a_rows": a_rows,
                      "phase_totals_s": totals,
                      "cli_recalls": res.recalls}), flush=True)
    if not a_rows or any(r["type"] != "kernel" for r in a_rows):
        fail("13c: op_profile of a pretrain step lists no launch of kernel "
             "A (walk_kernel)")

# phase 14: (world size, meshes, parts) of each bench.multi_device run
MD_RUNS = ((2, "1x2,2x1", "edge,retrieval,huge_k,library"), (4, "2x2", "edge"))
MD_A_PER_STEP = 6           # 3 layers, forward and backward, on every rank
MD_CLI = ["--data-path", "SYNTH", "--batch-size", "128", "--epochs", "1"]


def torchrun(nproc, args, timeout=600):
    """``python -m torch.distributed.run --standalone`` of ``nproc`` ranks
    from the repository's root; fails the script with the ranks' output
    when one fails."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), *args],
        cwd=root, env=env, capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        fail(f"torch.distributed.run {args[:2]} exited {res.returncode}:\n"
             f"{(res.stdout + res.stderr)[-6000:]}")
    return res


def md_summary(world, ranks, total, on_card=True):
    """Print one world's results; check each rank's launches (on the card;
    a CPU rehearsal runs the plain versions, which count none); add them
    to ``total``."""
    r0 = ranks[0]
    for key, rec in r0.get("edge", {}).items():
        a = [r["edge"][key]["launches"].get("csr_gather_scale_segsum", 0)
             for r in ranks]
        if on_card and any(n != MD_A_PER_STEP for n in a):
            fail(f"14a {key}: kernel A launches per rank {a}, expected "
                 f"{MD_A_PER_STEP} each")
        if on_card and key.startswith("finetune") and any(
                r["edge"][key]["launches"].get("fused_cosine_topk", 0) == 0
                for r in ranks):
            fail(f"14a {key}: a rank's finetune step launched no kernel C")
        print(f"  14a {key}: loss {rec['loss']:.7f} (err {rec['loss_err']:.2e})"
              f" grads err {rec.get('grad_err', float('nan')):.2e} params err "
              f"{rec.get('param_err', float('nan')):.2e}; step "
              f"{rec['step_ms']:.1f} ms on the mesh, "
              f"{rec['single_step_ms']:.1f} ms on one device; A per rank {a}",
              flush=True)
    for method, rec in r0.get("retrieval", {}).items():
        names = (("fused_cosine_topk",) if method == "approx" else
                 ("bucket_max", "column_topk", "bucket_rescore", "row_topk"))
        for r in ranks:
            got = r["retrieval"][method]["launches"]
            if on_card and any(got.get(n, 0) == 0 for n in names):
                fail(f"14b {method}: rank {r['rank']} launched {got}")
        print(f"  14b {method}: {rec['ms']:.2f} ms on idx={world} "
              f"(collectives host-staged over gloo) vs "
              f"{rec['single_ms']:.2f} ms on one device; scores err "
              f"{rec['max_abs_err']:.2e} (tol {TOL_SCORE}), rows with "
              f"ties {rec['tie_rows']}", flush=True)
    for dtype, rec in r0.get("huge_k", {}).items():
        print(f"  14c {dtype}: threshold bit for bit, counts exact, mean err "
              f"{rec['mean_err']:.2e}; chunk ms {[round(x, 1) for x in rec['ms']]}"
              f" on idx={world} vs {[round(x, 1) for x in rec['single_ms']]} "
              f"on one device", flush=True)
    if "library" in r0:
        rec = r0["library"]
        for r in ranks:
            if on_card and r["library"]["launches"].get(
                    "fused_cosine_topk", 0) == 0:
                fail(f"14d: rank {r['rank']} retrieved without kernel C")
        print(f"  14d library: fill {rec['fill']} = one device's, rows equal;"
              f" build {rec['build_ms']:.0f} ms vs {rec['single_build_ms']:.0f}"
              f" ms; retrieve {rec['retrieve_ms']:.2f} ms (first call "
              f"{rec['retrieve_first_ms']:.2f}) vs "
              f"{rec['single_retrieve_ms']:.2f} ms, scores err "
              f"{rec['max_abs_err']:.2e}, rows with ties {rec['tie_rows']}",
              flush=True)
    for r in ranks:
        for part in ("edge", "retrieval", "huge_k", "library"):
            recs = r.get(part, {})
            if part == "library" and recs:
                recs = {"": recs}
            for rec in recs.values():
                for name, n in rec.get("launches", {}).items():
                    total[name] = total.get(name, 0) + n
        print(f"  rank {r['rank']} of {world}: {r['seconds']:.1f} s, "
              f"host-staged collectives {r['host_staged']}", flush=True)


def phase_multi_device(dev, small=False):
    """Phase 14 (see the module doc); returns the launches of (a-d),
    summed over the ranks. On a CPU ``dev`` (a rehearsal) the ranks run on
    the CPU, at the bench's small size with ``small``."""
    import torch

    from ragraph_tpu_torch.cli import edge as cli
    print("phase 14: multi-device, every rank on this card over gloo "
          "(collectives staged through host memory: not NCCL times)",
          flush=True)
    on_card = dev.type == "cuda"
    where = [] if on_card else ["--device", "cpu"]
    if on_card:
        torch.cuda.empty_cache()
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        for world, meshes, parts in MD_RUNS:
            out = os.path.join(tmp, f"md{world}")
            t0 = time.perf_counter()
            torchrun(world, ["-m", "ragraph_tpu_torch.bench.multi_device",
                             "--out", out, "--meshes", meshes,
                             "--parts", parts, *where]
                     + (["--small"] if small else []))
            ranks = []
            for r in range(world):
                with open(os.path.join(out, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
            print(f"  world of {world}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            md_summary(world, ranks, total, on_card)

        # (e) the CLI: two ranks on this card over gloo (one launch of
        # finetune, which pretrains first), then a world of one on NCCL
        # against the single-device run
        t0 = time.perf_counter()
        gloo = os.path.join(tmp, "gloo")
        mesh = ["--save-dir", gloo, "--mesh", "dp=1,idx=2", "--dist-backend",
                "gloo", *where]
        torchrun(2, ["-m", "ragraph_tpu_torch.cli.edge", "finetune",
                     *MD_CLI, *mesh])
        files, logs = cli_files(gloo)
        want = ["finetune_RAGraph_SYNTH.json", "pretrain_RAGraph_SYNTH.json",
                "pretrain_RAGraph_SYNTH.pkl"]
        if files != want or len(logs) != 1:
            fail(f"14e: the mesh CLI wrote {files} and run logs {logs}, "
                 f"expected {want} and the launch's one log")
        with open(os.path.join(gloo, "finetune_RAGraph_SYNTH.json")) as f:
            got = json.load(f)
        if len(got["recalls"]) != 4 or not np.isfinite(got["recalls"]).all():
            fail(f"14e: mesh finetune recalls {got['recalls']}")
        nccl = os.path.join(tmp, "nccl")
        torchrun(1, ["-m", "ragraph_tpu_torch.cli.edge", "finetune",
                     *MD_CLI, "--save-dir", nccl, "--mesh", "dp=1,idx=1",
                     *where])
        one = cli.main(["finetune", *MD_CLI, "--save-dir",
                        os.path.join(tmp, "one"), "--device", str(dev)])
        with open(os.path.join(nccl, "finetune_RAGraph_SYNTH.json")) as f:
            world1 = json.load(f)
        err = float(np.max(np.abs(np.asarray(world1["recalls"])
                                  - np.asarray(one.recalls))))
        if err > 1e-3:
            fail(f"14e: NCCL world of one {world1['recalls']} vs one device "
                 f"{one.recalls}")
        print(f"  14e: --mesh dp=1,idx=2 over gloo: recall@20 per stage "
              f"{got['recalls']}, files {files}, {len(logs)} run logs; NCCL "
              f"world of one vs one device: largest recall difference "
              f"{err:.2e}; {time.perf_counter() - t0:.1f} s", flush=True)
    return total


# ---- phase 15: every width and every k ------------------------------------

WIDE_E = (4, 12, 100, 264, 512, 1000)   # widths of C and D-G
WIDE_K = (129, 256, 1000, 4096)         # k of the selection family
WIDE_D = (1, 3, 65, 514, 640, 1024)     # row widths of A, B and I
WIDE_NODE_HIDDEN = 512                  # phase 15a's --hidden
WIDE_EMB = 100                          # phase 15b's emb_size
WIDE_PATH_K = 1000                      # phase 15b's large retrieve_num
WIDE_STEPS = 6                          # phase 15b's steps of each phase


def wide_topk_checks(gen, dev):
    """Phase 15c, retrieval: at every width of WIDE_E, kernel C on its own
    lists and on the selection family (every k of WIDE_K), with ragged Q
    and R, a valid mask with fewer valid rows than k, and k > R; D and F
    against their plain versions and D against F bit for bit; the bucket
    family at every k of WIDE_K through D-G (R >= 128 k). E and G (the
    selection family beyond 128) bit for bit their plain versions at every
    k of WIDE_K on tied and exhausted inputs, and at k = 20,000 (the sort
    in global memory). Then the main path's refresh chunk (2,048 x
    262,144) at E = 100: C at k = 10 and 1,000, the bucket family at both.
    Returns the largest errors."""
    import torch

    from ragraph_tpu_torch.ops import bucket_topk as bt
    from ragraph_tpu_torch.ops import score_tile as st
    from ragraph_tpu_torch.ops.similarity import l2_normalize
    errs = {"C": 0.0, "D": 0.0, "F": 0.0, "E": 0.0, "G": 0.0, "score": 0.0,
            "select": 0.0}

    def unit(n, e):
        return l2_normalize(torch.randn(n, e, generator=gen, device=dev))

    def some_valid(n, n_valid):
        valid = torch.zeros(n, dtype=torch.bool, device=dev)
        valid[torch.randperm(n, generator=gen, device=dev)[:n_valid]] = True
        return valid

    tol = (0.0, TOL_SCORE)
    for e in WIDE_E:
        q, keys = unit(37, e), unit(5003, e)
        for k in (10, 128) + WIDE_K:
            errs["C"] = max(errs["C"], check_topk(
                f"C Q=37 R=5003 E={e} k={k}", q, keys, k))
        valid = some_valid(5003, 100)
        for k in (50, 129, 1000):
            check_topk(f"C Q=37 R=5003 E={e} k={k} valid=100", q, keys, k,
                       valid)
        check_topk(f"C Q=5 R=300 E={e} k=1000 (k > R)", q[:5], keys[:300],
                   1000)
        qh, kh = unit(70, e).bfloat16(), unit(1000, e).bfloat16()
        v = some_valid(1000, 600)
        tag = f"Q=70 R=1000 E={e} valid=600"
        errs["D"] = max(errs["D"], check_close(
            f"D {tag}", bt.bucket_max(kh, qh, v),
            bt.bucket_max_plain(kh, qh, v), tol))
        assign = torch.randint(-1, 74, (8, 70), generator=gen, device=dev,
                               dtype=torch.int32)
        errs["F"] = max(errs["F"], check_close(
            f"F {tag} P=70", bt.bucket_rescore(assign, qh, kh, v),
            bt.bucket_rescore_plain(assign, qh, kh, v), tol))
        d_equals_f(tag, kh, qh, v, torch.arange(70, device=dev))
        # the score matrix: its plain version, and D's maxima bit for bit
        sm = st.score_matrix(kh, qh, v)
        errs["score"] = max(errs["score"], check_close(
            f"score_matrix {tag}", sm, st.score_matrix_plain(kh, qh, v), tol))
        check_same(f"score_matrix bucket maxima against D {tag}",
                   sm.view(70, -1, LANE_KEYS).amax(2).T.contiguous(),
                   bt.bucket_max(kh, qh, v))
        for k, n_q in zip(WIDE_K, (19, 11, 5, 3)):
            n_r = LANE_KEYS * k + 37
            check_bucket_family(
                f"D-G Q={n_q} R={n_r} E={e} k={k}", unit(n_q, e),
                unit(n_r, e), k, some_valid(n_r, n_r - 1000))
        check_bucket_family(f"D-G Q=4 R=2000 E={e} k=1000 valid=600 "
                            f"(dense branch)", unit(4, e), unit(2000, e),
                            1000, some_valid(2000, 600))
        check_bucket_family(f"D-G Q=5 R=300 E={e} k=1000 (k > R)",
                            unit(5, e), unit(300, e), 1000)

    def same(tag, fn, plain, x, ks):
        worst = 0.0
        for k in ks:
            for got, ref, what in zip(fn(x, k), plain(x, k), "vi"):
                err = check_same(f"{tag} k={k} {what}", got, ref)
                worst = max(worst, err if what == "v" else 0.0)
        return worst

    grid = torch.round(torch.randn(5000, 37, generator=gen, device=dev) * 2)
    grid[:, 0] = bt.NEG_INF                 # a column with nothing in it
    grid[2500:, -1] = bt.NEG_INF            # one exhausted halfway
    grid[:, 1] = 0.5                        # a column of equal values
    errs["E"] = same("E R=5000 Q=37 grid", bt.column_topk,
                     bt.column_topk_plain, grid, WIDE_K)
    same("E R=300 Q=9 (k > R)", bt.column_topk, bt.column_topk_plain,
         grid[:300, :9].contiguous(), (1000,))
    rows = torch.round(torch.randn(9, 50000, generator=gen, device=dev) * 2)
    rows[0] = bt.NEG_INF
    rows[-1, 25000:] = bt.NEG_INF
    rows[1] = 0.5
    errs["G"] = same("G Q=9 W=50000 grid", bt.row_topk, bt.row_topk_plain,
                     rows, WIDE_K)
    errs["select"] = max(errs["E"], errs["G"])
    same("G Q=3 W=30000 (the sort in global memory)", bt.row_topk,
         bt.row_topk_plain,
         torch.randn(3, 30000, generator=gen, device=dev), (20000,))
    del grid, rows

    # the main path's refresh chunk at phase 15b's width
    q, keys = unit(CHUNK, WIDE_EMB), unit(U + I, WIDE_EMB)
    for k in (K_PATH, WIDE_PATH_K):
        errs["C"] = max(errs["C"], check_topk(
            f"C Q={CHUNK} R={U + I} E={WIDE_EMB} k={k}", q, keys, k))
        torch.cuda.empty_cache()
        check_bucket_family(f"D-G Q={CHUNK} R={U + I} E={WIDE_EMB} k={k}", q,
                            keys, k)
        torch.cuda.empty_cache()
    qh, kh = q.bfloat16(), keys.bfloat16()
    tag = f"Q={CHUNK} R={U + I} E={WIDE_EMB}"
    d_equals_f(tag, kh, qh, None, torch.arange(64, device=dev))
    sm = st.score_matrix(kh, qh)
    check_same(f"score_matrix bucket maxima against D {tag}",
               sm.view(CHUNK, -1, LANE_KEYS).amax(2).T.contiguous(),
               bt.bucket_max(kh, qh))
    from ragraph_tpu_torch.ops import select_topk as sl
    for got, ref, what in zip(sl.select_topk(sm, WIDE_PATH_K, U + I),
                              sl.select_topk_plain(sm[:, :U + I],
                                                   WIDE_PATH_K), "vi"):
        err = check_same(f"select_topk {tag} k={WIDE_PATH_K} {what}", got,
                         ref)
        errs["select"] = max(errs["select"], err if what == "v" else 0.0)
    del sm
    torch.cuda.empty_cache()
    return errs


LANE_KEYS = 128   # keys a bucket: the bucket family runs D-G for R >= 128 k


def f64_rows_sum(terms_fn, indptr, n_rows, d, block=128):
    """``out[r] = sum of terms_fn(c0, c1)[e]`` over the edges of row ``r``,
    in float64, in column blocks (the terms of 2^21 edges at 1,024 columns
    are 17 GB in float64)."""
    import torch

    from ragraph_tpu_torch.ops import csr_segment as cs
    seg = cs._segment_ids(indptr, int(indptr[-1]))
    out = torch.zeros(n_rows, d, dtype=torch.float64, device=indptr.device)
    for c0 in range(0, d, block):
        c1 = min(d, c0 + block)
        out[:, c0:c1].index_add_(0, seg, terms_fn(c0, c1).double())
    return out


def wide_segsum_checks(dev, graph, skewed):
    """Phase 15c, propagation: kernels A (bf16 and f32), B and I (bf16
    switch) at every width of WIDE_D, on phase 2's graph against their
    plain versions and on phase 2b's skewed graph (degree exponent 0.8, hub
    rows of about 37,000 edges) against their terms summed in float64, at
    TOL_SEGSUM. Returns the largest errors, the skewed graph's apart."""
    import torch

    from ragraph_tpu_torch.ops import csr_segment as cs
    gen = torch.Generator(dev).manual_seed(SEED + 50)
    errs = dict.fromkeys(("A", "B", "I", "A_skewed", "B_skewed",
                          "I_skewed"), 0.0)
    g = graph
    graphs = (
        ("main", g.senders, g.recv_indptr, g.edge_norm * 0.5
         + g.time_norm * 0.5, g.num_nodes, (g.recv_plan, g.send_plan),
         (g.edge_norm_send * 0.5 + g.time_norm_send * 0.5, g.recv_of_send,
          g.send_indptr)),
        ("skewed", skewed["senders"], skewed["recv_indptr"], skewed["w"],
         len(skewed["recv_indptr"]) - 1,
         (cs.walk_plan(skewed["recv_indptr"]),
          cs.walk_plan(skewed["send_indptr"])),
         (skewed["w_send"], skewed["recv_of_send"], skewed["send_indptr"])))
    for tag, send, ip, w, n, plans, bwd in graphs:
        n_e = len(send)
        sfx = "" if tag == "main" else "_skewed"
        for d in WIDE_D:
            table = torch.randn(n, d, generator=gen, device=dev)
            name = f"{tag} graph D={d}"
            for bf16 in (True, False):
                got = cs.gather_scale_segsum(table, w, *bwd[:1], send, ip,
                                             *bwd[1:], bf16=bf16,
                                             recv_plan=plans[0],
                                             send_plan=plans[1])
                if tag == "main":
                    ref = cs.gather_scale_segsum_plain(table, w, send, ip,
                                                       bf16)
                else:
                    t = table.to(torch.bfloat16).float() if bf16 else table
                    ww = w.to(torch.bfloat16).float() if bf16 else w
                    ref = f64_rows_sum(
                        lambda c0, c1: t[send.long(), c0:c1] * ww[:, None],
                        ip, n, d).float()
                errs["A" + sfx] = max(errs["A" + sfx], check_close(
                    f"A bf16={bf16} {name}", got, ref, TOL_SEGSUM))
                del got, ref
            msgs = table[send.long()] * w[:, None]
            got = cs.csr_segment_sum(msgs, ip)
            ref = cs.segment_sum_plain(msgs, ip) if tag == "main" else \
                f64_rows_sum(lambda c0, c1: msgs[:, c0:c1], ip, n, d).float()
            errs["B" + sfx] = max(errs["B" + sfx], check_close(
                f"B {name}", got, ref, TOL_SEGSUM))
            del msgs, got, ref
            msgs2 = pack_half_split(table[send.long()], 512)
            got = cs.segsum_packed2_w(msgs2, w, ip, n_e, bf16=True)
            if tag == "main":
                ref = cs.segsum_packed2_w_plain(msgs2, w, ip, n_e, 512, True)
            else:
                tb = table.to(torch.bfloat16).float()
                wb = w.to(torch.bfloat16).float()
                ref = f64_rows_sum(
                    lambda c0, c1: tb[send.long(), c0:c1] * wb[:, None],
                    ip, n, d).float()
            errs["I" + sfx] = max(errs["I" + sfx], check_close(
                f"I bf16=True {name}", got, ref, TOL_SEGSUM))
            del msgs2, got, ref, table
            torch.cuda.empty_cache()
    return errs


def wide_steps(name, trainer, params, batches, gen, want, grad_names):
    """``len(batches)`` steps of ``trainer`` from ``params``, then one more
    on the first batch, each with its launches counted from zero and held
    to ``want``; the gradients of ``grad_names`` finite and non-zero after
    the last. Returns the losses and the trained leaves."""
    import torch

    from ragraph_tpu_torch import native
    from ragraph_tpu_torch.train.trainer import param_leaves
    leaves, optimizer = trainer.prepare(params)
    losses, total = [], {}
    for i, batch in enumerate(batches + batches[:1]):
        native.reset_launches()
        loss, _ = trainer.step(leaves, optimizer, batch, gen)
        torch.cuda.synchronize()
        launches = dict(native.LAUNCHES)
        if launches != want:
            fail(f"15b {name} step {i}: launches {launches}, expected "
                 f"{want}")
        for kernel, n in launches.items():
            total[kernel] = total.get(kernel, 0) + n
        losses.append(float(loss))
    for leaf, t in param_leaves(leaves):
        if leaf.split(".")[0] in grad_names and (
                t.grad is None or not bool(torch.isfinite(t.grad).all())
                or float(t.grad.abs().max()) == 0.0):
            fail(f"15b {name}: gradient of {leaf} missing, non-finite or all "
                 f"zero")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"15b {name}: losses {losses} are not finite, or the first "
             f"batch's is not lower after {len(batches)} steps")
    print(f"  15b {name}: {len(losses)} steps, losses {losses}, launches "
          f"per step {want}", flush=True)
    return losses, leaves, total


def phase_wide_edge(dev, ds, graph):
    """Phase 15b: phase 6's path (U = I = 131,072, 2^20 interactions, 3
    layers, batch 2,048) at emb_size 100: WIDE_STEPS pretrain steps, then
    WIDE_STEPS steps of the finetune model that ``staged_finetune`` trains
    (retrieve_num 10: kernel A 6 launches a step, kernel C 128 on rows
    padded to 104 columns), then WIDE_STEPS at retrieve_num 1,000 (the
    selection family: 128 score matrices and 128 selections a step). Each
    run's loss on its first batch must be finite and lower after its
    steps. Returns the launches of the three runs, summed."""
    import dataclasses

    import torch

    from ragraph_tpu_torch.bench.main_path import finetune_rows
    from ragraph_tpu_torch.data.edgelist import load_edge_dataset
    from ragraph_tpu_torch.models.edge import (EdgeGraphArrays,
                                               EdgeModelConfig, RAGraphEdge)
    from ragraph_tpu_torch.train.trainer import EdgeTrainer
    cfg = EdgeModelConfig(emb_size=WIDE_EMB, num_layers=3)
    print(f"phase 15b: training at U = I = {U}, {graph.num_edges} edges, "
          f"emb_size {WIDE_EMB}, {cfg.num_layers} layers, batch "
          f"{cfg.batch_size}: {WIDE_STEPS} steps of each phase", flush=True)
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(SEED + 60)
    it = ds.train_batches(cfg.batch_size, np.random.default_rng(SEED + 61))
    batches = [tuple(torch.from_numpy(a).to(dev) for a in next(it))
               for _ in range(WIDE_STEPS)]
    n_chunks = -(-(U + I) // cfg.batch_size)
    a_step = 2 * cfg.num_layers

    model = RAGraphEdge(cfg, graph, phase="pretrain")
    params = model.init_params(torch.Generator(dev).manual_seed(SEED + 62))
    out, launches = {}, {}

    def count(total):
        for kernel, n in total.items():
            launches[kernel] = launches.get(kernel, 0) + n

    out["pretrain_losses"], leaves, total = wide_steps(
        "pretrain", EdgeTrainer(model, ds, logger=lambda *_: None), params,
        batches, gen, {"csr_gather_scale_segsum": a_step, "edge_weights": 1},
        ("user_embedding", "item_embedding"))
    count(total)
    tables = tuple(leaves[k].detach() for k in ("user_embedding",
                                                "item_embedding"))
    del model, params, leaves
    ft_rows, stage_rows = finetune_rows(np.random.default_rng(SEED + 63), U,
                                        I, FT_ROWS)
    ft_ds = load_edge_dataset(ft_rows, stage_rows, num_users=U, num_items=I,
                              phase="finetune")
    ft_graph = EdgeGraphArrays.from_dataset(ft_ds, dev)
    grads = ("user_embedding", "item_embedding", "gating_weight",
             "gating_bias")
    for k in (cfg.retrieve_num, WIDE_PATH_K):
        ft_model = RAGraphEdge(dataclasses.replace(cfg, retrieve_num=k),
                               ft_graph, phase="finetune")
        ft_model.make_resource_graph(*tables)
        ft_params = ft_model.init_params(
            torch.Generator(dev).manual_seed(SEED + 64),
            pretrained_tables=tables)
        want = {"csr_gather_scale_segsum": a_step, "edge_weights": 1}
        if k <= 128:
            want["fused_cosine_topk"] = 1
        else:
            want.update(score_matrix=n_chunks, select_topk=n_chunks)
        out[f"finetune_retrieve_num_{k}_losses"], _, total = wide_steps(
            f"finetune retrieve_num={k}",
            EdgeTrainer(ft_model, ft_ds, logger=lambda *_: None), ft_params,
            batches, gen, want, grads)
        count(total)
        del ft_model, ft_params
        torch.cuda.empty_cache()
    out["phase_s"], out["launches"] = time.perf_counter() - t0, launches
    print(json.dumps({"wide_edge": out}), flush=True)
    return launches


def phase_wide_timing(dev, graph, errs, family_launches):
    """Phase 15d: device times (``device_ms``) of the new shapes beside
    their one-call yardsticks and bounds, at the main path's refresh chunk
    (2,048 x 262,144): kernel C at E = 100 (rows padded to 104) and at E =
    512 and 1,000 (chunks of 128 columns), k = 10; the selection family at
    E = 100, k = 1,000 (the score matrix and the selection apart, and C's
    path whole); the bucket family's kernels at E = 100, k = 1,000 (and the
    family whole by a loop of calls: its glue reads one count to the host);
    kernel A at D = 100, 514 and 1,024 on the main path's graph. Returns
    the kernels-line entries of the selection family's two kernels."""
    import torch

    from ragraph_tpu_torch.ops import bucket_topk as bt
    from ragraph_tpu_torch.ops import csr_segment as cs
    from ragraph_tpu_torch.ops import select_topk as sl
    from ragraph_tpu_torch.ops.fused_retrieval import fused_cosine_topk
    from ragraph_tpu_torch.ops.score_tile import (score_matrix,
                                                  score_matrix_plain)
    from ragraph_tpu_torch.ops.similarity import l2_normalize
    print("phase 15d: timing the new shapes", flush=True)
    gen = torch.Generator(dev).manual_seed(SEED + 70)
    n_r = U + I
    rows = []

    def bound(n_bytes, n_ops, rate):
        by_b, by_o = n_bytes / HBM_BYTES_PER_MS, n_ops / rate
        return {"bound_ms": max(by_b, by_o),
                "bound_by": "bytes" if by_b >= by_o else "operations"}

    for e, k in ((WIDE_EMB, K_PATH), (512, K_PATH), (1000, K_PATH),
                 (WIDE_EMB, WIDE_PATH_K)):
        q = l2_normalize(torch.randn(CHUNK, e, generator=gen, device=dev))
        keys = l2_normalize(torch.randn(n_r, e, generator=gen, device=dev))
        qb = q.to(torch.bfloat16).float()
        kb = keys.to(torch.bfloat16).float()
        scores = qb @ kb.T
        rows.append(dict(
            name="fused_cosine_topk" if k <= 128 else
            "fused_cosine_topk (score_matrix + select_topk)",
            Q=CHUNK, R=n_r, E=e, k=k,
            device_ms=device_ms(lambda: fused_cosine_topk(q, keys, k), 5),
            library_device_ms=device_ms(lambda: torch.matmul(qb, kb.T), 5)
            + device_ms(lambda: torch.topk(scores, k, dim=1), 5),
            **bound(2 * CHUNK * e + 2 * n_r * e + 8 * CHUNK * k,
                    2 * CHUNK * n_r * e, BF16_FLOP_PER_MS)))
        print(f"  {json.dumps(rows[-1])}", flush=True)
        c_library = rows[-1]["library_device_ms"]
        if e != WIDE_EMB or k <= 128:
            del q, keys, qb, kb, scores
            torch.cuda.empty_cache()

    # the family's two kernels apart, at E = 100, k = 1,000
    qh, kh = q.to(torch.bfloat16), keys.to(torch.bfloat16)
    kh8 = torch.nn.functional.pad(kh, (0, 4)).contiguous()
    qh8 = torch.nn.functional.pad(qh, (0, 4)).contiguous()
    k = WIDE_PATH_K
    sm = score_matrix(kh8, qh8)
    family = []
    for name, kernel, plain, library, n_bytes, n_ops, rate, key in (
            ("score_matrix", lambda: score_matrix(kh8, qh8),
             lambda: score_matrix_plain(kh, qh),
             lambda: torch.matmul(qb, kb.T),
             2 * CHUNK * WIDE_EMB + 2 * n_r * WIDE_EMB + 4 * sm.numel(),
             2 * CHUNK * n_r * WIDE_EMB, BF16_FLOP_PER_MS, "score"),
            ("select_topk", lambda: sl.select_topk(sm, k, n_r),
             lambda: sl.select_topk_plain(sm[:, :n_r], k),
             lambda: torch.topk(scores, k, dim=1),
             4 * CHUNK * n_r + 8 * CHUNK * k, CHUNK * n_r, F32_FLOP_PER_MS,
             "select")):
        family.append(dict(
            name=name, route="cuda",
            source="ragraph_tpu_torch/csrc/" + (
                "bucket_topk.cu" if name == "score_matrix"
                else "select_topk.cu"),
            replaces="ragraph_tpu/ops/pallas_retrieval.py:130",
            launches=family_launches.get(name, 0), max_abs_err=errs[key],
            ms=cuda_ms(kernel, reps=10), plain_ms=cuda_ms(plain, reps=1,
                                                          warmup=1),
            **bound(n_bytes, n_ops, rate),
            library_ms=cuda_ms(library, reps=5),
            device_ms=device_ms(kernel, 5),
            library_device_ms=device_ms(library, 5), E=WIDE_EMB, k=k))
        torch.cuda.empty_cache()
    del sm, scores, qh8, kh8
    torch.cuda.empty_cache()

    # the bucket family's kernels at E = 100, k = 1,000, each on what the
    # path hands it
    st = bucket_stages(q, keys, k)
    bm, cand = st["bm"], st["cand"]
    assign = st["assign"][:, :P_MAX].contiguous()
    nb = bm.shape[0]
    n_live = int((assign < CHUNK).sum())
    e8 = st["qh"].shape[1]
    for name, kernel, library, n_bytes, n_ops, rate in (
            ("bucket_max", lambda: bt.bucket_max(st["kh"], st["qh"]), None,
             2 * n_r * e8 + 2 * CHUNK * e8 + 4 * nb * CHUNK,
             2 * CHUNK * n_r * WIDE_EMB, BF16_FLOP_PER_MS),
            ("column_topk (select_topk)", lambda: bt.column_topk(bm, k),
             lambda: torch.topk(bm, k, dim=0),
             4 * nb * CHUNK + 8 * CHUNK * k, nb * CHUNK, F32_FLOP_PER_MS),
            ("bucket_rescore", lambda: bt.bucket_rescore(assign, st["qh"],
                                                         st["kh"]), None,
             4 * nb * P_MAX + 2 * CHUNK * e8 + 2 * n_r * e8
             + 4 * nb * P_MAX * bt.LANE,
             2 * n_live * bt.LANE * WIDE_EMB, BF16_FLOP_PER_MS),
            ("row_topk (select_topk)", lambda: bt.row_topk(cand, k),
             lambda: torch.topk(cand, k, dim=1),
             4 * cand.numel() + 8 * CHUNK * k, cand.numel(),
             F32_FLOP_PER_MS)):
        rows.append(dict(
            name=name, Q=CHUNK, R=n_r, E=WIDE_EMB, k=k,
            device_ms=device_ms(kernel, 5),
            library_device_ms=None if library is None
            else device_ms(library, 5), **bound(n_bytes, n_ops, rate)))
        print(f"  {json.dumps(rows[-1])}", flush=True)
    rows.append(dict(
        name="bucketed_exact_topk (the family, a loop of calls)", Q=CHUNK,
        R=n_r, E=WIDE_EMB, k=k, ms=cuda_ms(
            lambda: bt.bucketed_exact_topk(q, keys, k), reps=5),
        bucket_rescore_rounds=st["assign"].shape[1] // P_MAX,
        library_device_ms=c_library,
        **bound(2 * CHUNK * WIDE_EMB + 2 * n_r * WIDE_EMB + 8 * CHUNK * k,
                2 * CHUNK * n_r * WIDE_EMB, BF16_FLOP_PER_MS)))
    print(f"  {json.dumps(rows[-1])}", flush=True)
    del st, bm, cand, assign, q, keys, qb, kb, qh, kh
    torch.cuda.empty_cache()

    # kernel A at the new widths, bf16, with the graph's walk plans
    g = graph
    n, n_e = g.num_nodes, g.num_edges
    w = g.edge_norm * 0.5 + g.time_norm * 0.5
    w_send = g.edge_norm_send * 0.5 + g.time_norm_send * 0.5
    args = (w, w_send, g.senders, g.recv_indptr, g.recv_of_send,
            g.send_indptr)
    planned = {"recv_plan": g.recv_plan, "send_plan": g.send_plan}
    for d in (WIDE_EMB, 514, 1024):
        table = torch.randn(n, d, generator=gen, device=dev)
        tb = table.to(torch.bfloat16).float()
        wb = w.to(torch.bfloat16).float()
        with warnings.catch_warnings():    # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            csr = torch.sparse_csr_tensor(g.recv_indptr.long(),
                                          g.senders.long(), wb, size=(n, n))
        rows.append(dict(
            name="csr_gather_scale_segsum", N=n, edges=n_e, D=d,
            device_ms=device_ms(lambda: cs.gather_scale_segsum(
                table, *args, bf16=True, **planned)),
            library_device_ms=device_ms(lambda: torch.sparse.mm(csr, tb), 5),
            **bound(4 * n * d + 8 * n_e + 4 * (n + 1) + 4 * n * d,
                    2 * n_e * d, F32_FLOP_PER_MS)))
        print(f"  {json.dumps(rows[-1])}", flush=True)
        del table, tb, csr
        torch.cuda.empty_cache()
    print(json.dumps({"wide_timing": rows}), flush=True)
    return family


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from ragraph_tpu_torch import native
    from ragraph_tpu_torch.bench.main_path import make_rows, xavier_tables
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
    lib_path, seconds, log = native.build(verbose=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip(), flush=True)
    native.lib()
    print(f"  build_seconds={seconds:.1f}", flush=True)
    phase_sass(lib_path)
    phase_register_lists(log)

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    train, test = make_rows(rng, U, I, M)
    ds = load_edge_dataset(train, test, num_users=U, num_items=I)
    del test
    graph = EdgeGraphArrays.from_dataset(ds, dev)
    params = params_from_jax(xavier_tables(rng, U, I, D), dev)
    print(f"  data_seconds={time.perf_counter() - t0:.1f} "
          f"edges={graph.num_edges} nodes={graph.num_nodes}", flush=True)
    if graph.num_edges != 2 * M or graph.num_nodes != U + I:
        fail("main-path graph has the wrong size")

    probes = probe_inputs(dev)
    errs = phase_kernel_checks(rng, dev, graph, probes)
    skewed = phase_skewed(rng, dev)
    launches, keys = phase_main_path(dev, ds, graph, params)
    launches.update(phase_exact_tier(dev, params, keys))
    phase_huge_k(dev, graph, params)
    phase_int8(dev, params, keys)
    del keys
    torch.cuda.empty_cache()
    launches.update(phase_ops_path(dev, graph))
    torch.cuda.empty_cache()
    launches.update(phase_probe_scripts())
    phase_small_agreement(dev)
    phase_small_training_agreement(dev)
    phase_small_node_agreement(dev)
    phase_cli(dev)
    trained, pre_tables = phase_training(dev, train, ds, graph)
    phase_small_zoo_agreement(dev)
    zoo_a = phase_zoo(dev, train, ds, graph, pre_tables, trained)
    del train
    with tempfile.TemporaryDirectory() as tu_root:
        write_tu_dataset(tu_root, node_dataset()[0])
        errs["C"] = max(errs["C"], phase_node_path(dev, tu_root))
        c_err, _ = phase_graph_level(dev, tu_root)
        errs["C"] = max(errs["C"], c_err)
        phase_fewshot(dev, tu_root)
        errs["C"] = max(errs["C"], phase_node_path(
            dev, tu_root, hidden=WIDE_NODE_HIDDEN, modes=("finetune",),
            label="phase 15a"))
    a_13, trainer_13, params_13 = phase_host_data(dev, ds, graph)
    ivf_launches = phase_ivf(dev)
    phase_utilities(dev, trainer_13, params_13)
    del trainer_13, params_13
    md_launches = phase_multi_device(dev)
    t15 = time.perf_counter()
    wide_launches = phase_wide_edge(dev, ds, graph)
    wide_errs = wide_topk_checks(torch.Generator(dev).manual_seed(SEED + 51),
                                 dev)
    wide_errs.update(wide_segsum_checks(dev, graph, skewed))
    print(json.dumps({"wide_max_abs_err": wide_errs}), flush=True)
    for key in ("A", "B", "C", "D", "E", "F", "G", "I"):
        errs[key] = max(errs[key], wide_errs[key])
    # kernel A's count spans the ops path, the zoo's runs and 13a's epoch;
    # C's and D-G's also 13b's calls at 10M keys
    launches["csr_gather_scale_segsum"] = launches.get(
        "csr_gather_scale_segsum", 0) + zoo_a + a_13
    # phase 14's launches, summed over its ranks, and phase 15b's
    for more in (ivf_launches, md_launches, wide_launches):
        for name, n in more.items():
            launches[name] = launches.get(name, 0) + n
    family = phase_wide_timing(dev, graph, wide_errs, wide_launches)
    print(json.dumps({"phase_15bcd_s": time.perf_counter() - t15}),
          flush=True)
    kernels = phase_timing(dev, graph, errs, launches, probes, skewed)
    kernels += family
    phase_step_timing(dev, trained)
    if len(kernels) != 14 or any(k["launches"] <= 0 for k in kernels):
        fail(f"kernels line: {[(k['name'], k['launches']) for k in kernels]}")

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
