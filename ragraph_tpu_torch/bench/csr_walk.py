"""Kernels A and K on a uniform and on a skewed graph, by device time.

    python -m ragraph_tpu_torch.bench.csr_walk [--device cpu --small]

Two graphs of N = 262,144 rows and E = 2^21 edges, D = 64, from a numpy
seed:

- ``uniform``: the main path's graph (U = I = 131,072 users and items, 2^20
  random interactions in both directions, ``bench.main_path.make_rows``)
  with the main path's edge weights;
- ``skewed``: receivers and senders drawn independently, each with
  probability proportional to ``(rank + 1) ** -0.8`` over randomly permuted
  ids (:func:`skewed_graph`). The largest row holds about 37,000 edges;
  most rows hold one to ten edges and a fifth none. The exponent is an
  assumption, not a dataset's measured statistic: it gives hub rows of
  tens of thousands of edges, as a popular item of a recommendation graph
  has. ``skewed_0.6`` and ``skewed_1.0`` draw the same way with the
  exponents 0.6 (largest row about 5,700 edges) and 1.0 (about 160,000),
  so that a reading does not rest on one exponent.

On each: kernel A's forward as the main path calls it (an f32 table,
``gather_scale_segsum``, bf16) and as its parts (the f32 to bf16 cast, the
kernel on the bf16 table), its backward (the same kernel on the
sender-order arrays, as ``_GatherScaleSegsum.backward`` calls it), kernel K
with the parity split on the same edges, and ``torch.sparse.mm`` on a CSR
of the same weights beside each. Then, on the main path's graph, a
pretrain and a finetune step (``bench.main_path.step_timings``) and a warm
``generate``.

Each kernel time is the device's alone (``timing.device_ms``), with the
graph's walk plans handed in as the model hands them; the loop of calls,
host included, is given beside A's.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ragraph_tpu_torch import native
from ragraph_tpu_torch.bench import main_path, timing
from ragraph_tpu_torch.data.edgelist import load_edge_dataset
from ragraph_tpu_torch.device import resolve_device
from ragraph_tpu_torch.models.edge import (EdgeGraphArrays, EdgeModelConfig,
                                           RAGraphEdge)
from ragraph_tpu_torch.ops import csr_segment as cs
from ragraph_tpu_torch.ops import probes
from ragraph_tpu_torch.ops.csr_segment import HUB_EDGES

N, E, D = 1 << 18, 1 << 21, 64
SMALL = (1024, 8192, 16)
ALPHA = 0.8
OTHER_ALPHAS = (0.6, 1.0)


def skewed_graph(rng: np.random.Generator, n: int = N, e: int = E,
                 alpha: float = ALPHA) -> dict:
    """A receiver-sorted CSR graph of ``n`` rows and ``e`` edges whose
    receivers and senders are drawn independently with probability
    proportional to ``(rank + 1) ** -alpha``, ranks mapped to ids by a
    random permutation, with uniform weights in [0, 1): numpy arrays
    ``senders``, ``recv_indptr``, ``w`` in receiver order and
    ``recv_of_send``, ``send_indptr``, ``w_send`` in sender order."""
    p = np.arange(1, n + 1, dtype=np.float64) ** -alpha
    p /= p.sum()
    recv = rng.permutation(n)[rng.choice(n, e, p=p)]
    send = rng.permutation(n)[rng.choice(n, e, p=p)]
    order = np.argsort(recv, kind="stable")
    recv, send = recv[order], send[order].astype(np.int32)
    w = rng.random(e).astype(np.float32)
    perm = np.argsort(send, kind="stable")

    def indptr(ids):
        return np.concatenate([[0], np.cumsum(np.bincount(ids, minlength=n))
                               ]).astype(np.int32)

    return {"senders": send, "recv_indptr": indptr(recv), "w": w,
            "recv_of_send": recv[perm].astype(np.int32),
            "send_indptr": indptr(send), "w_send": w[perm]}


def uniform_graph(rng: np.random.Generator, device,
                  small: bool = False) -> dict:
    """The main path's graph and edge weights as :func:`skewed_graph`'s
    arrays, on ``device``."""
    n = SMALL[0] // 2 if small else main_path.U
    train, test = main_path.make_rows(rng, n, n, SMALL[1] // 2 if small
                                      else main_path.M)
    g = EdgeGraphArrays.from_dataset(
        load_edge_dataset(train, test, num_users=n, num_items=n), device)
    return {"senders": g.senders, "recv_indptr": g.recv_indptr,
            "w": g.edge_norm * 0.5 + g.time_norm * 0.5,
            "recv_of_send": g.recv_of_send, "send_indptr": g.send_indptr,
            "w_send": g.edge_norm_send * 0.5 + g.time_norm_send * 0.5}


def degree_summary(indptr: torch.Tensor) -> dict:
    """Row lengths of a CSR, and its rows of more than ``HUB_EDGES`` edges,
    which kernels A and K cut into pieces."""
    lens = (indptr[1:] - indptr[:-1]).long()
    return {"rows": int(lens.numel()), "edges": int(lens.sum()),
            "largest_row": int(lens.max()),
            "empty_rows": int((lens == 0).sum()),
            "long_rows": int((lens > HUB_EDGES).sum()),
            "edges_in_long_rows": int(lens[lens > HUB_EDGES].sum())}


def csr_library(indptr, cols, vals, n_cols):
    """``torch.sparse.mm``'s operand: a CSR matrix of the given rows."""
    with warnings.catch_warnings():    # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(indptr.long(), cols.long(), vals,
                                       size=(len(indptr) - 1, n_cols))


def time_graph(g: dict, d: int, gen: torch.Generator, device) -> dict:
    """Kernels A and K and their library calls on one graph's arrays."""
    cuda = timing.is_cuda(device)

    def t(fn, reps=20):
        return timing.device_ms(fn, reps) if cuda else timing.timed_ms(
            fn, 2, 1, device)

    n = len(g["recv_indptr"]) - 1
    table = torch.randn(n, d, generator=gen, device=device)
    ct = torch.randn(n, d, generator=gen, device=device)
    tb = table.to(torch.bfloat16)
    rp, sp = cs.walk_plan(g["recv_indptr"]), cs.walk_plan(g["send_indptr"])
    args = (g["w"], g["w_send"], g["senders"], g["recv_indptr"],
            g["recv_of_send"], g["send_indptr"])
    fwd = (g["w"], g["senders"], g["recv_indptr"], True, rp)
    bwd = (g["w_send"], g["recv_of_send"], g["send_indptr"], True, sp)
    par = (g["senders"] & 1).float()
    k_args = (probes.pack_table(table), g["w"] * (1 - par), g["w"] * par,
              (g["senders"] >> 1).contiguous(), g["recv_indptr"], rp)
    a = cs._csr_gather_scale(table, *fwd)
    k = probes.packed_table_segsum(*k_args)
    plain = cs.gather_scale_segsum_plain(table, *fwd[:4])

    def layer():
        return cs.gather_scale_segsum(table, *args, bf16=True, recv_plan=rp,
                                      send_plan=sp)

    out = {
        "A_forward_layer": t(layer),
        "A_forward_layer_loop": timing.timed_ms(layer, device=device),
        "A_forward": t(lambda: cs._csr_gather_scale(table, *fwd)),
        "A_cast_f32_to_bf16": t(lambda: table.to(torch.bfloat16)),
        "A_forward_bf16_table": t(lambda: cs._csr_gather_scale(tb, *fwd)),
        "A_backward": t(lambda: cs._csr_gather_scale(ct, *bwd)),
        "A_backward_bf16_cotangent": t(lambda: cs._csr_gather_scale(
            ct.to(torch.bfloat16), *bwd)),
        "K": t(lambda: probes.packed_table_segsum(*k_args)),
        "A_max_abs_err_to_plain": float((a - plain).abs().max()),
        "K_equals_A": bool(torch.equal(a, k)),
        "A_repeat_equal": bool(torch.equal(
            a, cs._csr_gather_scale(table, *fwd))),
    }
    del a, k, plain
    # the library: A's forward and K as one CSR product each, on the
    # bf16-rounded rows and weights
    a_csr = csr_library(g["recv_indptr"], g["senders"],
                        g["w"].to(torch.bfloat16).float(), n)
    tf = tb.float()
    out["A_forward_library_sparse_mm"] = t(lambda: torch.sparse.mm(a_csr, tf),
                                           5)
    del a_csr
    b_csr = csr_library(g["send_indptr"], g["recv_of_send"],
                        g["w_send"].to(torch.bfloat16).float(), n)
    cf = ct.to(torch.bfloat16).float()
    out["A_backward_library_sparse_mm"] = t(lambda: torch.sparse.mm(b_csr,
                                                                    cf), 5)
    del b_csr
    return out


def step_and_generate(device, small: bool, seed: int) -> dict:
    """The main path's pretrain and finetune steps and a warm ``generate``."""
    ft_model, ft_params, model, params, batch = main_path.build(device, small,
                                                                seed)
    gen = torch.Generator(device).manual_seed(seed + 3)
    reps = (2, 1, 1, 1) if small else (10, 3, 5, 2)
    out = main_path.step_timings(ft_model, ft_params, model, params, batch,
                                 gen, device, reps)
    serve = RAGraphEdge(EdgeModelConfig(emb_size=main_path.D, num_layers=3),
                        model.graph, phase="vanilla")
    out["generate_warm_ms"] = timing.timed_ms(lambda: serve.generate(params),
                                              reps=5, device=device)
    return out


def run(device, small: bool = False, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device).manual_seed(seed + 1)
    d = SMALL[2] if small else D
    size = SMALL[:2] if small else (N, E)

    def skewed(alpha):
        return {k: torch.from_numpy(v).to(device)
                for k, v in skewed_graph(rng, *size, alpha).items()}

    graphs = [("uniform", lambda: uniform_graph(rng, device, small)),
              ("skewed", lambda: skewed(ALPHA))]
    graphs += [(f"skewed_{a}", lambda a=a: skewed(a)) for a in OTHER_ALPHAS]
    native.reset_launches()
    degrees, times = {}, {}
    for name, make in graphs:
        g = make()
        degrees[name] = {"receivers": degree_summary(g["recv_indptr"]),
                         "senders": degree_summary(g["send_indptr"])}
        times[name] = time_graph(g, d, gen, device)
        print(name, degrees[name], times[name], flush=True)
        del g
    if timing.is_cuda(device):
        torch.cuda.empty_cache()
    times["main_path"] = step_and_generate(device, small, seed)
    return {"bench": "csr_walk", "N": 2 * (SMALL[0] // 2 if small
                                            else main_path.U),
            "E": SMALL[1] if small else E, "D": d, "degrees": degrees,
            "device": timing.device_record(device),
            timing.times_key(device): times,
            "launches": dict(native.LAUNCHES)}


def main(argv=None) -> dict:
    args = timing.bench_parser(__doc__.splitlines()[0]).parse_args(argv)
    device = resolve_device(args.device or "cuda")
    return timing.emit(run(device, args.small, args.seed), args.out)


if __name__ == "__main__":
    main()
