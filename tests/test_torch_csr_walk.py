"""Kernels A's and K's shared row walk on graphs with hub rows: the walk
plan, the port's ``gather_scale_segsum`` against the JAX kernel in
interpret mode, and kernel K's plain version against kernel A's.

On the CPU the wrappers run their plain versions; the CUDA walk
(``csrc/rg_csr.cuh``) follows :func:`walk_plan` on the card, where
``chip_smoke.py`` holds it against the plain versions.

Tolerance against JAX: the JAX kernel sums each segment as a difference of
two prefix sums over all edges, which carries about 1e-3 relative error on
long segments (``ragraph_tpu/ops/pallas_segment.py:145-148``), against the
size of the prefix; here 1e-3 of the largest output. Port against port: 0.
"""

import _torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragraph_tpu.ops import pallas_segment as jseg
from ragraph_tpu_torch.bench.csr_walk import skewed_graph
from ragraph_tpu_torch.data.edgelist import load_edge_dataset
from ragraph_tpu_torch.models.edge import EdgeGraphArrays, lightgcn_propagate
from ragraph_tpu_torch.ops import csr_segment as tcs
from ragraph_tpu_torch.ops import probes

JAX_REL = 1e-3


def _indptr(lengths):
    return torch.tensor(np.concatenate([[0], np.cumsum(lengths)]),
                        dtype=torch.int32)


def _walk_order(indptr, plan):
    """The edges each row's walk visits, in order: a short row its own
    range, a long row its pieces one after another."""
    ip = indptr.tolist()
    longs = {r: i for i, r in enumerate(plan.long_rows.tolist())}
    ptr, pieces = plan.piece_ptr.tolist(), plan.pieces.tolist()
    order = []
    for r in range(len(ip) - 1):
        if r in longs:
            i = longs[r]
            order.append([e for b, end in pieces[ptr[i]:ptr[i + 1]]
                          for e in range(b, end)])
        else:
            order.append(list(range(ip[r], ip[r + 1])))
    return order


HUB = tcs.HUB_EDGES
PLAN_CASES = {
    "thresholds": [0, HUB - 1, HUB, HUB + 1, 2 * HUB, 2 * HUB + 1, 0, 1,
                   3 * HUB + 1],
    "all_short": [2, 0, HUB, 1],
    "hubs_first_and_last": [3 * HUB, 5, HUB + 2],
    "one_hub": [0, 8 * HUB + 3, 0],
    "empty": [0, 0, 0],
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES) + ["skewed"])
def test_walk_plan_covers_every_edge_once_in_order(case):
    """Every edge of every row exactly once, in edge order; pieces of
    ``HUB_EDGES`` edges but a row's last; long rows ascending and exactly
    those of more than ``HUB_EDGES`` edges."""
    if case == "skewed":
        indptr = torch.from_numpy(skewed_graph(np.random.default_rng(3), 600,
                                               9000)["recv_indptr"])
    else:
        indptr = _indptr(PLAN_CASES[case])
    plan = tcs.walk_plan(indptr)
    ip = indptr.long()
    lens = (ip[1:] - ip[:-1]).tolist()
    assert plan.long_rows.dtype == plan.piece_ptr.dtype == torch.int32
    assert plan.pieces.dtype == torch.int32 and plan.pieces.shape[1] == 2
    assert plan.long_rows.tolist() == [r for r, n in enumerate(lens)
                                       if n > HUB]
    assert plan.piece_ptr[0] == 0 and plan.piece_ptr[-1] == len(plan.pieces)
    for b, e in plan.pieces.tolist():
        assert 0 < e - b <= HUB
    order = _walk_order(indptr, plan)
    for r, edges in enumerate(order):
        assert edges == list(range(int(ip[r]), int(ip[r + 1]))), r
        if lens[r] > HUB:
            i = plan.long_rows.tolist().index(r)
            sizes = [e - b for b, e in plan.pieces.tolist()[
                plan.piece_ptr[i]:plan.piece_ptr[i + 1]]]
            assert sizes[:-1] == [HUB] * (len(sizes) - 1)
    assert sum(map(len, order)) == int(ip[-1])


def _same_plan(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_walk_plan_of_an_inference_tensor():
    """An indptr made under ``torch.inference_mode`` (as a server builds
    its graph) is planned inside and outside the mode alike."""
    lengths = [3, 2 * HUB + 5, 0, 7, HUB + 1]
    with torch.inference_mode():
        indptr = _indptr(lengths)
        inside = tcs.walk_plan(indptr)
    assert indptr.is_inference()
    want = tcs.walk_plan(_indptr(lengths))
    assert _same_plan(inside, want) and _same_plan(tcs.walk_plan(indptr),
                                                   want)
    assert inside.long_rows.tolist() == [1, 4]


def _hub_graph(n_users=300, n_items=40, seed=5):
    """Every user bought item 0 (a hub row of ``n_users`` edges on the
    item side), plus random rows."""
    rng = np.random.default_rng(seed)
    t0 = 1_600_000_000
    train = [(u, 0, t0 + u) for u in range(n_users)]
    train += [(int(u), int(i), t0 + k) for k, (u, i) in enumerate(zip(
        rng.integers(0, n_users, 600), rng.integers(1, n_items, 600)))]
    test = [(u, int(rng.integers(0, n_items))) for u in range(n_users)]
    return EdgeGraphArrays.from_dataset(load_edge_dataset(
        train, test, num_users=n_users, num_items=n_items), "cpu")


def test_edge_graph_arrays_carry_both_walk_plans():
    """The graph is planned once, where its CSR is built: ``recv_plan`` of
    ``recv_indptr``, ``send_plan`` of ``send_indptr``; ``to`` keeps them."""
    g = _hub_graph()
    assert _same_plan(g.recv_plan, tcs.walk_plan(g.recv_indptr))
    assert _same_plan(g.send_plan, tcs.walk_plan(g.send_indptr))
    hub = g.num_users          # item 0's node
    assert g.recv_plan.long_rows.tolist() == [hub]
    assert g.send_plan.long_rows.tolist() == [hub]
    moved = g.to("cpu")
    assert _same_plan(moved.recv_plan, g.recv_plan)
    assert _same_plan(moved.send_plan, g.send_plan)


def test_propagation_hands_the_graphs_plans_to_kernel_a(monkeypatch):
    """The fused propagation passes the graph's receiver plan to every
    forward launch and its sender plan to every backward launch, and makes
    no plan of its own; a call that runs no backward touches the sender
    plan not at all."""
    g = _hub_graph()
    seen = []

    def launch(table, w, idx, indptr, bf16, plan=None):
        seen.append((indptr, plan))
        return tcs.gather_scale_segsum_plain(table, w, idx, indptr, bf16)

    def no_plan(indptr):
        raise AssertionError("a plan made per call")

    monkeypatch.setattr(tcs, "_csr_gather_scale", launch)
    monkeypatch.setattr(tcs, "walk_plan", no_plan)
    emb = torch.randn(g.num_nodes, 8, generator=torch.Generator()
                      .manual_seed(0), requires_grad=True)

    def layers():
        return lightgcn_propagate(
            emb, g.senders, g.receivers, g.edge_norm, g.num_nodes, 2,
            recv_indptr=g.recv_indptr, impl="fused",
            weights_send=g.edge_norm_send, recv_of_send=g.recv_of_send,
            send_indptr=g.send_indptr, recv_plan=g.recv_plan,
            send_plan=g.send_plan)

    with torch.no_grad():
        layers()
    want = [(g.recv_indptr, g.recv_plan)] * 2
    assert len(seen) == 2 and all(
        i is wi and p is wp for (i, p), (wi, wp) in zip(seen, want))
    seen.clear()
    layers()[-1].sum().backward()
    want += [(g.send_indptr, g.send_plan)] * 2
    assert len(seen) == 4 and all(
        i is wi and p is wp for (i, p), (wi, wp) in zip(seen, want))


def _skewed(seed, n, e, d):
    """A small graph with hub rows of a few thousand edges on both sides
    (exponent 1.2 at this size, 0.8 at the card's), a table and a
    cotangent."""
    g = skewed_graph(np.random.default_rng(seed), n, e, alpha=1.2)
    rng = np.random.default_rng(seed + 1)
    g["emb"] = rng.normal(size=(n, d)).astype(np.float32)
    g["ct"] = rng.normal(size=(n, d)).astype(np.float32)
    return g


@pytest.mark.parametrize("bf16", [True, False])
def test_gather_scale_segsum_matches_jax_on_hub_rows(bf16):
    g = _skewed(11, 512, 16384, 8)
    assert min(np.diff(g["recv_indptr"]).max(),
               np.diff(g["send_indptr"]).max()) > 2000
    keys = ("w", "w_send", "senders", "recv_indptr", "recv_of_send",
            "send_indptr")

    def f(e):
        return jseg.gather_scale_segsum(
            e, *(jnp.asarray(g[k]) for k in keys), block=128, bf16=bf16,
            interpret=True)

    want, vjp = jax.vjp(f, jnp.asarray(g["emb"]))
    (want_grad,) = vjp(jnp.asarray(g["ct"]))
    emb = torch.from_numpy(g["emb"]).requires_grad_(True)
    got = tcs.gather_scale_segsum(emb, *(torch.from_numpy(g[k])
                                         for k in keys), bf16=bf16)
    got.backward(torch.from_numpy(g["ct"]))
    for name, a, b in (("forward", got.detach().numpy(), np.asarray(want)),
                       ("backward", emb.grad.numpy(), np.asarray(want_grad))):
        err = np.abs(a - b).max()
        assert err <= JAX_REL * np.abs(b).max(), (name, err)
    empty = np.diff(g["recv_indptr"]) == 0
    assert empty.any() and np.all(got.detach().numpy()[empty] == 0)


@pytest.mark.parametrize("d", [2, 18, 64])
def test_packed_table_segsum_plain_is_kernel_a_plain_on_hub_rows(d):
    """With the parity split, K's plain version is A's on a skewed graph,
    to the bit (a zero weight adds nothing)."""
    g = _skewed(21, 512, 8192, d)
    table = torch.from_numpy(g["emb"])
    send = torch.from_numpy(g["senders"])
    w = torch.from_numpy(g["w"])
    indptr = torch.from_numpy(g["recv_indptr"])
    par = (send & 1).float()
    got = probes.packed_table_segsum_plain(probes.pack_table(table),
                                           w * (1 - par), w * par,
                                           send >> 1, indptr)
    assert torch.equal(got, tcs.gather_scale_segsum_plain(table, w, send,
                                                          indptr, True))
