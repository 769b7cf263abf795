"""The node pipeline's modules below the library, port against JAX package:
graph containers and batching, the synthetic and TU datasets, the GCN
layers with the masked batch norm, the decoder, both propagations, dense
PageRank, shortest paths and position codes, and the augmentations.

Inputs come from a numpy seed. Where the JAX function draws, the test
repeats the draw with the same key and hands the values to the port.

Tolerances: everything is f32 on both sides with sums of at most a few
hundred terms taken in another order, 1e-5 absolute on values of order 1
(2e-5 after several matmuls in a row). Datasets and integer results are
held bit for bit.
"""

import dataclasses
import os

import _torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragraph_tpu.core import graph as jgraph
from ragraph_tpu.data import batching as jbatch
from ragraph_tpu.data import synthetic as jsyn
from ragraph_tpu.data import tu as jtu
from ragraph_tpu.nn.heads import TaskDecoder as JTaskDecoder
from ragraph_tpu.nn.layers import DenseGCN as JDenseGCN
from ragraph_tpu.nn.layers import avg_readout as j_avg_readout
from ragraph_tpu.nn.stack import GCNStack as JGCNStack
from ragraph_tpu.nn.stack import MaskedBatchNorm as JMaskedBatchNorm
from ragraph_tpu.ops import pagerank as jpr
from ragraph_tpu.ops import propagation as jprop
from ragraph_tpu.ops import shortest_path as jsp
from ragraph_tpu.rag import augmentation as jaug
from ragraph_tpu_torch.convert import (decoder_params_from_jax,
                                       preprompt_params_from_jax)
from ragraph_tpu_torch.core import graph as tgraph
from ragraph_tpu_torch.data import batching as tbatch
from ragraph_tpu_torch.data import synthetic as tsyn
from ragraph_tpu_torch.data import tu as ttu
from ragraph_tpu_torch.nn.heads import TaskDecoder
from ragraph_tpu_torch.nn.layers import DenseGCN, PReLU, avg_readout
from ragraph_tpu_torch.nn.stack import GCNStack, MaskedBatchNorm
from ragraph_tpu_torch.ops import pagerank as tpr
from ragraph_tpu_torch.ops import propagation as tprop
from ragraph_tpu_torch.ops import shortest_path as tsp
from ragraph_tpu_torch.rag import augmentation as taug

ATOL = 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _graph(seed, n=12, n_real=9, p=0.3, feat=5):
    """A padded random graph: raw symmetric adjacency, mask, features."""
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((n, n)) < p, k=1)
    adj = (upper | upper.T).astype(np.float32)
    mask = np.arange(n) < n_real
    adj *= mask[:, None] * mask[None, :]
    x = rng.normal(size=(n, feat)).astype(np.float32) * mask[:, None]
    return adj, mask, x


# ---- containers and batching -------------------------------------------------

@pytest.mark.parametrize("self_loops", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_normalize_adj_dense(seed, self_loops):
    adj, mask, _ = _graph(seed)
    want = jgraph.normalize_adj_dense(jnp.asarray(adj), jnp.asarray(mask),
                                      add_self_loops=self_loops)
    got = tgraph.normalize_adj_dense(_t(adj), _t(mask), self_loops)
    _close(got, want, 1e-6)
    assert bool((got[~_t(mask)] == 0).all())
    # no mask, and a batch of two equals the two one by one
    _close(tgraph.normalize_adj_dense(_t(adj)),
           jgraph.normalize_adj_dense(jnp.asarray(adj)), 1e-6)
    adj2, mask2, _ = _graph(seed + 10)
    both = tgraph.normalize_adj_dense(torch.stack([_t(adj), _t(adj2)]),
                                      torch.stack([_t(mask), _t(mask2)]),
                                      self_loops)
    assert torch.equal(both[0], got)


def test_row_normalize_and_segment_mean():
    adj, mask, x = _graph(3)
    _close(tgraph.row_normalize_adj(_t(adj)),
           jgraph.row_normalize_adj(jnp.asarray(adj)), 1e-6)
    ids = np.array([0, 0, 1, 3, 3, 3, 1, 0, 2, 4, 4, 4], np.int32)
    for m in (None, mask):
        want = jgraph.segment_mean(jnp.asarray(x), jnp.asarray(ids), 5,
                                   None if m is None else jnp.asarray(m))
        got = tgraph.segment_mean(_t(x), _t(ids), 5,
                                  None if m is None else _t(m))
        _close(got, want, 1e-6)
    assert tgraph.round_up(130, 128) == jgraph.round_up(130, 128) == 256


@pytest.mark.parametrize("kwargs", [
    dict(), dict(num_graphs=7, min_nodes=3, max_nodes=9, num_classes=4,
                 feat_dim=6, signal=0.6, p_in=0.35, p_out=0.15,
                 name="SYNTH-HARD")])
def test_synthetic_tu_dataset_bit_equal(kwargs):
    want = jsyn.synthetic_tu_dataset(seed=5, **kwargs)
    got = tsyn.synthetic_tu_dataset(seed=5, **kwargs)
    assert len(got) == len(want) and got.name == want.name
    assert (got.num_node_attributes, got.num_node_classes,
            got.num_graph_classes) == (want.num_node_attributes,
                                       want.num_node_classes,
                                       want.num_graph_classes)
    for g, w in zip(got.graphs, want.graphs):
        np.testing.assert_array_equal(g.features, w.features)
        np.testing.assert_array_equal(g.adj, w.adj)
        np.testing.assert_array_equal(g.node_labels, w.node_labels)
        assert g.graph_label == w.graph_label
    # shuffle and subset: the same graphs in the same order
    gs = got.shuffle(np.random.default_rng(1)).subset(.5, .8)
    ws = want.shuffle(np.random.default_rng(1)).subset(.5, .8)
    assert len(gs) == len(ws)
    for g, w in zip(gs.graphs, ws.graphs):
        np.testing.assert_array_equal(g.features, w.features)


def test_planted_partition_graph_bit_equal():
    a = tsyn.planted_partition_graph(np.random.default_rng(2), 11, 3, 4)
    b = jsyn.planted_partition_graph(np.random.default_rng(2), 11, 3, 4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _write_tu(root, name, ds, attrs=True, labels=True):
    base = os.path.join(root, name)
    os.makedirs(base)
    off, edges, ind = 0, [], []
    for gid, g in enumerate(ds.graphs):
        r, c = np.nonzero(g.adj)
        edges.append(np.stack([r, c], 1) + off + 1)
        ind.append(np.full(len(g.adj), gid + 1))
        off += len(g.adj)
    pre = os.path.join(base, name)
    np.savetxt(pre + "_A.txt", np.concatenate(edges), fmt="%d",
               delimiter=", ")
    np.savetxt(pre + "_graph_indicator.txt", np.concatenate(ind), fmt="%d")
    np.savetxt(pre + "_graph_labels.txt",
               [g.graph_label + 1 for g in ds.graphs], fmt="%d")
    if labels:
        np.savetxt(pre + "_node_labels.txt", np.concatenate(
            [g.node_labels.argmax(1) for g in ds.graphs]), fmt="%d")
    if attrs:
        np.savetxt(pre + "_node_attributes.txt", np.concatenate(
            [g.features for g in ds.graphs]), fmt="%.9g", delimiter=", ")


@pytest.mark.parametrize("attrs,labels", [(True, True), (False, True),
                                          (True, False)])
def test_load_tu_dataset(tmp_path, attrs, labels):
    """A tiny dataset written by the test in the raw TU text format: both
    loaders read the same graphs, and they are the graphs written."""
    ds = tsyn.synthetic_tu_dataset(seed=1, num_graphs=5, min_nodes=3,
                                   max_nodes=6, feat_dim=3, name="TINY")
    _write_tu(str(tmp_path), "TINY", ds, attrs, labels)
    got = ttu.load_tu_dataset(str(tmp_path), "TINY")
    want = jtu.load_tu_dataset(str(tmp_path), "TINY")
    assert len(got) == len(want) == 5
    assert (got.num_node_attributes, got.num_node_classes,
            got.num_graph_classes) == (want.num_node_attributes,
                                       want.num_node_classes,
                                       want.num_graph_classes)
    for g, w, src in zip(got.graphs, want.graphs, ds.graphs):
        np.testing.assert_array_equal(g.features, w.features)
        np.testing.assert_array_equal(g.adj, w.adj)
        np.testing.assert_array_equal(g.node_labels, w.node_labels)
        assert g.graph_label == w.graph_label
        np.testing.assert_array_equal(g.adj, src.adj)
        if attrs:
            np.testing.assert_allclose(g.features, src.features, rtol=1e-7)


def _same_dense_graph(got, want, atol=1e-6):
    for f in dataclasses.fields(tgraph.DenseGraph):
        _close(getattr(got, f.name), getattr(want, f.name), atol)
        assert tuple(getattr(got, f.name).shape) == \
            tuple(getattr(want, f.name).shape), f.name


def test_dense_batch_from_graphs_and_flat_batches():
    ds = tsyn.synthetic_tu_dataset(seed=2, num_graphs=7)
    gs = ds.graphs
    args = ([g.features for g in gs[:3]], [g.adj for g in gs[:3]],
            [g.node_labels for g in gs[:3]])
    want, want_adj = jgraph.dense_batch_from_graphs(
        *args, pad_nodes=80, num_classes=4, return_host_adj=True)
    got, got_adj = tgraph.dense_batch_from_graphs(
        *args, pad_nodes=80, num_classes=4, return_host_adj=True)
    _same_dense_graph(got, want)
    np.testing.assert_array_equal(got_adj, want_adj)
    assert got.graph_ids.dtype == torch.int32
    assert got.node_mask.dtype == torch.bool
    assert (got.num_nodes_padded, got.feature_dim, got.num_classes) \
        == (80, 16, 4)
    with pytest.raises(ValueError):
        tgraph.dense_batch_from_graphs(*args, pad_nodes=8)
    assert tbatch.compute_pad_nodes(gs, 3) == jbatch.compute_pad_nodes(gs, 3)
    assert tbatch.compute_pad_nodes(gs, 3, align=8) \
        == jbatch.compute_pad_nodes(gs, 3, align=8)
    for pad in (None, 96):
        wants = list(jbatch.flat_batches(gs, 3, pad, num_classes=3))
        gots = list(tbatch.flat_batches(gs, 3, pad, num_classes=3))
        assert len(gots) == len(wants) == 3
        for g, w in zip(gots, wants):
            _same_dense_graph(g, w)
    g, raw = next(tbatch.flat_batches(gs, 3, with_host_adj=True))
    assert isinstance(raw, np.ndarray) and raw.shape == (128, 128)


def test_stacked_batches():
    ds = tsyn.synthetic_tu_dataset(seed=3, num_graphs=7)
    for kw in (dict(), dict(pad_nodes=32, num_classes=4,
                            num_graph_classes=5)):
        wants = list(jbatch.stacked_batches(ds.graphs, 3, **kw))
        gots = list(tbatch.stacked_batches(ds.graphs, 3, **kw))
        assert len(gots) == len(wants) == 3
        for g, w in zip(gots, wants):
            assert sorted(g) == sorted(w)
            for k in w:
                _close(g[k], w[k], 1e-6)
                assert tuple(g[k].shape) == tuple(w[k].shape)
        # the last batch is padded with empty graphs
        assert not bool(gots[-1]["node_mask"][1:].any())


# ---- layers -------------------------------------------------------------------

@pytest.mark.parametrize("act", ["prelu", "relu", "none"])
@pytest.mark.parametrize("use_bias", [True, False])
def test_dense_gcn(act, use_bias):
    adj, mask, x = _graph(4)
    adj_n = np.asarray(jgraph.normalize_adj_dense(jnp.asarray(adj),
                                                  jnp.asarray(mask)))
    layer = JDenseGCN(7, use_bias=use_bias, act=act)
    variables = layer.init(jax.random.key(0), jnp.asarray(x),
                           jnp.asarray(adj_n), jnp.asarray(mask))
    p = jax.tree_util.tree_map(np.asarray, variables["params"])
    if use_bias:    # a bias that is not zero
        p["bias"] = np.linspace(-1, 1, 7).astype(np.float32)
    if act == "prelu":
        p["PReLU_0"]["slope"] = np.float32(0.1)
    want = layer.apply({"params": p}, jnp.asarray(x), jnp.asarray(adj_n),
                       jnp.asarray(mask))
    port = DenseGCN(5, 7, use_bias=use_bias, act=act)
    state = {"lin.weight": _t(p["Dense_0"]["kernel"]).T.contiguous()}
    if use_bias:
        state["bias"] = _t(p["bias"])
    if act == "prelu":
        state["act.slope"] = torch.tensor(0.1)
    port.load_state_dict(state)
    got = port(_t(x), _t(adj_n), _t(mask)).detach()
    _close(got, want)
    assert bool((got[~_t(mask)] == 0).all())    # the mask comes last
    _close(port(_t(x), _t(adj_n)).detach(),
           layer.apply({"params": p}, jnp.asarray(x), jnp.asarray(adj_n)))


def test_prelu_and_readout():
    act = PReLU()
    assert float(act.slope.detach()) == 0.25 and act.slope.dim() == 0
    x = torch.tensor([[-2.0, 3.0], [0.0, -1.0]])
    assert torch.equal(act(x).detach(),
                       torch.tensor([[-0.5, 3.0], [0.0, -0.25]]))
    _, mask, feats = _graph(5)
    _close(avg_readout(_t(feats), _t(mask)),
           j_avg_readout(jnp.asarray(feats), jnp.asarray(mask)), 1e-6)
    _close(avg_readout(_t(feats)), j_avg_readout(jnp.asarray(feats)), 1e-6)


@pytest.mark.parametrize("masked", [True, False])
def test_masked_batch_norm_training_and_running(masked):
    """Two training passes update the running statistics as the JAX module
    does (unbiased variance, momentum 0.1); a pass on the running values
    then agrees too."""
    rng = np.random.default_rng(6)
    xs = [rng.normal(2.0, 3.0, size=(10, 4)).astype(np.float32)
          for _ in range(3)]
    mask = np.arange(10) < 7 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    bn = JMaskedBatchNorm(4)
    variables = bn.init(jax.random.key(0), jnp.asarray(xs[0]), jm)
    params = {"scale": jnp.asarray([1.0, 2.0, 0.5, 1.5]),
              "bias": jnp.asarray([0.0, 1.0, -1.0, 0.3])}
    stats = variables["batch_stats"]
    port = MaskedBatchNorm(4)
    port.load_state_dict({"scale": _t(np.asarray(params["scale"])),
                          "bias": _t(np.asarray(params["bias"])),
                          "mean": torch.zeros(4), "var": torch.ones(4)})
    for x in xs[:2]:
        want, upd = bn.apply({"params": params, "batch_stats": stats},
                             jnp.asarray(x), jm, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        _close(port(_t(x), tm).detach(), want)
    _close(port.mean, stats["mean"], 1e-6)
    _close(port.var, stats["var"], 1e-5)
    want = bn.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(xs[2]), jm, use_running_average=True)
    before = port.mean.clone()
    _close(port(_t(xs[2]), tm, use_running_average=True).detach(), want)
    assert torch.equal(port.mean, before)


def _stack_pair(num_layers, hidden=6, feat=5, dropout=0.0):
    adj, mask, x = _graph(7, feat=feat)
    adj_n = np.asarray(jgraph.normalize_adj_dense(jnp.asarray(adj),
                                                  jnp.asarray(mask)))
    jstack = JGCNStack(hidden, num_layers, dropout=dropout)
    variables = jstack.init({"params": jax.random.key(1),
                             "dropout": jax.random.key(2)}, jnp.asarray(x),
                            jnp.asarray(adj_n), jnp.asarray(mask), lp=True,
                            deterministic=False)
    host = jax.tree_util.tree_map(np.asarray, dict(variables))
    state = preprompt_params_from_jax(
        {"params": {"gcn": host["params"]},
         "batch_stats": {"gcn": host["batch_stats"]}})
    port = GCNStack(feat, hidden, num_layers, dropout=dropout)
    port.load_state_dict({k[len("gcn."):]: v for k, v in state.items()})
    return jstack, variables, port, x, adj_n, mask


@pytest.mark.parametrize("num_layers", [1, 3])
def test_gcn_stack_inference_split_and_lp(num_layers):
    jstack, variables, port, x, adj_n, mask = _stack_pair(num_layers)
    ja = (jnp.asarray(x), jnp.asarray(adj_n), jnp.asarray(mask))
    ta = (_t(x), _t(adj_n), _t(mask))
    _close(port(*ta).detach(), jstack.apply(variables, *ja))
    # LP mode on the running statistics
    _close(port(*ta, lp=True, deterministic=True).detach(),
           jstack.apply(variables, *ja, lp=True, deterministic=True))
    # LP training mode (dropout 0): batch statistics, running values move
    want, upd = jstack.apply(variables, *ja, lp=True, deterministic=False,
                             mutable=["batch_stats"],
                             rngs={"dropout": jax.random.key(3)})
    _close(port(*ta, lp=True, deterministic=False).detach(), want, 2e-5)
    for i in range(num_layers):
        _close(port.bns[i].mean, upd["batch_stats"][f"bn_{i}"]["mean"], 1e-6)
        _close(port.bns[i].var, upd["batch_stats"][f"bn_{i}"]["var"], 1e-5)
    if num_layers > 1:      # the fewshot encode / decode split
        first = port(*ta, stop_at=1)
        _close(first.detach(), jstack.apply(variables, *ja, stop_at=1))
        _close(port.decode_from(first, ta[1], ta[2]).detach(),
               jstack.apply(variables, jnp.asarray(first.detach().numpy()),
                            ja[1], ja[2], method=jstack.decode_from))


def test_gcn_stack_dropout_needs_its_draws():
    _, _, port, x, adj_n, mask = _stack_pair(1, dropout=0.5)
    ta = (_t(x), _t(adj_n), _t(mask))
    with pytest.raises(ValueError):
        port(*ta, lp=True, deterministic=False)
    keep = torch.zeros(12, 6, dtype=torch.bool)
    keep[:, ::2] = True
    out = port(*ta, lp=True, deterministic=False, drop_masks=[keep])
    assert bool((out[:, 1::2] == 0).all())
    a = port(*ta, lp=True, deterministic=False,
             generator=torch.Generator().manual_seed(1))
    b = port(*ta, lp=True, deterministic=False,
             generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)


def test_task_decoder():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(9, 6)).astype(np.float32)
    jdec = JTaskDecoder(hidden=6, out=3)
    variables = jdec.init(jax.random.key(4), jnp.asarray(x))
    host = jax.tree_util.tree_map(np.asarray, dict(variables))
    host["params"]["Dense_0"]["bias"] = rng.normal(size=6).astype(np.float32)
    port = TaskDecoder(6, 6, 3)
    port.load_state_dict(decoder_params_from_jax(host))
    _close(port(_t(x)).detach(), jdec.apply(host, jnp.asarray(x)))
    with pytest.raises(ValueError):
        decoder_params_from_jax({"params": {"Dense_0": {}}})


# ---- graph ops ----------------------------------------------------------------

@pytest.mark.parametrize("k,relu", [(0, True), (1, True), (3, True),
                                    (2, False)])
def test_aggregate_k_hop_dense(k, relu):
    adj, mask, x = _graph(9)
    adj_n = np.asarray(jgraph.normalize_adj_dense(jnp.asarray(adj),
                                                  jnp.asarray(mask)))
    _close(tprop.aggregate_k_hop_dense(_t(adj_n), _t(x), k, relu),
           jprop.aggregate_k_hop_dense(jnp.asarray(adj_n), jnp.asarray(x), k,
                                       relu))
    # batched: each graph as alone
    adj2, mask2, x2 = _graph(19)
    got = tprop.aggregate_k_hop_dense(torch.stack([_t(adj_n), _t(adj2)]),
                                      torch.stack([_t(x), _t(x2)]), k, relu)
    _close(got[1], jprop.aggregate_k_hop_dense(jnp.asarray(adj2),
                                               jnp.asarray(x2), k, relu))


@pytest.mark.parametrize("k,relu", [(1, True), (3, False)])
def test_aggregate_k_hop_edges(k, relu):
    rng = np.random.default_rng(10)
    n, e = 20, 70
    send = rng.integers(0, n, e).astype(np.int32)
    recv = rng.integers(0, n, e).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    w[-5:] = 0.0                                # padding edges
    x = rng.normal(size=(n, 4)).astype(np.float32)
    _close(tprop.aggregate_k_hop_edges(_t(send), _t(recv), _t(w), _t(x), n,
                                       k, relu),
           jprop.aggregate_k_hop_edges(jnp.asarray(send), jnp.asarray(recv),
                                       jnp.asarray(w), jnp.asarray(x), n, k,
                                       relu))


def _pagerank_cases():
    cases = []
    for seed, n_real, p in ((0, 9, 0.3), (1, 12, 0.5), (2, 5, 0.15),
                            (3, 1, 0.3)):
        adj, mask, _ = _graph(seed, n_real=n_real, p=p)
        cases.append((adj, mask))
    empty = np.zeros((12, 12), np.float32)      # a batch-padding graph
    cases.append((empty, np.zeros(12, bool)))
    return cases


def test_pagerank_dense_and_inverse_prob():
    """Raw and normalized adjacencies (fractional row sums), dangling
    nodes, a single node, an empty graph; then all of them as one batch:
    every graph stops by its own rule, so the batch changes nothing."""
    per_graph = []
    for adj, mask in _pagerank_cases():
        for a in (adj, np.asarray(jgraph.normalize_adj_dense(
                jnp.asarray(adj), jnp.asarray(mask)))):
            ja, jm = jnp.asarray(a), jnp.asarray(mask)
            _close(tpr.pagerank_dense(_t(a), _t(mask)),
                   jpr.pagerank_dense(ja, jm), 2e-6)
            _close(tpr.degree_centrality_dense(_t(a), _t(mask)),
                   jpr.degree_centrality_dense(ja, jm), 1e-6)
            got = tpr.inverse_sample_prob_dense(_t(a), _t(mask))
            _close(got, jpr.inverse_sample_prob_dense(ja, jm), 2e-6)
            per_graph.append((a, mask, got))
    adjs = torch.stack([_t(a) for a, _, _ in per_graph])
    masks = torch.stack([_t(m) for _, m, _ in per_graph])
    batched = tpr.inverse_sample_prob_dense(adjs, masks)
    for i, (_, _, alone) in enumerate(per_graph):
        _close(batched[i], alone, 1e-7)
    shaped = tpr.pagerank_dense(adjs.reshape(2, 5, 12, 12),
                                masks.reshape(2, 5, 12))
    assert shaped.shape == (2, 5, 12)
    _close(tpr.pagerank_dense(_t(per_graph[0][0])),
           jpr.pagerank_dense(jnp.asarray(per_graph[0][0])), 2e-6)


def test_pagerank_dense_iteration_cap():
    adj, mask, _ = _graph(0)
    for cap in (1, 5, 9):       # below, at and off the host-read interval
        _close(tpr.pagerank_dense(_t(adj), _t(mask), max_iters=cap),
               jpr.pagerank_dense(jnp.asarray(adj), jnp.asarray(mask),
                                  max_iters=cap), 2e-6)


@pytest.mark.parametrize("seed,n_real", [(0, 9), (1, 12), (4, 17)])
def test_all_pairs_shortest_paths(seed, n_real):
    adj, mask, _ = _graph(seed, n=17, n_real=n_real, p=0.2)
    want = np.asarray(jsp.all_pairs_shortest_paths(jnp.asarray(adj),
                                                   jnp.asarray(mask)))
    got = tsp.all_pairs_shortest_paths(_t(adj), _t(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tsp.all_pairs_shortest_paths(_t(adj)).numpy(),
        np.asarray(jsp.all_pairs_shortest_paths(jnp.asarray(adj))))


@pytest.mark.parametrize("hops", [2, 10])
def test_anchor_distances_and_position_codes(hops):
    """Anchors drawn by JAX's ``choice`` with the key that
    ``position_aware_codes`` uses, handed to the port as data."""
    adj, mask, _ = _graph(11, n=14, n_real=11, p=0.2)
    ja, jm = jnp.asarray(adj), jnp.asarray(mask)
    key = jax.random.key(5)
    probs = jm.astype(jnp.float32) / jm.sum()
    anchors = np.asarray(jax.random.choice(key, 14, shape=(6,), p=probs))
    want = np.asarray(jsp.anchor_distances(ja, jnp.asarray(anchors), jm,
                                           num_hops=hops))
    got = tsp.anchor_distances(_t(adj), _t(anchors), _t(mask), hops).numpy()
    np.testing.assert_array_equal(got, want)
    want_code = jsp.position_aware_codes(ja, key, jm, num_anchors=6,
                                         dis_q=hops)
    got_code = tsp.position_aware_codes(_t(adj), _t(mask), 6, hops,
                                        anchors=_t(anchors))
    _close(got_code, want_code, 1e-7)
    # batched, and drawn by the port: anchors are real nodes
    adjs = torch.stack([_t(adj), _t(adj).flip(0).flip(1)])
    masks = torch.stack([_t(mask), _t(mask).flip(0)])
    both = tsp.position_aware_codes(
        adjs, masks, 6, hops,
        anchors=torch.stack([_t(anchors), _t(13 - anchors)]))
    _close(both[0], want_code, 1e-7)
    gen = torch.Generator().manual_seed(0)
    drawn = tsp.draw_anchors(masks, 50, gen)
    assert drawn.shape == (2, 50)
    assert bool(torch.gather(masks, 1, drawn).all())
    assert tsp.draw_anchors(torch.zeros(1, 4, dtype=torch.bool), 3,
                            gen).shape == (1, 3)
    with pytest.raises(ValueError):
        tsp.position_aware_codes(_t(adj), _t(mask))


def test_augmentations_with_jax_draws():
    adj, mask, x = _graph(12)
    prob = np.asarray(jpr.inverse_sample_prob_dense(jnp.asarray(adj),
                                                    jnp.asarray(mask)))
    prob = prob * 40.0          # keep probabilities that keep some nodes
    key = jax.random.key(6)
    want = jaug.augment_adj(key, jnp.asarray(adj), jnp.asarray(prob),
                            jnp.asarray(mask))
    u = np.asarray(jax.random.uniform(key, adj.shape))
    got = taug.augment_adj(None, _t(adj), _t(prob), _t(mask), u=_t(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < float(got.sum()) < float(mask.sum()) ** 2
    # features: JAX splits its key into a noise and a dropout key
    wantf = jaug.augment_features(key, jnp.asarray(x), jnp.asarray(prob),
                                  dropout_rate=1.0)
    k_noise, k_drop = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k_noise, x.shape))
    keep_u = np.asarray(jax.random.uniform(k_drop, prob.shape))
    gotf = taug.augment_features(None, _t(x), _t(prob), dropout_rate=1.0,
                                 noise=_t(noise), keep_u=_t(keep_u))
    _close(gotf, wantf, 1e-6)
    # without draws: a generator, or an error
    with pytest.raises(ValueError):
        taug.augment_adj(None, _t(adj), _t(prob))
    g = torch.Generator().manual_seed(3)
    a = taug.augment_adj(g, _t(adj), _t(prob), _t(mask))
    assert set(a.unique().tolist()) <= {0.0, 1.0}
    assert bool((a[~_t(mask)] == 0).all())


# ---- the rest of the public functions ---------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_jaccard_similarity(seed):
    from ragraph_tpu.ops.similarity import jaccard_similarity as j_jaccard
    from ragraph_tpu_torch.ops.similarity import jaccard_similarity
    adj, _, _ = _graph(seed, n=14, n_real=11)
    adj[3] = adj[:, 3] = 0.0            # an isolated node: empty unions
    adj = adj * np.float32(0.7)         # weights: only the pattern counts
    want = np.asarray(j_jaccard(jnp.asarray(adj)))
    got = jaccard_similarity(_t(adj))
    _close(got, want, 1e-7)
    assert float(got[3].abs().sum()) == 0 and bool((got <= 1).all())


@pytest.mark.parametrize("num,alpha", [(5, 0.5), (3, 0.3)])
def test_interpolation_node(num, alpha):
    """Mixup rows on JAX's pairs; a pair with src == dst gets the dst
    edge's weight, which is written last."""
    adj, _, x = _graph(4, n=10, n_real=10)
    key = jax.random.key(num)
    wf, wa = jaug.interpolation_node(key, jnp.asarray(x), jnp.asarray(adj),
                                     num, alpha)
    pairs = np.array(jax.random.randint(key, (num, 2), 0, 10))
    gf, ga = taug.interpolation_node(None, _t(x), _t(adj), num, alpha,
                                     pairs=_t(pairs))
    _close(gf, wf, 1e-7)
    _close(ga, wa, 0)
    same = np.array([[2, 2]] + [[0, 1]] * (num - 1))
    gf, ga = taug.interpolation_node(None, _t(x), _t(adj), num, alpha,
                                     pairs=_t(same))
    assert float(ga[10, 2]) == pytest.approx(1 - alpha)
    _close(gf[10], x[2], 1e-6)
    drawn = taug.interpolation_node(torch.Generator().manual_seed(0), _t(x),
                                    _t(adj), num, alpha)
    assert drawn[0].shape == (10 + num, 5) and drawn[1].shape == (10 + num,
                                                                  10 + num)
    with pytest.raises(ValueError):
        taug.interpolation_node(None, _t(x), _t(adj), num, alpha)


def test_augment_graph_with_jax_draws():
    """The original graph first, then each copy from JAX's per-copy keys
    (``fold_in(key, i)``, split into a feature and an adjacency key)."""
    adj, mask, x = _graph(8)
    prob = np.asarray(jpr.inverse_sample_prob_dense(jnp.asarray(adj),
                                                    jnp.asarray(mask))) * 40
    key = jax.random.key(2)
    want = list(jaug.augment_graph(key, 2, jnp.asarray(x), jnp.asarray(adj),
                                   jnp.asarray(prob), jnp.asarray(mask)))
    draws = []
    for i in range(2):
        k_f, k_a = jax.random.split(jax.random.fold_in(key, i))
        k_noise, k_drop = jax.random.split(k_f)
        draws.append({"noise": _t(jax.random.normal(k_noise, x.shape)),
                      "keep_u": _t(jax.random.uniform(k_drop, prob.shape)),
                      "u": _t(jax.random.uniform(k_a, adj.shape))})
    got = list(taug.augment_graph(None, 2, _t(x), _t(adj), _t(prob),
                                  _t(mask), draws=draws))
    assert len(got) == len(want) == 3
    assert got[0][0] is not None and torch.equal(got[0][1], _t(adj))
    for (gf, ga), (wf, wa) in zip(got, want):
        _close(gf, wf, 1e-6)
        _close(ga, wa, 0)
    own = list(taug.augment_graph(torch.Generator().manual_seed(1), 1,
                                  _t(x), _t(adj), _t(prob), _t(mask)))
    assert len(own) == 2 and own[1][1].shape == adj.shape


def test_package_reexports():
    """Each subpackage re-exports the public names of its ported modules,
    the JAX package's ``__init__`` lists where the module is ported."""
    import importlib

    import ragraph_tpu_torch as port
    for sub, names in {
            "core": ["DenseGraph", "normalize_adj_dense", "segment_mean"],
            "data": ["flat_batches", "load_tu_dataset", "load_edge_dataset",
                     "synthetic_tu_dataset"],
            "nn": ["DenseGAT", "BilinearDiscriminator2", "GCNStack",
                   "compare_loss", "LoRAFactors", "learned_gate"],
            "rag": ["LibraryConfig", "retrieve", "interpolation_node",
                    "augment_graph", "make_graphcl_views"],
            "models": ["PrePrompt", "prompt_pretrain_sample", "RAGraphNode",
                       "RAGraphGraph", "GRAPH_FUSION_WEIGHTS"],
            "ops": ["cosine_topk", "jaccard_similarity", "fused_cosine_topk",
                    "pagerank_dense", "position_aware_codes",
                    "streaming_cumsum"]}.items():
        mod = importlib.import_module(f"ragraph_tpu_torch.{sub}")
        for name in names:
            assert callable(getattr(mod, name)) or isinstance(
                getattr(mod, name), dict), (sub, name)
    assert port.DenseGraph is tgraph.DenseGraph
