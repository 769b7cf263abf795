"""The toy-graph library of the port against the JAX package's: the
compacting append, the batched build with every random draw passed in, and
retrieval in all its modes.

The JAX build derives a key per graph, copy and purpose; the helper
``_jax_draws`` walks the same derivation and hands the drawn values (noise,
uniforms, sampled node indices, anchors) to the port as data, so both sides
build from the same numbers. Values agree to 2e-5 (f32 matmuls and a
PageRank iteration in another order); labels, validity and positions'
zero pattern exactly. Retrieval is compared on tie-free stores: scores are
f32 on both sides here (stores below 32,768 rows take the exact path), so
the retrieved rows are the same rows.
"""

import dataclasses

import _torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragraph_tpu.data import batching as jbatch
from ragraph_tpu.models.preprompt import PrePrompt as JPrePrompt
from ragraph_tpu.ops import pagerank as jpr
from ragraph_tpu.rag import augmentation as jaug
from ragraph_tpu.rag import library as jlib
from ragraph_tpu_torch.convert import (library_from_jax,
                                       preprompt_params_from_jax)
from ragraph_tpu_torch.data import batching as tbatch
from ragraph_tpu_torch.data.synthetic import synthetic_tu_dataset
from ragraph_tpu_torch.models.preprompt import PrePrompt
from ragraph_tpu_torch.rag import library as tlib

ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _jax_lib(rng, capacity, fill, e=8, c=3, a=4):
    """A JAX library with ``fill`` random rows, and its arrays."""
    lib = jlib.library_init(capacity, e, c, a)
    keys = rng.normal(size=(capacity + 1, e)).astype(np.float32)
    values = rng.normal(size=(capacity + 1, e)).astype(np.float32)
    labels = np.eye(c, dtype=np.float32)[rng.integers(0, c, capacity + 1)]
    positions = rng.random(size=(capacity + 1, a)).astype(np.float32)
    return dataclasses.replace(
        lib, keys=jnp.asarray(keys), values=jnp.asarray(values),
        labels=jnp.asarray(labels), positions=jnp.asarray(positions),
        fill=jnp.asarray(fill, jnp.int32))


def _to_port(lib):
    return library_from_jax(np.asarray(lib.keys), np.asarray(lib.values),
                            np.asarray(lib.labels),
                            np.asarray(lib.positions), int(lib.fill),
                            lib.capacity, device="cpu")


def _same_live(got, want):
    assert int(got.fill) == int(want.fill)
    n = int(want.fill)
    for name in ("keys", "values", "labels", "positions"):
        _close(getattr(got, name)[:n], getattr(want, name)[:n], 1e-7)


# ---- the store ----------------------------------------------------------------

@pytest.mark.parametrize("start,n_rows,n_valid", [
    (0, 10, 10), (3, 12, 5), (0, 8, 0), (14, 10, 7), (20, 6, 6)])
def test_library_append(start, n_rows, n_valid):
    """Compaction after ``fill``; rows past the capacity (20) and invalid
    rows go to the dump row; the fill clamps and stays a device scalar."""
    rng = np.random.default_rng(start + n_rows)
    jl = _jax_lib(rng, 20, start)
    tl = _to_port(jl)
    rows = [rng.normal(size=(n_rows, w)).astype(np.float32)
            for w in (8, 8, 3, 4)]
    valid = np.zeros(n_rows, bool)
    valid[rng.permutation(n_rows)[:n_valid]] = True
    want = jlib.library_append(jl, *(jnp.asarray(r) for r in rows),
                               jnp.asarray(valid))
    got = tlib.library_append(tl, *(_t(r) for r in rows), _t(valid))
    _same_live(got, want)
    assert int(got.fill) == min(start + n_valid, 20)
    assert got.fill.dtype == torch.int32 and got.fill.dim() == 0
    assert torch.equal(got.valid_mask, torch.arange(20) < got.fill)
    # nothing that is read holds the dump row
    assert all(x.shape[0] == 20 for x in got.live())
    assert got.keys.shape[0] == 21
    # written in place: the returned library shares the store
    assert got.keys.data_ptr() == tl.keys.data_ptr()


def test_library_append_twice_and_reset():
    rng = np.random.default_rng(0)
    jl = jlib.library_init(16, 4, 2, 3)
    tl = tlib.library_init(16, 4, 2, 3)
    for n in (7, 6, 9):         # the third append overflows
        rows = [rng.normal(size=(n, w)).astype(np.float32)
                for w in (4, 4, 2, 3)]
        valid = (np.arange(n) % 4 != 3) | (n == 9)
        jl = jlib.library_append(jl, *(jnp.asarray(r) for r in rows),
                                 jnp.asarray(valid))
        tl = tlib.library_append(tl, *(_t(r) for r in rows), _t(valid))
        _same_live(tl, jl)
    assert int(tl.fill) == 16
    assert int(tlib.library_reset(tl).fill) == 0 and int(tl.fill) == 16
    with pytest.raises(ValueError):
        library_from_jax(np.zeros((5, 4)), np.zeros((5, 4)),
                         np.zeros((5, 2)), np.zeros((4, 3)), 0, 4, "cpu")


# ---- the build ----------------------------------------------------------------

def _encoders(feat, hidden, layers=1):
    jenc = JPrePrompt(hidden=hidden, num_layers=layers)
    variables = jenc.init(jax.random.key(7), jnp.zeros((8, feat)),
                          jnp.eye(8), method=jenc.inference)
    host = jax.tree_util.tree_map(np.asarray, dict(variables))
    # a bias that is not zero, so that augmented (all-zero) rows get keys
    for i in range(layers):
        host["params"]["gcn"][f"conv_{i}"]["bias"] = np.linspace(
            -0.3, 0.4, hidden).astype(np.float32)
    port = PrePrompt(feat, hidden, layers)
    port.load_state_dict(preprompt_params_from_jax(host), strict=False)

    def j_fn(f, a, m=None):
        return jenc.apply(host, f, a, m, method=jenc.inference)

    def t_fn(f, a, m=None):
        return port.inference(f, a, m)
    return j_fn, t_fn


def _jax_draws(key, batch, cfg):
    """Every draw of ``build_entries_batch`` for this key, found by the key
    derivation of ``rag/library.py:207-254`` and ``:149-204``."""
    f, a, m = (batch[k] for k in ("features", "adj", "node_mask"))
    b, n, _ = f.shape
    copies = 1 + cfg.num_augment_scale
    s = cfg.num_inverse_sample
    out = {"feat_noise": np.zeros((b, copies) + f.shape[1:], np.float32),
           "feat_keep_u": np.ones((b, copies, n), np.float32),
           "adj_u": np.ones((b, copies, n, n), np.float32),
           "sample_idx": np.zeros((b, copies, s), np.int64),
           "anchors": np.zeros((b, copies, cfg.num_anchors), np.int64)}
    keys = jax.random.split(key, b)
    for g in range(b):
        prob = jpr.inverse_sample_prob_dense(a[g], m[g])
        for i in range(copies):
            k_f, k_a, k_e = jax.random.split(jax.random.fold_in(keys[g], i),
                                             3)
            adj_i = a[g]
            if i > 0:
                k_noise, k_drop = jax.random.split(k_f)
                out["feat_noise"][g, i] = jax.random.normal(k_noise,
                                                            f[g].shape)
                out["feat_keep_u"][g, i] = jax.random.uniform(k_drop, (n,))
                out["adj_u"][g, i] = jax.random.uniform(k_a, (n, n))
                adj_i = jaug.augment_adj(k_a, a[g], prob, m[g])
            _, k_sample, k_pos = jax.random.split(k_e, 3)
            if s > 0:
                p = jpr.inverse_sample_prob_dense(adj_i, m[g])
                p_safe = jnp.where(p.sum() > 0, p, jnp.full((n,), 1.0 / n))
                out["sample_idx"][g, i] = jax.random.choice(
                    k_sample, n, shape=(s,), replace=True, p=p_safe)
                pos_mask = jnp.full((s,), bool(m[g].any()))
            else:
                pos_mask = m[g]
            probs = pos_mask.astype(jnp.float32)
            probs = probs / jnp.maximum(probs.sum(), 1.0)
            out["anchors"][g, i] = jax.random.choice(
                k_pos, pos_mask.shape[0], shape=(cfg.num_anchors,), p=probs)
    return {k: _t(v) for k, v in out.items()}


@pytest.mark.parametrize("inverse,augment,positions", [
    (10, 3, True), (0, 0, True), (6, 0, True), (0, 2, True), (4, 1, False)])
def test_build_entries_batch(inverse, augment, positions):
    ds = synthetic_tu_dataset(seed=4, num_graphs=3, min_nodes=5,
                              max_nodes=11, feat_dim=6)
    jcfg = jlib.LibraryConfig(num_inverse_sample=inverse,
                              num_augment_scale=augment,
                              use_positions=positions, num_anchors=5,
                              dis_q=4)
    tcfg = tlib.LibraryConfig(**dataclasses.asdict(jcfg))
    # batch 4: the last graph is batch padding (an empty graph)
    jb = next(jbatch.stacked_batches(ds.graphs, 4, num_classes=3))
    tb = next(tbatch.stacked_batches(ds.graphs, 4, num_classes=3))
    j_fn, t_fn = _encoders(6, 8)
    key = jax.random.key(11)
    want = jlib.build_entries_batch(
        j_fn, jb["features"], jb["adj"], jb["labels"], jb["node_mask"],
        jb["graph_onehot"], jcfg, key)
    with torch.no_grad():
        got = tlib.build_entries_batch(
            t_fn, tb["features"], tb["adj"], tb["labels"], tb["node_mask"],
            tb["graph_onehot"], tcfg, draws=_jax_draws(key, jb, jcfg))
    rows = 4 * (1 + augment) * (inverse or 16)
    valid = np.asarray(want[4])
    assert got[4].shape == (rows,) and valid.shape == (rows,)
    np.testing.assert_array_equal(got[4].numpy(), valid)
    assert valid.sum() == (3 * (1 + augment) * inverse if inverse
                           else (1 + augment) * sum(len(g.adj)
                                                    for g in ds.graphs))
    for g, w, name in zip(got[:4], want[:4],
                          ("keys", "values", "labels", "positions")):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g[_t(valid)], np.asarray(w)[valid])
    if positions:
        assert float(got[3][_t(valid)].abs().sum()) > 0
    else:
        assert float(got[3].abs().sum()) == 0


def test_build_entries_batch_draws_its_own():
    """Without draws the port draws from the generator: the same seed gives
    the same entries, another seed others; without either it raises."""
    ds = synthetic_tu_dataset(seed=4, num_graphs=4, feat_dim=6)
    tb = next(tbatch.stacked_batches(ds.graphs, 4, num_classes=3))
    _, t_fn = _encoders(6, 8)
    cfg = tlib.LibraryConfig()

    def run(seed):
        with torch.no_grad():
            return tlib.build_entries_batch(
                t_fn, tb["features"], tb["adj"], tb["labels"],
                tb["node_mask"], None, cfg,
                torch.Generator().manual_seed(seed))
    a, b, c = run(0), run(0), run(1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (4 * 4 * 10, 8) and bool(a[4].all())
    # keys are unit rows or all-zero rows of dropped-out copies
    norms = a[0].norm(dim=1)
    assert bool(((norms - 1).abs() < 1e-5).logical_or(norms < 1e-6).all())
    with pytest.raises(ValueError):
        tlib.build_entries_batch(t_fn, tb["features"], tb["adj"],
                                 tb["labels"], tb["node_mask"], None, cfg)
    # graph level: one pooled entry per graph and copy, drawn likewise
    gcfg = tlib.LibraryConfig(level="graph")
    ga, gb = (tlib.build_entries_batch(
        t_fn, tb["features"], tb["adj"], tb["labels"], tb["node_mask"],
        tb["graph_onehot"], gcfg, torch.Generator().manual_seed(s))
        for s in (0, 0))
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))
    assert ga[0].shape == (4 * 4, 8) and bool(ga[4].all())
    with pytest.raises(ValueError, match="level"):
        tlib.build_entries_batch(
            t_fn, tb["features"], tb["adj"], tb["labels"], tb["node_mask"],
            tb["graph_onehot"], tlib.LibraryConfig(level="edge"),
            torch.Generator())


@pytest.mark.parametrize("inverse,augment,positions", [
    (0, 0, False), (10, 3, True), (0, 2, True)])
def test_build_entries_batch_graph_level(inverse, augment, positions):
    """Graph-level entries against JAX's with its draws handed over: one
    mean-pooled key and value per graph and copy, the graph's one-hot
    label, zero positions; the padding graph yields no entry."""
    ds = synthetic_tu_dataset(seed=5, num_graphs=3, min_nodes=5,
                              max_nodes=11, feat_dim=6)
    jcfg = jlib.LibraryConfig(level="graph", num_inverse_sample=inverse,
                              num_augment_scale=augment,
                              use_positions=positions, num_anchors=5,
                              dis_q=4, toy_graph_hop=1)
    tcfg = tlib.LibraryConfig(**dataclasses.asdict(jcfg))
    jb = next(jbatch.stacked_batches(ds.graphs, 4, num_classes=3))
    tb = next(tbatch.stacked_batches(ds.graphs, 4, num_classes=3))
    j_fn, t_fn = _encoders(6, 8)
    key = jax.random.key(13)
    want = jlib.build_entries_batch(
        j_fn, jb["features"], jb["adj"], jb["labels"], jb["node_mask"],
        jb["graph_onehot"], jcfg, key)
    with torch.no_grad():
        got = tlib.build_entries_batch(
            t_fn, tb["features"], tb["adj"], tb["labels"], tb["node_mask"],
            tb["graph_onehot"], tcfg, draws=_jax_draws(key, jb, jcfg))
    rows = 4 * (1 + augment)
    valid = np.asarray(want[4])
    assert got[4].shape == (rows,)
    np.testing.assert_array_equal(got[4].numpy(), valid)
    assert valid.sum() == 3 * (1 + augment)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.zeros((rows, 5)))
    for g, w in zip(got[:2], want[:2]):
        assert tuple(g.shape) == tuple(w.shape) == (rows, 8)
        _close(g[_t(valid)], np.asarray(w)[valid], 1e-6)


def test_build_library_fills_and_clamps():
    """``build_library`` over the batches of both packages, deterministic
    settings: the same store. Then a capacity below the row count: the fill
    clamps at the capacity on both sides."""
    ds = synthetic_tu_dataset(seed=6, num_graphs=7, feat_dim=6)
    jcfg = jlib.LibraryConfig(num_inverse_sample=0, num_augment_scale=0,
                              use_positions=False)
    tcfg = tlib.LibraryConfig(**dataclasses.asdict(jcfg))
    j_fn, t_fn = _encoders(6, 8)
    n_nodes = sum(len(g.adj) for g in ds.graphs)
    for capacity in (256, 50):
        want = jlib.build_library(
            jlib.library_init(capacity, 8, 3), j_fn,
            jbatch.stacked_batches(ds.graphs, 3, num_classes=3), jcfg,
            jax.random.key(0))
        got = tlib.build_library(
            tlib.library_init(capacity, 8, 3), t_fn,
            tbatch.stacked_batches(ds.graphs, 3, num_classes=3), tcfg)
        assert int(got.fill) == int(want.fill) == min(n_nodes, capacity)
        n = int(got.fill)
        _close(got.keys[:n], want.keys[:n])
        _close(got.values[:n], want.values[:n])
        _close(got.labels[:n], want.labels[:n], 0)
        assert not got.keys.requires_grad


# ---- retrieval ------------------------------------------------------------------

def _queries(rng, q=7, e=8, a=4):
    return (rng.normal(size=(q, e)).astype(np.float32),
            rng.random(size=(q, a)).astype(np.float32))


@pytest.mark.parametrize("fill", [40, 3, 1])
def test_retrieve_semantic(fill):
    rng = np.random.default_rng(fill)
    jl = _jax_lib(rng, 40, fill)
    tl = _to_port(jl)
    q, _ = _queries(rng)
    jcfg = jlib.LibraryConfig(retrieve_num=min(4, fill))
    tcfg = tlib.LibraryConfig(retrieve_num=min(4, fill))
    want = jlib.retrieve(jl, jnp.asarray(q), jcfg)
    got = tlib.retrieve(tl, _t(q), tcfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, 1e-7)


@pytest.mark.parametrize("hidden", [264, 100])
def test_retrieve_semantic_wide_rows(hidden, monkeypatch):
    """``retrieve`` at widths the card's kernel C takes in chunks of 128
    columns (264) or on zero-padded rows (100), above the (lowered) size at
    which both packages leave the exact sort for the approximate tier: the
    port's kernel C against the JAX package's ``approx_max_k``. Each query
    has four planted neighbours 0.1 apart in score, so bf16 and f32 scores
    pick the same rows in the same order."""
    from ragraph_tpu.ops import topk as jtopk
    from ragraph_tpu_torch.ops import topk as ttopk
    monkeypatch.setattr(jtopk, "AUTO_APPROX_THRESHOLD", 100)
    monkeypatch.setattr(ttopk, "AUTO_APPROX_THRESHOLD", 100)
    rng = np.random.default_rng(hidden)
    jl = _jax_lib(rng, 300, 260, e=hidden)
    q, _ = _queries(rng, q=5, e=hidden)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    keys = np.array(jl.keys)
    for r in range(5):
        for j, cos in enumerate((0.9, 0.8, 0.7, 0.6)):
            noise = rng.normal(size=hidden)
            noise -= noise @ qn[r] * qn[r]
            keys[10 * r + j] = cos * qn[r] + np.sqrt(1 - cos ** 2) \
                * noise / np.linalg.norm(noise)
    jl = dataclasses.replace(jl, keys=jnp.asarray(keys))
    tl = _to_port(jl)
    jcfg, tcfg = (m.LibraryConfig(retrieve_num=4) for m in (jlib, tlib))
    want = jlib.retrieve(jl, jnp.asarray(q), jcfg)
    got = tlib.retrieve(tl, _t(q), tcfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, 1e-7)


def test_retrieve_structure_weighted():
    rng = np.random.default_rng(5)
    jl = _jax_lib(rng, 64, 50)
    tl = _to_port(jl)
    q, pos = _queries(rng)
    kw = dict(retrieve_num=5, structure_weight=0.4, semantic_weight=0.6)
    want = jlib.retrieve(jl, jnp.asarray(q), jlib.LibraryConfig(**kw),
                         search_positions=jnp.asarray(pos))
    got = tlib.retrieve(tl, _t(q), tlib.LibraryConfig(**kw),
                        search_positions=_t(pos))
    for g, w in zip(got, want):
        _close(g, w, 1e-7)
    # the weight changes what is retrieved; without positions it does not
    plain = tlib.retrieve(tl, _t(q), tlib.LibraryConfig(retrieve_num=5))
    assert not torch.equal(plain[0], got[0])
    assert torch.equal(tlib.retrieve(tl, _t(q), tlib.LibraryConfig(**kw))[0],
                       plain[0])


def test_retrieve_noise_rows():
    """``k = 2·retrieve_num`` under noise, then ``noise_retrieve_num``
    random live rows: JAX's ``randint`` with the same key, handed over."""
    rng = np.random.default_rng(6)
    jl = _jax_lib(rng, 64, 37)
    tl = _to_port(jl)
    q, _ = _queries(rng)
    kw = dict(retrieve_num=3, noise_retrieve_num=2)
    key = jax.random.key(3)
    want = jlib.retrieve(jl, jnp.asarray(q), jlib.LibraryConfig(**kw),
                         add_noise=True, key=key)
    idx = np.asarray(jax.random.randint(key, (7, 2), 0, 37))
    got = tlib.retrieve(tl, _t(q), tlib.LibraryConfig(**kw), add_noise=True,
                        noise_idx=_t(idx))
    assert got[0].shape == (7, 8, 8) and got[1].shape == (7, 8, 3)
    for g, w in zip(got, want):
        _close(g, w, 1e-7)
    # drawn by the port: live rows only, the same for the same seed
    a = tlib.retrieve(tl, _t(q), tlib.LibraryConfig(**kw), add_noise=True,
                      generator=torch.Generator().manual_seed(1))
    b = tlib.retrieve(tl, _t(q), tlib.LibraryConfig(**kw), add_noise=True,
                      generator=torch.Generator().manual_seed(1))
    assert torch.equal(a[0], b[0]) and torch.equal(a[0][:, :6], got[0][:, :6])
    live = tl.values[:37]
    noise_rows = a[0][:, 6:].reshape(-1, 8)
    assert bool((noise_rows[:, None, :] == live[None]).all(-1).any(-1).all())
    with pytest.raises(ValueError, match="generator"):
        tlib.retrieve(tl, _t(q), tlib.LibraryConfig(**kw), add_noise=True)


def test_retrieve_noise_gaussian():
    rng = np.random.default_rng(7)
    jl = _jax_lib(rng, 64, 64)
    tl = _to_port(jl)
    q, _ = _queries(rng)
    kw = dict(retrieve_num=2, noise_mode="gaussian", noise_std=0.05)
    key = jax.random.key(4)
    want = jlib.retrieve(jl, jnp.asarray(q), jlib.LibraryConfig(**kw),
                         add_noise=True, key=key)
    noise = np.asarray(jax.random.normal(key, (7, 4, 8)))
    got = tlib.retrieve(tl, _t(q), tlib.LibraryConfig(**kw), add_noise=True,
                        noise=_t(noise))
    for g, w in zip(got, want):
        _close(g, w, 1e-6)
    with pytest.raises(ValueError, match="generator"):
        tlib.retrieve(tl, _t(q), tlib.LibraryConfig(**kw), add_noise=True)


def test_retrieve_int8_tier():
    """int8 scoring with an exact rescore of ``k + pad`` candidates returns
    the f32 path's rows on both sides; raw int8 scores tie and may order
    rows otherwise, so that mode is held to its own scores' top-k."""
    rng = np.random.default_rng(8)
    jl = _jax_lib(rng, 128, 100, e=16)
    tl = _to_port(jl)
    q = rng.normal(size=(9, 16)).astype(np.float32)
    kw = dict(retrieve_num=4, retrieve_dtype="int8", retrieve_rescore_pad=12)
    want = jlib.retrieve(jl, jnp.asarray(q), jlib.LibraryConfig(**kw))
    got = tlib.retrieve(tl, _t(q), tlib.LibraryConfig(**kw))
    for g, w in zip(got, want):
        _close(g, w, 1e-7)
    raw = tlib.retrieve(tl, _t(q), tlib.LibraryConfig(
        retrieve_num=4, retrieve_dtype="int8"))
    f32 = tlib.retrieve(tl, _t(q), tlib.LibraryConfig(retrieve_num=4))
    assert raw[0].shape == f32[0].shape
    same = (raw[0][:, :, None, :] == f32[0][:, None, :, :]).all(-1).any(-1)
    assert float(same.float().mean()) > 0.7


def test_retrieve_carries_no_gradient():
    rng = np.random.default_rng(9)
    tl = _to_port(_jax_lib(rng, 32, 32))
    q = _t(_queries(rng)[0]).requires_grad_(True)
    emb, lab = tlib.retrieve(tl, q, tlib.LibraryConfig())
    assert not emb.requires_grad and not lab.requires_grad
