"""The port's RAGraph-edge serving slice against the JAX package on the
synthetic stream (64 users, 128 items).

Weights come from the JAX package's ``init_params`` through
``convert.params_from_jax``. Two arms:

- kernel path: the fused propagation (``segsum_impl="fused"``, bf16 and
  f32) and the fused retrieval on both sides. JAX runs its Pallas kernels
  in interpret mode; its ``cosine_topk`` is pointed at ``method="pallas"``
  and the port's ``AUTO_APPROX_THRESHOLD`` set to 0, both only for the test;
- CPU defaults: scatter reduction and f32 on both sides.

Random draws differ between the frameworks, so the parity tests draw
nothing (``num_inverse_sample=0``) or pass the same draws to both sides.
"""

import dataclasses
import functools

import _torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragraph_tpu.data import load_edge_dataset as j_load_edge_dataset
from ragraph_tpu.data import synthetic_edge_stream as j_synthetic
from ragraph_tpu.models import edge as jedge
from ragraph_tpu.models.edge import ragraph_edge as j_ragraph_edge
from ragraph_tpu.ops import topk as jtopk
from ragraph_tpu.ops.pagerank import inverse_sample_prob_edges as j_isp
from ragraph_tpu.train.metrics import RankingEvaluator as JEvaluator
from ragraph_tpu_torch.convert import params_from_jax
from ragraph_tpu_torch.data.edgelist import load_edge_dataset
from ragraph_tpu_torch.data.synthetic import synthetic_edge_stream
from ragraph_tpu_torch.models import edge as tedge
from ragraph_tpu_torch.models.edge import ragraph_edge as t_ragraph_edge
from ragraph_tpu_torch.ops import topk as ttopk
from ragraph_tpu_torch.ops.pagerank import inverse_sample_prob_edges
from ragraph_tpu_torch.rag.augmentation import augment_features
from ragraph_tpu_torch.train.metrics import RankingEvaluator

F32_ATOL = 1e-5
# a 1-ulp f32 difference can flip a bf16 rounding in the next layer
BF16_ATOL = 2e-3


@pytest.fixture(scope="module")
def data():
    j_train, j_stages = j_synthetic(seed=0)
    train, stages = synthetic_edge_stream(seed=0)
    assert train == j_train and stages == j_stages
    return (j_load_edge_dataset(j_train, j_stages[0]),
            load_edge_dataset(train, stages[0]))


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


def test_dataset_and_graph_arrays_match_exactly(data):
    jds, tds = data
    for f in ("edgelist", "edge_time", "senders", "receivers", "edge_norm",
              "edge_times_bi", "recv_indptr"):
        np.testing.assert_array_equal(getattr(tds, f), getattr(jds, f))
    assert tds.user_hist_dict == jds.user_hist_dict
    assert tds.test_user_dict == jds.test_user_dict
    jg = jedge.EdgeGraphArrays.from_dataset(jds)
    tg = tedge.EdgeGraphArrays.from_dataset(tds, "cpu")
    for f in ("senders", "receivers", "edge_norm", "edge_times", "recv_indptr",
              "send_perm", "send_indptr", "recv_of_send", "edge_norm_send",
              "time_norm", "time_norm_send"):
        got, want = _np(getattr(tg, f)), np.asarray(getattr(jg, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (tg.num_users, tg.num_items) == (jg.num_users, jg.num_items)


def _models(data, cls_name, phase, **cfg_kw):
    """The same config, graph and weights on both sides."""
    jds, tds = data
    jcfg = jedge.EdgeModelConfig(**cfg_kw)
    tcfg = tedge.EdgeModelConfig(**cfg_kw)
    jg = jedge.EdgeGraphArrays.from_dataset(jds)
    tg = tedge.EdgeGraphArrays.from_dataset(tds, "cpu")
    pre = getattr(jedge, cls_name)(jcfg, jg, phase="pretrain")
    tables = pre.init_params(jax.random.key(0))
    tables = (tables["user_embedding"], tables["item_embedding"])
    jm = getattr(jedge, cls_name)(jcfg, jg, phase=phase)
    tm = getattr(tedge, cls_name)(tcfg, tg, phase=phase)
    jparams = jm.init_params(jax.random.key(1), pretrained_tables=tables)
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                              "cpu")
    return jm, tm, jparams, tparams


ARMS = {"kernel-bf16": dict(segsum_impl="fused", propagate_dtype="bf16"),
        "kernel-f32": dict(segsum_impl="fused", propagate_dtype="f32"),
        "cpu-default": dict()}


@pytest.mark.parametrize("phase", ["pretrain", "vanilla", "finetune"])
@pytest.mark.parametrize("arm", list(ARMS))
def test_generate_matches_jax(data, monkeypatch, arm, phase):
    if arm != "cpu-default":
        monkeypatch.setattr(j_ragraph_edge, "cosine_topk",
                            functools.partial(jtopk.cosine_topk,
                                              method="pallas"))
        monkeypatch.setattr(ttopk, "AUTO_APPROX_THRESHOLD", 0)
    jm, tm, jparams, tparams = _models(data, "RAGraphEdge", phase,
                                       **ARMS[arm])
    atol = BF16_ATOL if arm == "kernel-bf16" else F32_ATOL
    if phase != "pretrain":
        ju, ji = jm.generate(jparams)
        jk, jv = jm.make_resource_graph(ju, ji, jax.random.key(2))
        tu0, ti = tm.generate(tparams)
        tk, tv = tm.make_resource_graph(tu0, ti)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=atol)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=atol)
    ju, ji = jm.generate(jparams)
    tu, ti = tm.generate(tparams)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=atol)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=atol)
    if phase != "pretrain":
        # the fusion moved the embeddings away from the plain propagation
        assert (tu - tu0).abs().max() > 1e-3


@pytest.mark.parametrize("cls_name", ["LightGCNEdge", "GraphPro"])
def test_backbones_match_jax(data, cls_name):
    jm, tm, jparams, tparams = _models(data, cls_name, "finetune")
    for (j, t) in zip(jm.generate(jparams), tm.generate(tparams)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=F32_ATOL)


def test_renorm_time_encoding_matches_jax(data):
    """``max_time_step`` recomputes the time softmax over the live edges
    (receiver order only), which leaves the fused backend."""
    jm, tm, jparams, tparams = _models(data, "RAGraphEdge", "pretrain",
                                       segsum_impl="fused",
                                       propagate_dtype="f32")
    step = int(np.asarray(jm.graph.edge_times).max()) + 5
    for (j, t) in zip(jm.generate(jparams, max_time_step=step),
                      tm.generate(tparams, max_time_step=step)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=F32_ATOL)


@pytest.mark.parametrize("mode", ["none", "scatter", "hist_pad"])
def test_recommend_from_matches_jax(mode):
    rng = np.random.default_rng(0)
    ue = rng.normal(size=(64, 16)).astype(np.float32)
    ie = rng.normal(size=(128, 16)).astype(np.float32)
    users = rng.integers(0, 64, 10).astype(np.int32)
    rows = rng.integers(0, 10, 40).astype(np.int32)
    cols = rng.integers(0, 128, 40).astype(np.int32)
    cols[:3] = 128                        # out of range: ignored
    kw = {} if mode == "none" else dict(hist_rows=rows, hist_cols=cols)
    pad = 16 if mode == "hist_pad" else None
    want_s, want_i = jedge.RAGraphEdge.recommend_from(
        jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(users), k=20,
        hist_pad=pad, **{k: jnp.asarray(v) for k, v in kw.items()})
    s, i = tedge.RAGraphEdge.recommend_from(
        torch.from_numpy(ue), torch.from_numpy(ie), torch.from_numpy(users),
        k=20, hist_pad=pad, **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    if mode != "none":
        seen = {(r, c) for r, c in zip(rows.tolist(), cols.tolist())}
        assert not any((r, c) in seen for r in range(10)
                       for c in i.numpy()[r].tolist())


def test_ranking_evaluator_matches_jax(data):
    _, tds = data
    rng = np.random.default_rng(1)
    ue = rng.normal(size=(tds.num_users, 16)).astype(np.float32)
    ie = rng.normal(size=(tds.num_items, 16)).astype(np.float32)
    metrics = ("recall", "ndcg", "precision", "mrr")
    for compat in (False, True):
        want = JEvaluator(metrics, ks=(5, 20), eval_batch_size=24,
                          mrr_compat=compat).evaluate(
            jnp.asarray(ue), jnp.asarray(ie), tds.test_user_dict,
            tds.user_hist_dict)
        got = RankingEvaluator(metrics, ks=(5, 20), eval_batch_size=24,
                               mrr_compat=compat).evaluate(
            torch.from_numpy(ue), torch.from_numpy(ie), tds.test_user_dict,
            tds.user_hist_dict)
        for m in metrics:
            np.testing.assert_allclose(got[m], want[m], rtol=1e-6, atol=1e-7)
    tuned = RankingEvaluator().evaluate_grouped(
        torch.from_numpy(ue), torch.from_numpy(ie), tds.test_user_dict,
        tds.train_user_dict, tds.user_hist_dict)
    assert np.isfinite(tuned["recall"]).all()


def test_inverse_sampling_and_library_rows_match_jax(data, monkeypatch):
    jds, tds = data
    n = tds.num_users + tds.num_items
    want = j_isp(jnp.asarray(jds.senders), jnp.asarray(jds.receivers),
                 jnp.asarray(jds.edge_norm), n)
    got = inverse_sample_prob_edges(torch.from_numpy(tds.senders),
                                    torch.from_numpy(tds.receivers),
                                    torch.from_numpy(tds.edge_norm), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert abs(float(got.sum()) - 1.0) < 1e-5

    # the same fixed sample indices on both sides
    idx = np.random.default_rng(3).integers(0, n, 50)
    monkeypatch.setattr(jax.random, "choice",
                        lambda *a, **k: jnp.asarray(idx))
    monkeypatch.setattr(torch, "multinomial",
                        lambda *a, **k: torch.from_numpy(idx))
    jm, tm, jparams, tparams = _models(data, "RAGraphEdge", "vanilla",
                                       num_inverse_sample=50)
    jk, jv = jm.make_resource_graph(*jm.generate(jparams), jax.random.key(0))
    tk, tv = tm.make_resource_graph(*tm.generate(tparams),
                                    torch.Generator().manual_seed(0))
    assert tk.shape == (50, 64)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=F32_ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=F32_ATOL)


def test_augmentation_and_library_growth(data):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(20, 8, generator=gen)
    keep_all = augment_features(gen, x, torch.full((20,), 1e4),
                                noise_std=0.0)
    torch.testing.assert_close(keep_all, x)
    assert (augment_features(gen, x, torch.zeros(20)) == 0).all()
    _, tm, _, tparams = _models(data, "RAGraphEdge", "vanilla",
                                num_augment_scale=1)
    with pytest.raises(ValueError, match="generator"):
        tm.make_resource_graph(*tm.generate(tparams))
    keys, values = tm.make_resource_graph(*tm.generate(tparams),
                                          torch.Generator().manual_seed(1))
    assert keys.shape == values.shape == (2 * tm.graph.num_nodes, 64)


@pytest.mark.parametrize("name", ["amazon", "koubei", "taobao", "SYNTH"])
@pytest.mark.parametrize("phase", ["vanilla", "finetune"])
def test_edge_config_for_matches_jax(name, phase):
    want = jedge.edge_config_for(name, phase, num_nodes=1234, emb_size=32)
    got = tedge.edge_config_for(name, phase, num_nodes=1234, emb_size=32)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_unported_paths_raise(data, monkeypatch):
    with pytest.raises(ValueError, match="retrieve_dtype"):
        tedge.EdgeModelConfig(retrieve_dtype="fp8")
    _, tm, _, tparams = _models(data, "RAGraphEdge", "vanilla",
                                retrieve_num=100000)
    tm.make_resource_graph(*tm.generate(tparams))
    index_path = tm.generate(tparams)
    # k = R = 192 here; shrink the huge-k limit below k * emb_size: the
    # threshold fusion, ported since, takes every row as the index path does
    monkeypatch.setattr(t_ragraph_edge, "_BIG_K_ELEMS", 1000)
    for got, want in zip(tm.generate(tparams), index_path):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_ATOL)
    monkeypatch.undo()
    tm.cfg = dataclasses.replace(tm.cfg, retrieve_num=10,
                                 retrieve_dtype="int8")
    assert all(torch.isfinite(t).all() for t in tm.generate(tparams))
    # a score type that cosine_topk does not know
    tm.cfg = dataclasses.replace(tm.cfg, retrieve_dtype="bf16")
    with pytest.raises(ValueError, match="unknown score_dtype"):
        tm.generate(tparams)
    tm.cfg = dataclasses.replace(tm.cfg, retrieve_dtype="input")
    # training and LoRA, ported since: neither raises. Without a mask or
    # embedding dropout the training forward equals the inference one; a
    # zero LoRA delta leaves the finetune embeddings where they were
    for got, want in zip(tm.forward(tparams, training=True),
                         tm.generate(tparams)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    tm.phase, tm.cfg = "finetune", dataclasses.replace(tm.cfg, use_lora=True)
    lora = tm.init_params(torch.Generator().manual_seed(0),
                          pretrained_tables=(tparams["user_embedding"],
                                             tparams["item_embedding"]))
    assert lora["user_lora"].a.shape == (tm.graph.num_users, 16)
    assert float(lora["user_lora"].a.abs().max()) == 0.0
    no_lora = {k: v for k, v in lora.items() if "lora" not in k}
    tm.cfg = dataclasses.replace(tm.cfg, use_lora=False)
    want = tm.generate(no_lora)
    tm.cfg = dataclasses.replace(tm.cfg, use_lora=True)
    for got, ref in zip(tm.generate(lora), want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=F32_ATOL)
