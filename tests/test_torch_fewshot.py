"""The fewshot slice of the port against the JAX package: the prototype
helpers of ``rag/fewshot.py``, the ``nn/prompts.py`` modules with their
parameters carried by ``convert``, the k-shot samplers and their files bit
for bit, and ``RAGraphFewshot``: prototypes at both levels, the library
build from JAX's draws, ``forward_node`` and ``forward_graph`` (one batched
retrieval against JAX's ``vmap``), training-free mode, the noise rows,
both losses with their gradients, and ten AdamW steps against
``optax.adamw`` (with a pin for retrieval's near ties).

Both sides start from the same numbers: the JAX package initialises the
encoder, samples the support and builds the library; the port gets them
through ``convert.fewshot_state_from_jax``. The JAX side's random values
(the query graph's position anchors, the noise rows, the build's draws) are
derived from its keys here and handed to the port as data. The layers get
a bias that is not zero, so that augmented all-zero feature rows still give
distinct keys. Tolerances (f32, another summation order): 2e-5; the
samplers and their files exactly.

Retrieval picks rows by a weighted sum of two cosines, and two kinds of
ties leave the choice to the top-k's order: a node sampled twice into one
library copy gives two equal rows (equal values and labels, so the outputs
agree whichever comes first), and a padding row of a query batch (a zero
embedding and zero position code) scores 0 against every row. Outputs are
compared on the real rows (the losses and accuracies mask the padding);
the ``retrieve`` test holds every index difference to a tie in score
between rows of equal keys, values and labels (their position codes may
differ, where the query's code is zero).
"""

import dataclasses
import functools

import _torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_library import _jax_draws

from ragraph_tpu.data import batching as jbatch
from ragraph_tpu.data import fewshot_export as jexp
from ragraph_tpu.data.synthetic import synthetic_tu_dataset as j_synth
from ragraph_tpu.models import ragraph_fewshot as jfs
from ragraph_tpu.nn import prompts as jprompts
from ragraph_tpu.ops.shortest_path import position_aware_codes as j_pos
from ragraph_tpu.rag import fewshot as jrf
from ragraph_tpu.rag import library as jlib
from ragraph_tpu_torch import convert
from ragraph_tpu_torch.data import batching as tbatch
from ragraph_tpu_torch.data import fewshot_export as texp
from ragraph_tpu_torch.data.synthetic import synthetic_tu_dataset as t_synth
from ragraph_tpu_torch.models import ragraph_fewshot as tfs
from ragraph_tpu_torch.nn import prompts as tprompts
from ragraph_tpu_torch.ops.shortest_path import position_aware_codes
from ragraph_tpu_torch.rag import fewshot as trf
from ragraph_tpu_torch.rag import library as tlib

ATOL = 2e-5
HIDDEN, FEAT, CLASSES = 16, 16, 3
B = 4


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    got = got.detach() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


# ---- rag/fewshot.py -----------------------------------------------------------

def test_prototype_helpers():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(11, 6)).astype(np.float32)
    labels = np.array([0, 2, 2, 0, 3, 3, 3, 0, 2, 0, 3])   # class 1 empty
    mask = rng.random(11) > 0.3
    protos = trf.fewshot_mean_logits(_t(logits), _t(labels), 4)
    want = jrf.fewshot_mean_logits(jnp.asarray(logits), jnp.asarray(labels),
                                   4)
    _close(protos, want, 1e-6)
    assert float(protos[1].abs().sum()) == 0
    q = rng.normal(size=(9, 6)).astype(np.float32)
    _close(trf.fewshot_predict_logits(protos, _t(q)),
           jrf.fewshot_predict_logits(want, jnp.asarray(q)), 1e-6)
    np.testing.assert_array_equal(
        trf.fewshot_predict_labels(protos, _t(q)).numpy(),
        np.asarray(jrf.fewshot_predict_labels(want, jnp.asarray(q))))
    for m in (None, mask):
        _close(trf.fewshot_predict_loss(protos, _t(logits), _t(labels),
                                        None if m is None else _t(m)),
               jrf.fewshot_predict_loss(want, jnp.asarray(logits),
                                        jnp.asarray(labels),
                                        None if m is None else
                                        jnp.asarray(m)), 1e-6)

    # FewShotBase: decode both sides with the same map, cosine, onehot
    w = rng.normal(size=(6, 5)).astype(np.float32)
    base_t = trf.FewShotBase(_t(logits), _t(labels), 4)
    base_j = jrf.FewShotBase(jnp.asarray(logits), jnp.asarray(labels), 4)
    got = base_t(_t(q), lambda x: torch.tanh(x @ _t(w)))
    _close(got, base_j(jnp.asarray(q), lambda x: jnp.tanh(x @ w)), 1e-6)
    assert tuple(got.shape) == (9, 4)


# ---- nn/prompts.py ----------------------------------------------------------

def test_prompt_functions():
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(13, 8)).astype(np.float32)
    labels = rng.integers(0, 5, 13)
    mask = rng.random(13) > 0.4
    for m in (None, mask):
        _close(tprompts.average_emb(_t(emb), _t(labels), 5,
                                    None if m is None else _t(m)),
               jprompts.average_emb(jnp.asarray(emb), jnp.asarray(labels), 5,
                                    None if m is None else jnp.asarray(m)),
               1e-6)
        gid = np.sort(rng.integers(0, 4, 13))
        _close(tprompts.sum_pool_by_graph(_t(emb), _t(gid), 4,
                                          None if m is None else _t(m)),
               jprompts.sum_pool_by_graph(jnp.asarray(emb),
                                          jnp.asarray(gid), 4,
                                          None if m is None
                                          else jnp.asarray(m)), 1e-6)
    centers = rng.normal(size=(3, 8)).astype(np.float32)
    _close(tprompts.distance_to_center(_t(emb), _t(centers)),
           jprompts.distance_to_center(jnp.asarray(emb),
                                       jnp.asarray(centers)), 1e-5)
    np.testing.assert_array_equal(
        tprompts.onehot(_t(labels), 5).numpy(),
        np.asarray(jprompts.onehot(jnp.asarray(labels), 5)))


@pytest.mark.parametrize("use_act", [True, False])
def test_downstream_and_down_prompt(use_act):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(7, 8)).astype(np.float32)
    cent = rng.normal(size=(3, 8)).astype(np.float32)
    jmod = jprompts.DownstreamPrompt(hidden=8, use_act=use_act)
    jvars = jmod.init(jax.random.key(0), jnp.asarray(x))
    tmod = tprompts.DownstreamPrompt(
        8, use_act=use_act, generator=torch.Generator().manual_seed(0))
    assert float(tmod.weight.detach().abs().max()) <= np.sqrt(6.0 / 9.0)
    tmod.load_state_dict(convert.prompt_params_from_jax(_host(jvars)))
    _close(tmod(_t(x)), jmod.apply(jvars, jnp.asarray(x)), 1e-6)

    jdown = jprompts.DownPrompt(hidden=8, num_classes=3)
    dvars = jdown.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(cent))
    tdown = tprompts.DownPrompt(8, 3)
    sd = convert.prompt_params_from_jax(_host(dvars))
    assert sorted(sd) == ["down.weight"]
    tdown.load_state_dict(sd)
    got = tdown(_t(x), _t(cent))
    _close(got, jdown.apply(dvars, jnp.asarray(x), jnp.asarray(cent)), 1e-6)
    _close(got.sum(dim=1), np.ones(7), 1e-6)
    _close(tdown.prompt_features(_t(x)),
           jdown.apply(dvars, jnp.asarray(x),
                       method=jdown.prompt_features), 1e-6)


@pytest.mark.parametrize("n", [2, 3, 5])
def test_weighted_prompt_and_feature(n):
    rng = np.random.default_rng(3)
    prompts = rng.normal(size=(n, 8)).astype(np.float32)
    jmod = jprompts.WeightedPrompt(num_prompts=n)
    jvars = jmod.init(jax.random.key(0), jnp.asarray(prompts))
    tmod = tprompts.WeightedPrompt(n)
    _close(tmod.weight, jvars["params"]["weight"], 0)
    _close(tmod(_t(prompts)), jmod.apply(jvars, jnp.asarray(prompts)), 1e-6)
    # trained weights carry over
    moved = {"params": {"weight": np.asarray(jvars["params"]["weight"])
                        + 0.3}}
    tmod.load_state_dict(convert.prompt_params_from_jax(moved))
    _close(tmod(_t(prompts)), jmod.apply(moved, jnp.asarray(prompts)), 1e-6)

    a, b = (rng.normal(size=(5, 8)).astype(np.float32) for _ in range(2))
    jf = jprompts.WeightedFeature()
    fvars = jf.init(jax.random.key(0), jnp.asarray(a), jnp.asarray(b))
    tf = tprompts.WeightedFeature()
    _close(tf(_t(a), _t(b)), jf.apply(fvars, jnp.asarray(a),
                                      jnp.asarray(b)), 1e-6)
    fvars = {"params": {"weight": np.array([[0.2 * n, -0.7]], np.float32)}}
    tf.load_state_dict(convert.prompt_params_from_jax(fvars))
    _close(tf(_t(a), _t(b)), jf.apply(fvars, jnp.asarray(a),
                                      jnp.asarray(b)), 1e-6)
    with pytest.raises(ValueError, match="prompt parameter"):
        convert.prompt_params_from_jax({"params": {"kernel": a}})


# ---- data/fewshot_export.py ------------------------------------------------

def _datasets(num_graphs=24):
    return j_synth(seed=5, num_graphs=num_graphs), \
        t_synth(seed=5, num_graphs=num_graphs)


@pytest.mark.parametrize("seed,shots", [(0, 5), (3, 2), (7, 40)])
def test_k_shot_samplers_bit_for_bit(seed, shots):
    jds, tds = _datasets()
    want = jexp.sample_k_shot_nodes(jds, shots, 3,
                                    np.random.default_rng(seed))
    got = texp.sample_k_shot_nodes(tds, shots, 3,
                                   np.random.default_rng(seed))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(got[1]) == 3 * min(shots, 40) or shots == 40
    want = jexp.sample_k_shot_graphs(jds, shots, 3,
                                     np.random.default_rng(seed))
    got = texp.sample_k_shot_graphs(tds, shots, 3,
                                    np.random.default_rng(seed))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    feats, adj, labels, lens = got
    assert feats.shape[0] == adj.shape[0] == lens.sum()
    assert len(labels) == len(lens)
    # normalised with self-loops: every diagonal entry is positive
    assert bool((np.diag(adj) > 0).all())


def test_support_files_load_in_either_package(tmp_path):
    jds, tds = _datasets()
    jpaths = jexp.export_fewshot_splits(jds, str(tmp_path / "j"), shots=3,
                                        num_tasks=3, seed=4)
    tpaths = texp.export_fewshot_splits(tds, str(tmp_path / "t"), shots=3,
                                        num_tasks=3, seed=4)
    assert [p.rsplit("/", 1)[1] for p in tpaths] == ["0.npz", "1.npz",
                                                     "2.npz"]
    for jp, tp in zip(jpaths, tpaths):
        for a, b in zip(texp.load_fewshot_split(jp),
                        jexp.load_fewshot_split(tp)):
            np.testing.assert_array_equal(a, b)
    jg = jexp.export_fewshot_graph_split(jds, str(tmp_path / "j" /
                                                  "support.npz"), shots=2)
    tg = texp.export_fewshot_graph_split(tds, str(tmp_path / "t" /
                                                  "support.npz"), shots=2)
    with np.load(jg) as a, np.load(tg) as b:
        assert sorted(a.files) == sorted(b.files) == [
            "adj", "features", "graph_len", "labels"]
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


# ---- the model --------------------------------------------------------------

def _configs(level, finetune=True, noise=False):
    kw = dict(emb_size=HIDDEN, num_class=CLASSES, level=level,
              finetune=finetune, noise_finetune=noise,
              query_graph_hop=3 if level == "node" else 1,
              retrieve_weight=0.4, label_weight=0.6)
    return (jfs.RAGraphFewshotConfig(
                library=jfs.fewshot_library_config(retrieve_num=5), **kw),
            tfs.RAGraphFewshotConfig(
                library=tfs.fewshot_library_config(retrieve_num=5), **kw))


def _jax_support(level, train, rng):
    if level == "node":
        feats, labels, adj = jexp.sample_k_shot_nodes(train, 4, CLASSES, rng)
        gid = None
    else:
        feats, adj, labels, lens = jexp.sample_k_shot_graphs(train, 3,
                                                             CLASSES, rng)
        gid = jnp.asarray(np.repeat(np.arange(len(lens)), lens), jnp.int32)
    return jfs.FewshotSupportSet(features=jnp.asarray(feats),
                                 adj=jnp.asarray(adj),
                                 labels=jnp.asarray(labels, jnp.int32),
                                 graph_ids=gid)


@functools.lru_cache(maxsize=None)
def _jax_state(level):
    """The JAX state: its support set, and a library built from 20 graphs
    (the build reads the library's configuration alone, which every case
    shares, so one build serves all cases of a level)."""
    jcfg, _ = _configs(level)
    jds = j_synth(seed=3, num_graphs=27)
    jtask = jfs.RAGraphFewshot(jcfg, FEAT)
    jstate = jtask.init_state(jax.random.key(1),
                              _jax_support(level, jds.subset(0, .75),
                                           np.random.default_rng(0)),
                              library_capacity=1024)
    params = _host(jstate.encoder_params)
    for i in range(2):
        params["params"]["gcn"][f"conv_{i}"]["bias"] = np.linspace(
            -0.3, 0.4, HIDDEN).astype(np.float32)
    jstate = dataclasses.replace(jstate, encoder_params=params)
    return jtask.build_library(
        jstate, jbatch.stacked_batches(jds.graphs[:20], 8,
                                       num_classes=CLASSES,
                                       num_graph_classes=CLASSES),
        jax.random.key(2))


def _pair(level, finetune=True, noise=False):
    """The JAX task and state (:func:`_jax_state`), the port's task with
    the converted state, and a query batch on each side (block-diagonal at
    the node level, stacked at the graph level, its last graph
    padding)."""
    jcfg, tcfg = _configs(level, finetune, noise)
    jds = j_synth(seed=3, num_graphs=27)
    jtask = jfs.RAGraphFewshot(jcfg, FEAT)
    jstate = _jax_state(level)
    ttask = tfs.RAGraphFewshot(tcfg, FEAT, device="cpu")
    tstate = convert.fewshot_state_from_jax(jstate, "cpu")
    tds = t_synth(seed=3, num_graphs=27)
    if level == "node":
        jb = next(jbatch.flat_batches(jds.graphs[20:], B,
                                      num_classes=CLASSES))
        tb = next(tbatch.flat_batches(tds.graphs[20:], B,
                                      num_classes=CLASSES))
    else:
        jb = next(jbatch.stacked_batches(jds.graphs[24:], B,
                                         num_classes=CLASSES,
                                         num_graph_classes=CLASSES))
        tb = next(tbatch.stacked_batches(tds.graphs[24:], B,
                                         num_classes=CLASSES,
                                         num_graph_classes=CLASSES))
    return jtask, jstate, ttask, tstate, jb, tb


def _choice(k_pos, mask, num_anchors):
    """The anchors JAX's ``position_aware_codes`` draws from ``k_pos``."""
    probs = mask.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    return jax.random.choice(k_pos, mask.shape[0], shape=(num_anchors,),
                             p=probs)


def _draws(key, mask, fill, lcfg):
    """JAX's anchors and noise rows for one forward: ``key`` None is the
    evaluation's fixed ``key(0)``; a 2-d ``mask`` is a stacked batch, one
    key per graph."""
    def one(k, m):
        if k is None:
            return _choice(jax.random.key(0), m, lcfg.num_anchors), None
        k_pos, k_noise = jax.random.split(k)
        noise = jax.random.randint(k_noise, (m.shape[0],
                                             lcfg.noise_retrieve_num),
                                   0, max(fill, 1))
        return _choice(k_pos, m, lcfg.num_anchors), noise
    if mask.ndim == 1:
        a, n = one(key, mask)
        return {"anchors": _t(a), "noise_idx": None if n is None else _t(n)}
    keys = [None] * mask.shape[0] if key is None \
        else list(jax.random.split(key, mask.shape[0]))
    outs = [one(k, m) for k, m in zip(keys, mask)]
    return {"anchors": _t(np.stack([a for a, _ in outs])),
            "noise_idx": None if key is None else
            _t(np.concatenate([n for _, n in outs]))}


def _jmask(level, jb):
    return jb.node_mask if level == "node" else jb["node_mask"]


def _real(level, tb, got, want):
    """The rows of ``got`` and ``want`` that are not padding: every row of
    a graph-level output (the padding graph's is zero), the real nodes of
    a node-level one."""
    if level == "graph":
        return got, want
    return got[tb.node_mask], np.asarray(want)[tb.node_mask.numpy()]


def _forwards(level, jtask, ttask):
    if level == "node":
        return jtask.forward_node, ttask.forward_node
    return jtask.forward_graph, ttask.forward_graph


@pytest.mark.parametrize("level", ["node", "graph"])
def test_prototypes(level):
    jtask, jstate, ttask, tstate, _, _ = _pair(level)
    want = jtask.prototypes(jstate.encoder_params, jstate.support)
    got = ttask.prototypes(tstate)
    assert tuple(got.shape) == (CLASSES, HIDDEN)
    _close(got, want)
    assert got.requires_grad
    if level == "graph":
        # per support graph first: not the plain per-class node mean
        sup = tstate.support
        flat = trf.fewshot_mean_logits(
            tstate.encoder.inference(sup.features, sup.adj),
            sup.labels[sup.graph_ids], CLASSES)
        assert float((flat - got).detach().abs().max()) > 1e-4


@pytest.mark.parametrize("level", ["node", "graph"])
def test_port_builds_the_same_library(level):
    """The port's build from the converted encoder with JAX's draws (the
    key of batch ``i`` is ``fold_in(key, i)``): the same rows, keyed by
    layer 1, 20 graphs x 4 copies x 10 samples."""
    jtask, jstate, ttask, tstate, _, _ = _pair(level)
    jds = j_synth(seed=3, num_graphs=27)
    tds = t_synth(seed=3, num_graphs=27)
    jbs = list(jbatch.stacked_batches(jds.graphs[:20], 8,
                                      num_classes=CLASSES,
                                      num_graph_classes=CLASSES))
    draws = [_jax_draws(jax.random.fold_in(jax.random.key(2), i), b,
                        jtask.cfg.library) for i, b in enumerate(jbs)]
    fresh = dataclasses.replace(tstate, library=tlib.library_init(
        1024, HIDDEN, CLASSES, 10))
    built = ttask.build_library(
        fresh, tbatch.stacked_batches(tds.graphs[:20], 8,
                                      num_classes=CLASSES,
                                      num_graph_classes=CLASSES),
        draws_per_batch=draws)
    n = int(jstate.library.fill)
    assert int(built.library.fill) == n == 20 * 4 * 10
    for name in ("keys", "values", "labels", "positions"):
        _close(getattr(built.library, name)[:n],
               getattr(jstate.library, name)[:n])
    # keys come from layer 1 alone
    b0 = next(tbatch.stacked_batches(tds.graphs[:8], 8,
                                     num_classes=CLASSES))
    enc = tstate.encoder.encode(b0["features"], b0["adj"], b0["node_mask"])
    assert enc.shape[-1] == HIDDEN
    assert not torch.equal(enc, tstate.encoder.inference(
        b0["features"], b0["adj"], b0["node_mask"]))


def test_structure_retrieve_matches_jax():
    """The structure branch the fewshot path takes: the same retrieved
    values and labels, and where the indices differ the two picks tie in
    score within f32 rounding."""
    jtask, jstate, ttask, tstate, jb, tb = _pair("node")
    lcfg = jtask.cfg.library
    emb = jtask._encode(jstate.encoder_params, jb.features, jb.adj,
                        jb.node_mask)
    pos = j_pos(jb.adj, jax.random.key(4), jb.node_mask,
                num_anchors=lcfg.num_anchors, dis_q=lcfg.dis_q)
    want_e, want_l = jlib.retrieve(jstate.library, emb, lcfg,
                                   search_positions=pos)
    t_emb = ttask._encode(tstate, tb.features, tb.adj, tb.node_mask)
    anchors = _t(_choice(jax.random.key(4), jb.node_mask, lcfg.num_anchors))
    t_pos = position_aware_codes(tb.adj, tb.node_mask, lcfg.num_anchors,
                                 lcfg.dis_q, anchors=anchors)
    _close(t_pos, pos, 1e-6)
    assert float(t_pos.abs().sum()) > 0
    got_e, got_l = tlib.retrieve(tstate.library, t_emb, tfs.
                                 fewshot_library_config(retrieve_num=5),
                                 search_positions=t_pos)
    real = tb.node_mask
    _close(got_e[real], np.asarray(want_e)[real.numpy()])
    np.testing.assert_array_equal(got_l[real].numpy(),
                                  np.asarray(want_l)[real.numpy()])
    # the picks by index: where they differ, the two rows are equal
    lib = tstate.library
    keys, _, _, positions = lib.live()
    sc = 0.001 * (tlib.l2_normalize(t_pos)
                  @ tlib.l2_normalize(positions).T) \
        + 0.999 * (tlib.l2_normalize(t_emb) @ tlib.l2_normalize(keys).T)
    sc = torch.where(lib.valid_mask[None, :], sc, -torch.inf)
    got_i = torch.topk(sc, 5, dim=1).indices[real]
    jsc = np.asarray(jnp.where(
        jnp.arange(lib.capacity)[None, :] < jstate.library.fill,
        0.001 * (jlib.l2_normalize(pos)
                 @ jlib.l2_normalize(jstate.library.positions[:1024]).T)
        + 0.999 * (jlib.l2_normalize(emb)
                   @ jlib.l2_normalize(jstate.library.keys[:1024]).T),
        -jnp.inf))
    want_i = np.asarray(jax.lax.top_k(jsc, 5)[1])[real.numpy()]
    diff = got_i.numpy() != want_i
    assert diff.sum() < diff.size // 2
    sc_real = sc[real]
    for r, a, b in zip(np.nonzero(diff)[0], got_i.numpy()[diff],
                       want_i[diff]):
        assert abs(float(sc_real[r, a]) - float(sc_real[r, b])) <= 1e-6
        for arr in (lib.keys, lib.values, lib.labels):
            assert torch.equal(arr[a], arr[b])


@pytest.mark.parametrize("level", ["node", "graph"])
@pytest.mark.parametrize("finetune", [False, True])
@pytest.mark.parametrize("training", [False, True])
def test_forward(level, finetune, training):
    """Evaluation (JAX's fixed ``key(0)`` anchors) and a training forward
    (anchors from the step's key) in both modes; at the graph level one
    retrieval for the whole stacked batch against JAX's per-graph
    ``vmap``."""
    jtask, jstate, ttask, tstate, jb, tb = _pair(level, finetune)
    jfwd, tfwd = _forwards(level, jtask, ttask)
    key = jax.random.key(7) if training else None
    want = jfwd(jstate, jb, training=training, key=key)
    draws = _draws(key, _jmask(level, jb), int(jstate.library.fill),
                   jtask.cfg.library)
    with torch.no_grad():
        got = tfwd(tstate, tb, training=training, **draws)
        rows = B if level == "graph" else tb.features.shape[0]
        assert tuple(got.shape) == tuple(want.shape) == (rows, HIDDEN)
        _close(*_real(level, tb, got, want))
        if not training:
            # the port's own fixed draw: deterministic, finite
            a, b = tfwd(tstate, tb), tfwd(tstate, tb)
            assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    acc_fn = ttask.accuracy_node if level == "node" else ttask.accuracy_graph
    jacc_fn = jtask.accuracy_node if level == "node" \
        else jtask.accuracy_graph
    if not training:
        assert 0.0 <= acc_fn(tstate, [tb]) <= 1.0
        assert 0.0 <= jacc_fn(jstate, [jb]) <= 1.0


@pytest.mark.parametrize("level", ["node", "graph"])
def test_forward_with_noise_rows(level):
    """``noise_finetune`` in training: twice the rows plus JAX's noise
    rows; without draws or a generator it raises; a generator draws its
    own."""
    jtask, jstate, ttask, tstate, jb, tb = _pair(level, noise=True)
    jfwd, tfwd = _forwards(level, jtask, ttask)
    key = jax.random.key(11)
    want = jfwd(jstate, jb, training=True, key=key)
    draws = _draws(key, _jmask(level, jb), int(jstate.library.fill),
                   jtask.cfg.library)
    with torch.no_grad():
        _close(*_real(level, tb, tfwd(tstate, tb, training=True, **draws),
                      want))
        with pytest.raises(ValueError, match="generator"):
            tfwd(tstate, tb, training=True, anchors=draws["anchors"])
        got = tfwd(tstate, tb, training=True,
                   generator=torch.Generator().manual_seed(0))
        assert bool(torch.isfinite(got).all())
        # evaluation adds no noise
        eval_draws = _draws(None, _jmask(level, jb), 0, jtask.cfg.library)
        _close(*_real(level, tb, tfwd(tstate, tb, **eval_draws),
                      jfwd(jstate, jb)))


def _grad_pairs(jgrads, tstate):
    named = dict(tstate.encoder.named_parameters())
    g = convert.preprompt_params_from_jax(_host(jgrads))
    return [(k, v, named[k]) for k, v in g.items()]


@pytest.mark.parametrize("level", ["node", "graph"])
@pytest.mark.parametrize("finetune,noise", [(False, False), (True, False),
                                            (True, True)])
def test_loss_and_gradients(level, finetune, noise):
    """Gradients reach layer 1 through the prototypes (the retrieval keys
    run without gradients) and layer 2 also through the decode; without
    ``finetune`` only the prototypes carry them."""
    jtask, jstate, ttask, tstate, jb, tb = _pair(level, finetune, noise)
    key = jax.random.key(13)
    jloss = jtask.loss_node if level == "node" else jtask.loss_graph
    tloss = ttask.loss_node if level == "node" else ttask.loss_graph

    def loss_fn(p):
        return jloss(dataclasses.replace(jstate, encoder_params=p), jb, key)
    want, jgrads = jax.value_and_grad(loss_fn)(jstate.encoder_params)
    draws = _draws(key, _jmask(level, jb), int(jstate.library.fill),
                   jtask.cfg.library)
    loss = tloss(tstate, tb, **draws)
    _close(loss.detach(), want, 1e-6)
    loss.backward()
    pairs = _grad_pairs(jgrads, tstate)
    assert len(pairs) == 6      # two layers: weight, bias, slope
    for name, jgrad, prm in pairs:
        assert prm.grad is not None, name
        _close(prm.grad, jgrad, 1e-5)
    assert float(tstate.encoder.gcn.convs[1].lin.weight.grad.abs().max()) > 0
    assert not tstate.library.keys.requires_grad


def _boundary_gap(ttask, tstate, tb, anchors, k):
    """The smallest score gap, over the batch's real nodes, between the
    port's k-th and (k+1)-th retrieved rows where those two rows differ in
    value or label (a swap of equal rows changes nothing)."""
    lcfg = ttask.cfg.library
    g = tb if isinstance(tb, dict) else dataclasses.asdict(tb)
    f, a, m = g["features"], g["adj"], g["node_mask"]
    with torch.no_grad():
        emb = ttask._encode(tstate, f, a, m).reshape(-1, HIDDEN)
        pos = position_aware_codes(a, m, lcfg.num_anchors, lcfg.dis_q,
                                   anchors=anchors).reshape(emb.shape[0], -1)
        keys, values, labels, positions = tstate.library.live()
        sc = lcfg.structure_weight * (tlib.l2_normalize(pos)
                                      @ tlib.l2_normalize(positions).T) \
            + lcfg.semantic_weight * (tlib.l2_normalize(emb)
                                      @ tlib.l2_normalize(keys).T)
        sc = torch.where(tstate.library.valid_mask[None, :], sc, -torch.inf)
        top, idx = torch.topk(sc, k + 1, dim=1)
    a_i, b_i = idx[:, k - 1], idx[:, k]
    equal = (values[a_i] == values[b_i]).all(1) \
        & (labels[a_i] == labels[b_i]).all(1)
    gap = torch.where(equal | ~m.reshape(-1), torch.inf,
                      top[:, k - 1] - top[:, k])
    return float(gap.min())


def _load_jax_adamw(tstate, optimizer, jparams, opt_state):
    """The JAX side's parameters and AdamW moments, into the port."""
    adam = opt_state[0]
    named = dict(tstate.encoder.named_parameters())
    with torch.no_grad():
        for k, v in convert.preprompt_params_from_jax(
                _host(jparams)).items():
            named[k].copy_(v)
    mu = convert.preprompt_params_from_jax(_host(adam.mu))
    nu = convert.preprompt_params_from_jax(_host(adam.nu))
    for k in mu:
        st = optimizer.state[named[k]]
        st["exp_avg"].copy_(mu[k])
        st["exp_avg_sq"].copy_(nu[k])
        st["step"].fill_(int(adam.count))


# Two retrieved rows whose scores lie within this gap may come back in
# either order: the two packages' f32 scores differ by about 4e-7 (another
# summation order), and more once the parameters have drifted by 1e-6.
TIE_GAP = 2e-6


@pytest.mark.parametrize("level", ["node", "graph"])
@pytest.mark.parametrize("noise", [False, True])
def test_ten_adamw_steps_match_optax(level, noise):
    """Ten AdamW steps against ``optax.adamw``: each step's loss, and the
    parameters after it. A step whose retrieval has a near tie at the k
    boundary (two different rows within ``TIE_GAP``) may retrieve another
    row on either side, which moves that step's loss by about 5e-5: such a
    step is recorded, its loss not compared, and the port takes the JAX
    side's parameters and moments after it, so that each later step is
    held from the same start. At most two of ten steps may be such."""
    jtask, jstate, ttask, tstate, jb, tb = _pair(level, noise=noise)
    lr, wd = 1e-2, 1e-2
    opt = optax.adamw(lr, weight_decay=wd)
    step = jtask.make_train_step_node(opt) if level == "node" \
        else jtask.make_train_step_graph(opt)
    opt_state = opt.init(jstate.encoder_params)
    optimizer = ttask.make_optimizer(tstate, lr, wd)
    assert isinstance(optimizer, torch.optim.AdamW)
    k = (2 if noise else 1) * ttask.cfg.library.retrieve_num
    losses, tie_steps = [], []
    for i in range(10):
        key = jax.random.fold_in(jax.random.key(5), i)
        draws = _draws(key, _jmask(level, jb), int(jstate.library.fill),
                       jtask.cfg.library)
        near_tie = _boundary_gap(ttask, tstate, tb, draws["anchors"],
                                 k) < TIE_GAP
        jstate, opt_state, want = step(jstate, opt_state, jb, key)
        got = ttask.train_step(tstate, optimizer, tb, **draws)
        losses.append(float(got))
        if near_tie:
            tie_steps.append(i)
            _load_jax_adamw(tstate, optimizer, jstate.encoder_params,
                            opt_state)
            continue
        _close(got, want, 1e-5)
        want_sd = convert.preprompt_params_from_jax(
            _host(jstate.encoder_params))
        sd = tstate.encoder.state_dict()
        for name, v in want_sd.items():
            _close(sd[name], v, ATOL)
    assert len(tie_steps) <= 2, tie_steps
    assert losses[-1] < losses[0]


def test_state_conversion_and_defaults():
    jtask, jstate, ttask, tstate, _, _ = _pair("graph")
    assert tstate.encoder.num_layers == 2 and tstate.encoder.hidden == HIDDEN
    assert tstate.library.capacity == 1024
    assert int(tstate.library.fill) == int(jstate.library.fill)
    np.testing.assert_array_equal(tstate.support.graph_ids.numpy(),
                                  np.asarray(jstate.support.graph_ids))
    np.testing.assert_array_equal(tstate.support.labels.numpy(),
                                  np.asarray(jstate.support.labels))
    assert tfs.FEWSHOT_NODE_WEIGHTS == jfs.FEWSHOT_NODE_WEIGHTS
    assert tfs.FEWSHOT_GRAPH_WEIGHTS == jfs.FEWSHOT_GRAPH_WEIGHTS
    assert dataclasses.asdict(tfs.fewshot_library_config(7, dis_q=3)) \
        == dataclasses.asdict(jfs.fewshot_library_config(7, dis_q=3))
    jc, tc = jfs.RAGraphFewshotConfig(), tfs.RAGraphFewshotConfig()
    for f in dataclasses.fields(jc):
        if f.name != "library":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    with pytest.raises(ValueError, match="encoder_layers"):
        tfs.RAGraphFewshot(tfs.RAGraphFewshotConfig(encoder_layers=1), FEAT,
                           device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tfs.RAGraphFewshot(tfs.RAGraphFewshotConfig(), FEAT)
    # a fresh state from a generator: a two-layer encoder and an empty store
    fresh = ttask.init_state(torch.Generator().manual_seed(0),
                             tstate.support, library_capacity=64)
    assert int(fresh.library.fill) == 0 and fresh.encoder.num_layers == 2
