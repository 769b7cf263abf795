"""Node pretraining of the port against the JAX package: the discriminators,
the dense GAT and the heads, ``compare_loss`` and ``_masked_bce``, the DGI
corruption and each GraphCL augmentation fed JAX's draws, the Lp tuple
sampler bit for bit, the Lp, DGI and GraphCL losses with every gradient,
ten Adam steps of ``lp+dgi+graphcl:subgraph`` against optax, the heads'
conversion, and the ``pretrain`` CLI.

Every random value of the JAX side is handed to the port as data: uniforms,
Gumbel noise and walk centres are drawn from the JAX keys the JAX functions
derive; the dropout masks of the Lp loss are read off flax's intermediates
(a kept entry is a non-zero output or a zero input). Tolerances (f32, other
summation orders): 1e-6 on outputs of order 1, 1e-5 on losses, 2e-6 on
gradients; selections (masks, memberships, permutations, tuples) exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ragraph_tpu.cli import node as j_cli
from ragraph_tpu.data import batching as jbatch
from ragraph_tpu.models import preprompt as jpp
from ragraph_tpu.nn import heads as jheads
from ragraph_tpu.nn import layers as jlayers
from ragraph_tpu.rag import pretrain_aug as jaug
from ragraph_tpu_torch.cli import node as t_cli
from ragraph_tpu_torch.convert import preprompt_params_from_jax
from ragraph_tpu_torch.data import batching as tbatch
from ragraph_tpu_torch.data.synthetic import synthetic_tu_dataset
from ragraph_tpu_torch.models import preprompt as tpp
from ragraph_tpu_torch.nn import heads as theads
from ragraph_tpu_torch.nn import layers as tlayers
from ragraph_tpu_torch.rag import pretrain_aug as taug
from ragraph_tpu_torch.train.checkpoint import restore_checkpoint

HIDDEN, FEAT = 16, 16
FLAVORS = ("edge", "mask", "node", "subgraph")


def _t(a):
    return torch.from_numpy(np.array(a))


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=atol)


def _batch(num_graphs=4, seed=2):
    """One block-diagonal batch on both sides, and its raw adjacency."""
    ds = synthetic_tu_dataset(seed=seed, num_graphs=num_graphs,
                              max_nodes=14)
    jg, raw = next(jbatch.flat_batches(ds.graphs, num_graphs,
                                       with_host_adj=True))
    tg = next(tbatch.flat_batches(ds.graphs, num_graphs))
    return jg, tg, raw


# ---- layers and heads -------------------------------------------------------

@pytest.mark.parametrize("two", [False, True])
def test_bilinear_discriminators(two):
    rng = np.random.default_rng(0)
    n, h = 9, 8
    c = rng.normal(size=(n, h) if two else (h,)).astype(np.float32)
    hp, hm = (rng.normal(size=(n, h)).astype(np.float32) for _ in range(2))
    b1, b2 = (rng.normal(size=(n,)).astype(np.float32) for _ in range(2))
    jmod = (jlayers.BilinearDiscriminator2 if two
            else jlayers.BilinearDiscriminator)(h)
    variables = _host(jmod.init(jax.random.key(0), c, hp, hm))
    variables["params"]["bilinear_b"] = np.float32(0.3)
    tmod = (tlayers.BilinearDiscriminator2 if two
            else tlayers.BilinearDiscriminator)(h)
    assert tuple(tmod.bilinear_b.shape) == ()
    tmod.load_state_dict({k: _t(v) for k, v in variables["params"].items()})
    for bias in ((None, None), (b1, b2)):
        want = jmod.apply(variables, c, hp, hm, *bias)
        with torch.no_grad():
            got = tmod(_t(c), _t(hp), _t(hm),
                       *(None if b is None else _t(b) for b in bias))
        assert tuple(got.shape) == (2 * n,)
        _close(got, want)


@pytest.mark.parametrize("heads,training", [(1, False), (2, False),
                                            (2, True)])
def test_dense_gat(heads, training):
    """Deterministic, and in training with JAX's attention dropout mask (a
    kept entry is a non-zero output; the dropped and the masked-out pairs
    are zero either way)."""
    jg, tg, _ = _batch()
    jmod = jlayers.DenseGAT(features=8, num_heads=heads, dropout=0.4)
    variables = _host(jmod.init(jax.random.key(1), jg.features, jg.adj,
                                jg.node_mask))
    tmod = tlayers.DenseGAT(FEAT, 8, num_heads=heads, dropout=0.4)
    tmod.load_state_dict({k: _t(v) for k, v in variables["params"].items()})
    if not training:
        want = jmod.apply(variables, jg.features, jg.adj, jg.node_mask)
        with torch.no_grad():
            got = tmod(tg.features, tg.adj, tg.node_mask)
    else:
        want, inter = jmod.apply(
            variables, jg.features, jg.adj, jg.node_mask,
            deterministic=False, rngs={"dropout": jax.random.key(5)},
            capture_intermediates=True, mutable=["intermediates"])
        dropped = np.asarray(inter["intermediates"]["Dropout_0"]
                             ["__call__"][0])
        with torch.no_grad():
            got = tmod(tg.features, tg.adj, tg.node_mask,
                       deterministic=False, drop_mask=_t(dropped != 0))
        with pytest.raises(ValueError, match="generator"):
            tmod(tg.features, tg.adj, tg.node_mask, deterministic=False)
    assert tuple(got.shape) == (128, 8 * heads)
    _close(got, want)
    assert float(got[~tg.node_mask].abs().sum()) == 0


def _head_pair(name, jmod, *args):
    """A JAX head, its variables, and the port's head loaded with them
    through the ``PrePrompt`` converter."""
    variables = _host(jmod.init(jax.random.key(3), *args))
    state = preprompt_params_from_jax(
        {"params": {"gcn": {}, name: variables["params"]}})
    tmod = {"lp": theads.LpHead, "dgi": theads.DGIHead,
            "graphcl_edge": theads.GraphCLHead}[name](HIDDEN)
    tmod.load_state_dict({k.partition(".")[2]: v for k, v in state.items()})
    return variables, tmod


def test_pretraining_heads():
    rng = np.random.default_rng(4)
    n = 12
    hs = [rng.normal(size=(n, HIDDEN)).astype(np.float32) for _ in range(4)]
    mask = np.arange(n) < 9
    m1, m2 = mask & (np.arange(n) % 3 != 0), mask & (np.arange(n) % 4 != 1)
    th = [_t(h) for h in hs]

    jlp = jheads.LpHead(HIDDEN)
    v, tlp = _head_pair("lp", jlp, hs[0])
    assert tuple(tlp.prompt.shape) == (1, HIDDEN)
    _close(tlp(th[0]).detach(), jlp.apply(v, hs[0]))

    jdgi = jheads.DGIHead(HIDDEN)
    v, tdgi = _head_pair("dgi", jdgi, hs[0], hs[1], mask)
    for msk in (None, mask):
        want = jdgi.apply(v, hs[0], hs[1], msk)
        got = tdgi(th[0], th[1], None if msk is None else _t(msk))
        _close(got.detach(), want)

    jcl = jheads.GraphCLHead(HIDDEN)
    v, tcl = _head_pair("graphcl_edge", jcl, *hs, mask)
    for views in (None, (m1, m2)):
        want = jcl.apply(v, *hs, mask, view_masks=views)
        got = tcl(*th, _t(mask), view_masks=None if views is None
                  else tuple(_t(x) for x in views))
        _close(got.detach(), want)


def test_logreg():
    x = np.random.default_rng(5).normal(size=(7, HIDDEN)).astype(np.float32)
    jmod = jheads.LogReg(3)
    variables = _host(jmod.init(jax.random.key(6), x))
    tmod = theads.LogReg(HIDDEN, 3, generator=torch.Generator().manual_seed(0))
    assert float(tmod.dense.bias.detach().abs().sum()) == 0
    dense = variables["params"]["Dense_0"]
    tmod.load_state_dict({"dense.weight": _t(dense["kernel"]).T,
                          "dense.bias": _t(dense["bias"])})
    _close(tmod(_t(x)).detach(), jmod.apply(variables, x))


# ---- losses -----------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_compare_loss_and_gradient(masked):
    rng = np.random.default_rng(7)
    n = 20
    feats = rng.normal(size=(n, HIDDEN)).astype(np.float32)
    tuples = rng.integers(0, n, size=(n, 6)).astype(np.int32)
    mask = None
    if masked:      # padding rows: all zero, their tuples point at themselves
        mask = np.arange(n) < 17
        feats[17:] = 0.0
        tuples[:17] %= 17
        tuples[17:] = np.arange(17, n)[:, None]

    def jloss(f):
        return jheads.compare_loss(f, tuples, 1.5,
                                   None if mask is None else jnp.asarray(mask))
    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(feats))
    tf = _t(feats).requires_grad_(True)
    got = theads.compare_loss(tf, _t(tuples), 1.5,
                              None if mask is None else _t(mask))
    got.backward()
    _close(got.detach(), want, 1e-5)
    _close(tf.grad, jgrad, 2e-6)
    assert bool(torch.isfinite(tf.grad).all())


@pytest.mark.parametrize("masked", [False, True])
def test_masked_bce(masked):
    rng = np.random.default_rng(8)
    logits = (3 * rng.normal(size=(24,))).astype(np.float32)
    mask = (np.arange(12) % 5 != 4) if masked else None
    want = jpp._masked_bce(jnp.asarray(logits),
                           None if mask is None else jnp.asarray(mask))
    got = tpp._masked_bce(_t(logits), None if mask is None else _t(mask))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_corrupt_features(masked):
    """The shuffle with JAX's Gumbel noise (masked: padding rows stay in
    place, real rows permute among themselves) or JAX's permutation: the
    same rows, exactly."""
    jg, tg, _ = _batch()
    key = jax.random.key(9)
    n = jg.features.shape[0]
    if masked:
        want = jpp.corrupt_features(key, jg.features, jg.node_mask)
        got = tpp.corrupt_features(tg.features, tg.node_mask,
                                   noise=_t(jax.random.gumbel(key, (n,))))
        real = tg.node_mask
        assert torch.equal(got[~real], tg.features[~real])
    else:
        want = jpp.corrupt_features(key, jg.features)
        got = tpp.corrupt_features(tg.features,
                                   perm=_t(jax.random.permutation(key, n)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # drawn from a generator: the same rows in another order
    drawn = tpp.corrupt_features(tg.features, tg.node_mask,
                                 torch.Generator().manual_seed(0))
    assert torch.equal(torch.sort(drawn[:, 0]).values,
                       torch.sort(tg.features[:, 0]).values)
    assert not torch.equal(drawn, tg.features)


# ---- augmentations ----------------------------------------------------------

def _jax_view_draws(key, flavor, mask):
    """The draws JAX's augmentation of ``flavor`` takes from ``key``
    (``rag/pretrain_aug.py``)."""
    n = mask.shape[0]
    if flavor in ("mask", "node"):
        return {"u": _t(jax.random.uniform(key, (n,)))}
    if flavor == "edge":
        k_drop, k_add = jax.random.split(key)
        return {"u_drop": _t(jax.random.uniform(k_drop, (n, n))),
                "u_add": _t(jax.random.uniform(k_add, (n, n)))}
    k_center, k_loop = jax.random.split(key)
    maskf = mask.astype(jnp.float32)
    probs = maskf / jnp.maximum(maskf.sum(), 1.0)
    center = jax.random.choice(k_center, n, p=probs)
    gumbel = np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(k_loop, i), (n,))) for i in range(n)])
    return {"center": _t(center), "gumbel": _t(gumbel)}


def _jax_views_draws(key, flavor, mask):
    k1, k2 = jax.random.split(key)
    return (_jax_view_draws(k1, flavor, mask),
            _jax_view_draws(k2, flavor, mask))


def _same_views(got, want):
    for (gf, ga, gm), (wf, wa, wm) in zip(got, want):
        _close(gf, wf, 0)
        _close(ga, wa, 1e-6)
        np.testing.assert_array_equal(
            np.asarray(gm) if gm is not None else None,
            np.asarray(wm) if wm is not None else None)


def test_augmentation_applies():
    """Each augmentation's apply on JAX's draws, on the normalised batch
    adjacency the CLI hands in: the same masks exactly, the same values."""
    jg, tg, _ = _batch()
    key = jax.random.key(10)
    f, a, m = jg.features, jg.adj, jg.node_mask
    tf, ta, tm = tg.features, tg.adj, tg.node_mask
    d = _jax_view_draws(key, "mask", m)
    _close(taug.aug_random_mask(tf, d["u"], 0.2, tm),
           jaug.aug_random_mask(key, f, 0.2, m), 0)
    d = _jax_view_draws(key, "edge", m)
    want = jaug.aug_random_edge(key, a, 0.2, m)
    got = taug.aug_random_edge(ta, d["u_drop"], d["u_add"], 0.2, tm)
    _close(got, want, 0)
    assert torch.equal(got, got.T)
    d = _jax_view_draws(key, "node", m)
    for g, w in zip(taug.aug_drop_node(tf, ta, d["u"], 0.2, tm),
                    jaug.aug_drop_node(key, f, a, 0.2, m)):
        _close(g, w, 0)
    d = _jax_view_draws(key, "subgraph", m)
    got = taug.aug_subgraph(tf, ta, d["center"], d["gumbel"], 0.2, tm)
    want = jaug.aug_subgraph(key, f, a, 0.2, m)
    for g, w in zip(got, want):
        _close(g, w, 0)
    # the walk stops at floor(0.8 * real nodes) or an exhausted frontier
    assert 0 < int(got[2].sum()) <= int(0.8 * int(tm.sum()))


@pytest.mark.parametrize("normalize", (True, False))
@pytest.mark.parametrize("flavor", FLAVORS)
def test_make_graphcl_views(flavor, normalize):
    jg, tg, _ = _batch()
    key = jax.random.key(11)
    want = jaug.make_graphcl_views(key, flavor, jg.features, jg.adj,
                                   jg.node_mask, normalize=normalize)
    got = taug.make_graphcl_views(flavor, tg.features, tg.adj, tg.node_mask,
                                  _jax_views_draws(key, flavor, jg.node_mask),
                                  normalize=normalize)
    _same_views(got, want)
    drawn = tuple(taug.draw_view(torch.Generator().manual_seed(1), flavor,
                                 tg.node_mask) for _ in range(2))
    for f, a, m in taug.make_graphcl_views(flavor, tg.features, tg.adj,
                                           tg.node_mask, drawn):
        assert f.shape == tg.features.shape and a.shape == tg.adj.shape
        assert bool(torch.isfinite(a).all())
    with pytest.raises(ValueError, match="flavor"):
        taug.draw_view(torch.Generator(), "bogus", tg.node_mask)


def test_prompt_pretrain_sample_bit_for_bit():
    _, _, raw = _batch(6)
    raw = raw > 0
    np.fill_diagonal(raw, False)
    mask = np.zeros(raw.shape[0], bool)
    mask[:int(raw.any(1).nonzero()[0].max()) + 1] = True
    for n_neg, m in ((5, mask), (100, mask), (7, None)):
        want = jpp.prompt_pretrain_sample(raw.astype(np.float32), n_neg,
                                          np.random.default_rng(3), m)
        got = tpp.prompt_pretrain_sample(raw.astype(np.float32), n_neg,
                                         np.random.default_rng(3), m)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


# ---- the PrePrompt losses and gradients -------------------------------------

def _preprompt_pair(layers=1):
    jg, tg, raw = _batch()
    jmod = jpp.PrePrompt(hidden=HIDDEN, num_layers=layers)
    variables = _host(dict(jmod.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jg.features, jg.adj, jnp.zeros((128, 3), jnp.int32), jg.node_mask,
        method=jmod.init_all)))
    tmod = tpp.PrePrompt(FEAT, HIDDEN, layers)
    tmod.load_state_dict(preprompt_params_from_jax(variables))
    raw = raw > 0
    np.fill_diagonal(raw, False)
    tuples = jpp.prompt_pretrain_sample(raw.astype(np.float32), 20,
                                        np.random.default_rng(0),
                                        np.asarray(jg.node_mask))
    return jmod, variables, tmod, jg, tg, tuples


def _jax_drop_masks(jmod, variables, jg, tuples, key):
    """The keep masks of the Lp loss's dropout under ``key``, one per
    layer: a non-zero output, or a zero input (padding rows)."""
    _, inter = jmod.apply(variables, jg.features, jg.adj, tuples,
                          jg.node_mask, rngs={"dropout": key},
                          capture_intermediates=True,
                          mutable=["intermediates"])
    gcn = inter["intermediates"]["gcn"]
    outs = gcn["drop"]["__call__"]
    return [_t((np.asarray(o) != 0) | (np.asarray(gcn[f"bn_{i}"]
                                                  ["__call__"][0]) == 0))
            for i, o in enumerate(outs)]


def _check_grads(jgrads, tmod, atol=2e-6):
    """Every JAX gradient against the port's (None counts as zero)."""
    want = preprompt_params_from_jax({"params": _host(jgrads)})
    named = dict(tmod.named_parameters())
    assert set(want) == set(named)
    nonzero = 0
    for k, w in want.items():
        g = named[k].grad
        g = torch.zeros_like(named[k]) if g is None else g
        _close(g, w, atol)
        nonzero += float(np.abs(np.asarray(w)).max()) > 0
    return nonzero


@pytest.mark.parametrize("layers", [1, 2])
def test_lp_loss_and_gradients(layers):
    """GCN in LP mode (batch statistics, JAX's dropout masks), ELU,
    ``compare_loss`` at temperature 1.5."""
    jmod, variables, tmod, jg, tg, tuples = _preprompt_pair(layers)
    key = jax.random.key(12)
    masks = _jax_drop_masks(jmod, variables, jg, tuples, key)
    assert len(masks) == layers and not bool(masks[0].all())

    def loss_fn(p):
        return jmod.apply({**variables, "params": p}, jg.features, jg.adj,
                          tuples, jg.node_mask, rngs={"dropout": key})
    want, jgrads = jax.value_and_grad(loss_fn)(variables["params"])
    got = tmod(tg.features, tg.adj, _t(tuples), tg.node_mask,
               drop_masks=masks)
    got.backward()
    _close(got.detach(), want, 1e-5)
    # the conv, PReLU and batch-norm parameters of every layer
    assert _check_grads(jgrads, tmod) == 5 * layers
    with pytest.raises(ValueError, match="generator"):
        tmod(tg.features, tg.adj, _t(tuples), tg.node_mask)


def test_dgi_and_graphcl_edge_losses():
    jmod, variables, tmod, jg, tg, _ = _preprompt_pair()
    key = jax.random.key(13)
    n = jg.features.shape[0]
    jshuf = jpp.corrupt_features(key, jg.features, jg.node_mask)
    tshuf = tpp.corrupt_features(tg.features, tg.node_mask,
                                 noise=_t(jax.random.gumbel(key, (n,))))
    d = _jax_views_draws(jax.random.key(14), "edge", jg.node_mask)
    (_, ja1, _), (_, ja2, _) = jaug.make_graphcl_views(
        jax.random.key(14), "edge", jg.features, jg.adj, jg.node_mask)
    (_, ta1, _), (_, ta2, _) = taug.make_graphcl_views(
        "edge", tg.features, tg.adj, tg.node_mask, d)
    for method, jargs, targs, head in (
            ("dgi_loss", (jshuf, jg.adj), (tshuf, tg.adj), "dgi"),
            ("graphcl_loss", (jshuf, jg.adj, ja1, ja2),
             (tshuf, tg.adj, ta1, ta2), "graphcl_edge")):
        tmod.zero_grad(set_to_none=True)

        def loss_fn(p):
            return jmod.apply({**variables, "params": p}, jg.features,
                              *jargs, jg.node_mask,
                              method=getattr(jmod, method))
        want, jgrads = jax.value_and_grad(loss_fn)(variables["params"])
        got = getattr(tmod, method)(tg.features, *targs, tg.node_mask)
        got.backward()
        _close(got.detach(), want, 1e-5)
        _check_grads(jgrads, tmod)
        assert tmod.get_submodule(head).disc.bilinear_w.grad is not None
        logits = getattr(tmod, f"{method}_logits")(tg.features, *targs,
                                                   tg.node_mask)
        assert tuple(logits.shape) == (2 * n,)


@pytest.mark.parametrize("flavor", FLAVORS)
def test_graphcl_flavor_loss(flavor):
    """``mask`` trains the ``graphcl_mask`` head, every other flavor
    ``graphcl_edge``; the views pool over their own masks."""
    jmod, variables, tmod, jg, tg, _ = _preprompt_pair()
    n = jg.features.shape[0]
    key = jax.random.key(15)
    jshuf = jpp.corrupt_features(key, jg.features, jg.node_mask)
    tshuf = tpp.corrupt_features(tg.features, tg.node_mask,
                                 noise=_t(jax.random.gumbel(key, (n,))))
    vkey = jax.random.key(16)
    jv = jaug.make_graphcl_views(vkey, flavor, jg.features, jg.adj,
                                 jg.node_mask)
    tv = taug.make_graphcl_views(flavor, tg.features, tg.adj, tg.node_mask,
                                 _jax_views_draws(vkey, flavor,
                                                  jg.node_mask))

    def loss_fn(p):
        return jmod.apply({**variables, "params": p}, jg.features, jshuf,
                          jg.adj, *jv, jg.node_mask, flavor=flavor,
                          method=jmod.graphcl_flavor_loss)
    want, jgrads = jax.value_and_grad(loss_fn)(variables["params"])
    got = tmod.graphcl_flavor_loss(tg.features, tshuf, tg.adj, *tv,
                                   tg.node_mask, flavor=flavor)
    got.backward()
    _close(got.detach(), want, 1e-5)
    _check_grads(jgrads, tmod)
    used, unused = ("graphcl_mask", "graphcl_edge") if flavor == "mask" \
        else ("graphcl_edge", "graphcl_mask")
    assert tmod.get_submodule(used).prompt.grad is not None
    assert tmod.get_submodule(unused).prompt.grad is None


def test_ten_adam_steps_match_optax():
    """``lp+dgi+graphcl:subgraph`` as the CLIs sum it, ten Adam steps at lr
    1e-3 with every draw of the JAX step handed to the port: the losses
    step by step (1e-5) and the parameters at the end (2e-5).

    A PReLU pre-activation within rounding of zero takes either branch by
    the summation order, and the gradient of its channel's weight row and
    bias then differs by ``(1 - slope)`` times its upstream, which Adam
    carries on. The port records every pre-activation it computes; a
    channel that had one below 1e-5 has its weight row and bias in that
    layer held to 2e-4 instead (this data has one, 7e-7 in the shuffled DGI
    pass of the tenth step, which moves its row by 4e-5). The port gets the
    JAX package's own input arrays."""
    jmod, variables, tmod, jg, tg, tuples = _preprompt_pair()
    near_kink = {i: set() for i in range(len(tmod.gcn.convs))}

    def recorder(layer):
        def record(conv, inputs):
            x, adj, mask = inputs
            with torch.no_grad():
                pre = adj @ conv.lin(x) + conv.bias
            near = (pre.abs() < 1e-5) & mask[:, None]   # padding is masked
            near_kink[layer].update(near.any(dim=0).nonzero()[:, 0].tolist())
        return record
    for i, conv in enumerate(tmod.gcn.convs):
        conv.register_forward_pre_hook(recorder(i))
    n = jg.features.shape[0]
    tf, ta = _t(jg.features), _t(jg.adj)
    opt = optax.adam(1e-3)
    params = variables["params"]
    opt_state = opt.init(params)

    @jax.jit
    def jstep(params, opt_state, key):
        k_drop, k_shuf, k_aug = jax.random.split(key, 3)

        def loss_fn(p):
            v = {**variables, "params": p}
            total = jmod.apply(v, jg.features, jg.adj, tuples, jg.node_mask,
                               rngs={"dropout": k_drop})
            shuf = jpp.corrupt_features(k_shuf, jg.features, jg.node_mask)
            total += jmod.apply(v, jg.features, shuf, jg.adj, jg.node_mask,
                                method=jmod.dgi_loss)
            v1, v2 = jaug.make_graphcl_views(
                jax.random.fold_in(k_aug, 0), "subgraph", jg.features,
                jg.adj, jg.node_mask)
            return total + jmod.apply(v, jg.features, shuf, jg.adj, v1, v2,
                                      jg.node_mask, flavor="subgraph",
                                      method=jmod.graphcl_flavor_loss)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    optimizer = torch.optim.Adam(tmod.parameters(), lr=1e-3, eps=1e-8)
    losses = []
    for step in range(10):
        key = jax.random.fold_in(jax.random.key(17), step)
        k_drop, k_shuf, k_aug = jax.random.split(key, 3)
        masks = _jax_drop_masks(jmod, {**variables, "params": params}, jg,
                                tuples, k_drop)
        noise = _t(jax.random.gumbel(k_shuf, (n,)))
        draws = _jax_views_draws(jax.random.fold_in(k_aug, 0), "subgraph",
                                 jg.node_mask)
        params, opt_state, want = jstep(params, opt_state, key)

        optimizer.zero_grad(set_to_none=True)
        shuf = tpp.corrupt_features(tf, tg.node_mask, noise=noise)
        v1, v2 = taug.make_graphcl_views("subgraph", tf, ta, tg.node_mask,
                                         draws)
        got = tmod(tf, ta, _t(tuples), tg.node_mask, drop_masks=masks) \
            + tmod.dgi_loss(tf, shuf, ta, tg.node_mask) \
            + tmod.graphcl_flavor_loss(tf, shuf, ta, v1, v2, tg.node_mask,
                                       flavor="subgraph")
        got.backward()
        optimizer.step()
        _close(got.detach(), want, 1e-5)
        losses.append(float(got.detach()))
    assert losses[-1] < losses[0]
    want = preprompt_params_from_jax({"params": _host(params)})
    state = tmod.state_dict()
    assert sum(len(c) for c in near_kink.values()) <= 2, near_kink
    for k, v in want.items():
        got, v = state[k].clone(), torch.as_tensor(v).clone()
        if k.startswith("gcn.convs.") and not k.endswith("slope"):
            kink = sorted(near_kink[int(k.split(".")[2])])
            _close(got[kink], v[kink], 2e-4)
            got[kink], v[kink] = 0.0, 0.0
        _close(got, v, 2e-5)


def test_the_sum_of_the_clis_loss():
    """The CLI's summed loss draws from one generator and repeats with it;
    each term it names takes part."""
    _, _, tmod, _, tg, tuples = _preprompt_pair()
    spec = "lp+dgi+graphcl:edge+graphcl:mask+graphcl:node+graphcl:subgraph"
    terms, flavors = t_cli.pretrain_terms(spec)
    assert flavors == list(FLAVORS) and len(terms) == 6
    a, b = (t_cli.pretrain_loss(tmod, terms, flavors, tg, _t(tuples),
                                torch.Generator().manual_seed(4))
            for _ in range(2))
    a, b = a.detach(), b.detach()
    assert torch.isfinite(a) and float(a) == float(b)
    lp = t_cli.pretrain_loss(tmod, ["lp"], [], tg, _t(tuples),
                             torch.Generator().manual_seed(4))
    assert float(a) > float(lp.detach())
    assert t_cli.pretrain_terms("graphcl")[1] == ["edge"]
    for bad in ("lp+foo", "graphcl:bogus", "graphclx", ""):
        with pytest.raises(ValueError):
            t_cli.pretrain_terms(bad)


# ---- conversion -------------------------------------------------------------

def test_heads_convert_and_unknown_heads_raise():
    jmod, variables, tmod, *_ = _preprompt_pair()
    state = preprompt_params_from_jax(variables)
    p = variables["params"]
    np.testing.assert_array_equal(state["lp.prompt"], p["lp"]["prompt"])
    for head in ("dgi", "graphcl_edge", "graphcl_mask"):
        disc = p[head]["BilinearDiscriminator_0"]
        np.testing.assert_array_equal(state[f"{head}.disc.bilinear_w"],
                                      disc["bilinear_w"])
        assert tuple(state[f"{head}.disc.bilinear_b"].shape) == ()
    assert sorted(state) == sorted(tmod.state_dict())
    bad = {"params": {**p, "dgi": {"prompt": p["dgi"]["prompt"]}}}
    with pytest.raises(ValueError, match="dgi"):
        preprompt_params_from_jax(bad)
    with pytest.raises(ValueError):
        preprompt_params_from_jax({"params": {**p, "extra_head": {}}})


# ---- the CLI ----------------------------------------------------------------

def test_pretrain_cli_writes_the_jax_files(tmp_path):
    """Both CLIs write ``model_SYNTH.pkl`` and ``pretrain_SYNTH.json`` with
    the same keys; the port's checkpoint is its ``state_dict`` (heads
    included) and loads back as the node CLI's encoder."""
    argv = ["pretrain", "--hidden", "16", "--pretrain-epochs", "2",
            "--pretrain-loss", "lp+dgi+graphcl:mask", "--lp-samples", "20"]
    jpath = j_cli.main(argv + ["--save-dir", str(tmp_path / "j"),
                               "--results-dir", str(tmp_path / "j")])
    tpath = t_cli.main(argv + ["--save-dir", str(tmp_path / "t"),
                               "--results-dir", str(tmp_path / "t"),
                               "--device", "cpu"])
    assert jpath.endswith("model_SYNTH.pkl") and tpath.endswith(
        "model_SYNTH.pkl")
    with open(tmp_path / "j" / "pretrain_SYNTH.json") as f:
        want = json.load(f)
    with open(tmp_path / "t" / "pretrain_SYNTH.json") as f:
        got = json.load(f)
    assert sorted(got) == sorted(want) == ["epoch_losses", "loss_terms"]
    assert got["loss_terms"] == want["loss_terms"] == ["lp", "dgi",
                                                       "graphcl:mask"]
    assert len(got["epoch_losses"]) == 2 and np.isfinite(
        got["epoch_losses"]).all()
    state = restore_checkpoint(tpath)
    assert "dgi.disc.bilinear_w" in state and "gcn.convs.0.lin.weight" in state
    loaded = t_cli.load_encoder_state(str(tmp_path / "t"), "SYNTH")
    assert sorted(loaded) == sorted(tpp.PrePrompt(FEAT, 16).state_dict())
    with pytest.raises(SystemExit):
        t_cli.main(["pretrain", "--pretrain-loss", "lp+foo", "--device",
                    "cpu"])
