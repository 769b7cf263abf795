"""The edge model zoo of the port (plugins, dynamic models, prompt models
and their crosses) against the JAX package, on a small synthetic graph (24
users, 48 items, E = 16, 2 layers) on the CPU.

Random draws differ between the frameworks, so a test passes them as data:
the edge masks (the JAX side's ``_drop_masks``, or GP's ``edge_drop_mask``,
replaced by one that records numpy masks; the port's ``edge_masks``),
SimGCL's noise and MixGCF's mixing weights (JAX's own draws, computed from
the step's key, handed to the port's ``_perturb_noise`` and
``_mix_weights``), and the initial GRU and prompt vector (through
``params_from_jax``). ``segsum_impl`` and ``propagate_dtype`` are set on
both sides; JAX runs the fused propagation's Pallas kernel in interpret
mode, the port its plain version.

Tolerances: ``LOSS`` on losses (f32 sums in another order), ``F32`` on
gradients and embeddings, elementwise ``atol + rtol * |JAX|``.
"""

import functools

import _torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ragraph_tpu.data import load_edge_dataset as j_load_edge_dataset
from ragraph_tpu.data import synthetic_edge_stream as j_synthetic
from ragraph_tpu.models import edge as jedge
from ragraph_tpu.models.edge import graphprompt as j_graphprompt
from ragraph_tpu_torch.convert import params_from_jax
from ragraph_tpu_torch.data.edgelist import load_edge_dataset
from ragraph_tpu_torch.data.synthetic import synthetic_edge_stream
from ragraph_tpu_torch.models import edge as tedge
from ragraph_tpu_torch.train.checkpoint import restore_checkpoint
from ragraph_tpu_torch.train.trainer import (EdgeTrainer, map_params,
                                             param_leaves)

LOSS = dict(rtol=1e-5, atol=1e-6)
F32 = dict(rtol=1e-4, atol=2e-6)
# The fused arm's JAX side sums by prefix differences (its Pallas kernel in
# interpret mode). On the gpf crosses, whose tables all carry the prompt's
# offset, that loses about 4e-5 absolute against a float64 sum, where the
# port's plain sum loses 2e-7: the known trap of
# ops/pallas_segment.py:145-148. Those cases take FUSED_GPF.
FUSED_GPF = dict(rtol=1e-4, atol=1e-4)


def _tol(name, arm):
    return FUSED_GPF if arm == "fused" and "@gpf" in name else F32
BASE = dict(emb_size=16, num_layers=2, batch_size=32, eval_batch_size=32,
            edge_dropout=0.3, n_negs=4, lbd=0.5)
ARMS = {"scatter": dict(segsum_impl="scatter", propagate_dtype="f32"),
        "fused": dict(segsum_impl="fused", propagate_dtype="f32")}
# name grammar: <model>[+<dynamic mode>][@<prompt mode>]; GP:<prompt mode>
PLUGINS = ("SGL", "SimGCL", "MixGCF", "LightGCNPlugin")
DYNAMIC = ("Roland", "EvolveGCNH", "EvolveGCNO")
GP = ("GP:graphprompt", "GP:gpf")
CROSSES = ("SGL+roland", "SimGCL+roland", "MixGCF+evolvegcn_o",
           "SGL+evolvegcn_h", "SimGCL+evolvegcn_h", "SimGCL@graphprompt",
           "LightGCNPlugin@gpf", "SGL@gpf", "MixGCF@graphprompt",
           "SGL+roland@gpf")
_PLUGIN_CLS = {"SGL": "SGLPlugin", "SimGCL": "SimGCLPlugin",
               "MixGCF": "MixGCFPlugin"}
_MODES = {"Roland": "roland", "EvolveGCNH": "evolvegcn_h",
          "EvolveGCNO": "evolvegcn_o"}


def zoo_cls(pkg, name):
    """The class called ``name`` in ``pkg``, either package's
    ``models.edge``."""
    name, _, prompt = name.partition("@")
    name, _, dynamic = name.partition("+")
    if name.startswith("GP:"):
        return functools.partial(pkg.GraphPromptEdge, prompt_mode=name[3:])
    cls = getattr(pkg, _PLUGIN_CLS.get(name, name))
    if dynamic:
        cls = pkg.make_dynamic(cls, dynamic)
    if prompt:
        cls = pkg.make_prompted(cls, prompt)
    return cls


def dynamic_mode(name):
    base = name.partition("@")[0]
    return _MODES.get(base) or base.partition("+")[2] or None


@pytest.fixture(scope="module")
def data():
    kw = dict(seed=3, num_users=24, num_items=48, num_stages=1,
              interactions_per_user=8)
    j_train, j_stages = j_synthetic(**kw)
    train, stages = synthetic_edge_stream(**kw)
    assert train == j_train
    return (j_load_edge_dataset(j_train,
                                [(u, i) for (u, i, _) in j_stages[0]]),
            load_edge_dataset(train, [(u, i) for (u, i, _) in stages[0]]))


def _host(tree):
    """JAX params to numpy: factor pairs to tuples, the GRU to a dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = {n: np.asarray(t) for n, t in v.items()}
        elif isinstance(v, tuple):
            out[k] = tuple(np.asarray(t) for t in v)
        else:
            out[k] = np.asarray(v)
    return out


def _flat(tree):
    return dict(param_leaves(tree))


class Draws:
    """The step's draws, recorded on the JAX side and handed to the port."""

    def __init__(self, jm, tm, jg, seed=7):
        self.rng = np.random.default_rng(seed)
        self.perm = np.asarray(jg.send_perm)
        self.n_edges = jg.num_edges
        self.masks = []
        self.noise = []
        self.tm = tm
        self.replay = 0         # > 0: hand out the recorded masks again

    def mask(self, keep):
        if self.replay:
            m = self.masks[(self.replay - 1) % len(self.masks)]
            self.replay += 1
            return m
        m = self.rng.random(self.n_edges) < keep
        self.masks.append(m)
        return m

    def patch(self, monkeypatch, jm, tm, key):
        monkeypatch.setattr(jm, "_drop_masks", lambda k, g, keep: (
            lambda m: (jnp.asarray(m), jnp.asarray(m[self.perm])))(
                self.mask(keep)))
        monkeypatch.setattr(j_graphprompt, "edge_drop_mask",
                            lambda k, n, keep: jnp.asarray(self.mask(keep)))
        n, e = tm.graph.num_nodes, tm.cfg.emb_size
        if isinstance(tm, tedge.SimGCLPlugin):
            _, _, k1, k2 = jax.random.split(key, 4)
            self.noise = [np.asarray(jax.random.uniform(
                jax.random.fold_in(k, layer), (n, e)))
                for k in (k1, k2) for layer in range(tm.cfg.num_layers)]

            def noise(generator, layer, shape, device):
                assert shape == (n, e)
                return torch.from_numpy(self.noise.pop(0).copy())
            monkeypatch.setattr(tm, "_perturb_noise", noise)
        if isinstance(tm, tedge.MixGCFPlugin):
            k_mix = jax.random.split(key, 3)[2]
            shape = (tm.cfg.batch_size, 1, tm.cfg.num_layers + 1, 1)
            w = np.asarray(jax.random.uniform(k_mix, shape))
            monkeypatch.setattr(tm, "_mix_weights", lambda gen, s, device:
                                torch.from_numpy(w.copy()))

    def edge_masks(self):
        """The recorded masks as the port's ``edge_masks`` argument."""
        pairs = [(torch.from_numpy(m), torch.from_numpy(m[self.perm]))
                 for m in self.masks]
        if isinstance(self.tm, tedge.GraphPromptEdge):
            return (pairs[0][0], None)
        return tuple(pairs) if isinstance(self.tm, tedge.SGLPlugin) \
            else pairs[0]


def setup_pair(data, name, phase, arm="scatter", monkeypatch=None, **cfg_kw):
    """Both models of ``name`` with one config, graph and weights, the
    dynamic state set on each side, and one batch."""
    jds, tds = data
    kw = {**BASE, **ARMS[arm], **cfg_kw}
    jg = jedge.EdgeGraphArrays.from_dataset(jds)
    tg = tedge.EdgeGraphArrays.from_dataset(tds, "cpu")
    pre = jedge.GraphPro(jedge.EdgeModelConfig(**kw), jg, phase="pretrain")
    tables = pre.init_params(jax.random.key(0))
    tables = (tables["user_embedding"], tables["item_embedding"])
    jm = zoo_cls(jedge, name)(jedge.EdgeModelConfig(**kw), jg, phase=phase)
    tm = zoo_cls(tedge, name)(tedge.EdgeModelConfig(**kw), tg, phase=phase)
    jparams = jm.init_params(jax.random.key(1), pretrained_tables=tables)
    tparams = params_from_jax(_host(jparams), "cpu")
    tol = _tol(name, arm)
    mode = dynamic_mode(name)
    if mode == "roland":
        if hasattr(jm, "forward_lgn"):
            jl = jm.forward_lgn(jparams, return_layers=True)
            tl = tm.forward_lgn(tparams, return_layers=True)
        else:
            jl = jm.propagated_plain(jparams)
            tl = tm.propagated_plain(tparams)
        assert len(tl) == len(jl) == kw["num_layers"] + 1
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
        jm.set_meta_layers(jl)
        tm.set_meta_layers(tl)
    elif mode == "evolvegcn_h":
        last = 0.1 * np.random.default_rng(2).normal(
            size=(jg.num_nodes, kw["emb_size"])).astype(np.float32)
        jm.set_last_emb(jnp.asarray(last))
        tm.set_last_emb(torch.from_numpy(last))
    rng = np.random.default_rng(3)
    b = kw["batch_size"]
    neg_shape = (b, kw["n_negs"]) if getattr(tm, "multi_negs", False) else b
    batch = (rng.integers(0, jds.num_users, b).astype(np.int32),
             rng.integers(0, jds.num_items, b).astype(np.int32),
             rng.integers(0, jds.num_items, neg_shape).astype(np.int32))
    return jm, tm, jparams, tparams, batch, jg


def jax_value_and_grad(jm, jparams, batch, key):
    def loss_fn(p):
        return jm.cal_loss(p, tuple(jnp.asarray(b) for b in batch), key)
    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(jparams)
    return float(loss), {k: float(v) for k, v in aux.items()}, _host(grads)


def torch_value_and_grad(tm, tparams, batch, edge_masks, generator=None):
    params = map_params(lambda t: t.clone().requires_grad_(True), tparams)
    loss, aux = tm.cal_loss(params, tuple(torch.from_numpy(b) for b in batch),
                            generator, edge_masks=edge_masks)
    loss.backward()
    grads = {name: (torch.zeros_like(t) if t.grad is None else t.grad).numpy()
             for name, t in param_leaves(params)}
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in aux.items()}, grads)


def compare_step(data, name, phase, arm, monkeypatch, **cfg_kw):
    """One ``cal_loss`` and its gradients on both sides; returns the
    port's aux and gradients."""
    jm, tm, jparams, tparams, batch, jg = setup_pair(
        data, name, phase, arm, **cfg_kw)
    key = jax.random.key(5)
    draws = Draws(jm, tm, jg)
    draws.patch(monkeypatch, jm, tm, key)
    jl, jaux, jgrads = jax_value_and_grad(jm, jparams, batch, key)
    tl, taux, tgrads = torch_value_and_grad(tm, tparams, batch,
                                            draws.edge_masks())
    assert draws.noise == []            # every noise draw was taken
    np.testing.assert_allclose(tl, jl, **LOSS)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k], jaux[k], **LOSS)
    want = _flat(jgrads)
    assert set(tgrads) == set(want)
    for leaf, g in tgrads.items():
        np.testing.assert_allclose(g, want[leaf], err_msg=leaf,
                                   **_tol(name, arm))
        assert (np.abs(g).max() == 0) == (np.abs(want[leaf]).max() == 0), \
            leaf
    return taux, tgrads


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("phase", ["pretrain", "finetune", "vanilla"])
@pytest.mark.parametrize("name", PLUGINS)
def test_plugin_loss_and_gradients_match_jax(data, monkeypatch, name,
                                             phase, arm):
    taux, tgrads = compare_step(data, name, phase, arm, monkeypatch)
    assert ("gating_weight" in tgrads) == (phase == "finetune")
    assert not any("lora" in k for k in tgrads)
    if name == "SimGCL":
        assert taux["rec_loss"] == 0.0
    if name in ("SGL", "SimGCL"):
        assert taux["cl_loss"] != 0.0


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("name", DYNAMIC + GP + CROSSES)
def test_dynamic_prompt_and_crosses_match_jax(data, monkeypatch, name, arm):
    """The finetune phase, where ``staged_dynamic`` and ``staged_finetune``
    build these classes: no gate, and the GRU or the prompt vector live."""
    taux, tgrads = compare_step(data, name, "finetune", arm, monkeypatch)
    assert not any(k.startswith("gating") for k in tgrads)
    assert any(k.startswith("gru.") for k in tgrads) == bool(
        dynamic_mode(name))
    assert ("prompt_vec" in tgrads) == ("@" in name or name in GP)
    if name.startswith("SimGCL"):       # the crosses keep the BPR term
        assert taux["rec_loss"] > 0.0


# -- the GRU and the EMA -------------------------------------------------


def test_gru_cell_matches_jax_and_torch_grucell():
    """Tolerance 1e-6: a few f32 products and sums."""
    rng = np.random.default_rng(0)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.3 for k, s in (
        ("w_ih", (24, 8)), ("w_hh", (24, 8)), ("b_ih", (24,)),
        ("b_hh", (24,)))}
    x = rng.normal(size=(5, 8)).astype(np.float32)
    h = rng.normal(size=(5, 8)).astype(np.float32)
    got = tedge.gru_cell({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), torch.from_numpy(h))
    want = jedge.gru_cell({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), jnp.asarray(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    cell = torch.nn.GRUCell(8, 8)
    with torch.no_grad():
        for attr, k in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                        ("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
            getattr(cell, attr).copy_(torch.from_numpy(p[k]))
        ref = cell(torch.from_numpy(x), torch.from_numpy(h))
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


def test_gru_init_gates_and_full_update():
    """The port's counterparts of JAX's GRU tests: the init's bound, an
    output within [-1, 1] from a zero state, and z -> 1 keeping h."""
    gen = torch.Generator().manual_seed(0)
    params = tedge.gru_cell_init(gen, 8)
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        "w_ih": (24, 8), "w_hh": (24, 8), "b_ih": (24,), "b_hh": (24,)}
    assert max(float(v.abs().max()) for v in params.values()) \
        <= 1 / np.sqrt(8)
    out = tedge.gru_cell(params, torch.ones(4, 8), torch.zeros(4, 8))
    assert out.shape == (4, 8) and float(out.abs().max()) <= 1.0
    params = tedge.gru_cell_init(gen, 4)
    params["b_ih"][4:8] = 100.0
    h = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 4))
                         .astype(np.float32))
    torch.testing.assert_close(
        tedge.gru_cell(params, torch.zeros(3, 4), h), h, rtol=0, atol=1e-4)


def test_ema_merge_through_the_nested_dict():
    rng = np.random.default_rng(1)

    def tree():
        return {"user_embedding": rng.normal(size=(3, 4)).astype(np.float32),
                "gru": {k: rng.normal(size=(6,)).astype(np.float32)
                        for k in ("w_ih", "w_hh", "b_ih", "b_hh")}}

    cur, meta = tree(), tree()
    to_t = functools.partial(map_params, torch.from_numpy)
    got = tedge.ema_merge(to_t(cur), to_t(meta), meta_weight=0.9)
    want = jedge.ema_merge(jax.tree.map(jnp.asarray, cur),
                           jax.tree.map(jnp.asarray, meta), meta_weight=0.9)
    for leaf, t in param_leaves(got):
        np.testing.assert_allclose(t.numpy(), _flat(_host(want))[leaf],
                                   rtol=0, atol=1e-7)
    ones = tedge.ema_merge({"a": torch.ones(2)}, {"a": torch.zeros(2)})
    torch.testing.assert_close(ones["a"], torch.full((2,), 0.1))


# -- port-side counterparts of the JAX model tests ------------------------


@pytest.fixture(scope="module")
def port(data):
    _, tds = data
    g = tedge.EdgeGraphArrays.from_dataset(tds, "cpu")
    cfg = tedge.EdgeModelConfig(**BASE)
    batch = (torch.arange(16), torch.arange(16), torch.arange(16, 32))
    return tds, g, cfg, batch


def _gen(seed=1):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("name", ["SGL", "SimGCL", "MixGCF",
                                  "LightGCNPlugin", "EvolveGCNO", "GP:gpf",
                                  "GP:graphprompt"])
def test_losses_finite_from_the_generator(port, name):
    """Without draws passed in, a step draws everything from its generator:
    finite, the same for one seed and another for another."""
    tds, g, cfg, batch = port
    m = zoo_cls(tedge, name)(cfg, g, phase="pretrain")
    params = m.init_params(_gen(0))
    if getattr(m, "multi_negs", False):
        batch = batch[:2] + (torch.from_numpy(np.random.default_rng(0)
                             .integers(0, tds.num_items, (16, cfg.n_negs))),)
    loss, aux = m.cal_loss(params, batch, _gen(1))
    assert np.isfinite(float(loss))
    if name in ("SGL", "SimGCL"):
        assert float(aux["cl_loss"]) != 0.0
    if name == "SimGCL":
        assert float(aux["rec_loss"]) == 0.0
    again, _ = m.cal_loss(params, batch, _gen(1))
    other, _ = m.cal_loss(params, batch, _gen(2))
    assert float(again) == float(loss) and float(other) != float(loss)


def test_simgcl_perturbation_changes_views(port):
    tds, g, cfg, batch = port
    m = tedge.SimGCLPlugin(cfg, g, phase="pretrain")
    params = m.init_params(_gen(0))
    u1, _ = m.forward(params, generator=_gen(1), perturb=True)
    u2, _ = m.forward(params, generator=_gen(2), perturb=True)
    u0, _ = m.forward(params)
    assert not torch.allclose(u1, u2) and not torch.allclose(u1, u0)
    with pytest.raises(ValueError, match="generator"):
        m.forward(params, perturb=True)
    mix = tedge.MixGCFPlugin(cfg, g, phase="pretrain")
    with pytest.raises(ValueError, match="generator"):
        mix._mix_weights(None, (2, 1, 3, 1), "cpu")


@pytest.mark.parametrize("name", ["SimGCL+evolvegcn_o", "SimGCL@gpf",
                                  "SimGCL@graphprompt"])
def test_simgcl_bpr_zeroed_standalone_active_in_crosses(port, name):
    tds, g, cfg, batch = port
    m = tedge.SimGCLPlugin(cfg, g, phase="pretrain")
    _, aux = m.cal_loss(m.init_params(_gen(0)), batch, _gen(1))
    assert float(aux["rec_loss"]) == 0.0 and not m.bpr_in_cal_loss
    crossed = zoo_cls(tedge, name)(cfg, g, phase="pretrain")
    _, aux = crossed.cal_loss(crossed.init_params(_gen(0)), batch, _gen(1))
    assert float(aux["rec_loss"]) > 0.0


def test_mixgcf_picks_the_hardest_candidate_up_to_ties(data, monkeypatch):
    """``_mix_negatives`` on both sides with the same layers and weights:
    the same picks. A candidate repeated in the list ties with itself: both
    pick the first, and the picked rows are the same either way."""
    jds, tds = data
    rng = np.random.default_rng(4)
    layers = rng.normal(size=(tds.num_users + tds.num_items, 3, 8)).astype(
        np.float32)
    users = rng.integers(0, tds.num_users, 12)
    pos = rng.integers(0, tds.num_items, 12)
    negs = rng.integers(0, tds.num_items, (12, 5))
    negs[:, 3] = negs[:, 1]                       # exact ties
    w = rng.random((12, 1, 3, 1)).astype(np.float32)
    jm = jedge.MixGCFPlugin(jedge.EdgeModelConfig(**BASE),
                            jedge.EdgeGraphArrays.from_dataset(jds))
    tm = tedge.MixGCFPlugin(tedge.EdgeModelConfig(**BASE),
                            tedge.EdgeGraphArrays.from_dataset(tds, "cpu"))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(w))
    monkeypatch.setattr(tm, "_mix_weights",
                        lambda gen, shape, device: torch.from_numpy(w))
    u, it = layers[:tds.num_users], layers[tds.num_users:]
    want = jm._mix_negatives(jnp.asarray(u), jnp.asarray(it),
                             jnp.asarray(users), jnp.asarray(negs),
                             jnp.asarray(pos), jax.random.key(0))
    got = tm._mix_negatives(torch.from_numpy(u), torch.from_numpy(it),
                            torch.from_numpy(users), torch.from_numpy(negs),
                            torch.from_numpy(pos), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_plugin_losses_pass_time_scale(port, monkeypatch):
    """Each forward of a plugin step rescales the static-time half of the
    weights by 1 / its keep rate: SGL's three and SimGCL's two views."""
    tds, g, cfg, batch = port
    keep = 1.0 - cfg.edge_dropout
    for cls, keeps in ((tedge.SGLPlugin, [keep, keep * 0.9, keep * 0.9]),
                       (tedge.SimGCLPlugin, [0.5, 0.5])):
        m = cls(cfg, g, phase="pretrain")
        seen = []
        orig = cls.forward

        def spy(self, p, _orig=orig, **kw):
            seen.append(kw.get("time_scale", 1.0))
            return _orig(self, p, **kw)

        monkeypatch.setattr(cls, "forward", spy)
        m.cal_loss(m.init_params(_gen(0)), batch, _gen(1))
        monkeypatch.undo()
        np.testing.assert_allclose(seen, [1.0 / k for k in keeps], rtol=1e-6)
    m = tedge.MixGCFPlugin(cfg, g, phase="pretrain")
    seen = []
    orig = tedge.MixGCFPlugin._propagated

    def spy_prop(self, *a, **kw):
        seen.append(kw.get("time_scale", 1.0))
        return orig(self, *a, **kw)

    monkeypatch.setattr(tedge.MixGCFPlugin, "_propagated", spy_prop)
    negs = torch.from_numpy(np.random.default_rng(0).integers(
        0, tds.num_items, (16, cfg.n_negs)))
    m.cal_loss(m.init_params(_gen(0)), (batch[0], batch[1], negs), _gen(1))
    np.testing.assert_allclose(seen, [1.0 / keep], rtol=1e-6)


def test_static_time_dropout_expectation_preserved(port):
    """With static time and the 1 / keep rescale, the time half of the
    masked weights keeps the unmasked time softmax's sum in expectation."""
    tds, g, cfg, batch = port
    m = tedge.SGLPlugin(cfg, g, phase="pretrain")
    assert m.use_time and cfg.time_mode == "static"
    assert not tedge.SGLPlugin(cfg, g, phase="vanilla").use_time
    keep, trials, acc = 0.7, 400, 0.0
    norm_half = g.edge_norm.numpy() * 0.5
    gen = _gen(0)
    for _ in range(trials):
        mask, mask_s = m._drop_masks(gen, g, keep)
        w, _, impl = m._edge_weights(g, mask, mask_s, time_scale=1.0 / keep)
        acc += float((w.numpy() - np.where(mask.numpy(), norm_half,
                                           0.0)).sum())
    np.testing.assert_allclose(acc / trials,
                               float(g.time_norm.sum()) * 0.5, rtol=0.05)


def test_dynamic_models_need_their_state(port):
    tds, g, cfg, batch = port
    h = tedge.EvolveGCNH(cfg, g)
    params = h.init_params(_gen(0))
    with pytest.raises(RuntimeError, match="set_last_emb"):
        h.forward(params)
    h.set_last_emb(torch.zeros(g.num_nodes, cfg.emb_size))
    u, _ = h.forward(params)
    assert u.shape == (g.num_users, cfg.emb_size)
    r = tedge.Roland(cfg, g)
    params = r.init_params(_gen(0))
    with pytest.raises(RuntimeError, match="set_meta_layers"):
        r.forward(params)
    r.set_meta_layers(r.forward_lgn(params, return_layers=True))
    assert np.isfinite(float(r.cal_loss(params, batch, _gen(1))[0]))
    assert set(params) == {"user_embedding", "item_embedding", "gru"}
    with pytest.raises(ValueError, match="dynamic mode"):
        tedge.make_dynamic(tedge.SGLPlugin, "gcn")
    with pytest.raises(ValueError, match="prompt_mode"):
        tedge.make_prompted(tedge.SGLPlugin, "gpt")
    cross = tedge.make_dynamic(tedge.SGLPlugin, "roland")(cfg, g)
    with pytest.raises(RuntimeError, match="set_meta_layers"):
        cross.forward(cross.init_params(_gen(0)))


def test_graphprompt_scaling_matches_per_message(port):
    """GP's graphprompt layer: the prompt on every message before the sum."""
    tds, g, cfg, batch = port
    m = tedge.GraphPromptEdge(cfg, g, prompt_mode="graphprompt")
    params = m.init_params(_gen(0))
    u1, _ = m.forward(params)
    h = torch.cat([params["user_embedding"], params["item_embedding"]])
    layers = [h]
    for _ in range(cfg.num_layers):
        msgs = h[g.senders.long()] * g.edge_norm[:, None] \
            * params["prompt_vec"]
        h = torch.zeros_like(h).index_add_(0, g.receivers.long(), msgs)
        layers.append(h)
    torch.testing.assert_close(u1, sum(layers)[:g.num_users], rtol=0,
                               atol=1e-6)


def test_prompted_lightgcn_prompt_is_live(port):
    """The prompt crosses wrap the plugin LightGCN: the prompt gets a
    gradient and moves the output."""
    tds, g, cfg, batch = port
    m = tedge.make_prompted(tedge.LightGCNPlugin, "graphprompt")(
        cfg, g, phase="pretrain")
    params = map_params(lambda t: t.requires_grad_(True),
                        m.init_params(_gen(0)))
    m.cal_loss(params, batch, _gen(1))[0].backward()
    assert float(params["prompt_vec"].grad.abs().sum()) > 0
    with torch.no_grad():
        u1, _ = m.forward(params)
        u2, _ = m.forward({**params,
                           "prompt_vec": params["prompt_vec"] + 1.0})
    assert float((u1 - u2).abs().max()) > 1e-6


def test_simgcl_graphprompt_order_matches_reference(data):
    """SimGCL x graphprompt: the prompt scales each hop before the noise,
    and the noisy prompted h propagates on. Against JAX's
    ``_propagated`` with the noise JAX drew, and against the explicit
    loop."""
    jds, tds = data
    kw = {**BASE, **ARMS["scatter"]}
    jg = jedge.EdgeGraphArrays.from_dataset(jds)
    tg = tedge.EdgeGraphArrays.from_dataset(tds, "cpu")
    jm = jedge.make_prompted(jedge.SimGCLPlugin, "graphprompt")(
        jedge.EdgeModelConfig(**kw), jg, phase="vanilla")
    tm = tedge.make_prompted(tedge.SimGCLPlugin, "graphprompt")(
        tedge.EdgeModelConfig(**kw), tg, phase="vanilla")
    jparams = jm.init_params(jax.random.key(0))
    tparams = params_from_jax(_host(jparams), "cpu")
    pk = jax.random.key(5)
    noise = [np.asarray(jax.random.uniform(jax.random.fold_in(pk, layer),
                                           (tg.num_nodes, kw["emb_size"])))
             for layer in range(kw["num_layers"])]
    tm._perturb_noise = lambda gen, layer, shape, device: \
        torch.from_numpy(noise[layer].copy())
    want = jm._propagated(jparams, None, False, None, perturb_key=pk)
    got = tm._propagated(tparams, None, False, None, perturb=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    h = torch.cat([tparams["user_embedding"], tparams["item_embedding"]])
    p = tparams["prompt_vec"]
    layers = [h]
    for layer in range(kw["num_layers"]):
        msgs = h[tg.senders.long()] * tg.edge_norm[:, None]
        h = torch.zeros_like(h).index_add_(0, tg.receivers.long(), msgs) * p
        n = torch.from_numpy(noise[layer].copy())
        n = n / n.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        h = h + torch.sign(h) * n * tm.cfg.eps
        layers.append(h)
    torch.testing.assert_close(got, sum(layers), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["roland", "evolvegcn_h", "evolvegcn_o"])
def test_sgl_cross_each_mode(port, mode):
    tds, g, cfg, batch = port
    m = tedge.make_dynamic(tedge.SGLPlugin, mode)(cfg, g, phase="pretrain")
    assert m.use_time is False and m.bpr_in_cal_loss
    params = m.init_params(_gen(0))
    assert "gru" in params and "gating_weight" not in params
    if mode == "roland":
        # the cross's plain loop is LightGCN's: no time, no gate, no GRU
        layers = tedge.lightgcn_propagate(
            torch.cat([params["user_embedding"], params["item_embedding"]]),
            g.senders.long(), g.receivers, g.edge_norm, g.num_nodes,
            cfg.num_layers)
        got = m.propagated_plain(params)
        assert m._computing_meta is False and len(got) == len(layers)
        for a, b in zip(got, layers):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        m.set_meta_layers(got)
    elif mode == "evolvegcn_h":
        m.set_last_emb(torch.zeros(g.num_nodes, cfg.emb_size))
    loss, aux = m.cal_loss(params, batch, _gen(1))
    assert np.isfinite(float(loss)) and "cl_loss" in aux
    assert type(m).__name__ == f"SGLPlugin_{mode}"


# -- training ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["SGL", "Roland"])
def test_adam_trajectory_matches_optax(data, monkeypatch, name):
    """Five Adam steps on fixed batches and masks: every parameter, the
    GRU's included, within 1e-5 of optax's."""
    jm, tm, jparams, tparams, batch, jg = setup_pair(
        data, name, "finetune", "scatter", lr=1e-3)
    draws = Draws(jm, tm, jg)
    draws.patch(monkeypatch, jm, tm, jax.random.key(0))
    opt = optax.adam(1e-3)
    state = opt.init(jparams)
    jb = tuple(jnp.asarray(b) for b in batch)
    grad_fn = jax.grad(lambda p: jm.cal_loss(p, jb, jax.random.key(0))[0])
    for _ in range(5):
        upd, state = opt.update(grad_fn(jparams), state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        draws.replay = draws.replay or 1    # one mask set for all steps
    trainer = EdgeTrainer(tm, None, logger=lambda *_: None)
    params, optimizer = trainer.prepare(tparams)
    tb = tuple(torch.from_numpy(b) for b in batch)
    for _ in range(5):
        trainer.step(params, optimizer, tb, None,
                     edge_masks=draws.edge_masks())
    want = _flat(_host(jparams))
    start = _flat(tparams)
    for leaf, t in param_leaves(params):
        np.testing.assert_allclose(t.detach().numpy(), want[leaf], rtol=0,
                                   atol=1e-5, err_msg=leaf)
        assert float((t.detach() - start[leaf]).abs().max()) > 1e-3, leaf


def test_trainer_resumes_the_gru_from_its_checkpoint(data, tmp_path):
    """``train_state.pkl`` carries the nested ``gru`` dict and its Adam
    moments: a run resumed after its last epoch hands back the saved
    snapshot as it was, and one resumed for another epoch goes on."""
    _, tds = data
    g = tedge.EdgeGraphArrays.from_dataset(tds, "cpu")
    m = tedge.EvolveGCNO(tedge.EdgeModelConfig(**BASE, lr=5e-3), g)
    params = m.init_params(_gen(0))

    def run(epochs, ckpt):
        return EdgeTrainer(m, tds, logger=lambda *_: None).train(
            params, _gen(3), num_epochs=epochs, rng=np.random.default_rng(3),
            checkpoint_dir=ckpt, checkpoint_every=2)

    ckpt = str(tmp_path / "state")
    first = run(2, ckpt)
    snap = restore_checkpoint(str(tmp_path / "state" / "train_state"))
    assert set(snap["params"]["gru"]) == {"w_ih", "w_hh", "b_ih", "b_hh"}
    assert {k for k in snap["opt_state"] if k.startswith("gru.")} == {
        "gru.b_hh", "gru.b_ih", "gru.w_hh", "gru.w_ih"}
    again = run(2, ckpt)
    assert again.history == []
    for leaf, t in param_leaves(again.best_params):
        torch.testing.assert_close(t, _flat(first.best_params)[leaf],
                                   rtol=0, atol=0)
    more = run(3, ckpt)
    assert [h["epoch"] for h in more.history] == [2]
    assert np.isfinite(more.history[0]["loss"])


def test_params_from_jax_carries_the_gru_and_the_prompt(data):
    jm, tm, jparams, tparams, _, _ = setup_pair(data, "SGL+roland@gpf",
                                                "finetune")
    host = _host(jparams)
    assert set(tparams) == {"user_embedding", "item_embedding", "gru",
                            "prompt_vec"}
    for leaf, t in param_leaves(tparams):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), _flat(host)[leaf])
    bad_gru = dict(host, gru={k: v for k, v in host["gru"].items()
                              if k != "b_hh"})
    with pytest.raises(ValueError, match="gru must hold"):
        params_from_jax(bad_gru, "cpu")
    with pytest.raises(ValueError, match=r"\(1, E\)"):
        params_from_jax(dict(host, prompt_vec=host["prompt_vec"][0]), "cpu")
    with pytest.raises(ValueError, match="not edge-model"):
        params_from_jax(dict(host, meta_layers=host["prompt_vec"]), "cpu")
