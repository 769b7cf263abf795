"""The port's training path against the JAX package on the synthetic stream
(64 users, 128 items): ``cal_loss`` and every gradient in the four phases,
Adam trajectories, and the two trainers as wholes.

Random draws differ between the frameworks, so a test passes them as data:
the edge-dropout masks (``edge_masks`` on the port, a replaced
``_drop_masks`` on the JAX side), the random gate of ``for_tune`` (both
modules' ``random_gate`` replaced by one with fixed weights) and the noise
rows (the port's ``_noise_indices`` returns what JAX drew). ``segsum_impl``
and ``propagate_dtype`` are set on both sides; JAX runs the fused
propagation's Pallas kernel in interpret mode, the port its plain version.

Tolerances: ``F32`` for f32 sums in another order; ``BF16`` where the tables
are rounded to bf16 before each layer, since an f32 difference of one ulp
can flip a rounding.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ragraph_tpu.data import load_edge_dataset as j_load_edge_dataset
from ragraph_tpu.data import synthetic_edge_stream as j_synthetic
from ragraph_tpu.models import edge as jedge
from ragraph_tpu.models.edge import ragraph_edge as j_ragraph_edge
from ragraph_tpu.train.trainer import EdgeTrainer as JEdgeTrainer
from ragraph_tpu.utils import native as j_native
from ragraph_tpu_torch.convert import params_from_jax, resources_from_jax
from ragraph_tpu_torch.data.edgelist import load_edge_dataset
from ragraph_tpu_torch.data.synthetic import synthetic_edge_stream
from ragraph_tpu_torch.models import edge as tedge
from ragraph_tpu_torch.models.edge import ragraph_edge as t_ragraph_edge
from ragraph_tpu_torch.train.trainer import (EdgeTrainer, map_params,
                                             param_leaves)

F32 = dict(rtol=1e-4, atol=2e-6)
BF16 = dict(rtol=2e-2, atol=2e-3)
BASE = dict(emb_size=16, num_layers=2, batch_size=96, eval_batch_size=64,
            edge_dropout=0.4, retrieve_num=5, lora_rank=4)
ARMS = {"scatter-f32": dict(segsum_impl="scatter", propagate_dtype="f32"),
        "fused-f32": dict(segsum_impl="fused", propagate_dtype="f32"),
        "fused-bf16": dict(segsum_impl="fused", propagate_dtype="bf16")}
LORA = {"off": dict(),
        "trained": dict(use_lora=True, lora_init_scale=1.0),
        "frozen": dict(use_lora=True, lora_init_scale=1.0,
                       lora_train_factors=False)}


@pytest.fixture(scope="module")
def data():
    j_train, j_stages = j_synthetic(seed=0)
    train, stages = synthetic_edge_stream(seed=0)
    return (j_load_edge_dataset(j_train, j_stages[0]),
            load_edge_dataset(train, stages[0]))


def _host(tree):
    """JAX params to numpy (LoRA factors to pairs)."""
    return {k: tuple(np.asarray(t) for t in v) if isinstance(v, tuple)
            else np.asarray(v) for k, v in tree.items()}


def _setup(data, cls_name, phase, monkeypatch, **cfg_kw):
    """Both models with one config, graph, weights and library, and one
    batch, mask pair and gate draw for both."""
    jds, tds = data
    kw = {**BASE, **cfg_kw}
    jg = jedge.EdgeGraphArrays.from_dataset(jds)
    tg = tedge.EdgeGraphArrays.from_dataset(tds, "cpu")
    pre = getattr(jedge, cls_name)(jedge.EdgeModelConfig(**kw), jg,
                                   phase="pretrain")
    tables = pre.init_params(jax.random.key(0))
    tables = (tables["user_embedding"], tables["item_embedding"])
    jm = getattr(jedge, cls_name)(jedge.EdgeModelConfig(**kw), jg,
                                  phase=phase)
    tm = getattr(tedge, cls_name)(tedge.EdgeModelConfig(**kw), tg,
                                  phase=phase)
    jparams = jm.init_params(jax.random.key(1), pretrained_tables=tables)
    tparams = params_from_jax(_host(jparams), "cpu")
    if jm.use_rag and phase in ("vanilla", "finetune"):
        ju, ji = pre.generate({"user_embedding": tables[0],
                               "item_embedding": tables[1]})
        jk, jv = jm.make_resource_graph(ju, ji, jax.random.key(2))
        tm.resource_keys, tm.resource_values = resources_from_jax(
            np.asarray(jk), np.asarray(jv), "cpu")

    rng = np.random.default_rng(3)
    batch = tuple(rng.integers(0, n, kw["batch_size"]).astype(np.int32)
                  for n in (jds.num_users, jds.num_items, jds.num_items))
    mask = rng.random(jg.num_edges) < 1.0 - kw["edge_dropout"]
    perm = np.asarray(jg.send_perm)
    monkeypatch.setattr(jm, "_drop_masks", lambda key, g, keep: (
        jnp.asarray(mask), jnp.asarray(mask[perm])))
    masks = (torch.from_numpy(mask), torch.from_numpy(mask[perm]))
    e = kw["emb_size"]
    gw = rng.normal(size=(e, e)).astype(np.float32)
    gb = rng.normal(size=(1, e)).astype(np.float32)
    monkeypatch.setattr(j_ragraph_edge, "random_gate", lambda x, key: (
        x * jax.nn.sigmoid(x @ jnp.asarray(gw) + jnp.asarray(gb))))
    monkeypatch.setattr(t_ragraph_edge, "random_gate", lambda x, gen: (
        x * torch.sigmoid(x @ torch.from_numpy(gw) + torch.from_numpy(gb))))
    return jm, tm, jparams, tparams, batch, masks


def _jax_value_and_grad(jm, jparams, batch, key):
    def loss_fn(p):
        return jm.cal_loss(p, tuple(jnp.asarray(b) for b in batch), key)
    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(jparams)
    return float(loss), {k: float(v) for k, v in aux.items()}, _host(grads)


def _torch_value_and_grad(tm, tparams, batch, masks, generator=None):
    params = map_params(lambda t: t.clone().requires_grad_(True), tparams)
    loss, aux = tm.cal_loss(params, tuple(torch.from_numpy(b) for b in batch),
                            generator, edge_masks=masks)
    loss.backward()
    grads = {name: (torch.zeros_like(t) if t.grad is None else t.grad).numpy()
             for name, t in param_leaves(params)}
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in aux.items()}, grads)


def _check_grads(got, want, tol, expect_zero=()):
    want_flat = {}
    for k, v in want.items():
        if isinstance(v, tuple):
            want_flat.update({f"{k}.{i}": t for i, t in enumerate(v)})
        else:
            want_flat[k] = v
    assert set(got) == set(want_flat)
    for name in got:
        np.testing.assert_allclose(got[name], want_flat[name], err_msg=name,
                                   **tol)
        zero = name.split(".")[0] in expect_zero
        assert (np.abs(want_flat[name]).max() == 0) == zero, name


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("cls_name,phase", [
    ("RAGraphEdge", "pretrain"), ("GraphPro", "pretrain"),
    ("LightGCNEdge", "pretrain"), ("RAGraphEdge", "for_tune"),
    ("RAGraphEdge", "vanilla")])
def test_cal_loss_and_gradients_match_jax(data, monkeypatch, arm, cls_name,
                                          phase):
    jm, tm, jparams, tparams, batch, masks = _setup(
        data, cls_name, phase, monkeypatch, **ARMS[arm])
    assert tm._segsum_impl() == jm._segsum_impl() == ARMS[arm]["segsum_impl"]
    jl, jaux, jgrads = _jax_value_and_grad(jm, jparams, batch,
                                           jax.random.key(5))
    tl, taux, tgrads = _torch_value_and_grad(tm, tparams, batch, masks)
    tol = BF16 if arm == "fused-bf16" else F32
    np.testing.assert_allclose(tl, jl, **tol)
    for k in ("rec_loss", "reg_loss"):
        np.testing.assert_allclose(taux[k], jaux[k], **tol)
    _check_grads(tgrads, jgrads, tol)


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("lora", list(LORA))
def test_finetune_loss_and_gradients_match_jax(data, monkeypatch, arm, lora):
    """The finetune phase: learned gate, RAG fusion, LoRA off, trained and
    frozen. Frozen factors get a zero gradient on both sides."""
    jm, tm, jparams, tparams, batch, masks = _setup(
        data, "RAGraphEdge", "finetune", monkeypatch, **ARMS[arm],
        **LORA[lora])
    assert ("user_lora" in tparams) == (lora != "off")
    jl, jaux, jgrads = _jax_value_and_grad(jm, jparams, batch,
                                           jax.random.key(5))
    tl, taux, tgrads = _torch_value_and_grad(tm, tparams, batch, masks)
    tol = BF16 if arm == "fused-bf16" else F32
    np.testing.assert_allclose(tl, jl, **tol)
    np.testing.assert_allclose(taux["reg_loss"], jaux["reg_loss"], **tol)
    _check_grads(tgrads, jgrads, tol, expect_zero=(
        ("user_lora", "item_lora") if lora == "frozen" else ()))


def test_finetune_gradient_path_skips_the_retrieval(data, monkeypatch):
    """The retrieved mean carries no gradient: the loss gradient with the
    library is ``(1 - retrieve_weight)`` times the one of the propagated
    embeddings alone, seen through a loss that is linear in them."""
    _, tm, _, tparams, _, masks = _setup(data, "RAGraphEdge", "finetune",
                                         monkeypatch, **ARMS["scatter-f32"])

    def grad_of_sum(resources):
        params = map_params(lambda t: t.clone().requires_grad_(True), tparams)
        u, i = tm.forward(params, training=True, edge_mask=masks[0],
                          edge_mask_send=masks[1], resources=resources)
        (u.sum() + i.sum()).backward()
        return params["user_embedding"].grad

    with_rag = grad_of_sum(None)
    tm_keys, tm.resource_keys = tm.resource_keys, None
    without = grad_of_sum(None)
    tm.resource_keys = tm_keys
    torch.testing.assert_close(with_rag,
                               (1 - tm.cfg.retrieve_weight) * without)


def test_noise_mode_matches_jax(data, monkeypatch):
    """``use_noise``: k widens by ``noise_retrieve_num`` and as many random
    library rows join each retrieved set; the rows JAX drew go to the port."""
    jm, tm, jparams, tparams, batch, masks = _setup(
        data, "RAGraphEdge", "finetune", monkeypatch, **ARMS["scatter-f32"],
        use_noise=True, noise_retrieve_num=2)
    key = jax.random.key(9)
    k_fwd = jax.random.split(key)[1]
    n_lib = tm.resource_values.shape[0]
    drawn = np.asarray(jax.random.randint(
        jax.random.fold_in(k_fwd, 7), (tm.graph.num_nodes, 2), 0, n_lib))
    seen = {}

    def noise(generator, n_rows, n_noise, n_resources, device):
        seen["shape"] = (n_rows, n_noise, n_resources)
        return torch.from_numpy(drawn.copy())

    monkeypatch.setattr(tm, "_noise_indices", noise)
    jl, _, jgrads = _jax_value_and_grad(jm, jparams, batch, key)
    tl, _, tgrads = _torch_value_and_grad(tm, tparams, batch, masks)
    assert seen["shape"] == (tm.graph.num_nodes, 2, n_lib)
    np.testing.assert_allclose(tl, jl, **F32)
    _check_grads(tgrads, jgrads, F32)
    quiet = dataclasses.replace(tm.cfg, use_noise=False)
    tm.cfg = quiet
    assert abs(_torch_value_and_grad(tm, tparams, batch, masks)[0] - tl) > 0
    # the port's own draw: in range, from the generator
    idx = t_ragraph_edge.TemporalLightGCN._noise_indices(
        torch.Generator().manual_seed(0), 50, 3, 7, "cpu")
    assert idx.shape == (50, 3) and 0 <= int(idx.min()) \
        and int(idx.max()) < 7
    with pytest.raises(ValueError, match="generator"):
        t_ragraph_edge.TemporalLightGCN._noise_indices(None, 5, 1, 7, "cpu")


def test_training_draws_come_from_the_generator(data, monkeypatch):
    """Without masks passed in, a step draws its salt from the generator:
    the same seed gives the same loss, another seed another; the two mask
    orders describe one set of edges."""
    _, tm, _, tparams, batch, _ = _setup(data, "RAGraphEdge", "pretrain",
                                         monkeypatch, **ARMS["fused-f32"])

    def loss(seed):
        return _torch_value_and_grad(
            tm, tparams, batch, None, torch.Generator().manual_seed(seed))[0]

    assert loss(0) == loss(0) and loss(0) != loss(1)
    g = tm.graph
    m, ms = tm._drop_masks(torch.Generator().manual_seed(2), g, 0.6)
    assert torch.equal(ms, m[g.send_perm.long()])
    assert 0.5 < m.float().mean() < 0.7
    ones, ones_s = tm._drop_masks(None, g, 1.0)
    assert ones.all() and ones_s.all()
    bare = dataclasses.replace(g, send_perm=None)
    m2, none = tm._drop_masks(torch.Generator().manual_seed(2), bare, 0.6)
    assert none is None and 0.5 < m2.float().mean() < 0.7


def _adam_run(jm, tm, jparams, tparams, batches, n_steps):
    opt = optax.adam(jm.cfg.lr)
    state = opt.init(jparams)

    @jax.jit
    def jstep(p, s, users, pos, neg):
        grads = jax.grad(lambda q: jm.cal_loss(
            q, (users, pos, neg), jax.random.key(0))[0])(p)
        upd, s = opt.update(grads, s, p)
        return optax.apply_updates(p, upd), s

    trainer = EdgeTrainer(tm, None, logger=lambda *_: None)
    params, optimizer = trainer.prepare(tparams)
    for step in range(n_steps):
        b = batches[step % len(batches)]
        jparams, state = jstep(jparams, state, *(jnp.asarray(a) for a in b))
        trainer.step(params, optimizer,
                     tuple(torch.from_numpy(a) for a in b), None)
    return _host(jparams), params


@pytest.mark.parametrize("phase,lora", [("pretrain", "off"),
                                        ("finetune", "off"),
                                        ("finetune", "trained"),
                                        ("finetune", "frozen")])
def test_adam_trajectory_matches_jax(data, monkeypatch, phase, lora):
    """20 Adam steps on fixed batches with ``edge_dropout=0``: every
    parameter within 1e-5 of optax's; frozen factors do not move."""
    jm, tm, jparams, tparams, _, _ = _setup(
        data, "RAGraphEdge", phase, monkeypatch, **ARMS["scatter-f32"],
        **LORA[lora], edge_dropout=0.0, lr=1e-3)
    monkeypatch.undo()          # no dropout: the real (all-ones) masks
    rng = np.random.default_rng(11)
    batches = [tuple(rng.integers(0, n, 96).astype(np.int32)
                     for n in (64, 128, 128)) for _ in range(4)]
    start = {k: v.numpy().copy() for k, v in param_leaves(tparams)}
    want, got = _adam_run(jm, tm, jparams, tparams, batches, 20)
    want = {k: v for k, v in param_leaves(want)}
    moved = 0.0
    for name, t in param_leaves(got):
        np.testing.assert_allclose(t.detach().numpy(), want[name], rtol=0,
                                   atol=1e-5, err_msg=name)
        delta = np.abs(t.detach().numpy() - start[name]).max()
        if lora == "frozen" and "lora" in name:
            assert delta == 0 and not t.requires_grad
        else:
            moved = max(moved, delta)
    assert moved > 5e-3         # 20 steps of lr 1e-3 went somewhere
    # the caller's tensors were copied, not trained in place
    for name, t in param_leaves(tparams):
        np.testing.assert_array_equal(t.numpy(), start[name])


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "cpp"])
def test_trainers_follow_one_trajectory(data, monkeypatch, native):
    """Both ``EdgeTrainer.train`` loops from the same numpy generator: the
    same batches and negatives, so the same losses, metrics and tables,
    epoch by epoch. ``cpp``: both samplers as they default, in C++.
    ``numpy``: both held to their numpy samplers; on the JAX side the C++
    one is switched off too, and since the call that would reach it draws
    its seed from the generator first, each dataset's method is bound with
    ``use_native=False``."""
    jm, tm, jparams, tparams, _, _ = _setup(
        data, "GraphPro", "pretrain", monkeypatch, **ARMS["scatter-f32"],
        edge_dropout=0.0, lr=5e-3, early_stop_patience=50)
    monkeypatch.undo()
    jds, tds = data
    if not native:
        monkeypatch.setattr(j_native, "negative_sample_native",
                            lambda *a, **k: None)
        for ds in (jds, tds):
            monkeypatch.setattr(ds, "sample_negatives", functools.partial(
                type(ds).sample_negatives, ds, use_native=False))
    jres = JEdgeTrainer(jm, jds, logger=lambda *_: None).train(
        jparams, jax.random.key(0), num_epochs=3,
        rng=np.random.default_rng(7))
    tres = EdgeTrainer(tm, tds, logger=lambda *_: None).train(
        tparams, torch.Generator().manual_seed(0), num_epochs=3,
        rng=np.random.default_rng(7))
    assert tres.epochs_run == jres.epochs_run == 3
    for th, jh in zip(tres.history, jres.history):
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
        np.testing.assert_allclose(th["recall"], jh["recall"], atol=1e-6)
        np.testing.assert_allclose(th["ndcg"], jh["ndcg"], atol=1e-6)
    assert tres.history[-1]["loss"] < tres.history[0]["loss"]
    for k in ("user_embedding", "item_embedding"):
        np.testing.assert_allclose(tres.best_params[k].numpy(),
                                   np.asarray(jres.best_params[k]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "cpp"])
def test_sampler_draws_as_jax_numpy_path(data, native):
    """The port's sampler draws as JAX's on the same path: numpy
    (``use_native=False`` on both sides) or C++ (both defaults)."""
    jds, tds = data
    np.testing.assert_array_equal(tds._hist_keys, jds._hist_keys)
    users = np.arange(64, dtype=np.int32).repeat(3)
    rng_j, rng_t = np.random.default_rng(1), np.random.default_rng(1)
    want = jds.sample_negatives(users, rng_j, n=4, use_native=native)
    got = tds.sample_negatives(users, rng_t, n=4, use_native=native)
    np.testing.assert_array_equal(got, want)
    # the generators moved on alike
    assert rng_t.integers(1 << 30) == rng_j.integers(1 << 30)
    keys = users.astype(np.int64)[:, None] * tds.num_items + got
    assert not np.isin(keys, tds._hist_keys).any()
    # ids past 2**31 / num_items: the int64 cast before the multiply
    big = dataclasses.replace(tds, num_items=1 << 20, _hist_keys=np.array(
        [(1 << 12) * (1 << 20) + 5], np.int64))
    out = big.sample_negatives(np.full(2000, 1 << 12, np.int32),
                               np.random.default_rng(0), use_native=native)
    assert out.shape == (2000, 1) and (out >= 0).all() and (out != 5).all()


def test_trainer_best_snapshot_early_stop_and_resume(data, monkeypatch,
                                                     tmp_path):
    _, tm, _, tparams, _, _ = _setup(data, "GraphPro", "pretrain",
                                     monkeypatch, **ARMS["scatter-f32"],
                                     lr=5e-3, early_stop_patience=2)
    monkeypatch.undo()
    _, tds = data
    logs = []
    trainer = EdgeTrainer(tm, tds, logger=logs.append)
    # an evaluator whose recall never improves: patience stops the run
    calls = {"n": 0}

    def flat(*a, **k):
        calls["n"] += 1
        return {"recall": np.array([0.5 if calls["n"] == 1 else 0.1]),
                "ndcg": np.array([0.1])}

    monkeypatch.setattr(trainer.evaluator, "evaluate", flat)
    res = trainer.train(tparams, torch.Generator().manual_seed(0),
                        num_epochs=10, rng=np.random.default_rng(0))
    assert res.epochs_run == 3 and "early stop" in logs[-1]
    assert res.best_perform["recall"][0] == 0.5
    monkeypatch.undo()
    # the snapshot is the epoch-0 state, not the tensors Adam kept updating
    one = EdgeTrainer(tm, tds, logger=lambda *_: None).train(
        tparams, torch.Generator().manual_seed(0), num_epochs=1,
        rng=np.random.default_rng(0))
    torch.testing.assert_close(res.best_params["user_embedding"],
                               one.best_params["user_embedding"])

    # resume: 4 epochs in one go against 2 + checkpoint + 2
    def run(epochs, ckpt):
        return EdgeTrainer(tm, tds, logger=lambda *_: None).train(
            tparams, torch.Generator().manual_seed(3), num_epochs=epochs,
            rng=np.random.default_rng(3), checkpoint_dir=ckpt,
            checkpoint_every=2)

    ckpt = str(tmp_path / "state")
    first = run(2, ckpt)
    assert (tmp_path / "state" / "train_state.pkl").exists()
    resumed = run(4, ckpt)
    assert first.epochs_run == 2 and resumed.epochs_run == 4
    assert [h["epoch"] for h in resumed.history] == [2, 3]
    assert resumed.history[-1]["loss"] < first.history[0]["loss"]
    # on a mesh the batch must split over dp, checked before any
    # collective (the surface of a DeviceMesh the check reads)
    class DpMesh:
        mesh_dim_names = ("dp", "idx")

        def size(self, i):
            return (7, 1)[i]

        def get_local_rank(self, name):
            return 0

    with pytest.raises(ValueError, match="batch_size 96 must divide by "
                                         "the data-parallel extent 7"):
        EdgeTrainer(tm, tds, mesh=DpMesh()).train(
            tparams, torch.Generator().manual_seed(3), num_epochs=1)
    grouped = EdgeTrainer(tm, tds, logger=lambda *_: None).evaluate_grouped(
        resumed.best_params)
    assert set(grouped) == {"tuned", "untuned"}
