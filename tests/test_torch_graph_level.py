"""The graph level of the port against the JAX package: ``RAGraphGraph``'s
forward, loss and gradients in both ``finetune`` settings and under
Gaussian noise, ten Adam steps against optax, its library build, the CLIs'
``--level graph`` runs from one checkpoint, and ``pretrain`` followed by
``finetune --level graph`` in each package within 2 SE.

Both sides start from the same numbers: the JAX package initialises the
encoder and the decoder and builds the library, and the port gets them
through ``ragraph_tpu_torch.convert``. The graph library pools each graph
into one entry (no sampling, no augmentation, no positions), so its rows
are distinct and retrieval is tie-free; the stores stay below 32,768 rows,
where both sides score in f32. Tolerances: 1e-5 on outputs of order 1 (f32,
another summation order), 1e-6 on the loss and gradients, 2e-5 on
parameters after ten Adam steps at lr 1e-2.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ragraph_tpu.cli import node as j_cli
from ragraph_tpu.data import batching as jbatch
from ragraph_tpu.models.preprompt import PrePrompt as JPrePrompt
from ragraph_tpu.models.ragraph_graph import RAGraphGraph as JRAGraphGraph
from ragraph_tpu.models.ragraph_graph import \
    RAGraphGraphConfig as JRAGraphGraphConfig
from ragraph_tpu.models.ragraph_graph import \
    graph_library_config as j_graph_library_config
from ragraph_tpu.nn.heads import TaskDecoder as JTaskDecoder
from ragraph_tpu.train.checkpoint import save_checkpoint as j_save
from ragraph_tpu_torch.cli import node as t_cli
from ragraph_tpu_torch.convert import (decoder_params_from_jax,
                                       library_from_jax,
                                       preprompt_params_from_jax)
from ragraph_tpu_torch.data import batching as tbatch
from ragraph_tpu_torch.data.synthetic import synthetic_tu_dataset
from ragraph_tpu_torch.models.ragraph_graph import (GRAPH_FUSION_WEIGHTS,
                                                    RAGraphGraph,
                                                    RAGraphGraphConfig,
                                                    graph_library_config)
from ragraph_tpu_torch.models.ragraph_node import (RAGraphNode,
                                                   RAGraphNodeState)

HIDDEN, FEAT, CLASSES = 16, 16, 3
B = 8


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _pair(finetune=True, noise=False, layers=1):
    """The JAX task with a built library, the port's task with the
    converted state, and a stacked val batch on both sides (its last
    graph is batch padding)."""
    ds = synthetic_tu_dataset(seed=3, num_graphs=31)
    kw = dict(emb_size=HIDDEN, num_class=CLASSES, finetune=finetune,
              noise_finetune=noise, encoder_layers=layers)
    jcfg = JRAGraphGraphConfig(library=j_graph_library_config(CLASSES), **kw)
    tcfg = RAGraphGraphConfig(library=graph_library_config(CLASSES), **kw)
    jtask = JRAGraphGraph(jcfg, FEAT)
    jstate = jtask.init_state(jax.random.key(1), library_capacity=512)
    jstate = jtask.build_library(
        jstate, jbatch.stacked_batches(ds.graphs[:24], B,
                                       num_classes=CLASSES,
                                       num_graph_classes=CLASSES),
        jax.random.key(2))
    ttask = RAGraphGraph(tcfg, FEAT, device="cpu")
    tstate = ttask.init_state(torch.Generator().manual_seed(0),
                              encoder_state=preprompt_params_from_jax(
                                  _host(jstate.encoder_params)),
                              library_capacity=8)
    tstate.decoder.load_state_dict(
        decoder_params_from_jax(_host(jstate.decoder_params)))
    lib = jstate.library
    tstate = dataclasses.replace(tstate, library=library_from_jax(
        np.asarray(lib.keys), np.asarray(lib.values), np.asarray(lib.labels),
        np.asarray(lib.positions), int(lib.fill), lib.capacity, "cpu"))
    jb = next(jbatch.stacked_batches(ds.graphs[24:], B, num_classes=CLASSES,
                                     num_graph_classes=CLASSES))
    tb = next(tbatch.stacked_batches(ds.graphs[24:], B, num_classes=CLASSES,
                                     num_graph_classes=CLASSES))
    return jtask, jstate, ttask, tstate, jb, tb


def _noise(key, retrieve_num=3):
    """The Gaussian noise JAX's ``retrieve`` draws from the step's key."""
    return _t(jax.random.normal(key, (B, 2 * retrieve_num, HIDDEN)))


def _grad_pairs(jgrads, tstate):
    enc = preprompt_params_from_jax(_host(jgrads["encoder"]))
    dec = decoder_params_from_jax(_host(jgrads["decoder"]))
    named = dict(tstate.encoder.named_parameters())
    out = [(k, v, named[k]) for k, v in enc.items()]
    named = dict(tstate.decoder.named_parameters())
    return out + [(k, v, named[k]) for k, v in dec.items()]


# ---- forward, loss, gradients -----------------------------------------------

@pytest.mark.parametrize("finetune", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
def test_forward(finetune, layers):
    jtask, jstate, ttask, tstate, jb, tb = _pair(finetune, layers=layers)
    assert int(jstate.library.fill) == 24
    want = jtask.forward(jstate, jb)
    with torch.no_grad():
        got = ttask.forward(tstate, tb)
    assert tuple(got.shape) == tuple(want.shape) == (B, CLASSES)
    _close(got, want)
    _close(got.sum(dim=1), np.ones(B), 1e-5)
    assert ttask.accuracy(tstate, [tb]) == pytest.approx(
        jtask.accuracy(jstate, [jb]), abs=1e-9)


@pytest.mark.parametrize("finetune", [False, True])
def test_forward_with_gaussian_noise(finetune):
    """Training with ``noise_finetune``: twice the rows, their values
    perturbed by JAX's normals; evaluation adds none."""
    jtask, jstate, ttask, tstate, jb, tb = _pair(finetune, noise=True)
    key = jax.random.key(9)
    want = jtask.forward(jstate, jb, training=True, key=key)
    with torch.no_grad():
        got = ttask.forward(tstate, tb, training=True, noise=_noise(key))
        _close(got, want)
        with pytest.raises(ValueError, match="generator"):
            ttask.forward(tstate, tb, training=True)
        _close(ttask.forward(tstate, tb), jtask.forward(jstate, jb))
        drawn = ttask.forward(tstate, tb, training=True,
                              generator=torch.Generator().manual_seed(0))
        assert bool(torch.isfinite(drawn).all())


@pytest.mark.parametrize("finetune", [False, True])
def test_loss_and_gradients(finetune):
    """With ``finetune`` the gradients reach the encoder (through the k-hop
    query) and the decoder; without it the output is the retrieved labels'
    mean, which no parameter reaches: JAX's gradients are all zero and the
    port's loss carries none."""
    jtask, jstate, ttask, tstate, jb, tb = _pair(finetune)

    def loss_fn(params):
        s = dataclasses.replace(jstate, encoder_params=params["encoder"],
                                decoder_params=params["decoder"])
        return jtask.loss(s, jb)
    want, jgrads = jax.value_and_grad(loss_fn)(
        {"encoder": jstate.encoder_params, "decoder": jstate.decoder_params})
    loss = ttask.loss(tstate, tb)
    _close(loss.detach(), want, 1e-6)
    pairs = _grad_pairs(jgrads, tstate)
    assert len(pairs) == 7     # GCN weight, bias, slope; two dense layers
    if not finetune:
        assert not loss.requires_grad
        assert all(float(np.abs(np.asarray(g)).max()) == 0
                   for _, g, _ in pairs)
        return
    loss.backward()
    for name, jgrad, prm in pairs:
        assert prm.grad is not None, name
        assert float(jgrad.abs().max()) > 0, name
        _close(prm.grad, jgrad, 1e-6)
    assert not tstate.library.keys.requires_grad


@pytest.mark.parametrize("noise", [False, True])
def test_ten_adam_steps_match_optax(noise):
    jtask, jstate, ttask, tstate, jb, tb = _pair(True, noise=noise)
    opt = optax.adam(1e-2)
    tstep = jtask.make_train_step(opt)
    opt_state = opt.init({"encoder": jstate.encoder_params,
                          "decoder": jstate.decoder_params})
    optimizer = ttask.make_optimizer(tstate, 1e-2)
    losses = []
    for i in range(10):
        key = jax.random.fold_in(jax.random.key(5), i)
        jstate, opt_state, want = tstep(jstate, opt_state, jb, key)
        got = ttask.train_step(tstate, optimizer, tb,
                               noise=_noise(key) if noise else None)
        _close(got, want, 1e-5)
        losses.append(float(got))
    assert losses[-1] < losses[0]
    enc = preprompt_params_from_jax(_host(jstate.encoder_params))
    dec = decoder_params_from_jax(_host(jstate.decoder_params))
    for k, v in enc.items():
        _close(tstate.encoder.state_dict()[k], v, 2e-5)
    for k, v in dec.items():
        _close(tstate.decoder.state_dict()[k], v, 2e-5)


def test_port_builds_the_same_library():
    """The port's own build from the converted encoder: one entry per
    real graph, the JAX package's keys, values and one-hot labels."""
    jtask, jstate, ttask, tstate, _, _ = _pair(False)
    ds = synthetic_tu_dataset(seed=3, num_graphs=31)
    fresh = ttask.init_state(torch.Generator().manual_seed(0),
                             library_capacity=512)
    fresh = RAGraphNodeState(tstate.encoder, tstate.decoder, fresh.library)
    built = ttask.build_library(
        fresh, tbatch.stacked_batches(ds.graphs[:24], B,
                                      num_classes=CLASSES,
                                      num_graph_classes=CLASSES))
    n = int(jstate.library.fill)
    assert int(built.library.fill) == n == 24
    _close(built.library.keys[:n], jstate.library.keys[:n], 1e-6)
    _close(built.library.values[:n], jstate.library.values[:n], 1e-6)
    _close(built.library.labels[:n], jstate.library.labels[:n], 0)
    labels = np.array([g.graph_label for g in ds.graphs[:24]])
    np.testing.assert_array_equal(
        built.library.labels[:n].argmax(dim=1).numpy(), labels)


def test_graph_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        RAGraphGraph(RAGraphGraphConfig(), FEAT)
    with pytest.raises(RuntimeError, match="cuda"):
        t_cli.main(["vanilla", "--level", "graph", "--test-times", "1"])
    assert GRAPH_FUSION_WEIGHTS["ENZYMES"] == (0.3, 0.8)
    cfg = graph_library_config(2, noise_std=0.1)
    assert (cfg.level, cfg.retrieve_num, cfg.noise_std) == ("graph", 3, 0.1)


# ---- the CLIs ---------------------------------------------------------------

def _shared_setup(tmp_path, monkeypatch, hidden=32):
    """One encoder checkpoint for both CLIs (a JAX ``PrePrompt`` with its
    heads), and the JAX decoder's initial values in the port (the CLIs draw
    it from their own generators)."""
    jenc = JPrePrompt(hidden=hidden, num_layers=1)
    ds = synthetic_tu_dataset(seed=0, num_graphs=4)
    g = next(jbatch.flat_batches(ds.graphs, 4))
    variables = jenc.init({"params": jax.random.key(3),
                           "dropout": jax.random.key(4)},
                          g.features, g.adj, jnp.zeros((128, 3), jnp.int32),
                          g.node_mask, method=jenc.init_all)
    j_save(str(tmp_path / "modelset" / "model_SYNTH"),
           _host(dict(variables)), use_orbax=False)
    calls = []
    init_state = RAGraphNode.init_state

    def init_with_jax_decoder(self, *args, **kwargs):
        state = init_state(self, *args, **kwargs)
        seed_i = len(calls)             # the CLI's run index is its seed
        calls.append(seed_i)
        _, k_dec = jax.random.split(jax.random.key(seed_i))
        jdec = JTaskDecoder(hidden=hidden, out=CLASSES)
        state.decoder.load_state_dict(decoder_params_from_jax(_host(dict(
            jdec.init(k_dec, jnp.zeros((1, hidden)))))))
        return state
    monkeypatch.setattr(RAGraphNode, "init_state", init_with_jax_decoder)
    return ["--dataset", "SYNTH", "--hidden", str(hidden), "--test-times",
            "2", "--save-dir", str(tmp_path / "modelset"),
            "--library-capacity", "4096", "--level", "graph"]


@pytest.mark.parametrize("mode,extra", [("vanilla", []),
                                        ("finetune", ["--epochs", "4"])])
def test_graph_cli_matches_jax(tmp_path, monkeypatch, mode, extra):
    """Both CLIs on SYNTH at the graph level from one JAX checkpoint with
    heads: each run's accuracy within one test graph (of 24) of JAX's."""
    argv = _shared_setup(tmp_path, monkeypatch) + extra
    j_mean = j_cli.main([mode] + argv + ["--results-dir",
                                         str(tmp_path / "j")])
    t_mean = t_cli.main([mode] + argv + ["--results-dir", str(tmp_path / "t"),
                                         "--device", "cpu"])
    with open(tmp_path / "j" / f"{mode}_graph_SYNTH.json") as f:
        want = json.load(f)
    with open(tmp_path / "t" / f"{mode}_graph_SYNTH.json") as f:
        got = json.load(f)
    assert sorted(got) == sorted(want) == ["accuracy", "mean", "std"]
    assert got["mean"] == t_mean and want["mean"] == j_mean
    assert len(got["accuracy"]) == 2
    one_graph = 100.0 / 24
    for a, b in zip(got["accuracy"], want["accuracy"]):
        assert abs(a - b) <= one_graph + 1e-9, (got, want)


def test_pretrain_then_graph_finetune_within_two_se(tmp_path):
    """``pretrain`` (hidden 32, 3 epochs of ``lp``) then ``finetune --level
    graph`` (10 epochs, 5 seeded runs) in each package on SYNTH on the CPU,
    each from its own checkpoint: the two seed means within 2 SE of their
    difference, the criterion of ``experiments/reference_e2e_differential
    *.py``; both well above chance (33%)."""
    common = ["--dataset", "SYNTH", "--hidden", "32"]
    pre = ["pretrain", "--pretrain-epochs", "3"]
    fin = ["finetune", "--level", "graph", "--epochs", "10",
           "--test-times", "5", "--library-capacity", "4096"]
    runs = {}
    for side, main, extra in (("jax", j_cli.main, []),
                              ("port", t_cli.main, ["--device", "cpu"])):
        dirs = ["--save-dir", str(tmp_path / side / "modelset"),
                "--results-dir", str(tmp_path / side)]
        main(pre + common + dirs + extra)
        with open(tmp_path / side / "pretrain_SYNTH.json") as f:
            losses = json.load(f)["epoch_losses"]
        assert len(losses) == 3 and losses[-1] < losses[0], (side, losses)
        main(fin + common + dirs + extra)
        with open(tmp_path / side / "finetune_graph_SYNTH.json") as f:
            runs[side] = np.array(json.load(f)["accuracy"])
    j, t = runs["jax"], runs["port"]
    se = float(np.sqrt(np.var(j, ddof=1) / len(j) + np.var(t, ddof=1)
                       / len(t)))
    assert abs(j.mean() - t.mean()) <= 2 * se + 1e-9, (j, t, se)
    assert j.mean() > 50 and t.mean() > 50, (j, t)
