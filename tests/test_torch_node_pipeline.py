"""The static node pipeline as a whole, port against JAX package:
``RAGraphNode.forward`` in both modes, the loss and its gradients, ten Adam
steps against ``optax``, the checkpoint conversion, and the two CLIs on
SYNTH.

Both sides start from the same numbers: the JAX package initialises the
encoder and the decoder and builds the library, and the port gets them
through ``ragraph_tpu_torch.convert``. The library is built without
inverse sampling, augmentation and positions, so it holds no all-zero keys
and no two equal rows: retrieval is tie-free and both sides fetch the same
rows. Tolerances: 1e-5 on outputs of order 1 (f32, other summation order),
2e-5 on parameters after ten Adam steps at lr 1e-2.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ragraph_tpu.rag as j_rag
from ragraph_tpu.cli import node as j_cli
from ragraph_tpu.data import batching as jbatch
from ragraph_tpu.models.preprompt import PrePrompt as JPrePrompt
from ragraph_tpu.models.ragraph_node import RAGraphNode as JRAGraphNode
from ragraph_tpu.models.ragraph_node import \
    RAGraphNodeConfig as JRAGraphNodeConfig
from ragraph_tpu.nn.heads import TaskDecoder as JTaskDecoder
from ragraph_tpu.rag.library import LibraryConfig as JLibraryConfig
from ragraph_tpu.train.checkpoint import save_checkpoint as j_save
from ragraph_tpu_torch.cli import node as t_cli
from ragraph_tpu_torch.convert import (complete_preprompt_state,
                                       decoder_params_from_jax,
                                       library_from_jax,
                                       preprompt_params_from_jax)
from ragraph_tpu_torch.data import batching as tbatch
from ragraph_tpu_torch.data.synthetic import synthetic_tu_dataset
from ragraph_tpu_torch.models import preprompt as t_preprompt
from ragraph_tpu_torch.models.ragraph_node import (RAGraphNode,
                                                   RAGraphNodeConfig,
                                                   RAGraphNodeState)
from ragraph_tpu_torch.nn.heads import TaskDecoder
from ragraph_tpu_torch.rag.library import LibraryConfig

ATOL = 1e-5
HIDDEN, FEAT, CLASSES = 16, 16, 3
DETERMINISTIC = dict(num_inverse_sample=0, num_augment_scale=0,
                     use_positions=False)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _pair(finetune=True, noise=False, layers=1):
    """The JAX task with a built library, the port's task with the
    converted state, and a val batch on both sides."""
    ds = synthetic_tu_dataset(seed=3, num_graphs=24)
    kw = dict(emb_size=HIDDEN, num_class=CLASSES, finetune=finetune,
              noise_finetune=noise, encoder_layers=layers)
    jcfg = JRAGraphNodeConfig(library=JLibraryConfig(
        retrieve_num=4, **DETERMINISTIC), **kw)
    tcfg = RAGraphNodeConfig(library=LibraryConfig(
        retrieve_num=4, **DETERMINISTIC), **kw)
    jtask = JRAGraphNode(jcfg, FEAT)
    jstate = jtask.init_state(jax.random.key(1), library_capacity=512)
    jstate = jtask.build_library(
        jstate, jbatch.stacked_batches(ds.graphs[:16], 8,
                                       num_classes=CLASSES),
        jax.random.key(2))
    ttask = RAGraphNode(tcfg, FEAT, device="cpu")
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
    jg = next(jbatch.flat_batches(ds.graphs[16:], 8, num_classes=CLASSES))
    tg = next(tbatch.flat_batches(ds.graphs[16:], 8, num_classes=CLASSES))
    return jtask, jstate, ttask, tstate, jg, tg


def _grad_pairs(jgrads, tstate):
    """(name, JAX gradient in the port's layout, port parameter)."""
    enc = preprompt_params_from_jax(_host(jgrads["encoder"]))
    dec = decoder_params_from_jax(_host(jgrads["decoder"]))
    named = dict(tstate.encoder.named_parameters())
    out = [(k, v, named[k]) for k, v in enc.items()]
    named = dict(tstate.decoder.named_parameters())
    return out + [(k, v, named[k]) for k, v in dec.items()]


# ---- forward, loss, gradients ----------------------------------------------

@pytest.mark.parametrize("finetune", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
def test_forward(finetune, layers):
    jtask, jstate, ttask, tstate, jg, tg = _pair(finetune, layers=layers)
    want = jtask.forward(jstate, jg)
    with torch.no_grad():
        got = ttask.forward(tstate, tg)
    assert tuple(got.shape) == tuple(want.shape) == (128, CLASSES)
    _close(got, want)
    real = tg.node_mask
    _close(got[real].sum(dim=1), np.ones(int(real.sum())), 1e-5)
    assert ttask.accuracy(tstate, [tg]) == pytest.approx(
        jtask.accuracy(jstate, [jg]), abs=1e-9)


def test_forward_with_noise_rows():
    """Training mode with ``noise_finetune``: twice the rows plus one random
    live row, JAX's ``randint`` with the same key handed to the port."""
    jtask, jstate, ttask, tstate, jg, tg = _pair(True, noise=True)
    key = jax.random.key(9)
    want = jtask.forward(jstate, jg, training=True, key=key)
    idx = np.asarray(jax.random.randint(key, (128, 1), 0,
                                        int(jstate.library.fill)))
    with torch.no_grad():
        got = ttask.forward(tstate, tg, training=True,
                            noise_idx=torch.from_numpy(np.array(idx)))
    _close(got, want)
    with pytest.raises(ValueError, match="generator"):
        ttask.forward(tstate, tg, training=True)
    # evaluation never adds noise
    with torch.no_grad():
        _close(ttask.forward(tstate, tg), jtask.forward(jstate, jg))


def test_loss_and_gradients():
    jtask, jstate, ttask, tstate, jg, tg = _pair(True)

    def loss_fn(params):
        s = dataclasses.replace(jstate, encoder_params=params["encoder"],
                                decoder_params=params["decoder"])
        return jtask.loss(s, jg)
    want, jgrads = jax.value_and_grad(loss_fn)(
        {"encoder": jstate.encoder_params, "decoder": jstate.decoder_params})
    loss = ttask.loss(tstate, tg)
    _close(loss.detach(), want, 1e-6)
    loss.backward()
    pairs = _grad_pairs(jgrads, tstate)
    assert len(pairs) == 7     # GCN weight, bias, slope; two dense layers
    for name, jgrad, prm in pairs:
        assert prm.grad is not None, name
        assert float(jgrad.abs().max()) > 0, name
        _close(prm.grad, jgrad, 1e-6)
    # the library is a buffer and the batch norms take no part
    assert not tstate.library.keys.requires_grad
    assert all(p.grad is None for n, p in
               tstate.encoder.named_parameters() if "bns" in n)


@pytest.mark.parametrize("noise", [False, True])
def test_ten_adam_steps_match_optax(noise):
    jtask, jstate, ttask, tstate, jg, tg = _pair(True, noise=noise)
    opt = optax.adam(1e-2)
    tstep = jtask.make_train_step(opt)
    opt_state = opt.init({"encoder": jstate.encoder_params,
                          "decoder": jstate.decoder_params})
    optimizer = ttask.make_optimizer(tstate, 1e-2)
    fill = int(jstate.library.fill)
    losses = []
    for i in range(10):
        key = jax.random.fold_in(jax.random.key(5), i)
        jstate, opt_state, want = tstep(jstate, opt_state, jg, key)
        idx = torch.from_numpy(np.array(
            jax.random.randint(key, (128, 1), 0, fill))) if noise else None
        got = ttask.train_step(tstate, optimizer, tg, noise_idx=idx)
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
    """The port's own build from the converted encoder gives the store the
    JAX package built."""
    jtask, jstate, ttask, tstate, _, _ = _pair(False)
    ds = synthetic_tu_dataset(seed=3, num_graphs=24)
    fresh = ttask.init_state(torch.Generator().manual_seed(0),
                             library_capacity=512)
    fresh = RAGraphNodeState(tstate.encoder, tstate.decoder, fresh.library)
    built = ttask.build_library(
        fresh, tbatch.stacked_batches(ds.graphs[:16], 8,
                                      num_classes=CLASSES))
    n = int(jstate.library.fill)
    assert int(built.library.fill) == n > 0
    _close(built.library.keys[:n], jstate.library.keys[:n], 2e-5)
    _close(built.library.values[:n], jstate.library.values[:n], 2e-5)
    _close(built.library.labels[:n], jstate.library.labels[:n], 0)


def test_init_state_draws_from_the_generator():
    cfg = RAGraphNodeConfig(emb_size=HIDDEN, library=LibraryConfig())
    task = RAGraphNode(cfg, FEAT, device="cpu")
    a = task.init_state(torch.Generator().manual_seed(4))
    b = task.init_state(torch.Generator().manual_seed(4))
    c = task.init_state(torch.Generator().manual_seed(5))
    wa = a.encoder.gcn.convs[0].lin.weight
    assert torch.equal(wa, b.encoder.gcn.convs[0].lin.weight)
    assert not torch.equal(wa, c.encoder.gcn.convs[0].lin.weight)
    assert float(wa.detach().abs().max()) <= (6.0 / (FEAT + HIDDEN)) ** 0.5
    assert float(a.encoder.gcn.convs[0].act.slope.detach()) == 0.25
    assert float(a.decoder.dense_0.bias.detach().abs().sum()) == 0
    assert a.library.keys.shape == (4097, HIDDEN)
    assert a.library.positions.shape == (4097, 10)
    assert isinstance(a.decoder, TaskDecoder) and len(a.parameters()) == 9


def test_node_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        RAGraphNode(RAGraphNodeConfig(), FEAT)
    with pytest.raises(RuntimeError, match="cuda"):
        t_cli.main(["vanilla", "--test-times", "1"])


# ---- conversion ----------------------------------------------------------------

def test_preprompt_conversion_skips_heads_by_name():
    """The full tree of the JAX ``PrePrompt`` (all heads initialised): the
    encoder and the pretraining heads convert (a head the port does not
    know still raises), and the port loads the result strictly;
    ``embed``, ``encode`` and ``decode`` agree."""
    ds = synthetic_tu_dataset(seed=2, num_graphs=4)
    jg = next(jbatch.flat_batches(ds.graphs, 4, num_classes=CLASSES))
    tg = next(tbatch.flat_batches(ds.graphs, 4, num_classes=CLASSES))
    jenc = JPrePrompt(hidden=HIDDEN, num_layers=2)
    variables = jenc.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jg.features, jg.adj, jnp.zeros((128, 3), jnp.int32), jg.node_mask,
        method=jenc.init_all)
    host = _host(dict(variables))
    assert {"lp", "dgi", "graphcl_edge", "graphcl_mask"} <= set(
        host["params"])
    state = preprompt_params_from_jax(host)
    assert {"lp.prompt", "dgi.disc.bilinear_w", "graphcl_edge.prompt",
            "graphcl_mask.disc.bilinear_b"} <= set(state)
    np.testing.assert_array_equal(
        state["dgi.disc.bilinear_w"].numpy(),
        host["params"]["dgi"]["BilinearDiscriminator_0"]["bilinear_w"])
    port = t_preprompt.PrePrompt(FEAT, HIDDEN, 2)
    port.load_state_dict(state)             # complete: bns and heads
    ja = (jg.features, jg.adj, jg.node_mask)
    ta = (tg.features, tg.adj, tg.node_mask)
    with torch.no_grad():
        _close(port.inference(*ta), jenc.apply(variables, *ja,
                                               method=jenc.inference))
        h, c = port.embed(*ta)
        jh, jc = jenc.apply(variables, *ja, method=jenc.embed)
        _close(h, jh)
        _close(c, jc)
        first = port.encode(*ta)
        _close(first, jenc.apply(variables, *ja, method=jenc.encode))
        _close(port.decode(first, ta[1], ta[2]),
               jenc.apply(variables, jnp.asarray(first.numpy()), ja[1],
                          ja[2], method=jenc.decode))
    bad = {"params": dict(host["params"], extra_head={})}
    with pytest.raises(ValueError):
        preprompt_params_from_jax(bad)
    with pytest.raises(ValueError):
        complete_preprompt_state({"gcn.convs.9.bias": torch.zeros(1)}, port)


# ---- the CLIs --------------------------------------------------------------------

def _shared_setup(tmp_path, monkeypatch):
    """One encoder checkpoint for both CLIs, the deterministic library
    settings on both sides, and the JAX decoder's initial values in the
    port (the CLIs draw it from their own generators)."""
    jenc = JPrePrompt(hidden=32, num_layers=1)
    variables = jenc.init(jax.random.key(3), jnp.zeros((8, FEAT)),
                          jnp.eye(8), method=jenc.inference)
    j_save(str(tmp_path / "modelset" / "model_SYNTH"),
           _host(dict(variables)), use_orbax=False)
    monkeypatch.setattr(j_rag, "LibraryConfig",
                        functools.partial(JLibraryConfig, **DETERMINISTIC))
    monkeypatch.setattr(t_cli, "LibraryConfig",
                        functools.partial(LibraryConfig, **DETERMINISTIC))
    calls = []
    init_state = RAGraphNode.init_state

    def init_with_jax_decoder(self, *args, **kwargs):
        state = init_state(self, *args, **kwargs)
        seed_i = len(calls)             # the CLI's run index is its seed
        calls.append(seed_i)
        _, k_dec = jax.random.split(jax.random.key(seed_i))
        jdec = JTaskDecoder(hidden=32, out=CLASSES)
        state.decoder.load_state_dict(decoder_params_from_jax(_host(dict(
            jdec.init(k_dec, jnp.zeros((1, 32)))))))
        return state
    monkeypatch.setattr(RAGraphNode, "init_state", init_with_jax_decoder)
    return ["--dataset", "SYNTH", "--hidden", "32", "--test-times", "2",
            "--save-dir", str(tmp_path / "modelset")]


@pytest.mark.parametrize("mode,tag,extra", [
    ("vanilla", "vanilla", []),
    ("finetune", "finetune", ["--epochs", "3"]),
    ("finetune", "noise", ["--epochs", "2", "--noise"])])
def test_node_cli_matches_jax(tmp_path, monkeypatch, mode, tag, extra):
    """Both CLIs on SYNTH from one encoder checkpoint. ``vanilla`` and
    ``finetune`` reach equal accuracies run by run (a node whose two best
    classes are all but tied may fall either way: one node of a test split
    of about 380 is allowed per run). With ``--noise`` the random rows
    differ by design, so only the result file and the level are held."""
    argv = _shared_setup(tmp_path, monkeypatch) + extra
    j_mean = j_cli.main([mode] + argv + ["--results-dir",
                                         str(tmp_path / "j")])
    t_mean = t_cli.main([mode] + argv + ["--results-dir", str(tmp_path / "t"),
                                         "--device", "cpu"])
    with open(tmp_path / "j" / f"{tag}_node_SYNTH.json") as f:
        want = json.load(f)
    with open(tmp_path / "t" / f"{tag}_node_SYNTH.json") as f:
        got = json.load(f)
    assert sorted(got) == sorted(want) == ["accuracy", "mean", "std"]
    assert got["mean"] == t_mean and want["mean"] == j_mean
    assert len(got["accuracy"]) == 2
    if tag == "noise":
        assert all(a > 80.0 for a in got["accuracy"] + want["accuracy"])
    else:
        one_node = 100.0 / 350
        for a, b in zip(got["accuracy"], want["accuracy"]):
            assert abs(a - b) <= one_node, (got, want)


@pytest.mark.parametrize("argv,what", [
    (["finetune", "--mesh", "dp=1;idx=1"], "--mesh expects dp=D,idx=I")])
def test_node_cli_unported_exits_point_at_the_roadmap(argv, what):
    """Nothing is left unported (``--mesh`` came last); a malformed
    ``--mesh`` exits non-zero naming the flag's form, as the JAX CLI does."""
    with pytest.raises(SystemExit) as exc:
        t_cli.main(argv + ["--device", "cpu"])
    assert what in str(exc.value) and exc.value.code != 0


def test_node_cli_random_encoder_and_flags(tmp_path):
    """No checkpoint: a random encoder, as in the JAX CLI; the parser takes
    every flag of the JAX CLI; the rescore pad needs int8."""
    mean = t_cli.main(["vanilla", "--hidden", "16", "--test-times", "1",
                       "--save-dir", str(tmp_path / "none"), "--results-dir",
                       str(tmp_path), "--device", "cpu",
                       "--library-capacity", "4096"])
    assert mean > 50.0
    j_flags = {a.dest for a in j_cli.build_parser()._actions}
    t_flags = {a.dest for a in t_cli.build_parser()._actions}
    assert j_flags - t_flags == set()
    assert t_flags - j_flags == {"device", "dist_backend"}
    with pytest.raises(SystemExit):
        t_cli.main(["vanilla", "--retrieve-rescore-pad", "4", "--device",
                    "cpu"])


def test_node_cli_reads_a_port_state_dict(tmp_path):
    from ragraph_tpu_torch.train.checkpoint import save_checkpoint
    enc = t_preprompt.PrePrompt(FEAT, 16, generator=torch.Generator()
                                .manual_seed(1))
    save_checkpoint(str(tmp_path / "model_SYNTH"), enc.state_dict())
    state = t_cli.load_encoder_state(str(tmp_path), "SYNTH")
    assert sorted(state) == sorted(enc.state_dict())
    assert torch.equal(state["gcn.convs.0.lin.weight"],
                       enc.gcn.convs[0].lin.weight)
    assert t_cli.load_encoder_state(str(tmp_path / "none"), "SYNTH") is None


def test_node_cli_observer_sees_every_stage_and_changes_nothing(tmp_path):
    """An observer is told of each stage of the protocol in order, with the
    objects the stage made, and the run's accuracy is the unobserved run's
    (exactly: the hooks compute nothing)."""
    import contextlib

    class Seen(t_cli.RunObserver):
        def __init__(self):
            self.log, self.fills = [], []

        @contextlib.contextmanager
        def stage(self, name):
            self.log.append(("begin", name))
            yield
            self.log.append(("end", name))

        def after(self, name, **objects):
            self.log.append(("after", name))
            if "state" in objects:
                self.fills.append(int(objects["state"].library.fill))
            if name == "finetune_epoch":
                assert len(objects["losses"]) == 3   # 36 val graphs / 16

    argv = ["finetune", "--hidden", "16", "--test-times", "1", "--epochs",
            "2", "--save-dir", str(tmp_path / "none"), "--results-dir",
            str(tmp_path), "--device", "cpu", "--library-capacity", "3000"]
    seen = Seen()
    assert t_cli.main(argv, observer=seen) == t_cli.main(argv)
    stages = ["library_build_train"] + ["finetune_epoch"] * 2 \
        + ["library_build_val", "test_accuracy"]
    assert [n for what, n in seen.log if what == "begin"] == stages
    assert [n for what, n in seen.log if what == "end"] == stages
    assert [n for what, n in seen.log if what == "after"] == [
        "library_build_train", "finetune_epoch", "finetune_epoch",
        "finetune", "library_build_val"]
    # 60 train graphs x 4 copies x 10 samples, then the clamp at capacity
    assert seen.fills == [2400, 2400, 3000]
