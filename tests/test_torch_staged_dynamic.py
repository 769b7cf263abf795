"""The port's dynamic staged loop (``staged_dynamic``) and the model zoo's
edge CLI, on the synthetic stream on the CPU.

With ``edge_dropout=0`` the only draw of a ROLAND or EvolveGCN stage is the
GRU's initial weights: both packages' ``gru_cell_init`` are replaced by one
that returns the same numpy weights, the JAX sampler is held to its numpy
path, and the two loops then give the same recall and ndcg stage by stage
(``METRIC``: 1e-6, as the trainers' comparison in
``test_torch_edge_training.py``). The plugin crosses draw masks, noise and
mixing weights from their own generators, so they are held to the loop's own
guarantees: finite metrics, and a resumed run bit for bit the uninterrupted
one.
"""

import argparse
import functools
import json
import pickle

import _torch_threads  # noqa: F401  (torch's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragraph_tpu.cli import edge as j_cli
from ragraph_tpu.data.edgelist import EdgeDataset as JEdgeDataset
from ragraph_tpu.models import edge as jedge
from ragraph_tpu.models.edge import dynamic as j_dynamic
from ragraph_tpu.utils import native as j_native
from ragraph_tpu_torch.cli import edge as t_cli
from ragraph_tpu_torch.data.edgelist import EdgeDataset as TEdgeDataset
from ragraph_tpu_torch.data.edgelist import load_edge_dataset
from ragraph_tpu_torch.data.synthetic import synthetic_edge_stream
from ragraph_tpu_torch.models import edge as tedge
from ragraph_tpu_torch.models.edge import dynamic as t_dynamic
from ragraph_tpu_torch.train import trainer as t_trainer

METRIC = dict(rtol=0, atol=1e-6)


def _cfg(pkg, **kw):
    base = dict(emb_size=8, num_layers=2, batch_size=32, eval_batch_size=32,
                edge_dropout=0.2, early_stop_patience=3, lr=5e-3, n_negs=4,
                segsum_impl="scatter", propagate_dtype="f32")
    base.update(kw)
    return pkg.EdgeModelConfig(**base)


@pytest.fixture(scope="module")
def setup():
    train, stages = synthetic_edge_stream(seed=4, num_users=24,
                                          num_items=48, num_stages=3,
                                          interactions_per_user=6)
    ds = load_edge_dataset(train, [(u, i) for (u, i, _) in stages[0]])
    rng = np.random.default_rng(0)
    bound = np.sqrt(6.0 / (ds.num_users + 8))
    tables = {"user_embedding": rng.uniform(-bound, bound, (ds.num_users, 8))
              .astype(np.float32),
              "item_embedding": rng.uniform(-bound, bound, (ds.num_items, 8))
              .astype(np.float32)}
    return train, stages, tables


def _port(setup, model_cls, mode, stages=None, **kw):
    train, all_stages, tables = setup
    stages = list(all_stages if stages is None else stages)
    args = dict(device="cpu", mode=mode, num_epochs=2,
                logger=lambda *_: None)
    args.update(kw)
    cfg = args.pop("cfg", _cfg(tedge))
    return tedge.staged_dynamic(train, stages[0], stages, tables,
                                lambda phase: cfg, 1, model_cls, **args)


@pytest.mark.parametrize("cls_name,mode", [("Roland", "roland"),
                                           ("EvolveGCNH", "evolvegcn_h"),
                                           ("EvolveGCNO", "evolvegcn_o")])
def test_staged_dynamic_matches_jax(setup, monkeypatch, cls_name, mode):
    """Two stages of two epochs in each package from the same tables and
    GRU: the same recall and ndcg per stage (the port's counterpart of
    JAX's ``test_staged_dynamic_roland``, in each mode)."""
    train, stages, tables = setup
    rng = np.random.default_rng(5)
    gru = {k: rng.uniform(-0.35, 0.35, s).astype(np.float32) for k, s in (
        ("w_ih", (24, 8)), ("w_hh", (24, 8)), ("b_ih", (24,)),
        ("b_hh", (24,)))}
    monkeypatch.setattr(j_dynamic, "gru_cell_init", lambda key, size: {
        k: jnp.asarray(v) for k, v in gru.items()})
    monkeypatch.setattr(t_dynamic, "gru_cell_init",
                        lambda gen, size, device=None: {
                            k: torch.from_numpy(v.copy())
                            for k, v in gru.items()})
    monkeypatch.setattr(j_native, "negative_sample_native",
                        lambda *a, **k: None)
    for cls in (JEdgeDataset, TEdgeDataset):
        monkeypatch.setattr(cls, "sample_negatives", functools.partialmethod(
            cls.sample_negatives, use_native=False))
    cfg = dict(edge_dropout=0.0)
    want = jedge.staged_dynamic(
        train, stages[0], list(stages[:2]), tables,
        cfg_factory=lambda phase: _cfg(jedge, **cfg), key=jax.random.key(1),
        model_cls=getattr(jedge, cls_name), mode=mode, num_epochs=2,
        logger=lambda *_: None)
    logs = []
    got = _port(setup, getattr(tedge, cls_name), mode, stages=stages[:2],
                cfg=_cfg(tedge, **cfg), logger=logs.append)
    assert len(got.recalls) == len(want.recalls) == 2
    np.testing.assert_allclose(got.recalls, want.recalls, **METRIC)
    np.testing.assert_allclose(got.ndcgs, want.ndcgs, **METRIC)
    assert all(np.isfinite(got.recalls))
    assert sum(m.startswith("--- dynamic stage") for m in logs) == 2


CROSSES = [(tedge.Roland, "roland"),
           (tedge.EvolveGCNH, "evolvegcn_h"),
           (tedge.make_dynamic(tedge.SGLPlugin, "roland"), "roland"),
           (tedge.make_dynamic(tedge.SimGCLPlugin, "evolvegcn_h"),
            "evolvegcn_h"),
           (tedge.make_prompted(tedge.make_dynamic(tedge.MixGCFPlugin,
                                                   "evolvegcn_o"), "gpf"),
            "evolvegcn_o")]


@pytest.mark.parametrize("model_cls,mode", CROSSES,
                         ids=[c.__name__ for c, _ in CROSSES])
def test_staged_dynamic_resume_bit_equal(setup, tmp_path, model_cls, mode):
    """Interrupted after stage 1 and resumed: the same metrics as the
    uninterrupted run, exactly. The state carries the tables, the meta
    params (the GRU's among them) and the last embeddings."""
    full = _port(setup, model_cls, mode)
    assert len(full.recalls) == 3 and np.isfinite(full.recalls).all()
    ckpt = str(tmp_path / "dyn")
    part = _port(setup, model_cls, mode, checkpoint_dir=ckpt,
                 stop_after_stage=1)
    assert part.recalls == full.recalls[:1]
    with open(tmp_path / "dyn" / "staged_state.pkl", "rb") as f:
        state = pickle.load(f)
    assert set(state) == {"stage", "tables", "meta_params", "last_emb",
                          "recalls", "ndcgs"}
    assert set(state["meta_params"]["gru"]) == {"w_ih", "w_hh", "b_ih",
                                                "b_hh"}
    assert state["last_emb"].shape == (24 + 48, 8)
    resumed = _port(setup, model_cls, mode, checkpoint_dir=ckpt,
                    resume=True)
    assert resumed.recalls == full.recalls
    assert resumed.ndcgs == full.ndcgs


def test_staged_dynamic_carries_the_meta_state(setup, monkeypatch):
    """ROLAND's meta params after stage 2 are the EMA of stage 2's best
    params and stage 1's, with weight 0.9 on the old; each stage starts
    from the carried GRU."""
    seen = []
    orig = t_trainer.EdgeTrainer.train

    def spy(self, params, *a, **k):
        res = orig(self, params, *a, **k)
        seen.append(({n: t.clone() for n, t in params["gru"].items()},
                     res.best_params))
        return res

    monkeypatch.setattr(t_trainer.EdgeTrainer, "train", spy)
    states = []
    monkeypatch.setattr(tedge.staged, "_save_stage_state",
                        lambda d, s: states.append(s))
    _port(setup, tedge.Roland, "roland", stages=setup[1][:2],
          checkpoint_dir="unused")
    (gru1, best1), (gru2, best2) = seen
    for k in gru2:
        torch.testing.assert_close(gru2[k], best1["gru"][k])
    merged = tedge.ema_merge(best2, best1, 0.9)
    for k in ("user_embedding", "item_embedding"):
        torch.testing.assert_close(states[1]["meta_params"][k], merged[k])
    torch.testing.assert_close(states[1]["meta_params"]["gru"]["w_ih"],
                               merged["gru"]["w_ih"])


def test_staged_dynamic_guards(setup):
    train, stages, tables = setup
    short = {k: v[:-1] for k, v in tables.items()}
    with pytest.raises(ValueError, match="wrong checkpoint"):
        tedge.staged_dynamic(train, stages[0], list(stages), short,
                             lambda phase: _cfg(tedge), 1, tedge.Roland,
                             device="cpu")
    class IdxMesh:      # the surface of a dp=1,idx=2 DeviceMesh read here
        mesh_dim_names = ("dp", "idx")

        def size(self, i):
            return (1, 2)[i]

        def get_local_rank(self, name):
            return 0

    # the dynamic models' tables do not shard over idx (the JAX CLI refuses
    # them too); the refusal comes before any collective
    with pytest.raises(ValueError, match="tables shard over idx only"):
        _port(setup, tedge.Roland, "roland", mesh=IdxMesh())


# -- the CLI ----------------------------------------------------------------

CHOICES = ([None, "roland", "evolvegcn_h", "evolvegcn_o"],
           [None, "graphprompt", "gpf"])


def _combos():
    return [(m, d, p) for m in t_cli.MODELS for d in CHOICES[0]
            for p in CHOICES[1]]


def test_cli_accepts_and_refuses_as_jax():
    """Every ``--model`` x ``--dynamic`` x ``--prompt``: the port builds a
    class where the JAX CLI does (the same name, or GP with the same
    prompt mode) and refuses the rest with its message."""
    assert list(t_cli.MODELS) == j_cli.build_parser()._option_string_actions[
        "--model"].choices
    assert t_cli.DYNAMIC_MODELS == j_cli.DYNAMIC_MODELS
    refused = 0
    for model, dynamic, prompt in _combos():
        args = argparse.Namespace(model=model, dynamic=dynamic,
                                  prompt=prompt)
        try:
            want = j_cli._model_cls(args)
        except SystemExit as e:
            with pytest.raises(SystemExit) as got:
                t_cli._model_cls(args)
            assert str(got.value.code) == str(e.code)
            refused += 1
            continue
        got = t_cli._model_cls(args)
        if isinstance(want, functools.partial):
            assert got.func.__name__ == want.func.__name__
            assert got.keywords == want.keywords
        else:
            assert got.__name__ == want.__name__, (model, dynamic, prompt)
        assert t_cli._is_dynamic(args) == j_cli._is_dynamic(args)
        assert t_cli._dynamic_mode(args) == j_cli._dynamic_mode(args)
    assert refused == 73


def _legal(model):
    out = []
    for d in CHOICES[0]:
        for p in CHOICES[1]:
            args = argparse.Namespace(model=model, dynamic=d, prompt=p)
            try:
                j_cli._model_cls(args)
            except SystemExit:
                continue
            out.append((d, p))
    return out


@pytest.mark.parametrize("model", list(t_cli.MODELS))
def test_cli_runs_every_model_and_cross(tmp_path, model):
    """``pretrain`` (GraphPro's tables for a dynamic model) then
    ``finetune`` with every ``--dynamic`` and ``--prompt`` the JAX CLI
    takes for this model: four finite stages each, in the JAX CLI's file
    names."""
    args = ["--data-path", "SYNTH", "--batch-size", "128", "--epochs", "1",
            "--emb-size", "8", "--num-layers", "2", "--device", "cpu",
            "--save-dir", str(tmp_path), "--model", model, "--n-negs", "4"]
    t_cli.main(["pretrain"] + args)
    assert (tmp_path / f"pretrain_{model}_SYNTH.pkl").exists()
    for dynamic, prompt in _legal(model):
        extra = (["--dynamic", dynamic] if dynamic else []) \
            + (["--prompt", prompt] if prompt else [])
        res = t_cli.main(["finetune"] + args + extra)
        tag = "-".join([model] + [x for x in (dynamic, prompt) if x])
        with open(tmp_path / f"finetune_{tag}_SYNTH.json") as f:
            out = json.load(f)
        assert out["recalls"] == res.recalls and len(res.recalls) == 4
        assert np.isfinite(res.recalls + res.ndcgs).all(), (model, extra)

