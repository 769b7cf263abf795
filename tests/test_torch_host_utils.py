"""The port's single-device utilities against the JAX package's:
``data/planetoid.py``, ``train/torch_import.py`` (and ``cli.edge finetune
--pre-model-path x.pt``), ``train/logging.py``, ``train/profiling.py``,
``utils/seed.py``, ``config.py`` and ``train/checkpoint.py``'s
``restore_checkpoint(template=)``.
"""

import argparse
import json
import logging
import os
import pickle
import random

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ragraph_tpu import config as j_config
from ragraph_tpu.cli import edge as j_edge_cli
from ragraph_tpu.data import planetoid as j_planetoid
from ragraph_tpu.train import checkpoint as j_checkpoint
from ragraph_tpu.train import torch_import as j_torch_import
from ragraph_tpu_torch import config as t_config
from ragraph_tpu_torch.cli import edge as t_edge_cli
from ragraph_tpu_torch.data import planetoid as t_planetoid
from ragraph_tpu_torch.train import profiling
from ragraph_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from ragraph_tpu_torch.train.logging import RunLogger, log_exceptions
from ragraph_tpu_torch.train.torch_import import tables_from_torch
from ragraph_tpu_torch.utils.seed import seed_everything


# -- planetoid ----------------------------------------------------------------

def write_planetoid(data_dir, name, n_train=6, n_allx=10, n_test=5,
                    n_feat=4, n_class=3, missing_test=()):
    """Write ``ind.<name>.{x,y,tx,ty,allx,ally,graph,test.index}``; the
    offsets in ``missing_test`` are absent from tx/ty/test.index, as
    Citeseer's isolated test nodes are."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(1)
    n_total = n_allx + n_test
    present = np.asarray([i for i in range(n_test) if i not in missing_test])
    feats = rng.random((n_total, n_feat)).astype(np.float32)
    labels = np.eye(n_class, dtype=np.int64)[
        rng.integers(0, n_class, size=n_total)]
    graph = {i: [] for i in range(n_total)}
    for _ in range(3 * n_total):
        u, v = (int(x) for x in rng.integers(0, n_total, size=2))
        if u != v and v not in graph[u]:
            graph[u].append(v)
            graph[v].append(u)
    objs = {"x": sp.csr_matrix(feats[:n_train]), "y": labels[:n_train],
            "tx": sp.csr_matrix(feats[n_allx + present]),
            "ty": labels[n_allx + present],
            "allx": sp.csr_matrix(feats[:n_allx]), "ally": labels[:n_allx],
            "graph": graph}
    for k, v in objs.items():
        with open(os.path.join(data_dir, f"ind.{name}.{k}"), "wb") as f:
            pickle.dump(v, f)
    with open(os.path.join(data_dir, f"ind.{name}.test.index"), "w") as f:
        f.write("\n".join(str(i) for i in (n_allx + present)[::-1]))


@pytest.mark.parametrize("name,missing", [("cora", ()),
                                          ("citeseer", (1, 3))])
def test_load_planetoid_matches_jax(tmp_path, name, missing):
    write_planetoid(str(tmp_path), name, missing_test=missing)
    got = t_planetoid.load_planetoid(str(tmp_path), name)
    want = j_planetoid.load_planetoid(str(tmp_path), name)
    np.testing.assert_array_equal(got[0].toarray(), want[0].toarray())
    for g, w in zip(got[1:3], want[1:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3:] == want[3:]
    if missing:   # the isolated test nodes are zero rows
        assert got[1].shape[0] == 15
        assert not got[1][[11, 13]].any() and not got[2][[11, 13]].any()


def test_planetoid_helpers_match_jax():
    rng = np.random.default_rng(2)
    feats = rng.random((20, 6)).astype(np.float32)
    feats[3] = 0.0
    mask = t_planetoid.sample_mask([0, 2, 5, 7], 20)
    np.testing.assert_array_equal(mask, j_planetoid.sample_mask([0, 2, 5, 7],
                                                                20))
    np.testing.assert_array_equal(t_planetoid.row_normalize_features(feats),
                                  j_planetoid.row_normalize_features(feats))
    np.testing.assert_array_equal(
        t_planetoid.standardize_data(feats, mask),
        j_planetoid.standardize_data(feats, mask))
    adj = (rng.random((9, 9)) < 0.2).astype(np.float32)
    for hops in (1, 2):
        np.testing.assert_array_equal(t_planetoid.adj_to_bias(adj, hops),
                                      j_planetoid.adj_to_bias(adj, hops))
    logits = rng.standard_normal((20, 6)).astype(np.float32)
    labels = (rng.random((20, 6)) < 0.4).astype(np.float32)
    assert t_planetoid.micro_f1(logits, labels) == \
        j_planetoid.micro_f1(logits, labels)


# -- .pt import ---------------------------------------------------------------

class Tables(torch.nn.Module):
    def __init__(self, ue, ie):
        super().__init__()
        self.user_embedding = torch.nn.Embedding.from_pretrained(ue)
        self.item_embedding = torch.nn.Embedding.from_pretrained(ie)


def _pt(path, kind, ue, ie):
    bare = {"user_embedding": ue, "item_embedding": ie}
    objs = {
        "bare": bare,
        "state_dict": {"state_dict": bare, "epoch": 3},
        "model_state_dict": {"model_state_dict": bare},
        "model": {"model": bare},
        "module": Tables(ue, ie),
        "weight_suffix": {"state_dict": {f"{k}.weight": v
                                         for k, v in bare.items()},
                          "args": argparse.Namespace(lr=1e-3)},
    }
    torch.save(objs[kind], path)
    return str(path)


@pytest.mark.parametrize("kind", ["bare", "state_dict", "model_state_dict",
                                  "model", "module", "weight_suffix"])
def test_tables_from_torch_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(3)
    ue = torch.from_numpy(rng.normal(size=(5, 4)).astype(np.float32))
    ie = torch.from_numpy(rng.normal(size=(7, 4)).astype(np.float32))
    path = _pt(tmp_path / "w.pt", kind, ue, ie)
    got = tables_from_torch(path)
    want = j_torch_import.tables_from_torch(path)
    assert set(got) == set(want) == {"user_embedding", "item_embedding"}
    for k in got:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["item_embedding"], ie.numpy())


def test_tables_from_torch_missing_table_raises(tmp_path):
    path = str(tmp_path / "w.pt")
    torch.save({"user_embedding": torch.zeros(2, 2)}, path)
    with pytest.raises(KeyError, match="item_embedding"):
        tables_from_torch(path)
    with pytest.raises(KeyError, match="item_embedding"):
        j_torch_import.tables_from_torch(path)


def test_cli_finetune_from_pt_matches_jax(tmp_path):
    """``finetune --pre-model-path x.pt`` in both packages at tiny widths:
    LightGCN draws nothing at random once dropout is off and both take
    their negatives from the same C++ sampler, so the metrics agree."""
    rng = np.random.default_rng(4)
    pt = _pt(tmp_path / "x.pt", "weight_suffix",
             torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32)),
             torch.from_numpy(rng.normal(size=(128, 8)).astype(np.float32)))
    args = ["finetune", "--data-path", "SYNTH", "--emb-size", "8",
            "--num-layers", "2", "--epochs", "1", "--batch-size", "128",
            "--model", "LightGCN", "--edge-dropout", "0",
            "--pre-model-path", pt]
    want = j_edge_cli.main(args + ["--save-dir", str(tmp_path / "j")])
    got = t_edge_cli.main(args + ["--save-dir", str(tmp_path / "t"),
                                  "--device", "cpu"])
    assert len(got.recalls) == 4 and np.isfinite(got.recalls).all()
    np.testing.assert_allclose(got.recalls, want.recalls, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.ndcgs, want.ndcgs, rtol=0, atol=1e-4)
    logs = list((tmp_path / "t").glob("train_log_*.txt"))
    assert len(logs) == 1 and "avg recall" in logs[0].read_text()


# -- logging ------------------------------------------------------------------

def test_run_logger_writes_its_file(tmp_path):
    log = RunLogger(save_dir=str(tmp_path), exp_name="unit")
    log("hello")
    log.log_loss(2, {"loss": 0.25, "steps": 4})
    log.log_eval({"recall": np.array([0.5, 0.75]), "eval_time": 1.5},
                 ks=(10, 20))
    log.close()
    assert os.path.dirname(log.log_path) == str(tmp_path)
    assert os.path.basename(log.log_path).startswith("train_log_")
    text = open(log.log_path).read()
    assert f"PID: {os.getpid()}" in text and "CMD: python " in text
    assert "hello" in text and "[epoch 2] loss=0.25000 steps=4" in text
    assert "[eval] recall@10=0.50000 recall@20=0.75000 eval_time=1.5" in text
    assert RunLogger(exp_name="unit", echo_argv=False).log_path is None


def test_log_exceptions_logs_and_reraises(caplog):
    @log_exceptions
    def boom(x):
        raise KeyError(x)

    with caplog.at_level(logging.ERROR, logger="ragraph_tpu_torch"):
        with pytest.raises(KeyError, match="7"):
            boom(7)
    assert "exception in boom" in caplog.text and "KeyError" in caplog.text
    assert log_exceptions(lambda: 3)() == 3


# -- profiling ----------------------------------------------------------------

def test_phase_totals_and_annotate():
    """``phase_totals`` sums the latest recording's spans by name; the old
    ``phase`` timer and the ``annotate`` decorator are gone (``span`` is
    the one range)."""
    with profiling.span("unit-phase"):      # tracing off: records nothing
        sum(range(1000))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            with profiling.span("unit-phase"):
                sum(range(1000))
    rec = profiling.recorded()
    assert [s.name for s in rec.spans] == ["unit-phase"] * 2
    total = profiling.phase_totals()["unit-phase"]
    assert total > 0
    assert total == pytest.approx(sum(s.host_s for s in rec.spans))
    assert not hasattr(profiling, "annotate")
    assert not hasattr(profiling, "phase")


def test_op_profile_rows_on_cpu():
    a, b = torch.randn(256, 256), torch.randn(256, 256)
    rows = profiling.op_profile(lambda x, y: (x @ y).relu(), a, b, iters=2,
                                min_ms=0.0)
    assert rows and set(rows[0]) == {"type", "name", "occurrences",
                                     "ms_per_call"}
    assert all(r["type"] == "cpu_op" for r in rows)
    names = {r["name"] for r in rows}
    assert names & {"aten::mm", "aten::matmul"} and "aten::relu" in names
    ms = [r["ms_per_call"] for r in rows]
    assert ms == sorted(ms, reverse=True)


def test_trace_and_memory_record_on_cpu(tmp_path):
    profiling.start_trace(str(tmp_path))
    with pytest.raises(RuntimeError, match="already"):
        profiling.start_trace(str(tmp_path))
    torch.randn(64, 64).sum()
    path = profiling.stop_trace()
    assert os.path.dirname(path) == str(tmp_path)
    assert "traceEvents" in json.load(open(path))
    lines = []
    assert profiling.record_memory_analysis("unit", "cpu", lines.append) \
        is None
    assert "no device memory statistics" in lines[0]


def test_finiteness_checks():
    ok = {"a": torch.ones(3), "b": (np.zeros(2), torch.arange(3)),
          "c": [np.int32(1), "name"]}
    assert profiling.tree_all_finite(ok)
    profiling.assert_all_finite(ok)
    assert profiling.tree_all_finite({})
    for bad in ({"a": torch.tensor([1.0, float("nan")])},
                {"b": [np.array([np.inf])]}):
        assert not profiling.tree_all_finite(bad)
        with pytest.raises(ValueError, match="non-finite values detected "
                                             "in params"):
            profiling.assert_all_finite(bad, "params")


# -- seed and config ------------------------------------------------------------

def test_seed_everything():
    gen, rng = seed_everything(11)
    first = (random.random(), np.random.rand(), torch.rand(1).item(),
             torch.rand(1, generator=gen).item(), rng.integers(1 << 30))
    gen, rng = seed_everything(11)
    again = (random.random(), np.random.rand(), torch.rand(1).item(),
             torch.rand(1, generator=gen).item(), rng.integers(1 << 30))
    assert first == again
    assert rng.integers(1 << 30) == np.random.default_rng(11).integers(
        1 << 30, size=2)[1]


def test_experiment_config_matches_jax(tmp_path):
    got, want = t_config.ExperimentConfig(), j_config.ExperimentConfig()
    assert got.to_dict() == want.to_dict()
    assert list(got.to_dict()) == list(want.to_dict())
    cfg = got.replace(task="edge", seed=7,
                      edge=got.edge.__class__(metrics_k=(10, 50)))
    path = str(tmp_path / "cfg.json")
    cfg.to_json(path)
    assert t_config.ExperimentConfig.from_json(path) == cfg
    assert t_config.ExperimentConfig.from_json(cfg.to_json()) == cfg
    # a file of either package loads in the other
    back = j_config.ExperimentConfig.from_json(path)
    assert back.to_dict() == cfg.to_dict()
    assert t_config.ExperimentConfig.from_json(back.to_json()) == cfg


# -- checkpoints ----------------------------------------------------------------

def test_restore_checkpoint_with_template(tmp_path):
    rng = np.random.default_rng(5)
    tree = {"user_embedding": rng.normal(size=(4, 3)).astype(np.float32),
            "lora": (rng.normal(size=(4, 2)), rng.normal(size=(2, 3))),
            "epoch": 3}
    path = save_checkpoint(str(tmp_path / "state"), tree)
    template = {"user_embedding": torch.zeros(4, 3, dtype=torch.bfloat16),
                "lora": (torch.zeros(4, 2), torch.zeros(2, 3,
                                                        dtype=torch.float64)),
                "epoch": 0}
    got = restore_checkpoint(path, template=template)
    assert got["user_embedding"].dtype == torch.bfloat16
    torch.testing.assert_close(got["user_embedding"],
                               torch.from_numpy(tree["user_embedding"]).to(
                                   torch.bfloat16))
    assert isinstance(got["lora"], tuple)
    assert got["lora"][0].dtype == torch.float32
    assert got["lora"][1].dtype == torch.float64
    np.testing.assert_array_equal(got["lora"][1].numpy(), tree["lora"][1])
    assert got["epoch"] == 3
    plain = restore_checkpoint(path)
    assert isinstance(plain["user_embedding"], np.ndarray)
    # a pickle the JAX package wrote, restored onto tensors
    j_path = j_checkpoint.save_checkpoint(
        str(tmp_path / "j"), {"user_embedding": jnp.ones((4, 3))},
        use_orbax=False)
    got = restore_checkpoint(j_path, template={"user_embedding":
                                               torch.zeros(4, 3)})
    assert torch.equal(got["user_embedding"], torch.ones(4, 3))


def test_restore_checkpoint_refuses_orbax_directory(tmp_path):
    path = j_checkpoint.save_checkpoint(
        str(tmp_path / "orbax"), {"w": jnp.ones(3)}, use_orbax=True)
    assert os.path.isdir(path)
    with pytest.raises(ValueError, match="orbax.*pickle"):
        restore_checkpoint(path)


def test_trainer_memory_hook(monkeypatch):
    """``RAGRAPH_MEM_ANALYSIS`` makes ``EdgeTrainer.train`` record the
    device's memory after its first step (on the CPU: that there is none)."""
    from ragraph_tpu_torch.data.edgelist import load_edge_dataset
    from ragraph_tpu_torch.data.synthetic import synthetic_edge_stream
    from ragraph_tpu_torch.models.edge import (EdgeGraphArrays,
                                               EdgeModelConfig, LightGCNEdge)
    from ragraph_tpu_torch.train.trainer import EdgeTrainer
    train, stages = synthetic_edge_stream(seed=0, num_users=32,
                                          num_items=64, num_stages=1)
    ds = load_edge_dataset(train, [(u, i) for u, i, _ in stages[0]])
    cfg = EdgeModelConfig(emb_size=8, num_layers=1, batch_size=64,
                          eval_batch_size=32)
    model = LightGCNEdge(cfg, EdgeGraphArrays.from_dataset(ds, "cpu"),
                         phase="pretrain")
    monkeypatch.setenv("RAGRAPH_MEM_ANALYSIS", "1")
    lines = []
    EdgeTrainer(model, ds, logger=lines.append).train(
        model.init_params(torch.Generator().manual_seed(0)),
        torch.Generator().manual_seed(1), num_epochs=2,
        rng=np.random.default_rng(0))
    mem = [m for m in lines if m.startswith("[mem] edge_step")]
    assert len(mem) == 1 and "no device memory statistics" in mem[0]
