"""The port's staged finetuning loop, its checkpoints and the three CLI
modes, on the synthetic stream on the CPU.

The two packages draw different random numbers (the ``for_tune`` gate, the
dropout salts), so the staged loops are not compared number by number: the
merge and the checkpoint files are, and the loop is held to its own
guarantees (a resumed run equals an uninterrupted one bit for bit).
"""

import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragraph_tpu.cli import edge as j_edge_cli
from ragraph_tpu.models.edge import staged as j_staged
from ragraph_tpu.train.checkpoint import BestCheckpointKeeper as JKeeper
from ragraph_tpu.train.checkpoint import restore_checkpoint as j_restore
from ragraph_tpu_torch.cli import edge as t_edge_cli
from ragraph_tpu_torch.data.edgelist import load_edge_dataset
from ragraph_tpu_torch.data.synthetic import synthetic_edge_stream
from ragraph_tpu_torch.models.edge import (EdgeGraphArrays, EdgeModelConfig,
                                           GraphPro, RAGraphEdge, Roland,
                                           SGLPlugin, staged)
from ragraph_tpu_torch.train.checkpoint import (BestCheckpointKeeper,
                                                restore_checkpoint)


def _cfg(**kw):
    base = dict(emb_size=16, num_layers=2, batch_size=128,
                eval_batch_size=64, edge_dropout=0.3, lr=5e-3,
                early_stop_patience=5, retrieve_num=5, retrieve_weight=0.3)
    base.update(kw)
    return EdgeModelConfig(**base)


@pytest.fixture(scope="module")
def setup():
    train, stages = synthetic_edge_stream(seed=0, num_users=48,
                                          num_items=96, num_stages=3,
                                          interactions_per_user=10)
    ds = load_edge_dataset(train, [(u, i) for (u, i, _) in stages[0]])
    pre = GraphPro(_cfg(), EdgeGraphArrays.from_dataset(ds, "cpu"),
                   phase="pretrain")
    params = pre.init_params(torch.Generator().manual_seed(0))
    tables = {"user_embedding": params["user_embedding"].numpy(),
              "item_embedding": params["item_embedding"].numpy()}
    return train, stages, tables


def _run(setup, **kw):
    train, stages, tables = setup
    args = dict(cfg_factory=lambda phase: _cfg(), seed=2, device="cpu",
                num_epochs=3, updt_inter=2, logger=lambda *_: None)
    args.update(kw)
    return staged.staged_finetune(train, stages[0], list(stages), tables,
                                  **args)


@pytest.mark.parametrize("n_recent", [0, 1, 3])
def test_interpolative_merge_matches_jax(n_recent):
    """Tolerance 1e-6: one f32 rounding of a weighted sum of unit rows."""
    rng = np.random.default_rng(n_recent)

    def tables():
        return {"user_embedding": rng.normal(size=(12, 8)).astype(np.float32),
                "item_embedding": rng.normal(size=(20, 8)).astype(np.float32)}

    pre, recent = tables(), [tables() for _ in range(n_recent)]
    want = j_staged.interpolative_merge(
        {k: jnp.asarray(v) for k, v in pre.items()}, recent)
    got = staged.interpolative_merge(
        pre, [{k: torch.from_numpy(v) for k, v in t.items()}
              for t in recent])
    for k in pre:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)
    if n_recent:
        np.testing.assert_allclose(
            np.linalg.norm(np.asarray(got["user_embedding"]), axis=1), 1.0,
            atol=1e-6)


@pytest.mark.parametrize("stop_after", [1, 2])
def test_staged_finetune_resume_bit_equal(setup, tmp_path, stop_after):
    """Interrupted after stage 1, and inside the merge window after stage 2
    (``updt_inter=2``): the resumed run's metrics equal the uninterrupted
    run's exactly, not within a tolerance."""
    full = _run(setup)
    assert len(full.recalls) == 3
    ckpt = str(tmp_path / "staged")
    part = _run(setup, checkpoint_dir=ckpt, stop_after_stage=stop_after)
    assert part.recalls == full.recalls[:stop_after]
    with open(tmp_path / "staged" / "staged_state.pkl", "rb") as f:
        state = pickle.load(f)
    assert state["stage"] == stop_after
    assert len(state["saved_tables"]) == min(stop_after, 2)
    assert isinstance(state["recalls"][0], float)
    resumed = _run(setup, checkpoint_dir=ckpt, resume=True)
    assert resumed.recalls == full.recalls
    assert resumed.ndcgs == full.ndcgs
    assert np.isfinite(full.avg_recall) and np.isfinite(full.avg_ndcg)
    assert not (tmp_path / "staged" / "staged_state.pkl.tmp").exists()


def test_staged_finetune_resume_complete_run_is_noop(setup, tmp_path):
    ckpt = str(tmp_path / "staged")
    full = _run(setup, checkpoint_dir=ckpt)
    calls = []
    resumed = _run(setup, checkpoint_dir=ckpt, resume=True,
                   cfg_factory=lambda phase: calls.append(phase) or _cfg())
    assert resumed.recalls == full.recalls and calls == []


def test_staged_seed_and_early_stop(setup):
    """Another seed gives another run; patience 1 cuts a stage's epochs;
    LoRA, noise and the GraphPro backbone all run through the loop."""
    logs = []
    a = _run(setup, logger=logs.append)
    b = _run(setup, seed=3)
    assert a.recalls != b.recalls
    assert sum("epoch 2:" in m for m in logs) == 3
    logs = []
    _run(setup, logger=logs.append, num_epochs=6,
         cfg_factory=lambda phase: _cfg(early_stop_patience=1, lr=0.0))
    assert any("early stop at epoch 1" in m for m in logs)
    assert not any("epoch 2:" in m for m in logs)
    for kw in (dict(use_lora=True, lora_rank=4),
               dict(use_lora=True, lora_rank=4, lora_init_scale=1.0,
                    lora_train_factors=False),
               dict(use_noise=True)):
        res = _run(setup, num_epochs=1,
                   cfg_factory=lambda phase, kw=kw: _cfg(**kw))
        assert len(res.recalls) == 3 and np.isfinite(res.recalls).all()
    res = _run(setup, num_epochs=1, model_cls=GraphPro)
    assert np.isfinite(res.recalls).all()
    gens = [staged.stage_generator(2, s, p, torch.device("cpu")).initial_seed()
            for s in (1, 2) for p in (1, 6)]
    assert len(set(gens)) == 4


class IdxMesh:
    """The surface of a ``dp=1,idx=2`` DeviceMesh that the model reads."""
    mesh_dim_names = ("dp", "idx")

    def size(self, i):
        return (1, 2)[i]

    def get_local_rank(self, name):
        return 0


def test_staged_guards(setup):
    train, stages, tables = setup
    short = {k: v[:-1] for k, v in tables.items()}
    with pytest.raises(ValueError, match="wrong checkpoint"):
        _run((train, stages, short))
    late = [list(s) for s in stages]
    late[2] = late[2] + [(48, 0, late[2][0][2])]
    with pytest.raises(ValueError, match="beyond the base id range"):
        _run((train, late, tables))
    # tables shard over idx only in the base models; the refusal comes
    # before any collective (the surface of a DeviceMesh it reads)
    with pytest.raises(ValueError, match="tables shard over idx only"):
        staged.staged_dynamic(train, stages[0], stages, tables,
                              lambda phase: _cfg(), 2, Roland,
                              device="cpu", mesh=IdxMesh())
    with pytest.raises(ValueError, match="tables shard over idx only"):
        _run(setup, mesh=IdxMesh(), model_cls=SGLPlugin)
    assert RAGraphEdge.use_rag and not GraphPro.use_rag


def test_keeper_files_are_read_by_the_other_package(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"user_embedding": rng.normal(size=(5, 4)).astype(np.float32),
            "item_embedding": rng.normal(size=(6, 4)).astype(np.float32)}
    tk = BestCheckpointKeeper(str(tmp_path / "t"), name="best")
    assert tk.update(0.1, {k: torch.from_numpy(v) for k, v in tree.items()})
    assert not tk.update(0.05, tree) and tk.best_metric == 0.1
    assert tk.path.endswith("best.pkl")
    jk = JKeeper(str(tmp_path / "j"), name="best")
    assert jk.update(0.2, {k: jnp.asarray(v) for k, v in tree.items()})
    for path, restore in ((tk.path, lambda p: j_restore(p, use_orbax=False)),
                          (jk.path, restore_checkpoint)):
        back = restore(path)
        for k, v in tree.items():
            np.testing.assert_array_equal(np.asarray(back[k]), v)


def test_cli_pretrain_finetune_vanilla_and_checkpoint_interop(tmp_path):
    """The three modes in order on the CPU, with the JAX CLI's result files
    and keys; then each package's pretrain checkpoint through the other."""
    common = ["--data-path", "SYNTH", "--batch-size", "128", "--epochs", "2",
              "--emb-size", "16", "--num-layers", "2"]
    t_dir, j_dir = str(tmp_path / "t"), str(tmp_path / "j")
    t_args = common + ["--save-dir", t_dir, "--device", "cpu"]
    path = t_edge_cli.main(["pretrain"] + t_args)
    assert path == f"{t_dir}/pretrain_RAGraph_SYNTH.pkl"
    with open(f"{t_dir}/pretrain_RAGraph_SYNTH.json") as f:
        assert set(json.load(f)) == {"best_recall", "best_ndcg"}
    res = t_edge_cli.main(["finetune"] + t_args + ["--lora", "zero"])
    assert len(res.recalls) == 4 and np.isfinite(res.recalls).all()
    with open(f"{t_dir}/finetune_RAGraph_SYNTH.json") as f:
        out = json.load(f)
    assert set(out) == {"recalls", "ndcgs", "avg_recall", "avg_ndcg"}
    assert out["recalls"] == res.recalls
    recalls, ndcgs = t_edge_cli.main(["vanilla"] + t_args)
    assert len(recalls) == 4

    # the port's pretrain checkpoint through the JAX CLI: the same tables,
    # so the same training-free evaluation (1e-4, as for the vanilla CLI)
    j_recalls, j_ndcgs = j_edge_cli.main(
        ["vanilla"] + common + ["--save-dir", t_dir])
    np.testing.assert_allclose(recalls, j_recalls, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ndcgs, j_ndcgs, rtol=0, atol=1e-4)

    # and the JAX CLI's pretrain checkpoint through the port
    j_path = j_edge_cli.main(["pretrain"] + common + ["--save-dir", j_dir])
    tables = restore_checkpoint(j_path)
    assert tables["user_embedding"].shape == (64, 16)
    j_args = common + ["--save-dir", j_dir, "--device", "cpu"]
    recalls, _ = t_edge_cli.main(["vanilla"] + j_args)
    j_recalls, _ = j_edge_cli.main(["vanilla"] + common
                                   + ["--save-dir", j_dir])
    np.testing.assert_allclose(recalls, j_recalls, rtol=0, atol=1e-4)
    res = t_edge_cli.main(["finetune"] + j_args + ["--model", "RAGraph"])
    assert len(res.recalls) == 4


def test_cli_finetune_pretrains_when_no_checkpoint_and_resumes(tmp_path):
    args = ["--data-path", "SYNTH", "--batch-size", "128", "--epochs", "1",
            "--emb-size", "16", "--num-layers", "2", "--device", "cpu",
            "--model", "GraphPro", "--save-dir", str(tmp_path),
            "--stage-ckpt-dir", str(tmp_path / "ckpt")]
    first = t_edge_cli.main(["finetune"] + args)
    assert (tmp_path / "pretrain_GraphPro_SYNTH.pkl").exists()
    assert (tmp_path / "finetune_GraphPro_SYNTH.json").exists()
    again = t_edge_cli.main(["finetune"] + args + ["--resume"])
    assert again.recalls == first.recalls
    with pytest.raises(SystemExit, match="stage-ckpt-dir"):
        t_edge_cli.main(["finetune", "--resume", "--device", "cpu"])
    # a reference .pt (tables under "state_dict", nn.Embedding names)
    tables = restore_checkpoint(str(tmp_path / "pretrain_GraphPro_SYNTH"))
    pt = tmp_path / "weights.pt"
    torch.save({"state_dict": {f"{k}.weight": torch.from_numpy(v)
                               for k, v in tables.items()}}, pt)
    from_pt = t_edge_cli.main(["finetune"] + args[:-2]
                              + ["--pre-model-path", str(pt)])
    assert from_pt.recalls == first.recalls
    # the zoo's refusals, before any work, with the JAX CLI's messages
    with pytest.raises(SystemExit, match="--dynamic requires a plugin"):
        t_edge_cli.main(["finetune", "--device", "cpu", "--model",
                         "GraphPro", "--dynamic", "roland"])
    with pytest.raises(SystemExit, match="--prompt requires a plugin"):
        t_edge_cli.main(["finetune", "--device", "cpu", "--model",
                         "roland", "--prompt", "gpf"])
