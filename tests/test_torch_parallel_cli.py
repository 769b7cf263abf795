"""The port's three CLIs with ``--mesh`` under ``python -m
torch.distributed.run --standalone --nproc-per-node 4 ... --device cpu``
(gloo), against the same CLIs in one process without ``--mesh``, and the
edge CLI against the JAX CLI on a mesh where nothing is drawn at random
(LightGCN from a tables file, ``--edge-dropout 0``). The huge-k route of
``cli.edge vanilla --mesh`` is checked with a spy in ranks started by
``tests/_torch_parallel_workers.py``.

Metrics agree to 1e-5 between the port's runs (every rank draws what the
single process draws; only sums over ranks reassociate) and to 1e-4 with
the JAX CLI, as ``tests/test_torch_host_utils.py`` holds the single-device
edge CLI.
"""

import concurrent.futures as cf
import json
import os
import pickle
import subprocess
import sys

import _torch_threads
import numpy as np
import pytest

from _torch_parallel_workers import REPO, run_world
from ragraph_tpu.cli import edge as j_edge_cli
from ragraph_tpu_torch.cli import edge as t_edge_cli
from ragraph_tpu_torch.cli import fewshot as t_fewshot_cli
from ragraph_tpu_torch.cli import node as t_node_cli

MESH = ["--mesh", "dp=2,idx=2", "--device", "cpu"]
EDGE = ["--data-path", "SYNTH", "--emb-size", "8", "--num-layers", "2",
        "--batch-size", "128"]
NODE = ["finetune", "--dataset", "SYNTH", "--hidden", "16", "--epochs", "2",
        "--batch-size", "8", "--test-times", "1"]
FEWSHOT = NODE + ["--retrieve-num", "3", "--library-capacity", "16384"]


def _env():
    # the module's torchrun jobs run two at a time, four ranks each
    env = {**os.environ, "PYTHONPATH": REPO, **_torch_threads.env(2 * 4)}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def _torchrun(module: str, args: list, cwd, nproc: int = 4):
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", module, *args],
        cwd=cwd, env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, (res.stdout + res.stderr)[-6000:]
    return res


def _json(path):
    with open(path) as f:
        return json.load(f)


def _tables(path):
    rng = np.random.default_rng(4)
    with open(path, "wb") as f:
        pickle.dump({"user_embedding": rng.normal(size=(64, 8)).astype(
            np.float32), "item_embedding": rng.normal(size=(128, 8)).astype(
            np.float32)}, f)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every ``torch.distributed.run`` job, two at a time."""
    tmp = tmp_path_factory.mktemp("cli")
    tables = _tables(tmp / "tables.pkl")

    def edge():
        d = str(tmp / "edge")
        _torchrun("ragraph_tpu_torch.cli.edge",
                  ["pretrain", *EDGE, "--epochs", "2", "--save-dir", d,
                   *MESH], tmp)
        _torchrun("ragraph_tpu_torch.cli.edge",
                  ["finetune", *EDGE, "--epochs", "1", "--save-dir", d,
                   *MESH], tmp)
        return d

    def edge_lightgcn():
        d = str(tmp / "edge_lgn")
        _torchrun("ragraph_tpu_torch.cli.edge",
                  ["finetune", *EDGE, "--epochs", "1", "--model",
                   "LightGCN", "--edge-dropout", "0", "--pre-model-path",
                   tables, "--save-dir", d, *MESH], tmp)
        return d

    def task(module, args, level, name):
        d = str(tmp / name)
        _torchrun(module, [*args, "--level", level, "--save-dir", d,
                           "--results-dir", d, *MESH], tmp)
        return d

    jobs = {"edge": (edge,), "edge_lgn": (edge_lightgcn,)}
    for level in ("node", "graph"):
        jobs[f"node_{level}"] = (task, "ragraph_tpu_torch.cli.node",
                                 NODE + ["--library-capacity", "2048"],
                                 level, f"node_{level}")
        jobs[f"fewshot_{level}"] = (task, "ragraph_tpu_torch.cli.fewshot",
                                    FEWSHOT, level, f"fewshot_{level}")
    with cf.ThreadPoolExecutor(2) as ex:
        futs = {k: ex.submit(*v) for k, v in jobs.items()}
        out = {k: f.result() for k, f in futs.items()}
    out["tmp"], out["tables"] = tmp, tables
    return out


def test_edge_mesh_cli_matches_one_process(runs, tmp_path):
    """``pretrain`` then ``finetune --mesh dp=2,idx=2`` (RAGraph, edge
    dropout 0.5, the tables row-sharded over idx): the metrics of the run
    in one process; the JAX CLI's file names, written once by rank 0,
    with one run log for each mode."""
    d = tmp_path / "one"
    t_edge_cli.main(["pretrain", *EDGE, "--epochs", "2", "--save-dir",
                     str(d), "--device", "cpu"])
    want = t_edge_cli.main(["finetune", *EDGE, "--epochs", "1",
                            "--save-dir", str(d), "--device", "cpu"])
    mesh_dir = runs["edge"]
    got = _json(os.path.join(mesh_dir, "finetune_RAGraph_SYNTH.json"))
    np.testing.assert_allclose(got["recalls"], want.recalls, atol=1e-5)
    np.testing.assert_allclose(got["ndcgs"], want.ndcgs, atol=1e-5)
    pre = _json(os.path.join(mesh_dir, "pretrain_RAGraph_SYNTH.json"))
    np.testing.assert_allclose(
        pre["best_recall"],
        _json(d / "pretrain_RAGraph_SYNTH.json")["best_recall"], atol=1e-5)
    files = sorted(os.listdir(mesh_dir))
    assert files[:3] == ["finetune_RAGraph_SYNTH.json",
                         "pretrain_RAGraph_SYNTH.json",
                         "pretrain_RAGraph_SYNTH.pkl"]
    logs = [f for f in files if f.startswith("train_log_")]
    assert len(files) == 5 and len(logs) == 2
    assert any("avg recall" in open(os.path.join(mesh_dir, f)).read()
               for f in logs)
    with open(os.path.join(mesh_dir, "pretrain_RAGraph_SYNTH.pkl"),
              "rb") as f:
        tables = pickle.load(f)
    assert tables["user_embedding"].shape == (64, 8)    # whole, not a block
    assert tables["item_embedding"].shape == (128, 8)


def test_edge_mesh_cli_matches_jax_cli(runs, tmp_path):
    """LightGCN from one tables file with ``--edge-dropout 0`` draws nothing
    at random: the port's ``--mesh dp=2,idx=2`` run gives the metrics of
    the JAX CLI's ``--mesh dp=2,idx=4`` run (its 8 virtual devices) and of
    the port in one process."""
    args = ["finetune", *EDGE, "--epochs", "1", "--model", "LightGCN",
            "--edge-dropout", "0", "--pre-model-path", runs["tables"]]
    want = j_edge_cli.main(args + ["--mesh", "dp=2,idx=4", "--save-dir",
                                   str(tmp_path / "j")])
    one = t_edge_cli.main(args + ["--save-dir", str(tmp_path / "t"),
                                  "--device", "cpu"])
    got = _json(os.path.join(runs["edge_lgn"],
                             "finetune_LightGCN_SYNTH.json"))
    np.testing.assert_allclose(got["recalls"], want.recalls, atol=1e-4)
    np.testing.assert_allclose(got["ndcgs"], want.ndcgs, atol=1e-4)
    np.testing.assert_allclose(got["recalls"], one.recalls, atol=1e-5)
    np.testing.assert_allclose(got["ndcgs"], one.ndcgs, atol=1e-5)


@pytest.mark.parametrize("level", ["node", "graph"])
def test_node_mesh_cli_matches_one_process(runs, tmp_path, level):
    """The library built sharded over idx and the fine-tune batches over dp:
    the accuracy of the run in one process, the file written once."""
    want = t_node_cli.main(NODE + ["--library-capacity", "2048", "--level",
                                   level, "--save-dir", str(tmp_path),
                                   "--results-dir", str(tmp_path),
                                   "--device", "cpu"])
    got = _json(os.path.join(runs[f"node_{level}"],
                             f"finetune_{level}_SYNTH.json"))
    np.testing.assert_allclose(got["mean"], want, atol=1e-5)
    assert np.isfinite(got["mean"]) and got["mean"] > 33.0


@pytest.mark.parametrize("level", ["node", "graph"])
def test_fewshot_mesh_cli_matches_one_process(runs, tmp_path, level):
    want = t_fewshot_cli.main(FEWSHOT + ["--level", level, "--save-dir",
                                         str(tmp_path), "--results-dir",
                                         str(tmp_path), "--device", "cpu"])
    got = _json(os.path.join(runs[f"fewshot_{level}"],
                             f"fewshot_finetune_{level}_SYNTH_shot5.json"))
    np.testing.assert_allclose(got["mean"], want, atol=1e-5)
    assert got["mean"] > 40.0


@pytest.fixture(scope="module")
def spy_world(tmp_path_factory):
    """Four ranks: ``pretrain`` and ``vanilla --mesh dp=2,idx=2`` with every
    retrieval forced into the huge-k branch and its sharded fusion counted,
    and SGL (a plugin, whose loss couples the batch's rows) on a dp-only
    mesh."""
    d = str(tmp_path_factory.mktemp("spy"))
    mesh = ["--mesh", "dp=2,idx=2", "--device", "cpu", "--save-dir", d]
    cases = [
        ("pretrain", "cli", dict(argv_module="ragraph_tpu_torch.cli.edge",
                                 argv=["pretrain", *EDGE, "--epochs", "2",
                                       *mesh])),
        ("vanilla", "cli", dict(argv_module="ragraph_tpu_torch.cli.edge",
                                argv=["vanilla", *EDGE, *mesh],
                                spy="huge_k")),
        ("sgl", "cli", dict(argv_module="ragraph_tpu_torch.cli.edge",
                            argv=["pretrain", *EDGE, "--epochs", "2",
                                  "--model", "SGL", "--mesh", "dp=4,idx=1",
                                  "--device", "cpu", "--save-dir",
                                  d + "_sgl"]))]
    return run_world(4, cases, d, 300, "spy"), d


def test_edge_mesh_cli_vanilla_reaches_sharded_huge_k(spy_world, tmp_path,
                                                      monkeypatch):
    """``vanilla --mesh``: the CLI path reaches the idx-sharded fusion
    (SYNTH's 192 library rows divide over idx=2) on every rank, and its
    metrics are those of the single-process huge-k branch."""
    from ragraph_tpu_torch.models.edge import ragraph_edge
    ranks, d = spy_world
    monkeypatch.setattr(ragraph_edge, "_BIG_K_ELEMS", 0)
    want = t_edge_cli.main(["vanilla", *EDGE, "--save-dir", d,
                            "--device", "cpu"])
    for got in ranks:
        assert got["vanilla"]["calls"] > 0
        recalls, ndcgs = got["vanilla"]["out"]
        assert len(recalls) == 4
        np.testing.assert_allclose(recalls, want[0], atol=1e-5)
        np.testing.assert_allclose(ndcgs, want[1], atol=1e-5)


def test_edge_dp_mesh_plugin_matches_one_process(spy_world, tmp_path):
    """SGL on ``--mesh dp=4,idx=1``: every rank takes the whole batch (the
    in-batch contrastive loss couples its rows), and the run equals one
    process's."""
    ranks, d = spy_world
    t_edge_cli.main(["pretrain", *EDGE, "--epochs", "2", "--model", "SGL",
                     "--save-dir", str(tmp_path), "--device", "cpu"])
    want = _json(tmp_path / "pretrain_SGL_SYNTH.json")
    got = _json(os.path.join(d + "_sgl", "pretrain_SGL_SYNTH.json"))
    np.testing.assert_allclose(got["best_recall"], want["best_recall"],
                               atol=1e-5)
    assert ranks[0]["sgl"]["out"].endswith("pretrain_SGL_SYNTH.pkl")


@pytest.mark.parametrize("extra", [
    ["--model", "SGL"], ["--model", "GP"], ["--model", "roland"],
    ["--model", "SGL", "--dynamic", "roland"],
    ["--model", "LightGCN", "--prompt", "gpf"]])
def test_edge_mesh_cli_refuses_idx_sharding_of_baselines(tmp_path, extra):
    """idx>1 with a plugin, dynamic or prompt model exits with the JAX
    CLI's words, before joining any process group."""
    with pytest.raises(SystemExit, match="idx>1"):
        t_edge_cli.main(["pretrain", "--data-path", "SYNTH", *extra,
                         "--mesh", "dp=1,idx=2", "--device", "cpu",
                         "--save-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="idx>1"):
        j_edge_cli.main(["pretrain", "--data-path", "SYNTH", *extra,
                         "--mesh", "dp=1,idx=8", "--save-dir",
                         str(tmp_path)])


@pytest.mark.parametrize("cli", [t_edge_cli, t_node_cli, t_fewshot_cli])
def test_mesh_spec_malformed(tmp_path, cli):
    mode = "pretrain" if cli is t_edge_cli else "finetune"
    with pytest.raises(SystemExit, match="--mesh expects dp=D,idx=I"):
        cli.main([mode, "--mesh", "dp=2;idx=2", "--device", "cpu",
                  "--save-dir", str(tmp_path)])


def test_mesh_world_of_one_and_a_wrong_world(tmp_path):
    """Without ``torch.distributed.run`` a process is a world of one:
    ``--mesh dp=1,idx=1`` gives the result of no mesh, and ``dp=2,idx=2``
    is refused."""
    args = ["pretrain", *EDGE, "--epochs", "1", "--device", "cpu"]
    code = ("import sys; from ragraph_tpu_torch.cli import edge; "
            "edge.main(sys.argv[1:])")
    res = subprocess.run(
        [sys.executable, "-c", code, *args, "--mesh", "dp=1,idx=1",
         "--save-dir", str(tmp_path / "m")], cwd=tmp_path, env=_env(),
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    t_edge_cli.main(args + ["--save-dir", str(tmp_path / "one")])
    assert _json(tmp_path / "m" / "pretrain_RAGraph_SYNTH.json") == \
        _json(tmp_path / "one" / "pretrain_RAGraph_SYNTH.json")
    res = subprocess.run(
        [sys.executable, "-c", code, *args, "--mesh", "dp=2,idx=2",
         "--save-dir", str(tmp_path / "w")], cwd=tmp_path, env=_env(),
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "dp*idx = 2*2 != 1 ranks" in res.stderr


def test_parallel_imports_without_jax():
    """``ragraph_tpu_torch.parallel`` and the test ranks' module import in
    a process where ``jax`` cannot be imported."""
    code = ("import sys; sys.modules['jax'] = None\n"
            "import ragraph_tpu_torch.parallel as p\n"
            "import _torch_parallel_workers\n"
            "assert p.make_mesh and p.sharded_huge_k_fuse\n"
            "assert not any(m == 'ragraph_tpu' or m.startswith('ragraph_tpu.')"
            " for m in sys.modules)\n")
    env = {**_env(), "PYTHONPATH": REPO + os.pathsep
           + os.path.join(REPO, "tests")}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
