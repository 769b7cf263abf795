"""The port's CLI against the JAX CLI, checkpoint interop, and the guards
that keep the port free of JAX and of a hidden CPU path."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ragraph_tpu.cli import edge as j_edge_cli
from ragraph_tpu.train.checkpoint import restore_checkpoint as j_restore
from ragraph_tpu.train.checkpoint import save_checkpoint as j_save
from ragraph_tpu_torch.cli import edge as t_edge_cli
from ragraph_tpu_torch.convert import params_from_jax
from ragraph_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                save_checkpoint)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "ragraph_tpu_torch"


def _tables(seed=0, d=64):
    rng = np.random.default_rng(seed)
    return {"user_embedding": (0.1 * rng.normal(size=(64, d))
                               ).astype(np.float32),
            "item_embedding": (0.1 * rng.normal(size=(128, d))
                               ).astype(np.float32)}


def test_vanilla_cli_matches_jax(tmp_path):
    """Pretrained tables written by the JAX package serve both CLIs; the
    per-stage recall@20 and ndcg@20 agree."""
    j_save(str(tmp_path / "pretrain_RAGraph_SYNTH"), _tables(),
           use_orbax=False)
    argv = ["vanilla", "--data-path", "SYNTH", "--save-dir", str(tmp_path)]
    j_recalls, j_ndcgs = j_edge_cli.main(argv)
    recalls, ndcgs = t_edge_cli.main(argv + ["--device", "cpu"])
    assert len(recalls) == len(j_recalls) == 4
    np.testing.assert_allclose(recalls, j_recalls, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ndcgs, j_ndcgs, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["pretrain", "finetune"])
def test_unported_cli_modes_exit_nonzero(mode, tmp_path):
    """Both modes run, with the model zoo's ``--model`` values too. Every
    mode is ported now, ``--mesh`` included; what exits non-zero is a
    malformed ``--mesh``, and one whose ``dp * idx`` is not the world size
    (a process outside ``torch.distributed.run`` is a world of one),
    before the process joins any group."""
    args = [mode, "--save-dir", str(tmp_path), "--device", "cpu",
            "--epochs", "1", "--batch-size", "128", "--emb-size", "8"]
    t_edge_cli.main(args)
    assert (tmp_path / f"{mode}_RAGraph_SYNTH.json").exists()
    t_edge_cli.main(args + ["--model", "SGL"])
    assert (tmp_path / f"{mode}_SGL_SYNTH.json").exists()
    with pytest.raises(SystemExit) as exc:
        t_edge_cli.main(args + ["--mesh", "dp=1;idx=1"])
    assert exc.value.code not in (0, None)
    assert "--mesh expects dp=D,idx=I" in str(exc.value.code)
    with pytest.raises(ValueError, match=r"dp\*idx = 2\*1 != 1 ranks"):
        t_edge_cli.main(args + ["--mesh", "dp=2,idx=1"])
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_checkpoint_interop(tmp_path):
    """A JAX ``save_checkpoint(use_orbax=False)`` file loads through the
    port into identical tensors, and the port's files load in JAX."""
    tables = _tables(1, 16)
    tables["gating_weight"] = np.eye(16, dtype=np.float32)
    tables["gating_bias"] = np.ones((1, 16), np.float32)
    path = j_save(str(tmp_path / "jax_tables"), tables, use_orbax=False)
    params = params_from_jax(restore_checkpoint(path), "cpu")
    assert set(params) == set(tables)
    for k, v in tables.items():
        assert params[k].dtype == torch.float32
        np.testing.assert_array_equal(params[k].numpy(), v)
    path = save_checkpoint(str(tmp_path / "torch_tables"), params)
    back = j_restore(path, use_orbax=False)
    for k, v in tables.items():
        np.testing.assert_array_equal(back[k], v)
    # LoRA factors, ported since: a pair of arrays becomes the port's pair
    lora = params_from_jax(
        {"user_lora": (np.ones((64, 4)), np.ones((4, 16)))},
        "cpu")["user_lora"]
    assert lora.a.shape == (64, 4) and lora.b.dtype == torch.float32
    with pytest.raises(ValueError, match="pair"):
        params_from_jax({"user_lora": np.zeros(3)}, "cpu")
    with pytest.raises(ValueError, match="not edge-model"):
        params_from_jax({"meta_layers": np.zeros(2)}, "cpu")
    # the prompt vector, ported since with the model zoo, must be (1, E)
    with pytest.raises(ValueError, match=r"\(1, E\)"):
        params_from_jax({"prompt_vec": np.zeros(2)}, "cpu")


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PORT.rglob("*.py"))


def test_port_imports_without_jax():
    """Every port module imports in a process where ``jax`` cannot be
    imported, and importing builds and loads no kernel and no C++
    library."""
    code = ("import sys; sys.modules['jax'] = None\n"
            "import importlib\n"
            f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
            "from ragraph_tpu_torch import native\n"
            "assert native._lib is None\n"
            "from ragraph_tpu_torch.utils import native as host\n"
            "assert host._lib is None\n"
            "assert not any(m == 'ragraph_tpu' or m.startswith('ragraph_tpu.')"
            " for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_sources_import_no_jax():
    bad = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.]|"
                     r"import\s+ragraph_tpu(?!_torch)|"
                     r"from\s+ragraph_tpu(?!_torch)[\s.])", re.M)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not bad.search(f.read_text()), f


def test_entry_points_raise_without_a_card(tmp_path):
    """No hidden CPU path: the default device is CUDA, and without a card
    the entry points raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from ragraph_tpu_torch.data.edgelist import load_edge_dataset
    from ragraph_tpu_torch.data.synthetic import synthetic_edge_stream
    from ragraph_tpu_torch.models.edge import EdgeGraphArrays
    train, stages = synthetic_edge_stream(num_users=8, num_items=8,
                                          num_stages=1)
    ds = load_edge_dataset(train, stages[0])
    with pytest.raises(RuntimeError, match="cuda"):
        EdgeGraphArrays.from_dataset(ds)
    with pytest.raises(RuntimeError, match="cuda"):
        EdgeGraphArrays.from_dataset(ds, "cpu").to("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax(_tables())
    save_checkpoint(str(tmp_path / "pretrain_RAGraph_SYNTH"), _tables())
    with pytest.raises(RuntimeError, match="cuda"):
        t_edge_cli.main(["vanilla", "--save-dir", str(tmp_path)])
