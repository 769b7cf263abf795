"""The port's fewshot CLI: its parser against the JAX CLI's, ``vanilla``
and ``finetune`` at both levels on the CPU, support sets read from files
the JAX package exported, ``--mesh``, and which pretrain checkpoints it
loads: a two-layer one written by either package's ``cli.node pretrain``
loads, a one-layer one gives the random two-layer encoder with the JAX
CLI's message. The JAX CLIs on the port's ``state_dict`` file are pinned
too: the fewshot CLI falls back, the node CLI raises."""

import json

import numpy as np
import pytest
import torch

from ragraph_tpu.cli import fewshot as j_fewshot
from ragraph_tpu.cli import node as j_node
from ragraph_tpu.data import fewshot_export as jexp
from ragraph_tpu.data.synthetic import synthetic_tu_dataset as j_synth
from ragraph_tpu_torch.cli import fewshot as t_fewshot
from ragraph_tpu_torch.cli import node as t_node
from ragraph_tpu_torch.convert import preprompt_params_from_jax
from ragraph_tpu_torch.train.checkpoint import restore_checkpoint

SMALL = ["--hidden", "32", "--library-capacity", "4096", "--test-times", "1"]
FALLBACK = "has <2 encoder layers; using random 2-layer init"


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type,
                     a.nargs, a.const)
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax_flag_for_flag():
    j, t = _actions(j_fewshot.build_parser()), \
        _actions(t_fewshot.build_parser())
    assert t.pop("device")[:2] == (("--device",), "cuda")
    assert t.pop("dist_backend")[:3] == (("--dist-backend",), None,
                                         ["nccl", "gloo"])
    assert t == j


def test_mesh_and_missing_card():
    """``--mesh`` must name a world of ``dp * idx`` ranks; a process outside
    ``torch.distributed.run`` is a world of one, refused before it joins
    any group."""
    import torch.distributed as dist
    with pytest.raises(ValueError, match=r"dp\*idx = 2\*1 != 1 ranks"):
        t_fewshot.main(["finetune", "--mesh", "dp=2,idx=1", "--device",
                        "cpu"])
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_fewshot.main(["finetune"])


class Probe(t_node.RunObserver):
    """Records the checkpoint state the CLI settled on and the library's
    fill after each append."""

    def __init__(self):
        self.fills, self.encoder_state, self.losses = [], "unset", []

    def after(self, name, **o):
        if name == "checkpoint":
            self.encoder_state = o["encoder_state"]
        elif name.startswith("library_build"):
            self.fills.append(int(o["state"].library.fill))
        elif name == "finetune_epoch":
            self.losses.append(float(torch.stack(o["losses"]).mean()))


@pytest.mark.parametrize("level", ["node", "graph"])
@pytest.mark.parametrize("mode", ["vanilla", "finetune"])
def test_cli_runs_on_the_cpu(tmp_path, level, mode):
    """The protocol on SYNTH (120 graphs: 60 train, 36 val) with a random
    encoder: the library holds 40 rows per train graph, then the val
    graphs' too; the JAX CLI's result file and keys."""
    probe = Probe()
    mean = t_fewshot.main(
        [mode, "--level", level, "--epochs", "2", "--save-dir",
         str(tmp_path / "none"), "--results-dir", str(tmp_path),
         "--device", "cpu"] + SMALL, observer=probe)
    assert probe.encoder_state is None
    assert probe.fills == [60 * 40, 96 * 40]
    with open(tmp_path / f"fewshot_{mode}_{level}_SYNTH_shot5.json") as f:
        out = json.load(f)
    assert sorted(out) == ["accuracy", "mean", "std"]
    assert out["mean"] == mean and len(out["accuracy"]) == 1
    assert 100.0 / 3 < mean <= 100.0
    if mode == "finetune":
        assert len(probe.losses) == 2 and np.isfinite(probe.losses).all()
    else:
        assert probe.losses == []


@pytest.mark.parametrize("level", ["node", "graph"])
def test_support_dir_from_jax_export(tmp_path, level):
    """Support sets the JAX package exported: per-task node splits, or one
    graph set shared by every task; the CLI reads them instead of
    sampling."""
    ds = j_synth(seed=0, num_graphs=120, num_classes=3, feat_dim=16)
    sup = tmp_path / "support"
    if level == "node":
        paths = jexp.export_fewshot_splits(ds, str(sup), shots=2,
                                           num_tasks=2)
        want = np.load(paths[1])["labels"]
    else:
        jexp.export_fewshot_graph_split(ds, str(sup / "support.npz"),
                                        shots=2)
        want = np.load(sup / "support.npz")["labels"]
    seen = []

    class SupportProbe(t_node.RunObserver):
        def after(self, name, **o):
            if name == "library_build_train":
                seen.append(o["state"].support)
    # node level: task 1 reads 1.npz; graph level: task 0 finds no 0.npz
    # and reads the shared support.npz
    tasks = 2 if level == "node" else 1
    t_fewshot.main(["vanilla", "--level", level, "--support-dir", str(sup),
                    "--save-dir", str(tmp_path / "none"), "--results-dir",
                    str(tmp_path), "--device", "cpu", "--hidden", "32",
                    "--library-capacity", "4096", "--test-times",
                    str(tasks)], observer=SupportProbe())
    assert len(seen) == tasks
    np.testing.assert_array_equal(seen[-1].labels.numpy(), want)
    assert (seen[-1].graph_ids is None) == (level == "node")
    if level == "graph":
        lens = np.load(sup / "support.npz")["graph_len"]
        np.testing.assert_array_equal(
            seen[-1].graph_ids.numpy(), np.repeat(np.arange(len(lens)), lens))


def _pretrain(main, save_dir, layers, extra=()):
    main(["pretrain", "--encoder-layers", str(layers), "--hidden", "32",
          "--pretrain-epochs", "1", "--lp-samples", "20", "--save-dir",
          str(save_dir), "--results-dir", str(save_dir)] + list(extra))


def test_checkpoints_of_either_package(tmp_path, capsys):
    """Two-layer checkpoints of both packages load (the encoder is the
    checkpoint's); one-layer ones give the random two-layer encoder with
    the JAX CLI's message (on the run's console, which is stderr). The
    port's CLIs write their run logs into ``--save-dir``."""
    ckpts = {}
    for layers in (1, 2):
        ckpts["jax", layers] = tmp_path / f"jax{layers}"
        _pretrain(j_node.main, ckpts["jax", layers], layers)
        ckpts["port", layers] = tmp_path / f"port{layers}"
        _pretrain(t_node.main, ckpts["port", layers], layers,
                  ["--device", "cpu"])
    for (side, layers), d in ckpts.items():
        capsys.readouterr()
        probe = Probe()
        t_fewshot.main(["vanilla", "--save-dir", str(d), "--results-dir",
                        str(d), "--device", "cpu"] + SMALL, observer=probe)
        console = capsys.readouterr().err
        tree = restore_checkpoint(str(d / "model_SYNTH"))
        want = preprompt_params_from_jax(tree) if side == "jax" else \
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
        if layers == 2:
            assert FALLBACK not in console, side
            got = probe.encoder_state
            for k in ("gcn.convs.0.lin.weight", "gcn.convs.1.lin.weight"):
                assert torch.equal(got[k], want[k]), (side, k)
        else:
            assert probe.encoder_state is None, side
            assert FALLBACK in console, side
            assert "gcn.convs.1.lin.weight" not in want
        # the port's node (pretrain) and fewshot runs log to <save-dir>
        logs = list(d.glob("train_log_*.txt"))
        assert logs and any("results written to" in f.read_text()
                            for f in logs), side


def test_jax_clis_on_a_port_checkpoint(tmp_path, capsys):
    """The port's ``state_dict`` file is no flax tree: the JAX fewshot CLI
    finds no ``conv_1`` in it and falls back to its random init; the JAX
    node CLI cannot apply it and raises."""
    _pretrain(t_node.main, tmp_path, 2, ["--device", "cpu"])
    j_fewshot.main(["vanilla", "--save-dir", str(tmp_path), "--results-dir",
                    str(tmp_path), "--hidden", "32", "--test-times", "1",
                    "--library-capacity", "4096"])
    assert FALLBACK in capsys.readouterr().err
    with pytest.raises(Exception):
        j_node.main(["vanilla", "--save-dir", str(tmp_path), "--results-dir",
                     str(tmp_path), "--hidden", "32", "--encoder-layers", "2",
                     "--test-times", "1", "--library-capacity", "4096"])


def test_patience_restores_the_best_epoch(tmp_path, capsys):
    """``--patience 1``: the run stops at the first epoch whose loss does
    not improve and restores the encoder as it was after the best epoch
    (snapshots taken after each epoch of the same run)."""

    class EncoderProbe(Probe):
        def __init__(self):
            super().__init__()
            self.snapshots = []

        def after(self, name, **o):
            super().after(name, **o)
            if name == "library_build_train":
                self.state = o["state"]     # its encoder trains in place
            elif name == "finetune_epoch":
                self.snapshots.append(self._encoder(self.state))
            elif name == "finetune":
                self.restored = self._encoder(o["state"])

        @staticmethod
        def _encoder(state):
            return {k: v.clone() for k, v in
                    state.encoder.state_dict().items()}
    probe = EncoderProbe()
    t_fewshot.main(["finetune", "--lr", "0.5", "--epochs", "8",
                    "--patience", "1", "--save-dir", str(tmp_path / "none"),
                    "--results-dir", str(tmp_path), "--device", "cpu"]
                   + SMALL, observer=probe)
    losses, n = probe.losses, len(probe.losses)
    assert 2 <= n < 8
    assert f"early stop at epoch {n - 1}" in capsys.readouterr().err
    assert losses[-1] >= losses[-2]
    assert all(b < a for a, b in zip(losses[:-2], losses[1:-1]))
    best, last = probe.snapshots[-2], probe.snapshots[-1]
    for k, v in best.items():
        assert torch.equal(probe.restored[k], v), k
    assert any(not torch.equal(last[k], v) for k, v in best.items())
