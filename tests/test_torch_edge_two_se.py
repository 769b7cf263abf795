"""The edge CLI in each package on SYNTH (``synthetic_edge_stream``), on
the CPU: ``pretrain`` then ``finetune`` (RAGraph, every stage) for five
seeds, each package from its own checkpoint. The two seed means of the
finetune's average recall@20, and of its ndcg@20, must lie within 2 SE of
their difference, the criterion of
``experiments/reference_e2e_differential*.py``, with the JAX CLI as the
reference; both far above the random ranking's recall."""

import json

import _torch_threads  # noqa: F401  (torch's share of the cores)
import numpy as np

from ragraph_tpu.cli import edge as j_cli
from ragraph_tpu_torch.cli import edge as t_cli

SEEDS = range(5)


def within_two_se(j, t):
    j, t = np.asarray(j), np.asarray(t)
    se = float(np.sqrt(np.var(j, ddof=1) / len(j)
                       + np.var(t, ddof=1) / len(t)))
    return abs(j.mean() - t.mean()) <= 2 * se + 1e-9, se


def test_pretrain_then_finetune_within_two_se(tmp_path):
    runs = {}
    for side, main, extra in (("jax", j_cli.main, []),
                              ("port", t_cli.main, ["--device", "cpu"])):
        out = {"avg_recall": [], "avg_ndcg": []}
        for seed in SEEDS:
            args = ["--data-path", "SYNTH", "--batch-size", "128",
                    "--epochs", "3", "--emb-size", "16", "--num-layers",
                    "2", "--seed", str(seed), "--save-dir",
                    str(tmp_path / f"{side}{seed}")] + extra
            main(["pretrain"] + args)
            main(["finetune"] + args)
            with open(tmp_path / f"{side}{seed}"
                      / "finetune_RAGraph_SYNTH.json") as f:
                res = json.load(f)
            assert len(res["recalls"]) == 4, (side, res)
            for k in out:
                out[k].append(res[k])
        runs[side] = out
    for k in ("avg_recall", "avg_ndcg"):
        j, t = runs["jax"][k], runs["port"][k]
        ok, se = within_two_se(j, t)
        assert ok, (k, j, t, se)
        # 20 of 128 items ranked at random recall about 0.16
        assert min(np.mean(j), np.mean(t)) > 0.2 or k == "avg_ndcg", (j, t)
