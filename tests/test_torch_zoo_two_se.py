"""The edge CLI's model zoo in each package on SYNTH
(``synthetic_edge_stream``), on the CPU: ``pretrain`` then ``finetune
--model SGL --dynamic roland`` for five seeds, each package from its own
checkpoint. The two seed means of the finetune's average recall@20, and of
its ndcg@20, must lie within 2 SE of their difference, the criterion of
``experiments/reference_e2e_differential*.py``, with the JAX CLI as the
reference. A file of its own, so that ``--dist loadfile`` runs it beside
``test_torch_staged_dynamic.py``."""

import json

import _torch_threads  # noqa: F401  (torch's share of the cores)
import numpy as np

from ragraph_tpu.cli import edge as j_cli
from ragraph_tpu_torch.cli import edge as t_cli


def test_sgl_roland_cli_within_two_se_of_jax(tmp_path):
    """``pretrain`` then ``finetune --model SGL --dynamic roland`` on SYNTH
    in each package for five seeds, each from its own checkpoint (E = 16, 2
    layers): the seed means of the average recall@20 and ndcg@20 within 2
    SE of their difference, the JAX CLI as the reference."""
    runs = {}
    for side, main, extra in (("jax", j_cli.main, []),
                              ("port", t_cli.main, ["--device", "cpu"])):
        out = {"avg_recall": [], "avg_ndcg": []}
        for seed in range(5):
            save = tmp_path / f"{side}{seed}"
            args = ["--data-path", "SYNTH", "--batch-size", "128",
                    "--epochs", "2", "--emb-size", "16", "--num-layers", "2",
                    "--model", "SGL", "--seed", str(seed), "--save-dir",
                    str(save)] + extra
            main(["pretrain"] + args)
            main(["finetune", "--dynamic", "roland"] + args)
            with open(save / "finetune_SGL-roland_SYNTH.json") as f:
                res = json.load(f)
            assert len(res["recalls"]) == 4, (side, res)
            for k in out:
                out[k].append(res[k])
        runs[side] = out
    for k in ("avg_recall", "avg_ndcg"):
        j, t = np.asarray(runs["jax"][k]), np.asarray(runs["port"][k])
        se = float(np.sqrt(np.var(j, ddof=1) / len(j)
                           + np.var(t, ddof=1) / len(t)))
        assert abs(j.mean() - t.mean()) <= 2 * se + 1e-9, (k, j, t, se)
