"""The fewshot CLI at the node level in each package on SYNTH, on the CPU:
``cli.fewshot finetune`` for five tasks. Each task draws its own split,
support set and random two-layer encoder (no pretrain checkpoint), so the
five are independent replicates; the two task means must lie within 2 SE
of their difference, the criterion of
``experiments/reference_e2e_differential*.py``, with the JAX CLI as the
reference; both well above chance (33%).

A run from a pretrain checkpoint is no such replicate set: its five tasks
share one encoder, and the spread between checkpoints (task means 96.3 to
97.9 over four pretrain seeds of the JAX CLI at this size) is not in the
tasks' SE."""

import json

import _torch_threads  # noqa: F401  (torch's share of the cores)
import numpy as np
from test_torch_edge_two_se import within_two_se

from ragraph_tpu.cli import fewshot as j_fewshot
from ragraph_tpu_torch.cli import fewshot as t_fewshot


def test_fewshot_finetune_within_two_se(tmp_path):
    runs = {}
    for side, main, dev in (("jax", j_fewshot.main, []),
                            ("port", t_fewshot.main, ["--device", "cpu"])):
        main(["finetune", "--hidden", "32", "--epochs", "3", "--test-times",
              "5", "--library-capacity", "4096", "--save-dir",
              str(tmp_path / "none"), "--results-dir", str(tmp_path / side)]
             + dev)
        with open(tmp_path / side / "fewshot_finetune_node_SYNTH_shot5.json"
                  ) as f:
            runs[side] = json.load(f)["accuracy"]
    j, t = runs["jax"], runs["port"]
    assert len(j) == len(t) == 5
    ok, se = within_two_se(j, t)
    assert ok, (j, t, se)
    assert min(np.mean(j), np.mean(t)) > 50, (j, t)
