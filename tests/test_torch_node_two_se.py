"""The node CLI's ``vanilla`` and ``finetune`` at the node level in each
package, on a synthetic dataset written as TU text files (so that both
packages' TU loaders read it), on the CPU, five seeded runs each. The two
seed means of each mode must lie within 2 SE of their difference, the
criterion of ``experiments/reference_e2e_differential*.py``, with the JAX
CLI as the reference; both well above chance (33%)."""

import json

import _torch_threads  # noqa: F401  (torch's share of the cores)
import numpy as np
import pytest
from test_torch_edge_two_se import within_two_se
from test_torch_node_ops import _write_tu

from ragraph_tpu.cli import node as j_cli
from ragraph_tpu_torch.cli import node as t_cli
from ragraph_tpu_torch.data.synthetic import synthetic_tu_dataset


@pytest.fixture(scope="module")
def tu_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tu")
    ds = synthetic_tu_dataset(seed=1, num_graphs=120, num_classes=3,
                              feat_dim=16, signal=1.0, name="SYNTHTU")
    _write_tu(str(root), "SYNTHTU", ds)
    return root


@pytest.mark.parametrize("mode,extra", [("vanilla", []),
                                        ("finetune", ["--epochs", "5"])])
def test_node_level_within_two_se(tmp_path, tu_root, mode, extra):
    runs = {}
    for side, main, dev in (("jax", j_cli.main, []),
                            ("port", t_cli.main, ["--device", "cpu"])):
        main([mode, "--dataset", "SYNTHTU", "--data-root", str(tu_root),
              "--hidden", "32", "--test-times", "5", "--library-capacity",
              "4096", "--save-dir", str(tmp_path / "none"),
              "--results-dir", str(tmp_path / side)] + extra + dev)
        with open(tmp_path / side / f"{mode}_node_SYNTHTU.json") as f:
            runs[side] = json.load(f)["accuracy"]
    j, t = runs["jax"], runs["port"]
    assert len(j) == len(t) == 5
    ok, se = within_two_se(j, t)
    assert ok, (j, t, se)
    assert min(np.mean(j), np.mean(t)) > 50, (j, t)
