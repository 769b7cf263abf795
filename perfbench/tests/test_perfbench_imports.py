"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the reference imports nothing of the
program; without a card a run fails and prints no result."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from perfbench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "ragraph_tpu"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_and_the_reference_imports_no_program():
    for path in spec.HERE.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
    for path in (spec.HERE / "reference").rglob("*.py"):
        assert _imports(path) <= {"__future__", "dataclasses", "numpy",
                                  "torch", "warnings"}, path


def test_whole_names_are_compared():
    sys.modules.setdefault("ragraph_tpu_torch_lookalike", sys)
    try:
        assert "ragraph_tpu_torch_lookalike" not in run.forbidden_modules()
    finally:
        del sys.modules["ragraph_tpu_torch_lookalike"]


SETUP = """
import sys, torch
sys.path.insert(0, {repo!r})
import ragraph_tpu_torch.ops.topk as topk
topk.AUTO_APPROX_THRESHOLD = 0
from perfbench import run, spec
for w in ("amazon.finetune", "amazon.eval"):
    cell = spec.cell(w)
    cell["config"].update(num_users=300, num_items=200,
                          num_interactions=12000, batch_size=256,
                          pretrain_interactions=6000,
                          finetune_interactions=3000,
                          test_interactions=1500, test_users=40)
    run.run_cell(cell, 5, 0.1, False, torch.device("cpu"))
print(run.forbidden_modules())
"""


def test_a_cells_run_loads_no_jax():
    res = subprocess.run([sys.executable, "-c",
                          SETUP.format(repo=str(spec.REPO))],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_a_run_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "taobao.pretrain", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=spec.REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr
