"""Tests that need the card (marker ``chip``; each skips without one, with
its reason). Run on the chip:

    python3 -m pytest -q -p no:cacheprovider perfbench/tests -m chip
"""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import calibrate, check, run, spec

pytestmark = pytest.mark.chip
SEED = 2**31 + 901


def _run(cwd, workload="amazon.eval", seconds="2", trace="0"):
    return subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", workload,
         "--seed", str(SEED), "--seconds", seconds, "--trace", trace],
        cwd=cwd, capture_output=True, text=True, timeout=900)


def test_result_line_names_the_card_and_its_power_limit(cuda_device):
    res = _run(spec.REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == torch.cuda.get_device_name(0)
    assert dev["nvidia_smi"] and dev["nvidia_smi"].endswith("W")
    assert dev["memory_peak_bytes"] > 0
    assert res.stderr.strip().splitlines()[-1].startswith("check ")


def test_the_harness_alone_fails(cuda_device, tmp_path):
    shutil.copy(spec.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "perfbench")
    res = _run(tmp_path)
    assert res.returncode != 0
    assert not res.stdout.strip()


@pytest.mark.parametrize("workload", ["amazon.finetune", "amazon.eval",
                                      "taobao.pretrain"])
def test_control_and_faults_fail_on_the_card(cuda_device, workload,
                                             tiny_cell):
    cell = tiny_cell(workload)
    cell["config"].update(num_users=20000, num_items=15000,
                          num_interactions=400000,
                          pretrain_interactions=300000,
                          finetune_interactions=40000,
                          test_interactions=20000, test_users=2500,
                          batch_size=2048)
    prog = calibrate.program_run(cell, SEED, cuda_device)
    ok, checks = check.judge(cell["limits"],
                             cell["loop"].readings(cell, prog, cuda_device))
    assert ok, checks
    ok, checks = check.judge(
        cell["limits"], cell["loop"].control(cell, prog, cuda_device))
    assert not ok, checks
    for name, fault in cell["loop"].faults(cell).items():
        with fault():
            out = run.run_cell(cell, SEED, 0.5, False, cuda_device)
        assert not out["correct"], (name, out["checks"])
