"""``correct`` on the CPU at a tiny size: the port against the plain
reference (one cell of each loop and phase), the control one precision
below, and each fault a cell can have, planted under the timed path of a
whole run (all but the harness's look for a card)."""

import pytest
import torch

from perfbench import calibrate, check, run
from perfbench.trace import Spans

CPU = torch.device("cpu")
SEED = 2**31 + 77
WORKLOADS = ["amazon.finetune", "amazon.eval", "taobao.pretrain"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_port_agrees_with_the_reference(tiny_cell, workload):
    out = run.run_cell(tiny_cell(workload), SEED, 0.3, False, CPU)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("workload", ["amazon.finetune", "amazon.eval"])
def test_control_one_precision_below_is_not_correct(tiny_cell, workload):
    cell = tiny_cell(workload)
    prog = calibrate.program_run(cell, SEED, CPU)
    ok, checks = check.judge(cell["limits"],
                             cell["loop"].control(cell, prog, CPU))
    assert not ok, checks


FAULTS = [("amazon.finetune", f) for f in (
    "half_batch", "state_unchanged", "positive_negatives",
    "retrieval_altered")] + [
    ("amazon.eval", f) for f in ("half_users", "altered_answer")] + [
    ("taobao.pretrain", f) for f in (
        "half_batch", "state_unchanged", "positive_negatives")]


def test_each_cell_lists_its_faults():
    from perfbench import spec
    want = {}
    for w, f in FAULTS:
        want.setdefault(w, set()).add(f)
    for w, names in want.items():
        cell = spec.cell(w)
        assert set(cell["loop"].faults(cell)) == names, w


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny_cell, workload, fault):
    cell = tiny_cell(workload)
    with cell["loop"].faults(cell)[fault]():
        out = run.run_cell(cell, SEED, 0.3, False, CPU)
    assert not out["correct"], out["checks"]
    assert out["failed"] == out["attempted"]


def test_no_limits_no_correct(tiny_cell):
    cell = tiny_cell("taobao.pretrain")
    cell["limits"] = None
    assert not run.run_cell(cell, SEED, 0.1, False, CPU)["correct"]


def test_traced_run_reads_its_window(tiny_cell):
    out = run.run_cell(tiny_cell("amazon.finetune"), SEED, 0.5, True, CPU)
    assert out["correct"]
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "batch_wait_ms.finetune" in out["metrics"]


def test_program_config_refuses_a_departure(tiny_cell):
    cell = tiny_cell("amazon.finetune")
    cell["config"]["finetune"] = dict(cell["config"]["finetune"],
                                      retrieve_num=11)
    with pytest.raises(SystemExit):
        cell["program"].Program(cell["config"], cell["mix"], SEED, CPU,
                                Spans(), test_rows=False)


def test_first_step_retrieval_is_compared_over_every_node(tiny_cell):
    cell = tiny_cell("amazon.finetune")
    prog = calibrate.program_run(cell, SEED, CPU)
    ids, mean = prog.record["retrieval"]
    n = cell["config"]["num_users"] + cell["config"]["num_items"]
    assert ids.shape == (n, cell["config"]["finetune"]["retrieve_num"])
    assert mean.shape == (n, cell["config"]["emb_size"])
    values = cell["loop"].readings(cell, prog, CPU)
    assert values["retrieval_miss"] == 0.0
    assert values["rag_mean_gap"] < 1e-5
