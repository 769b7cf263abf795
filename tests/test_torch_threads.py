"""The rule that gives each port test process its share of the CPU cores
(``tests/_torch_threads.py``), and what importing the helper sets."""

import os
import subprocess
import sys

import _torch_threads
import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.parametrize("cores, workers, processes, want", [
    (8, 6, 1, 1),        # the tier-1 run: six xdist workers
    (8, None, 1, 8),     # no xdist: torch's default
    (8, None, 4, 2),     # four ranks started alone
    (8, 6, 4, 1),        # never below one thread
    (2, None, 8, 1),
])
def test_share_rule(monkeypatch, cores, workers, processes, want):
    monkeypatch.setattr(os, "sched_getaffinity",
                        lambda pid: set(range(cores)))
    if workers is None:
        monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT", raising=False)
    else:
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", str(workers))
    assert _torch_threads.share(processes) == want


@pytest.mark.parametrize("chosen", [None, "3"])
def test_import_sets_share_and_keeps_a_chosen_value(chosen):
    """A fresh process under six workers: importing the helper gives torch
    and the variables the share, unless ``OMP_NUM_THREADS`` was set; a
    chosen value also reaches the children of a four-rank world."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    env["PYTEST_XDIST_WORKER_COUNT"] = "6"
    env["PYTHONPATH"] = TESTS
    if chosen:
        env["OMP_NUM_THREADS"] = chosen
    code = ("import os, torch, _torch_threads as t\n"
            "print(os.environ['OMP_NUM_THREADS'], "
            "os.environ['MKL_NUM_THREADS'], torch.get_num_threads(), "
            "t.env(4)['OMP_NUM_THREADS'])\n")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    own = str(max(1, len(os.sched_getaffinity(0)) // 6))
    ranks = str(max(1, len(os.sched_getaffinity(0)) // 24))
    want = [chosen] * 4 if chosen else [own, own, own, ranks]
    assert res.stdout.split() == want
