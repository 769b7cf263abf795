"""The port's runnable examples stay runnable: each in a fresh subprocess
on the CPU (``--device cpu``), and without ``--device`` on a machine with
no card they raise instead of running on the CPU."""

import os
import subprocess
import sys

import _torch_threads  # noqa: F401  (torch's share of the cores)
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ["quickstart_torch.py", "serving_torch.py"]


def _run(script, *args):
    # the repo root on the path, so that a fresh clone runs without an
    # install; jax made unimportable, so that the port runs without it
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            f"sys.argv = [{script!r}] + {list(args)!r}; "
            f"runpy.run_path({os.path.join(ROOT, 'examples', script)!r}, "
            "run_name='__main__')")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=ROOT, env=env)


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_runs_on_the_cpu(script):
    proc = _run(script, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = "node accuracy" if script.startswith("quickstart") \
        else "history masking verified."
    assert want in proc.stdout


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_needs_a_card_by_default(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _run(script)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
