"""pytest settings of the benchmark's own tests (``perfbench/tests``):
the ``chip`` marker for tests that need a CUDA card, and the helpers that
shrink a cell to a size the CPU runs in seconds."""

from __future__ import annotations

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (run on the chip; skips "
        "elsewhere with its reason)")


@pytest.fixture
def cuda_device():
    """The card, or a skip with the reason; decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


TINY = dict(num_users=400, num_items=300, num_interactions=20000,
            pretrain_interactions=10000, finetune_interactions=5000,
            test_interactions=2500, test_users=50, batch_size=256)


@pytest.fixture
def tiny_cell(monkeypatch):
    """``tiny_cell(workload)``: the cell shrunk to ``TINY``, its retrieval
    on the path the card takes at full size (kernel C's, whose plain
    version runs on the CPU: ``cosine_topk``'s "auto" leaves the exact
    sort above ``AUTO_APPROX_THRESHOLD`` library rows)."""
    from ragraph_tpu_torch.ops import topk
    from perfbench import spec
    monkeypatch.setattr(topk, "AUTO_APPROX_THRESHOLD", 0)

    def make(workload):
        cell = spec.cell(workload)
        cell["config"].update(TINY)
        return cell
    return make
