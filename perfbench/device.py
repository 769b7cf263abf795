"""Which device a run measured, and the published peaks that rooflines are
taken against (copied from the port's ``bench/timing.py::device_record``,
which the program may change)."""

from __future__ import annotations

import subprocess

import torch

# One NVIDIA H100 SXM (NVIDIA's data sheet; dense rates, no sparsity), at
# its full power limit of 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def power_limit(index: int = 0) -> str | None:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    if smi.returncode != 0 or not smi.stdout.strip():
        return None
    return smi.stdout.strip().splitlines()[0]


def record(device: torch.device, count: int) -> dict:
    """The result line's ``device``: platform, the card's name, the cards
    used, the peak of allocated memory, and the power limit."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    idx = device.index or 0
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(idx),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(idx)),
            "nvidia_smi": power_limit(idx)}
