"""LoRA factors for fine-tuning an embedding table (counterpart of
``ragraph_tpu/nn/lora.py``).

The factors start from the truncated SVD of the pretrained table,
``A = scale · U_r Σ_r`` and ``B = V_rᵀ``, and the model adds
``dropout(A @ B)`` to the table. Singular vectors are defined up to sign, so
``A`` and ``B`` may differ from another library's by a sign per column and
row; ``A @ B`` does not.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LoRAFactors(NamedTuple):
    a: torch.Tensor  # (N, r)
    b: torch.Tensor  # (r, E)


def svd_init(table: torch.Tensor, rank: int,
             scale: float = 1.0) -> LoRAFactors:
    """Truncated-SVD init. ``scale=1`` starts with the delta equal to the
    table's best rank-``r`` approximation; ``scale=0`` starts with a zero
    delta and keeps the SVD row space in ``B``."""
    u, s, vt = torch.linalg.svd(table.detach().float(), full_matrices=False)
    return LoRAFactors(a=scale * u[:, :rank] * s[:rank][None, :],
                       b=vt[:rank, :].contiguous())


def apply_lora(base: torch.Tensor, factors: LoRAFactors,
               dropout_rate: float = 0.0,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """``base + dropout(A @ B)``; dropout only with a generator."""
    delta = factors.a.float() @ factors.b.float()
    if dropout_rate > 0.0 and generator is not None:
        keep = torch.rand(delta.shape, generator=generator,
                          device=delta.device) < 1.0 - dropout_rate
        delta = torch.where(keep, delta / (1.0 - dropout_rate), 0.0)
    return base + delta
