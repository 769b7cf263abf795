"""Decoders (counterpart of ``ragraph_tpu/nn/heads.py::TaskDecoder``). The
pretraining heads (Lp, DGI, GraphCL) and ``compare_loss`` are not ported
yet (ROADMAP.md, queue 1)."""

from __future__ import annotations

import math

import torch
from torch import nn


def lecun_normal_(weight: torch.Tensor,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Fill an ``(out, in)`` weight with normal draws of variance
    ``1 / in``, the JAX package's default for its dense layers (which
    truncates at two standard deviations; this one does not)."""
    with torch.no_grad():
        return weight.normal_(0.0, 1.0 / math.sqrt(weight.shape[1]),
                              generator=generator)


class TaskDecoder(nn.Module):
    """2-layer MLP: Linear → LeakyReLU(0.01) → Linear."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dense_0 = nn.Linear(in_features, hidden)
        self.dense_1 = nn.Linear(hidden, out)
        for lin in (self.dense_0, self.dense_1):
            lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x):
        x = nn.functional.leaky_relu(self.dense_0(x), negative_slope=0.01)
        return self.dense_1(x)
