"""Core GNN layers (counterpart of ``ragraph_tpu/nn/layers.py``): the
dense GCN convolution with its PReLU, and the masked mean readout. The
discriminators and the dense GAT belong to the pretraining heads, which
are not ported yet (ROADMAP.md, queue 1).

Every layer takes padded inputs with any leading batch dimensions:
``x (..., N, F)``, ``adj (..., N, N)``, ``node_mask (..., N)``.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def xavier_uniform_(weight: torch.Tensor,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """Glorot-uniform fill of an ``(out, in)`` weight from ``generator``."""
    fan_out, fan_in = weight.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return weight.uniform_(-bound, bound, generator=generator)


class PReLU(nn.Module):
    """Parametric ReLU with one shared slope, 0.25 at the start."""

    def __init__(self, init_slope: float = 0.25):
        super().__init__()
        self.slope = nn.Parameter(torch.tensor(init_slope,
                                               dtype=torch.float32))

    def forward(self, x):
        return torch.where(x >= 0, x, self.slope * x)


class DenseGCN(nn.Module):
    """One dense GCN convolution ``act(adj @ (x W) + b)`` on a
    pre-normalized padded adjacency; the mask is applied after the
    activation. ``lin.weight`` is ``(out, in)``: the transpose of the JAX
    package's ``Dense_0/kernel``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 act: str = "prelu",
                 generator: torch.Generator | None = None):
        super().__init__()
        if act not in ("prelu", "relu", "none"):
            raise ValueError(f"unknown activation {act!r}")
        self.lin = nn.Linear(in_features, features, bias=False)
        xavier_uniform_(self.lin.weight, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.act = PReLU() if act == "prelu" else None
        self.act_name = act

    def forward(self, x, adj, node_mask=None):
        out = torch.matmul(adj, self.lin(x))
        if self.bias is not None:
            out = out + self.bias
        if self.act_name == "prelu":
            out = self.act(out)
        elif self.act_name == "relu":
            out = torch.relu(out)
        if node_mask is not None:
            out = out * node_mask.to(out.dtype)[..., None]
        return out


def avg_readout(seq: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Masked mean over the node axis of ``seq (N, H)``:
    ``sum(seq * mask) / max(sum(mask), 1)``."""
    if mask is None:
        return seq.mean(dim=0)
    m = mask.to(seq.dtype)[:, None]
    return (seq * m).sum(dim=0) / torch.clamp_min(m.sum(), 1.0)
