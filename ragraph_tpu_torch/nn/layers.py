"""Core GNN layers (counterpart of ``ragraph_tpu/nn/layers.py``): the
dense GCN convolution with its PReLU, the masked mean readout, the two
bilinear discriminators of the DGI and GraphCL heads, and the dense
multi-head GAT.

The GCN takes padded inputs with any leading batch dimensions: ``x (...,
N, F)``, ``adj (..., N, N)``, ``node_mask (..., N)``; the readout, the
discriminators and the GAT take one graph (or one block-diagonal batch)
``(N, ...)``. Weights keep the JAX package's orientation where they are
plain parameters (``bilinear_w``, the GAT's ``W`` and ``a``), so that its
checkpoints load without a transpose.
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


class BilinearDiscriminator(nn.Module):
    """Bilinear scorer ``f(h, c) = h · (c @ W) + b`` of the rows ``h_pl``
    (positive) and ``h_mi`` (corrupted) against one summary ``c (H,)``;
    returns the ``(N_pos + N_neg,)`` logits. ``bilinear_w (H, H)`` is used
    as the JAX package uses it (``c @ W``); ``bilinear_b`` is a scalar."""

    def __init__(self, features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.bilinear_w = nn.Parameter(torch.empty(features, features))
        xavier_uniform_(self.bilinear_w, generator)
        self.bilinear_b = nn.Parameter(torch.zeros(()))

    def forward(self, c, h_pl, h_mi, s_bias1=None, s_bias2=None):
        cw = c @ self.bilinear_w
        sc_1 = h_pl @ cw + self.bilinear_b
        sc_2 = h_mi @ cw + self.bilinear_b
        if s_bias1 is not None:
            sc_1 = sc_1 + s_bias1
        if s_bias2 is not None:
            sc_2 = sc_2 + s_bias2
        return torch.cat([sc_1, sc_2], dim=0)


class BilinearDiscriminator2(BilinearDiscriminator):
    """:class:`BilinearDiscriminator` with one context row per node: ``c
    (N, H)``, ``f(h_i, c_i) = (h_i @ W) · c_i + b``."""

    def forward(self, c, h_pl, h_mi, s_bias1=None, s_bias2=None):
        sc_1 = ((h_pl @ self.bilinear_w) * c).sum(dim=-1) + self.bilinear_b
        sc_2 = ((h_mi @ self.bilinear_w) * c).sum(dim=-1) + self.bilinear_b
        if s_bias1 is not None:
            sc_1 = sc_1 + s_bias1
        if s_bias2 is not None:
            sc_2 = sc_2 + s_bias2
        return torch.cat([sc_1, sc_2], dim=0)


class DenseGAT(nn.Module):
    """Dense multi-head graph attention over a padded adjacency ``(N, N)``.

    The pairwise score ``leaky_relu(a · [h_i || h_j])`` is the broadcast sum
    ``a_src · h_i + a_dst · h_j``; pairs outside the adjacency (or touching
    a padded node) get ``-9e15`` before the softmax over ``j``. ``W (F_in,
    heads * F)`` and ``a (2F, 1)`` have the JAX package's layout. In
    training (``deterministic=False``) with ``dropout > 0`` the attention
    is dropped with ``drop_mask`` (keep mask ``(N, N, heads)``) or a mask
    drawn from ``generator``."""

    def __init__(self, in_features: int, features: int, num_heads: int = 1,
                 alpha: float = 0.2, dropout: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.features, self.num_heads = features, num_heads
        self.alpha, self.dropout = alpha, dropout
        self.W = nn.Parameter(torch.empty(in_features, features * num_heads))
        self.a = nn.Parameter(torch.empty(2 * features, 1))
        xavier_uniform_(self.W, generator)
        xavier_uniform_(self.a, generator)

    def forward(self, x, adj, node_mask=None, *, deterministic: bool = True,
                drop_mask=None, generator: torch.Generator | None = None):
        n = x.shape[0]
        h = (x @ self.W).reshape(n, self.num_heads, self.features)
        src = h @ self.a[: self.features, 0]                 # (N, heads)
        dst = h @ self.a[self.features:, 0]
        e = nn.functional.leaky_relu(src[:, None, :] + dst[None, :, :],
                                     negative_slope=self.alpha)
        mask = adj > 0
        if node_mask is not None:
            mask = mask & (node_mask[:, None] & node_mask[None, :])
        e = torch.where(mask[:, :, None], e, -9e15)
        attn = torch.softmax(e, dim=1)
        if self.dropout > 0 and not deterministic:
            if drop_mask is None:
                if generator is None:
                    raise ValueError("DenseGAT in training needs drop_mask "
                                     "or a generator")
                drop_mask = torch.rand(attn.shape, generator=generator,
                                       device=attn.device) >= self.dropout
            attn = torch.where(drop_mask, attn / (1.0 - self.dropout), 0.0)
        out = torch.einsum("nmh,mhf->nhf", attn, h)
        out = out.reshape(n, self.num_heads * self.features)
        if node_mask is not None:
            out = out * node_mask.to(out.dtype)[:, None]
        return out
