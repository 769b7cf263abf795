"""Pretraining heads and decoders (counterpart of
``ragraph_tpu/nn/heads.py``): the task decoder, the linear probe, the Lp,
DGI and GraphCL pretraining heads, and the contrastive tuple loss
``compare_loss``. The heads take one graph or one block-diagonal batch
``(N, H)``."""

from __future__ import annotations

import math

import torch
from torch import nn

from ragraph_tpu_torch.nn.layers import (BilinearDiscriminator, avg_readout,
                                         xavier_uniform_)
from ragraph_tpu_torch.ops.similarity import l2_normalize


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


class LogReg(nn.Module):
    """Linear probe: Xavier weight, zero bias (``dense.weight`` is ``(out,
    in)``, the transpose of the JAX package's ``Dense_0/kernel``)."""

    def __init__(self, in_features: int, num_classes: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dense = nn.Linear(in_features, num_classes)
        xavier_uniform_(self.dense.weight, generator)
        nn.init.zeros_(self.dense.bias)

    def forward(self, x):
        return self.dense(x)


def _prompt(hidden: int, generator) -> nn.Parameter:
    p = nn.Parameter(torch.empty(1, hidden))
    xavier_uniform_(p, generator)
    return p


class LpHead(nn.Module):
    """Link-prediction pretraining head: ``elu(gcn_out)``. Its ``(1, H)``
    ``prompt`` never enters the computation (as in the reference); it is
    kept so that checkpoints have the same entries."""

    def __init__(self, hidden: int, generator: torch.Generator | None = None):
        super().__init__()
        self.prompt = _prompt(hidden, generator)

    def forward(self, gcn_out):
        return nn.functional.elu(gcn_out)


class DGIHead(nn.Module):
    """DGI head: clean rows ``h_1`` and corrupted rows ``h_2``, both scaled
    by the prompt, scored against the sigmoid of the clean rows' masked
    mean."""

    def __init__(self, hidden: int, generator: torch.Generator | None = None):
        super().__init__()
        self.prompt = _prompt(hidden, generator)
        self.disc = BilinearDiscriminator(hidden, generator)

    def forward(self, h_1, h_2, node_mask=None, samp_bias1=None,
                samp_bias2=None):
        c = torch.sigmoid(avg_readout(h_1, node_mask))
        return self.disc(c, h_1 * self.prompt, h_2 * self.prompt,
                         samp_bias1, samp_bias2)


class GraphCLHead(nn.Module):
    """GraphCL head: the clean and corrupted rows scored against the
    summaries of two augmented views, one discriminator for both. A view
    that drops nodes pools over its own ``view_masks`` entry (the
    reference's views are smaller graphs)."""

    def __init__(self, hidden: int, generator: torch.Generator | None = None):
        super().__init__()
        self.prompt = _prompt(hidden, generator)
        self.disc = BilinearDiscriminator(hidden, generator)

    def forward(self, h_0, h_2, h_aug1, h_aug2, node_mask=None,
                view_masks=None):
        m1, m2 = view_masks if view_masks is not None \
            else (node_mask, node_mask)
        h_00, h_22 = h_0 * self.prompt, h_2 * self.prompt
        c_1 = torch.sigmoid(avg_readout(h_aug1 * self.prompt, m1))
        c_3 = torch.sigmoid(avg_readout(h_aug2 * self.prompt, m2))
        return self.disc(c_1, h_00, h_22) + self.disc(c_3, h_00, h_22)


def compare_loss(features: torch.Tensor, tuples: torch.Tensor,
                 temperature: float = 1.5,
                 row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Contrastive tuple loss: ``tuples[i] = [pos, neg_1..neg_n]`` index
    rows of ``features``, the anchor is row ``i``, and the loss is ``-log(
    exp(cos(h_i, h_pos)) / sum_j exp(cos(h_i, h_neg_j)))``, averaged over
    the anchors that ``row_mask`` keeps. Both exponentials are divided by
    the temperature, which cancels, as in the reference."""
    anchors = l2_normalize(features)                       # (N, H)
    gathered = l2_normalize(features[tuples.long()])       # (N, 1+n, H)
    sim = torch.einsum("nh,nkh->nk", anchors, gathered)
    exp = torch.exp(sim) / temperature
    losses = -torch.log(exp[:, 0]
                        / torch.clamp_min(exp[:, 1:].sum(dim=1), 1e-12))
    if row_mask is None:
        return losses.mean()
    m = row_mask.to(losses.dtype)
    return (losses * m).sum() / torch.clamp_min(m.sum(), 1.0)
