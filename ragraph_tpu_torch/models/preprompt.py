"""The frozen encoder of the node pipelines (counterpart of
``ragraph_tpu/models/preprompt.py``).

:class:`PrePrompt` is the shared GCN stack with its inference-side methods:
``inference`` (the frozen encoder used everywhere downstream: one GCN pass,
no batch norm, no dropout), ``embed``, and the fewshot ``encode`` /
``decode`` split. The pretraining side (the Lp, DGI and GraphCL heads, their
losses and ``prompt_pretrain_sample``) is not ported yet; those entry
points raise with a pointer to ROADMAP.md.
"""

from __future__ import annotations

import torch
from torch import nn

from ragraph_tpu_torch.nn.layers import avg_readout
from ragraph_tpu_torch.nn.stack import GCNStack

_PRETRAIN = ("the pretraining heads and losses (Lp, DGI, GraphCL) are not "
             "ported yet: see ROADMAP.md, queue 1, item 5")


def subgraph3_mean(h: torch.Tensor, adj: torch.Tensor,
                   node_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean of the features over each node's neighbourhood of at most 3
    hops: ``A3 = (A @ A @ A) > 0``, ``mean = (A3 @ h) / rowsum(A3)``."""
    a3 = adj @ (adj @ adj)
    reach = (a3 > 0).to(h.dtype)
    if node_mask is not None:
        m = node_mask.to(h.dtype)
        reach = reach * m[:, None] * m[None, :]
    cnt = reach.sum(dim=1, keepdim=True)
    return (reach @ h) / torch.clamp_min(cnt, 1.0)


class PrePrompt(nn.Module):
    """GCN encoder of ``num_layers`` dense convolutions of width
    ``hidden`` over ``in_features`` node attributes."""

    def __init__(self, in_features: int, hidden: int = 256,
                 num_layers: int = 1, dropout: float = 0.3,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden, self.num_layers = hidden, num_layers
        self.gcn = GCNStack(in_features, hidden, num_layers, dropout,
                            generator=generator)

    def forward(self, features, adj, tuples, node_mask=None, *,
                deterministic: bool = False):
        raise NotImplementedError(_PRETRAIN)

    def dgi_loss(self, *args, **kwargs):
        raise NotImplementedError(_PRETRAIN)

    def graphcl_loss(self, *args, **kwargs):
        raise NotImplementedError(_PRETRAIN)

    def graphcl_flavor_loss(self, *args, **kwargs):
        raise NotImplementedError(_PRETRAIN)

    def inference(self, features, adj, node_mask=None):
        """Frozen node embeddings; inputs may carry leading batch
        dimensions."""
        return self.gcn(features, adj, node_mask, lp=False,
                        deterministic=True)

    def embed(self, features, adj, node_mask=None):
        """(node embeddings, the readout of their 3-hop means)."""
        h = self.inference(features, adj, node_mask)
        sub3 = subgraph3_mean(h, adj, node_mask)
        return h, avg_readout(sub3, node_mask)

    def encode(self, features, adj, node_mask=None):
        """The first layer alone (fewshot ``encode``)."""
        return self.gcn(features, adj, node_mask, lp=False,
                        deterministic=True, stop_at=1)

    def decode(self, hidden, adj, node_mask=None):
        """The layers after the first (fewshot ``decode``)."""
        return self.gcn.decode_from(hidden, adj, node_mask, start=1)


def prompt_pretrain_sample(*args, **kwargs):
    raise NotImplementedError(_PRETRAIN)
