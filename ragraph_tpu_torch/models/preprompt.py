"""Pretraining model and frozen encoder of the node pipelines (counterpart
of ``ragraph_tpu/models/preprompt.py``).

:class:`PrePrompt` is the shared GCN stack with the Lp, DGI and GraphCL
pretraining heads. ``forward`` is the Lp loss (the reference's live loss);
``dgi_loss``, ``graphcl_loss`` and ``graphcl_flavor_loss`` are the optional
objectives; ``inference`` is the frozen encoder used everywhere downstream
(one GCN pass, no batch norm, no dropout), with ``embed`` and the fewshot
``encode`` / ``decode`` split. :func:`prompt_pretrain_sample` draws the Lp
tuples on the host with numpy, as the JAX package does.

Every random value can be passed in: the dropout keep masks of the Lp loss
(``drop_masks``), the DGI shuffle (:func:`corrupt_features`'s ``noise`` or
``perm``) and the GraphCL views (``rag/pretrain_aug.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ragraph_tpu_torch.nn.heads import (DGIHead, GraphCLHead, LpHead,
                                        compare_loss)
from ragraph_tpu_torch.nn.layers import avg_readout
from ragraph_tpu_torch.nn.stack import GCNStack


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


def _masked_bce(logits: torch.Tensor,
                node_mask: torch.Tensor | None) -> torch.Tensor:
    """BCE with logits over ``[positives | negatives]`` discriminator
    output (labels 1, then 0), averaged over the rows ``node_mask`` keeps
    (twice: once per half)."""
    n = logits.shape[0] // 2
    labels = torch.cat([torch.ones(n, device=logits.device),
                        torch.zeros(n, device=logits.device)])
    per = torch.clamp_min(logits, 0) - logits * labels \
        + torch.log1p(torch.exp(-logits.abs()))
    if node_mask is None:
        return per.mean()
    m = torch.cat([node_mask, node_mask]).to(per.dtype)
    return (per * m).sum() / torch.clamp_min(m.sum(), 1.0)


def corrupt_features(features: torch.Tensor,
                     node_mask: torch.Tensor | None = None,
                     generator: torch.Generator | None = None, *,
                     noise: torch.Tensor | None = None,
                     perm: torch.Tensor | None = None) -> torch.Tensor:
    """DGI corruption: shuffle the node feature rows.

    With a mask (real rows first, padding after, the layout of
    :func:`ragraph_tpu_torch.core.graph.dense_batch_from_graphs`), a stable
    sort of Gumbel ``noise (N,)`` with padding forced last sends every real
    position a random real row and every padded position a padded row.
    Without a mask the rows follow ``perm``, a random permutation. Either
    is drawn from ``generator`` when not given.
    """
    n = features.shape[0]
    if node_mask is None:
        if perm is None:
            perm = torch.randperm(n, generator=generator,
                                  device=features.device)
        return features[perm.long()]
    if noise is None:
        e = torch.empty(n, device=features.device)
        noise = -torch.log(e.exponential_(generator=generator))
    idx = torch.argsort(torch.where(node_mask.bool(), noise, torch.inf),
                        stable=True)
    return features[idx]


class PrePrompt(nn.Module):
    """GCN encoder of ``num_layers`` dense convolutions of width ``hidden``
    over ``in_features`` node attributes, with the pretraining heads
    ``lp``, ``dgi``, ``graphcl_edge`` and ``graphcl_mask`` (all drawn from
    ``generator`` here, where the JAX package's ``init_all`` touches
    them).

    In LP mode the stack's batch norms update their running statistics as
    ``torch.nn.BatchNorm1d`` does; the JAX package's pretraining leaves
    them at their initial values. Nothing downstream reads them: the
    encoder runs without batch norm outside pretraining."""

    def __init__(self, in_features: int, hidden: int = 256,
                 num_layers: int = 1, dropout: float = 0.3,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden, self.num_layers = hidden, num_layers
        self.gcn = GCNStack(in_features, hidden, num_layers, dropout,
                            generator=generator)
        self.lp = LpHead(hidden, generator)
        self.dgi = DGIHead(hidden, generator)
        self.graphcl_edge = GraphCLHead(hidden, generator)
        self.graphcl_mask = GraphCLHead(hidden, generator)

    def forward(self, features, adj, tuples, node_mask=None, *,
                deterministic: bool = False, drop_masks=None,
                generator: torch.Generator | None = None):
        """The Lp loss: the stack in LP mode (batch norm, then dropout with
        ``drop_masks`` or masks from ``generator``), ELU, then
        :func:`compare_loss` at temperature 1.5 over the anchors that
        ``node_mask`` keeps."""
        h = self.gcn(features, adj, node_mask, lp=True,
                     deterministic=deterministic, drop_masks=drop_masks,
                     generator=generator)
        return compare_loss(self.lp(h), tuples, temperature=1.5,
                            row_mask=node_mask)

    def dgi_loss_logits(self, features, shuf_features, adj, node_mask=None):
        """DGI discriminator logits, clean rows then corrupted rows."""
        h_1 = self.gcn(features, adj, node_mask)
        h_2 = self.gcn(shuf_features, adj, node_mask)
        return self.dgi(h_1, h_2, node_mask)

    def dgi_loss(self, features, shuf_features, adj, node_mask=None):
        """Masked BCE over :meth:`dgi_loss_logits`."""
        return _masked_bce(self.dgi_loss_logits(features, shuf_features,
                                                adj, node_mask), node_mask)

    def graphcl_loss_logits(self, features, shuf_features, adj, aug_adj1,
                            aug_adj2, node_mask=None):
        """GraphCL logits of the edge flavor: two rewritten adjacencies of
        the clean features."""
        h_0 = self.gcn(features, adj, node_mask)
        h_2 = self.gcn(shuf_features, adj, node_mask)
        h_a1 = self.gcn(features, aug_adj1, node_mask)
        h_a2 = self.gcn(features, aug_adj2, node_mask)
        return self.graphcl_edge(h_0, h_2, h_a1, h_a2, node_mask)

    def graphcl_loss(self, features, shuf_features, adj, aug_adj1, aug_adj2,
                     node_mask=None):
        """Masked BCE over :meth:`graphcl_loss_logits`."""
        return _masked_bce(self.graphcl_loss_logits(
            features, shuf_features, adj, aug_adj1, aug_adj2, node_mask),
            node_mask)

    def graphcl_flavor_loss(self, features, shuf_features, adj, view1, view2,
                            node_mask=None, *, flavor: str = "edge"):
        """GraphCL loss for any flavor; ``view1`` and ``view2`` are the
        ``(features, adj, mask)`` triples of
        :func:`ragraph_tpu_torch.rag.pretrain_aug.make_graphcl_views`.
        ``mask`` uses the ``graphcl_mask`` head, every other flavor
        ``graphcl_edge`` (the reference's two head instances)."""
        h_0 = self.gcn(features, adj, node_mask)
        h_2 = self.gcn(shuf_features, adj, node_mask)
        f1, a1, m1 = view1
        f2, a2, m2 = view2
        h_a1 = self.gcn(f1, a1, m1)
        h_a2 = self.gcn(f2, a2, m2)
        head = self.graphcl_mask if flavor == "mask" else self.graphcl_edge
        logits = head(h_0, h_2, h_a1, h_a2, node_mask, view_masks=(m1, m2))
        return _masked_bce(logits, node_mask)

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


def prompt_pretrain_sample(adj: np.ndarray, n: int,
                           rng: np.random.Generator,
                           node_mask: np.ndarray | None = None) -> np.ndarray:
    """``(pos, neg_1..neg_n)`` index tuples per node, drawn on the host
    (the JAX package's numpy function, the same draws from the same
    ``rng``): column 0 is a uniformly random neighbour (the node itself if
    it has none); columns 1..n are distinct random non-neighbours, by
    Gumbel top-k over masked scores.

    ``adj`` is the raw binary adjacency. Padded rows (mask False) sample
    themselves where they find nothing valid; their loss rows are masked
    out.
    """
    num = adj.shape[0]
    n = min(n, num - 1)
    is_neigh = adj > 0
    if node_mask is not None:
        is_neigh = is_neigh & node_mask[None, :] & node_mask[:, None]

    g1 = rng.gumbel(size=(num, num))
    pos_scores = np.where(is_neigh, g1, -np.inf)
    pos = pos_scores.argmax(axis=1)
    has_neigh = is_neigh.any(axis=1)
    pos = np.where(has_neigh, pos, np.arange(num))

    g2 = rng.gumbel(size=(num, num))
    non_neigh = ~is_neigh
    if node_mask is not None:
        # negatives must be real nodes
        non_neigh = non_neigh & node_mask[None, :]
    neg_scores = np.where(non_neigh, g2, -np.inf)
    order = np.argpartition(-neg_scores, kth=min(n, num - 1) - 1, axis=1)
    negs = order[:, :n]
    # rows with too few valid negatives: replace the -inf picks with self
    picked_invalid = ~np.isfinite(
        np.take_along_axis(neg_scores, negs, axis=1))
    negs = np.where(picked_invalid, np.arange(num)[:, None], negs)

    return np.concatenate([pos[:, None], negs], axis=1).astype(np.int32)
