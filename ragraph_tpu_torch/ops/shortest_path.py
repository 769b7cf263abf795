"""Shortest-path distances and position-aware structural codes
(counterpart of ``ragraph_tpu/ops/shortest_path.py``).

- :func:`all_pairs_shortest_paths`: repeated min-plus squaring,
  ``ceil(log2(N))`` steps; for small graphs and for checks.
- :func:`anchor_distances`: multi-source Bellman-Ford from the anchors
  only, ``num_hops`` rounds of a masked min-plus step. The position code
  zeroes any distance of ``dis_q`` or more, so ``dis_q`` rounds are exact
  for it. This is the library build's path, and it takes leading batch
  dimensions. Its ``(..., N, N, A)`` intermediate is small there: the
  library build hands it 10 sampled nodes and 10 anchors, 4 KB a graph; a
  whole 126-node TU graph with 10 anchors is 635 KB, 41 MB at 16 graphs by
  4 copies.
"""

from __future__ import annotations

import torch

INF = 1e9


def _init_dist(adj: torch.Tensor,
               node_mask: torch.Tensor | None) -> torch.Tensor:
    """Edge-weight matrix: adj > 0 -> weight, diagonal -> 0, else INF."""
    n = adj.shape[0]
    if node_mask is None:
        node_mask = torch.ones(n, dtype=torch.bool, device=adj.device)
    pair_mask = node_mask[:, None] & node_mask[None, :]
    dist = torch.where((adj > 0) & pair_mask, adj.float(), INF)
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    return torch.where(eye & pair_mask, 0.0, dist)


def _minplus(a: torch.Tensor, b: torch.Tensor, block: int = 16
             ) -> torch.Tensor:
    """Min-plus product ``C[i,j] = min_k A[i,k] + B[k,j]``, over row blocks
    so that the broadcast intermediate stays ``(block, N, N)``."""
    return torch.cat([(a[s:s + block, :, None] + b[None, :, :]).amin(dim=1)
                      for s in range(0, a.shape[0], block)])


def all_pairs_shortest_paths(adj: torch.Tensor,
                             node_mask: torch.Tensor | None = None,
                             block: int = 16) -> torch.Tensor:
    """All-pairs shortest paths of ``adj (N, N)`` by min-plus squaring."""
    dist = _init_dist(adj, node_mask)
    steps = max(1, (adj.shape[0] - 1).bit_length())
    for _ in range(steps):
        dist = torch.minimum(dist, _minplus(dist, dist, block=block))
    return dist


def anchor_distances(adj: torch.Tensor, anchor_idx: torch.Tensor,
                     node_mask: torch.Tensor | None = None,
                     num_hops: int = 10) -> torch.Tensor:
    """Unweighted shortest distance from every node to each anchor, for
    ``adj (..., N, N)`` and ``anchor_idx (..., A)``: ``(..., N, A)`` f32,
    INF where the anchor is not reached within ``num_hops`` hops."""
    n = adj.shape[-1]
    if node_mask is None:
        node_mask = torch.ones(adj.shape[:-1], dtype=torch.bool,
                               device=adj.device)
    neighbor = (adj > 0) & node_mask[..., :, None] & node_mask[..., None, :]
    nodes = torch.arange(n, device=adj.device)
    is_anchor = nodes[:, None] == anchor_idx.long()[..., None, :]
    dist = torch.where(is_anchor, 0.0, INF)                   # (..., N, A)
    for _ in range(num_hops):
        # the best distance over one edge: min over u adjacent to v of
        # dist[u] + 1
        via = torch.where(neighbor[..., :, :, None], dist[..., None, :, :],
                          INF).amin(dim=-2) + 1.0
        dist = torch.minimum(dist, via)
    return torch.where(node_mask[..., None], dist, INF)


def draw_anchors(node_mask: torch.Tensor, num_anchors: int,
                 generator: torch.Generator) -> torch.Tensor:
    """``num_anchors`` nodes per graph, uniform with replacement over the
    real nodes of ``node_mask (..., N)``; a graph with no real node draws
    from all (its codes are masked to zero anyway)."""
    probs = node_mask.to(torch.float32)
    empty = probs.sum(dim=-1, keepdim=True) <= 0
    probs = torch.where(empty, torch.ones_like(probs), probs)
    flat = probs.reshape(-1, probs.shape[-1])
    idx = torch.multinomial(flat, num_anchors, replacement=True,
                            generator=generator)
    return idx.reshape(*node_mask.shape[:-1], num_anchors)


def position_aware_codes(adj: torch.Tensor,
                         node_mask: torch.Tensor | None = None,
                         num_anchors: int = 10, dis_q: int = 10, *,
                         anchors: torch.Tensor | None = None,
                         generator: torch.Generator | None = None
                         ) -> torch.Tensor:
    """Position-aware structural code ``1/(d+1)`` to random anchors, 0 where
    ``d >= dis_q``. The anchors are ``anchors (..., A)`` when given, else
    drawn from ``generator`` uniformly with replacement among the real
    nodes."""
    if node_mask is None:
        node_mask = torch.ones(adj.shape[:-1], dtype=torch.bool,
                               device=adj.device)
    if anchors is None:
        if generator is None:
            raise ValueError("position_aware_codes needs anchors or a "
                             "generator to draw them")
        anchors = draw_anchors(node_mask, num_anchors, generator)
    dist = anchor_distances(adj, anchors, node_mask, num_hops=dis_q)
    code = torch.where(dist < dis_q, 1.0 / (dist + 1.0), 0.0)
    return code * node_mask[..., None]
