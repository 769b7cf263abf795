"""Sparse PageRank and inverse-importance sampling probabilities
(counterpart of ``ragraph_tpu/ops/pagerank.py``, edge-list variants)."""

from __future__ import annotations

import torch


def pagerank_edges(senders: torch.Tensor, receivers: torch.Tensor,
                   edge_weights: torch.Tensor, num_nodes: int,
                   damping: float = 0.85, eps: float = 1e-6,
                   max_iters: int = 200) -> torch.Tensor:
    """Power iteration over a weighted edge list, with the dangling mass
    spread uniformly; stops once ``‖p' - p‖₁ < eps`` or after
    ``max_iters`` steps, as the JAX ``while_loop`` does."""
    dev = edge_weights.device
    w = edge_weights.float()
    senders, receivers = senders.long(), receivers.long()
    out_degree = torch.zeros(num_nodes, device=dev).index_add_(0, senders, w)
    inv_out = torch.where(out_degree > 0,
                          1.0 / torch.where(out_degree > 0, out_degree, 1.0),
                          0.0)
    dangling = out_degree == 0
    n = float(num_nodes)
    p = torch.full((num_nodes,), 1.0 / n, device=dev)
    for _ in range(max_iters):
        contrib = (p * inv_out)[senders] * w
        spread = torch.zeros(num_nodes, device=dev).index_add_(
            0, receivers, contrib)
        dangling_mass = torch.where(dangling, p, 0.0).sum() / n
        new_p = (1.0 - damping) / n + damping * (spread + dangling_mass)
        delta = (new_p - p).abs().sum()
        p = new_p
        if delta.item() < eps:
            break
    return p


def inverse_sample_prob_edges(senders: torch.Tensor, receivers: torch.Tensor,
                              edge_weights: torch.Tensor, num_nodes: int,
                              alpha: float = 0.5, eps: float = 1e-6,
                              max_iters: int = 200) -> torch.Tensor:
    """Sampling probability ∝ ``1 / (alpha·PR + (1-alpha)·DC + eps)``."""
    pr = pagerank_edges(senders, receivers, edge_weights, num_nodes,
                        max_iters=max_iters)
    w = edge_weights.float()
    degree = torch.zeros(num_nodes, device=w.device).index_add_(
        0, receivers.long(), w)
    dc = degree / max(float(num_nodes) - 1.0, 1.0)
    importance = alpha * pr + (1.0 - alpha) * dc
    inv = 1.0 / (importance + eps)
    return inv / torch.clamp_min(inv.sum(), 1e-12)
