"""PageRank, degree centrality and inverse-importance sampling
probabilities (counterpart of ``ragraph_tpu/ops/pagerank.py``), on edge
lists and on dense padded adjacencies.

The dense functions take any leading batch dimensions (``adj (..., N, N)``,
``node_mask (..., N)``): the library build runs every graph and copy of a
batch through one power iteration.
"""

from __future__ import annotations

import torch

# The dense power iteration reads its stopping condition on the host once
# every this many steps; a graph that has converged is frozen on the device
# in between, so the result does not depend on it.
_CHECK_EVERY = 8


def pagerank_dense(adj: torch.Tensor, node_mask: torch.Tensor | None = None,
                   damping: float = 0.85, eps: float = 1e-6,
                   max_iters: int = 200) -> torch.Tensor:
    """Power-iteration PageRank on dense (padded) adjacencies.

    The update is ``p' = (1-d)/N + d * P^T p`` with dangling rows replaced
    by the uniform distribution over the real nodes. Each graph iterates
    until its own ``||p' - p||_1 < eps`` or ``max_iters`` steps, as the JAX
    ``while_loop`` does under ``vmap``: a per-graph flag freezes a graph
    once it has stopped, so batching changes no graph's result, and the
    flags are read on the host only every few steps.
    """
    if node_mask is None:
        node_mask = torch.ones(adj.shape[:-1], dtype=torch.bool,
                               device=adj.device)
    maskf = node_mask.to(adj.dtype)
    n_real = torch.clamp_min(maskf.sum(dim=-1, keepdim=True), 1.0)

    adj = adj * maskf[..., :, None] * maskf[..., None, :]
    out_degree = adj.sum(dim=-1)
    dangling = (out_degree == 0) & node_mask
    # divide by the actual positive degree: callers pass normalized
    # adjacencies whose row sums can lie in (0, 1)
    p_mat = adj / torch.where(out_degree > 0, out_degree, 1.0)[..., None]
    p_mat = torch.where(dangling[..., None],
                        (maskf / n_real)[..., None, :], p_mat)
    p_mat_t = p_mat.transpose(-1, -2)

    p = maskf / n_real
    active = torch.ones(adj.shape[:-2], dtype=torch.bool, device=adj.device)
    for it in range(max_iters):
        new_p = (1.0 - damping) / n_real \
            + damping * torch.matmul(p_mat_t, p[..., None])[..., 0]
        new_p = new_p * maskf
        delta = (new_p - p).abs().sum(dim=-1)
        p = torch.where(active[..., None], new_p, p)
        active = active & (delta >= eps)
        if (it + 1) % _CHECK_EVERY == 0 and not bool(active.any()):
            break
    return p


def degree_centrality_dense(adj: torch.Tensor,
                            node_mask: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """``deg / (N_real - 1)`` column-sum degree centrality (mask-aware)."""
    if node_mask is None:
        node_mask = torch.ones(adj.shape[:-1], dtype=torch.bool,
                               device=adj.device)
    maskf = node_mask.to(adj.dtype)
    adj = adj * maskf[..., :, None] * maskf[..., None, :]
    degree = adj.sum(dim=-2)
    n_real = torch.clamp_min(maskf.sum(dim=-1, keepdim=True), 2.0)
    return degree / (n_real - 1.0)


def inverse_sample_prob_dense(adj: torch.Tensor,
                              node_mask: torch.Tensor | None = None,
                              alpha: float = 0.5, eps: float = 1e-6,
                              max_iters: int = 200) -> torch.Tensor:
    """Sampling probability ∝ ``1/(alpha·PR + (1-alpha)·DC + eps)``, zero on
    padding, normalized per graph."""
    if node_mask is None:
        node_mask = torch.ones(adj.shape[:-1], dtype=torch.bool,
                               device=adj.device)
    pr = pagerank_dense(adj, node_mask, max_iters=max_iters)
    dc = degree_centrality_dense(adj, node_mask)
    importance = alpha * pr + (1.0 - alpha) * dc
    inv = torch.where(node_mask, 1.0 / (importance + eps), 0.0)
    return inv / torch.clamp_min(inv.sum(dim=-1, keepdim=True), 1e-12)


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
