"""k-hop feature propagation (counterpart of
``ragraph_tpu/ops/propagation.py``): row-normalize the (already
symmetric-normalized) adjacency by its row sum, then apply ``k`` rounds of
``relu(adj_norm @ x)``."""

from __future__ import annotations

import torch

from ragraph_tpu_torch.core.graph import row_normalize_adj


def aggregate_k_hop_dense(adj: torch.Tensor, x: torch.Tensor, k: int,
                          relu: bool = True) -> torch.Tensor:
    """``k`` rounds of ``relu(row_norm(adj) @ x)`` for ``adj (..., N, N)``
    and ``x (..., N, F)``."""
    if k <= 0:
        return x
    adj_n = row_normalize_adj(adj)
    for _ in range(k):
        x = torch.matmul(adj_n, x)
        if relu:
            x = torch.relu(x)
    return x


def aggregate_k_hop_edges(senders: torch.Tensor, receivers: torch.Tensor,
                          weights: torch.Tensor, x: torch.Tensor,
                          num_nodes: int, k: int,
                          relu: bool = True) -> torch.Tensor:
    """Edge-list variant: ``k`` rounds of a weighted gather and segment
    sum. ``weights`` already hold the normalization; padding edges carry
    zero weight."""
    send, recv = senders.long(), receivers.long()
    for _ in range(k):
        msgs = x[send] * weights[:, None]
        x = torch.zeros((num_nodes, x.shape[1]), dtype=msgs.dtype,
                        device=x.device).index_add_(0, recv, msgs)
        if relu:
            x = torch.relu(x)
    return x
