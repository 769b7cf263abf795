"""Cosine and neighbourhood Jaccard similarity (counterpart of
``ragraph_tpu/ops/similarity.py``)."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalisation, ``x * rsqrt(max(Σx², eps²))``: finite
    (zero) at an all-zero row, and with a finite gradient there."""
    sq = (x * x).sum(dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp_min(sq, eps * eps))


def cosine_similarity(queries: torch.Tensor,
                      keys: torch.Tensor) -> torch.Tensor:
    """``(Q, E) x (R, E) -> (Q, R)`` cosine similarity matrix in f32."""
    return l2_normalize(queries.float()) @ l2_normalize(keys.float()).T


def jaccard_similarity(adj: torch.Tensor) -> torch.Tensor:
    """All-pairs neighbourhood Jaccard similarity ``(N, N)`` of the nonzero
    pattern of ``adj``: ``|N(u) ∩ N(v)| / |N(u) ∪ N(v)|``, 0 where the
    union is empty. The intersections are one ``A @ A.T``; the unions come
    from the degrees."""
    a = (adj != 0).to(torch.float32)
    inter = a @ a.T
    deg = a.sum(dim=1)
    union = deg[:, None] + deg[None, :] - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, 1.0), 0.0)
