"""Cosine-scored top-k retrieval (counterpart of ``ragraph_tpu/ops/topk.py``).

Dispatch follows the JAX package:

- ``"exact"``: f32 matmul, ``-inf`` for invalid rows, ``torch.topk``;
- ``"pallas"``: the exact fused kernel (:mod:`.fused_retrieval`);
- ``"approx"``: on the TPU ``lax.approx_max_k``, a TPU PartialReduce with no
  GPU counterpart; here it answers exactly through the fused kernel;
- ``"auto"``: exact below :data:`AUTO_APPROX_THRESHOLD` rows, above it
  ``"bucket"`` when ``recall_target >= 1`` and ``"approx"`` otherwise.

``"bucket"`` and ``score_dtype="int8"`` are not ported yet (ROADMAP.md,
queue 2 kernels 2-5 and queue 1 "Serving tiers").
"""

from __future__ import annotations

import torch

from ragraph_tpu_torch.ops.fused_retrieval import fused_cosine_topk
from ragraph_tpu_torch.ops.similarity import l2_normalize

# Library size above which "auto" leaves the exact sort.
AUTO_APPROX_THRESHOLD = 32_768


def cosine_topk(queries: torch.Tensor, keys: torch.Tensor, k: int,
                valid_mask: torch.Tensor | None = None,
                queries_normalized: bool = False,
                keys_normalized: bool = False,
                method: str = "auto",
                recall_target: float = 0.99,
                score_dtype: str = "input"):
    """Top-k cosine ``(scores, indices)`` of ``queries (Q, E)`` against
    ``keys (R, E)``, each ``(Q, k)`` (see module doc for ``method``)."""
    if score_dtype == "int8":
        raise NotImplementedError(
            "score_dtype='int8' is not ported yet (ROADMAP.md queue 1, "
            "'Serving tiers': the int8 scoring path of ops/topk.py)")
    if score_dtype != "input":
        raise ValueError(f"unknown score_dtype {score_dtype!r}")
    q = queries if queries_normalized else l2_normalize(queries)
    kk = keys if keys_normalized else l2_normalize(keys)
    if method == "auto":
        if keys.shape[0] < AUTO_APPROX_THRESHOLD:
            method = "exact"
        elif recall_target >= 1.0:
            method = "bucket"
        else:
            method = "approx"
    if method == "bucket":
        raise NotImplementedError(
            "method='bucket' is not ported yet (ROADMAP.md queue 2: the "
            "bucket top-k kernels of ops/bucket_topk.py)")
    if method in ("pallas", "approx"):
        return fused_cosine_topk(q, kk, k, valid_mask=valid_mask)
    if method != "exact":
        raise ValueError(f"unknown method {method!r}")
    scores = q.float() @ kk.float().T
    if valid_mask is not None:
        scores = torch.where(valid_mask[None, :].bool(), scores, -torch.inf)
    return torch.topk(scores, k, dim=1)


def topk_gather(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Gather library rows per query: ``(R, E)[(Q, k)] -> (Q, k, E)``."""
    return values[indices.long()]
