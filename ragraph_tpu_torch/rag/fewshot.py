"""Few-shot class prototypes and the FewShotBase predictor (counterpart of
``ragraph_tpu/rag/fewshot.py``).

- :func:`fewshot_mean_logits`: the per-class mean of support logits, a
  segment mean (``index_add_`` of the rows and of the counts);
- :func:`fewshot_predict_logits`: cosine similarity of query logits to the
  class prototypes;
- :func:`fewshot_predict_labels`: the argmax over those similarities;
- :func:`fewshot_predict_loss`: the mean squared distance to the gold
  class prototype, optionally masked;
- :class:`FewShotBase`: decode the queries and a fixed support set with the
  task's decoder, then score ``similarity @ onehot``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ragraph_tpu_torch.ops.similarity import cosine_similarity, l2_normalize


def fewshot_mean_logits(fewshot_logits: torch.Tensor,
                        fewshot_labels: torch.Tensor,
                        num_classes: int) -> torch.Tensor:
    """Per-class mean of support logits ``(S, H)`` -> ``(C, H)``
    prototypes; a class without support rows gets a zero row."""
    idx = fewshot_labels.long()
    sums = fewshot_logits.new_zeros((num_classes, fewshot_logits.shape[1]))
    sums = sums.index_add(0, idx, fewshot_logits)
    counts = fewshot_logits.new_zeros(num_classes).index_add_(
        0, idx, torch.ones_like(idx, dtype=fewshot_logits.dtype))
    return sums / torch.clamp_min(counts, 1.0)[:, None]


def fewshot_predict_logits(mean_fewshot_logits: torch.Tensor,
                           logits: torch.Tensor) -> torch.Tensor:
    """Cosine similarity ``(N, H) x (C, H) -> (N, C)``."""
    return l2_normalize(logits) @ l2_normalize(mean_fewshot_logits).T


def fewshot_predict_labels(mean_fewshot_logits: torch.Tensor,
                           logits: torch.Tensor) -> torch.Tensor:
    """Nearest-prototype class indices."""
    return fewshot_predict_logits(mean_fewshot_logits, logits).argmax(dim=-1)


def fewshot_predict_loss(mean_fewshot_logits: torch.Tensor,
                         logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean squared distance between query logits and their gold class
    prototype, averaged over the rows ``mask`` keeps (all without one)."""
    gold = mean_fewshot_logits[labels.long()]
    per = ((logits - gold) ** 2).mean(dim=-1)
    if mask is None:
        return per.mean()
    m = mask.to(per.dtype)
    return (per * m).sum() / torch.clamp_min(m.sum(), 1.0)


class FewShotBase:
    """Cosine-to-support predictor over a fixed support set: the queries
    and the support embeddings both go through ``decoder``, and the class
    scores are ``cosine(q, s) @ onehot(support labels)``."""

    def __init__(self, support_embeddings: torch.Tensor,
                 support_labels: torch.Tensor, num_classes: int):
        self.support_embeddings = support_embeddings
        self.support_onehot = torch.nn.functional.one_hot(
            support_labels.long(), num_classes).to(support_embeddings.dtype)

    def __call__(self, search_embeddings: torch.Tensor,
                 decoder: Callable) -> torch.Tensor:
        sim = cosine_similarity(decoder(search_embeddings),
                                decoder(self.support_embeddings))
        return sim @ self.support_onehot
