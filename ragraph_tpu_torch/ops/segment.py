"""Segment primitives (counterpart of ``ragraph_tpu/ops/segment.py``)."""

from __future__ import annotations

import torch


def scatter_sum(src: torch.Tensor, index: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``src`` rows into ``num_segments`` buckets keyed by ``index``."""
    out = torch.zeros((num_segments, *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    return out.index_add_(0, index, src)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Numerically stable softmax within segments of a flat vector.

    Masked entries get probability 0 and do not affect their segment.
    """
    if mask is not None:
        logits = torch.where(mask, logits, -torch.inf)
    seg_max = torch.full((num_segments,), -torch.inf, dtype=logits.dtype,
                         device=logits.device)
    seg_max = seg_max.scatter_reduce(0, segment_ids.long(), logits, "amax")
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    exp = torch.exp(logits - seg_max[segment_ids.long()])
    if mask is not None:
        exp = torch.where(mask, exp, 0.0)
    denom = scatter_sum(exp, segment_ids, num_segments)
    return exp / torch.clamp_min(denom[segment_ids.long()], 1e-16)
