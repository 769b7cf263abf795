"""Embedding gating (counterpart of ``ragraph_tpu/nn/gating.py``): the
learned gate of the finetune phase and the random gate of ``for_tune``."""

from __future__ import annotations

import torch

from ragraph_tpu_torch.ops.similarity import l2_normalize


def learned_gate(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 dropout_rate: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """``dropout(x * sigmoid(x @ W + b))``; dropout only with a generator."""
    out = x * torch.sigmoid(x @ weight + bias)
    if dropout_rate > 0.0 and generator is not None:
        keep = torch.rand(out.shape, generator=generator,
                          device=out.device) < 1.0 - dropout_rate
        out = torch.where(keep, out / (1.0 - dropout_rate), 0.0)
    return out


def random_gate(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Gate with freshly drawn row-normalised Gaussian ``W`` and ``b``."""
    emb = x.shape[-1]
    w = l2_normalize(torch.randn((emb, emb), generator=generator,
                                 device=x.device))
    b = l2_normalize(torch.randn((1, emb), generator=generator,
                                 device=x.device))
    return x * torch.sigmoid(x @ w + b)
