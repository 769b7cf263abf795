"""Library-build augmentations (counterpart of
``ragraph_tpu/rag/augmentation.py``): ``augment_features`` and
``augment_adj``. Each draws from the caller's generator, or takes its
draws as arguments. Inputs may carry leading batch dimensions."""

from __future__ import annotations

import torch


def _need(generator, what: str):
    if generator is None:
        raise ValueError(f"{what} needs its draws or a generator")
    return generator


def augment_features(generator: torch.Generator | None,
                     features: torch.Tensor, sample_prob: torch.Tensor,
                     noise_std: float = 0.1, dropout_rate: float = 0.01, *,
                     noise: torch.Tensor | None = None,
                     keep_u: torch.Tensor | None = None) -> torch.Tensor:
    """Gaussian noise, then node dropout keeping node ``i`` with
    probability ``clip(sample_prob[i] * dropout_rate, 0, 1)`` (the
    reference's inverse-importance dropout, reproduced verbatim).
    ``noise`` (standard normals shaped like ``features``) and ``keep_u``
    (uniforms shaped like ``sample_prob``; a node stays where ``keep_u <
    keep probability``) replace the generator's draws."""
    if noise is None:
        noise = torch.randn(features.shape,
                            generator=_need(generator, "augment_features"),
                            device=features.device, dtype=features.dtype)
    noisy = features + noise_std * noise
    keep_prob = torch.clamp(sample_prob * dropout_rate, 0.0, 1.0)
    if keep_u is None:
        keep = torch.bernoulli(keep_prob,
                               generator=_need(generator, "augment_features"))
    else:
        keep = keep_u < keep_prob
    return noisy * keep[..., None].to(features.dtype)


def augment_adj(generator: torch.Generator | None, adj: torch.Tensor,
                sample_prob: torch.Tensor,
                node_mask: torch.Tensor | None = None, *,
                u: torch.Tensor | None = None) -> torch.Tensor:
    """Probabilistic edge rewrite ``A'[i,j] = 1{U < (p_i + p_j)/2}`` on the
    real nodes; ``u`` (uniforms shaped like ``adj``) replaces the
    generator's draws."""
    keep_prob = (sample_prob[..., :, None] + sample_prob[..., None, :]) * 0.5
    if u is None:
        u = torch.rand(adj.shape, generator=_need(generator, "augment_adj"),
                       device=adj.device, dtype=adj.dtype)
    new_adj = (u < keep_prob).to(adj.dtype)
    if node_mask is not None:
        m = node_mask.to(adj.dtype)
        new_adj = new_adj * m[..., :, None] * m[..., None, :]
    return new_adj
