"""Library-build feature augmentation (counterpart of
``ragraph_tpu/rag/augmentation.py::augment_features``)."""

from __future__ import annotations

import torch


def augment_features(generator: torch.Generator, features: torch.Tensor,
                     sample_prob: torch.Tensor, noise_std: float = 0.1,
                     dropout_rate: float = 0.01) -> torch.Tensor:
    """Gaussian noise, then node dropout keeping node ``i`` with
    probability ``clip(sample_prob[i] * dropout_rate, 0, 1)`` (the
    reference's inverse-importance dropout, reproduced verbatim)."""
    noise = torch.randn(features.shape, generator=generator,
                        device=features.device, dtype=features.dtype)
    noisy = features + noise_std * noise
    keep_prob = torch.clamp(sample_prob * dropout_rate, 0.0, 1.0)
    keep = torch.bernoulli(keep_prob, generator=generator)
    return noisy * keep[:, None].to(features.dtype)
