"""Library-build augmentations (counterpart of
``ragraph_tpu/rag/augmentation.py``): ``augment_features``,
``augment_adj``, the mixup node insertion ``interpolation_node`` and the
copy generator ``augment_graph``. Each draws from the caller's generator,
or takes its draws as arguments. ``augment_features`` and ``augment_adj``
take leading batch dimensions."""

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


def interpolation_node(generator: torch.Generator | None,
                       features: torch.Tensor, adj: torch.Tensor,
                       interpolation_num: int = 5, alpha: float = 0.5, *,
                       pairs: torch.Tensor | None = None):
    """Mixup node insertion into ``interpolation_num`` extra rows of one
    graph ``features (N, F)``, ``adj (N, N)``: row ``N + i`` gets ``alpha *
    x[src] + (1 - alpha) * x[dst]`` and symmetric edges of weight ``alpha``
    to ``src`` and ``1 - alpha`` to ``dst``, for the ``i``-th of ``pairs
    (interpolation_num, 2)`` (node indices, drawn uniformly when not
    given). Returns ``(features (N + n, F), adj (N + n, N + n))``."""
    n, f = features.shape
    if pairs is None:
        pairs = torch.randint(0, n, (interpolation_num, 2),
                              generator=_need(generator,
                                              "interpolation_node"),
                              device=features.device)
    new_f = features.new_zeros((n + interpolation_num, f))
    new_f[:n] = features
    new_a = adj.new_zeros((n + interpolation_num,) * 2)
    new_a[:n, :n] = adj
    for i in range(interpolation_num):     # later pairs overwrite earlier
        src, dst = pairs[i, 0].long(), pairs[i, 1].long()
        row = n + i
        new_f[row] = alpha * features[src] + (1 - alpha) * features[dst]
        new_a[row, src] = alpha
        new_a[src, row] = alpha
        new_a[row, dst] = 1 - alpha
        new_a[dst, row] = 1 - alpha
    return new_f, new_a


def augment_graph(generator: torch.Generator | None, num_augment_scale: int,
                  features: torch.Tensor, adj: torch.Tensor,
                  sample_prob: torch.Tensor,
                  node_mask: torch.Tensor | None = None, draws=None):
    """Yield ``(features, adj)`` for the original graph, then for
    ``num_augment_scale`` augmented copies (:func:`augment_features`, then
    :func:`augment_adj`). ``draws`` may give each copy's draws, a sequence
    of dicts with ``noise``, ``keep_u`` and ``u``; what is missing is
    drawn from ``generator``."""
    yield features, adj
    for i in range(num_augment_scale):
        d = draws[i] if draws is not None else {}
        yield (augment_features(generator, features, sample_prob,
                                noise=d.get("noise"),
                                keep_u=d.get("keep_u")),
               augment_adj(generator, adj, sample_prob, node_mask,
                           u=d.get("u")))
