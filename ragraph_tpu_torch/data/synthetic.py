"""Synthetic temporal interactions (counterpart of
``ragraph_tpu/data/synthetic.py::synthetic_edge_stream``)."""

from __future__ import annotations

import numpy as np


def synthetic_edge_stream(seed: int = 0, num_users: int = 64,
                          num_items: int = 128, num_classes: int = 4,
                          interactions_per_user: int = 12,
                          num_stages: int = 3):
    """Synthetic ``(user, item, time)`` rows with taste clusters: users
    prefer items of their own cluster, so recall@k is learnable.

    Returns ``(train, stages)``; the same seed gives the same rows as the
    JAX package's generator.
    """
    rng = np.random.default_rng(seed)
    user_cluster = rng.integers(0, num_classes, size=num_users)
    item_cluster = rng.integers(0, num_classes, size=num_items)
    by_cluster = [np.where(item_cluster == c)[0] for c in range(num_classes)]

    def draw(user, t):
        c = user_cluster[user]
        if rng.random() < 0.8 and len(by_cluster[c]) > 0:
            item = int(rng.choice(by_cluster[c]))
        else:
            item = int(rng.integers(0, num_items))
        return (user, item, int(t))

    phases = []
    t0 = 1_600_000_000
    for phase in range(1 + num_stages):
        rows = []
        for u in range(num_users):
            for i in range(interactions_per_user):
                t = t0 + phase * 1_000_000 + int(rng.integers(0, 900_000))
                rows.append(draw(u, t))
        phases.append(rows)
    return phases[0], phases[1:]
