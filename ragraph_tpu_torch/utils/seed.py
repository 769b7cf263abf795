"""Seeding helpers (counterpart of ``ragraph_tpu/utils/seed.py``)."""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int):
    """Seed ``random``, ``np.random`` and torch's default generators;
    return ``(torch.Generator, np.random.Generator)`` seeded with ``seed``.

    The JAX package returns a root ``jax.random`` key where this returns a
    CPU ``torch.Generator``; the numpy generator is the same draw for draw.
    ``PYTHONHASHSEED`` is not set: CPython reads it only at start-up.
    """
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed), np.random.default_rng(seed)
