"""Pickle checkpoints (counterpart of ``ragraph_tpu/train/checkpoint.py``'s
``use_orbax=False`` format).

A checkpoint is a pickled tree of dicts, lists and numpy arrays, the same
file the JAX package writes with ``save_checkpoint(..., use_orbax=False)``,
so tables pretrained by either package load in the other. Unpickling runs
code from the file: load only checkpoints this project wrote.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def to_host(tree):
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple):     # a named tuple becomes a plain one
        return tuple(to_host(v) for v in tree)
    if isinstance(tree, list):
        return [to_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    return np.asarray(tree)


def save_checkpoint(path: str, tree) -> str:
    """Pickle ``tree`` (tensors become numpy arrays) to ``path`` + ``.pkl``."""
    path = path if path.endswith(".pkl") else path + ".pkl"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(to_host(tree), f)
    return path


def restore_checkpoint(path: str):
    """Load a tree saved by :func:`save_checkpoint` (numpy leaves)."""
    pkl = path if path.endswith(".pkl") else path + ".pkl"
    with open(pkl, "rb") as f:
        return pickle.load(f)


class BestCheckpointKeeper:
    """Save-on-best helper (a higher metric is better): writes
    ``<directory>/<name>.pkl`` whenever :meth:`update` sees a new best."""

    def __init__(self, directory: str, name: str = "best"):
        self.directory = directory
        self.name = name
        self.best_metric = -float("inf")
        self.path = None

    def update(self, metric: float, tree) -> bool:
        if metric > self.best_metric:
            self.best_metric = metric
            self.path = save_checkpoint(
                os.path.join(self.directory, self.name), tree)
            return True
        return False
