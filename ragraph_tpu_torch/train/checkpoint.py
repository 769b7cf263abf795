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


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(path: str, tree) -> str:
    """Pickle ``tree`` (tensors become numpy arrays) to ``path`` + ``.pkl``."""
    path = path if path.endswith(".pkl") else path + ".pkl"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_host(tree), f)
    return path


def restore_checkpoint(path: str):
    """Load a tree saved by :func:`save_checkpoint` (numpy leaves)."""
    pkl = path if path.endswith(".pkl") else path + ".pkl"
    with open(pkl, "rb") as f:
        return pickle.load(f)
