"""Pickle checkpoints (counterpart of ``ragraph_tpu/train/checkpoint.py``'s
``use_orbax=False`` format).

A checkpoint is a pickled tree of dicts, lists and numpy arrays, the same
file the JAX package writes with ``save_checkpoint(..., use_orbax=False)``,
so tables pretrained by either package load in the other. The JAX
package's orbax directories are not read (:func:`restore_checkpoint`).
Unpickling runs code from the file: load only checkpoints this project
wrote.
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


def _like(template, tree):
    """``tree``'s leaves as tensors of ``template``'s dtypes and devices,
    where the template holds a tensor; other leaves pass through."""
    if isinstance(template, dict):
        return {k: _like(template[k], v) if k in template else v
                for k, v in tree.items()}
    if isinstance(template, (tuple, list)):
        return type(tree)(_like(t, v) for t, v in zip(template, tree))
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(np.asarray(tree)).to(device=template.device,
                                                    dtype=template.dtype)
    return tree


def restore_checkpoint(path: str, template=None):
    """Load a tree saved by :func:`save_checkpoint`. Its leaves are numpy
    arrays, or with ``template`` (a tree of the same structure) tensors of
    the template's dtypes and devices: the one-device half of the JAX
    package's ``restore_sharded``.

    The JAX package's default format is an orbax directory. orbax imports
    JAX (and needs tensorstore), which the port does not depend on, so the
    pickle file is the one format both packages read; a directory raises a
    ``ValueError`` that says so.
    """
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, which is the JAX package's orbax "
            f"format; the port reads only the pickle format that both "
            f"packages write (ragraph_tpu save_checkpoint(..., "
            f"use_orbax=False)), since orbax imports JAX")
    pkl = path if path.endswith(".pkl") else path + ".pkl"
    with open(pkl, "rb") as f:
        tree = pickle.load(f)
    return tree if template is None else _like(template, tree)


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
