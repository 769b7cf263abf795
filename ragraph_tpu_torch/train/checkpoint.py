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
    package's ``restore_sharded`` (:func:`restore_sharded` is the mesh
    half).

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


def _slice_like(template, tree, mesh, axis_name):
    if isinstance(template, dict):
        return {k: _slice_like(template[k], v, mesh, axis_name)
                if k in template else v for k, v in tree.items()}
    if isinstance(template, (tuple, list)):
        return type(tree)(_slice_like(t, v, mesh, axis_name)
                          for t, v in zip(template, tree))
    if isinstance(template, torch.Tensor):
        from ragraph_tpu_torch.parallel.mesh import shard_rows
        whole = torch.as_tensor(np.asarray(tree))
        if template.dim() >= 1 and whole.dim() >= 1 \
                and template.shape[0] != whole.shape[0]:
            whole = shard_rows(mesh, whole, axis_name)
        if whole.shape != template.shape:
            raise ValueError(f"restore_sharded: saved shape "
                             f"{tuple(whole.shape)} fits neither the "
                             f"template's {tuple(template.shape)} nor its "
                             f"block on '{axis_name}'")
        return whole.to(device=template.device, dtype=template.dtype)
    return tree


def restore_sharded(path: str, template, mesh, axis_name: str = "idx"):
    """Restore a checkpoint onto the template's layout on this rank.

    The file holds whole arrays (rank 0 writes gathered tables). A template
    leaf with fewer rows than its saved array is this rank's row block on
    ``axis_name`` (an ``idx``-sharded table or library), and gets that
    block; a leaf of the saved shape is replicated and gets the whole
    array; both in the template's dtype and device. Other leaves pass
    through. Every rank reads the file.
    """
    return _slice_like(template, restore_checkpoint(path), mesh, axis_name)


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
