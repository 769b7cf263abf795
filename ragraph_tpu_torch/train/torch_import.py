"""Import of the reference's ``.pt`` pretrained tables (counterpart of
``ragraph_tpu/train/torch_import.py``).

The reference finetunes from ``torch.save``d checkpoints whose embedding
entries are ``user_embedding`` and ``item_embedding`` (bare parameters, or
``nn.Embedding``s with a ``.weight`` suffix). :func:`tables_from_torch`
turns such a file into the numpy table dict that ``staged_finetune`` and
``staged_dynamic`` take as ``pretrain_tables``, the same dict the pickle
checkpoints hold, so ``cli.edge finetune --pre-model-path x.pt`` runs.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

TABLE_PREFIXES = ("user_embedding", "item_embedding")
_WRAPPER_KEYS = ("state_dict", "model_state_dict", "model")


def load_torch_state_dict(path: str) -> dict:
    """``torch.load`` a checkpoint onto the CPU; return its tensors as numpy
    arrays by name.

    Takes a bare state dict, one wrapped under ``state_dict``,
    ``model_state_dict`` or ``model``, or a whole saved module. A file that
    the safe loader (``weights_only=True``) refuses, such as a module or a
    dict holding an ``argparse.Namespace``, is loaded in full, which runs
    code from the file: load only checkpoints you trust.
    """
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):           # a whole nn.Module
        obj = obj.state_dict()
    for key in _WRAPPER_KEYS:
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    out = {}
    for k, v in obj.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy()
        elif isinstance(v, np.ndarray):
            out[k] = v
        # other entries (hyperparameters and the like) are dropped
    return out


def tables_from_torch(path: str) -> dict:
    """``{"user_embedding": (U, D) f32, "item_embedding": (I, D) f32}`` from
    a reference ``.pt``; ``KeyError`` if a table is missing."""
    sd = load_torch_state_dict(path)
    tables = {}
    for prefix in TABLE_PREFIXES:
        for cand in (prefix, prefix + ".weight"):
            if cand in sd:
                tables[prefix] = np.asarray(sd[cand], dtype=np.float32)
                break
        else:
            raise KeyError(
                f"{path}: no '{prefix}' entry (keys: {sorted(sd)[:8]}...)")
    return tables
