"""Carry parameters and the retrieval library from the JAX package into the
port."""

from __future__ import annotations

import numpy as np
import torch

from ragraph_tpu_torch.device import resolve_device
from ragraph_tpu_torch.nn.lora import LoRAFactors

# The edge-model parameters the port reads: four arrays, and the LoRA
# factors as ``(A, B)`` pairs of arrays.
EDGE_PARAM_KEYS = ("user_embedding", "item_embedding", "gating_weight",
                   "gating_bias")
EDGE_LORA_KEYS = ("user_lora", "item_lora")


def params_from_jax(params: dict, device: str | torch.device = "cuda"
                    ) -> dict:
    """Turn the JAX package's edge-model params (a dict of numpy arrays,
    e.g. from its pickle checkpoints or ``np.asarray`` of its jax arrays)
    into f32 tensors on ``device``, under the same keys. ``user_lora`` and
    ``item_lora`` (pairs of arrays ``(A, B)``) become
    :class:`ragraph_tpu_torch.nn.lora.LoRAFactors`."""
    dev = resolve_device(device)
    unknown = set(params) - set(EDGE_PARAM_KEYS) - set(EDGE_LORA_KEYS)
    if unknown:
        raise ValueError(f"params {sorted(unknown)} are not edge-model "
                         f"parameters the port knows")

    def put(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    out = {}
    for k, v in params.items():
        if k in EDGE_LORA_KEYS:
            if len(v) != 2:
                raise ValueError(f"{k} must be a pair (A, B), got "
                                 f"{len(v)} entries")
            out[k] = LoRAFactors(put(v[0]), put(v[1]))
        else:
            out[k] = put(v)
    return out


def resources_from_jax(resource_keys, resource_values,
                       device: str | torch.device = "cuda") -> tuple:
    """Turn the JAX package's retrieval library (``resource_keys`` and
    ``resource_values`` of an edge model, as numpy arrays) into f32 tensors
    on ``device``: the ``resources`` argument of the port's ``generate``."""
    dev = resolve_device(device)
    keys = np.array(resource_keys, dtype=np.float32)
    values = np.array(resource_values, dtype=np.float32)
    if keys.ndim != 2 or values.ndim != 2 or len(keys) != len(values):
        raise ValueError(f"library keys {keys.shape} and values "
                         f"{values.shape} must be 2-d with equal rows")
    return torch.from_numpy(keys).to(dev), torch.from_numpy(values).to(dev)


def int8_keys_from_jax(table, device: str | torch.device = "cuda"
                       ) -> torch.Tensor:
    """Carry a key table pre-quantized by the JAX package's
    ``quantize_keys_i8`` (a numpy int8 array) to ``device``, for
    ``cosine_topk(score_dtype="int8")``."""
    table = np.array(table)     # a writable copy: jax arrays export read-only
    if table.dtype != np.int8 or table.ndim != 2:
        raise ValueError(f"expected a 2-d int8 table, got {table.dtype} "
                         f"{table.shape}")
    return torch.from_numpy(table).to(resolve_device(device))
