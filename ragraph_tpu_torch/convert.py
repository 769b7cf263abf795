"""Carry parameters from the JAX package into the port."""

from __future__ import annotations

import numpy as np
import torch

from ragraph_tpu_torch.device import resolve_device

# The edge-model parameters the port's serving path reads.
EDGE_PARAM_KEYS = ("user_embedding", "item_embedding", "gating_weight",
                   "gating_bias")


def params_from_jax(params: dict, device: str | torch.device = "cuda"
                    ) -> dict:
    """Turn the JAX package's edge-model params (a dict of numpy arrays,
    e.g. from its pickle checkpoints or ``np.asarray`` of its jax arrays)
    into f32 tensors on ``device``, under the same keys."""
    dev = resolve_device(device)
    unknown = set(params) - set(EDGE_PARAM_KEYS)
    if unknown:
        raise NotImplementedError(
            f"params {sorted(unknown)} have no counterpart in the port yet "
            "(LoRA factors: ROADMAP.md queue 1, 'Edge model core')")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in params.items()}
