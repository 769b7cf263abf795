"""Carry parameters and the retrieval libraries from the JAX package into
the port."""

from __future__ import annotations

import numpy as np
import torch

from ragraph_tpu_torch.device import resolve_device
from ragraph_tpu_torch.nn.lora import LoRAFactors

# The edge-model parameters the port reads: arrays, the LoRA factors as
# ``(A, B)`` pairs of arrays, and the dynamic models' GRU as a dict of four
# arrays.
EDGE_PARAM_KEYS = ("user_embedding", "item_embedding", "gating_weight",
                   "gating_bias", "prompt_vec")
EDGE_LORA_KEYS = ("user_lora", "item_lora")
GRU_PARAM_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")


def params_from_jax(params: dict, device: str | torch.device = "cuda"
                    ) -> dict:
    """Turn the JAX package's edge-model params (a dict of numpy arrays,
    e.g. from its pickle checkpoints or ``np.asarray`` of its jax arrays)
    into f32 tensors on ``device``, under the same keys. ``user_lora`` and
    ``item_lora`` (pairs of arrays ``(A, B)``) become
    :class:`ragraph_tpu_torch.nn.lora.LoRAFactors`; ``gru`` (the dict
    ``w_ih``, ``w_hh``, ``b_ih``, ``b_hh`` of the dynamic models) a dict of
    tensors; ``prompt_vec`` must be ``(1, E)``. Any other key raises."""
    dev = resolve_device(device)
    unknown = (set(params) - set(EDGE_PARAM_KEYS) - set(EDGE_LORA_KEYS)
               - {"gru"})
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
        elif k == "gru":
            if set(v) != set(GRU_PARAM_KEYS):
                raise ValueError(f"gru must hold {list(GRU_PARAM_KEYS)}, "
                                 f"got {sorted(v)}")
            out[k] = {n: put(v[n]) for n in GRU_PARAM_KEYS}
        else:
            out[k] = put(v)
    if "prompt_vec" in out and (out["prompt_vec"].ndim != 2
                                or out["prompt_vec"].shape[0] != 1):
        raise ValueError(f"prompt_vec must be (1, E), got "
                         f"{tuple(out['prompt_vec'].shape)}")
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


# The pretraining heads of the JAX ``PrePrompt`` tree: a ``prompt`` each,
# and a ``BilinearDiscriminator_0`` for all but ``lp``.
_PREPROMPT_HEADS = ("lp", "dgi", "graphcl_edge", "graphcl_mask")


def _np32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _head_params(name: str, sub: dict) -> dict:
    """One head's entries: ``prompt`` as is, and the discriminator's
    ``bilinear_w`` (in the orientation both packages use) and scalar
    ``bilinear_b`` under ``disc``."""
    want = {"prompt"} if name == "lp" \
        else {"prompt", "BilinearDiscriminator_0"}
    if set(sub) != want:
        raise ValueError(f"{name}: entries {sorted(sub)}, expected "
                         f"{sorted(want)}")
    out = {f"{name}.prompt": _np32(sub["prompt"])}
    if name != "lp":
        disc = sub["BilinearDiscriminator_0"]
        if set(disc) != {"bilinear_w", "bilinear_b"}:
            raise ValueError(f"{name}/BilinearDiscriminator_0: entries "
                             f"{sorted(disc)}")
        out[f"{name}.disc.bilinear_w"] = _np32(disc["bilinear_w"])
        out[f"{name}.disc.bilinear_b"] = _np32(disc["bilinear_b"])
    return out


def preprompt_params_from_jax(variables: dict) -> dict:
    """Turn the flax variables of the JAX package's ``PrePrompt`` (numpy
    leaves: ``{"params": {"gcn": {"conv_i": ..., "bn_i": ...}, <heads>},
    "batch_stats": ...}``, as its pickle checkpoints hold them) into a
    ``state_dict`` for :class:`ragraph_tpu_torch.models.preprompt.PrePrompt`
    (CPU tensors). ``Dense_0/kernel`` is ``(in, out)`` and becomes the
    ``(out, in)`` ``lin.weight``; the pretraining heads (``lp``, ``dgi``,
    ``graphcl_edge``, ``graphcl_mask``) convert as they are; any other
    entry raises. Entries the tree lacks (an encoder initialised through
    ``inference`` has no heads and no batch norms) keep the module's
    defaults: pass the result to ``load_state_dict(..., strict=False)`` or
    through :func:`complete_preprompt_state`."""
    params = variables.get("params", variables)
    unknown = set(params) - {"gcn"} - set(_PREPROMPT_HEADS)
    if unknown or "gcn" not in params:
        raise ValueError(f"not a PrePrompt tree: entries {sorted(params)}")
    out = {}
    for name in _PREPROMPT_HEADS:
        if name in params:
            out.update(_head_params(name, params[name]))
    for name, sub in params["gcn"].items():
        kind, _, i = name.partition("_")
        if kind == "conv" and i.isdigit():
            extra = set(sub) - {"Dense_0", "bias", "PReLU_0"}
            if extra:
                raise ValueError(f"gcn/{name}: unknown entries "
                                 f"{sorted(extra)}")
            out[f"gcn.convs.{i}.lin.weight"] = \
                _np32(sub["Dense_0"]["kernel"]).T.contiguous()
            if "bias" in sub:
                out[f"gcn.convs.{i}.bias"] = _np32(sub["bias"])
            if "PReLU_0" in sub:
                out[f"gcn.convs.{i}.act.slope"] = \
                    _np32(sub["PReLU_0"]["slope"])
        elif kind == "bn" and i.isdigit():
            out[f"gcn.bns.{i}.scale"] = _np32(sub["scale"])
            out[f"gcn.bns.{i}.bias"] = _np32(sub["bias"])
        else:
            raise ValueError(f"gcn/{name}: not a layer the port knows")
    stats = variables.get("batch_stats", {}).get("gcn", {})
    for name, sub in stats.items():
        i = name.partition("_")[2]
        out[f"gcn.bns.{i}.mean"] = _np32(sub["mean"])
        out[f"gcn.bns.{i}.var"] = _np32(sub["var"])
    return out


def complete_preprompt_state(partial: dict, module) -> dict:
    """``partial`` filled up with ``module``'s own values for the entries it
    lacks (the batch norms and heads of a tree that never ran them); an
    entry that ``module`` does not have raises."""
    full = {k: v.detach().cpu().clone()
            for k, v in module.state_dict().items()}
    unknown = set(partial) - set(full)
    if unknown:
        raise ValueError(f"entries {sorted(unknown)} do not belong to the "
                         f"encoder")
    full.update(partial)
    return full


def decoder_params_from_jax(variables: dict) -> dict:
    """The flax variables of the JAX package's ``TaskDecoder``
    (``Dense_0``, ``Dense_1``) as a ``state_dict`` for the port's."""
    params = variables.get("params", variables)
    if set(params) != {"Dense_0", "Dense_1"}:
        raise ValueError(f"not a TaskDecoder tree: entries {sorted(params)}")
    out = {}
    for i in (0, 1):
        out[f"dense_{i}.weight"] = \
            _np32(params[f"Dense_{i}"]["kernel"]).T.contiguous()
        out[f"dense_{i}.bias"] = _np32(params[f"Dense_{i}"]["bias"])
    return out


def library_from_jax(keys, values, labels, positions, fill, capacity: int,
                     device: str | torch.device = "cuda"):
    """Carry the JAX package's ``ToyGraphLibrary`` (its four ``(capacity +
    1, ...)`` arrays as numpy, its fill and capacity) to ``device``."""
    from ragraph_tpu_torch.rag.library import ToyGraphLibrary
    dev = resolve_device(device)
    arrays = [np.array(a, dtype=np.float32)
              for a in (keys, values, labels, positions)]
    if any(a.ndim != 2 or a.shape[0] != capacity + 1 for a in arrays):
        raise ValueError(f"library arrays must be 2-d with capacity + 1 = "
                         f"{capacity + 1} rows, got "
                         f"{[a.shape for a in arrays]}")
    return ToyGraphLibrary(
        *(torch.from_numpy(a).to(dev) for a in arrays),
        fill=torch.tensor(int(fill), dtype=torch.int32, device=dev),
        capacity=int(capacity))


def prompt_params_from_jax(variables: dict) -> dict:
    """The flax variables of a JAX ``nn/prompts.py`` module
    (``DownstreamPrompt``, ``WeightedPrompt``, ``WeightedFeature`` or
    ``DownPrompt``) as a ``state_dict`` for the port's module of the same
    name: the tree's paths joined by dots, each leaf a ``weight`` in the
    same orientation."""
    params = variables.get("params", variables)
    out = {}

    def walk(prefix, sub):
        for name, v in sub.items():
            if hasattr(v, "items"):
                walk(f"{prefix}{name}.", v)
            elif name == "weight":
                out[prefix + name] = _np32(v)
            else:
                raise ValueError(f"{prefix}{name}: not a prompt parameter")
    walk("", params)
    return out


def fewshot_state_from_jax(state, device: str | torch.device = "cuda"):
    """The port's ``RAGraphFewshotState`` from the JAX package's: the
    encoder through :func:`preprompt_params_from_jax` (its width and depth
    read off the tree), the library through :func:`library_from_jax` and
    the support set's arrays, all on ``device``."""
    from ragraph_tpu_torch.models.preprompt import PrePrompt
    from ragraph_tpu_torch.models.ragraph_fewshot import (
        FewshotSupportSet, RAGraphFewshotState)
    dev = resolve_device(device)
    sd = preprompt_params_from_jax(state.encoder_params)
    layers = sum(1 for k in sd if k.endswith(".lin.weight")
                 and k.startswith("gcn.convs."))
    hidden, in_features = sd["gcn.convs.0.lin.weight"].shape
    encoder = PrePrompt(in_features, hidden=hidden, num_layers=layers)
    encoder.load_state_dict(complete_preprompt_state(sd, encoder))
    lib = state.library
    library = library_from_jax(*(np.asarray(a) for a in (
        lib.keys, lib.values, lib.labels, lib.positions)),
        int(lib.fill), lib.capacity, dev)
    sup = state.support

    def put(a, dtype):
        return torch.from_numpy(np.array(a)).to(dev, dtype)
    support = FewshotSupportSet(
        put(sup.features, torch.float32), put(sup.adj, torch.float32),
        put(sup.labels, torch.int64),
        None if sup.graph_ids is None else put(sup.graph_ids, torch.int64))
    return RAGraphFewshotState(encoder=encoder.to(dev), library=library,
                               support=support)

