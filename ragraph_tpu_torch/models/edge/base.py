"""Shared pieces of the edge (recommendation) model family, inference part
(counterpart of ``ragraph_tpu/models/edge/base.py``): the config, the
relative edge-time encoding and the LightGCN propagation."""

from __future__ import annotations

import dataclasses

import torch

from ragraph_tpu_torch.ops.csr_segment import (gather_scale_segsum,
                                               sorted_segment_sum_grad)
from ragraph_tpu_torch.ops.segment import scatter_sum, segment_softmax


@dataclasses.dataclass(frozen=True)
class EdgeModelConfig:
    """Typed model config; fields and defaults as in the JAX package (see
    its docstrings for the measured reasons behind each default)."""

    emb_size: int = 64
    num_layers: int = 3
    edge_dropout: float = 0.5
    emb_dropout: float = 0.0
    weight_decay: float = 1e-4
    lr: float = 1e-3
    batch_size: int = 2048
    eval_batch_size: int = 512
    num_epochs: int = 300
    early_stop_patience: int = 10
    metrics: tuple = ("recall", "ndcg")
    metrics_k: tuple = (20,)
    # RAG knobs; rag_chunk is the retrieval query-chunk size (defaults to
    # batch_size)
    rag_chunk: int | None = None
    retrieve_weight: float = 0.3
    retrieve_num: int = 10
    noise_retrieve_num: int = 1
    num_augment_scale: int = 0
    num_inverse_sample: int = 0
    use_noise: bool = False
    lora_rank: int = 16
    use_lora: bool = False
    lora_init_scale: float = 0.0
    lora_train_factors: bool = True
    # "auto" picks fused on CUDA when the sender-order arrays exist, else
    # sorted on CUDA, else scatter; "fused"/"sorted"/"scatter" force one
    segsum_impl: str = "auto"
    # "auto" = bf16 rows with f32 sums on CUDA, f32 elsewhere
    propagate_dtype: str = "auto"
    time_mode: str = "static"
    retrieve_dtype: str = "input"
    selection_dtype: str = "f32"
    temp: float = 0.2
    lbd: float = 0.1
    eps: float = 0.1
    n_negs: int = 16

    def __post_init__(self):
        if self.selection_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"selection_dtype must be 'f32' or 'bf16', got "
                f"{self.selection_dtype!r}")
        if self.retrieve_dtype not in ("input", "bf16", "int8"):
            raise ValueError(
                f"retrieve_dtype must be 'input', 'bf16' or 'int8', got "
                f"{self.retrieve_dtype!r}")


def relative_time_encoding(edge_times: torch.Tensor,
                           receivers: torch.Tensor, num_nodes: int,
                           edge_mask: torch.Tensor | None = None,
                           max_step=None) -> torch.Tensor:
    """Per-destination softmax over min-max rescaled edge times; masked
    edges get probability 0."""
    t = edge_times.float()
    if edge_mask is not None:
        big = torch.where(edge_mask, t, -torch.inf).max()
        small = torch.where(edge_mask, t, torch.inf).min()
    else:
        big, small = t.max(), t.min()
    if max_step is not None:
        big = torch.tensor(float(max_step), device=t.device)
    t = (t - small) / torch.clamp_min(big - small, 1e-12)
    return segment_softmax(t, receivers, num_nodes, mask=edge_mask)


def lightgcn_propagate(all_emb: torch.Tensor, senders: torch.Tensor,
                       receivers: torch.Tensor, weights: torch.Tensor,
                       num_nodes: int, num_layers: int,
                       recv_indptr: torch.Tensor | None = None,
                       impl: str = "scatter",
                       weights_send: torch.Tensor | None = None,
                       recv_of_send: torch.Tensor | None = None,
                       send_indptr: torch.Tensor | None = None,
                       bf16: bool = True) -> list:
    """LightGCN layers; returns ``[h0, h1, ..., hL]``.

    ``impl="fused"`` with all sender-order arrays runs
    :func:`gather_scale_segsum` (kernel A); ``"fused"`` without them falls
    to ``"sorted"``, which gathers and scales the rows and sums them with
    :func:`sorted_segment_sum_grad` (kernel B); ``"scatter"`` is
    ``index_add_``.
    """
    use_fused = (impl == "fused" and recv_indptr is not None
                 and weights_send is not None and recv_of_send is not None
                 and send_indptr is not None)
    use_sorted = (impl in ("sorted", "fused") and not use_fused
                  and recv_indptr is not None)
    layers = [all_emb]
    for _ in range(num_layers):
        if use_fused:
            layers.append(gather_scale_segsum(
                layers[-1], weights, weights_send, senders, recv_indptr,
                recv_of_send, send_indptr, bf16=bf16))
            continue
        msgs = layers[-1][senders.long()] * weights[:, None]
        if use_sorted:
            layers.append(sorted_segment_sum_grad(msgs, recv_indptr,
                                                  receivers))
        else:
            layers.append(scatter_sum(msgs, receivers, num_nodes))
    return layers
