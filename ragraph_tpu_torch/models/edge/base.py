"""Shared pieces of the edge (recommendation) model family (counterpart of
``ragraph_tpu/models/edge/base.py``): the config, the losses, the edge
dropout masks, the relative edge-time encoding and the LightGCN
propagation."""

from __future__ import annotations

import dataclasses

import torch

from ragraph_tpu_torch.ops.csr_segment import (WalkPlan, gather_scale_segsum,
                                               sorted_segment_sum_grad)
from ragraph_tpu_torch.ops.segment import scatter_sum, segment_softmax
from ragraph_tpu_torch.ops.similarity import l2_normalize


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


def bpr_loss(user_emb, pos_item_emb, neg_item_emb):
    """``-log sigmoid(pos - neg)``, averaged."""
    pos_score = (user_emb * pos_item_emb).sum(dim=1)
    neg_score = (user_emb * neg_item_emb).sum(dim=1)
    return -torch.log(1e-10 + torch.sigmoid(pos_score - neg_score)).mean()


def nce_loss(pos_score, neg_score, edge_weight=1.0):
    """NCE with ``neg_score`` of shape ``(B, N)``."""
    numerator = torch.exp(pos_score)
    denominator = numerator + torch.exp(neg_score).sum(dim=1)
    return (-torch.log(numerator / denominator) * edge_weight).mean()


def cal_infonce(view1, view2, temperature: float, b_cos: bool = True,
                mask: torch.Tensor | None = None):
    """In-batch InfoNCE. ``mask`` (``(B,)`` bool) leaves padded rows out of
    every denominator and of the mean (see :func:`unique_padded`)."""
    if b_cos:
        view1 = l2_normalize(view1)
        view2 = l2_normalize(view2)
    pos_score = torch.exp((view1 * view2).sum(dim=-1) / temperature)
    sim = view1.float() @ view2.float().T
    if mask is not None:
        sim = torch.where(mask[None, :], sim, -torch.inf)
    ttl_score = torch.exp(sim / temperature).sum(dim=1)
    losses = -torch.log(pos_score / ttl_score + 1e-5)
    if mask is not None:
        mm = mask.to(losses.dtype)
        return (losses * mm).sum() / torch.clamp_min(mm.sum(), 1.0)
    return losses.mean()


def unique_padded(x: torch.Tensor, size: int):
    """Fixed-size unique: the sorted distinct values of ``x`` cut or padded
    to ``size``; returns ``(values, valid_mask)`` with padding read as 0."""
    vals = torch.unique(x)[:size]
    out = torch.full((size,), -1, dtype=x.dtype, device=x.device)
    out[:len(vals)] = vals
    valid = out >= 0
    return torch.where(valid, out, 0), valid


def reg_loss_emb(user_table, item_table, users, pos_items, neg_items):
    """``½(‖u‖² + ‖i⁺‖² + ‖i⁻‖²)/B`` on the tables' rows of the batch."""
    u = user_table[users.long()]
    p = item_table[pos_items.long()]
    n = item_table[neg_items.long()]
    return 0.5 * ((u ** 2).sum() + (p ** 2).sum() + (n ** 2).sum()) \
        / users.shape[0]


def check_finite(loss):
    """Whether ``loss`` is finite, as a tensor (no host read)."""
    return torch.isfinite(loss)


def edge_drop_mask(generator: torch.Generator, num_edges: int,
                   keep_rate: float, device=None):
    """Bernoulli keep mask drawn from ``generator``."""
    device = device if device is not None else generator.device
    if keep_rate >= 1.0:
        return torch.ones(num_edges, dtype=torch.bool, device=device)
    return torch.rand(num_edges, generator=generator,
                      device=device) < keep_rate


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)``. torch has no
    uint32 multiply, and the int64 product would pass 2**63, so the high
    half of ``x`` is multiplied apart and only its low 16 bits kept."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_edge_mask(salt, edge_ids: torch.Tensor, keep_rate: float):
    """Keep mask from a stateless integer hash of the edge id: the JAX
    package's uint32 arithmetic (a murmur3-style finalizer) in int64 masked
    to 32 bits, bit for bit the same mask for the same ``salt``.

    A pure elementwise function of ``(salt, edge id)``, so the same mask
    exists in sender order by hashing ``graph.send_perm``, without a
    gather. ``salt`` is an int or a 0-d integer tensor; its low 32 bits
    count.
    """
    if keep_rate >= 1.0:
        return torch.ones(edge_ids.shape, dtype=torch.bool,
                          device=edge_ids.device)
    if isinstance(salt, torch.Tensor):
        salt = salt.to(edge_ids.device, torch.int64)
    x = (_mul32(edge_ids.to(torch.int64) & _M32, 0x9E3779B9)
         + (salt & _M32)) & _M32
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)
    # clamp: a keep_rate in (1 - 2**-33, 1) would round to 2**32, which as a
    # uint32 threshold wraps to 0 and drops every edge instead of none
    thresh = min(round(keep_rate * 4294967296.0), 4294967295)
    return x < thresh


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
                       bf16: bool = True,
                       recv_plan: WalkPlan | None = None,
                       send_plan: WalkPlan | None = None) -> list:
    """LightGCN layers; returns ``[h0, h1, ..., hL]``.

    ``impl="fused"`` with all sender-order arrays runs
    :func:`gather_scale_segsum` (kernel A, with the walk plans of the two
    indptrs when given); ``"fused"`` without them falls
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
                recv_of_send, send_indptr, bf16=bf16, recv_plan=recv_plan,
                send_plan=send_plan))
            continue
        msgs = layers[-1][senders.long()] * weights[:, None]
        if use_sorted:
            layers.append(sorted_segment_sum_grad(msgs, recv_indptr,
                                                  receivers))
        else:
            layers.append(scatter_sum(msgs, receivers, num_nodes))
    return layers
