"""Shared pieces of the edge (recommendation) model family (counterpart of
``ragraph_tpu/models/edge/base.py``): the config, the losses, the edge
dropout draws (:class:`EdgeDraws`; the hash itself lives beside its kernel
in ``ops/edge_weights.py``), the relative edge-time encoding and the
LightGCN propagation."""

from __future__ import annotations

import dataclasses

import torch

from ragraph_tpu_torch.ops.csr_segment import (WalkPlan, gather_scale_segsum,
                                               sorted_segment_sum_grad)
from ragraph_tpu_torch.ops.edge_weights import (  # noqa: F401
    hash_edge_mask, keep_mask)
from ragraph_tpu_torch.ops.segment import scatter_sum, segment_softmax
from ragraph_tpu_torch.ops.similarity import l2_normalize
from ragraph_tpu_torch.train.profiling import count


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


def unique_padded(x: torch.Tensor, size: int, count_as: str | None = None):
    """Fixed-size unique: the sorted distinct values of ``x`` cut or padded
    to ``size``; returns ``(values, valid_mask)`` with padding read as 0
    (and, as padding, any negative value). No value is read on the host:
    the ``j``-th distinct value is the sorted ``x`` at the first position
    whose distinct-rank is ``j``. ``count_as`` names a profiler counter
    that adds the valid rows."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    if n == 0:
        return (torch.zeros(size, dtype=x.dtype, device=x.device),
                torch.zeros(size, dtype=torch.bool, device=x.device))
    first = torch.ones(n, dtype=torch.bool, device=x.device)
    first[1:] = s[1:] != s[:-1]
    rank = torch.cumsum(first, 0) - 1
    at = torch.searchsorted(rank, torch.arange(size, device=x.device))
    vals = s[at.clamp_max(n - 1)]
    valid = (at < n) & (vals >= 0)
    if count_as is not None:
        count(count_as, valid.sum())
    return torch.where(valid, vals, 0), valid


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


@dataclasses.dataclass(frozen=True)
class EdgeDraws:
    """A step's edge dropout as the draws that define it, before any mask
    exists: an edge is kept where :func:`hash_edge_mask` keeps it for every
    ``(salt, keep rate)`` of ``draws`` (none keeps every edge), its id being
    its position in receiver order and ``send_perm`` in sender order.

    ``&`` ANDs two records (SGL's views). :meth:`masks`, or unpacking, gives
    the ``(receiver order, sender order)`` bool masks for code that takes
    masks; ``TemporalLightGCN._edge_weights`` turns a record into weights
    without them where it can (``ops/edge_weights.py``).
    """

    draws: tuple
    send_perm: torch.Tensor

    def masks(self):
        ids = torch.arange(self.send_perm.shape[0],
                           device=self.send_perm.device)
        return keep_mask(self.draws, ids), keep_mask(self.draws,
                                                     self.send_perm)

    def __iter__(self):
        return iter(self.masks())

    def __and__(self, other: "EdgeDraws") -> "EdgeDraws":
        return dataclasses.replace(self, draws=self.draws + other.draws)


def mask_pair(masks):
    """``(edge_mask, edge_mask_send)`` of a step's dropout: an
    :class:`EdgeDraws` travels whole as the first, with ``None``; a pair of
    masks (the sender one possibly ``None``) as given."""
    return (masks, None) if isinstance(masks, EdgeDraws) else tuple(masks)


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
