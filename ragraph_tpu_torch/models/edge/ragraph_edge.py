"""The edge (recommendation) model family (counterpart of
``ragraph_tpu/models/edge/ragraph_edge.py``).

``TemporalLightGCN`` is the shared engine of ``LightGCNEdge``, ``GraphPro``
and ``RAGraphEdge``: a temporal LightGCN whose phases follow the reference
lifecycle (pretrain / for_tune / vanilla / finetune). ``RAGraphEdge`` adds
the retrieval library (:meth:`TemporalLightGCN.make_resource_graph`) and the
RAG fusion of its cosine top-k (:meth:`TemporalLightGCN._fuse_rag`).

Parameters are a plain dict with the JAX package's keys
(``user_embedding``, ``item_embedding``, ``gating_weight``, ``gating_bias``
as tensors, ``user_lora`` and ``item_lora`` as ``(A, B)`` pairs), so tables
trained by either package serve the other
(:func:`ragraph_tpu_torch.convert.params_from_jax`). The model is
functional as the JAX one is: :meth:`TemporalLightGCN.cal_loss` maps params
and a batch to a loss, and whoever trains makes the tensors leaves with
``requires_grad`` (:class:`ragraph_tpu_torch.train.trainer.EdgeTrainer`).
The model runs on the device of its graph arrays. Where the JAX package asks
"is the backend a TPU", this one asks "is the graph on CUDA": on the CPU
both pick the scatter reduction and f32.

Randomness comes from the ``torch.Generator`` a caller passes. The draws of
a training step live in small methods (``_draw_salt``, ``_noise_indices``)
and in ``nn/gating.py``, which a test can replace to feed both packages
the same numbers.

Multi-device (``mesh=`` with an ``idx`` axis over 1, the base models only):
the propagation runs per receiver range on each rank
(:mod:`ragraph_tpu_torch.parallel.edge_sharded`, kernel A on the shard) on a
graph that carries :meth:`EdgeGraphArrays.with_sharding`'s arrays; tables
given as this rank's row block (``EdgeTrainer`` places them so) are
all-gathered first, so every layer comes back whole and the loss, the RAG
fusion and ``generate`` read full tables as on one device; and the huge-k
fusion runs on the rank's rows of the library
(:func:`ragraph_tpu_torch.parallel.sharded_huge_k_fuse`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ragraph_tpu_torch.data.edgelist import EdgeDataset
from ragraph_tpu_torch.device import resolve_device
from ragraph_tpu_torch.models.edge.base import (EdgeDraws, EdgeModelConfig,
                                                bpr_loss, edge_drop_mask,
                                                lightgcn_propagate, mask_pair,
                                                reg_loss_emb,
                                                relative_time_encoding)
from ragraph_tpu_torch.nn.gating import learned_gate, random_gate
from ragraph_tpu_torch.nn.lora import LoRAFactors, apply_lora, svd_init
from ragraph_tpu_torch.ops.csr_segment import (WalkPlan, gather_scale_segsum,
                                               sorted_segment_sum_grad,
                                               walk_plan)
from ragraph_tpu_torch.ops.edge_weights import edge_weights
from ragraph_tpu_torch.ops.pagerank import inverse_sample_prob_edges
from ragraph_tpu_torch.ops.segment import scatter_sum
from ragraph_tpu_torch.ops.similarity import l2_normalize
from ragraph_tpu_torch.ops.selection import rowwise_kth_largest
from ragraph_tpu_torch.ops.topk import (cosine_topk, quantize_keys_i8,
                                        topk_gather)
from ragraph_tpu_torch.rag.augmentation import augment_features
from ragraph_tpu_torch.train.profiling import count, span

# _fuse_rag leaves the (chunk, k, E) index gather for the k-th-score
# threshold and a membership matmul when k * emb_size exceeds this, as in
# the JAX package. Module-level so that a test can make it small.
_BIG_K_ELEMS = 1 << 20

# Per-dataset RAG knobs (reference modules/RAGraph.py:33-85).
EDGE_DATASET_CONFIGS = {
    "amazon": dict(retrieve_weight=0.3,
                   vanilla=dict(rag_chunk=32768, retrieve_num=50,
                                num_augment_scale=0, inverse_frac=0.01),
                   finetune=dict(rag_chunk=4096, retrieve_num=10,
                                 noise_retrieve_num=1, num_augment_scale=0,
                                 num_inverse_sample=0)),
    "koubei": dict(retrieve_weight=0.3,
                   vanilla=dict(rag_chunk=512, retrieve_num=100000,
                                num_augment_scale=1, inverse_frac=0.01),
                   finetune=dict(rag_chunk=4096, retrieve_num=20,
                                 noise_retrieve_num=1, num_augment_scale=0,
                                 num_inverse_sample=0)),
    "taobao": dict(retrieve_weight=0.3,
                   vanilla=dict(rag_chunk=512, retrieve_num=100000,
                                num_augment_scale=1, inverse_frac=0.01),
                   finetune=dict(rag_chunk=4096, retrieve_num=20,
                                 noise_retrieve_num=1, num_augment_scale=0,
                                 num_inverse_sample=0)),
}

_TENSOR_FIELDS = ("senders", "receivers", "edge_norm", "edge_times",
                  "recv_indptr", "send_perm", "send_indptr", "recv_of_send",
                  "edge_norm_send", "time_norm", "time_norm_send")
_PLAN_FIELDS = ("recv_plan", "send_plan")


def _plan_to(plan: WalkPlan, device: torch.device) -> WalkPlan:
    return WalkPlan(*(t.to(device) for t in plan))


@dataclasses.dataclass
class EdgeGraphArrays:
    """The bidirectional interaction graph as tensors on one device.

    Receiver-sorted edges with CSR bounds, plus the sender-order arrays of
    the fused propagation's backward and the static per-destination time
    softmax, computed exactly in f64 on the host, and the walk plans of
    kernel A's forward and backward (``recv_plan`` of ``recv_indptr``,
    ``send_plan`` of ``send_indptr``), made once on the host.
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    edge_norm: torch.Tensor
    edge_times: torch.Tensor
    num_users: int
    num_items: int
    recv_indptr: torch.Tensor | None = None
    send_perm: torch.Tensor | None = None
    send_indptr: torch.Tensor | None = None
    recv_of_send: torch.Tensor | None = None
    edge_norm_send: torch.Tensor | None = None
    time_norm: torch.Tensor | None = None
    time_norm_send: torch.Tensor | None = None
    recv_plan: WalkPlan | None = None
    send_plan: WalkPlan | None = None
    # receiver-range shards for the multi-device propagation
    # (parallel.edge_sharded.ShardedEdges, on the host); see with_sharding
    sharded: Any = None

    @classmethod
    def from_dataset(cls, ds: EdgeDataset,
                     device: str | torch.device = "cuda") -> "EdgeGraphArrays":
        dev = resolve_device(device)
        send = np.asarray(ds.senders)
        recv = np.asarray(ds.receivers)
        norm = np.asarray(ds.edge_norm)
        n_nodes = ds.num_users + ds.num_items
        perm = np.argsort(send, kind="stable").astype(np.int32)
        sip = np.zeros(n_nodes + 1, np.int32)
        sip[1:] = np.cumsum(np.bincount(send, minlength=n_nodes))

        # static time softmax over the full graph, exact in f64; zero-weight
        # padding edges are left out
        t = np.asarray(ds.edge_times_bi, np.float64)
        realm = norm > 0
        tr = t[realm] if realm.any() else t
        tmin = tr.min() if tr.size else 0.0
        span = max((tr.max() - tmin), 1e-12) if tr.size else 1.0
        e = np.where(realm, np.exp((t - tmin) / span), 0.0)
        denom = np.bincount(recv, weights=e, minlength=n_nodes)
        tn = np.where(realm, e / np.maximum(denom[recv], 1e-300),
                      0.0).astype(np.float32)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        def plan(ip):
            return _plan_to(walk_plan(torch.from_numpy(np.ascontiguousarray(ip))),
                            dev)

        indptr = getattr(ds, "recv_indptr", None)
        return cls(senders=put(send), receivers=put(recv),
                   edge_norm=put(norm), edge_times=put(ds.edge_times_bi),
                   num_users=ds.num_users, num_items=ds.num_items,
                   recv_indptr=put(indptr) if indptr is not None else None,
                   recv_plan=plan(indptr) if indptr is not None else None,
                   send_perm=put(perm), send_indptr=put(sip),
                   send_plan=plan(sip),
                   recv_of_send=put(recv[perm].astype(np.int32)),
                   edge_norm_send=put(norm[perm]),
                   time_norm=put(tn), time_norm_send=put(tn[perm]))

    def to(self, device: str | torch.device) -> "EdgeGraphArrays":
        dev = resolve_device(device)
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(dev) for f in _TENSOR_FIELDS
            if getattr(self, f) is not None}, **{
            f: _plan_to(getattr(self, f), dev) for f in _PLAN_FIELDS
            if getattr(self, f) is not None})

    def with_sharding(self, n_shards: int) -> "EdgeGraphArrays":
        """Attach receiver-range shards for the multi-device propagation.
        The node count is padded up to a multiple of ``n_shards`` inside
        them (``sharded.num_nodes``); the propagation pads the table with
        zero rows, which have no edges, and slices them off."""
        from ragraph_tpu_torch.parallel.edge_sharded import (
            shard_edges_by_receiver)
        n_pad = -(-self.num_nodes // n_shards) * n_shards
        sh = shard_edges_by_receiver(
            self.senders.cpu().numpy(), self.receivers.cpu().numpy(),
            self.edge_norm.cpu().numpy(), n_pad, n_shards)
        return dataclasses.replace(self, sharded=sh)

    @property
    def device(self) -> torch.device:
        return self.senders.device

    @property
    def num_nodes(self) -> int:
        return self.num_users + self.num_items

    @property
    def num_edges(self) -> int:
        return int(self.senders.shape[0])


def xavier(shape: tuple, generator: torch.Generator,
            device: torch.device) -> torch.Tensor:
    """Glorot-uniform init (fan-in ``shape[-2]``, fan-out ``shape[-1]``)."""
    bound = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    u = torch.rand(shape, generator=generator, device=device)
    return (2.0 * u - 1.0) * bound


class TemporalLightGCN:
    """Shared engine for LightGCN / GraphPro / RAGraph-edge.

    Flags: ``use_time`` (GraphPro/RAGraph), ``use_rag`` and with it
    ``cfg.use_lora`` (RAGraph only). ``phase`` follows the reference
    lifecycle.
    """

    use_time: bool = True
    use_rag: bool = False
    # the loss is a mean of per-row terms of the batch, so a data-parallel
    # rank may train on its share of the rows (EdgeTrainer); models whose
    # loss couples the batch's rows (in-batch contrastive views, per-row
    # draws) set False and every rank takes the whole batch
    rows_independent: bool = True

    def __init__(self, cfg: EdgeModelConfig, graph: EdgeGraphArrays,
                 phase: str = "pretrain", mesh=None):
        from ragraph_tpu_torch.parallel.mesh import axis_size
        if axis_size(mesh, "idx") > 1 and type(self) not in _SHARDABLE:
            raise ValueError(
                f"{type(self).__name__}: tables shard over idx only in the "
                f"base models (LightGCNEdge, GraphPro, RAGraphEdge); give "
                f"it a mesh with idx=1")
        self.cfg = cfg
        self.graph = graph
        self.phase = phase
        self.mesh = mesh             # multi-device: sharded propagation
        self.resource_keys = None    # (R, E) library, not parameters
        self.resource_values = None

    def _segsum_impl(self, graph: EdgeGraphArrays | None = None) -> str:
        """Pick the propagation backend, by the JAX package's rule with
        "on a TPU" read as "on CUDA"."""
        g = self.graph if graph is None else graph
        want = self.cfg.segsum_impl
        on_cuda = g.device.type == "cuda"
        have_sorted = g.recv_indptr is not None
        have_fused = (have_sorted and g.send_indptr is not None
                      and g.recv_of_send is not None
                      and g.edge_norm_send is not None)
        if want == "fused" and have_fused:
            return "fused"
        if want == "auto" and on_cuda and have_fused:
            return "fused"
        if want in ("sorted", "fused") and on_cuda and have_sorted:
            return "sorted"
        if want == "auto" and on_cuda and have_sorted:
            return "sorted"
        return "scatter"

    def _bf16(self) -> bool:
        d = self.cfg.propagate_dtype
        return d == "bf16" or (d == "auto"
                               and self.graph.device.type == "cuda")

    def _edge_weights(self, g, edge_mask, edge_mask_send,
                      time_scale: float = 1.0, max_time_step=None):
        """Per-edge weights in receiver order (and in sender order when the
        fused path applies). Returns ``(weights, w_send, impl)``.

        Static time mode folds in the precomputed time softmax; otherwise
        the softmax is recomputed over the live edges, which exists only in
        receiver order and so leaves the fused backend. ``edge_mask`` may
        be a step's :class:`EdgeDraws`: on CUDA, with the static fold or no
        time, one launch of ``rg_edge_weights`` hashes and weights both
        orders (counter ``edge_weights.fused_edges`` adds the edges it
        weighs, per order); elsewhere the draws become bool masks first.
        """
        cfg = self.cfg
        impl = self._segsum_impl(g)
        static_time = (cfg.time_mode == "static"
                       and g.time_norm is not None
                       and max_time_step is None)
        if isinstance(edge_mask, EdgeDraws):
            if g.device.type == "cuda" and (static_time or not self.use_time):
                return (*self._drawn_weights(g, edge_mask, impl, time_scale),
                        impl)
            edge_mask, edge_mask_send = edge_mask.masks()
        downgrade = ("sorted" if g.device.type == "cuda"
                     and g.recv_indptr is not None else "scatter")
        if impl == "fused" and (edge_mask is not None
                                and edge_mask_send is None):
            impl = downgrade
        if impl == "fused" and self.use_time and not static_time:
            impl = downgrade

        weights = g.edge_norm
        w_send = g.edge_norm_send if impl == "fused" else None
        if self.use_time and static_time:
            weights = weights * 0.5 + g.time_norm * (0.5 * time_scale)
            if impl == "fused":
                w_send = w_send * 0.5 + g.time_norm_send * (0.5 * time_scale)
            if edge_mask is not None:
                weights = torch.where(edge_mask, weights, 0.0)
                if impl == "fused":
                    w_send = torch.where(edge_mask_send, w_send, 0.0)
        else:
            if edge_mask is not None:
                weights = torch.where(edge_mask, weights, 0.0)
                if impl == "fused":
                    w_send = torch.where(edge_mask_send, w_send, 0.0)
            if self.use_time:
                # zero-weight padding edges get no softmax mass
                pad_valid = g.edge_norm > 0
                tmask = (pad_valid if edge_mask is None
                         else pad_valid & edge_mask)
                tn = relative_time_encoding(
                    g.edge_times, g.receivers, g.num_nodes,
                    edge_mask=tmask, max_step=max_time_step)
                weights = weights * 0.5 + tn * 0.5
        return weights, w_send, impl

    def _drawn_weights(self, g, draws: EdgeDraws, impl: str,
                       time_scale: float):
        """``(weights, w_send)`` of a step's draws in one kernel launch,
        the static time fold in where the model uses time, the sender order
        where ``impl`` is ``"fused"``."""
        fold = self.use_time
        send = impl == "fused"
        out = edge_weights(
            draws.draws, g.edge_norm, g.time_norm if fold else None,
            0.5 * time_scale if fold else None,
            send_perm=g.send_perm if send else None,
            edge_norm_send=g.edge_norm_send if send else None,
            time_norm_send=g.time_norm_send if fold and send else None)
        count("edge_weights.fused_edges", g.num_edges * (2 if send else 1))
        return out

    @staticmethod
    def _draw_salt(generator: torch.Generator) -> torch.Tensor:
        """The step's dropout salt: a 0-d int64 tensor in ``[0, 2**32)`` on
        the generator's device, never read on the host."""
        return torch.randint(0, 1 << 32, (), generator=generator,
                             device=generator.device)

    def _drop_masks(self, generator, g, keep_rate: float):
        """The step's edge dropout. Where the sender arrays exist, an
        :class:`EdgeDraws` of one salt from ``generator`` (none at a keep
        rate of 1), whose hash gives the same mask in both orders and keeps
        the fused propagation usable; unpacked it is the ``(receiver order,
        sender order)`` pair of bool masks. Else a Bernoulli mask in
        receiver order and ``None``."""
        if g.send_perm is not None:
            draws = (() if keep_rate >= 1.0
                     else ((self._draw_salt(generator), keep_rate),))
            return EdgeDraws(draws, g.send_perm)
        return edge_drop_mask(generator, g.num_edges, keep_rate,
                              g.device), None

    def _prop_layer(self, g, h, weights, w_send, impl):
        """One propagation layer under the chosen backend, the building
        block of the per-layer loops of the plugin and dynamic models:
        ``"fused"`` is kernel A with the graph's walk plans, ``"sorted"``
        gathers and scales the rows and sums them with kernel B,
        ``"scatter"`` is ``index_add_``."""
        if impl == "fused":
            return gather_scale_segsum(
                h, weights, w_send, g.senders, g.recv_indptr,
                g.recv_of_send, g.send_indptr, bf16=self._bf16(),
                recv_plan=g.recv_plan, send_plan=g.send_plan)
        msgs = h[g.senders.long()] * weights[:, None]
        if impl == "sorted":
            return sorted_segment_sum_grad(msgs, g.recv_indptr, g.receivers)
        return scatter_sum(msgs, g.receivers, g.num_nodes)

    def _idx(self) -> int:
        from ragraph_tpu_torch.parallel.mesh import axis_size
        return axis_size(self.mesh, "idx")

    def _use_sharded(self, g) -> bool:
        """The multi-device propagation applies when a mesh with an
        ``idx`` axis over 1 is set and the graph carries shards."""
        return self._idx() > 1 and getattr(g, "sharded", None) is not None

    def _propagate_layers(self, g, all_emb, weights, w_send, impl):
        """The full layer stack under the chosen backend; with
        :meth:`_use_sharded` the receiver-range path, whose per-step
        receiver-order ``weights`` carry the dropout and time folds onto
        the shards (``w_send`` is derived there from the same vector)."""
        if self._use_sharded(g):
            from ragraph_tpu_torch.parallel.edge_sharded import (
                sharded_propagate_per_step)
            return sharded_propagate_per_step(
                self.mesh, all_emb, g.sharded, self.cfg.num_layers,
                weights, bf16=self._bf16())
        return lightgcn_propagate(all_emb, g.senders, g.receivers, weights,
                                  g.num_nodes, self.cfg.num_layers,
                                  recv_indptr=g.recv_indptr, impl=impl,
                                  weights_send=w_send,
                                  recv_of_send=g.recv_of_send,
                                  send_indptr=g.send_indptr,
                                  bf16=self._bf16(), recv_plan=g.recv_plan,
                                  send_plan=g.send_plan)

    # -- params ------------------------------------------------------------

    def init_params(self, generator: torch.Generator,
                    pretrained_tables: tuple | None = None) -> dict:
        """Fresh tables (pretrain / for_tune, or without pretrained ones)
        and, in the finetune phase, the gate, drawn from ``generator`` on
        the graph's device."""
        g, cfg = self.graph, self.cfg
        dev = g.device
        params: dict[str, Any] = {}
        if self.phase in ("pretrain", "for_tune") or pretrained_tables is None:
            params["user_embedding"] = xavier((g.num_users, cfg.emb_size),
                                               generator, dev)
            params["item_embedding"] = xavier((g.num_items, cfg.emb_size),
                                               generator, dev)
        else:
            params["user_embedding"], params["item_embedding"] = \
                pretrained_tables
        if self.phase == "finetune":
            params["gating_weight"] = xavier((cfg.emb_size, cfg.emb_size),
                                              generator, dev)
            params["gating_bias"] = xavier((1, cfg.emb_size), generator, dev)
            if self._lora():
                params["user_lora"] = svd_init(params["user_embedding"],
                                               cfg.lora_rank,
                                               cfg.lora_init_scale)
                params["item_lora"] = svd_init(params["item_embedding"],
                                               cfg.lora_rank,
                                               cfg.lora_init_scale)
        return params

    # -- forward -----------------------------------------------------------

    def _lora(self) -> bool:
        return (self.phase == "finetune" and self.use_rag
                and self.cfg.use_lora)

    def _tables(self, params):
        """The two tables whole: a table given as this rank's row block of
        an ``idx``-sharded one (fewer rows than the graph's count) is
        all-gathered over ``idx``, differentiably."""
        u, it = params["user_embedding"], params["item_embedding"]
        if self._idx() > 1:
            from ragraph_tpu_torch.parallel.collectives import all_gather
            g = self.graph
            if u.shape[0] != g.num_users:
                u = all_gather(u, self.mesh, "idx")[: g.num_users]
            if it.shape[0] != g.num_items:
                it = all_gather(it, self.mesh, "idx")[: g.num_items]
        return u, it

    def _effective_tables(self, params, generator, training: bool):
        """The base tables plus the LoRA delta. With
        ``lora_train_factors=False`` the factors are detached: the delta is
        a constant bias, and a trainer leaves the factors out of its
        optimizer (Adam on a zero gradient changes nothing)."""
        u, it = self._tables(params)
        if self._lora():
            cfg = self.cfg
            drop_gen = (generator if training and cfg.emb_dropout > 0
                        else None)
            u_f = LoRAFactors(*params["user_lora"])
            i_f = LoRAFactors(*params["item_lora"])
            if not cfg.lora_train_factors:
                u_f = LoRAFactors(*(t.detach() for t in u_f))
                i_f = LoRAFactors(*(t.detach() for t in i_f))
            u = apply_lora(u, u_f, cfg.emb_dropout, drop_gen)
            it = apply_lora(it, i_f, cfg.emb_dropout, drop_gen)
        return u, it

    def _gate(self, params, all_emb, generator, training: bool = False):
        if self.phase == "finetune":
            drop_gen = (generator if training and self.cfg.emb_dropout > 0
                        else None)
            return learned_gate(all_emb, params["gating_weight"],
                                params["gating_bias"],
                                self.cfg.emb_dropout, drop_gen)
        if self.phase == "for_tune":
            if generator is None:
                generator = torch.Generator(all_emb.device).manual_seed(0)
            return random_gate(all_emb, generator)
        return all_emb

    def forward(self, params, *, generator: torch.Generator | None = None,
                training: bool = False, edge_mask=None, edge_mask_send=None,
                time_scale: float = 1.0, max_time_step=None, graph=None,
                resources=None):
        """Returns ``(user_emb, item_emb)``.

        ``graph`` / ``resources`` override the instance's graph and
        library; ``edge_mask_send`` is the keep mask in sender order, which
        keeps the fused propagation usable under a mask; ``time_scale``
        rescales the static time softmax under dropout (1 / keep rate).
        ``training`` turns on the embedding dropout and the noise mode of
        the RAG fusion, both drawing from ``generator``.
        """
        g = self.graph if graph is None else graph
        with span("edge_weights"):
            weights, w_send, impl = self._edge_weights(
                g, edge_mask, edge_mask_send, time_scale=time_scale,
                max_time_step=max_time_step)
        u, it = self._effective_tables(params, generator, training)
        all_emb = self._gate(params, torch.cat([u, it], dim=0), generator,
                             training)

        with span("propagate"):
            layers = self._propagate_layers(g, all_emb, weights, w_send,
                                            impl)
        res_emb = sum(layers)

        res_src = (resources if resources is not None
                   else (self.resource_keys, self.resource_values))
        if self.use_rag and self.phase in ("vanilla", "finetune") \
                and res_src[0] is not None:
            res_emb = self._fuse_rag(layers[0], res_emb, generator, training,
                                     resources=res_src)
        return res_emb[: g.num_users], res_emb[g.num_users:]

    @staticmethod
    def _noise_indices(generator, n_rows: int, n_noise: int,
                       n_resources: int, device) -> torch.Tensor:
        """``(n_rows, n_noise)`` uniform library rows for the noise mode."""
        if generator is None:
            raise ValueError("the noise mode draws from a generator; pass "
                             "one")
        return torch.randint(0, n_resources, (n_rows, n_noise),
                             generator=generator, device=device)

    def _fuse_rag(self, query_emb, res_emb, generator=None,
                  training: bool = False, resources=None):
        """Cosine top-k over the library and the weighted fusion of the
        retrieved values' mean, chunked over the queries at ``rag_chunk``
        (else ``batch_size``) so no ``(N, R)`` score matrix exists.

        Two strategies. Small ``k``: the top-k indices of all queries in
        one ``cosine_topk`` call (kernel C takes them in one launch; a path
        that builds scores passes over them by chunk), then per chunk a
        ``(chunk, k, E)`` gather and its mean. Huge ``k`` (koubei/taobao
        vanilla, ``retrieve_num=100000``), where the index tensor and its
        gather would not fit: the k-th score of each row is the threshold,
        membership is ``scores >= kth``, and the mean is a ``(chunk, R)``
        0/1 matrix times the values over the member count. The two agree
        up to exact score ties at the k-th boundary.

        The retrieval yields indices (or a 0/1 membership) and the library
        is a buffer, so the retrieved mean carries no gradient: it is
        computed without autograd on detached queries, and the only
        gradient path of the result is ``(1 - retrieve_weight) * res_emb``.

        Noise mode (``use_noise`` while training in the finetune phase):
        the retrieval widens to ``retrieve_num + noise_retrieve_num`` and
        ``noise_retrieve_num`` uniformly drawn library rows join every
        retrieved set, as the reference's noise protocol does.
        """
        cfg = self.cfg
        add_noise = cfg.use_noise and training and self.phase == "finetune"
        with span("retrieve"), torch.no_grad():
            rag_emb = self._retrieved_mean(query_emb.detach(), add_noise,
                                           generator, resources)
        return (1.0 - cfg.retrieve_weight) * res_emb \
            + cfg.retrieve_weight * rag_emb

    def _retrieved_mean(self, query_emb, add_noise, generator, resources):
        cfg = self.cfg
        res_keys, res_values = (resources if resources is not None
                                else (self.resource_keys,
                                      self.resource_values))
        k = cfg.retrieve_num + (cfg.noise_retrieve_num if add_noise else 0)
        k = min(k, res_keys.shape[0])
        qn, e = query_emb.shape
        chunk = min(cfg.rag_chunk or cfg.batch_size, qn)
        keys_n = l2_normalize(res_keys)
        big_k = k * e > _BIG_K_ELEMS
        # per-library work happens once, outside the chunk loop: the bf16
        # cast of the selection tier and the int8 quantization
        if big_k and cfg.selection_dtype == "bf16":
            keys_n = keys_n.to(torch.bfloat16)
        elif cfg.retrieve_dtype == "int8" and not big_k:
            keys_n = quantize_keys_i8(keys_n, normalized=True)
        # multi-device: the huge-k branch runs on this rank's rows of the
        # library whenever the row count divides the idx axis
        n_idx = self._idx()
        shard_fuse = big_k and n_idx > 1 and res_keys.shape[0] % n_idx == 0
        if shard_fuse:
            from ragraph_tpu_torch.parallel.mesh import axis_index
            from ragraph_tpu_torch.parallel.sharded_selection import (
                sharded_huge_k_fuse)
            rows = res_keys.shape[0] // n_idx
            lo = axis_index(self.mesh, "idx") * rows
            keys_loc = keys_n[lo:lo + rows]
            values_loc = res_values[lo:lo + rows]
        means, counts = [], []
        if not big_k:
            # one retrieval over every query (kernel C takes them in one
            # launch; the score-matrix paths pass over them by chunk), then
            # the (chunk, k, E) gathers
            _, idx = cosine_topk(query_emb, keys_n, k, keys_normalized=True,
                                 score_dtype=cfg.retrieve_dtype, chunk=chunk)
            means = [topk_gather(res_values, idx[s:s + chunk]).mean(dim=1)
                     for s in range(0, qn, chunk)]
        else:
            for s in range(0, qn, chunk):
                qc = query_emb[s:s + chunk]
                if shard_fuse:
                    mean, count = sharded_huge_k_fuse(self.mesh, qc, keys_loc,
                                                      values_loc, k)
                    means.append(mean)
                    counts.append(count[:, None])
                    continue
                # bf16 keys give bf16 scores and the 16-bit selection
                scores = l2_normalize(qc).to(keys_n.dtype) @ keys_n.T
                member = scores >= rowwise_kth_largest(scores, k)
                count = member.sum(dim=1, keepdim=True)
                total = member.to(res_values.dtype) @ res_values
                means.append(total.float() / count.clamp(min=1))
                counts.append(count)
        rag_emb = torch.cat(means, dim=0)
        if add_noise:
            # the mean over [top-k, noise rows] as a count-weighted blend
            nk = cfg.noise_retrieve_num
            noise_idx = self._noise_indices(generator, qn, nk,
                                            res_values.shape[0],
                                            rag_emb.device)
            noise_sum = topk_gather(res_values, noise_idx).sum(dim=1)
            c = (torch.cat(counts, dim=0).to(rag_emb.dtype) if counts
                 else float(k))
            rag_emb = (rag_emb * c + noise_sum) / (c + nk)
        return rag_emb

    # -- resource graph (library) ------------------------------------------

    def make_resource_graph(self, pretrained_user_emb, pretrained_item_emb,
                            generator: torch.Generator | None = None,
                            graph=None):
        """Build the retrieval library from pretrained embeddings: keys are
        the last propagation layer, values the sum of the even layers;
        optional inverse-importance sampling and feature augmentation draw
        from ``generator``. Sets the instance library and returns
        ``(keys, values)``."""
        g = self.graph if graph is None else graph
        cfg = self.cfg
        if generator is None and (cfg.num_augment_scale > 0
                                  or cfg.num_inverse_sample > 0):
            raise ValueError("augmentation and inverse sampling draw from "
                             "a generator; pass one")
        all_emb = torch.cat([pretrained_user_emb, pretrained_item_emb], dim=0)
        layers = self._propagate_layers(g, all_emb, g.edge_norm, None,
                                        self._segsum_impl(g))
        keys_base = layers[-1]
        values_base = sum(layers[0::2])

        sample_prob = inverse_sample_prob_edges(
            g.senders, g.receivers, g.edge_norm, g.num_nodes)

        all_keys, all_values = [], []
        for i in range(1 + cfg.num_augment_scale):
            if i > 0:
                aug_keys = augment_features(generator, keys_base, sample_prob)
                aug_values = augment_features(generator, values_base,
                                              sample_prob)
            else:
                aug_keys, aug_values = keys_base, values_base
            if cfg.num_inverse_sample > 0:
                idx = torch.multinomial(sample_prob, cfg.num_inverse_sample,
                                        replacement=True, generator=generator)
                aug_keys = aug_keys[idx]
                aug_values = aug_values[idx]
            all_keys.append(aug_keys)
            all_values.append(aug_values)

        self.resource_keys = torch.cat(all_keys, dim=0)
        self.resource_values = torch.cat(all_values, dim=0)
        return self.resource_keys, self.resource_values

    # -- loss --------------------------------------------------------------

    def cal_loss(self, params, batch, generator, graph=None, resources=None,
                 edge_masks=None):
        """BPR plus weight-decay L2 of one ``(users, pos_items, neg_items)``
        batch of index tensors; returns ``(loss, {"rec_loss", "reg_loss"})``.

        The step's edge dropout comes from :meth:`_drop_masks` unless
        ``edge_masks`` gives the ``(receiver order, sender order)`` pair.
        """
        g = self.graph if graph is None else graph
        users, pos_items, neg_items = (t.long() for t in batch)
        keep = 1.0 - self.cfg.edge_dropout
        if edge_masks is None:
            with span("edge_weights"):
                edge_masks = self._drop_masks(generator, g, keep)
        mask, mask_send = mask_pair(edge_masks)
        user_emb, item_emb = self.forward(
            params, generator=generator, training=True, edge_mask=mask,
            edge_mask_send=mask_send, time_scale=1.0 / keep, graph=g,
            resources=resources)
        with span("loss"):
            rec = bpr_loss(user_emb[users], item_emb[pos_items],
                           item_emb[neg_items])
            u_t, i_t = self._effective_tables(params, None, False)
            reg = self.cfg.weight_decay * reg_loss_emb(u_t, i_t, users,
                                                       pos_items, neg_items)
        return rec + reg, {"rec_loss": rec, "reg_loss": reg}

    # -- serving -----------------------------------------------------------

    @torch.no_grad()
    def generate(self, params, generator: torch.Generator | None = None,
                 max_time_step=None, graph=None, resources=None):
        """Full-graph embeddings, no dropout."""
        with span("generate"):
            return self.forward(params, generator=generator, training=False,
                                max_time_step=max_time_step, graph=graph,
                                resources=resources)

    @staticmethod
    def rating(user_emb, item_emb):
        return user_emb.float() @ item_emb.float().T

    @staticmethod
    @torch.no_grad()
    def recommend_from(user_emb: torch.Tensor, item_emb: torch.Tensor,
                       user_ids: torch.Tensor, k: int = 20,
                       hist_rows: torch.Tensor | None = None,
                       hist_cols: torch.Tensor | None = None,
                       hist_pad: int | None = None):
        """Per-request serving from precomputed embeddings: score, mask the
        user's history, take the top-k. Returns ``(scores, items)``.

        ``hist_rows/hist_cols`` index (batch row, item) pairs to exclude;
        out-of-range entries are ignored. With the default
        ``hist_pad=None`` history is masked to ``-1e8`` in the full score
        matrix; a positive ``hist_pad`` takes the top ``k + hist_pad``
        candidates first, drops history among them and re-takes the top
        ``k``. The top-k is exact at every catalog size (the TPU's
        approximate top-k above 32k items has no GPU counterpart).
        """
        scores = user_emb[user_ids.long()].float() @ item_emb.float().T
        if hist_rows is None:
            return torch.topk(scores, k, dim=1)
        rows, cols = hist_rows.long(), hist_cols.long()
        b, n_items = scores.shape
        if not hist_pad:
            ok = (rows >= 0) & (rows < b) & (cols >= 0) & (cols < n_items)
            scores[rows[ok], cols[ok]] = -1e8
            return torch.topk(scores, k, dim=1)
        s, idx = torch.topk(scores, k + hist_pad, dim=1)
        r = rows.clamp(0, b - 1)
        seen = (idx[r] == cols[:, None]) & (rows[:, None] < b)
        bad = torch.zeros(idx.shape, dtype=torch.int32, device=idx.device)
        bad = bad.index_add_(0, r, seen.int()) > 0
        s = torch.where(bad, -1e8, s)
        s2, pos = torch.topk(s, k, dim=1)
        return s2, torch.gather(idx, 1, pos)

    def recommend(self, params, user_ids: torch.Tensor, k: int = 20,
                  hist_rows: torch.Tensor | None = None,
                  hist_cols: torch.Tensor | None = None,
                  generator: torch.Generator | None = None):
        """One-shot serving: full :meth:`generate`, then
        :meth:`recommend_from`."""
        user_emb, item_emb = self.generate(params, generator=generator)
        return self.recommend_from(user_emb, item_emb, user_ids, k=k,
                                   hist_rows=hist_rows, hist_cols=hist_cols)


class LightGCNEdge(TemporalLightGCN):
    """Plain LightGCN (no time encoding, no gate, no RAG)."""

    use_time = False
    use_rag = False

    def _gate(self, params, all_emb, generator, training: bool = False):
        return all_emb


class GraphPro(TemporalLightGCN):
    """Temporal LightGCN with gating (the pretrain backbone)."""

    use_time = True
    use_rag = False


class RAGraphEdge(TemporalLightGCN):
    """The RAG recommender."""

    use_time = True
    use_rag = True


# the classes whose tables may shard over idx
_SHARDABLE = (TemporalLightGCN, LightGCNEdge, GraphPro, RAGraphEdge)


def edge_config_for(dataset_name: str, phase: str,
                    num_nodes: int | None = None,
                    **overrides) -> EdgeModelConfig:
    """Materialise the per-dataset knob table into a typed config."""
    base = EDGE_DATASET_CONFIGS.get(dataset_name)
    kwargs: dict[str, Any] = {}
    if base is not None:
        kwargs["retrieve_weight"] = base["retrieve_weight"]
        sub = base["vanilla"] if phase == "vanilla" else base["finetune"]
        for k, v in sub.items():
            if k == "inverse_frac":
                if num_nodes is not None:
                    kwargs["num_inverse_sample"] = round(v * num_nodes)
            else:
                kwargs[k] = v
    kwargs.update(overrides)
    return EdgeModelConfig(**kwargs)
