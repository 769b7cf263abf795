"""Model-parallel edge propagation: receiver-range sharding with kernel A
on each rank (counterpart of ``ragraph_tpu/parallel/edge_sharded.py``).

- Edges (receiver-sorted, as everywhere in the edge family) are split into
  per-rank RECEIVER RANGES, contiguous row blocks of the output, so each
  rank's segment sum is one local call of
  :func:`ragraph_tpu_torch.ops.csr_segment.gather_scale_segsum` (kernel A
  on the card). Shards are padded to the largest edge count with
  zero-weight edges on the shard's LAST local row (inert under the
  weighted sum); in sender order every padding edge comes from node 0.
  Either end may pass kernel A's 128-edge hub threshold, and then the walk
  cuts it into pieces like any long row.
- Per layer the node table is all-gathered over the axis (every rank needs
  arbitrary sender rows); the local CSR's senders index that full table,
  its receivers the rank's own rows.
- Gradients: kernel A's backward (the same kernel on the shard's
  sender-order arrays) gives each rank's partial cotangent of the full
  table, and the all-gather's backward sums the partials over the axis
  (:mod:`.collectives`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ragraph_tpu_torch.ops.csr_segment import (WalkPlan, gather_scale_segsum,
                                               walk_plan)
from ragraph_tpu_torch.parallel.collectives import all_gather
from ragraph_tpu_torch.parallel.mesh import axis_index, axis_size


@dataclasses.dataclass
class LocalShard:
    """One rank's receiver range on its device, with kernel A's walk plans
    of both orders, made once per shard and device."""

    senders: torch.Tensor        # (Ep,) global node ids
    recv_indptr: torch.Tensor    # (rows + 1,) local CSR bounds
    recv_of_send: torch.Tensor   # (Ep,) local receiver ids, sender-sorted
    send_indptr: torch.Tensor    # (N + 1,) CSR bounds in sender order
    weights: torch.Tensor        # (Ep,) static weights (0 = padding)
    weights_send: torch.Tensor
    edge_gid: torch.Tensor       # (Ep,) int64 positions in the global edges
    edge_gid_send: torch.Tensor
    valid: torch.Tensor          # (Ep,) bool
    valid_send: torch.Tensor
    recv_plan: WalkPlan
    send_plan: WalkPlan


@dataclasses.dataclass
class ShardedEdges:
    """Receiver-range-sharded edge arrays of every shard, on the host.

    Every field is ``(n_shards, E_pad)`` except ``recv_indptr`` (``(n_shards,
    rows_per_shard + 1)``, LOCAL row indices) and ``send_indptr``
    (``(n_shards, N + 1)``). Sender ids stay GLOBAL; ``recv_of_send`` is
    local. ``edge_gid`` / ``edge_gid_send`` give each slot's position in the
    caller's receiver-sorted edge arrays, with ``valid`` / ``valid_send``
    marking real edges, so per-step weights map onto the shards by one
    gather (:func:`sharded_propagate_per_step`).
    """

    senders: torch.Tensor
    recv_indptr: torch.Tensor
    weights: torch.Tensor
    recv_of_send: torch.Tensor
    send_indptr: torch.Tensor
    weights_send: torch.Tensor
    num_nodes: int
    rows_per_shard: int
    edges_per_shard: int
    edge_gid: torch.Tensor
    edge_gid_send: torch.Tensor
    valid: torch.Tensor
    valid_send: torch.Tensor
    _local: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def n_shards(self) -> int:
        return int(self.senders.shape[0])

    def local(self, shard: int, device: torch.device) -> LocalShard:
        """Shard ``shard``'s arrays on ``device``, with its walk plans;
        made on first use and kept."""
        key = (shard, str(device))
        if key not in self._local:
            def put(t, dtype=None):
                t = t[shard].contiguous()
                return t.to(device=device, dtype=dtype or t.dtype)
            rip, sip = put(self.recv_indptr), put(self.send_indptr)
            self._local[key] = LocalShard(
                senders=put(self.senders), recv_indptr=rip,
                recv_of_send=put(self.recv_of_send), send_indptr=sip,
                weights=put(self.weights),
                weights_send=put(self.weights_send),
                edge_gid=put(self.edge_gid, torch.int64),
                edge_gid_send=put(self.edge_gid_send, torch.int64),
                valid=put(self.valid), valid_send=put(self.valid_send),
                recv_plan=walk_plan(rip), send_plan=walk_plan(sip))
        return self._local[key]


def shard_edges_by_receiver(senders: np.ndarray, receivers: np.ndarray,
                            weights: np.ndarray, num_nodes: int,
                            n_shards: int) -> ShardedEdges:
    """Host-side prep: split receiver-sorted edges at row boundaries.

    ``num_nodes`` must divide by ``n_shards``. Pads each shard to the
    largest shard with zero-weight edges on the shard's LAST local row, so
    the receiver order stays sorted.
    """
    assert num_nodes % n_shards == 0
    rows = num_nodes // n_shards
    order = np.argsort(receivers, kind="stable")
    senders = np.asarray(senders)[order]
    receivers = np.asarray(receivers)[order]
    weights = np.asarray(weights)[order]

    bounds = np.searchsorted(receivers, np.arange(0, num_nodes + 1, rows))
    e_pad = max(int(np.diff(bounds).max()), 1)

    s_send = np.zeros((n_shards, e_pad), np.int32)
    s_w = np.zeros((n_shards, e_pad), np.float32)
    s_rip = np.zeros((n_shards, rows + 1), np.int32)
    s_ros = np.zeros((n_shards, e_pad), np.int32)
    s_sip = np.zeros((n_shards, num_nodes + 1), np.int32)
    s_ws = np.zeros((n_shards, e_pad), np.float32)
    s_gid = np.zeros((n_shards, e_pad), np.int32)
    s_gid_send = np.zeros((n_shards, e_pad), np.int32)
    s_valid = np.zeros((n_shards, e_pad), bool)
    s_valid_send = np.zeros((n_shards, e_pad), bool)
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        n_e = hi - lo
        snd = np.zeros(e_pad, np.int32)          # padding senders: node 0
        rcv_local = np.full(e_pad, rows - 1, np.int32)  # padding: last row
        w = np.zeros(e_pad, np.float32)          # padding weight 0
        gid = np.zeros(e_pad, np.int32)
        snd[:n_e] = senders[lo:hi]
        rcv_local[:n_e] = receivers[lo:hi] - s * rows
        w[:n_e] = weights[lo:hi]
        gid[:n_e] = order[lo:hi]
        s_rip[s, 1:] = np.cumsum(np.bincount(rcv_local, minlength=rows))
        perm = np.argsort(snd, kind="stable")
        valid = np.arange(e_pad) < n_e
        s_send[s] = snd
        s_w[s] = w
        s_ros[s] = rcv_local[perm]
        s_sip[s, 1:] = np.cumsum(np.bincount(snd, minlength=num_nodes))
        s_ws[s] = w[perm]
        s_gid[s] = gid
        s_gid_send[s] = gid[perm]
        s_valid[s] = valid
        s_valid_send[s] = valid[perm]
    t = torch.from_numpy
    return ShardedEdges(
        senders=t(s_send), recv_indptr=t(s_rip), weights=t(s_w),
        recv_of_send=t(s_ros), send_indptr=t(s_sip), weights_send=t(s_ws),
        num_nodes=num_nodes, rows_per_shard=rows, edges_per_shard=e_pad,
        edge_gid=t(s_gid), edge_gid_send=t(s_gid_send), valid=t(s_valid),
        valid_send=t(s_valid_send))


def sharded_lightgcn_propagate(mesh, emb: torch.Tensor, edges: ShardedEdges,
                               num_layers: int, axis_name: str = "idx",
                               bf16: bool = True,
                               weights: torch.Tensor | None = None,
                               weights_send: torch.Tensor | None = None):
    """LightGCN layers over ``axis_name``-sharded receiver ranges.

    ``emb`` is the full ``(N, D)`` table, replicated, or this rank's
    ``(N/D, D)`` block of it. Returns ``[h0, h1, ..., hL]``, each the full
    ``(N, D)`` layer, gathered over the axis and so replicated. Each rank
    computes its rows of every layer with kernel A on its shard.
    ``weights`` / ``weights_send`` override the shard's static weights with
    this step's ``(E_pad,)`` local ones; weights get no gradient.
    """
    if axis_size(mesh, axis_name) != edges.n_shards:
        raise ValueError(f"{edges.n_shards} edge shards on an '{axis_name}' "
                         f"axis of {axis_size(mesh, axis_name)}")
    sh = edges.local(axis_index(mesh, axis_name), emb.device)
    w = sh.weights if weights is None else weights
    ws = sh.weights_send if weights_send is None else weights_send
    full = emb if emb.shape[0] == edges.num_nodes else \
        all_gather(emb, mesh, axis_name)
    layers = [full]
    for _ in range(num_layers):
        local = gather_scale_segsum(
            layers[-1], w, ws, sh.senders, sh.recv_indptr, sh.recv_of_send,
            sh.send_indptr, bf16=bf16, recv_plan=sh.recv_plan,
            send_plan=sh.send_plan)
        layers.append(all_gather(local, mesh, axis_name))
    return layers


def sharded_propagate_per_step(mesh, emb: torch.Tensor, edges: ShardedEdges,
                               num_layers: int, w_global: torch.Tensor,
                               axis_name: str = "idx", bf16: bool = True):
    """Model-facing entry: this step's global receiver-order weights
    ``w_global (E,)`` (binorm x time fold x dropout mask) mapped onto the
    shard, and the node count padded to the shard-divisible
    ``edges.num_nodes`` with zero rows (no edges, so inert) and sliced
    back. ``emb`` is the full ``(N, D)`` table on every rank. Returns
    ``[h0 .. hL]``, each the full ``(N, D)`` layer."""
    sh = edges.local(axis_index(mesh, axis_name), emb.device)
    w_global = w_global.detach()
    w_sh = torch.where(sh.valid, w_global[sh.edge_gid], 0.0)
    ws_sh = torch.where(sh.valid_send, w_global[sh.edge_gid_send], 0.0)
    n = emb.shape[0]
    if n != edges.num_nodes:
        emb = torch.cat([emb, emb.new_zeros((edges.num_nodes - n,
                                             emb.shape[1]))])
    layers = sharded_lightgcn_propagate(
        mesh, emb, edges, num_layers, axis_name=axis_name, bf16=bf16,
        weights=w_sh, weights_send=ws_sh)
    return [h[:n] for h in layers]
