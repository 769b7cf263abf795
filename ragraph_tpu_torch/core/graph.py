"""Padded graph containers (counterpart of ``ragraph_tpu/core/graph.py``).

A graph batch is padded to a fixed node budget and carries an explicit node
mask; padding rows are all-zero in the normalized adjacency, which makes
them inert under message passing. The JAX package pads so that XLA compiles
once; the port keeps the layout so that both sides compute on the same
arrays.

The functions on adjacencies take any leading batch dimensions: ``(..., N,
N)`` with masks ``(..., N)``, which is how the library build runs all
graphs and copies of a batch at once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class DenseGraph:
    """A padded (batch of) graph(s) with a dense normalized adjacency.

    ``features (N, F)``, ``adj (N, N)`` = ``D^-1/2 (A + I) D^-1/2`` on the
    real nodes, ``node_mask (N,)`` bool, ``labels (N, C)`` one-hot,
    ``graph_ids (N,)`` int32 (padding nodes get ``num_graphs``),
    ``num_graphs`` a 0-d int32 tensor.
    """

    features: torch.Tensor
    adj: torch.Tensor
    node_mask: torch.Tensor
    labels: torch.Tensor
    graph_ids: torch.Tensor
    num_graphs: torch.Tensor

    def to(self, device) -> "DenseGraph":
        return DenseGraph(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})

    @property
    def num_nodes_padded(self) -> int:
        return self.features.shape[0]

    @property
    def feature_dim(self) -> int:
        return self.features.shape[1]

    @property
    def num_classes(self) -> int:
        return self.labels.shape[1]


@dataclasses.dataclass
class EdgeGraph:
    """A padded edge-list graph for segment-sum message passing:
    ``senders``, ``receivers`` ``(E,)`` int32, ``weights (E,)`` (zero on
    padding edges), ``edge_mask (E,)`` bool, and the static ``num_nodes``."""

    senders: torch.Tensor
    receivers: torch.Tensor
    weights: torch.Tensor
    edge_mask: torch.Tensor
    num_nodes: int

    def to(self, device) -> "EdgeGraph":
        return EdgeGraph(self.senders.to(device), self.receivers.to(device),
                         self.weights.to(device), self.edge_mask.to(device),
                         self.num_nodes)

    @property
    def num_edges_padded(self) -> int:
        return self.senders.shape[0]


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return ((x + m - 1) // m) * m


def normalize_adj_dense(adj: torch.Tensor,
                        node_mask: torch.Tensor | None = None,
                        add_self_loops: bool = True) -> torch.Tensor:
    """Symmetric normalization ``D^-1/2 (A [+ I]) D^-1/2`` of ``adj (..., N,
    N)``; padding rows and columns stay zero and get no self-loop."""
    if node_mask is None:
        node_mask = torch.ones(adj.shape[:-1], dtype=torch.bool,
                               device=adj.device)
    maskf = node_mask.to(adj.dtype)
    if add_self_loops:
        adj = adj + torch.diag_embed(maskf)
    adj = adj * maskf[..., :, None] * maskf[..., None, :]
    rowsum = adj.sum(dim=-1)
    d_inv_sqrt = torch.where(rowsum > 0,
                             torch.rsqrt(torch.clamp_min(rowsum, 1e-12)), 0.0)
    return adj * d_inv_sqrt[..., :, None] * d_inv_sqrt[..., None, :]


def row_normalize_adj(adj: torch.Tensor) -> torch.Tensor:
    """Row normalization ``D^-1 A``; zero-degree rows stay zero."""
    degree = adj.sum(dim=-1, keepdim=True)
    return torch.where(degree > 0, adj / torch.clamp_min(degree, 1e-12), 0.0)


def dense_batch_from_graphs(features_list, adj_list, labels_list,
                            pad_nodes: int, num_classes: int | None = None,
                            return_host_adj: bool = False,
                            device: str | torch.device = "cpu"):
    """Assemble a block-diagonal padded :class:`DenseGraph` on the host and
    put it on ``device``: per-graph features and labels stacked, raw
    adjacencies block-diagonalized into the fixed budget ``pad_nodes``,
    then the symmetric ``A + I`` normalization. With ``return_host_adj`` the
    raw numpy block-diagonal adjacency comes back too."""
    n_real = sum(f.shape[0] for f in features_list)
    if n_real > pad_nodes:
        raise ValueError(f"batch has {n_real} nodes > pad budget {pad_nodes}")
    fdim = features_list[0].shape[1]
    cdim = num_classes if num_classes is not None \
        else labels_list[0].shape[1]

    features = np.zeros((pad_nodes, fdim), dtype=np.float32)
    adj = np.zeros((pad_nodes, pad_nodes), dtype=np.float32)
    labels = np.zeros((pad_nodes, cdim), dtype=np.float32)
    graph_ids = np.full((pad_nodes,), len(features_list), dtype=np.int32)
    mask = np.zeros((pad_nodes,), dtype=bool)

    off = 0
    for gid, (f, a, y) in enumerate(zip(features_list, adj_list,
                                        labels_list)):
        n = f.shape[0]
        features[off:off + n] = f
        adj[off:off + n, off:off + n] = a
        labels[off:off + n, :y.shape[1]] = y
        graph_ids[off:off + n] = gid
        mask[off:off + n] = True
        off += n

    adj_t = torch.from_numpy(adj).to(device)
    mask_t = torch.from_numpy(mask).to(device)
    g = DenseGraph(
        features=torch.from_numpy(features).to(device),
        adj=normalize_adj_dense(adj_t, mask_t, add_self_loops=True),
        node_mask=mask_t,
        labels=torch.from_numpy(labels).to(device),
        graph_ids=torch.from_numpy(graph_ids).to(device),
        num_graphs=torch.tensor(len(features_list), dtype=torch.int32,
                                device=device))
    if return_host_adj:
        return g, adj
    return g


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Masked per-segment mean of the rows of ``data``."""
    if mask is not None:
        ones = mask.to(data.dtype)
        data = data * ones[:, None]
    else:
        ones = torch.ones(data.shape[0], dtype=data.dtype, device=data.device)
    ids = segment_ids.long()
    sums = torch.zeros((num_segments, data.shape[1]), dtype=data.dtype,
                       device=data.device).index_add_(0, ids, data)
    counts = torch.zeros(num_segments, dtype=data.dtype,
                         device=data.device).index_add_(0, ids, ones)
    return sums / torch.clamp_min(counts, 1.0)[:, None]
