"""Host-side batch assembly: ragged graphs -> padded tensors on a device
(counterpart of ``ragraph_tpu/data/batching.py``).

- :func:`flat_batches`: one block-diagonal :class:`DenseGraph` per batch,
  the training and evaluation layout.
- :func:`stacked_batches`: ``(B, N_pad, ...)`` per-graph tensors for the
  batched library build (:func:`ragraph_tpu_torch.rag.library.build_entries_batch`).
"""

from __future__ import annotations

import numpy as np
import torch

from ragraph_tpu_torch.core.graph import (dense_batch_from_graphs,
                                          normalize_adj_dense, round_up)


def _chunks(graphs, batch_size: int):
    return [graphs[i:i + batch_size]
            for i in range(0, len(graphs), batch_size)]


def compute_pad_nodes(graphs, batch_size: int, align: int = 128) -> int:
    """The node budget that covers the largest batch, rounded up."""
    worst = max(sum(g.features.shape[0] for g in c)
                for c in _chunks(graphs, batch_size))
    return round_up(worst, align)


def flat_batches(graphs, batch_size: int, pad_nodes: int | None = None,
                 num_classes: int | None = None,
                 with_host_adj: bool = False,
                 device: str | torch.device = "cpu"):
    """Yield block-diagonal padded :class:`DenseGraph` batches on ``device``.
    ``pad_nodes`` defaults to one budget for all batches (the largest batch
    rounded up to 128). ``with_host_adj`` yields ``(graph, raw numpy
    block-diagonal adjacency)`` pairs."""
    if pad_nodes is None:
        pad_nodes = compute_pad_nodes(graphs, batch_size)
    for chunk in _chunks(graphs, batch_size):
        yield dense_batch_from_graphs(
            [g.features for g in chunk], [g.adj for g in chunk],
            [g.node_labels for g in chunk], pad_nodes=pad_nodes,
            num_classes=num_classes, return_host_adj=with_host_adj,
            device=device)


def stacked_batches(graphs, batch_size: int, pad_nodes: int | None = None,
                    num_classes: int | None = None,
                    num_graph_classes: int | None = None,
                    device: str | torch.device = "cpu"):
    """Yield dicts of stacked per-graph tensors on ``device``: ``features
    (B,N,F)``, ``adj (B,N,N)`` (normalized per graph), ``labels (B,N,C)``,
    ``node_mask (B,N)``, ``graph_onehot (B,Cg)``. The last short batch is
    padded with empty graphs (all-False masks) so that ``B`` is constant."""
    if pad_nodes is None:
        worst = max(g.features.shape[0] for g in graphs)
        pad_nodes = round_up(max(worst, 8), 8)
    fdim = graphs[0].features.shape[1]
    cdim = num_classes if num_classes is not None \
        else graphs[0].node_labels.shape[1]
    cg = num_graph_classes if num_graph_classes is not None else cdim

    for chunk in _chunks(graphs, batch_size):
        b = batch_size
        features = np.zeros((b, pad_nodes, fdim), np.float32)
        adj = np.zeros((b, pad_nodes, pad_nodes), np.float32)
        labels = np.zeros((b, pad_nodes, cdim), np.float32)
        mask = np.zeros((b, pad_nodes), bool)
        graph_onehot = np.zeros((b, cg), np.float32)
        for j, g in enumerate(chunk):
            n = g.features.shape[0]
            features[j, :n] = g.features
            adj[j, :n, :n] = g.adj
            labels[j, :n, :g.node_labels.shape[1]] = g.node_labels
            mask[j, :n] = True
            graph_onehot[j, g.graph_label] = 1.0
        mask_t = torch.from_numpy(mask).to(device)
        yield {
            "features": torch.from_numpy(features).to(device),
            "adj": normalize_adj_dense(torch.from_numpy(adj).to(device),
                                       mask_t),
            "labels": torch.from_numpy(labels).to(device),
            "node_mask": mask_t,
            "graph_onehot": torch.from_numpy(graph_onehot).to(device),
        }
