"""TU-format dataset loading (counterpart of ``ragraph_tpu/data/tu.py``;
numpy only, the same graphs in the same order).

    <name>_A.txt                edge list (1-based, "row, col")
    <name>_graph_indicator.txt  node -> graph id (1-based)
    <name>_graph_labels.txt     per-graph label
    <name>_node_labels.txt      per-node label (optional)
    <name>_node_attributes.txt  per-node continuous attrs (optional)

Node features are the continuous attributes; node "labels" are the one-hot
node-label block.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class TUGraph:
    features: np.ndarray     # (n, F) float32 continuous attributes
    adj: np.ndarray          # (n, n) float32 binary adjacency (raw)
    node_labels: np.ndarray  # (n, C_node) one-hot node labels
    graph_label: int


@dataclasses.dataclass
class TUDataset:
    name: str
    graphs: list
    num_node_attributes: int
    num_node_classes: int
    num_graph_classes: int

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i):
        return self.graphs[i]

    def shuffle(self, rng: np.random.Generator):
        order = rng.permutation(len(self.graphs))
        return dataclasses.replace(
            self, graphs=[self.graphs[i] for i in order])

    def subset(self, lo: float, hi: float):
        """Fractional slice ``graphs[int(lo·n):int(hi·n)]``."""
        n = len(self.graphs)
        return dataclasses.replace(
            self, graphs=self.graphs[int(lo * n): int(hi * n)])


def _maybe_load(path: str):
    return np.loadtxt(path, delimiter=",", ndmin=2) \
        if os.path.exists(path) else None


def load_tu_dataset(root: str, name: str) -> TUDataset:
    """Parse a raw TU dataset directory ``root/name/name_*.txt``."""
    base = os.path.join(root, name, name)
    edges = np.loadtxt(base + "_A.txt", delimiter=",", dtype=np.int64,
                       ndmin=2) - 1
    graph_ind = np.loadtxt(base + "_graph_indicator.txt", dtype=np.int64,
                           ndmin=1) - 1
    graph_labels = np.loadtxt(base + "_graph_labels.txt", dtype=np.int64,
                              ndmin=1)
    graph_labels = graph_labels - graph_labels.min()

    node_labels_raw = _maybe_load(base + "_node_labels.txt")
    node_attrs = _maybe_load(base + "_node_attributes.txt")

    num_nodes = graph_ind.shape[0]
    if node_labels_raw is not None:
        nl = node_labels_raw.astype(np.int64).reshape(num_nodes, -1)[:, 0]
        nl = nl - nl.min()
        num_node_classes = int(nl.max()) + 1
        node_onehot = np.eye(num_node_classes, dtype=np.float32)[nl]
    else:
        num_node_classes = 0
        node_onehot = np.zeros((num_nodes, 0), dtype=np.float32)

    if node_attrs is None:
        node_attrs = np.zeros((num_nodes, 0), dtype=np.float32)
    node_attrs = node_attrs.astype(np.float32)

    num_graphs = int(graph_ind.max()) + 1
    # TU nodes are contiguous per graph
    node_offsets = np.zeros(num_graphs + 1, dtype=np.int64)
    node_offsets[1:] = np.cumsum(np.bincount(graph_ind, minlength=num_graphs))

    src_graph = graph_ind[edges[:, 0]]
    edges_sorted = edges[np.argsort(src_graph, kind="stable")]
    edge_offsets = np.zeros(num_graphs + 1, dtype=np.int64)
    edge_offsets[1:] = np.cumsum(np.bincount(src_graph, minlength=num_graphs))

    graphs = []
    for g in range(num_graphs):
        lo, hi = node_offsets[g], node_offsets[g + 1]
        n = hi - lo
        e = edges_sorted[edge_offsets[g]: edge_offsets[g + 1]] - lo
        adj = np.zeros((n, n), dtype=np.float32)
        adj[e[:, 0], e[:, 1]] = 1.0
        graphs.append(TUGraph(features=node_attrs[lo:hi], adj=adj,
                              node_labels=node_onehot[lo:hi],
                              graph_label=int(graph_labels[g])))

    return TUDataset(name=name, graphs=graphs,
                     num_node_attributes=node_attrs.shape[1],
                     num_node_classes=num_node_classes,
                     num_graph_classes=int(graph_labels.max()) + 1)
