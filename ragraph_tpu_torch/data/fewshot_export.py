"""K-shot support sets: sampling and ``.npz`` export (counterpart of
``ragraph_tpu/data/fewshot_export.py``; numpy only).

The samplers make the same draws from the same ``np.random.Generator`` as
the JAX package's, so both give the same supports, and the files either
writes load in the other.

- :func:`sample_k_shot_nodes`: ``shots`` nodes per node class, with the
  block-diagonal sub-adjacency among them (nodes of different graphs are
  not joined);
- :func:`sample_k_shot_graphs`: ``shots`` whole graphs per graph class,
  stacked block-diagonally, with one label and one node count per graph;
- both return the adjacency symmetrically normalised with self-loops,
  ``D^-1/2 (A + I) D^-1/2``: without the self-loops a sparse support set
  gives all-zero GCN outputs, hence zero class prototypes;
- :func:`export_fewshot_splits` writes one node split per task as
  ``<out_dir>/<task>.npz``, :func:`export_fewshot_graph_split` one graph
  support set shared by every task, and :func:`load_fewshot_split` reads a
  node split back.
"""

from __future__ import annotations

import os

import numpy as np


def _normalize_with_self_loops(adj: np.ndarray) -> np.ndarray:
    n = adj.shape[0]
    adj = adj + np.eye(n, dtype=np.float32)
    d = 1.0 / np.sqrt(np.maximum(adj.sum(1), 1e-12))
    return adj * d[:, None] * d[None, :]


def _choose_per_class(per_class: dict, shots: int, num_classes: int,
                      rng: np.random.Generator) -> list:
    """``(item, class)`` pairs: up to ``shots`` items of each class drawn
    without replacement, classes in order."""
    chosen = []
    for c in range(num_classes):
        pool = per_class[c]
        if not pool:
            continue
        idx = rng.choice(len(pool), size=min(shots, len(pool)),
                         replace=False)
        chosen.extend((pool[i], c) for i in idx)
    return chosen


def sample_k_shot_nodes(dataset, shots: int, num_classes: int,
                        rng: np.random.Generator):
    """``shots`` nodes per node class across a TU-style dataset.

    Returns ``(features (S, F), labels (S,), adj (S, S))``; ``adj`` is the
    induced block-diagonal sub-adjacency of the sampled nodes, normalised
    with self-loops."""
    per_class = {c: [] for c in range(num_classes)}
    for gi, g in enumerate(dataset.graphs):
        if not g.node_labels.shape[1]:
            continue
        y = g.node_labels.argmax(1)
        for ni in range(g.features.shape[0]):
            per_class[int(y[ni])].append((gi, ni))
    chosen = _choose_per_class(per_class, shots, num_classes, rng)

    n = len(chosen)
    feats, labels = [], []
    adj = np.zeros((n, n), np.float32)
    for a, ((gi, ni), c) in enumerate(chosen):
        feats.append(dataset.graphs[gi].features[ni])
        labels.append(c)
        for b, ((gj, nj), _) in enumerate(chosen):
            if gi == gj and dataset.graphs[gi].adj[ni, nj] > 0:
                adj[a, b] = 1.0
    return (np.stack(feats), np.asarray(labels, np.int64),
            _normalize_with_self_loops(adj))


def sample_k_shot_graphs(dataset, shots: int, num_classes: int,
                         rng: np.random.Generator):
    """``shots`` whole graphs per graph class.

    Returns ``(features (N, F), adj (N, N), labels (G,), graph_len (G,))``:
    the sampled graphs' node features stacked, their block-diagonal
    adjacency normalised with self-loops (for a block-diagonal matrix the
    same as normalising each graph), one label per graph and each graph's
    node count."""
    per_class = {c: [] for c in range(num_classes)}
    for gi, g in enumerate(dataset.graphs):
        y = getattr(g, "graph_label", None)
        if y is not None:
            per_class[int(y)].append(gi)
    chosen = _choose_per_class(per_class, shots, num_classes, rng)

    graphs = [dataset.graphs[gi] for gi, _ in chosen]
    lens = [g.features.shape[0] for g in graphs]
    n = int(sum(lens))
    adj = np.zeros((n, n), np.float32)
    off = 0
    for g in graphs:
        m = g.features.shape[0]
        adj[off:off + m, off:off + m] = np.asarray(g.adj, np.float32)
        off += m
    return (np.concatenate([g.features for g in graphs], axis=0),
            _normalize_with_self_loops(adj),
            np.asarray([c for _, c in chosen], np.int64),
            np.asarray(lens, np.int64))


def export_fewshot_splits(dataset, out_dir: str, shots: int = 5,
                          num_tasks: int = 5, seed: int = 0):
    """Write ``num_tasks`` k-shot node splits, task ``i`` drawn from
    ``np.random.default_rng(seed + i)``, as ``<out_dir>/<i>.npz`` with
    ``features``, ``labels`` and ``adj``; returns the paths."""
    num_classes = max(dataset.num_node_classes, 1)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for task in range(num_tasks):
        rng = np.random.default_rng(seed + task)
        feats, labels, adj = sample_k_shot_nodes(dataset, shots,
                                                 num_classes, rng)
        path = os.path.join(out_dir, f"{task}.npz")
        np.savez(path, features=feats, labels=labels, adj=adj)
        paths.append(path)
    return paths


def export_fewshot_graph_split(dataset, out_path: str, shots: int = 5,
                               seed: int = 0):
    """Write one graph-level k-shot support set, shared by every task, as
    ``.npz`` with ``features``, ``adj``, ``labels`` and ``graph_len``;
    returns ``out_path``."""
    num_classes = max(dataset.num_graph_classes, 1)
    rng = np.random.default_rng(seed)
    feats, adj, labels, lens = sample_k_shot_graphs(dataset, shots,
                                                    num_classes, rng)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, features=feats, adj=adj, labels=labels,
             graph_len=lens)
    return out_path


def load_fewshot_split(path: str):
    """One exported node split: ``(features, labels, adj)``."""
    data = np.load(path)
    return data["features"], data["labels"], data["adj"]
