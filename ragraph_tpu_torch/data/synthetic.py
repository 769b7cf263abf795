"""Synthetic data (counterpart of ``ragraph_tpu/data/synthetic.py``): a
temporal interaction stream for the edge pipeline and TU-shaped
planted-partition graphs for the node pipeline. numpy only; the same seed
gives the same data as the JAX package's generators."""

from __future__ import annotations

import numpy as np

from ragraph_tpu_torch.data.tu import TUDataset, TUGraph


def planted_partition_graph(rng: np.random.Generator, n: int,
                            num_classes: int, feat_dim: int,
                            p_in: float = 0.5, p_out: float = 0.05,
                            signal: float = 1.5, centroids=None):
    """One graph: nodes in ``num_classes`` blocks, dense intra-block edges,
    features = class centroid * signal + noise. ``centroids`` should be
    shared across the graphs of a dataset so that retrieval across graphs
    carries class signal."""
    labels = rng.integers(0, num_classes, size=n)
    same = labels[:, None] == labels[None, :]
    probs = np.where(same, p_in, p_out)
    upper = rng.random((n, n)) < probs
    adj = np.triu(upper, k=1)
    adj = (adj | adj.T).astype(np.float32)

    if centroids is None:
        centroids = rng.normal(size=(num_classes, feat_dim))
    feats = (signal * centroids[labels]
             + rng.normal(size=(n, feat_dim))).astype(np.float32)
    onehot = np.eye(num_classes, dtype=np.float32)[labels]
    return feats, adj, onehot, labels


def synthetic_tu_dataset(seed: int = 0, num_graphs: int = 60,
                         min_nodes: int = 8, max_nodes: int = 24,
                         num_classes: int = 3, feat_dim: int = 16,
                         p_in: float = 0.5, p_out: float = 0.05,
                         signal: float = 1.5,
                         name: str = "SYNTH") -> TUDataset:
    """A TU-shaped dataset of planted-partition graphs; the graph label is
    the majority node class."""
    rng = np.random.default_rng(seed)
    centroids = rng.normal(size=(num_classes, feat_dim))
    graphs = []
    for _ in range(num_graphs):
        n = int(rng.integers(min_nodes, max_nodes + 1))
        feats, adj, onehot, labels = planted_partition_graph(
            rng, n, num_classes, feat_dim, p_in=p_in, p_out=p_out,
            signal=signal, centroids=centroids)
        graph_label = int(np.bincount(labels,
                                      minlength=num_classes).argmax())
        graphs.append(TUGraph(features=feats, adj=adj, node_labels=onehot,
                              graph_label=graph_label))
    return TUDataset(name=name, graphs=graphs,
                     num_node_attributes=feat_dim,
                     num_node_classes=num_classes,
                     num_graph_classes=num_classes)


def synthetic_edge_stream(seed: int = 0, num_users: int = 64,
                          num_items: int = 128, num_classes: int = 4,
                          interactions_per_user: int = 12,
                          num_stages: int = 3):
    """Synthetic ``(user, item, time)`` rows with taste clusters: users
    prefer items of their own cluster, so recall@k is learnable.

    Returns ``(train, stages)``; the same seed gives the same rows as the
    JAX package's generator.
    """
    rng = np.random.default_rng(seed)
    user_cluster = rng.integers(0, num_classes, size=num_users)
    item_cluster = rng.integers(0, num_classes, size=num_items)
    by_cluster = [np.where(item_cluster == c)[0] for c in range(num_classes)]

    def draw(user, t):
        c = user_cluster[user]
        if rng.random() < 0.8 and len(by_cluster[c]) > 0:
            item = int(rng.choice(by_cluster[c]))
        else:
            item = int(rng.integers(0, num_items))
        return (user, item, int(t))

    phases = []
    t0 = 1_600_000_000
    for phase in range(1 + num_stages):
        rows = []
        for u in range(num_users):
            for i in range(interactions_per_user):
                t = t0 + phase * 1_000_000 + int(rng.integers(0, 900_000))
                rows.append(draw(u, t))
        phases.append(rows)
    return phases[0], phases[1:]
