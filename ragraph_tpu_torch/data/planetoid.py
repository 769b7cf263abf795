"""Planetoid (Cora, Citeseer, Pubmed) loading and classic GNN helpers: a
numpy and scipy copy of ``ragraph_tpu/data/planetoid.py``, after the
reference's ``RAGraph_node/utils/process.py``:
- ``load_data`` (``:123-161``): the pickled Planetoid split format
  (``ind.<ds>.{x,y,tx,ty,allx,ally,graph}`` + ``test.index``), with the
  Citeseer padding for isolated test nodes;
- ``preprocess_features`` row normalization (``:199-206``);
- ``adj_to_bias`` attention-bias mask (``:92-103``);
- ``micro_f1`` (``:66-84``);
- ``sample_mask`` (``:117-121``).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import scipy.sparse as sp


def parse_index_file(filename: str):
    with open(filename) as f:
        return [int(line.strip()) for line in f]


def sample_mask(idx, n: int) -> np.ndarray:
    mask = np.zeros(n, dtype=bool)
    mask[idx] = True
    return mask


def load_planetoid(root: str, dataset: str):
    """Load a Planetoid dataset.

    Returns ``(adj (scipy csr), features (N, F) float32 row-normalized,
    labels (N, C) one-hot, idx_train, idx_val, idx_test)``.
    """
    names = ["x", "y", "tx", "ty", "allx", "ally", "graph"]
    objects = []
    for name in names:
        path = os.path.join(root, f"ind.{dataset}.{name}")
        with open(path, "rb") as f:   # unpickling runs code: trusted files
            objects.append(pickle.load(f, encoding="latin1"))
    x, y, tx, ty, allx, ally, graph = objects
    test_idx = parse_index_file(
        os.path.join(root, f"ind.{dataset}.test.index"))
    test_idx_range = np.sort(test_idx)

    if dataset == "citeseer":
        # isolated test nodes: pad with zero rows (process.py:135-143)
        full = range(min(test_idx), max(test_idx) + 1)
        tx_ext = sp.lil_matrix((len(full), x.shape[1]))
        tx_ext[test_idx_range - min(test_idx), :] = tx
        tx = tx_ext
        ty_ext = np.zeros((len(full), y.shape[1]))
        ty_ext[test_idx_range - min(test_idx), :] = ty
        ty = ty_ext

    features = sp.vstack((allx, tx)).tolil()
    features[test_idx, :] = features[test_idx_range, :]
    labels = np.vstack((ally, ty))
    labels[test_idx, :] = labels[test_idx_range, :]

    # adjacency from the neighbor dict
    n = labels.shape[0]
    rows, cols = [], []
    for u, nbrs in graph.items():
        for v in nbrs:
            rows.append(u)
            cols.append(v)
    adj = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    adj = ((adj + adj.T) > 0).astype(np.float32)

    idx_test = test_idx_range.tolist()
    idx_train = list(range(len(y)))
    idx_val = list(range(len(y), len(y) + 500))

    features = row_normalize_features(
        np.asarray(features.todense(), dtype=np.float32))
    return adj, features, labels.astype(np.float32), idx_train, idx_val, idx_test


def row_normalize_features(features: np.ndarray) -> np.ndarray:
    """Row-normalize to unit sum (``preprocess_features``)."""
    rowsum = features.sum(axis=1, keepdims=True)
    inv = np.where(rowsum > 0, 1.0 / np.maximum(rowsum, 1e-12), 0.0)
    return features * inv


def standardize_data(features: np.ndarray,
                     train_mask: np.ndarray) -> np.ndarray:
    """Z-score features using statistics of the training rows only
    (``standardize_data``, ``RAGraph_node/utils/process.py:187-197``)."""
    mu = features[train_mask].mean(axis=0)
    sigma = features[train_mask].std(axis=0)
    sigma = np.where(sigma > 0, sigma, 1.0)
    return (features - mu) / sigma


def adj_to_bias(adj: np.ndarray, nhood: int = 1) -> np.ndarray:
    """Attention bias: 0 within ``nhood`` hops (incl. self), -1e9 outside
    (``adj_to_bias``, single-graph form)."""
    n = adj.shape[0]
    mt = np.eye(n)
    for _ in range(nhood):
        mt = mt @ (adj + np.eye(n))
    mt = (mt > 0).astype(np.float32)
    return -1e9 * (1.0 - mt)


def micro_f1(logits: np.ndarray, labels: np.ndarray) -> float:
    """Micro-averaged F1 over multi-label predictions (``micro_f1``:
    predictions = round(sigmoid(logits)))."""
    preds = (1.0 / (1.0 + np.exp(-logits))) > 0.5
    labels = labels > 0.5
    tp = np.count_nonzero(preds & labels)
    fp = np.count_nonzero(preds & ~labels)
    fn = np.count_nonzero(~preds & labels)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)
