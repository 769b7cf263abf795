"""Temporal user-item edge-list datasets: a numpy copy of the parts of
``ragraph_tpu/data/edgelist.py`` that the serving path reads.

Rows are ``user \\t items \\t times`` lines or ``(user, item, time)``
tuples. The bipartite graph becomes a bidirectional, receiver-sorted edge
array over ``U + I`` nodes with binorm weights and CSR bounds. Files are
parsed and negatives drawn in C++ (``csrc/fastgraph.cpp`` through
:mod:`ragraph_tpu_torch.utils.native`) unless the caller passes
``use_native=False`` for the numpy path; either way the draws are the JAX
package's, bit for bit, from the same generator.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from ragraph_tpu_torch.utils.native import (negative_sample_native,
                                            parse_edge_file_native)


def timestamp_to_time_step(timestamps: np.ndarray, hour_interval: float,
                           least_time: int | None = None) -> np.ndarray:
    """Bin raw timestamps into ``hour_interval``-hour steps."""
    if least_time is None:
        least_time = timestamps.min()
    return (timestamps - least_time) // int(hour_interval * 3600)


def parse_edge_file(path_or_rows, has_time: bool = True,
                    use_native: bool = True):
    """Parse a tab-separated edge file or an iterable of (u, i, t) rows.

    A file goes through the C++ parser, or with ``use_native=False`` through
    a Python line loop; both give the same rows."""
    rows = []
    if isinstance(path_or_rows, str):
        if use_native:
            users, items, times = parse_edge_file_native(path_or_rows)
            if not has_time:
                times = np.zeros_like(times)
            return list(zip(users.tolist(), items.tolist(), times.tolist()))
        with open(path_or_rows) as f:
            for line in f:
                parts = line.strip().split("\t")
                if not has_time:
                    user, items = parts[:2]
                    times = " ".join(["0"] * len(items.split(" ")))
                else:
                    user, items, times = parts
                for item, t in zip(items.split(" "), times.split(" ")):
                    rows.append((int(user), int(item), int(t)))
    else:
        rows = [(int(u), int(i), int(t)) for (u, i, t) in path_or_rows]
    return rows


@dataclasses.dataclass
class EdgeDataset:
    """Loaded and preprocessed temporal interaction data."""

    edgelist: np.ndarray          # (E, 2) int32 (user, item)
    edge_time: np.ndarray         # (E,) binned time steps (1-based)
    num_users: int
    num_items: int
    train_user_dict: dict         # user -> list[item]
    test_user_dict: dict          # user -> list[item]
    user_hist_dict: dict          # user -> list[item] (masked in eval)

    # bidirectional graph over U + I nodes, receiver-sorted
    senders: np.ndarray           # (2E,) int32
    receivers: np.ndarray         # (2E,) int32, ascending
    edge_norm: np.ndarray         # (2E,) float32 binorm weights
    edge_times_bi: np.ndarray     # (2E,) int32
    recv_indptr: np.ndarray = None  # (U+I+1,) int32 CSR bounds
    _hist_keys: np.ndarray = None  # sorted user*I+item of the train pairs

    @property
    def num_edges(self) -> int:
        return len(self.edgelist)

    @property
    def num_nodes(self) -> int:
        return self.num_users + self.num_items

    def sample_negatives(self, users: np.ndarray, rng: np.random.Generator,
                         n: int = 1, max_rounds: int = 100,
                         use_native: bool = True) -> np.ndarray:
        """Rejection-sample ``n`` negatives per user: items that are not
        among the user's train interactions. Returns ``(len(users), n)``.

        The C++ sampler takes its seed from ``rng`` (one draw), so the
        generator moves on as the JAX package's does; ``use_native=False``
        draws with numpy, redrawing only the rejected entries."""
        if use_native:
            return negative_sample_native(
                users, self._hist_keys, self.num_items,
                seed=int(rng.integers(0, 2**63 - 1)), n_negs=n)
        out = rng.integers(0, self.num_items, size=(len(users), n))
        # int64 before the multiply: users arrive as int32, and
        # user * num_items passes 2**31 at production scale, after which
        # every membership test would miss
        u64 = users.astype(np.int64)
        keys = u64[:, None] * self.num_items + out
        for _ in range(max_rounds):
            idx = np.searchsorted(self._hist_keys, keys.ravel())
            idx = np.minimum(idx, len(self._hist_keys) - 1)
            bad = (self._hist_keys[idx] == keys.ravel()).reshape(keys.shape)
            if not bad.any():
                break
            out[bad] = rng.integers(0, self.num_items, size=int(bad.sum()))
            keys = u64[:, None] * self.num_items + out
        return out

    def train_batches(self, batch_size: int, rng: np.random.Generator,
                      n_negs: int = 1, drop_remainder: bool = True):
        """Shuffled ``(users, pos_items, neg_items)`` int32 batches."""
        perm = rng.permutation(self.num_edges)
        edges = self.edgelist[perm]
        end = self.num_edges - (self.num_edges % batch_size
                                if drop_remainder else 0)
        for s in range(0, end, batch_size):
            chunk = edges[s:s + batch_size]
            users = chunk[:, 0].astype(np.int32)
            pos = chunk[:, 1].astype(np.int32)
            negs = self.sample_negatives(users, rng, n=n_negs).astype(np.int32)
            yield users, pos, negs.squeeze(-1) if n_negs == 1 else negs


def load_edge_dataset(train, test, hour_interval: float = 1.0,
                      has_time: bool = True,
                      num_users: int | None = None,
                      num_items: int | None = None,
                      user_hist: list | None = None,
                      phase: str = "pretrain",
                      pad_edges_to: int | None = None) -> EdgeDataset:
    """Build an :class:`EdgeDataset`.

    Args:
      train/test: file path, or iterable of ``(user, item, time)`` /
        ``(user, item)`` rows.
      user_hist: extra interaction row lists (earlier stages) added to the
        history dict for eval masking in the finetune phase.
      pad_edges_to: pad the bidirectional edge arrays to this length with
        inert zero-weight edges.
    """
    train_rows = parse_edge_file(train, has_time)
    test_rows = (parse_edge_file(test, has_time=False)
                 if isinstance(test, str)
                 else [(int(u), int(i), 0) for (u, i, *rest) in test])

    edgelist = np.array([(u, i) for (u, i, _) in train_rows], dtype=np.int32)
    raw_times = np.array([t for (_, _, t) in train_rows], dtype=np.int64)
    edge_time = (1 + timestamp_to_time_step(raw_times, hour_interval)
                 ).astype(np.int32)

    train_user_dict = defaultdict(list)
    for u, i, _ in train_rows:
        train_user_dict[u].append(i)
    test_user_dict = defaultdict(list)
    for u, i, _ in test_rows:
        test_user_dict[u].append(i)

    if num_users is None:
        num_users = int(max(edgelist[:, 0].max(),
                            max(test_user_dict.keys(), default=0))) + 1
    if num_items is None:
        max_test_item = max((max(v) for v in test_user_dict.values()),
                            default=0)
        num_items = int(max(edgelist[:, 1].max(), max_test_item)) + 1

    user_hist_dict = {u: list(v) for u, v in train_user_dict.items()}
    if phase == "finetune" and user_hist:
        for rows in user_hist:
            for u, i, *_ in parse_edge_file(rows, has_time) \
                    if isinstance(rows, str) else [(r[0], r[1]) for r in rows]:
                user_hist_dict.setdefault(u, []).append(i)

    # bidirectional graph with binorm weights
    u = edgelist[:, 0]
    it = edgelist[:, 1] + num_users
    user_deg = np.bincount(u, minlength=num_users + num_items).astype(np.float32)
    item_deg = np.bincount(it, minlength=num_users + num_items).astype(np.float32)
    deg = user_deg + item_deg
    with np.errstate(divide="ignore"):
        d_inv_sqrt = np.where(deg > 0, deg ** -0.5, 0.0)
    norm = (d_inv_sqrt[u] * d_inv_sqrt[it]).astype(np.float32)

    senders = np.concatenate([u, it]).astype(np.int32)
    receivers = np.concatenate([it, u]).astype(np.int32)
    edge_norm = np.concatenate([norm, norm])
    edge_times_bi = np.concatenate([edge_time, edge_time]).astype(np.int32)

    # receiver-sorted order, which the CSR segment sums need
    order = np.argsort(receivers, kind="stable")
    senders = senders[order]
    receivers = receivers[order]
    edge_norm = edge_norm[order]
    edge_times_bi = edge_times_bi[order]
    n_nodes = num_users + num_items

    if pad_edges_to is not None and pad_edges_to > len(senders):
        # inert padding: zero weight, the last node id on both ends (keeps
        # receivers sorted); the time softmax skips zero-weight edges
        pad = pad_edges_to - len(senders)
        senders = np.concatenate(
            [senders, np.full(pad, n_nodes - 1, np.int32)])
        receivers = np.concatenate(
            [receivers, np.full(pad, n_nodes - 1, np.int32)])
        edge_norm = np.concatenate([edge_norm,
                                    np.zeros(pad, edge_norm.dtype)])
        edge_times_bi = np.concatenate([edge_times_bi,
                                        np.zeros(pad, np.int32)])

    recv_counts = np.bincount(receivers, minlength=n_nodes)
    recv_indptr = np.zeros(n_nodes + 1, np.int32)
    recv_indptr[1:] = np.cumsum(recv_counts)

    hist_keys = np.unique(edgelist[:, 0].astype(np.int64) * num_items
                          + edgelist[:, 1].astype(np.int64))

    return EdgeDataset(
        edgelist=edgelist, edge_time=edge_time,
        num_users=num_users, num_items=num_items,
        train_user_dict=dict(train_user_dict),
        test_user_dict=dict(test_user_dict),
        user_hist_dict=user_hist_dict,
        senders=senders, receivers=receivers,
        edge_norm=edge_norm, edge_times_bi=edge_times_bi,
        recv_indptr=recv_indptr,
        _hist_keys=hist_keys,
    )


def merge_rows(row_lists):
    """Concatenate interaction row lists per user: a left join on the users
    of the first list, duplicates kept (the reference's ``merge_pd``)."""
    base_users = {u for (u, _, _) in row_lists[0]}
    out = list(row_lists[0])
    for rows in row_lists[1:]:
        out.extend((u, i, t) for (u, i, t) in rows if u in base_users)
    return out
