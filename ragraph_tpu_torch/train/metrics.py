"""Ranking metrics with history masking (counterpart of
``ragraph_tpu/train/metrics.py``).

The ``(B, I)`` rating, the history mask and the top-k run on the device;
the ragged ground-truth bookkeeping stays in numpy on the host. The top-k
is exact at every catalog size (the TPU's approximate top-k above 32k items
has no GPU counterpart). Under a profiler recording an evaluation is span
``evaluate``, holding ``eval.history`` and ``eval.score`` for each user
batch, ``eval.fetch`` (the host's wait for the top-k) and ``eval.hits``.
"""

from __future__ import annotations

import numpy as np
import torch

from ragraph_tpu_torch.train.profiling import span


def _rate_and_topk(user_emb_batch: torch.Tensor, item_emb: torch.Tensor,
                   hist_rows: torch.Tensor, hist_cols: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Score one user batch, mask history to ``-1e8``, return top-k items.
    Entries with an out-of-range column (the padding) are ignored."""
    scores = user_emb_batch.float() @ item_emb.float().T
    ok = hist_cols < scores.shape[1]
    scores[hist_rows[ok].long(), hist_cols[ok].long()] = -1e8
    return torch.topk(scores, k, dim=1).indices


def _pad_history(users, user_hist_dict, num_items):
    """Flatten per-user histories into (row, col) index arrays, padded to a
    power of two with out-of-range columns."""
    rows, cols = [], []
    for r, u in enumerate(users):
        for i in user_hist_dict.get(int(u), ()):
            rows.append(r)
            cols.append(i)
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    target = max(1, 1 << (max(len(rows), 1) - 1).bit_length())
    pad = target - len(rows)
    if pad:
        rows = np.concatenate([rows, np.zeros(pad, np.int32)])
        cols = np.concatenate([cols, np.full(pad, num_items, np.int32)])
    return rows, cols


def recall_at_k(hits, test_lens, k):
    return (hits[:, :k].sum(1) / test_lens).sum()


def precision_at_k(hits, k):
    return hits[:, :k].sum() / k


def mrr_at_k(hits, k, compat=False):
    """MRR: 1/rank of the first hit within the top-k.

    ``compat=True`` reproduces the reference formula bit for bit
    (``RAGraph_edge/utils/metrics.py:24-29``), which divides by
    ``log2(1/rank)``: a rank-1 hit gives ``inf`` and a rank-1 miss ``nan``.
    """
    if compat:
        with np.errstate(divide="ignore", invalid="ignore"):
            scores = np.log2(1.0 / np.arange(1, k + 1))
            pred = hits[:, :k] / scores
        return pred.sum(1).sum()
    ranks = np.arange(1, k + 1, dtype=np.float32)
    first_hit = np.where(hits[:, :k] > 0, 1.0 / ranks, 0.0).max(axis=1)
    return first_hit.sum()


def ndcg_at_k(hits, test_lens, k):
    pred = hits[:, :k]
    discount = 1.0 / np.log2(np.arange(2, k + 2))
    dcg = (pred * discount).sum(1)
    idcg = np.array([discount[: min(int(n), k)].sum() for n in test_lens])
    idcg[idcg == 0.0] = 1.0
    ndcg = dcg / idcg
    ndcg[np.isnan(ndcg)] = 0.0
    return ndcg.sum()


class RankingEvaluator:
    """Full-catalog ranking eval over a test user dict."""

    def __init__(self, metrics=("recall", "ndcg"), ks=(20,),
                 eval_batch_size: int = 512, mrr_compat: bool = False):
        self.metrics = tuple(metrics)
        self.ks = tuple(int(k) for k in ks)
        self.eval_batch_size = eval_batch_size
        self.mrr_compat = mrr_compat

    @torch.no_grad()
    def evaluate(self, user_emb, item_emb, test_user_dict, user_hist_dict,
                 users=None):
        """Returns {metric: np.array over ks} averaged over test users."""
        with span("evaluate"):
            return self._evaluate(user_emb, item_emb, test_user_dict,
                                  user_hist_dict, users)

    def _evaluate(self, user_emb, item_emb, test_user_dict, user_hist_dict,
                  users):
        if users is None:
            users = list(test_user_dict.keys())
        num_users = len(users)
        num_items = item_emb.shape[0]
        max_k = max(self.ks)
        result = {m: np.zeros(len(self.ks)) for m in self.metrics}
        if num_users == 0:
            return result

        dev = user_emb.device
        topks = []
        for s in range(0, num_users, self.eval_batch_size):
            batch_users = users[s:s + self.eval_batch_size]
            ids = torch.from_numpy(np.asarray(batch_users, np.int64)).to(dev)
            with span("eval.history"):
                rows, cols = _pad_history(batch_users, user_hist_dict,
                                          num_items)
            with span("eval.score"):
                topks.append(_rate_and_topk(
                    user_emb[ids], item_emb, torch.from_numpy(rows).to(dev),
                    torch.from_numpy(cols).to(dev), max_k))
        with span("eval.fetch"):
            all_topk = torch.cat(topks, dim=0).cpu().numpy()

        with span("eval.hits"):
            hits = np.zeros((num_users, max_k), np.float32)
            test_lens = np.zeros(num_users, np.float32)
            for r, u in enumerate(users):
                gt = set(test_user_dict[int(u)])
                test_lens[r] = len(gt)
                hits[r] = [c in gt for c in all_topk[r].tolist()]

            for ki, k in enumerate(self.ks):
                for m in self.metrics:
                    if m == "recall":
                        result[m][ki] = recall_at_k(hits, test_lens, k)
                    elif m == "ndcg":
                        result[m][ki] = ndcg_at_k(hits, test_lens, k)
                    elif m == "precision":
                        result[m][ki] = precision_at_k(hits, k)
                    elif m == "mrr":
                        result[m][ki] = mrr_at_k(hits, k,
                                                 compat=self.mrr_compat)

            for m in self.metrics:
                result[m] = result[m] / num_users
        return result

    def evaluate_grouped(self, user_emb, item_emb, test_user_dict,
                         train_user_dict, user_hist_dict,
                         group: str = "tuned"):
        """Tuned/untuned user split (reference ``metrics.py:143-209``)."""
        tuned = set(train_user_dict) & set(test_user_dict)
        users = (sorted(tuned) if group == "tuned"
                 else sorted(set(test_user_dict) - set(train_user_dict)))
        return self.evaluate(user_emb, item_emb, test_user_dict,
                             user_hist_dict, users=users)
