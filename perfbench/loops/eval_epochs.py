"""The evaluation loop: ``generate`` then ``RankingEvaluator.evaluate``
over the test users with the history masked, as closes every epoch of
``EdgeTrainer.train``. The unit is an evaluation; ``eval_ms`` is the window
over the evaluations completed in it.

The numbers compared with the reference:

- ``emb_gap``: ``||E - E_ref|| / ||E_ref||`` of the last ``generate``'s
  embeddings;
- ``recall_gap``, ``ndcg_gap``: the largest relative gap of any
  evaluation's recall@k and ndcg@k in the window against the reference's
  evaluation of the program's embeddings.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from perfbench import check
from perfbench.programs.ragraph_edge import sync

TEST_ROWS = True


def _eval_one(prog):
    with prog.spans.span("generate"):
        user_emb, item_emb = prog.model.generate(prog.tables["params"])
        sync(prog.device)
    with prog.spans.span("evaluate"):
        result = prog.trainer.evaluator.evaluate(
            user_emb, item_emb, prog.ds.test_user_dict,
            prog.ds.user_hist_dict)
    return (user_emb, item_emb), result


def setup(prog) -> None:
    t0 = time.perf_counter()
    prog.record = {"results": []}
    _eval_one(prog)
    prog._stage("first_evaluation", t0)


def window(prog, seconds: float) -> float:
    sync(prog.device)
    t0 = time.perf_counter()
    with prog.spans.span("window"):
        while True:
            emb, result = _eval_one(prog)
            prog.record["results"].append(
                {k: float(v[0]) for k, v in result.items()})
            prog.units += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(prog.device)
    prog.record["embeddings"] = emb
    return time.perf_counter() - t0


def measures(prog, window_s: float) -> dict:
    """The end-to-end measures of a window, by metric name before its
    first dot."""
    return {"eval_ms": window_s * 1e3 / prog.units}


# -- correctness -----------------------------------------------------------

def _pairs(*parts) -> np.ndarray:
    return np.concatenate([np.stack([p["users"], p["items"]], 1)
                           for p in parts])


def _reference_embeddings(cell, prog, device, dtype: str):
    ref = cell["reference"]
    ref.no_tf32()
    model = ref.build(cell["config"], prog.phase, prog.inputs, prog.tables,
                      device, dtype)
    with torch.no_grad():
        return model.forward({k: v.float()
                              for k, v in prog.tables["params"].items()},
                             model.weights())


def readings(cell: dict, prog, device, dtype: str | None = None) -> dict:
    """The cell's numbers. With ``dtype`` (the control), the reference's
    embeddings at that precision take the program's place."""
    ru, ri = _reference_embeddings(cell, prog, device, "bf16")
    if dtype is None:
        pu, pi = prog.record["embeddings"]
    else:
        pu, pi = _reference_embeddings(cell, prog, device, dtype)
    e_ref = torch.cat([ru, ri])
    emb_gap = float((torch.cat([pu, pi]).float() - e_ref).norm()
                    / e_ref.norm())
    inputs = prog.inputs
    k = int(cell["config"]["metrics_k"])
    recall, ndcg = cell["reference"].evaluate(
        pu, pi, inputs["test"], _pairs(inputs["hist"], inputs["train"]), k)
    floor = 1.0 / len(np.unique(inputs["test"][:, 0]))
    results = prog.record["results"] if dtype is None else \
        [{"recall": recall, "ndcg": ndcg}]
    return {"emb_gap": emb_gap,
            "recall_gap": max(check.rel(r["recall"], recall, floor)
                              for r in results),
            "ndcg_gap": max(check.rel(r["ndcg"], ndcg, floor)
                            for r in results)}


def control(cell: dict, prog, device) -> dict:
    """The reference one precision below the configuration's (float8 with
    a per-tensor scale where it states bfloat16) in the program's
    place."""
    return readings(cell, prog, device, dtype="fp8")


# -- faults planted under the timed path -------------------------------------

@contextlib.contextmanager
def half_users():
    """Half of the test users left out; the metrics averaged over the
    rest."""
    from ragraph_tpu_torch.train.metrics import RankingEvaluator
    orig = RankingEvaluator.evaluate

    def evaluate(self, user_emb, item_emb, test_user_dict, user_hist_dict,
                 users=None):
        users = list(test_user_dict)[: len(test_user_dict) // 2]
        return orig(self, user_emb, item_emb, test_user_dict,
                    user_hist_dict, users=users)
    RankingEvaluator.evaluate = evaluate
    try:
        yield
    finally:
        RankingEvaluator.evaluate = orig


@contextlib.contextmanager
def altered_answer():
    """Each evaluation batch's top-k lists altered where they are made:
    every user gets the next user's list."""
    from ragraph_tpu_torch.train import metrics
    orig = metrics._rate_and_topk

    def rate_and_topk(*args):
        return torch.roll(orig(*args), 1, dims=0)
    metrics._rate_and_topk = rate_and_topk
    try:
        yield
    finally:
        metrics._rate_and_topk = orig


def faults(cell: dict) -> dict:
    """The faults this cell can have, by name."""
    return {"half_users": half_users, "altered_answer": altered_answer}
