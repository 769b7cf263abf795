"""Milliseconds per evaluation of ``RankingEvaluator.evaluate`` (device
scoring and top-k, host bookkeeping), a span."""


def read(view):
    t = view.spans.get("evaluate")
    return 1e3 * sum(t) / len(t) if t else None
