"""Host milliseconds per evaluation in the program's ``eval.history``
spans: the evaluator's history lists (``_pad_history``)."""

from perfbench.metrics.spans import span_ms


def read(view):
    return span_ms(view, "eval.history")
