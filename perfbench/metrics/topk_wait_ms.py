"""Host milliseconds per evaluation in the program's ``eval.fetch``
span: the evaluator's wait for its top-k on the host."""

from perfbench.metrics.spans import span_ms


def read(view):
    return span_ms(view, "eval.fetch")
