"""Host milliseconds per evaluation in the program's ``eval.hits`` span:
the ground-truth loop and the metric sums."""

from perfbench.metrics.spans import span_ms


def read(view):
    return span_ms(view, "eval.hits")
