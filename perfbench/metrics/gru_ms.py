"""Device milliseconds per step under the program's ``roland.gru`` spans:
the forward GRU cells of ROLAND's layers, summed (their backward runs
inside ``backward``)."""

from perfbench.metrics.spans import span_ms


def read(view):
    return span_ms(view, "roland.gru", device=True)
