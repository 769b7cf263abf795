"""Host milliseconds per unit in the program's ``gc`` spans: Python's
garbage collections while the window ran."""

from perfbench.metrics.spans import span_ms


def read(view):
    return span_ms(view, "gc")
