"""Device milliseconds per step under the program's ``adam`` span:
``optimizer.step()``."""

from perfbench.metrics.spans import span_ms


def read(view):
    return span_ms(view, "adam", device=True)
