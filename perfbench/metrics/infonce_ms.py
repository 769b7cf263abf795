"""Device milliseconds per step under the program's ``infonce`` spans: the
InfoNCE between the two views' rows of the batch's distinct users and
items."""

from perfbench.metrics.spans import span_ms


def read(view):
    return span_ms(view, "infonce", device=True)
