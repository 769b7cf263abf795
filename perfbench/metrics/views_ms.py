"""Device milliseconds per step under the program's ``sgl.views`` span:
the forwards of SGL's two contrastive views."""

from perfbench.metrics.spans import span_ms


def read(view):
    return span_ms(view, "sgl.views", device=True)
