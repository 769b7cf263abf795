"""Device milliseconds per step under the program's ``backward`` span:
autograd's backward of the loss (with the gradient sums on a mesh)."""

from perfbench.metrics.spans import span_ms


def read(view):
    return span_ms(view, "backward", device=True)
