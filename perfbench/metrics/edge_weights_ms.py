"""Device milliseconds per step under the program's ``edge_weights`` spans:
the step's dropout masks (``_drop_masks``) and per-edge weights
(``_edge_weights``)."""

from perfbench.metrics.spans import span_ms


def read(view):
    return span_ms(view, "edge_weights", device=True)
