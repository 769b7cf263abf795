"""The forward GRU cells' share of their roofline: the step's cells
(``gru_cells`` of the shapes) at their bound (:mod:`gru_counts`: the
products at float32's peak, or the bytes at the HBM rate, whichever is
larger) over the device time of the ``roland.gru`` spans, in %."""

from perfbench.metrics import gru_counts
from perfbench.metrics.spans import span_ms


def read(view):
    ms = span_ms(view, "roland.gru", device=True)
    s = view.shapes
    if not ms or not s.get("gru_cells"):
        return None
    bound_ms = 1e3 * s["gru_cells"] * gru_counts.gru_bound_s(
        s["num_nodes"], s["emb_size"])
    return 100.0 * bound_ms / ms
