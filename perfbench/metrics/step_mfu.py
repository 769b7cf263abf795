"""The whole step's share of the card's bf16 dense peak: the operations a
step needs (the retrieval's score product, kernel A's propagation forward
and backward) over the traced window's time per step."""

from perfbench import device as peaks
from perfbench.metrics import counts


def read(view):
    if view.units <= 0:
        return None
    s = view.shapes
    flops = (counts.retrievals_per_unit(view) * counts.retrieval_flops(
        s["num_nodes"], s["library_rows"], s["emb_size"])
        + counts.a_calls_per_unit(view) * counts.propagation_a_flops(
            s["num_edges"], s["emb_size"]))
    if flops <= 0:
        return None
    step_s = view.window_s / view.units
    return 100.0 * flops / (step_s * peaks.PEAK_BF16_FLOPS)
