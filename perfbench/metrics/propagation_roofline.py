"""The propagation kernels' share of their roofline: the bytes of kernel
A's and B's calls in the window (each input byte read once, each output
byte written once) at the HBM rate, over the device time of A's and B's
kernels."""

from perfbench import device as peaks
from perfbench.metrics import counts

KERNELS = ("walk_kernel", "csr_rows_kernel")


def read(view):
    t = view.device_seconds(KERNELS)
    s = view.shapes
    n, m, d = s["num_nodes"], s["num_edges"], s["emb_size"]
    total = view.units * (
        counts.a_calls_per_unit(view) * counts.propagation_a_bytes(n, m, d)
        + counts.b_calls_per_unit(view) * counts.propagation_b_bytes(n, m, d))
    if t <= 0 or total <= 0:
        return None
    return 100.0 * total / peaks.PEAK_HBM_BYTES / t
