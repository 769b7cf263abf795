"""The retrieval kernels' share of their roofline: the least time of a
step's retrievals (the score product at the bf16 dense peak, or the bytes
read once at the HBM rate, whichever is larger) over their device time."""

from perfbench import device as peaks
from perfbench.metrics import counts


def read(view):
    t = view.device_seconds(counts.RETRIEVAL_KERNELS)
    n = counts.retrievals_per_unit(view) * view.units
    if t <= 0 or n <= 0:
        return None
    s = view.shapes
    q, r, e, k = s["num_nodes"], s["library_rows"], s["emb_size"], \
        s["retrieve_num"]
    bound = n * max(counts.retrieval_flops(q, r, e) / peaks.PEAK_BF16_FLOPS,
                    counts.retrieval_bytes(q, r, e, k) / peaks.PEAK_HBM_BYTES)
    return 100.0 * bound / t
