"""Device milliseconds per step of the retrieval kernels (kernel C, and the
selection family past k = 128), from the trace by kernel name."""

from perfbench.metrics.counts import RETRIEVAL_KERNELS


def read(view):
    if not view.ran(RETRIEVAL_KERNELS):
        return None
    return view.per_unit(view.device_seconds(RETRIEVAL_KERNELS)) * 1e3
