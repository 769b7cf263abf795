"""Device milliseconds per step of the propagation kernels (A, B, I, H),
from the trace by kernel name."""

from perfbench.metrics.counts import PROPAGATION_KERNELS


def read(view):
    if not view.ran(PROPAGATION_KERNELS):
        return None
    return view.per_unit(view.device_seconds(PROPAGATION_KERNELS)) * 1e3
