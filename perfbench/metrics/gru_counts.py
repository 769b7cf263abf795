"""Operation and byte counts of one GRU cell over ``n`` rows of width
``e`` (``torch.nn.GRUCell``'s step, as ROLAND runs it after each
propagation layer), with no padding:

- operations: the two ``(n, e) x (e, 3e)`` products, ``2 * 2 n e 3e =
  12 n e^2`` (the gates' elementwise work is not counted);
- bytes: the float32 input ``x`` and hidden state ``h`` read once, the
  output written once, ``12 n e``, and the weights and biases read once,
  ``4 (6 e^2 + 6 e)``.

The bound of a cell is the larger of its operations at float32's peak
outside the tensor cores (the GRU runs in float32 with TF32 off) and its
bytes at the HBM rate.
"""

from __future__ import annotations

from perfbench import device as peaks

# One NVIDIA H100 SXM, float32 without the tensor cores (NVIDIA's data
# sheet), at its full power limit of 700 W.
PEAK_FP32_FLOPS = 66.9e12


def gru_flops(n: int, e: int) -> float:
    return 12.0 * n * e * e


def gru_bytes(n: int, e: int) -> float:
    return 12.0 * n * e + 4.0 * (6 * e * e + 6 * e)


def gru_bound_s(n: int, e: int) -> float:
    """Seconds one cell needs at least."""
    return max(gru_flops(n, e) / PEAK_FP32_FLOPS,
               gru_bytes(n, e) / peaks.PEAK_HBM_BYTES)
