"""Exact k-th selection and the huge-k RAG fusion over a row-sharded
library (counterpart of ``ragraph_tpu/parallel/sharded_selection.py``).

The koubei and taobao ``vanilla`` configs retrieve the top 100,000 library
rows per node (``retrieve_num=100000``). On one device
``TemporalLightGCN._retrieved_mean`` replaces the sort by the k-th-score
threshold (:func:`ragraph_tpu_torch.ops.selection.rowwise_kth_largest`)
and a membership product. Here the same math runs over a library whose
rows are sharded over ``idx``:

1. each rank scores the replicated query chunk against its ``R/D`` rows,
   so the ``(Q, R)`` scores only exist as ``(Q, R/D)`` blocks;
2. the radix search runs on each rank's ordered keys, and each pass's
   ``(Q, 2^w - 1)`` rank counts are summed over the axis as int32. The
   counts are exact integer sums, so the threshold is bit for bit the
   single-device one of the same dtype (f32 in 11 passes, bf16 in 6);
3. the membership mean's partial sums (``count`` and ``member @ values``)
   complete with one more sum.
"""

from __future__ import annotations

import torch

from ragraph_tpu_torch.ops.selection import (_narrow_key,
                                             ordered_key_to_bf16,
                                             ordered_key_to_f32)
from ragraph_tpu_torch.ops.similarity import l2_normalize
from ragraph_tpu_torch.parallel.collectives import all_reduce
from ragraph_tpu_torch.parallel.mesh import axis_size


def kth_largest_psum(x_local: torch.Tensor, k: int, mesh, r_global: int,
                     axis_name: str = "idx") -> torch.Tensor:
    """The k-th largest of each row of a ``(Q, R_global)`` matrix whose
    columns are sharded over ``axis_name`` (``x_local`` is this rank's
    ``(Q, R_local)`` block). Returns the replicated ``(Q, 1)`` threshold,
    equal bit for bit to ``rowwise_kth_largest`` of the whole matrix. ``k``
    is clamped to ``[1, R_global]``; a bf16 block runs the 16-bit search."""
    q_len = x_local.shape[0]
    k = max(1, min(k, r_global))
    bf16 = x_local.dtype == torch.bfloat16
    key = _narrow_key(x_local, bf16)
    half = 1 << (15 if bf16 else 31)

    def step(lo, shift, width):
        cands = [lo | (j << shift) for j in range(1, 2 ** width)]
        # the pass's candidates share one integer sum over the axis
        cnt = torch.cat([(key >= (c - half).to(key.dtype)).sum(
            dim=1, keepdim=True, dtype=torch.int32) for c in cands], dim=1)
        cnt = all_reduce(cnt, mesh, axis_name)
        best = lo
        for j, c in enumerate(cands):
            best = torch.where(cnt[:, j:j + 1] >= k, c, best)
        return best

    lo = torch.zeros((q_len, 1), dtype=torch.int64, device=x_local.device)
    if bf16:
        lo = step(lo, 14, 2)                   # bits 15..14
        for shift in (11, 8, 5, 2):            # bits 13..2
            lo = step(lo, shift, 3)
        lo = step(lo, 0, 2)                    # bits 1..0
        return ordered_key_to_bf16(lo)
    lo = step(lo, 30, 2)                       # bits 31..30
    for shift in range(27, -1, -3):            # bits 29..0 in ten passes
        lo = step(lo, shift, 3)
    return ordered_key_to_f32(lo)


def sharded_kth_largest(mesh, x_local: torch.Tensor, k: int,
                        axis_name: str = "idx") -> torch.Tensor:
    """Row-wise k-th largest of a matrix whose columns are sharded over
    ``axis_name`` in equal blocks (``x_local`` this rank's); replicated
    ``(Q, 1)``."""
    r_global = x_local.shape[1] * axis_size(mesh, axis_name)
    return kth_largest_psum(x_local, k, mesh, r_global, axis_name)


@torch.no_grad()
def sharded_huge_k_fuse(mesh, queries: torch.Tensor, keys_n: torch.Tensor,
                        values: torch.Tensor, k: int,
                        valid_mask: torch.Tensor | None = None,
                        axis_name: str = "idx"):
    """Mean of each query's top-k library rows, the library row-sharded.

    ``queries (Q, E)`` replicated, not yet normalised; ``keys_n`` this
    rank's block of the L2-normalised keys (bf16 keys select the bf16
    selection tier); ``values`` its block of the values; ``valid_mask`` its
    block of a row mask (False rows never score or count; with fewer than
    k valid rows the mean is over all valid rows). Returns replicated
    ``(mean (Q, Ev) f32, count (Q,) int32)``; the threshold is bit for bit
    the single-device one, the mean differs by the order of the sums.
    """
    r_global = keys_n.shape[0] * axis_size(mesh, axis_name)
    scores = l2_normalize(queries).to(keys_n.dtype) @ keys_n.T  # (Q, R/D)
    if valid_mask is not None:
        scores = torch.where(valid_mask[None, :].bool(), scores, -torch.inf)
    kth = kth_largest_psum(scores, k, mesh, r_global, axis_name)
    member = scores >= kth
    if valid_mask is not None:
        member = member & valid_mask[None, :].bool()
    count = all_reduce(member.sum(dim=1, keepdim=True, dtype=torch.int32),
                       mesh, axis_name)
    total = all_reduce((member.to(values.dtype) @ values).float(), mesh,
                       axis_name)
    return total / count.clamp(min=1), count[:, 0]
