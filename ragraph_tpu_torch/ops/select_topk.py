"""The selection family: an exact top-``k`` of each row for any ``k``.

Kernels C, E and G keep their running lists in shared memory or in a
warp's registers, at most 128 entries. For a larger ``k`` their wrappers
(:func:`ragraph_tpu_torch.ops.fused_retrieval.fused_cosine_topk`,
:func:`ragraph_tpu_torch.ops.bucket_topk.column_topk` and ``row_topk``)
route here: :func:`select_topk` runs ``csrc/select_topk.cu`` on CUDA
tensors, one block a row (a radix select of the ``k``-th value, a
compaction of the members, a bitonic sort of them), and its plain version
on CPU tensors.

Contract (both versions): ``(vals (n_rows, k) f32, idx (n_rows, k)
int32)``, value descending, ties to the lowest column; a slot whose value
is not above ``-3e38`` and a slot past the row's width hold ``(-3e38, 0)``.
"""

from __future__ import annotations

import torch

from ragraph_tpu_torch import native

NEG_INF = -3.0e38
SMEM_SORT = 16_384   # members a block sorts in shared memory; more go to a
                     # global scratch row (csrc/select_topk.cu kSmemSort)


def select_topk_plain(x: torch.Tensor, k: int):
    """Plain version of the selection family: a stable descending sort cut
    to ``k``, padded, and ``(-3e38, 0)`` wherever the value is not above
    ``-3e38``."""
    s, i = torch.sort(x.float(), dim=1, descending=True, stable=True)
    s, i = s[:, :k], i[:, :k]
    pad = k - s.shape[1]
    if pad:
        s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
        i = torch.nn.functional.pad(i, (0, pad), value=0)
    dead = ~(s > NEG_INF)
    return (torch.where(dead, NEG_INF, s),
            torch.where(dead, 0, i).to(torch.int32))


def sort_width(n: int, k: int) -> int:
    """Entries a row's sort takes: the least power of two at or above its
    ``min(k, n)`` members."""
    return 1 << (min(k, n) - 1).bit_length()


def select_topk(x: torch.Tensor, k: int, n: int | None = None):
    """Exact top-``k`` of the first ``n`` columns (all by default) of each
    row of ``x (n_rows, ld)`` (see module doc). Any ``k >= 1``."""
    if k < 1:
        raise ValueError(f"select_topk takes k >= 1, got k={k}")
    n = x.shape[1] if n is None else n
    if x.device.type == "cpu":
        return select_topk_plain(x[:, :n], k)
    name = "select_topk"
    x = x.float()
    if x.dim() != 2 or x.stride(1) != 1 or not 1 <= n <= x.shape[1]:
        raise ValueError(f"{name}: takes rows of unit stride and 1 <= n <= "
                         f"{x.shape[1] if x.dim() == 2 else '?'}, got shape "
                         f"{tuple(x.shape)}, n={n}")
    n_rows = x.shape[0]
    vals = torch.empty((n_rows, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((n_rows, k), dtype=torch.int32, device=x.device)
    if n_rows == 0:
        return vals, idx
    p = sort_width(n, k)
    scratch = None
    if p > SMEM_SORT:
        scratch = torch.empty((n_rows, p), dtype=torch.int64,
                              device=x.device)
    rc = native.lib().rg_select_topk(
        x.data_ptr(), x.stride(0), n_rows, n, k, p,
        scratch.data_ptr() if scratch is not None else None,
        vals.data_ptr(), idx.data_ptr(), native.stream_ptr(x))
    native.check(rc, name)
    native.LAUNCHES[name] += 1
    return vals, idx
