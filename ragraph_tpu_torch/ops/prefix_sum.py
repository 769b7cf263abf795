"""Prefix sums over rows and the sorted segment sum built on them
(counterpart of ``streaming_cumsum``, ``sorted_segment_sum_indptr`` and
``sorted_segment_sum`` of ``ragraph_tpu/ops/pallas_segment.py``).

:func:`prefix_sum` is kernel H on CUDA tensors (``csrc/prefix_sum.cu``) and
:func:`prefix_sum_plain` on CPU tensors: the inclusive or exclusive prefix
over axis 0 of an f32 or bf16 ``(N, D)`` matrix, summed and returned in f32,
with the ``(1, D)`` grand total. Kernel H reads the input once: tiles of
rows and column slabs pass their carry on through device memory in three
levels (tiles, groups, supergroups), in an order fixed by the shape, so two
calls give the same bits. The kernel's source owns its tiles and the layout
of its scratch; the wrapper asks it for the scratch's size.

:func:`sorted_segment_sum_indptr` keeps the JAX package's definition: the
exclusive prefix read at the CSR bounds and differenced. The difference
cancels large partial sums, so its absolute error follows the size of the
prefix, not of the segment's sum (about 1e-3 relative on long segments, as
the JAX docstring says). ``ops/csr_segment.py`` sums each segment directly
(kernel B) and is the accurate route; the models use that one.
"""

from __future__ import annotations

import torch

from ragraph_tpu_torch import native


def prefix_sum_plain(x: torch.Tensor, exclusive: bool = False):
    """Plain version of kernel H: ``(prefix, total)`` in f32. The exclusive
    prefix is the inclusive one shifted down a row."""
    xf = x.float()
    incl = torch.cumsum(xf, dim=0)
    total = (incl[-1:] if len(xf) else
             torch.zeros(1, xf.shape[1], dtype=torch.float32,
                         device=x.device))
    if exclusive:
        incl = torch.cat([torch.zeros_like(incl[:1]), incl[:-1]])
    return incl, total


def prefix_sum(x: torch.Tensor, exclusive: bool = False):
    """``(prefix, total)`` of an ``(N, D)`` f32 or bf16 matrix over axis 0:
    ``prefix`` is ``(N, D)`` f32, ``total`` ``(1, D)`` f32. Kernel H on CUDA
    tensors, its plain version on CPU tensors."""
    if x.dim() != 2:
        raise ValueError(f"prefix_sum: x must be 2-d, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return prefix_sum_plain(x, exclusive)
    name = "prefix_sum"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x is on {x.device}, not CUDA")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    n, d = x.shape
    if d < 1 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous with at least one "
                         f"column, got shape {tuple(x.shape)}")
    out = torch.empty(n, d, dtype=torch.float32, device=x.device)
    if n == 0:
        return out, torch.zeros(1, d, dtype=torch.float32, device=x.device)
    lib = native.lib()
    words = lib.rg_prefix_sum_scratch_words(n, d)
    if words < 0:
        raise ValueError(f"{name}: {n} x {d} takes more tiles than a grid's "
                         f"2^31 - 1 blocks")
    total = torch.empty(1, d, dtype=torch.float32, device=x.device)
    scratch = torch.empty(words, dtype=torch.int32, device=x.device)
    rc = lib.rg_prefix_sum(
        x.data_ptr(), out.data_ptr(), total.data_ptr(), scratch.data_ptr(),
        n, d, int(exclusive), int(x.dtype == torch.bfloat16),
        native.stream_ptr(x))
    native.check(rc, name)
    native.LAUNCHES[name] += 1
    return out, total


def streaming_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over axis 0 (f32 out)."""
    return prefix_sum(x, exclusive=False)[0]


def boundary_diff_excl(excl: torch.Tensor, total: torch.Tensor,
                       indptr: torch.Tensor, n: int) -> torch.Tensor:
    """Per-segment sums from the exclusive prefix and the grand total: the
    bound at position ``n`` (the end of the last segment) reads the total,
    every other bound reads ``excl``; an empty segment gives exactly 0."""
    if n == 0:
        return torch.zeros(len(indptr) - 1, excl.shape[1],
                           dtype=torch.float32, device=excl.device)
    ip = indptr.long()
    g = excl[torch.clamp(ip, max=n - 1)]
    g = torch.where((ip == n)[:, None], total[0], g)
    return g[1:] - g[:-1]


def sorted_segment_sum_indptr(msgs: torch.Tensor,
                              indptr: torch.Tensor) -> torch.Tensor:
    """Segment sum of ``msgs`` (``(E, D)``, rows grouped by segment in
    order) over the CSR bounds ``indptr`` (``(N+1,)``; empty segments
    allowed), by the prefix difference. Returns ``(N, D)`` f32."""
    excl, total = prefix_sum(msgs, exclusive=True)
    return boundary_diff_excl(excl, total, indptr, msgs.shape[0])


def sorted_segment_sum(msgs: torch.Tensor, starts: torch.Tensor,
                       ends: torch.Tensor) -> torch.Tensor:
    """The starts/ends form of :func:`sorted_segment_sum_indptr`, for
    contiguous CSR (``ends[i] == starts[i + 1]``)."""
    return sorted_segment_sum_indptr(msgs, torch.cat([starts, ends[-1:]]))
