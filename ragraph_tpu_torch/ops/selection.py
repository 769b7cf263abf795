"""Exact row-wise k-th-largest selection without a sort (counterpart of
``ragraph_tpu/ops/selection.py``; plain tensor code in both packages).

The huge-k RAG fusion (koubei/taobao ``retrieve_num=100000`` vanilla
configs) needs the k-th largest score of each query row as its membership
threshold (``models/edge/ragraph_edge.py::_fuse_rag``). The floats are
mapped to integer keys of the same order and the k-th key is found by a
radix search from the top bit down, three bits per pass: each pass counts,
for seven candidate thresholds, the row's keys at or above it, and keeps the
largest candidate that still has ``k`` of them. The search converges to the
exact order statistic; nothing is approximated.

Monotonic bijection for finite floats and infinities, as an unsigned
integer: ``u = bits(x); key = sign(u) ? ~u : u | 0x80000000`` (32 bits for
f32, the same form on 16 bits for bf16). NaNs are not ordered and must not
appear (cosine scores are finite).

PyTorch has no arithmetic on unsigned 32- and 16-bit integers, so the public
key functions hold the unsigned values in wider signed integers (int64 for
f32 keys, int32 for bf16 keys), equal to the JAX package's keys as integers.
The search itself compares narrow keys, ``key ^ sign bit`` viewed as int32 /
int16, which have the same order under a signed comparison.

**bf16 tier**: a ``bfloat16`` input runs the same search on 16-bit keys, 6
passes over half-width data instead of 11 over full-width. It is exact on
the bf16 values; the approximation (more ties at the k-th value, so
``x >= kth`` admits slightly more than k members) enters only when the
caller rounds f32 scores to bf16 first, see
``EdgeModelConfig.selection_dtype``.
"""

from __future__ import annotations

import torch


def f32_to_ordered_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving 32-bit keys of f32 values, as int64 in
    ``[0, 2**32)`` (see module doc)."""
    u = x.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(u >> 31 != 0, u ^ 0xFFFFFFFF, u | 0x80000000)


def ordered_key_to_f32(lo: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`f32_to_ordered_key`."""
    back = torch.where(lo >= 0x80000000, lo & 0x7FFFFFFF, lo ^ 0xFFFFFFFF)
    # the unsigned bit pattern as the int32 with the same bits
    back = torch.where(back >= 0x80000000, back - (1 << 32), back)
    return back.to(torch.int32).view(torch.float32)


def bf16_to_ordered_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving 16-bit keys of bf16 values, as int32 in
    ``[0, 2**16)`` (same sign-flip form)."""
    u = x.to(torch.bfloat16).contiguous().view(torch.int16).int() & 0xFFFF
    return torch.where(u >> 15 != 0, u ^ 0xFFFF, u | 0x8000)


def ordered_key_to_bf16(lo: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bf16_to_ordered_key`."""
    back = torch.where(lo >= 0x8000, lo & 0x7FFF, lo ^ 0xFFFF)
    back = torch.where(back >= 0x8000, back - (1 << 16), back)
    return back.to(torch.int16).view(torch.bfloat16)


def _narrow_key(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``ordered key ^ sign bit`` as int16 / int32: the float's bits with the
    magnitude bits flipped where it is negative."""
    if bf16:
        i = x.contiguous().view(torch.int16)
        return torch.where(i < 0, i ^ 0x7FFF, i)
    i = x.float().contiguous().view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def rowwise_kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th largest value of each row of ``x (Q, R)`` as ``(Q, 1)``.

    Equal to ``torch.topk(x, k)[0][:, -1:]`` bit for bit (it is the k-th
    order statistic, so ``x >= kth`` has the sort's members also under
    ties). A ``bfloat16`` input is searched on its 16-bit keys and returns
    bf16; every other dtype is cast to f32 first.

    ``k`` is clamped to ``[1, R]``. NaN inputs are undefined.
    """
    q_len, r_len = x.shape
    k = max(1, min(k, r_len))
    bf16 = x.dtype == torch.bfloat16
    key = _narrow_key(x, bf16)
    half = 1 << (15 if bf16 else 31)           # the keys' sign bit

    def step(lo, shift, width):
        # resolve `width` bits: the largest extension of `lo` that still has
        # at least k keys at or above it
        best = lo
        for j in range(1, 2 ** width):
            cand = lo | (j << shift)
            # int32 counts: the bool reduction is the slower half of a
            # pass, and it is faster into int32 than into int64
            cnt = (key >= (cand - half).to(key.dtype)).sum(
                dim=1, keepdim=True, dtype=torch.int32)
            best = torch.where(cnt >= k, cand, best)
        return best

    # the unsigned candidate key of each row, in int64
    lo = torch.zeros((q_len, 1), dtype=torch.int64, device=x.device)
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
