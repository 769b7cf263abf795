"""Exact fused cosine top-k (counterpart of
``ragraph_tpu/ops/pallas_retrieval.py``).

:func:`fused_cosine_topk` runs kernel C (``csrc/fused_retrieval.cu``) on
CUDA tensors: bf16 scores summed in f32 on the tensor cores, a running
per-query top-k filtered in registers, and no ``(Q, R)`` score matrix in
device memory. On CPU tensors it runs :func:`fused_cosine_topk_plain`. The
two add the same exact bf16 products in different orders, so their scores
agree to a few f32 roundings, not bit for bit.

Contract (both versions): scores ``(Q, k)`` f32 sorted descending and
indices ``(Q, k)`` int32; rows with ``valid_mask`` False never surface;
slots left over when fewer than ``k`` rows are valid hold ``(-3e38, 0)``;
ties go to the lowest index, and equal scores are listed in ascending index
order. (The TPU kernel keeps the same members under ties but lists equal
scores in descending index order.)
"""

from __future__ import annotations

import torch

from ragraph_tpu_torch import native

NEG_INF = -3.0e38
MAX_K = 128   # the running lists live in shared memory
MAX_E = 256
_BR = 128     # keys per tile (csrc/rg_mma.cuh kTileN)
_MAX_SPLITS = 32          # one per lane of the merge launch's warp
_SMEM_BLOCK = 232_448     # shared memory one H100 block may ask for
_SMEM_SM = 233_472        # shared memory of one H100 SM
_SMEM_RESERVED = 1024     # taken by the runtime for each resident block


def fused_cosine_topk_plain(queries: torch.Tensor, keys_n: torch.Tensor,
                            k: int, valid_mask: torch.Tensor | None = None):
    """Plain version of kernel C: f32 matmul of the bf16-cast inputs, the
    ``-3e38`` mask, a stable descending sort cut to ``k``."""
    q = queries.to(torch.bfloat16).float()
    kk = keys_n.to(torch.bfloat16).float()
    scores = q @ kk.T
    if valid_mask is not None:
        scores = torch.where(valid_mask[None, :].bool(), scores, NEG_INF)
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    s, i = s[:, :k], i[:, :k]
    if s.shape[1] < k:  # fewer rows than k
        pad = k - s.shape[1]
        s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
        i = torch.nn.functional.pad(i, (0, pad), value=0)
    i = torch.where(s <= NEG_INF, 0, i)
    return s, i.to(torch.int32)


def _smem_bytes(bq: int, e: int, k: int) -> int:
    """Shared memory of one block of kernel C (``smem_bytes`` in
    ``csrc/fused_retrieval.cu``): the alignment slack, the resident query
    tile and two key tiles in 64-column swizzle atoms of the width padded to
    16, and the ``(bq, k)`` lists."""
    atoms = -(-(-(-e // 16) * 16) // 64)
    return 1024 + (bq + 2 * _BR) * 128 * atoms + 8 * bq * k


def _splits(n_q: int, n_r: int, e: int, k: int,
            sms: int) -> tuple[int, int, int]:
    """Kernel C's tile plan on a card with ``sms`` SMs: ``(queries per
    block, ranges, keys per range)``.

    A block of 128 queries (two warpgroups) shares each key tile where that
    fits shared memory and still gives every SM a block; else 64. R is cut
    into at most 32 ranges of whole 128-key tiles, as many as the SMs hold
    resident beside the query blocks (two blocks of 128 queries or four of
    64 per SM, fewer where shared memory runs out), so the launch is one
    wave."""
    n_tiles = -(-n_r // _BR)
    max_splits = min(_MAX_SPLITS, n_tiles)
    bq = 128 if (_smem_bytes(128, e, k) <= _SMEM_BLOCK
                 and -(-n_q // 128) * max_splits >= sms) else 64
    q_blocks = -(-n_q // bq)
    per_sm = min(256 // bq,
                 _SMEM_SM // (_smem_bytes(bq, e, k) + _SMEM_RESERVED))
    splits = max(1, min(max_splits, per_sm * sms // q_blocks))
    rows_per_split = -(-n_tiles // splits) * _BR
    return bq, -(-n_r // rows_per_split), rows_per_split


def fused_cosine_topk(queries: torch.Tensor, keys_n: torch.Tensor, k: int,
                      valid_mask: torch.Tensor | None = None):
    """Exact top-``k`` of already L2-normalised ``queries (Q, E)`` against
    ``keys_n (R, E)``, both scored in bf16 (see module doc)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"fused_cosine_topk takes 1 <= k <= {MAX_K}, "
                         f"got k={k}")
    if queries.device.type == "cpu":
        return fused_cosine_topk_plain(queries, keys_n, k, valid_mask)
    name = "fused_cosine_topk"
    q = queries.to(torch.bfloat16).contiguous()
    kk = keys_n.to(torch.bfloat16).contiguous()
    n_q, e = q.shape
    n_r = kk.shape[0]
    if kk.dim() != 2 or kk.shape[1] != e:
        raise ValueError(f"{name}: keys {tuple(kk.shape)} do not match "
                         f"queries {tuple(q.shape)}")
    if e % 8 or not 0 < e <= MAX_E:
        raise ValueError(f"{name}: width must be a multiple of 8 and at "
                         f"most {MAX_E}, got {e}")
    for arg, t in (("queries", q), ("keys", kk)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: {arg} on {t.device}, expected "
                             f"{q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    valid = None
    if valid_mask is not None:
        valid = valid_mask.to(device=q.device, dtype=torch.bool).contiguous()
        if valid.shape != (n_r,):
            raise ValueError(f"{name}: valid_mask must be ({n_r},), got "
                             f"{tuple(valid.shape)}")
    if n_r == 0 or n_q == 0:
        return (torch.full((n_q, k), NEG_INF, device=q.device),
                torch.zeros((n_q, k), dtype=torch.int32, device=q.device))
    out_s = torch.empty((n_q, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=q.device)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    bq, splits, rows_per_split = _splits(n_q, n_r, e, k, sms)
    part_s = torch.empty((n_q, splits, k), dtype=torch.float32,
                         device=q.device)
    part_i = torch.empty((n_q, splits, k), dtype=torch.int32,
                         device=q.device)
    bound = torch.empty(n_q, dtype=torch.int32, device=q.device)
    rc = native.lib().rg_fused_cosine_topk(
        q.data_ptr(), kk.data_ptr(),
        valid.data_ptr() if valid is not None else None,
        part_s.data_ptr(), part_i.data_ptr(), bound.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), n_q, n_r, e, k, bq, splits,
        rows_per_split, native.stream_ptr(q))
    native.check(rc, name)
    native.LAUNCHES[name] += 1
    return out_s, out_i
