"""Exact fused cosine top-k (counterpart of
``ragraph_tpu/ops/pallas_retrieval.py``).

:func:`fused_cosine_topk` runs kernel C (``csrc/fused_retrieval.cu``) on
CUDA tensors: bf16 scores with f32 accumulation, a running per-query top-k,
and no ``(Q, R)`` score matrix in device memory. On CPU tensors it runs
:func:`fused_cosine_topk_plain`.

Contract (both versions): scores ``(Q, k)`` f32 sorted descending and
indices ``(Q, k)`` int32; rows with ``valid_mask`` False never surface;
slots left over when fewer than ``k`` rows are valid hold ``(-3e38, 0)``;
ties go to the lowest index, and equal scores are listed in ascending index
order. (The TPU kernel keeps the same members under ties but lists equal
scores in descending index order.)
"""

from __future__ import annotations

import math

import torch

from ragraph_tpu_torch import native

NEG_INF = -3.0e38
MAX_K = 128   # the running lists live in shared memory
MAX_E = 256
_BQ = 64      # queries per block (csrc/fused_retrieval.cu kBQ)
_BR = 64      # keys per tile (kBR)


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


def _splits(n_q: int, n_r: int, device: torch.device) -> tuple[int, int]:
    """Split R across blocks so that a query chunk fills the card: about
    four resident blocks per SM, at most 32 ranges (one per merge lane)."""
    n_tiles = -(-n_r // _BR)
    q_blocks = -(-n_q // _BQ)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = max(1, min(32, n_tiles, math.ceil(4 * sms / q_blocks)))
    rows_per_split = -(-n_tiles // splits) * _BR
    return -(-n_r // rows_per_split), rows_per_split


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
    splits, rows_per_split = _splits(n_q, n_r, q.device)
    part_s = torch.empty((n_q, splits, k), dtype=torch.float32,
                         device=q.device)
    part_i = torch.empty((n_q, splits, k), dtype=torch.int32,
                         device=q.device)
    rc = native.lib().rg_fused_cosine_topk(
        q.data_ptr(), kk.data_ptr(),
        valid.data_ptr() if valid is not None else None,
        part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr(), n_q, n_r, e, k, splits, rows_per_split,
        native.stream_ptr(q))
    native.check(rc, name)
    native.LAUNCHES[name] += 1
    return out_s, out_i
