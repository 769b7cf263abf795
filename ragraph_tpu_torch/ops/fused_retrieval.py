"""Exact fused cosine top-k (counterpart of
``ragraph_tpu/ops/pallas_retrieval.py``).

:func:`fused_cosine_topk` runs kernel C (``csrc/fused_retrieval.cu``) on
CUDA tensors: bf16 scores summed in f32 on the tensor cores, a running
per-query top-k filtered in registers, and no ``(Q, R)`` score matrix in
device memory. On CPU tensors it runs :func:`fused_cosine_topk_plain`. The
two add the same exact bf16 products in different orders, so their scores
agree to a few f32 roundings, not bit for bit.

Any width and any ``k``: rows whose width is not a multiple of 8 are
copied into zero-padded bf16 rows (a zero column adds exactly 0 to every
product), rows wider than 256 are walked in chunks of 128 columns, and a
``k`` above the 128 entries of the kernel's lists takes the selection
family instead (:func:`_select_path`): the ``(Q, R)`` scores of a chunk of
queries by the same tensor-core tile (``score_tile.score_matrix``), then
``select_topk.select_topk`` on them.

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
from ragraph_tpu_torch.ops.score_tile import (
    CHUNK_E, LANE, SMEM_ALIGN, SMEM_RESERVED, SMEM_SM, bf16_rows,
    device_memory, pass_rows, score_matrix)
from ragraph_tpu_torch.ops.select_topk import select_topk

NEG_INF = -3.0e38
MAX_K = 128   # the running lists live in shared memory; a larger k takes
              # the selection family
_MAX_SPLITS = 32          # one per lane of the merge launch's warp
BLOCK_Q = 64              # queries a block of kernel C: one warpgroup
BLOCK_THREADS = 256       # its consumer and producer warpgroups
BLOCKS_PER_SM = 2         # its __launch_bounds__
REGS_SM = 65_536          # 32-bit registers of one H100 SM
WARP_ROWS = 16            # queries of a consumer warp


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


def _stages(e: int) -> int:
    """Stages of kernel C's ring (``ring_stages`` in
    ``csrc/fused_retrieval.cu``): 5 key tiles of rows of at most 64
    values, 2 up to 128, both under a resident query tile; 3 (query, key)
    pairs of 128-column pieces past that."""
    return 5 if e <= 64 else 2 if e <= CHUNK_E else 3


def _tile_bytes(rows: int, w: int) -> int:
    """Bytes of a tile of ``rows`` rows of width ``w``: 64-column swizzle
    atoms of the width padded to 16 (``rg_mma.cuh::tile_bytes``)."""
    return rows * 128 * -(-(-(-w // 16) * 16) // 64)


def _smem_bytes(e: int, k: int) -> int:
    """Shared memory of one block of kernel C (``smem_bytes`` in
    ``csrc/fused_retrieval.cu``): the alignment slack, the resident query
    tile (none past 128 columns), the ring's stages of 128-column pieces,
    the ``(64, k)`` lists in rows of ``k`` rounded up to 4 and two
    mbarriers a stage."""
    w = min(e, CHUNK_E)
    wide = e > CHUNK_E
    stage = (_tile_bytes(BLOCK_Q, w) if wide else 0) + _tile_bytes(LANE, w)
    stages = _stages(e)
    return (SMEM_ALIGN + (0 if wide else _tile_bytes(BLOCK_Q, e))
            + stages * stage + 8 * BLOCK_Q * -(-k // 4) * 4 + 16 * stages)


def _splits(n_q: int, n_r: int, e: int, k: int,
            sms: int) -> tuple[int, int, int]:
    """Kernel C's tile plan on a card with ``sms`` SMs: ``(queries per
    block, ranges, keys per range)``.

    Blocks of 64 queries, two an SM (one where shared memory runs out). R
    is cut into at most 32 ranges of whole 128-key tiles, as many as the
    SMs hold resident beside the query blocks, so that a launch of few
    queries is one wave that reaches every SM. Many queries take one
    range: each query's list climbs through the keys once."""
    n_tiles = -(-n_r // LANE)
    q_blocks = -(-n_q // BLOCK_Q)
    per_sm = min(BLOCKS_PER_SM,
                 SMEM_SM // (_smem_bytes(e, k) + SMEM_RESERVED))
    splits = max(1, min(_MAX_SPLITS, n_tiles, per_sm * sms // q_blocks))
    rows_per_split = -(-n_tiles // splits) * LANE
    return BLOCK_Q, -(-n_r // rows_per_split), rows_per_split


def runs_kernel_c(queries: torch.Tensor, k: int) -> bool:
    """Whether :func:`fused_cosine_topk` answers ``queries`` by kernel C
    itself, which builds no ``(Q, R)`` score matrix: CUDA rows and
    ``k <= MAX_K``. Its plain version and the selection path do build
    one."""
    return queries.device.type == "cuda" and k <= MAX_K


def fused_cosine_topk(queries: torch.Tensor, keys_n: torch.Tensor, k: int,
                      valid_mask: torch.Tensor | None = None):
    """Exact top-``k`` of already L2-normalised ``queries (Q, E)`` against
    ``keys_n (R, E)``, both scored in bf16 (see module doc). Any ``k >= 1``
    and any width."""
    if k < 1:
        raise ValueError(f"fused_cosine_topk takes k >= 1, got k={k}")
    if queries.device.type == "cpu":
        return fused_cosine_topk_plain(queries, keys_n, k, valid_mask)
    name = "fused_cosine_topk"
    if keys_n.dim() != 2 or queries.dim() != 2 \
            or keys_n.shape[1] != queries.shape[1]:
        raise ValueError(f"{name}: keys {tuple(keys_n.shape)} do not match "
                         f"queries {tuple(queries.shape)}")
    q, kk = bf16_rows(queries), bf16_rows(keys_n)
    n_q, e = q.shape
    n_r = kk.shape[0]
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
    if k > MAX_K:
        return _select_path(q, kk, k, valid)
    out_s = torch.empty((n_q, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=q.device)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    bq, splits, rows_per_split = _splits(n_q, n_r, e, k, sms)
    part_s = torch.empty((n_q, splits, k), dtype=torch.float32,
                         device=q.device)
    part_i = torch.empty((n_q, splits, k), dtype=torch.int32,
                         device=q.device)
    # the count of warp-tiles whose vote passed (int64), then the shared
    # bound (Q int32); the kernel's one memset zeroes both
    bound = torch.empty(2 + n_q, dtype=torch.int32, device=q.device)
    rc = native.lib().rg_fused_cosine_topk(
        q.data_ptr(), kk.data_ptr(),
        valid.data_ptr() if valid is not None else None,
        part_s.data_ptr(), part_i.data_ptr(), bound.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), n_q, n_r, e, k, bq, splits,
        rows_per_split, native.stream_ptr(q))
    native.check(rc, name)
    native.LAUNCHES[name] += 1
    # here, not at the top: the train package imports the models, which
    # import this module
    from ragraph_tpu_torch.train.profiling import count
    count("retrieve.c_calls")
    count("retrieve.c_rows", n_q)
    count("retrieve.c_vote_passes", bound[:2].view(torch.int64)[0])
    count("retrieve.c_warp_tiles", -(-n_q // WARP_ROWS) * -(-n_r // LANE))
    return out_s, out_i


def _select_path(q: torch.Tensor, kk: torch.Tensor, k: int,
                 valid: torch.Tensor | None):
    """Kernel C's contract for ``k > MAX_K``: per pass of queries (as many
    as :func:`score_tile.pass_rows` lets their score rows take), the
    scores by the tensor-core tile C uses (bit for bit C's), then the
    selection family on them."""
    n_q, n_r = q.shape[0], kk.shape[0]
    chunk = pass_rows(n_q, 4 * -(-n_r // LANE) * LANE, device_memory(q.device))
    vals, idx = [], []
    for i in range(0, n_q, chunk):
        scores = score_matrix(kk, q[i:i + chunk], valid)
        v, j = select_topk(scores, k, n_r)
        vals.append(v)
        idx.append(j)
        del scores   # before the next pass allocates its own
    return torch.cat(vals), torch.cat(idx)
