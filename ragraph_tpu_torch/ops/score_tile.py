"""The Python side of the tensor-core score tile (``csrc/rg_mma.cuh``) that
kernels C, D and F and the score matrix share: the bf16 rows they read,
the shared memory of their ring of tiles, the tile plan of D and the score
matrix, the score matrix itself, and how much scratch one pass of a
large-``k`` path may take.

:func:`score_matrix` is D's tile with every score stored (``rg_score_matrix``
in ``csrc/bucket_topk.cu``): the ``(Q, R)`` scores that kernel C's and the
bucket path's ``k > 128`` selection (:mod:`.select_topk`) reads. On CPU
tensors it runs :func:`score_matrix_plain`, which adds the exact bf16
products in sequence (:func:`fma_chain`); the card sums them on the tensor
cores in another order, so the two agree to a few f32 roundings.
"""

from __future__ import annotations

import functools
import os

import torch

from ragraph_tpu_torch import native
from ragraph_tpu_torch.ops.csr_segment import _check_cuda

NEG_INF = -3.0e38
LANE = 128           # keys per tile, one bucket (rg_mma.cuh kTileN)
RESIDENT_E = 256     # widest row kept whole in a tile (kResidentE)
CHUNK_E = 128        # columns of a chunk of a wider row (kChunkE)
SMEM_BLOCK = 232_448     # shared memory one H100 block may ask for
SMEM_SM = 233_472        # shared memory of one H100 SM
SMEM_RESERVED = 1024     # taken by the runtime for each resident block
SMEM_ALIGN = 1024        # slack for the tiles' alignment (kAlign)
SCRATCH_SHARE = 32   # one pass of a large-k path: its scratch takes at most
                     # this fraction (1/32) of the device's memory


def bf16_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` as contiguous bf16 rows whose width is a multiple of 8 (the
    kernels' 16-byte row loads): one copy into zero-padded rows where the
    width is not, else the usual cast (none for contiguous bf16 rows)."""
    e = x.shape[-1]
    if e % 8 == 0:
        return x.to(torch.bfloat16).contiguous()
    out = x.new_zeros((*x.shape[:-1], -(-e // 8) * 8), dtype=torch.bfloat16)
    out[..., :e] = x
    return out


def ring_bytes(bq: int, e: int) -> int:
    """Bytes of the ring of tiles of kernel D and the score matrix
    for ``bq`` queries at width ``e`` (``ring_bytes`` in ``rg_mma.cuh``):
    tiles in 64-column swizzle atoms of the width padded to 16, the
    resident query tile and two key tiles, or for rows wider than 256 two
    stages of a 128-column query chunk and key chunk."""
    if e > RESIDENT_E:
        return 2 * (bq + LANE) * 128 * (CHUNK_E // 64)
    return (bq + 2 * LANE) * 128 * -(-(-(-e // 16) * 16) // 64)


def fma_chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_c a[..., c] * b[..., c]`` in f32, added in ascending ``c`` into
    one accumulator that starts at 0: the plain versions' order. The inputs
    hold bf16 values, whose products are exact in f32, so a fused and an
    unfused multiply-add give the same bits."""
    a, b = a.float(), b.float()
    acc = torch.zeros(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]),
                      dtype=torch.float32, device=a.device)
    for c in range(a.shape[-1]):
        acc.addcmul_(a[..., c], b[..., c])
    return acc


def valid_u8(valid_mask, n_r: int, device) -> torch.Tensor | None:
    """``valid_mask (R,)`` as a contiguous bool tensor on ``device``."""
    if valid_mask is None:
        return None
    valid = valid_mask.to(device=device, dtype=torch.bool).contiguous()
    if valid.shape != (n_r,):
        raise ValueError(f"valid_mask must be ({n_r},), got "
                         f"{tuple(valid.shape)}")
    return valid


def check_qk(name: str, queries: torch.Tensor, keys: torch.Tensor):
    """The bf16 ``(Q, E)`` / ``(R, E)`` pair that the tile takes, returned
    as rows padded to a multiple of 8 (a copy only where ``E`` is not
    one)."""
    _check_cuda(name, queries=(queries, torch.bfloat16, 2),
                keys=(keys, torch.bfloat16, 2))
    if keys.shape[1] != queries.shape[1] or queries.shape[1] == 0:
        raise ValueError(f"{name}: keys {tuple(keys.shape)} do not match "
                         f"queries {tuple(queries.shape)}")
    return bf16_rows(queries), bf16_rows(keys)


@functools.lru_cache(maxsize=None)
def sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def device_memory(device: torch.device) -> int:
    """Bytes of memory of ``device``: the card's, or the host's for the
    CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def pass_rows(n: int, row_bytes: int, total_memory: int) -> int:
    """Rows one pass of a large-``k`` path takes when its scratch holds
    ``row_bytes`` a row: at most ``1/SCRATCH_SHARE`` of ``total_memory``
    (2.5 GB of 80 GB: 2,384 rows of the score matrix at R = 262,144), at
    least one, at most ``n``."""
    return max(1, min(n, total_memory // SCRATCH_SHARE // row_bytes))


def tile_plan(n_q: int, n_r: int, e: int, n_sms: int) -> tuple[int, int, int]:
    """The tile plan of kernel D and of the score matrix on a card with
    ``n_sms`` SMs: ``(queries per block, ranges, buckets per range)``.

    A block of 128 queries (two warpgroups) shares each bucket's key tile
    where that still gives every SM a block, else 64. The buckets are cut
    into as many ranges as the SMs hold resident beside the query blocks
    (two blocks of 128 queries or four of 64 per SM, fewer where shared
    memory runs out), so the launch is one wave."""
    nb = -(-n_r // LANE)
    bq = 128 if -(-n_q // 128) * nb >= n_sms else 64
    per_sm = min(256 // bq, SMEM_SM // (SMEM_ALIGN + ring_bytes(bq, e)
                                        + SMEM_RESERVED))
    ranges = max(1, min(nb, per_sm * n_sms // -(-n_q // bq)))
    per_range = -(-nb // ranges)
    return bq, -(-nb // per_range), per_range


def score_matrix_plain(keys: torch.Tensor, queries: torch.Tensor,
                       valid_mask: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Plain version of the score matrix: the ``(Q, R)`` scores by
    :func:`fma_chain`, ``-3e38`` for an invalid key and in the columns
    from ``R`` to the end of the last bucket."""
    n_r, n_q = keys.shape[0], queries.shape[0]
    scores = fma_chain(queries.to(torch.bfloat16)[:, None, :],
                       keys.to(torch.bfloat16)[None, :, :])
    if valid_mask is not None:
        scores = torch.where(valid_mask.bool()[None, :], scores, NEG_INF)
    pad = -(-n_r // LANE) * LANE - n_r
    return torch.cat([scores, scores.new_full((n_q, pad), NEG_INF)], 1)


def score_matrix(keys: torch.Tensor, queries: torch.Tensor,
                 valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Scores ``(Q, ceil(R/128)*128)`` f32 of bf16 ``queries (Q, E)``
    against bf16 ``keys (R, E)`` by kernel D's tile, every score stored
    (bitwise D's, F's and kernel C's at the same width): ``-3e38`` for an
    invalid key and from column ``R`` on."""
    if keys.device.type == "cpu":
        return score_matrix_plain(keys, queries, valid_mask)
    name = "score_matrix"
    queries, keys = check_qk(name, queries, keys)
    n_r, n_q = keys.shape[0], queries.shape[0]
    valid = valid_u8(valid_mask, n_r, keys.device)
    out = torch.empty((n_q, -(-n_r // LANE) * LANE), dtype=torch.float32,
                      device=keys.device)
    if n_r == 0 or n_q == 0:
        return out.fill_(NEG_INF)
    bq, _, per_range = tile_plan(n_q, n_r, keys.shape[1], sms(keys.device))
    rc = native.lib().rg_score_matrix(
        keys.data_ptr(), queries.data_ptr(),
        valid.data_ptr() if valid is not None else None, out.data_ptr(),
        n_r, n_q, keys.shape[1], bq, per_range, native.stream_ptr(keys))
    native.check(rc, name)
    native.LAUNCHES[name] += 1
    return out
