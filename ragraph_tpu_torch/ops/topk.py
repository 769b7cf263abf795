"""Cosine-scored top-k retrieval (counterpart of ``ragraph_tpu/ops/topk.py``).

Dispatch follows the JAX package:

- ``"exact"``: f32 matmul, ``-inf`` for invalid rows, ``torch.topk``;
- ``"pallas"``: the exact fused kernel (:mod:`.fused_retrieval`);
- ``"bucket"``: the two-phase exact kernels (:mod:`.bucket_topk`);
- ``"approx"``: on the TPU ``lax.approx_max_k``, a TPU PartialReduce with no
  GPU counterpart; here it answers exactly through the fused kernel;
- ``"auto"``: exact below :data:`AUTO_APPROX_THRESHOLD` rows, above it
  ``"bucket"`` when ``recall_target >= 1`` and ``"approx"`` otherwise.

``score_dtype="int8"`` scores symmetric int8 quantizations of the normalised
rows (:func:`_int8_topk`), optionally followed by an exact rescore of
``k + rescore_pad`` candidates.
"""

from __future__ import annotations

import torch

from ragraph_tpu_torch.ops.bucket_topk import bucketed_exact_topk
from ragraph_tpu_torch.ops.fused_retrieval import (fused_cosine_topk,
                                                   runs_kernel_c)
from ragraph_tpu_torch.ops.similarity import l2_normalize

# Library size above which "auto" leaves the exact sort.
AUTO_APPROX_THRESHOLD = 32_768

# Widest slice whose int8 dot products, summed in f32, are still exact
# integers: 127 * 127 * E < 2**24. Wider rows are scored a slice at a time.
INT8_SLICE_E = 1040


def _quantize_i8(x: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantization of L2-normalised rows (scale 127)."""
    return torch.clamp(torch.round(x.float() * 127.0),
                       -127, 127).to(torch.int8)


def quantize_keys_i8(keys: torch.Tensor,
                     normalized: bool = False) -> torch.Tensor:
    """Pre-quantize a key table for ``cosine_topk(score_dtype="int8")``.

    Quantizing the ``(R, E)`` table is a full pass over it, so serving
    quantizes once per library build and passes the int8 table as ``keys``.
    """
    return _quantize_i8(keys if normalized else l2_normalize(keys))


def cosine_topk(queries: torch.Tensor, keys: torch.Tensor, k: int,
                valid_mask: torch.Tensor | None = None,
                queries_normalized: bool = False,
                keys_normalized: bool = False,
                method: str = "auto",
                recall_target: float = 0.99,
                score_dtype: str = "input",
                rescore_pad: int = 0,
                rescore_keys: torch.Tensor | None = None,
                chunk: int | None = None):
    """Top-k cosine ``(scores, indices)`` of ``queries (Q, E)`` against
    ``keys (R, E)``, each ``(Q, k)`` (see module doc for ``method``).

    ``score_dtype="int8"`` is only valid with ``"approx"`` or ``"exact"``
    (the others promise exact bf16 scores). ``keys`` may then be a table
    from :func:`quantize_keys_i8`. ``rescore_pad > 0`` fetches
    ``k + rescore_pad`` candidates by their int8 scores, rescores them at
    full precision and returns the true top-k of that set; with an int8
    ``keys`` table the full-precision rows come from ``rescore_keys``
    (same rows; normalised iff ``keys_normalized``). Without a rescore the
    scores are the quantized approximations.

    ``chunk`` bounds the query rows of one pass on every path that builds
    a ``(Q, R)`` score matrix: the exact sort, int8 scoring, the bucket
    tier, and kernel C's plain version or its ``k > MAX_K`` path. Kernel C
    itself builds none and takes all the queries in one launch, so each
    query's top-k list climbs through the keys once.
    """
    q = queries if queries_normalized else l2_normalize(queries)
    if rescore_keys is not None and (keys.dtype != torch.int8
                                     or not rescore_pad):
        raise ValueError("rescore_keys is only meaningful with "
                         "pre-quantized int8 keys and rescore_pad > 0")
    if keys.dtype == torch.int8:
        # pre-quantized table from quantize_keys_i8 (already normalised)
        if score_dtype != "int8":
            raise ValueError("int8 keys require score_dtype='int8'")
        if rescore_pad and rescore_keys is None:
            raise ValueError("rescore_pad needs full-precision rows; "
                             "pass the float table as rescore_keys (or "
                             "pass float keys to quantize per call)")
        kk = keys
    else:
        kk = keys if keys_normalized else l2_normalize(keys)
    if rescore_keys is not None and not keys_normalized:
        rescore_keys = l2_normalize(rescore_keys)
    if method == "auto":
        if keys.shape[0] < AUTO_APPROX_THRESHOLD:
            method = "exact"
        elif recall_target >= 1.0:
            method = "bucket"
        else:
            method = "approx"
    if score_dtype == "int8":
        if method not in ("approx", "exact"):
            raise ValueError(
                f"score_dtype='int8' breaks method={method!r}'s exact-"
                "score contract; use method='approx' or 'exact'")
    else:
        if score_dtype != "input":
            raise ValueError(f"unknown score_dtype {score_dtype!r}")
        if rescore_pad:
            raise ValueError("rescore_pad is only meaningful with "
                             "score_dtype='int8'")
        if method not in ("bucket", "pallas", "approx", "exact"):
            raise ValueError(f"unknown method {method!r}")
    fused = score_dtype == "input" and method in ("pallas", "approx")
    n_q = q.shape[0]
    if chunk is None or n_q <= chunk or (fused and runs_kernel_c(q, k)):
        return _one_pass(q, kk, k, valid_mask, method, score_dtype,
                         rescore_pad, rescore_keys)
    if fused:
        kk = kk.to(torch.bfloat16)   # once, not once a pass
    parts = [_one_pass(q[s:s + chunk], kk, k, valid_mask, method,
                       score_dtype, rescore_pad, rescore_keys)
             for s in range(0, n_q, chunk)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def _one_pass(q, kk, k, valid_mask, method, score_dtype, rescore_pad,
              rescore_keys):
    """:func:`cosine_topk` of normalised queries ``q`` against ``kk`` by a
    resolved ``method``, in one call of its path."""
    if score_dtype == "int8":
        return _int8_topk(q, kk, k, valid_mask, rescore_pad, rescore_keys)
    if method == "bucket":
        return bucketed_exact_topk(q, kk, k, valid_mask=valid_mask)
    if method in ("pallas", "approx"):
        return fused_cosine_topk(q, kk, k, valid_mask=valid_mask)
    scores = q.float() @ kk.float().T
    if valid_mask is not None:
        scores = torch.where(valid_mask[None, :].bool(), scores, -torch.inf)
    return torch.topk(scores, k, dim=1)


def _int8_topk(q: torch.Tensor, kk: torch.Tensor, k: int, valid_mask,
               rescore_pad: int, rescore_keys: torch.Tensor | None = None):
    """Int8-scored top-k, with an optional exact rescore of the candidates.

    ``q`` / ``kk`` are already L2-normalised (``kk`` may be int8 already).
    The s8 x s8 -> s32 product of the JAX package is :func:`_int8_dot`
    here. Both ``"approx"`` and ``"exact"`` take an exact ``torch.topk`` of
    the int8 scores (the TPU's approximate top-k has no GPU counterpart), so
    the caller's method and recall target change nothing here.
    """
    ki = kk if kk.dtype == torch.int8 else _quantize_i8(kk)
    scores = _int8_dot(_quantize_i8(q), ki) * (1.0 / (127.0 * 127.0))
    if valid_mask is not None:
        scores = torch.where(valid_mask[None, :].bool(), scores, -torch.inf)
    if not rescore_pad:
        return torch.topk(scores, k, dim=1)
    kc = min(k + rescore_pad, kk.shape[0])   # small libraries
    cand = torch.topk(scores, kc, dim=1).indices
    rows = (kk if rescore_keys is None else rescore_keys)[cand]  # (Q, kc, E)
    sc = (q.to(rows.dtype).float()[:, None, :] * rows.float()).sum(dim=-1)
    if valid_mask is not None:
        # candidates are only invalid when a query has < kc valid rows
        sc = torch.where(valid_mask.bool()[cand], sc, -torch.inf)
    vals, pos = torch.topk(sc, k, dim=1)
    return vals, torch.gather(cand, 1, pos)


def _int8_dot(qi: torch.Tensor, ki: torch.Tensor) -> torch.Tensor:
    """The s32 products ``qi @ ki.T`` of two int8 tables, as f32 (the JAX
    package's ``s32.astype(f32)``): f32 matmuls of slices of at most
    ``INT8_SLICE_E`` columns, each an exact integer, added in int32 where
    there is more than one slice."""
    e = qi.shape[1]
    if e <= INT8_SLICE_E:
        return qi.float() @ ki.float().T
    acc = None
    for c in range(0, e, INT8_SLICE_E):
        part = (qi[:, c:c + INT8_SLICE_E].float()
                @ ki[:, c:c + INT8_SLICE_E].float().T).to(torch.int32)
        acc = part if acc is None else acc.add_(part)
    return acc.float()


def topk_gather(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Gather library rows per query: ``(R, E)[(Q, k)] -> (Q, k, E)``."""
    return values[indices.long()]
