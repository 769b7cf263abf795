"""Two-phase exact top-k: a sweep of bucket maxima, then a rescore of the
candidates (counterpart of ``ragraph_tpu/ops/bucket_topk.py``).

**Phase 1 (kernel D)**: the scores of every query against every key, bf16
inputs and f32 sums, reduced at once to the maximum of each bucket of 128
consecutive keys. The ``(Q, R)`` scores are never stored; the result is
``(R/128, Q)``. Its tile plan is ``score_tile.tile_plan``.

**Glue (kernel E, then PyTorch)**: each query's ``k`` best buckets. The
``k`` largest bucket maxima are ``k`` distinct keys, so the ``k``-th largest
score is at least the ``k``-th largest bucket maximum ``t``; every key of the
true top-``k`` scores at least ``t`` and so does its bucket's maximum: **the
true top-k all lie in the top-k buckets ranked by their maximum** (under
exact score ties a key of a dropped bucket with an equal score may be
swapped in, which changes indices and never the scores). The ``Q*k``
(query, bucket) pairs are then inverted into per-bucket query lists by a
stable sort on the bucket id.

**Phase 2 (kernel F)**: exact scores of each bucket's listed queries against
its 128 keys, ``(R/128, p_max, 128)`` panels, ``p_max`` queries per bucket
a launch. Where more queries want one bucket (identical queries, say), the
further ones take further launches of F, ``p_max`` more per bucket each;
how many follows from the largest demand, which costs one host read per
call.

**Phase 3 (PyTorch, then kernel G)**: the panels are scattered into a
``(Q, k*128)`` candidate matrix and kernel G takes each row's top-``k``; a
candidate's key index follows from its bucket id and lane.

The scores are those of ``topk(q.bf16 @ keys.bf16.T)`` with f32 sums, and
the tier is exact because every score of phase 2 is bitwise the score that
phase 1 took the maximum of. On the card kernels D and F sum the exact
bf16 products on the tensor cores, in one order for both
(``csrc/rg_mma.cuh``, the tile kernel C uses too). The plain versions below
add them in sequence (``score_tile.fma_chain``), the same order in D's and F's,
and so differ from the card's scores by a few f32 roundings.

Each kernel has a plain PyTorch version here (``*_plain``). A wrapper runs
it only for tensors on the CPU; for CUDA tensors it launches the kernel
(``csrc/bucket_topk.cu``) or raises.

Any width and any ``k``: D and F take rows padded with zero columns to a
multiple of 8 (``score_tile.bf16_rows``) and walk rows wider than 256 in
chunks of 128 columns, in one order for both; E and G take ``k`` up to
their 128-entry warp lists and route a larger ``k`` to the selection
family (:mod:`.select_topk`), so the path selects ``k`` of ``k`` buckets'
``k * 128`` candidates for every ``k``.
"""

from __future__ import annotations

import torch

from ragraph_tpu_torch import native
from ragraph_tpu_torch.ops.csr_segment import _check_cuda
from ragraph_tpu_torch.ops.score_tile import (
    LANE, bf16_rows, check_qk, device_memory, fma_chain, pass_rows, sms,
    tile_plan, valid_u8)
from ragraph_tpu_torch.ops.select_topk import select_topk

NEG_INF = -3.0e38
MAX_K = 128   # kernels E and G hold at most 128 entries a warp; a larger k
              # takes the selection family
_Q_CHUNK = 4096   # queries per pass; the p_max capacity is per pass


def _check_k(name: str, k: int) -> None:
    if k < 1:
        raise ValueError(f"{name} takes k >= 1, got k={k}")


def _check_nonempty(name: str, what: str, x: torch.Tensor, dim: int) -> None:
    if x.dim() == 2 and x.shape[dim] == 0:
        raise ValueError(f"{name} takes at least one {what}, got "
                         f"{tuple(x.shape)}")


# ---- phase 1: kernel D ------------------------------------------------------

def bucket_max_plain(keys: torch.Tensor, queries: torch.Tensor,
                     valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of kernel D: the ``(R, Q)`` scores in full (by
    ``score_tile.fma_chain``), invalid
    rows and the last bucket's padding at ``-3e38``, then the maximum over
    each group of 128 rows."""
    n_r, n_q = keys.shape[0], queries.shape[0]
    nb = -(-n_r // LANE)
    scores = fma_chain(keys.to(torch.bfloat16)[:, None, :],
                        queries.to(torch.bfloat16)[None, :, :])
    if valid_mask is not None:
        scores = torch.where(valid_mask.bool()[:, None], scores, NEG_INF)
    pad = nb * LANE - n_r
    if pad:
        scores = torch.cat([scores, scores.new_full((pad, n_q), NEG_INF)])
    return scores.view(nb, LANE, n_q).amax(dim=1)


def bucket_max(keys: torch.Tensor, queries: torch.Tensor,
               valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Bucket maxima ``(ceil(R/128), Q)`` f32 of bf16 ``keys (R, E)`` against
    bf16 ``queries (Q, E)``; a bucket without a valid key holds ``-3e38``."""
    if keys.device.type == "cpu":
        return bucket_max_plain(keys, queries, valid_mask)
    name = "bucket_max"
    queries, keys = check_qk(name, queries, keys)
    n_r, n_q = keys.shape[0], queries.shape[0]
    valid = valid_u8(valid_mask, n_r, keys.device)
    out = torch.empty((-(-n_r // LANE), n_q), dtype=torch.float32,
                      device=keys.device)
    if out.numel() == 0:
        return out
    bq, _, per_range = tile_plan(n_q, n_r, keys.shape[1], sms(keys.device))
    rc = native.lib().rg_bucket_max(
        keys.data_ptr(), queries.data_ptr(),
        valid.data_ptr() if valid is not None else None, out.data_ptr(),
        n_r, n_q, keys.shape[1], bq, per_range, native.stream_ptr(keys))
    native.check(rc, name)
    native.LAUNCHES[name] += 1
    return out


# ---- kernels E and G: top-k by k extractions --------------------------------

def row_topk_plain(x: torch.Tensor, k: int):
    """Plain version of kernel G: ``k`` rounds of (row maximum, lowest
    column that reaches it, strike that column to ``-3e38``)."""
    x = x.float().clone()
    col = torch.arange(x.shape[1], device=x.device)[None, :]
    vals, idxs = [], []
    for _ in range(k):
        cur = x.amax(dim=1, keepdim=True)
        pos = torch.where(x >= cur, col, 2 ** 30).amin(dim=1, keepdim=True)
        vals.append(cur)
        idxs.append(pos)
        x = torch.where(col == pos, NEG_INF, x)
    return torch.cat(vals, dim=1), torch.cat(idxs, dim=1).to(torch.int32)


def column_topk_plain(x: torch.Tensor, k: int):
    """Plain version of kernel E: :func:`row_topk_plain` of the transpose."""
    return row_topk_plain(x.T, k)


def iterative_topk(x: torch.Tensor, k: int):
    """Exact top-``k`` over axis 1 of ``x (Q, W)`` by ``k`` arg-max
    extractions in plain PyTorch; ties go to the lowest index."""
    x = x.clone()
    col = torch.arange(x.shape[1], device=x.device)[None, :]
    vals, idxs = [], []
    for _ in range(k):
        pos = x.argmax(dim=1, keepdim=True)
        vals.append(torch.gather(x, 1, pos))
        idxs.append(pos)
        x = torch.where(col == pos, NEG_INF, x)
    return torch.cat(vals, dim=1), torch.cat(idxs, dim=1).to(torch.int32)


def _topk_outputs(n_q: int, k: int, device):
    return (torch.empty((n_q, k), dtype=torch.float32, device=device),
            torch.empty((n_q, k), dtype=torch.int32, device=device))


def _list_cap(k: int) -> int:
    """The list length of kernels E and G for ``k``: one list of 32, 64 or
    128 entries a warp."""
    return next(c for c in (32, 64, 128) if k <= c)


def _column_topk_plan(k: int) -> tuple[int, int]:
    """Kernel E's plan: ``(kcap, cols)``. A block takes ``cols`` = 8
    columns, one warp each (the only width the kernel is built for; it
    rejects any other), so a refresh chunk's 2,048 columns give 256 blocks,
    two for each of an H100's 132 SMs."""
    return _list_cap(k), 8


def _row_topk_plan(n_q: int, k: int, sms: int) -> tuple[int, int]:
    """Kernel G's plan: ``(kcap, warps)``, one row a warp, four warps a
    block unless that leaves SMs without a block."""
    warps = 4
    while warps > 1 and -(-n_q // warps) < sms:
        warps //= 2
    return _list_cap(k), warps


def column_topk(x: torch.Tensor, k: int):
    """Exact top-``k`` over axis 0 of every column of ``x (R, Q)``.

    Returns ``(vals (Q, k) f32, idx (Q, k) int32)`` sorted descending, ties
    to the lowest row; once a column has nothing above ``-3e38`` left its
    slots hold ``(-3e38, 0)``. Values must be at least ``-3e38``. On the
    card a ``k`` above ``MAX_K`` takes the selection family on the
    transpose.
    """
    _check_k("column_topk", k)
    _check_nonempty("column_topk", "row", x, 0)
    if x.device.type == "cpu":
        return column_topk_plain(x, k)
    name = "column_topk"
    x = x.float().contiguous()
    _check_cuda(name, x=(x, torch.float32, 2))
    if k > MAX_K:
        return select_topk(x.T.contiguous(), k)
    n_r, n_q = x.shape
    vals, idx = _topk_outputs(n_q, k, x.device)
    if n_q == 0:
        return vals, idx
    rc = native.lib().rg_column_topk(x.data_ptr(), vals.data_ptr(),
                                     idx.data_ptr(), n_r, n_q, k,
                                     *_column_topk_plan(k),
                                     native.stream_ptr(x))
    native.check(rc, name)
    native.LAUNCHES[name] += 1
    return vals, idx


def row_topk(x: torch.Tensor, k: int):
    """Exact top-``k`` over axis 1 of ``x (Q, W)``: the contract of
    :func:`column_topk` along rows, ties to the lowest column; on the card
    a ``k`` above ``MAX_K`` takes the selection family."""
    _check_k("row_topk", k)
    _check_nonempty("row_topk", "column", x, 1)
    if x.device.type == "cpu":
        return row_topk_plain(x, k)
    name = "row_topk"
    x = x.float().contiguous()
    _check_cuda(name, x=(x, torch.float32, 2))
    if k > MAX_K:
        return select_topk(x, k)
    n_q, w = x.shape
    vals, idx = _topk_outputs(n_q, k, x.device)
    if n_q == 0:
        return vals, idx
    rc = native.lib().rg_row_topk(x.data_ptr(), vals.data_ptr(),
                                  idx.data_ptr(), n_q, w, k,
                                  *_row_topk_plan(n_q, k, sms(x.device)),
                                  native.stream_ptr(x))
    native.check(rc, name)
    native.LAUNCHES[name] += 1
    return vals, idx


# ---- phase 2: kernel F ------------------------------------------------------

def bucket_rescore_plain(assign: torch.Tensor, queries: torch.Tensor,
                         keys: torch.Tensor,
                         valid_mask: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Plain version of kernel F: gather each slot's query row (zeros for an
    empty slot) and each bucket's keys, score, mask."""
    nb, p_max = assign.shape
    n_q, e = queries.shape
    n_r = keys.shape[0]
    q = torch.cat([queries.to(torch.bfloat16),
                   queries.new_zeros((1, e), dtype=torch.bfloat16)])
    ids = assign.long()
    ids = torch.where((ids >= 0) & (ids < n_q), ids, n_q)
    rows = torch.arange(nb * LANE, device=keys.device)
    live = rows < n_r
    if valid_mask is not None:
        live = live & valid_mask.bool()[rows.clamp(max=n_r - 1)]
    kb = keys.to(torch.bfloat16)[rows.clamp(max=n_r - 1)].view(nb, LANE, e)
    sc = fma_chain(q[ids][:, :, None, :], kb[:, None, :, :])
    return torch.where(live.view(nb, 1, LANE), sc, NEG_INF)


def bucket_rescore(assign: torch.Tensor, queries: torch.Tensor,
                   keys: torch.Tensor,
                   valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Score panels ``(nb, P, 128)`` f32: slot ``p`` of bucket ``b`` holds
    the scores of query ``assign[b, p]`` against the bucket's 128 keys. An
    id outside ``[0, Q)`` marks an empty slot, which holds 0; an invalid key
    (or one past ``R`` in the last bucket) holds ``-3e38`` in every slot."""
    if keys.device.type == "cpu":
        return bucket_rescore_plain(assign, queries, keys, valid_mask)
    name = "bucket_rescore"
    queries, keys = check_qk(name, queries, keys)
    _check_cuda(name, assign=(assign, torch.int32, 2))
    nb, p_max = assign.shape
    n_r, e = keys.shape
    if assign.device != keys.device:
        raise ValueError(f"{name}: assign is on {assign.device}, not "
                         f"{keys.device}")
    if nb != -(-n_r // LANE):
        raise ValueError(f"{name}: assign has {nb} buckets, the keys have "
                         f"{-(-n_r // LANE)}")
    valid = valid_u8(valid_mask, n_r, keys.device)
    out = torch.empty((nb, p_max, LANE), dtype=torch.float32,
                      device=keys.device)
    if out.numel() == 0:
        return out
    rc = native.lib().rg_bucket_rescore(
        assign.data_ptr(), queries.data_ptr(), keys.data_ptr(),
        valid.data_ptr() if valid is not None else None, out.data_ptr(),
        nb, p_max, queries.shape[0], n_r, e, native.stream_ptr(keys))
    native.check(rc, name)
    native.LAUNCHES[name] += 1
    return out


# ---- the glue ---------------------------------------------------------------

def invert_pairs(bucket_ids: torch.Tensor, nb: int, p_max: int):
    """Turn each query's bucket list ``(Q, k)`` (an id of ``nb`` marks an
    unused slot) into per-bucket query lists, ``p_max`` entries a round.

    Returns ``(assign (nb, rounds * p_max) int32, slot (nb, rounds * p_max)
    int64)``: ``assign[b]`` lists the queries that want bucket ``b`` in
    query order (``Q`` in an empty slot), and ``slot`` says which of the
    query's ``k`` bucket slots each entry fills. ``rounds`` is the least
    number that holds the bucket most in demand; finding it is the call's
    one host read.
    """
    q_len, k = bucket_ids.shape
    dev = bucket_ids.device
    n_pairs = q_len * k
    ar = torch.arange(n_pairs, device=dev)
    pair_b = bucket_ids.reshape(-1).long()
    order = torch.argsort(pair_b, stable=True)
    sb = pair_b[order]
    sq, ss = order // k, order % k
    # first occurrence of each bucket in the sorted pair list
    first = torch.full((nb + 1,), n_pairs, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, sb, ar, "amin")
    real = sb < nb
    rank = torch.where(real, ar - first[sb], 0)
    demand = int((rank + 1).masked_fill(~real, 0).max())   # the one host read
    width = max(1, -(-demand // p_max)) * p_max
    # a dump row takes the unused slots' writes; duplicates land only there
    assign = torch.full((nb + 1, width), q_len, dtype=torch.int32,
                        device=dev)
    assign[sb, rank] = torch.where(real, sq, q_len).to(torch.int32)
    slot = torch.zeros((nb + 1, width), dtype=torch.int64, device=dev)
    slot[sb, rank] = ss
    return assign[:nb].contiguous(), slot[:nb].contiguous()


def bucket_candidates(q_in: torch.Tensor, k_in: torch.Tensor, k: int,
                      valid: torch.Tensor | None, p_max: int):
    """Phases 1 and 2 and the glue around them, for bf16 ``q_in (Q, E)`` and
    ``k_in (R, E)`` with at least ``k`` buckets.

    Returns what each kernel of the path reads or writes: the bucket maxima
    ``bm (nb, Q)``, the per-bucket query lists ``assign (nb, rounds *
    p_max)`` (kernel F takes ``p_max`` columns a launch), each query's
    bucket list ``bucket_ids (Q, k)`` (``nb`` in an unused slot) and the
    candidate scores ``cand (Q, k*128)``, slot ``s`` of a row holding the
    128 scores of the query's ``s``-th bucket (``-3e38`` where there is
    none).
    """
    q_len = q_in.shape[0]
    nb = -(-k_in.shape[0] // LANE)
    bm = bucket_max(k_in, q_in, valid)                     # (nb, Q)
    bvals, bucket_ids = column_topk(bm, k)                 # (Q, k)
    # fewer than k non-empty buckets: the exhausted tail repeats bucket 0;
    # mark those slots unused so that no bucket is scattered twice
    bucket_ids = torch.where(bvals <= NEG_INF, nb, bucket_ids)
    assign, slot = invert_pairs(bucket_ids, nb, p_max)

    # row Q of the candidates takes the empty slots' panels; a round past
    # the first scores the queries beyond p_max of the buckets that have
    # them, by the same kernel, so every candidate has phase 1's bits
    cand = torch.full((q_len + 1, k, LANE), NEG_INF, dtype=torch.float32,
                      device=q_in.device)
    for c in range(0, assign.shape[1], p_max):
        rnd = assign[:, c:c + p_max].contiguous()
        panels = bucket_rescore(rnd, q_in, k_in, valid)    # (nb, P, 128)
        cand[rnd.reshape(-1).long(), slot[:, c:c + p_max].reshape(-1)] = \
            panels.reshape(-1, LANE)
    return bm, assign, bucket_ids, cand[:q_len].reshape(q_len, k * LANE)


def bucketed_exact_topk(queries: torch.Tensor, keys_n: torch.Tensor, k: int,
                        valid_mask: torch.Tensor | None = None,
                        p_max: int = 32):
    """Exact top-``k`` of already L2-normalised ``queries (Q, E)`` against
    ``keys_n (R, E)``, both scored in bf16 with f32 sums (see module doc).

    ``valid_mask (R,)`` bool: invalid rows never surface. ``p_max`` is the
    per-bucket capacity of one launch of kernel F; the queries beyond it
    take further launches.

    Returns ``(scores (Q, k) f32, indices (Q, k) int32)`` sorted descending.
    The scores are always exact; indices may differ from a full sort only
    under exact score ties. Slots beyond the valid rows hold ``(-inf, 0)``.
    Any ``k >= 1`` and any width. A pass takes at most 4,096 queries, and
    fewer where their ``(Q, k * 128)`` f32 candidates would take more than
    ``score_tile.pass_rows`` allows.
    """
    _check_k("bucketed_exact_topk", k)
    q_len = queries.shape[0]
    r_len = keys_n.shape[0]
    chunk = pass_rows(min(q_len, _Q_CHUNK), 4 * k * LANE,
                      device_memory(queries.device))
    # bf16 rows padded to a multiple of 8 (zero columns add 0), once
    q_in, k_in = bf16_rows(queries), bf16_rows(keys_n)
    if q_len > chunk:
        outs = [bucketed_exact_topk(q_in[i:i + chunk], k_in, k, valid_mask,
                                    p_max)
                for i in range(0, q_len, chunk)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))
    dev = queries.device
    valid = valid_u8(valid_mask, r_len, dev)
    nb = -(-r_len // LANE)
    if nb < k:
        # tiny library: the dense exact path is already cheap
        scores = q_in.float() @ k_in.float().T
        if valid is not None:
            scores = torch.where(valid[None, :], scores, -torch.inf)
        s, i = torch.topk(scores, min(k, r_len), dim=1)
        pad = k - s.shape[1]
        s = torch.nn.functional.pad(s, (0, pad), value=-torch.inf)
        i = torch.nn.functional.pad(i, (0, pad), value=0)
        return s, torch.where(torch.isinf(s), 0, i).to(torch.int32)

    bucket_ids, cand = bucket_candidates(q_in, k_in, k, valid, p_max)[-2:]
    vals, pos = row_topk(cand, k)
    g_bucket = torch.gather(bucket_ids, 1, (pos // LANE).long())
    g_idx = g_bucket * LANE + pos % LANE
    # exhausted slots: an in-range index and -inf, as the masked exact sort
    dead = vals <= NEG_INF
    return (torch.where(dead, -torch.inf, vals),
            torch.where(dead, 0, g_idx).to(torch.int32))
