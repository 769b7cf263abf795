"""The probe kernels of the bench scripts (kernels J, K, L): counterparts of
the three Pallas kernels that live in ``benchmarks/bench_exact_phases.py``,
``experiments/packed_table_gather_bench.py`` and
``experiments/onehot_gather_bench.py``.

- :func:`matmul_probe` (J): the bf16 product ``keys · queriesᵀ`` with f32
  sums, of which one row of every 128-row group is written:
  ``out[g, q] = keys[128·g + pick_row] · queries[q]``. Phase 1 of the bucket
  top-k (kernel D) without the group maximum. On the card it is the
  tensor-core tile of kernels C, D and F with the keys on the A side, where
  D and F put the queries: it equals kernel F's score of that key to a few
  f32 roundings. The plain version adds in sequence, as D's and F's plain
  versions do, so on the CPU the two agree bit for bit.
- :func:`packed_table_segsum` (K): kernel A's weighted segment sum from a
  table packed two rows to one, ``out[r] = Σ_e w_lo[e]·T[idx_half[e], :D] +
  w_hi[e]·T[idx_half[e], D:]`` over receiver-sorted CSR. Both weights may be
  non-zero; they are rounded to bf16 and the products add in f32. On the
  card it runs kernel A's row walk (``csrc/rg_csr.cuh``) with the same
  :func:`~ragraph_tpu_torch.ops.csr_segment.walk_plan`, so with the parity
  split it equals kernel A bit for bit.
- :func:`onehot_block_gather` (L): a block-local row gather over a padded,
  sender-sorted edge stream, ``out[b·P + s] = table[128·b + col[b, s]]`` and
  a zero row for a padding slot. :func:`build_onehot_layout` makes the
  stream's layout on the host.

Each has a plain PyTorch version (``*_plain``). A wrapper runs it only for
tensors on the CPU; for CUDA tensors it launches the kernel
(``csrc/probes.cu``) or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ragraph_tpu_torch import native
from ragraph_tpu_torch.ops.score_tile import (LANE, RESIDENT_E, check_qk,
                                              fma_chain)
from ragraph_tpu_torch.ops.csr_segment import (WalkPlan, _check_cuda,
                                              _segment_ids, walk_plan,
                                              walk_plan_args)

MAX_PACKED_D = 128   # kernel K: half width of a packed row
MAX_GATHER_D = 512   # kernel L: 128 rows of this width fit shared memory


def _check_pick(pick_row: int) -> None:
    if not 0 <= pick_row < LANE:
        raise ValueError(f"matmul_probe: pick_row must be in [0, {LANE}), "
                         f"got {pick_row}")


def matmul_probe_plain(keys: torch.Tensor, queries: torch.Tensor,
                       pick_row: int = 0) -> torch.Tensor:
    """Plain version of kernel J: the picked row of every group, scored in
    the kernels' dot order; a picked row past ``R`` scores 0."""
    _check_pick(pick_row)
    n_r = keys.shape[0]
    rows = torch.arange(-(-n_r // LANE), device=keys.device) * LANE + pick_row
    kb = keys.to(torch.bfloat16)[rows.clamp(max=max(n_r - 1, 0))]
    sc = fma_chain(kb[:, None, :], queries.to(torch.bfloat16)[None, :, :])
    return torch.where((rows < n_r)[:, None], sc, 0.0)


def matmul_probe(keys: torch.Tensor, queries: torch.Tensor,
                 pick_row: int = 0) -> torch.Tensor:
    """``out[g, q] = keys[128·g + pick_row] · queries[q]``, ``(ceil(R/128),
    Q)`` f32, from bf16 ``keys (R, E)`` and ``queries (Q, E)``. On the card
    every one of the ``R·Q`` dot products is taken and one row in 128 is
    written (kernel J), for rows of at most 256 values."""
    if keys.device.type == "cpu":
        return matmul_probe_plain(keys, queries, pick_row)
    name = "mm_probe"
    _check_pick(pick_row)
    queries, keys = check_qk(name, queries, keys)
    if keys.shape[1] > RESIDENT_E:
        raise ValueError(f"{name}: its tiles hold rows of at most "
                         f"{RESIDENT_E} values, got {keys.shape[1]}")
    n_r, n_q = keys.shape[0], queries.shape[0]
    out = torch.empty((-(-n_r // LANE), n_q), dtype=torch.float32,
                      device=keys.device)
    if out.numel() == 0:
        return out
    rc = native.lib().rg_mm_probe(
        keys.data_ptr(), queries.data_ptr(), out.data_ptr(), n_r, n_q,
        keys.shape[1], pick_row, native.stream_ptr(keys))
    native.check(rc, name)
    native.LAUNCHES[name] += 1
    return out


def pack_table(table: torch.Tensor) -> torch.Tensor:
    """``(N, D)`` rows as the bf16 ``(N/2, 2D)`` packed table: packed row
    ``m`` is ``[row 2m | row 2m + 1]``."""
    n, d = table.shape
    if n % 2:
        raise ValueError(f"pack_table: an even number of rows, got {n}")
    return table.to(torch.bfloat16).reshape(n // 2, 2 * d)


def _check_packed(table_packed, w_lo, w_hi, idx_half, indptr) -> int:
    if table_packed.dim() != 2 or table_packed.shape[1] % 4:
        raise ValueError(f"packed_table_segsum: table must be (N/2, 2D) with "
                         f"D even, got shape {tuple(table_packed.shape)}")
    d = table_packed.shape[1] // 2
    if not 0 < d <= MAX_PACKED_D:
        raise ValueError(f"packed_table_segsum: D must be at most "
                         f"{MAX_PACKED_D}, got {d}")
    n = idx_half.shape[0]
    if w_lo.shape != (n,) or w_hi.shape != (n,):
        raise ValueError(f"packed_table_segsum: w_lo and w_hi must be "
                         f"({n},), got {tuple(w_lo.shape)} and "
                         f"{tuple(w_hi.shape)}")
    if indptr.dim() != 1 or indptr.shape[0] < 1:
        raise ValueError("packed_table_segsum: indptr must be (N + 1,)")
    return d


def packed_table_segsum_plain(table_packed: torch.Tensor, w_lo: torch.Tensor,
                              w_hi: torch.Tensor, idx_half: torch.Tensor,
                              indptr: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel K: gather the packed rows, round rows and
    weights to bf16, scale each half, ``index_add_`` over segment ids."""
    d = _check_packed(table_packed, w_lo, w_hi, idx_half, indptr)
    rows = table_packed.to(torch.bfloat16).float()[idx_half.long()]
    wl = w_lo.to(torch.bfloat16).float()[:, None]
    wh = w_hi.to(torch.bfloat16).float()[:, None]
    msgs = rows[:, :d] * wl + rows[:, d:] * wh
    out = torch.zeros(len(indptr) - 1, d, dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(0, _segment_ids(indptr, len(idx_half)), msgs)


def packed_table_segsum(table_packed: torch.Tensor, w_lo: torch.Tensor,
                        w_hi: torch.Tensor, idx_half: torch.Tensor,
                        indptr: torch.Tensor,
                        plan: WalkPlan | None = None) -> torch.Tensor:
    """``out[r] = Σ_{e∈[indptr[r], indptr[r+1])} w_lo[e]·T[idx_half[e], :D]
    + w_hi[e]·T[idx_half[e], D:]``, ``(len(indptr) - 1, D)`` f32, from the
    packed ``(N/2, 2D)`` table ``T``. Rows and weights are rounded to bf16;
    products and sums are f32. Empty segments give zero rows. ``plan`` is
    ``walk_plan(indptr)``, made here when not given."""
    if table_packed.device.type == "cpu":
        return packed_table_segsum_plain(table_packed, w_lo, w_hi, idx_half,
                                         indptr)
    name = "packed_table_segsum"
    d = _check_packed(table_packed, w_lo, w_hi, idx_half, indptr)
    src = table_packed.to(torch.bfloat16).contiguous()
    _check_cuda(name, table_packed=(src, torch.bfloat16, 2),
                w_lo=(w_lo, torch.float32, 1), w_hi=(w_hi, torch.float32, 1),
                idx_half=(idx_half, torch.int32, 1),
                indptr=(indptr, torch.int32, 1))
    n_rows = len(indptr) - 1
    plan_args, _partial = walk_plan_args(plan or walk_plan(indptr), d)
    out = torch.empty(n_rows, d, dtype=torch.float32, device=src.device)
    rc = native.lib().rg_packed_table_segsum(
        src.data_ptr(), w_lo.data_ptr(), w_hi.data_ptr(),
        idx_half.data_ptr(), indptr.data_ptr(), out.data_ptr(), n_rows, d,
        *plan_args, native.stream_ptr(src))
    native.check(rc, name)
    native.LAUNCHES[name] += 1
    return out


def build_onehot_layout(senders: np.ndarray, n: int, lane: int = LANE):
    """The padded stream of sender-sorted edges that kernel L reads.

    Table rows are grouped into blocks of ``lane``; block ``b``'s edges are
    a contiguous run of the sorted ``senders`` and land at slots
    ``[b·P, b·P + counts[b])`` with ``P`` the largest block load rounded up
    to a multiple of ``lane``. Returns ``(local_col (nb, P) int32 with
    ``lane`` in the padding slots, P, counts (nb,), slot (E,) int64)``:
    edge ``e`` is found at row ``slot[e]`` of the gathered stream.
    """
    senders = np.asarray(senders)
    if len(senders) > 1 and (np.diff(senders) < 0).any():
        raise ValueError("build_onehot_layout: senders must be sorted")
    nb = -(-n // lane)
    block_of = senders // lane
    counts = np.bincount(block_of, minlength=nb)
    p = int(-(-max(int(counts.max(initial=0)), 1) // lane) * lane)
    offs = np.zeros(nb + 1, np.int64)
    offs[1:] = np.cumsum(counts)
    slot = (np.arange(len(senders)) - offs[block_of]
            + block_of.astype(np.int64) * p)
    local_col = np.full(nb * p, lane, np.int32)
    local_col[slot] = senders % lane
    return local_col.reshape(nb, p), p, counts, slot


def _check_gather(col: torch.Tensor, table: torch.Tensor) -> None:
    if col.dim() != 2 or table.dim() != 2:
        raise ValueError(f"onehot_block_gather: col must be (blocks, P) and "
                         f"table (N, D), got {tuple(col.shape)} and "
                         f"{tuple(table.shape)}")
    if -(-table.shape[0] // LANE) != col.shape[0]:
        raise ValueError(f"onehot_block_gather: {table.shape[0]} table rows "
                         f"make {-(-table.shape[0] // LANE)} blocks of "
                         f"{LANE}, col has {col.shape[0]}")


def onehot_block_gather_plain(col: torch.Tensor,
                              table: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel L: each block's rows with a zero row
    appended, indexed by the block's columns."""
    _check_gather(col, table)
    nb, p = col.shape
    n, d = table.shape
    padded = torch.cat([table, table.new_zeros((nb * LANE - n, d))])
    blocks = torch.cat([padded.view(nb, LANE, d),
                        table.new_zeros((nb, 1, d))], dim=1)
    c = col.long()
    c = torch.where((c >= 0) & (c < LANE), c, LANE)
    return torch.gather(blocks, 1, c[:, :, None].expand(nb, p, d)) \
        .reshape(nb * p, d)


def onehot_block_gather(col: torch.Tensor, table: torch.Tensor
                        ) -> torch.Tensor:
    """``out[b·P + s] = table[128·b + col[b, s]]``, ``(blocks·P, D)`` in the
    table's bf16, a zero row where ``col[b, s]`` is outside ``[0, 128)``.
    A copy: exact."""
    if col.device.type == "cpu":
        return onehot_block_gather_plain(col, table)
    name = "onehot_gather"
    _check_gather(col, table)
    _check_cuda(name, col=(col, torch.int32, 2),
                table=(table, torch.bfloat16, 2))
    nb, p = col.shape
    n, d = table.shape
    if d % 8 or not 0 < d <= MAX_GATHER_D:
        raise ValueError(f"{name}: row width must be a multiple of 8 and at "
                         f"most {MAX_GATHER_D}, got {d}")
    if p * (d // 8) >= 1 << 31:
        raise ValueError(f"{name}: {p} slots of width {d} exceed the "
                         f"kernel's block size")
    out = torch.empty((nb * p, d), dtype=torch.bfloat16, device=table.device)
    if out.numel() == 0:
        return out
    rc = native.lib().rg_onehot_gather(
        col.data_ptr(), table.data_ptr(), out.data_ptr(), nb, p, n, d,
        native.stream_ptr(table))
    native.check(rc, name)
    native.LAUNCHES[name] += 1
    return out
