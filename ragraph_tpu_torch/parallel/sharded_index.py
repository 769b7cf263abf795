"""Row-sharded retrieval index: local top-k and a global merge
(counterpart of ``ragraph_tpu/parallel/sharded_index.py``).

The library's ``R`` rows are sharded over the mesh's ``idx`` axis:

1. each rank scores the replicated queries against its ``R/D`` local rows
   and takes a *local* top-k through the single-device dispatch
   (:func:`ragraph_tpu_torch.ops.topk.cosine_topk`: kernel C for
   ``"approx"``/``"pallas"``, and for ``"auto"`` at 32,768 local rows or
   more; kernels D-G for ``"bucket"``, and for ``"auto"`` with
   ``recall_target >= 1``);
2. the ``(Q, k)`` candidates (scores and global row ids) are all-gathered
   over ``idx``, ``k·D`` values per query instead of ``R``;
3. a final ``torch.topk`` over the ``k·D`` candidates gives the global
   result, exact whenever the local method is.

Arguments named as sharded are this rank's block of rows; the results are
replicated.
"""

from __future__ import annotations

import torch

from ragraph_tpu_torch.parallel.collectives import all_gather, all_reduce
from ragraph_tpu_torch.parallel.mesh import axis_index


def _gather_cols(x: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """``(Q, k)`` per rank -> ``(Q, k·D)``, the ranks' columns in order."""
    return all_gather(x.T.contiguous(), mesh, axis_name).T


def merge_topk(mesh, s_loc: torch.Tensor, i_loc: torch.Tensor, k: int,
               axis_name: str = "idx"):
    """The global top-k of the ranks' local candidates (global ids)."""
    s_all = _gather_cols(s_loc, mesh, axis_name)
    i_all = _gather_cols(i_loc, mesh, axis_name)
    s_top, pos = torch.topk(s_all, k, dim=1)
    return s_top, torch.gather(i_all, 1, pos)


def sharded_cosine_topk(mesh, queries: torch.Tensor, keys: torch.Tensor,
                        k: int, valid_mask: torch.Tensor | None = None,
                        axis_name: str = "idx", local_method: str = "auto",
                        recall_target: float = 0.99,
                        score_dtype: str = "input", rescore_pad: int = 0):
    """Cosine top-k of replicated ``queries (Q, E)`` against the row-sharded
    ``keys`` (this rank's ``(R/D, E)`` block; an int8 table from
    ``quantize_keys_i8`` with ``score_dtype="int8"``), masked by the
    sharded ``valid_mask``. Returns replicated ``(scores, global indices)``,
    each ``(Q, k)``."""
    from ragraph_tpu_torch.ops.topk import cosine_topk
    rows_local = keys.shape[0]
    k_local = min(k, rows_local)
    s_loc, i_loc = cosine_topk(queries, keys, k_local, valid_mask=valid_mask,
                               method=local_method,
                               recall_target=recall_target,
                               score_dtype=score_dtype,
                               rescore_pad=rescore_pad)
    i_loc = i_loc.long() + axis_index(mesh, axis_name) * rows_local
    return merge_topk(mesh, s_loc.float(), i_loc, k, axis_name)


def sharded_gather_rows(mesh, values: torch.Tensor, indices: torch.Tensor,
                        axis_name: str = "idx") -> torch.Tensor:
    """Rows of the row-sharded ``values`` by *global* index: each rank puts
    in its own rows (zeros elsewhere) and a sum over the axis completes the
    gather. Returns replicated ``values[indices]``."""
    rows_local = values.shape[0]
    local = indices.long() - axis_index(mesh, axis_name) * rows_local
    in_range = (local >= 0) & (local < rows_local)
    got = values[local.clamp(0, rows_local - 1)] \
        * in_range[..., None].to(values.dtype)
    return all_reduce(got, mesh, axis_name)


def sharded_retrieve(mesh, queries: torch.Tensor, keys: torch.Tensor,
                     values: torch.Tensor, labels: torch.Tensor, k: int,
                     valid_mask: torch.Tensor | None = None):
    """Sharded top-k and the value and label gathers over ``idx``. Returns
    replicated ``(values (Q, k, Ev), labels (Q, k, C))``."""
    _, idx = sharded_cosine_topk(mesh, queries, keys, k, valid_mask)
    return (sharded_gather_rows(mesh, values, idx),
            sharded_gather_rows(mesh, labels, idx))
