"""IVF coarse-quantized retrieval index (counterpart of
``ragraph_tpu/rag/ivf.py``).

- **Build**: Lloyd k-means over L2-normalised keys. Each chunk of rows is
  scored against the centroids (rounded to the keys' dtype) with f32 sums,
  assigned by argmax (ties to the lowest centroid), and summed into f32
  per-cluster totals; an empty cluster keeps its centroid. Rows are then
  bucketed into a dense ``(P, cap, E)`` tensor of the keys' dtype with a
  fixed capacity per cluster: rows past it are dropped and counted.
- **Search**: score the queries against the centroids, probe the top
  ``nprobe`` clusters, score their ``nprobe * cap`` slots (empty ones at
  ``-inf``) and take the top-k.

JAX computes all of this in XLA (matmuls, ``argmax``, ``segment_sum``,
``top_k``, gathers), so plain PyTorch is its port; no kernel is involved.
Scores are f32 as JAX's ``preferred_element_type=jnp.float32`` makes them:
the inputs are cast to f32 before the product, which keeps each product of
two bf16 values exact, where a bf16 ``matmul`` would round its output.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ragraph_tpu_torch.ops.similarity import l2_normalize


@dataclasses.dataclass
class IVFIndex:
    centroids: torch.Tensor   # (P, E) L2-normalised f32
    keys: torch.Tensor        # (P, cap, E) bucketed normalised keys
    row_ids: torch.Tensor     # (P, cap) int32 original row ids (-1 empty)
    valid: torch.Tensor       # (P, cap) bool
    dropped: torch.Tensor     # scalar int32: overflow rows not indexed
    num_clusters: int
    capacity: int


def _scores(rows: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """f32 scores of ``rows`` against ``centroids`` (both in the keys'
    dtype): exact products, f32 sums."""
    return rows.float() @ centroids.float().T


def kmeans(keys_n: torch.Tensor, init, num_clusters: int, iters: int = 10,
           chunk: int = 262_144):
    """Lloyd k-means on normalised rows (cosine = dot assignment).

    ``init`` picks the initial centroids: the ``num_clusters`` row indices
    themselves (an array or tensor), or a ``torch.Generator`` to draw them
    without replacement. (JAX draws them with ``jax.random.choice`` from a
    key, a stream torch cannot reproduce; its tests hand JAX's indices in.)

    Returns ``(centroids (P, E) f32, assignment (R,) int32)``. Memory: the
    keys, one chunk's ``(chunk, P)`` f32 scores and f32 copy of its rows.
    """
    r, e = keys_n.shape
    dev = keys_n.device
    if isinstance(init, torch.Generator):
        init_idx = torch.randperm(r, generator=init,
                                  device=init.device)[:num_clusters]
    else:
        init_idx = torch.as_tensor(np.asarray(init)).long()
    if init_idx.shape != (num_clusters,):
        raise ValueError(f"need {num_clusters} initial rows, got "
                         f"{tuple(init_idx.shape)}")
    centroids = keys_n[init_idx.to(dev)].float()
    chunk = min(chunk, r)
    starts = range(0, r, chunk)

    def assign(centroids_b, lo):
        return _scores(keys_n[lo:lo + chunk], centroids_b).argmax(dim=1)

    for _ in range(iters):
        centroids_b = centroids.to(keys_n.dtype)
        # JAX pads the last chunk and sends the padding to row P; the last
        # chunk is short here, so row P stays empty
        sums = torch.zeros((num_clusters + 1, e), dtype=torch.float32,
                           device=dev)
        counts = torch.zeros(num_clusters + 1, dtype=torch.float32,
                             device=dev)
        for lo in starts:
            a = assign(centroids_b, lo)
            sums.index_add_(0, a, keys_n[lo:lo + chunk].float())
            counts += torch.bincount(a, minlength=num_clusters + 1)
        new_c = l2_normalize(sums[:num_clusters] / torch.clamp_min(
            counts[:num_clusters, None], 1.0))
        centroids = torch.where(counts[:num_clusters, None] > 0, new_c,
                                centroids)

    centroids_b = centroids.to(keys_n.dtype)
    assignment = torch.cat([assign(centroids_b, lo) for lo in starts])
    return centroids, assignment.to(torch.int32)


def _bucketize(keys_n: torch.Tensor, assignment: torch.Tensor,
               num_clusters: int, capacity: int):
    """Place rows into fixed-capacity cluster buckets, in row order within a
    cluster (a stable sort); rows past the capacity are dropped.

    Returns ``(keys (P, cap, E), row_ids (P, cap) int32, valid (P, cap),
    dropped)``.
    """
    r, e = keys_n.shape
    dev = keys_n.device
    a = assignment.long()
    order = torch.argsort(a, stable=True)
    sorted_a = a[order]
    first_pos = torch.searchsorted(
        sorted_a, torch.arange(num_clusters, device=dev))
    rank = torch.arange(r, device=dev) - first_pos[sorted_a]
    fits = rank < capacity
    slot = (sorted_a * capacity + rank)[fits]
    rows = order[fits]
    keys_b = keys_n.new_zeros((num_clusters * capacity, e))
    keys_b[slot] = keys_n[rows]
    ids_b = torch.full((num_clusters * capacity,), -1, dtype=torch.int32,
                       device=dev)
    ids_b[slot] = rows.to(torch.int32)
    ids_b = ids_b.view(num_clusters, capacity)
    dropped = (~fits).sum().to(torch.int32)
    return (keys_b.view(num_clusters, capacity, e), ids_b, ids_b >= 0,
            dropped)


def build_ivf(keys: torch.Tensor, init, num_clusters: int = 1024,
              capacity: int | None = None, iters: int = 10,
              normalized: bool = False) -> IVFIndex:
    """Build an IVF index over library keys (``init`` as in :func:`kmeans`).

    Pass ``normalized=True`` (and bf16 keys) at large R to avoid a second
    full-size copy for the normalisation.
    """
    keys_n = keys if normalized else l2_normalize(keys)
    r = keys.shape[0]
    if capacity is None:
        capacity = max(32, int(2 * r / num_clusters))
    centroids, assignment = kmeans(keys_n, init, num_clusters, iters=iters)
    keys_b, ids_b, valid, dropped = _bucketize(keys_n, assignment,
                                               num_clusters, capacity)
    return IVFIndex(centroids=centroids, keys=keys_b, row_ids=ids_b,
                    valid=valid, dropped=dropped,
                    num_clusters=num_clusters, capacity=capacity)


def ivf_search(index: IVFIndex, queries: torch.Tensor, k: int,
               nprobe: int = 8):
    """Approximate top-``k``: ``(scores (Q, k) f32, row_ids (Q, k) int32)``,
    ids into the original key array (-1 where fewer than ``k`` valid
    candidates were probed)."""
    q = l2_normalize(queries).to(index.keys.dtype)
    cents = index.centroids.to(index.keys.dtype)
    probe = torch.topk(_scores(q, cents), nprobe, dim=1).indices
    cand_keys = index.keys[probe]                       # (Q, np, cap, E)
    scores = torch.einsum("qe,qpce->qpc", q.float(), cand_keys.float())
    scores = torch.where(index.valid[probe], scores, -torch.inf)
    n_q = queries.shape[0]
    s, pos = torch.topk(scores.reshape(n_q, -1), k, dim=1)
    return s, torch.gather(index.row_ids[probe].reshape(n_q, -1), 1, pos)
