"""The toy-graph vector library: a key/value/label/position store
(counterpart of ``ragraph_tpu/rag/library.py``).

- A preallocated store of ``capacity`` rows plus one dump row, with a fill
  counter that stays a device scalar. :func:`library_append` packs the
  valid rows densely after ``fill``; invalid rows and rows past the
  capacity land on the dump row, which nothing reads.
- :func:`build_entries_batch` runs the whole per-graph pipeline (inverse
  sampling by PageRank, augmentation, the frozen encoder, k-hop value
  propagation, position codes) for all graphs and all copies of a batch at
  once, over a ``(B, copies, N, ...)`` leading axis: the JAX package's
  ``vmap`` over graphs and copies written out.
- :func:`retrieve` is a cosine top-k with fill masking
  (:func:`ragraph_tpu_torch.ops.topk.cosine_topk`: above 32,768 rows the
  fused CUDA kernel on the card), the structure-weighted variant, and both
  noise modes. On a store sharded over a mesh
  (:mod:`ragraph_tpu_torch.parallel.sharded_library`) it takes the local
  top-k of each shard and merges
  (:mod:`ragraph_tpu_torch.parallel.sharded_index`).

Every function that draws takes its draws as an optional argument and
otherwise draws from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ragraph_tpu_torch.ops.pagerank import inverse_sample_prob_dense
from ragraph_tpu_torch.ops.propagation import aggregate_k_hop_dense
from ragraph_tpu_torch.ops.shortest_path import position_aware_codes
from ragraph_tpu_torch.ops.similarity import l2_normalize
from ragraph_tpu_torch.ops.topk import cosine_topk, topk_gather
from ragraph_tpu_torch.rag.augmentation import augment_adj, augment_features


@dataclasses.dataclass(frozen=True)
class LibraryConfig:
    """Knobs of the library's build and query phases (the JAX package's
    defaults)."""

    level: str = "node"               # "node" | "graph"
    num_inverse_sample: int = 10      # 0 disables inverse sampling
    num_augment_scale: int = 3        # augmented copies per graph
    retrieve_num: int = 4             # num_class + 1 in the node variant
    noise_retrieve_num: int = 1
    noise_mode: str = "rows"          # "rows" | "gaussian"
    noise_std: float = 0.01
    toy_graph_hop: int = 2            # query_graph_hop - 1
    use_positions: bool = True
    num_anchors: int = 10
    dis_q: int = 10
    structure_weight: float = 0.0
    semantic_weight: float = 0.999
    retrieve_dtype: str = "input"     # "input" | "int8"
    retrieve_rescore_pad: int = 0


@dataclasses.dataclass
class ToyGraphLibrary:
    """Fixed-capacity key/value/label/position store (+1 dump row).

    With ``mesh`` set the store is sharded over the mesh's ``axis_name``:
    the arrays are this rank's ``capacity / D`` rows of a store of exactly
    ``capacity`` rows (no dump row), and ``fill`` is replicated
    (:mod:`ragraph_tpu_torch.parallel.sharded_library`)."""

    keys: torch.Tensor        # (capacity+1, E)
    values: torch.Tensor      # (capacity+1, E)
    labels: torch.Tensor      # (capacity+1, C)
    positions: torch.Tensor   # (capacity+1, A)
    fill: torch.Tensor        # 0-d int32, on the store's device
    capacity: int
    mesh: Any = None
    axis_name: str = "idx"

    @property
    def valid_mask(self) -> torch.Tensor:
        """Which rows hold entries (this rank's rows on a sharded store)."""
        rows = self.keys.shape[0] if self.mesh is not None else self.capacity
        ids = torch.arange(rows, device=self.fill.device)
        if self.mesh is not None:
            ids = ids + self.mesh.get_local_rank(self.axis_name) * rows
        return ids < self.fill

    def live(self):
        """The capacity-trimmed views that retrieval reads (no dump row)."""
        return (self.keys[: self.capacity], self.values[: self.capacity],
                self.labels[: self.capacity], self.positions[: self.capacity])

    def to(self, device) -> "ToyGraphLibrary":
        return ToyGraphLibrary(self.keys.to(device), self.values.to(device),
                               self.labels.to(device),
                               self.positions.to(device),
                               self.fill.to(device), self.capacity,
                               self.mesh, self.axis_name)


def library_init(capacity: int, emb_size: int, num_classes: int,
                 num_anchors: int = 10,
                 device: str | torch.device = "cpu") -> ToyGraphLibrary:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return ToyGraphLibrary(
        keys=z(capacity + 1, emb_size), values=z(capacity + 1, emb_size),
        labels=z(capacity + 1, num_classes),
        positions=z(capacity + 1, num_anchors),
        fill=torch.zeros((), dtype=torch.int32, device=device),
        capacity=capacity)


def library_reset(lib: ToyGraphLibrary) -> ToyGraphLibrary:
    """Empty the store: the fill counter goes to zero, the rows stay."""
    return dataclasses.replace(lib, fill=torch.zeros_like(lib.fill))


def library_append(lib: ToyGraphLibrary, keys: torch.Tensor,
                   values: torch.Tensor, labels: torch.Tensor,
                   positions: torch.Tensor,
                   valid: torch.Tensor) -> ToyGraphLibrary:
    """Compacting append: valid rows pack densely after ``fill``; invalid
    rows and the overflow past the capacity land on the dump row.

    The store's tensors are written in place and shared with the returned
    library, which carries the new fill; rows below the old fill are not
    touched. Several rows may be written to the dump row in no fixed order:
    nothing reads it (:meth:`ToyGraphLibrary.live`). No host read: the fill
    stays on the device and clamps at the capacity. A sharded store takes
    :func:`ragraph_tpu_torch.parallel.sharded_library_append`.
    """
    if lib.mesh is not None:
        raise ValueError("library_append: the store is sharded over a mesh; "
                         "use parallel.sharded_library_append")
    valid = valid.bool()
    valid_i = valid.to(torch.int32)
    pos = lib.fill + torch.cumsum(valid_i, dim=0) - valid_i
    pos = torch.where(valid & (pos < lib.capacity), pos, lib.capacity).long()
    new_fill = torch.clamp_max(lib.fill + valid_i.sum(), lib.capacity) \
        .to(torch.int32)
    with torch.no_grad():
        lib.keys[pos] = keys.detach().to(lib.keys.dtype)
        lib.values[pos] = values.detach().to(lib.values.dtype)
        lib.labels[pos] = labels.detach().to(lib.labels.dtype)
        lib.positions[pos] = positions.detach().to(lib.positions.dtype)
    return dataclasses.replace(lib, fill=new_fill)


# ---------------------------------------------------------------------------
# Build phase
# ---------------------------------------------------------------------------

def draw_sample_indices(p_safe: torch.Tensor, num: int,
                        generator: torch.Generator) -> torch.Tensor:
    """``num`` node indices per graph with replacement, node ``i`` with
    probability ``p_safe[..., i]``."""
    flat = p_safe.reshape(-1, p_safe.shape[-1])
    idx = torch.multinomial(flat, num, replacement=True, generator=generator)
    return idx.reshape(*p_safe.shape[:-1], num)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, :]`` per leading index: ``(..., N, F), (..., S) ->
    (..., S, F)``."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def build_entries_batch(encoder_fn: Callable, features: torch.Tensor,
                        adjs: torch.Tensor, labels: torch.Tensor,
                        node_masks: torch.Tensor, graph_onehots,
                        cfg: LibraryConfig,
                        generator: torch.Generator | None = None, *,
                        draws: dict | None = None):
    """Entries for a whole batch of padded graphs, all copies.

    ``features (B, N, F)``; ``adjs (B, N, N)`` normalized clean adjacency;
    ``labels (B, N, C)``; ``node_masks (B, N)``; ``graph_onehots (B, C)``
    is read only by graph-level libraries (zeros when None).
    ``encoder_fn(features, adj)`` must take leading batch dimensions.

    Copy 0 of a graph is the graph itself; copies ``1..num_augment_scale``
    have augmented features and a rewritten adjacency. With
    ``num_inverse_sample > 0`` each copy contributes that many nodes drawn
    by inverse importance, with the *clean* adjacency restricted to them;
    otherwise every real node. A graph-level library (``cfg.level ==
    "graph"``) pools each copy's valid rows into one mean entry whose label
    is the graph's one-hot label; a padding graph yields no entry.

    ``draws`` may hold any of the random values, each ``(B, copies, ...)``
    (entries of copy 0 that augmentation would use are ignored):
    ``feat_noise (.., N, F)`` standard normals, ``feat_keep_u (.., N)`` and
    ``adj_u (.., N, N)`` uniforms, ``sample_idx (.., num_inverse_sample)``
    node indices, ``anchors (.., num_anchors)`` indices into the sampled
    rows. What is missing is drawn from ``generator``.

    Returns ``(keys, values, labels, positions, valid)`` flattened to
    ``(B * copies * rows, ...)``, graph-major, then copy, then row.
    """
    if cfg.level not in ("node", "graph"):
        raise ValueError(f"unknown library level {cfg.level!r}")
    draws = draws or {}
    b, n_pad, _ = features.shape
    copies = 1 + cfg.num_augment_scale

    def expand(x):      # (B, ...) -> (B, copies, ...)
        return x[:, None].expand(b, copies, *x.shape[1:])

    f_c, a_clean, y_c, m_c = (expand(x) for x in (features, adjs, labels,
                                                   node_masks))
    if cfg.num_augment_scale > 0:
        sample_prob = expand(inverse_sample_prob_dense(adjs, node_masks))
        aug_f = augment_features(generator, f_c, sample_prob,
                                 noise=draws.get("feat_noise"),
                                 keep_u=draws.get("feat_keep_u"))
        aug_a = augment_adj(generator, a_clean, sample_prob, m_c,
                            u=draws.get("adj_u"))
        is_aug = torch.arange(copies, device=features.device) > 0
        f_c = torch.where(is_aug[None, :, None, None], aug_f, f_c)
        a_c = torch.where(is_aug[None, :, None, None], aug_a, a_clean)
    else:
        a_c = a_clean

    embeddings = encoder_fn(f_c, a_c)                      # (B, copies, N, H)
    graph_valid = m_c.any(dim=-1)                          # (B, copies)

    if cfg.num_inverse_sample > 0:
        idx = draws.get("sample_idx")
        if idx is None:
            if generator is None:
                raise ValueError("build_entries_batch needs sample_idx or a "
                                 "generator to draw them")
            prob = inverse_sample_prob_dense(a_c, m_c)
            # an empty (padding) graph draws uniformly; its rows are
            # invalid anyway
            p_safe = torch.where(prob.sum(dim=-1, keepdim=True) > 0, prob,
                                 torch.full_like(prob, 1.0 / n_pad))
            idx = draw_sample_indices(p_safe, cfg.num_inverse_sample,
                                      generator)
        idx = idx.long()
        # the clean adjacency restricted to the sampled nodes, even for an
        # augmented copy
        rows = _gather_rows(a_clean, idx)                  # (.., S, N)
        sample_adj = torch.gather(
            rows, -1, idx[..., None, :].expand(*idx.shape, idx.shape[-1]))
        keys_ = _gather_rows(embeddings, idx)
        labels_ = _gather_rows(y_c, idx)
        valid = graph_valid[..., None].expand(*idx.shape)
        sample_mask = valid
    else:
        sample_adj, keys_, labels_ = a_c, embeddings, y_c
        valid = sample_mask = m_c

    keys_ = l2_normalize(keys_)
    values_ = aggregate_k_hop_dense(sample_adj, keys_, cfg.toy_graph_hop)
    if cfg.use_positions:
        positions_ = position_aware_codes(
            sample_adj, sample_mask, num_anchors=cfg.num_anchors,
            dis_q=cfg.dis_q, anchors=draws.get("anchors"),
            generator=generator)
    else:
        positions_ = keys_.new_zeros((*keys_.shape[:-1], cfg.num_anchors))

    if cfg.level == "graph":
        m = sample_mask.to(keys_.dtype)[..., None]          # (B, copies, S, 1)
        denom = torch.clamp_min(m.sum(dim=-2), 1.0)
        keys_ = ((keys_ * m).sum(dim=-2) / denom)[..., None, :]
        values_ = ((values_ * m).sum(dim=-2) / denom)[..., None, :]
        if graph_onehots is None:
            graph_onehots = features.new_zeros((b, labels.shape[-1]))
        labels_ = expand(graph_onehots.to(keys_.dtype))[..., None, :]
        positions_ = keys_.new_zeros((b, copies, 1, cfg.num_anchors))
        valid = graph_valid[..., None]

    return tuple(x.reshape(-1, *x.shape[3:]) for x in
                 (keys_, values_, labels_, positions_, valid))


def build_library(lib: ToyGraphLibrary, encoder_fn: Callable, batches,
                  cfg: LibraryConfig,
                  generator: torch.Generator | None = None,
                  draws_per_batch=None) -> ToyGraphLibrary:
    """Fill the library from an iterable of padded graph-batch dicts
    (``features (B,N,F)``, ``adj (B,N,N)``, ``labels (B,N,C)``,
    ``node_mask (B,N)`` and, for graph-level libraries, ``graph_onehot``).
    Appends, never resets: repeated calls grow the store. The encoder runs
    without gradients: the library holds buffers, not parameters."""
    return build_library_with(lib, encoder_fn, batches, cfg, generator,
                              draws_per_batch, append_fn=library_append)


def build_library_with(lib: ToyGraphLibrary, encoder_fn: Callable, batches,
                       cfg: LibraryConfig,
                       generator: torch.Generator | None = None,
                       draws_per_batch=None, *,
                       append_fn: Callable) -> ToyGraphLibrary:
    """The build loop of :func:`build_library` with its append as an
    argument, ``append_fn(lib, keys, values, labels, positions, valid)``;
    the sharded store passes its own
    (:func:`ragraph_tpu_torch.parallel.build_sharded_library`)."""
    for i, batch in enumerate(batches):
        with torch.no_grad():
            entries = build_entries_batch(
                encoder_fn, batch["features"], batch["adj"], batch["labels"],
                batch["node_mask"], batch.get("graph_onehot"), cfg,
                generator,
                draws=None if draws_per_batch is None else draws_per_batch[i])
        lib = append_fn(lib, *entries)
    return lib


# ---------------------------------------------------------------------------
# Query phase
# ---------------------------------------------------------------------------

def retrieve(lib: ToyGraphLibrary, search_keys: torch.Tensor,
             cfg: LibraryConfig, *, add_noise: bool = False,
             generator: torch.Generator | None = None,
             search_positions: torch.Tensor | None = None,
             noise_idx: torch.Tensor | None = None,
             noise: torch.Tensor | None = None):
    """Top-k retrieval with optional adversarial noise.

    - semantic path: cosine top-k of the live rows, ``k = 2·retrieve_num``
      under noise;
    - structure path (``structure_weight != 0`` and ``search_positions``
      given): a weighted sum of position-code and semantic similarity;
    - noise: ``rows`` appends ``noise_retrieve_num`` uniformly random live
      rows (``noise_idx (Q, noise_retrieve_num)`` when given, else drawn
      from ``generator``); ``gaussian`` perturbs the retrieved values
      (``noise`` standard normals when given).

    The search runs without gradients on detached queries; the library's
    tensors are buffers. Returns ``(rag_embeddings (Q,K,E), rag_labels
    (Q,K,C))``.
    """
    res_keys, res_values, res_labels, res_positions = lib.live()
    valid = lib.valid_mask
    k_retrieve = 2 * cfg.retrieve_num if add_noise else cfg.retrieve_num
    mesh = lib.mesh
    if mesh is not None:
        from ragraph_tpu_torch.parallel.sharded_index import (
            merge_topk, sharded_cosine_topk, sharded_gather_rows)

    def take(rows, idx):
        if mesh is None:
            return topk_gather(rows, idx)
        return sharded_gather_rows(mesh, rows, idx, lib.axis_name)

    with torch.no_grad():
        q = search_keys.detach()
        if cfg.structure_weight != 0.0 and search_positions is not None:
            sem = l2_normalize(q) @ l2_normalize(res_keys).T
            struct = l2_normalize(search_positions.detach()) \
                @ l2_normalize(res_positions).T
            scores = cfg.structure_weight * struct + cfg.semantic_weight * sem
            scores = torch.where(valid[None, :], scores, -torch.inf)
            if mesh is None:
                topk_idx = torch.topk(scores, k_retrieve, dim=1).indices
            else:
                # each shard's top-k of its columns, then the global merge
                rows_local = scores.shape[1]
                s_loc, i_loc = torch.topk(scores, min(k_retrieve, rows_local),
                                          dim=1)
                i_loc = i_loc + mesh.get_local_rank(lib.axis_name) \
                    * rows_local
                _, topk_idx = merge_topk(mesh, s_loc, i_loc, k_retrieve,
                                         lib.axis_name)
        elif mesh is None:
            _, topk_idx = cosine_topk(q, res_keys, k_retrieve,
                                      valid_mask=valid,
                                      score_dtype=cfg.retrieve_dtype,
                                      rescore_pad=cfg.retrieve_rescore_pad)
        else:
            _, topk_idx = sharded_cosine_topk(
                mesh, q, res_keys, k_retrieve, valid_mask=valid,
                axis_name=lib.axis_name, score_dtype=cfg.retrieve_dtype,
                rescore_pad=cfg.retrieve_rescore_pad)
        rag_embeddings = take(res_values, topk_idx)
        rag_labels = take(res_labels, topk_idx)

        if add_noise:
            if cfg.noise_mode == "rows":
                if noise_idx is None:
                    if generator is None:
                        raise ValueError("noise retrieval needs a generator "
                                         "or noise_idx")
                    u = torch.rand((q.shape[0], cfg.noise_retrieve_num),
                                   generator=generator, device=q.device)
                    hi = torch.clamp_min(lib.fill, 1)
                    noise_idx = torch.minimum((u * hi).long(), hi.long() - 1)
                rag_embeddings = torch.cat(
                    [rag_embeddings, take(res_values, noise_idx)], dim=1)
                rag_labels = torch.cat(
                    [rag_labels, take(res_labels, noise_idx)], dim=1)
            elif cfg.noise_mode == "gaussian":
                if noise is None:
                    if generator is None:
                        raise ValueError("noise retrieval needs a generator "
                                         "or noise")
                    noise = torch.randn(rag_embeddings.shape,
                                        generator=generator, device=q.device)
                rag_embeddings = rag_embeddings + cfg.noise_std * noise
    return rag_embeddings, rag_labels
