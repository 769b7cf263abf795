"""Staged temporal fine-tuning loop (counterpart of
``ragraph_tpu/models/edge/staged.py``).

For each temporal stage ``s`` over ``test_1..test_N``:

1. interpolative weight update: tables = ``0.5 * pretrain + 0.5 *``
   the L1-normalised, decay-weighted recent stage tables, then rows
   L2-normalised;
2. structural prompt: the propagation graph is the union of all data seen
   so far (pretrain + finetune + ``test_1..test_{s-1}``);
3. a ``for_tune`` model (random gate) generates frozen embeddings, twice
   with independent gate draws: once for the finetune model's tables and
   once for the retrieval library;
4. a ``finetune`` model (learned gate, optional LoRA, RAG over the library
   built on the stage graph) trains on the stage's finetune split with
   best-recall early stopping;
5. the stages' recall and ndcg are collected and averaged.

:func:`staged_dynamic` is the loop of the dynamic baselines (ROLAND,
EvolveGCN-H/-O and their plugin crosses): per stage the model is rebuilt on
the stage graph from the previous stage's tables and GRU, ROLAND against
its meta model's layers and EvolveGCN-H against the previous stage's
embeddings.

Every draw of a stage comes from generators seeded by ``(seed, stage,
purpose)``, never from what earlier stages consumed, so a run resumed from
a stage checkpoint repeats the uninterrupted run exactly.

With ``mesh`` (one process per rank) every rank runs the loop on the same
draws: batches split over ``dp``, and with an ``idx`` axis over 1 the
stage graphs carry receiver-range shards and the tables shard over it
(:class:`~ragraph_tpu_torch.train.trainer.EdgeTrainer`); rank 0 alone
writes the stage checkpoints.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Callable

import numpy as np
import torch

from ragraph_tpu_torch.data.edgelist import load_edge_dataset, merge_rows
from ragraph_tpu_torch.device import resolve_device
from ragraph_tpu_torch.models.edge.dynamic import ema_merge
from ragraph_tpu_torch.models.edge.ragraph_edge import (EdgeGraphArrays,
                                                        RAGraphEdge)
from ragraph_tpu_torch.ops.similarity import l2_normalize
from ragraph_tpu_torch.parallel import is_writer
from ragraph_tpu_torch.parallel.mesh import axis_size
from ragraph_tpu_torch.train.checkpoint import to_host
from ragraph_tpu_torch.train.trainer import EdgeTrainer


def _validate_tables(tables: dict, num_users: int, num_items: int):
    """Reject pretrain tables whose row counts do not match the data: a
    checkpoint of another dataset would shift the user/item offsets and
    train on corrupt embeddings with finite losses throughout."""
    u = tables["user_embedding"].shape[0]
    i = tables["item_embedding"].shape[0]
    if (u, i) != (num_users, num_items):
        raise ValueError(
            f"pretrain tables have {u} user / {i} item rows but the "
            f"dataset has {num_users} users / {num_items} items — "
            f"wrong checkpoint for this dataset?")


def _validate_stage_ids(all_rows, num_users: int, num_items: int):
    """Reject user or item ids beyond the base range, which is fixed from
    pretrain + stage 1: a new user id in a later stage would collide with
    item node ``id - num_users`` in the bidirectional graph."""
    for si, rows in enumerate(all_rows):
        if not len(rows):
            continue
        arr = np.asarray(rows, dtype=np.int64)
        u, it = int(arr[:, 0].max()), int(arr[:, 1].max())
        if u >= num_users or it >= num_items:
            raise ValueError(
                f"rows[{si}] contains user {u} / item {it} beyond the "
                f"base id range ({num_users} users / {num_items} "
                f"items fixed from pretrain + stage 1); ids appearing "
                f"only in later stages are not representable — extend "
                f"the pretrain scan or re-index the stream")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def interpolative_merge(pretrain_tables: dict, recent_tables: list,
                        pretrain_weight: float = 0.5) -> dict:
    """Merge historical checkpoints. ``recent_tables`` is ordered most
    recent first; the weights are ``[w_pre, (1 - w_pre) ·
    norm1(arange(1..n)).flip()]``, so the most recent table gets the
    largest share. Rows are L2-normalised after merging. Returns f32 CPU
    tensors (the pretrain tables as they are when there is nothing to
    merge)."""
    if not recent_tables:
        return dict(pretrain_tables)
    n = len(recent_tables)
    decay = np.arange(1, n + 1, dtype=np.float32)
    decay = (decay / decay.sum())[::-1]
    weights = np.concatenate([[pretrain_weight],
                              (1 - pretrain_weight) * decay])
    out = {}
    for k in ("user_embedding", "item_embedding"):
        stacked = [_np(pretrain_tables[k])] + [_np(t[k])
                                               for t in recent_tables]
        merged = sum(w * t for w, t in zip(weights, stacked))
        out[k] = l2_normalize(torch.from_numpy(
            np.asarray(merged, dtype=np.float32)), dim=1)
    return out


def _stage_state_path(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, "staged_state.pkl")


def _save_stage_state(checkpoint_dir: str, state: dict) -> None:
    """Persist the staged loop's carried state: everything a stage reads
    from earlier ones. Written to a temporary file and renamed, so a crash
    in mid-write leaves the previous stage's state whole. Rank 0 writes."""
    if not is_writer():
        return
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = _stage_state_path(checkpoint_dir)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(to_host(state), f)
    os.replace(tmp, path)


def _load_stage_state(checkpoint_dir: str) -> dict | None:
    path = _stage_state_path(checkpoint_dir)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


@dataclasses.dataclass
class StageResult:
    recalls: list
    ndcgs: list

    @property
    def avg_recall(self):
        return float(np.mean(self.recalls))

    @property
    def avg_ndcg(self):
        return float(np.mean(self.ndcgs))


def stage_generator(seed: int, stage: int, purpose: int,
                    device: torch.device) -> torch.Generator:
    """The generator of one purpose of one stage, a function of ``(seed,
    stage, purpose)`` alone."""
    mixed = np.random.SeedSequence([seed, stage, purpose]).generate_state(
        1, dtype=np.uint64)[0]
    return torch.Generator(device).manual_seed(int(mixed) >> 1)


def _bucket(n_rows: int) -> int:
    """Bidirectional edges of ``n_rows`` interactions, rounded up so that
    every stage's graph pads to one edge count."""
    return -((-2 * n_rows) // 4096) * 4096


def _arrays_fn(mesh, dev: torch.device) -> Callable:
    """A dataset's graph arrays on ``dev``, with receiver-range shards when
    the mesh's ``idx`` axis is over 1."""
    n_shards = axis_size(mesh, "idx")

    def arrays(ds):
        g = EdgeGraphArrays.from_dataset(ds, dev)
        return g.with_sharding(n_shards) if n_shards > 1 else g
    return arrays


def _tree_to(tree, dev: torch.device):
    """Tensors (or numpy arrays) of a nested dict as f32 tensors on
    ``dev``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(_np(tree), dtype=np.float32)).to(dev)


def staged_dynamic(pretrain_rows, finetune_rows, stage_rows: list,
                   pretrain_tables: dict, cfg_factory: Callable, seed: int,
                   model_cls, *, device: str | torch.device = "cuda",
                   mode: str = "roland", hour_interval: float = 1.0,
                   num_epochs: int | None = None, meta_weight: float = 0.9,
                   logger: Callable = print, mesh=None,
                   val_rows: list | None = None,
                   checkpoint_dir: str | None = None,
                   resume: bool = False,
                   stop_after_stage: int | None = None) -> StageResult:
    """The staged loop of the dynamic baselines (ROLAND, EvolveGCN-H/-O
    and the plugin crosses of :func:`make_dynamic`).

    Each stage builds ``model_cls`` on the stage's finetune graph, padded
    to one edge count across stages, from the previous stage's tables; the
    previous stage's params (``meta_params``) give every other entry the
    new params share, the GRU's among them. ``mode="roland"`` sets the meta
    layers from the stage's starting params (``forward_lgn``, or for a
    cross its ``propagated_plain``), detached, and after the stage
    EMA-merges ``meta_params`` with weight ``meta_weight`` on the old;
    ``"evolvegcn_h"`` evolves against the previous stage's embeddings (the
    pretrain tables before the first stage). Arguments otherwise as
    :func:`staged_finetune`; with ``checkpoint_dir`` the carried state
    (tables, ``meta_params``, ``last_emb``, metrics) is written after every
    stage, and a resumed run equals an uninterrupted one bit for bit on the
    CPU.
    """
    dev = resolve_device(device)
    arrays = _arrays_fn(mesh, dev)
    base_ds = load_edge_dataset(
        pretrain_rows, val_rows if val_rows is not None else stage_rows[0],
        hour_interval=hour_interval)
    num_users, num_items = base_ds.num_users, base_ds.num_items
    _validate_tables(pretrain_tables, num_users, num_items)

    all_rows = [pretrain_rows, finetune_rows, *stage_rows]
    _validate_stage_ids(all_rows, num_users, num_items)
    recalls, ndcgs = [], []
    tables = dict(pretrain_tables)
    meta_params = None
    last_emb = None
    start_stage = 1
    if checkpoint_dir is not None and resume:
        state = _load_stage_state(checkpoint_dir)
        if state is not None:
            tables = dict(state["tables"])
            meta_params = _tree_to(state["meta_params"], dev)
            last_emb = (_tree_to(state["last_emb"], dev)
                        if state["last_emb"] is not None else None)
            recalls, ndcgs = list(state["recalls"]), list(state["ndcgs"])
            start_stage = int(state["stage"]) + 1
            logger(f"resuming dynamic staged loop after completed stage "
                   f"{state['stage']} ({checkpoint_dir})")
    ft_bucket = _bucket(max(len(r) for r in all_rows[1:-1]))

    for stage in range(start_stage, len(stage_rows) + 1):
        def gen(purpose):
            return stage_generator(seed, stage, purpose, dev)

        ft_dataset = load_edge_dataset(
            all_rows[stage], stage_rows[stage - 1],
            hour_interval=hour_interval, num_users=num_users,
            num_items=num_items, phase="finetune",
            user_hist=all_rows[:stage], pad_edges_to=ft_bucket)
        model = model_cls(cfg_factory("finetune"), arrays(ft_dataset),
                          phase="finetune", mesh=mesh)
        params = model.init_params(gen(1), pretrained_tables=(
            _tree_to(tables["user_embedding"], dev),
            _tree_to(tables["item_embedding"], dev)))
        if meta_params is not None:
            # the GRU and the (EMA-merged) tables carry across stages
            params = {**params,
                      **{k: meta_params[k] for k in meta_params
                         if k in params and k != "gru"},
                      "gru": meta_params["gru"]}

        if mode == "roland":
            with torch.no_grad():
                if hasattr(model, "forward_lgn"):
                    meta_layers = model.forward_lgn(params,
                                                    return_layers=True)
                else:       # a cross: its layers with the fusion off
                    meta_layers = model.propagated_plain(params)
            model.set_meta_layers(meta_layers)
        elif mode == "evolvegcn_h":
            if last_emb is None:
                last_emb = torch.cat(
                    [_tree_to(tables["user_embedding"], dev),
                     _tree_to(tables["item_embedding"], dev)], dim=0)
            model.set_last_emb(last_emb)

        logger(f"--- dynamic stage {stage} ({mode})")
        trainer = EdgeTrainer(model, ft_dataset, logger=logger, mesh=mesh)
        result = trainer.train(params, gen(2), num_epochs=num_epochs,
                               rng=np.random.default_rng(stage))
        recalls.append(float(result.best_perform["recall"][0]))
        ndcgs.append(float(result.best_perform["ndcg"][0]))

        best = result.best_params
        tables = {k: _np(best[k]) for k in ("user_embedding",
                                            "item_embedding")}
        if mode == "roland" and meta_params is not None:
            meta_params = ema_merge(best, meta_params,
                                    meta_weight=meta_weight)
        else:
            meta_params = best
        u_emb, i_emb = model.generate(best)
        last_emb = torch.cat([u_emb, i_emb], dim=0)
        logger(f"stage {stage}: recall={recalls[-1]:.4f} "
               f"ndcg={ndcgs[-1]:.4f}")
        if checkpoint_dir is not None:
            _save_stage_state(checkpoint_dir, {
                "stage": stage, "tables": tables,
                "meta_params": meta_params, "last_emb": last_emb,
                "recalls": recalls, "ndcgs": ndcgs})
        if stop_after_stage is not None and stage >= stop_after_stage:
            logger(f"stopping after stage {stage} (stop_after_stage)")
            break

    return StageResult(recalls=recalls, ndcgs=ndcgs)


def staged_finetune(pretrain_rows, finetune_rows, stage_rows: list,
                    pretrain_tables: dict, cfg_factory: Callable,
                    seed: int, *, device: str | torch.device = "cuda",
                    hour_interval: float = 1.0, updt_inter: int = 1,
                    num_epochs: int | None = None,
                    logger: Callable = print, model_cls=RAGraphEdge,
                    mesh=None, val_rows: list | None = None,
                    checkpoint_dir: str | None = None,
                    resume: bool = False,
                    stop_after_stage: int | None = None) -> StageResult:
    """Run the staged loop.

    Args:
      pretrain_rows / finetune_rows / stage_rows: interaction row lists
        (``(user, item, time)``); ``stage_rows[i]`` is ``test_{i+1}``.
      pretrain_tables: ``{"user_embedding", "item_embedding"}`` of the
        pretrained model (numpy arrays or tensors).
      cfg_factory: ``(phase: str) -> EdgeModelConfig``.
      seed: root of every stage's generators (:func:`stage_generator`).
      updt_inter: how many recent stage tables feed the interpolative merge.
      val_rows: the pretrain validation rows; the id space is fixed from
        pretrain + validation (else pretrain + stage 1).
      checkpoint_dir: if set, the loop state (stage index, the last
        ``updt_inter`` stage tables, collected metrics) is written after
        every stage.
      resume: with ``checkpoint_dir``, continue after the last completed
        stage; equal bit for bit to an uninterrupted run on the CPU.
      stop_after_stage: return after this stage (its checkpoint written).
      mesh: a ``DeviceMesh``: batches split over ``dp``; with an ``idx``
        axis over 1 the tables row-shard over it and the propagation runs
        per receiver range (see the module doc).
    """
    dev = resolve_device(device)
    arrays = _arrays_fn(mesh, dev)
    base_ds = load_edge_dataset(
        pretrain_rows, val_rows if val_rows is not None else stage_rows[0],
        hour_interval=hour_interval)
    num_users, num_items = base_ds.num_users, base_ds.num_items
    _validate_tables(pretrain_tables, num_users, num_items)

    all_rows = [pretrain_rows, finetune_rows, *stage_rows]
    _validate_stage_ids(all_rows, num_users, num_items)
    saved_tables: list[dict] = []
    recalls, ndcgs = [], []
    start_stage = 1
    if checkpoint_dir is not None and resume:
        state = _load_stage_state(checkpoint_dir)
        if state is not None:
            saved_tables = list(state["saved_tables"])
            recalls, ndcgs = list(state["recalls"]), list(state["ndcgs"])
            start_stage = int(state["stage"]) + 1
            logger(f"resuming staged loop after completed stage "
                   f"{state['stage']} ({checkpoint_dir})")

    # every stage's graphs are padded to the largest stage's bucket, so the
    # edge arrays have one shape across the loop
    prompt_bucket = _bucket(len(merge_rows(all_rows)))
    ft_bucket = _bucket(max(len(r) for r in all_rows[1:-1]) or 1)

    for stage in range(start_stage, len(stage_rows) + 1):
        def gen(purpose):
            return stage_generator(seed, stage, purpose, dev)

        ft_idx = stage

        if len(saved_tables) >= updt_inter:
            merged = interpolative_merge(
                pretrain_tables, saved_tables[-updt_inter:][::-1])
        else:
            merged = dict(pretrain_tables)

        # structural prompt graph: all data up to and with the ft split
        prompt_rows = merge_rows(all_rows[:ft_idx + 1])
        pre_dataset = load_edge_dataset(
            prompt_rows, all_rows[ft_idx], hour_interval=hour_interval,
            num_users=num_users, num_items=num_items,
            pad_edges_to=prompt_bucket)
        pre_model = model_cls(cfg_factory("for_tune"), arrays(pre_dataset),
                              phase="for_tune", mesh=mesh)
        # init_params supplies whatever else the class needs to generate;
        # the tables come from the merge
        pre_params = pre_model.init_params(gen(5))
        pre_params["user_embedding"] = _tree_to(merged["user_embedding"], dev)
        pre_params["item_embedding"] = _tree_to(merged["item_embedding"], dev)
        # two generate calls with independent gate draws: the finetune
        # model's tables and the library base must not share one draw
        pre_u, pre_i = pre_model.generate(pre_params, generator=gen(1))
        res_u, res_i = pre_model.generate(pre_params, generator=gen(6))

        ft_dataset = load_edge_dataset(
            all_rows[ft_idx], stage_rows[stage - 1],
            hour_interval=hour_interval, num_users=num_users,
            num_items=num_items, phase="finetune",
            user_hist=all_rows[:ft_idx], pad_edges_to=ft_bucket)
        model = model_cls(cfg_factory("finetune"), arrays(ft_dataset),
                          phase="finetune", mesh=mesh)
        if model.use_rag:
            model.make_resource_graph(res_u, res_i, gen(2))
        params = model.init_params(gen(3), pretrained_tables=(pre_u, pre_i))

        logger(f"--- stage {stage}: ft rows={len(all_rows[ft_idx])} "
               f"test users={len(ft_dataset.test_user_dict)}")
        trainer = EdgeTrainer(model, ft_dataset, logger=logger, mesh=mesh)
        result = trainer.train(params, gen(4), num_epochs=num_epochs,
                               rng=np.random.default_rng(stage))

        recalls.append(float(result.best_perform["recall"][0]))
        ndcgs.append(float(result.best_perform["ndcg"][0]))
        saved_tables.append({
            "user_embedding": _np(result.best_params["user_embedding"]),
            "item_embedding": _np(result.best_params["item_embedding"])})
        logger(f"stage {stage}: recall={recalls[-1]:.4f} "
               f"ndcg={ndcgs[-1]:.4f}")
        if checkpoint_dir is not None:
            # only the last updt_inter tables feed later merges
            _save_stage_state(checkpoint_dir, {
                "stage": stage,
                "saved_tables": saved_tables[-updt_inter:],
                "recalls": recalls, "ndcgs": ndcgs})
        if stop_after_stage is not None and stage >= stop_after_stage:
            logger(f"stopping after stage {stage} (stop_after_stage)")
            break

    return StageResult(recalls=recalls, ndcgs=ndcgs)
