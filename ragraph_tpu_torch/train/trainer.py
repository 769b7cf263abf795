"""Edge-model trainer: epoch loop, evaluation each epoch, early stop,
checkpoints (counterpart of ``ragraph_tpu/train/trainer.py``).

Shuffled edge batches with host-sampled negatives, Adam, an evaluation after
every epoch, the best-recall snapshot, and a patience stop. Where the JAX
trainer jits one pure step that returns new arrays, this one makes the
parameters leaf tensors and lets ``torch.optim.Adam`` update them in place;
so the best-recall snapshot is a clone, not a reference. A background
thread makes the next batches (:mod:`.prefetch`) while a step runs; with
``RAGRAPH_MEM_ANALYSIS`` set, the device's memory after the first step is
logged (:func:`.profiling.record_memory_analysis`). Under a profiler
recording a step is span ``step``, holding ``backward`` and ``adam``, and
the batch's copy is ``to_device`` (:func:`.profiling.span`). optax's ``adam``
and torch's share their defaults (b1 0.9, b2 0.999, eps 1e-8 added outside
the root), so the two trainers follow the same trajectory from the same
batches and masks.

With ``mesh`` (a ``DeviceMesh``, one process per rank): the embedding
tables are placed row-sharded over ``idx`` (each rank holds its block, and
so do their Adam moments), everything else replicated from rank 0; each
rank trains on its ``dp`` share of every batch (the whole batch for models
whose loss couples its rows, ``rows_independent``); gradients are summed as
:mod:`ragraph_tpu_torch.parallel.dp` sets out. Every rank draws the same
batches and masks from the same seeds, and evaluates the same gathered
tables; rank 0 alone writes the checkpoint, which holds whole tables as a
single-device run's does, and ``TrainResult.best_params`` holds them whole
on every rank.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from ragraph_tpu_torch.parallel import is_writer
from ragraph_tpu_torch.parallel.collectives import all_gather
from ragraph_tpu_torch.parallel.dp import (backward_global_mean, shard_batch,
                                           sync_grads)
from ragraph_tpu_torch.parallel.mesh import (axis_size, dp_extent,
                                             replicate, shard_rows)
from ragraph_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from ragraph_tpu_torch.train.metrics import RankingEvaluator
from ragraph_tpu_torch.train.prefetch import prefetch
from ragraph_tpu_torch.train.profiling import record_memory_analysis, span


@dataclasses.dataclass
class TrainResult:
    best_perform: dict
    best_params: Any
    epochs_run: int
    history: list


def map_params(fn: Callable, params: dict) -> dict:
    """Apply ``fn`` to every tensor of a params dict. LoRA factor pairs are
    tuples of tensors and stay tuples; a nested dict of tensors (the GRU of
    the dynamic models, ``gru``) stays a dict."""
    def one(v):
        if isinstance(v, dict):
            return {k: fn(t) for k, t in v.items()}
        if isinstance(v, (tuple, list)):
            return tuple(fn(t) for t in v)
        return fn(v)
    return {k: one(v) for k, v in params.items()}


def _map_named(fn: Callable, params: dict) -> dict:
    """``fn(top-level name, tensor)`` on every tensor of a params dict, with
    the shape of :func:`map_params`."""
    return {k: map_params(lambda t, k=k: fn(k, t), {k: v})[k]
            for k, v in params.items()}


def param_leaves(params: dict) -> list:
    """``(name, tensor)`` for every tensor of a params dict, in key order:
    ``user_lora.0`` for a factor pair's entries, ``gru.w_ih`` for a nested
    dict's."""
    out = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            out += [(f"{k}.{n}", v[n]) for n in sorted(v)]
        elif isinstance(v, (tuple, list)):
            out += [(f"{k}.{i}", t) for i, t in enumerate(v)]
        else:
            out.append((k, v))
    return out


class EdgeTrainer:
    """Train a :class:`TemporalLightGCN`-family model on an EdgeDataset."""

    def __init__(self, model, dataset, cfg=None, logger: Callable = print,
                 evaluator: RankingEvaluator | None = None, mesh=None):
        self.mesh = mesh
        self.model = model
        self.dataset = dataset
        self.cfg = cfg or model.cfg
        self.log = logger
        self.evaluator = evaluator or RankingEvaluator(
            metrics=self.cfg.metrics, ks=self.cfg.metrics_k,
            eval_batch_size=self.cfg.eval_batch_size)

    # -- multi-device placement -----------------------------------------------

    def _is_table(self, name: str, t: torch.Tensor) -> bool:
        """An ``idx``-sharded leaf: an embedding table on a mesh whose
        ``idx`` axis is over 1 (the JAX trainer's placement rule)."""
        return (axis_size(self.mesh, "idx") > 1 and "." not in name
                and name.endswith("_embedding") and t.dim() == 2)

    def _place(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's copy of a whole leaf: its row block of a table, else
        rank 0's values."""
        if self.mesh is None:
            return t
        if self._is_table(name, t):
            self._rows[name] = t.shape[0]
            return shard_rows(self.mesh, t)
        return replicate(self.mesh, t)

    def _whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A placed leaf (or its Adam moment) made whole again."""
        if self.mesh is None or name not in self._rows:
            return t
        return all_gather(t.detach(), self.mesh, "idx")[: self._rows[name]]

    def whole_params(self, params: dict) -> dict:
        """``params`` with every sharded table gathered whole (a collective:
        every rank calls it); ``params`` itself off a mesh."""
        if self.mesh is None:
            return params
        return _map_named(lambda n, t: self._whole(n, t).detach().clone(),
                          params)

    # -- one step ------------------------------------------------------------

    def prepare(self, params: dict):
        """Leaf copies of ``params`` with ``requires_grad`` and their Adam.
        Frozen LoRA factors (``lora_train_factors=False``) stay out of the
        optimizer and need no gradient. On a mesh the copies are placed
        (tables row-sharded over ``idx``, the rest replicated)."""
        frozen = () if self.cfg.lora_train_factors else ("user_lora",
                                                         "item_lora")
        self._rows = {}
        params = map_params(lambda t: t.detach().clone(), params)
        if self.mesh is not None:
            params = _map_named(self._place, params)
        trainable = []
        for name, t in param_leaves(params):
            if name.split(".")[0] not in frozen:
                trainable.append(t.requires_grad_(True))
        return params, torch.optim.Adam(trainable, lr=self.cfg.lr)

    def _graph_and_resources(self):
        model = self.model
        resources = None
        if getattr(model, "use_rag", False) \
                and model.resource_keys is not None:
            resources = (model.resource_keys, model.resource_values)
        return model.graph, resources

    def step(self, params: dict, optimizer, batch, generator,
             edge_masks=None):
        """Loss, gradients and the Adam update of one batch of index
        tensors, in place on ``params``. Returns ``(loss, aux)`` as
        detached device scalars."""
        with span("step"):
            graph, resources = self._graph_and_resources()
            optimizer.zero_grad(set_to_none=True)
            if self.mesh is not None and self.model.rows_independent:
                batch = shard_batch(self.mesh, batch)
            loss, aux = self.model.cal_loss(params, batch, generator,
                                            graph=graph, resources=resources,
                                            edge_masks=edge_masks)
            with span("backward"):
                if self.mesh is None:
                    loss.backward()
                else:
                    # this rank's share of the global mean, then the
                    # gradient sums
                    loss = backward_global_mean(self.mesh, loss)
                    leaves = [(n, t) for n, t in param_leaves(params)
                              if t.requires_grad]
                    sync_grads(
                        self.mesh,
                        [t for n, t in leaves if not self._is_table(n, t)],
                        [t for n, t in leaves if self._is_table(n, t)])
            with span("adam"):
                optimizer.step()
            return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def _to_device(self, users, pos, neg):
        """A batch's index arrays on the graph's device; one copy when the
        three have one shape."""
        dev = self.model.graph.device
        with span("to_device"):
            if neg.shape == users.shape:
                return tuple(torch.from_numpy(np.stack([users, pos, neg]))
                             .to(dev))
            return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                         for a in (users, pos, neg))

    # -- the loop ------------------------------------------------------------

    def train(self, params: dict, generator: torch.Generator,
              num_epochs: int | None = None,
              rng: np.random.Generator | None = None,
              checkpoint_dir: str | None = None,
              checkpoint_every: int = 10) -> TrainResult:
        """Train; ``generator`` (on the graph's device) feeds the dropout
        draws, ``rng`` the batch order and the negatives.

        With ``checkpoint_dir``, params, Adam moments, the generator's
        state, epoch and best metrics are saved every ``checkpoint_every``
        epochs as ``train_state.pkl``, and a later call resumes from it.
        """
        cfg = self.cfg
        rng = rng or np.random.default_rng(0)
        num_epochs = num_epochs if num_epochs is not None else cfg.num_epochs
        if self.mesh is not None and cfg.batch_size % dp_extent(self.mesh):
            raise ValueError(f"batch_size {cfg.batch_size} must divide by "
                             f"the data-parallel extent "
                             f"{dp_extent(self.mesh)}")
        params, optimizer = self.prepare(params)

        best = {"recall": np.zeros(len(cfg.metrics_k)),
                "ndcg": np.zeros(len(cfg.metrics_k))}
        best_params = map_params(lambda t: t.detach().clone(), params)
        stop_counter = 0
        history = []
        epochs_run = 0
        start_epoch = 0

        resume_path = (os.path.join(checkpoint_dir, "train_state")
                       if checkpoint_dir else None)
        if resume_path and os.path.exists(resume_path + ".pkl"):
            snap = restore_checkpoint(resume_path)
            dev = self.model.graph.device
            self._load_state(params, optimizer, snap["params"],
                             snap["opt_state"])
            generator.set_state(torch.from_numpy(snap["generator_state"]))
            best = snap["best"]
            best_params = _map_named(
                lambda n, a: self._place(
                    n, torch.from_numpy(np.array(a)).to(dev)),
                snap["best_params"])
            start_epoch = int(snap["epoch"]) + 1
            stop_counter = int(snap["stop_counter"])
            self.log(f"resumed from {resume_path} at epoch {start_epoch}")

        n_negs = cfg.n_negs if getattr(self.model, "multi_negs",
                                       False) else 1
        for epoch in range(start_epoch, num_epochs):
            t0 = time.time()
            losses = []
            # the next batches are sampled on a thread while this one trains
            with prefetch(self.dataset.train_batches(
                    cfg.batch_size, rng, n_negs=n_negs,
                    drop_remainder=True), depth=2) as batches:
                for users, pos, neg in batches:
                    loss, _ = self.step(params, optimizer,
                                        self._to_device(users, pos, neg),
                                        generator)
                    # device scalars, read once per epoch
                    losses.append(loss)
                    if (epoch == start_epoch and len(losses) == 1
                            and os.environ.get("RAGRAPH_MEM_ANALYSIS")):
                        record_memory_analysis(
                            "edge_step", self.model.graph.device, self.log)
            nb = len(losses)
            ep_loss = float(torch.stack(losses).sum()) if losses else 0.0
            train_time = time.time() - t0

            user_emb, item_emb = self.model.generate(params)
            result = self.evaluator.evaluate(
                user_emb, item_emb, self.dataset.test_user_dict,
                self.dataset.user_hist_dict)
            history.append({"epoch": epoch, "loss": ep_loss / max(nb, 1),
                            **{m: v.tolist() for m, v in result.items()},
                            "train_time": round(train_time, 2)})
            self.log(f"epoch {epoch}: loss={ep_loss / max(nb, 1):.4f} "
                     + " ".join(f"{m}@{k}={v[i]:.4f}"
                                for m, v in result.items()
                                for i, k in enumerate(cfg.metrics_k))
                     + f" ({train_time:.1f}s)")
            epochs_run = epoch + 1

            if result["recall"][0] > best["recall"][0]:
                best = result
                # a clone: Adam goes on updating ``params`` in place
                best_params = map_params(lambda t: t.detach().clone(),
                                         params)
                stop_counter = 0
            else:
                stop_counter += 1
                if stop_counter >= cfg.early_stop_patience:
                    self.log(f"early stop at epoch {epoch}; best recall "
                             f"{best['recall'][0]:.4f}")
                    break

            if resume_path and (epoch + 1) % checkpoint_every == 0:
                # gathered on every rank, written by rank 0
                snap = {"params": self.whole_params(params),
                        "opt_state": self._opt_state(params, optimizer),
                        "generator_state": generator.get_state(),
                        "best": best,
                        "best_params": self.whole_params(best_params),
                        "epoch": epoch, "stop_counter": stop_counter}
                if is_writer():
                    save_checkpoint(resume_path, snap)

        return TrainResult(best_perform=best,
                           best_params=self.whole_params(best_params),
                           epochs_run=epochs_run, history=history)

    def _opt_state(self, params: dict, optimizer) -> dict:
        """Adam's step count and moments by parameter name, whole."""
        out = {}
        for name, t in param_leaves(params):
            st = optimizer.state.get(t)
            if st:
                top = name.split(".")[0]
                out[name] = {"step": float(st["step"]),
                             "exp_avg": self._whole(top, st["exp_avg"]),
                             "exp_avg_sq": self._whole(top,
                                                       st["exp_avg_sq"])}
        return out

    def _load_state(self, params: dict, optimizer, saved_params: dict,
                    saved_opt: dict) -> None:
        """Whole saved leaves and moments, each placed as its parameter."""
        saved = dict(param_leaves(saved_params))

        def placed(name, a, t):
            return self._place(name.split(".")[0], torch.from_numpy(
                np.array(a)).to(device=t.device, dtype=t.dtype))

        with torch.no_grad():
            for name, t in param_leaves(params):
                t.copy_(placed(name, saved[name], t))
                if name in saved_opt:
                    st = saved_opt[name]
                    optimizer.state[t] = {
                        "step": torch.tensor(float(st["step"])),
                        "exp_avg": placed(name, st["exp_avg"], t),
                        "exp_avg_sq": placed(name, st["exp_avg_sq"], t)}

    def evaluate_grouped(self, params):
        """Recall and ndcg apart for tuned users (in the train split) and
        untuned ones."""
        user_emb, item_emb = self.model.generate(params)
        out = {}
        for group in ("tuned", "untuned"):
            out[group] = self.evaluator.evaluate_grouped(
                user_emb, item_emb, self.dataset.test_user_dict,
                self.dataset.train_user_dict, self.dataset.user_hist_dict,
                group=group)
            self.log(f"[{group}] " + " ".join(
                f"{m}@{k}={v[i]:.4f}" for m, v in out[group].items()
                for i, k in enumerate(self.cfg.metrics_k)))
        return out
