"""The program under test for configurations whose ``model`` is
``edge_dynamic``: a plugin crossed with a dynamic evolution
(``ragraph_tpu_torch``'s ``make_dynamic``; the configuration's ``plugin``
and ``dynamic``), one stage of ``staged_dynamic`` as the CLI trains it
(``cli.edge finetune --model <plugin> --dynamic <dynamic>``), and its
``EdgeTrainer``.

Set-up makes the inputs (:mod:`perfbench.traffic`), loads the stage's
finetune split through the port's loader (padded as ``staged_dynamic``
pads it), and builds the stage's model and params through
``staged.dynamic_stage``, the function ``staged_dynamic`` calls: the model
on the stage graph, the params from the starting tables (the seed's unit
rows) and a GRU drawn from the seed, and ROLAND's meta layers. The loops
in :mod:`perfbench.loops` drive it.
"""

from __future__ import annotations

import sys
import time

import torch

from perfbench import traffic
from perfbench.programs.ragraph_edge import (PAD_MULTIPLE, program_config,
                                             sync)
from perfbench.trace import Spans

# SGL's step runs three forwards (the dropout's and two views'), each with
# one GRU cell a layer
FORWARDS_PER_STEP = 3


class Leaves(dict):
    """A params dict whose nested entries are also found by the names
    ``param_leaves`` gives them (``gru.w_ih``)."""

    def __missing__(self, key):
        top, _, sub = key.partition(".")
        if sub and isinstance(self.get(top), dict):
            return self[top][sub]
        raise KeyError(key)


def dynamic_config(cfg: dict):
    """The program's ``EdgeModelConfig`` for the stage, as ``cli/edge.py``
    makes it; refuses one that departs from the file."""
    mc = program_config(dict(cfg, finetune={}), "finetune")
    bad = {k: (getattr(mc, k), cfg[k]) for k in ("temp", "lbd")
           if getattr(mc, k) != cfg[k]}
    # the program's fixed widths and rates: SGL's views keep 0.9 of the
    # survivors, ROLAND's GRU is as wide as the embedding
    if cfg["view_keep"] != 0.9:
        bad["view_keep"] = (0.9, cfg["view_keep"])
    if cfg["gru_size"] != mc.emb_size:
        bad["gru_size"] = (mc.emb_size, cfg["gru_size"])
    if bad:
        raise SystemExit(f"the program's configuration departs from the "
                         f"file: {bad}")
    return mc


class Program:
    """One cell's program objects, built from the seed's inputs.
    ``test_rows``: whether the loop evaluates, so needs the test stage."""

    def __init__(self, cfg: dict, mix: dict, seed: int,
                 device: torch.device, spans: Spans, test_rows: bool):
        # what this program needs of the port, first, so that a port
        # without it fails at once
        from ragraph_tpu_torch.cli.edge import model_class
        from ragraph_tpu_torch.data.edgelist import load_edge_dataset
        from ragraph_tpu_torch.models.edge.staged import dynamic_stage
        from ragraph_tpu_torch.train.trainer import EdgeTrainer
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.spans = device, spans
        self.phase = mix["phase"]
        if self.phase != "finetune":
            raise SystemExit("the dynamic crosses train in the finetune "
                             "phase")
        self.stages: dict[str, float] = {}     # set-up seconds by stage
        model_cls = model_class(cfg["plugin"], dynamic=cfg["dynamic"])
        self.mc = dynamic_config(cfg)
        print(f"precision: torch.backends.cuda.matmul.allow_tf32="
              f"{torch.backends.cuda.matmul.allow_tf32}", file=sys.stderr)
        t = time.perf_counter()
        self.inputs = traffic.make_inputs(cfg, self.phase, seed, test_rows)
        t = self._stage("inputs", t)
        tr, test, hist = (self.inputs[k] for k in ("train", "test", "hist"))
        self.ds = load_edge_dataset(
            traffic.as_rows(tr["users"], tr["items"], tr["times"]),
            traffic.as_rows(test[:, 0], test[:, 1]) if test is not None
            else [], hour_interval=float(cfg["hour_interval"]),
            num_users=int(cfg["num_users"]), num_items=int(cfg["num_items"]),
            phase=self.phase,
            user_hist=[traffic.as_rows(hist["users"], hist["items"],
                                       hist["times"])],
            pad_edges_to=-(-2 * len(tr["users"]) // PAD_MULTIPLE)
            * PAD_MULTIPLE)
        if self.ds.num_edges < self.mc.batch_size:
            raise ValueError("fewer interactions than one batch")
        t = self._stage("load_edge_dataset", t)
        start = traffic.make_tables(cfg, self.phase, seed, device)["params"]
        self.model, params = dynamic_stage(
            model_cls, lambda phase: self.mc, self.ds,
            {k: start[k] for k in ("user_embedding", "item_embedding")},
            traffic.torch_generator(seed, 6, device), mode=cfg["dynamic"],
            device=device)
        self.tables = {"params": Leaves(params)}
        self._stage("stage_model", t)
        self.trainer = EdgeTrainer(self.model, self.ds,
                                   logger=lambda *_: None)
        self.units = 0
        self.record: dict = {}

    def _stage(self, name: str, t0: float) -> float:
        sync(self.device)
        t = time.perf_counter()
        self.stages[name] = t - t0
        return t

    def shapes(self) -> dict:
        """The shapes the metric readers count from."""
        return {"num_nodes": self.model.graph.num_nodes,
                "num_edges": 2 * len(self.inputs["train"]["users"]),
                "emb_size": int(self.cfg["emb_size"]),
                "gru_cells": FORWARDS_PER_STEP * int(self.cfg["num_layers"])}

    def close(self) -> None:
        """Stop the feed's thread and let go of the program's state."""
        feed = getattr(self, "feed", None)
        if feed is not None:
            feed.close()
        for name in ("params", "optimizer", "trainer", "model", "ds",
                     "generator", "feed"):
            self.__dict__.pop(name, None)
