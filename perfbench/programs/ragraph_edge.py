"""The program under test for configurations whose ``model`` is
``ragraph_edge``: ``ragraph_tpu_torch``'s ``RAGraphEdge`` and its
``EdgeTrainer``, built as ``cli/edge.py`` and ``staged_finetune`` build them
for one stage.

Set-up makes the inputs (:mod:`perfbench.traffic`), loads them through the
port's loader, builds the graph arrays, a ``RAGraphEdge`` in the mix's
phase, the library (finetune phase) and an ``EdgeTrainer``. The loops in
:mod:`perfbench.loops` drive it.
"""

from __future__ import annotations

import time

import torch

from perfbench import traffic
from perfbench.trace import Spans

PAD_MULTIPLE = 4096       # staged_finetune pads stage graphs' edges to it


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_config(cfg: dict, phase: str):
    """The program's ``EdgeModelConfig``, as ``cli/edge.py`` makes it from
    ``edge_config_for``; refuses one that departs from the file."""
    from ragraph_tpu_torch.models.edge import edge_config_for
    mc = edge_config_for(
        cfg["dataset"], phase, emb_size=int(cfg["emb_size"]),
        num_layers=int(cfg["num_layers"]),
        edge_dropout=float(cfg["edge_dropout"]), lr=float(cfg["lr"]),
        batch_size=int(cfg["batch_size"]), use_noise=bool(cfg["use_noise"]),
        use_lora=bool(cfg["use_lora"]), segsum_impl=cfg["segsum_impl"],
        propagate_dtype=cfg["propagate_dtype"],
        retrieve_dtype=cfg["retrieve_dtype"], time_mode=cfg["time_mode"],
        eval_batch_size=int(cfg["eval_batch_size"]),
        metrics_k=(int(cfg["metrics_k"]),))
    want = dict(cfg["finetune"], weight_decay=cfg["weight_decay"]) \
        if phase == "finetune" else {"weight_decay": cfg["weight_decay"]}
    bad = {k: (getattr(mc, k), v) for k, v in want.items()
           if getattr(mc, k) != v}
    if bad:
        raise SystemExit(f"the program's configuration departs from the "
                         f"file: {bad}")
    return mc


class Program:
    """One cell's program objects, built from the seed's inputs.
    ``test_rows``: whether the loop evaluates, so needs the test stage."""

    def __init__(self, cfg: dict, mix: dict, seed: int,
                 device: torch.device, spans: Spans, test_rows: bool):
        from ragraph_tpu_torch.data.edgelist import load_edge_dataset
        from ragraph_tpu_torch.models.edge import (EdgeGraphArrays,
                                                   RAGraphEdge)
        from ragraph_tpu_torch.train.trainer import EdgeTrainer
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.spans = device, spans
        self.phase = mix["phase"]
        self.stages: dict[str, float] = {}     # set-up seconds by stage
        t = time.perf_counter()
        self.inputs = traffic.make_inputs(cfg, self.phase, seed, test_rows)
        t = self._stage("inputs", t)
        tr = self.inputs["train"]
        test = self.inputs["test"]
        finetune = self.phase == "finetune"
        pad = (-(-2 * len(tr["users"]) // PAD_MULTIPLE) * PAD_MULTIPLE
               if finetune else None)
        hist = self.inputs["hist"]
        self.mc = program_config(cfg, self.phase)
        self.ds = load_edge_dataset(
            traffic.as_rows(tr["users"], tr["items"], tr["times"]),
            traffic.as_rows(test[:, 0], test[:, 1]) if test is not None
            else [], hour_interval=float(cfg["hour_interval"]),
            num_users=int(cfg["num_users"]), num_items=int(cfg["num_items"]),
            phase=self.phase,
            user_hist=[traffic.as_rows(hist["users"], hist["items"],
                                       hist["times"])] if finetune else None,
            pad_edges_to=pad)
        if self.ds.num_edges < self.mc.batch_size:
            raise ValueError("fewer interactions than one batch")
        t = self._stage("load_edge_dataset", t)
        self.model = RAGraphEdge(self.mc,
                                 EdgeGraphArrays.from_dataset(self.ds, device),
                                 phase=self.phase)
        t = self._stage("graph_arrays", t)
        self.tables = traffic.make_tables(cfg, self.phase, seed, device)
        if finetune:
            lib = self.tables["library"]
            self.model.make_resource_graph(lib["user_embedding"],
                                           lib["item_embedding"])
        self._stage("tables_and_library", t)
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
        ft = self.cfg["finetune"]
        lib = self.model.resource_keys
        return {"num_nodes": self.model.graph.num_nodes,
                "num_edges": 2 * len(self.inputs["train"]["users"]),
                "emb_size": int(self.cfg["emb_size"]),
                "library_rows": int(lib.shape[0]) if lib is not None else 0,
                "retrieve_num": int(ft["retrieve_num"]),
                "rag_chunk": int(ft["rag_chunk"])}

    def close(self) -> None:
        """Stop the feed's thread and let go of the program's state."""
        feed = getattr(self, "feed", None)
        if feed is not None:
            feed.close()
        for name in ("params", "optimizer", "trainer", "model", "ds",
                     "generator", "feed"):
            self.__dict__.pop(name, None)
