"""Node-task CLI of the port (counterpart of ``ragraph_tpu/cli/node.py``).

``python -m ragraph_tpu_torch.cli.node finetune|vanilla [--noise]`` with the
JAX CLI's flags plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch versions of the kernels). Protocol: ``--test-times`` seeded reruns
with shuffled 0.5/0.3/0.8 splits, the library built from the train split by
the frozen encoder, (``finetune``: Adam over encoder and decoder on the val
split,) the val entries appended, accuracy on the test split, then
``<results-dir>/<tag>_node_<dataset>.json`` with ``mean``, ``std`` and
``accuracy``.

The encoder comes from ``<save-dir>/model_<dataset>.pkl`` (a pickle
checkpoint of the JAX package's ``PrePrompt`` variables, or of the port's
``state_dict``) when that file is there, else from a random
initialisation, as in the JAX CLI.

Not ported yet, each exiting with a pointer to ROADMAP.md: ``pretrain``,
``--level graph`` and ``--mesh``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys

import numpy as np
import torch

from ragraph_tpu_torch.convert import preprompt_params_from_jax
from ragraph_tpu_torch.data.batching import flat_batches, stacked_batches
from ragraph_tpu_torch.data.synthetic import synthetic_tu_dataset
from ragraph_tpu_torch.data.tu import load_tu_dataset
from ragraph_tpu_torch.device import resolve_device
from ragraph_tpu_torch.models.ragraph_node import (RAGraphNode,
                                                   RAGraphNodeConfig)
from ragraph_tpu_torch.rag.library import LibraryConfig
from ragraph_tpu_torch.train.checkpoint import restore_checkpoint

log = logging.getLogger("ragraph_tpu_torch.node")


def build_parser():
    p = argparse.ArgumentParser("ragraph_tpu_torch.node")
    p.add_argument("mode", choices=["pretrain", "finetune", "vanilla"])
    p.add_argument("--dataset", default="SYNTH",
                   help="TU dataset name, or SYNTH / SYNTH-HARD for "
                        "synthetic graphs")
    p.add_argument("--data-root", default="data")
    p.add_argument("--level", choices=["node", "graph"], default="node")
    p.add_argument("--noise", action="store_true",
                   help="adversarial noise-retrieval fine-tuning")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--encoder-layers", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--test-times", type=int, default=5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--save-dir", default="modelset")
    p.add_argument("--results-dir", default="results")
    p.add_argument("--library-capacity", type=int, default=65536)
    p.add_argument("--retrieve-dtype", choices=["input", "int8"],
                   default="input")
    p.add_argument("--retrieve-rescore-pad", type=int, default=0,
                   help="with --retrieve-dtype int8: exact-rescore "
                        "k+PAD int8 candidates")
    p.add_argument("--mesh", default=None, metavar="dp=D,idx=I")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch "
                        "versions of the kernels")
    return p


def load_dataset(args):
    if args.dataset == "SYNTH":
        return synthetic_tu_dataset(seed=0, num_graphs=120, num_classes=3,
                                    feat_dim=16)
    if args.dataset == "SYNTH-HARD":
        return synthetic_tu_dataset(seed=0, num_graphs=120, num_classes=3,
                                    feat_dim=16, signal=0.6, p_in=0.35,
                                    p_out=0.15, name="SYNTH-HARD")
    return load_tu_dataset(args.data_root, args.dataset)


def load_encoder_state(save_dir: str, dataset: str):
    """The encoder's ``state_dict`` from ``<save_dir>/model_<dataset>.pkl``,
    or None when there is no such file."""
    ckpt = os.path.join(save_dir, f"model_{dataset}")
    try:
        tree = restore_checkpoint(ckpt)
    except FileNotFoundError:
        log.info("no pretrain checkpoint found; using random encoder init")
        return None
    log.info("loaded pretrain checkpoint %s", ckpt)
    if "params" in tree or "gcn" in tree:
        return preprompt_params_from_jax(tree)
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


class RunObserver:
    """Hooks of one protocol run; this base class does nothing.

    ``stage(name)`` is a context manager round each stage
    (``library_build_train``, ``finetune_epoch``, ``library_build_val``,
    ``test_accuracy``); ``after(name, **objects)`` is called after a stage
    with the objects it made. A subclass can time the stages and inspect
    the state without a second copy of the protocol.
    """

    def stage(self, name: str):
        return contextlib.nullcontext()

    def after(self, name: str, **objects) -> None:
        pass


def eval_once(args, ds, encoder_state, seed_i: int, device,
              observer: RunObserver | None = None) -> float:
    """One seeded run of the protocol; returns the test accuracy."""
    obs = observer or RunObserver()
    rng = np.random.default_rng(seed_i)
    ds = ds.shuffle(rng)
    train, val, test = ds.subset(0, .5), ds.subset(.5, .8), ds.subset(.8, 1)
    pad = args.batch_size * max(g.features.shape[0] for g in ds.graphs)
    finetune = args.mode == "finetune"
    num_class = max(ds.num_node_classes, ds.num_graph_classes, 2)

    libcfg = LibraryConfig(level="node", retrieve_num=num_class + 1,
                           toy_graph_hop=2,
                           retrieve_dtype=args.retrieve_dtype,
                           retrieve_rescore_pad=args.retrieve_rescore_pad)
    cfg = RAGraphNodeConfig(emb_size=args.hidden, num_class=num_class,
                            finetune=finetune, noise_finetune=args.noise,
                            encoder_layers=args.encoder_layers,
                            library=libcfg)
    task = RAGraphNode(cfg, feature_dim=ds.num_node_attributes, device=device)
    state = task.init_state(torch.Generator().manual_seed(seed_i),
                            encoder_state=encoder_state,
                            library_capacity=args.library_capacity)

    def gen(seed):
        return torch.Generator(device).manual_seed(seed)

    def lib_batches(graphs):
        return stacked_batches(graphs, args.batch_size, num_classes=num_class,
                               num_graph_classes=num_class, device=device)

    with obs.stage("library_build_train"):
        state = task.build_library(state, lib_batches(train.graphs),
                                   gen(seed_i + 1))
    obs.after("library_build_train", task=task, state=state, libcfg=libcfg,
              train=train, val=val, pad=pad)

    if finetune:
        optimizer = task.make_optimizer(state, args.lr)
        batches = list(flat_batches(val.graphs, args.batch_size, pad,
                                    num_classes=num_class, device=device))
        noise_gen = gen(seed_i + 2)
        for epoch in range(args.epochs):
            with obs.stage("finetune_epoch"):
                losses = [task.train_step(state, optimizer, b, noise_gen)
                          for b in batches]
            obs.after("finetune_epoch", losses=losses)
            if epoch % 10 == 0:     # the only host read of the losses
                log.info("epoch %d loss %.6f", epoch,
                         float(torch.stack(losses).mean()))
        obs.after("finetune", task=task, state=state, optimizer=optimizer,
                  batches=batches)

    # the protocol appends the val entries before the test
    with obs.stage("library_build_val"):
        state = task.build_library(state, lib_batches(val.graphs),
                                   gen(seed_i + 3))
    obs.after("library_build_val", task=task, state=state, libcfg=libcfg,
              train=train, val=val, pad=pad)
    with obs.stage("test_accuracy"):
        acc = task.accuracy(state, flat_batches(test.graphs, args.batch_size,
                                                pad, num_classes=num_class,
                                                device=device))
    return acc


def run_eval(args, device, observer: RunObserver | None = None) -> float:
    ds = load_dataset(args)
    encoder_state = load_encoder_state(args.save_dir, args.dataset)
    accs = []
    for i in range(args.test_times):
        accs.append(100.0 * eval_once(args, ds, encoder_state, i, device,
                                      observer))
        log.info("run %d/%d: accuracy %.4f", i + 1, args.test_times,
                 accs[-1])
    mean, std = float(np.mean(accs)), float(np.std(accs))
    log.info("Mean: [%.4f]  Std: [%.4f]", mean, std)
    os.makedirs(args.results_dir, exist_ok=True)
    tag = "noise" if args.noise else args.mode
    out = os.path.join(args.results_dir,
                       f"{tag}_{args.level}_{args.dataset}.json")
    with open(out, "w") as f:
        json.dump({"mean": mean, "std": std, "accuracy": accs}, f, indent=4)
    log.info("results written to %s", out)
    return mean


def main(argv=None, observer: RunObserver | None = None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(message)s",
                            stream=sys.stderr)
    if args.retrieve_rescore_pad and args.retrieve_dtype != "int8":
        parser.error("--retrieve-rescore-pad requires --retrieve-dtype int8")
    for flag, what in ((args.mode == "pretrain",
                        "node pretraining (the Lp, DGI and GraphCL heads) "
                        "is not ported yet: ROADMAP.md, queue 1, item 5"),
                       (args.level == "graph",
                        "--level graph is not ported yet: ROADMAP.md, "
                        "queue 1, item 5"),
                       (args.mesh is not None,
                        "--mesh is not ported yet: ROADMAP.md, queue 1, "
                        "item 10")):
        if flag:
            raise SystemExit(what)
    return run_eval(args, resolve_device(args.device), observer)


if __name__ == "__main__":
    main()
