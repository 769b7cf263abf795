"""Few-shot task CLI of the port (counterpart of
``ragraph_tpu/cli/fewshot.py``).

``python -m ragraph_tpu_torch.cli.fewshot finetune|vanilla [--level
node|graph]`` with the JAX CLI's flags plus ``--device`` (default ``cuda``;
``cpu`` runs the plain PyTorch versions of the kernels).

For each of ``--test-times`` tasks ``i``, ``np.random.default_rng(i)``
shuffles the dataset (0.5 / 0.3 / 0.2 train, val and test splits) and
draws a k-shot support set from the train split (``--shots`` nodes, or
whole graphs at ``--level graph``, per class), or the support is read from
``--support-dir`` (``<dir>/<i>.npz``, else ``<dir>/support.npz``). The
train graphs fill the library through the frozen first layer; ``finetune``
trains the encoder by AdamW on the val batches (``--patience`` stops early
on the epoch loss and restores the best state); the val graphs are
appended; the test split is classified by cosine to the class prototypes.
The mean and std of the accuracies go to
``<results-dir>/fewshot_<mode>_<level>_<dataset>_shot<shots>.json``.

The encoder comes from ``<save-dir>/model_<dataset>.pkl`` (a JAX
``PrePrompt`` tree or the port's ``state_dict``, through
:func:`ragraph_tpu_torch.cli.node.load_encoder_state`) when that file holds
two or more layers, else from a random two-layer initialisation. The run
logs to the console and to ``<save-dir>/train_log_<stamp>.txt``.

``--mesh dp=D,idx=I`` (one process per rank, launched by ``python -m
torch.distributed.run``): the library is built sharded over ``idx`` and
retrieved through the sharded index, the encoder and the support set are
replicated, and the fine-tune batches split over ``dp``. Rank 0 writes the
files. ``--dist-backend`` (the port's own) as in ``cli.edge``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os

import numpy as np
import torch

from ragraph_tpu_torch import parallel
from ragraph_tpu_torch.cli.node import (RunObserver, load_dataset,
                                        load_encoder_state)
from ragraph_tpu_torch.data.batching import flat_batches, stacked_batches
from ragraph_tpu_torch.data.fewshot_export import (sample_k_shot_graphs,
                                                   sample_k_shot_nodes)
from ragraph_tpu_torch.device import resolve_device
from ragraph_tpu_torch.models.ragraph_fewshot import (
    FEWSHOT_GRAPH_WEIGHTS, FEWSHOT_NODE_WEIGHTS, FewshotSupportSet,
    RAGraphFewshot, RAGraphFewshotConfig, fewshot_library_config)
from ragraph_tpu_torch.train.logging import RunLogger
from ragraph_tpu_torch.utils.seed import seed_everything

# main's RunLogger(exp_name="cli") sends the records of this logger and of
# the other CLI module's to the console and <save-dir>/train_log_*.txt
log = logging.getLogger("ragraph_tpu_torch.cli.fewshot")


def build_parser():
    p = argparse.ArgumentParser("ragraph_tpu_torch.fewshot")
    p.add_argument("mode", choices=["finetune", "vanilla"])
    p.add_argument("--dataset", default="SYNTH")
    p.add_argument("--data-root", default="data")
    p.add_argument("--level", choices=["node", "graph"], default="node")
    p.add_argument("--shots", type=int, default=5)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--retrieve-num", type=int, default=5)
    p.add_argument("--retrieve-weight", type=float, default=None,
                   help="override the per-dataset fusion weight table")
    p.add_argument("--label-weight", type=float, default=None)
    p.add_argument("--test-times", type=int, default=5)
    p.add_argument("--seed", type=int, default=42,
                   help="accepted as the JAX CLI accepts it; every draw "
                        "of the protocol is seeded by the task's index")
    p.add_argument("--patience", type=int, default=None,
                   help="early-stop patience on the epoch loss, restoring "
                        "the best state (default: off, train all --epochs "
                        "and keep the final state)")
    p.add_argument("--support-dir", default=None,
                   help="load k-shot support sets from <dir>/<task>.npz "
                        "(falling back to <dir>/support.npz, one set shared "
                        "by every task) instead of sampling; keys: "
                        "features/labels/adj, + graph_len at --level graph")
    p.add_argument("--noise", action="store_true")
    p.add_argument("--save-dir", default="modelset")
    p.add_argument("--results-dir", default="results")
    p.add_argument("--library-capacity", type=int, default=65536)
    p.add_argument("--mesh", default=None, metavar="dp=D,idx=I",
                   help="multi-device layout, one process per rank (python "
                        "-m torch.distributed.run): the library is built "
                        "sharded over idx, fine-tune batches split over dp "
                        "with the encoder and support set replicated. "
                        "dp*idx must equal the world size.")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="with --mesh: the process group's backend (default "
                        "nccl on the card, gloo on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch "
                        "versions of the kernels")
    return p


def load_two_layer_encoder(save_dir: str, dataset: str):
    """The pretrain checkpoint's ``state_dict`` when it holds two or more
    encoder layers (the encode/decode split), else None."""
    state = load_encoder_state(save_dir, dataset)
    if state is not None and "gcn.convs.1.lin.weight" not in state:
        log.info("checkpoint %s has <2 encoder layers; using random 2-layer "
                 "init (pretrain with --encoder-layers 2 first)",
                 os.path.join(save_dir, f"model_{dataset}"))
        return None
    return state


def load_support(args, task_i: int, train, num_class: int,
                 rng: np.random.Generator):
    """The task's support arrays ``(features, labels, adj, graph_ids)``:
    read from ``--support-dir`` or drawn from the train split with
    ``rng``."""
    graph_ids = None
    if args.support_dir is not None:
        path = os.path.join(args.support_dir, f"{task_i}.npz")
        if not os.path.exists(path):
            path = os.path.join(args.support_dir, "support.npz")
        data = np.load(path)
        feats, labels, adj = data["features"], data["labels"], data["adj"]
        if "graph_len" in data:
            lens = data["graph_len"]
            graph_ids = np.repeat(np.arange(len(lens)), lens)
    elif args.level == "graph":
        feats, adj, labels, lens = sample_k_shot_graphs(train, args.shots,
                                                        num_class, rng)
        graph_ids = np.repeat(np.arange(len(lens)), lens)
    else:
        feats, labels, adj = sample_k_shot_nodes(train, args.shots,
                                                 num_class, rng)
    return feats, labels, adj, graph_ids


def run_task(args, ds, encoder_state, task_i: int, device,
             observer: RunObserver | None = None, mesh=None) -> float:
    """One task of the protocol; returns its test accuracy. With ``mesh``
    the library is sharded over ``idx`` when that axis is over 1 and the
    fine-tune steps split their batches over ``dp``."""
    obs = observer or RunObserver()
    rng = np.random.default_rng(task_i)
    dsi = ds.shuffle(rng)
    train, val, test = dsi.subset(0, .5), dsi.subset(.5, .8), \
        dsi.subset(.8, 1)
    pad = args.batch_size * max(g.features.shape[0] for g in ds.graphs)
    num_class = max(ds.num_node_classes, 2)
    feats, labels, adj, graph_ids = load_support(args, task_i, train,
                                                 num_class, rng)
    support = FewshotSupportSet(
        torch.from_numpy(np.asarray(feats, np.float32)),
        torch.from_numpy(np.asarray(adj, np.float32)),
        torch.from_numpy(np.asarray(labels, np.int64)),
        None if graph_ids is None
        else torch.from_numpy(np.asarray(graph_ids, np.int64)))

    weights = (FEWSHOT_NODE_WEIGHTS if args.level == "node"
               else FEWSHOT_GRAPH_WEIGHTS)
    rw, lw = weights.get(args.dataset, (0.5, 0.5))
    if args.retrieve_weight is not None:
        rw = args.retrieve_weight
    if args.label_weight is not None:
        lw = args.label_weight
    libcfg = fewshot_library_config(retrieve_num=args.retrieve_num)
    cfg = RAGraphFewshotConfig(
        emb_size=args.hidden, num_class=num_class, level=args.level,
        retrieve_weight=rw, label_weight=lw,
        query_graph_hop=3 if args.level == "node" else 1,
        finetune=args.mode == "finetune", noise_finetune=args.noise,
        encoder_layers=2, library=libcfg)
    task = RAGraphFewshot(cfg, feature_dim=ds.num_node_attributes,
                          device=device)
    state = task.init_state(torch.Generator().manual_seed(task_i), support,
                            encoder_state=encoder_state,
                            library_capacity=args.library_capacity)

    def gen(seed):
        return torch.Generator(device).manual_seed(seed)

    def lib_batches(graphs):
        return stacked_batches(graphs, args.batch_size, num_classes=num_class,
                               num_graph_classes=num_class, device=device)

    def task_batches(graphs):
        """The node level's block-diagonal batches, the graph level's
        stacked ones."""
        if args.level == "node":
            return flat_batches(graphs, args.batch_size, pad,
                                num_classes=num_class, device=device)
        return lib_batches(graphs)

    shard_lib = parallel.axis_size(mesh, "idx") > 1
    if mesh is not None:
        parallel.replicate(mesh, state.encoder)
        state = dataclasses.replace(
            state, support=parallel.replicate(mesh, state.support))
        if shard_lib:
            state = dataclasses.replace(state, library=(
                parallel.sharded_library_init(
                    mesh, args.library_capacity, cfg.emb_size, num_class,
                    num_anchors=cfg.library.num_anchors, device=device)))

    def build(state, graphs, generator):
        """The library append: on the sharded store with ``idx`` over 1
        (every rank builds the same entries, each writes its rows)."""
        if not shard_lib:
            return task.build_library(state, lib_batches(graphs), generator)

        def encode(features, adj, node_mask=None):
            return task._encode(state, features, adj, node_mask)
        return dataclasses.replace(state, library=(
            parallel.build_sharded_library(
                mesh, state.library, encode, lib_batches(graphs),
                cfg.library, generator)))

    with obs.stage("library_build_train"):
        state = build(state, train.graphs, gen(task_i + 100))
    obs.after("library_build_train", task=task, state=state, libcfg=libcfg,
              train=train, val=val, pad=pad)

    if cfg.finetune:
        optimizer = task.make_optimizer(state, args.lr, args.weight_decay)
        batches = list(task_batches(val.graphs))
        step_gen = gen(task_i + 200)
        best_loss, best_params, trigger = float("inf"), None, 0
        for epoch in range(args.epochs):
            with obs.stage("finetune_epoch"):
                losses = [task.train_step(state, optimizer, b, step_gen,
                                          mesh=mesh)
                          for b in batches]
            obs.after("finetune_epoch", losses=losses)
            epoch_loss = torch.stack(losses).mean()
            if epoch % 10 == 0:
                log.info("epoch %d loss %.6f", epoch, float(epoch_loss))
            if args.patience is None:
                continue
            # best-loss checkpoint and patience (one host read an epoch);
            # only the encoder trains, so it is the whole checkpoint
            if float(epoch_loss) < best_loss:
                best_loss, trigger = float(epoch_loss), 0
                best_params = {k: v.detach().clone() for k, v in
                               state.encoder.state_dict().items()}
            else:
                trigger += 1
                if trigger >= args.patience:
                    log.info("early stop at epoch %d", epoch)
                    break
        if best_params is not None:
            state.encoder.load_state_dict(best_params)
        obs.after("finetune", task=task, state=state, optimizer=optimizer,
                  batches=batches)

    # the protocol appends the val entries before the test
    with obs.stage("library_build_val"):
        state = build(state, val.graphs, gen(task_i + 300))
    obs.after("library_build_val", task=task, state=state, libcfg=libcfg,
              train=train, val=val, pad=pad)
    with obs.stage("test_accuracy"):
        if args.level == "node":
            return task.accuracy_node(state, task_batches(test.graphs))
        return task.accuracy_graph(state, task_batches(test.graphs))


def main(argv=None, observer: RunObserver | None = None) -> float:
    args = build_parser().parse_args(argv)
    mesh, device = parallel.mesh_from_args(args.mesh, args.device,
                                           args.dist_backend)
    RunLogger(save_dir=args.save_dir if parallel.is_writer() else None,
              exp_name="cli")
    seed_everything(args.seed)
    device = device or resolve_device(args.device)
    ds = load_dataset(args)
    encoder_state = load_two_layer_encoder(args.save_dir, args.dataset)
    (observer or RunObserver()).after("checkpoint",
                                      encoder_state=encoder_state)

    accs = []
    for task_i in range(args.test_times):
        accs.append(100.0 * run_task(args, ds, encoder_state, task_i, device,
                                     observer, mesh=mesh))
        log.info("task %d/%d: accuracy %.4f", task_i + 1, args.test_times,
                 accs[-1])
    mean, std = float(np.mean(accs)), float(np.std(accs))
    log.info("shots=%d Mean: [%.4f]  Std: [%.4f]", args.shots, mean, std)
    out = os.path.join(
        args.results_dir,
        f"fewshot_{args.mode}_{args.level}_{args.dataset}"
        f"_shot{args.shots}.json")
    if parallel.is_writer():
        os.makedirs(args.results_dir, exist_ok=True)
        with open(out, "w") as f:
            json.dump({"mean": mean, "std": std, "accuracy": accs}, f,
                      indent=4)
        log.info("results written to %s", out)
    return mean


if __name__ == "__main__":
    main()
