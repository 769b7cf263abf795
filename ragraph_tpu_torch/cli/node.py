"""Node- and graph-task CLI of the port (counterpart of
``ragraph_tpu/cli/node.py``).

``python -m ragraph_tpu_torch.cli.node pretrain|finetune|vanilla [--noise]
[--level node|graph]`` with the JAX CLI's flags plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch versions of the kernels).

- ``pretrain``: the encoder with its pretraining heads, trained by Adam on
  block-diagonal batches of the whole dataset for ``--pretrain-epochs``
  under the ``+``-joined ``--pretrain-loss`` terms (``lp``, ``dgi``,
  ``graphcl[:edge|mask|node|subgraph]``). The epoch with the lowest loss is
  saved as ``<save-dir>/model_<dataset>.pkl`` (the port's ``state_dict``);
  ``<results-dir>/pretrain_<dataset>.json`` holds ``loss_terms`` and
  ``epoch_losses``.
- ``finetune`` / ``vanilla``: ``--test-times`` seeded reruns with shuffled
  0.5/0.3/0.8 splits, the library built from the train split by the frozen
  encoder, (``finetune``: Adam over encoder and decoder on the val split,)
  the val entries appended, accuracy on the test split, then
  ``<results-dir>/<tag>_<level>_<dataset>.json`` with ``mean``, ``std`` and
  ``accuracy``. ``--level graph`` classifies whole graphs
  (:class:`ragraph_tpu_torch.models.ragraph_graph.RAGraphGraph`) on stacked
  batches, with the fusion weights of the dataset.

The encoder comes from ``<save-dir>/model_<dataset>.pkl`` (a pickle
checkpoint of the JAX package's ``PrePrompt`` variables, with or without the
heads, or of the port's ``state_dict``) when that file is there, else from a
random initialisation, as in the JAX CLI. The run logs to the console and
to ``<save-dir>/train_log_<stamp>.txt``.

``--mesh dp=D,idx=I`` (``finetune`` / ``vanilla``; one process per rank,
launched by ``python -m torch.distributed.run``): the library is built
sharded over ``idx`` (``parallel/sharded_library.py``; the store never
exists whole on one device) and retrieved through the sharded index, and
the fine-tune batches split over ``dp`` with replicated parameters. Rank 0
writes the files. ``--dist-backend`` (the port's own) as in ``cli.edge``.
"""

from __future__ import annotations

import argparse
import dataclasses
import contextlib
import json
import logging
import os

import numpy as np
import torch

from ragraph_tpu_torch import parallel
from ragraph_tpu_torch.convert import preprompt_params_from_jax
from ragraph_tpu_torch.data.batching import flat_batches, stacked_batches
from ragraph_tpu_torch.data.synthetic import synthetic_tu_dataset
from ragraph_tpu_torch.data.tu import load_tu_dataset
from ragraph_tpu_torch.device import resolve_device
from ragraph_tpu_torch.models.preprompt import (PrePrompt,
                                                corrupt_features,
                                                prompt_pretrain_sample)
from ragraph_tpu_torch.models.ragraph_graph import (GRAPH_FUSION_WEIGHTS,
                                                    RAGraphGraph,
                                                    RAGraphGraphConfig,
                                                    graph_library_config)
from ragraph_tpu_torch.models.ragraph_node import (RAGraphNode,
                                                   RAGraphNodeConfig)
from ragraph_tpu_torch.rag.library import LibraryConfig
from ragraph_tpu_torch.rag.pretrain_aug import (FLAVORS, draw_view,
                                                make_graphcl_views)
from ragraph_tpu_torch.train.checkpoint import (BestCheckpointKeeper,
                                                restore_checkpoint)
from ragraph_tpu_torch.train.logging import RunLogger
from ragraph_tpu_torch.utils.seed import seed_everything

# main's RunLogger(exp_name="cli") sends the records of this logger and of
# the other CLI module's to the console and <save-dir>/train_log_*.txt
log = logging.getLogger("ragraph_tpu_torch.cli.node")


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
    p.add_argument("--pretrain-loss", default="lp",
                   help="'+'-joined objectives: lp, dgi, graphcl[:FLAVOR] "
                        "with FLAVOR in {edge,mask,node,subgraph}")
    p.add_argument("--encoder-layers", type=int, default=1)
    p.add_argument("--lp-samples", type=int, default=100,
                   help="negatives per node for the Lp pretrain tuples")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--pretrain-epochs", type=int, default=30)
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
    p.add_argument("--mesh", default=None, metavar="dp=D,idx=I",
                   help="multi-device layout for finetune/vanilla, one "
                        "process per rank (python -m "
                        "torch.distributed.run): the library is BUILT "
                        "sharded over idx (parallel/sharded_library.py), "
                        "fine-tune batches split over dp with replicated "
                        "params. dp*idx must equal the world size; the "
                        "library capacity must divide by idx.")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="with --mesh: the process group's backend (default "
                        "nccl on the card, gloo on the CPU)")
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
    (``pretrain_epoch``; ``library_build_train``, ``finetune_epoch``,
    ``library_build_val``, ``test_accuracy``); ``after(name, **objects)`` is
    called after a stage with the objects it made. A subclass can time the
    stages and inspect the state without a second copy of the protocol.
    """

    def stage(self, name: str):
        return contextlib.nullcontext()

    def after(self, name: str, **objects) -> None:
        pass


def pretrain_terms(spec: str):
    """``(terms, graphcl flavors)`` of a ``--pretrain-loss`` value;
    ``graphcl`` alone is ``graphcl:edge``. An unknown term raises."""
    terms = spec.split("+")
    flavors = []
    for t in terms:
        if t.startswith("graphcl"):
            flavor = t.split(":", 1)[1] if ":" in t else "edge"
            if t not in ("graphcl", f"graphcl:{flavor}") \
                    or flavor not in FLAVORS:
                raise ValueError(f"unknown GraphCL term {t!r}")
            flavors.append(flavor)
        elif t not in ("lp", "dgi"):
            raise ValueError(f"unknown pretraining term {t!r}")
    return terms, flavors


def pretrain_loss(model: PrePrompt, terms, flavors, g, tuples,
                  generator: torch.Generator) -> torch.Tensor:
    """The summed pretraining loss of one block-diagonal batch ``g``, its
    random values drawn from ``generator``: the Lp dropout, the DGI
    shuffle (shared with GraphCL), and two views per GraphCL flavor, made
    from the normalised batch adjacency (and normalised again)."""
    total = torch.zeros((), device=g.features.device)
    if "lp" in terms:
        total = total + model(g.features, g.adj, tuples, g.node_mask,
                              generator=generator)
    if "dgi" in terms or flavors:
        shuf = corrupt_features(g.features, g.node_mask, generator)
    if "dgi" in terms:
        total = total + model.dgi_loss(g.features, shuf, g.adj, g.node_mask)
    for flavor in flavors:
        draws = tuple(draw_view(generator, flavor, g.node_mask)
                      for _ in range(2))
        v1, v2 = make_graphcl_views(flavor, g.features, g.adj, g.node_mask,
                                    draws)
        total = total + model.graphcl_flavor_loss(
            g.features, shuf, g.adj, v1, v2, g.node_mask, flavor=flavor)
    return total


def run_pretrain(args, terms, flavors, device,
                 observer: RunObserver | None = None) -> str:
    """Pretrain the encoder on the loss ``terms`` and GraphCL ``flavors``
    of :func:`pretrain_terms`; returns the path of the best checkpoint."""
    obs = observer or RunObserver()
    _, rng = seed_everything(args.seed)
    ds = load_dataset(args)
    pad = args.batch_size * max(g.features.shape[0] for g in ds.graphs)
    model = PrePrompt(ds.num_node_attributes, hidden=args.hidden,
                      num_layers=args.encoder_layers,
                      generator=torch.Generator().manual_seed(args.seed)
                      ).to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8)
    generator = torch.Generator(device).manual_seed(args.seed + 2)
    keeper = BestCheckpointKeeper(args.save_dir,
                                  name=f"model_{args.dataset}")
    # the raw host adjacency comes with each batch, for the tuple sampler
    batches = list(flat_batches(ds.graphs, args.batch_size, pad,
                                with_host_adj=True, device=device))
    masks_host = [g.node_mask.cpu().numpy() for g, _ in batches]
    epoch_losses = []
    for epoch in range(args.pretrain_epochs):
        with obs.stage("pretrain_epoch"):
            losses = []
            for (g, raw_adj), mask_host in zip(batches, masks_host):
                raw = raw_adj > 0
                np.fill_diagonal(raw, False)
                tuples = torch.from_numpy(prompt_pretrain_sample(
                    raw.astype(np.float32), args.lp_samples, rng,
                    mask_host)).to(device)
                optimizer.zero_grad(set_to_none=True)
                loss = pretrain_loss(model, terms, flavors, g, tuples,
                                     generator)
                loss.backward()
                optimizer.step()
                losses.append(loss.detach())
        obs.after("pretrain_epoch", losses=losses)
        # the epoch's one host read of the losses
        epoch_losses.append(float(torch.stack(losses).mean()))
        log.info("epoch %d pretrain_loss %.6f", epoch, epoch_losses[-1])
        keeper.update(-epoch_losses[-1], model.state_dict())
    os.makedirs(args.results_dir, exist_ok=True)
    out = os.path.join(args.results_dir, f"pretrain_{args.dataset}.json")
    with open(out, "w") as f:
        json.dump({"loss_terms": terms, "epoch_losses": epoch_losses}, f,
                  indent=4)
    log.info("saved best pretrain checkpoint: %s", keeper.path)
    return keeper.path


def eval_once(args, ds, encoder_state, seed_i: int, device,
              observer: RunObserver | None = None, mesh=None) -> float:
    """One seeded run of the protocol; returns the test accuracy. With
    ``mesh`` the library is sharded over ``idx`` when that axis is over 1
    and the fine-tune steps split their batches over ``dp``."""
    obs = observer or RunObserver()
    rng = np.random.default_rng(seed_i)
    ds = ds.shuffle(rng)
    train, val, test = ds.subset(0, .5), ds.subset(.5, .8), ds.subset(.8, 1)
    pad = args.batch_size * max(g.features.shape[0] for g in ds.graphs)
    finetune = args.mode == "finetune"
    num_class = max(ds.num_node_classes, ds.num_graph_classes, 2)

    retr = dict(retrieve_dtype=args.retrieve_dtype,
                retrieve_rescore_pad=args.retrieve_rescore_pad)
    if args.level == "node":
        libcfg = LibraryConfig(level="node", retrieve_num=num_class + 1,
                               toy_graph_hop=2, **retr)
        cfg = RAGraphNodeConfig(emb_size=args.hidden, num_class=num_class,
                                finetune=finetune, noise_finetune=args.noise,
                                encoder_layers=args.encoder_layers,
                                library=libcfg)
        task = RAGraphNode(cfg, feature_dim=ds.num_node_attributes,
                           device=device)
    else:
        rw, lw = GRAPH_FUSION_WEIGHTS.get(args.dataset, (0.3, 0.3))
        libcfg = graph_library_config(num_class, **retr)
        cfg = RAGraphGraphConfig(emb_size=args.hidden, num_class=num_class,
                                 retrieve_weight=rw, label_weight=lw,
                                 finetune=finetune,
                                 noise_finetune=args.noise,
                                 encoder_layers=args.encoder_layers,
                                 library=libcfg)
        task = RAGraphGraph(cfg, feature_dim=ds.num_node_attributes,
                            device=device)
    state = task.init_state(torch.Generator().manual_seed(seed_i),
                            encoder_state=encoder_state,
                            library_capacity=args.library_capacity)

    def gen(seed):
        return torch.Generator(device).manual_seed(seed)

    def lib_batches(graphs):
        return stacked_batches(graphs, args.batch_size, num_classes=num_class,
                               num_graph_classes=num_class, device=device)

    shard_lib = parallel.axis_size(mesh, "idx") > 1
    if mesh is not None:
        parallel.replicate(mesh, state.encoder)
        parallel.replicate(mesh, state.decoder)
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
        return dataclasses.replace(state, library=(
            parallel.build_sharded_library(
                mesh, state.library, task.encoder_fn(state),
                lib_batches(graphs), cfg.library, generator)))

    def task_batches(graphs):
        """The node task's block-diagonal batches, the graph task's
        stacked ones."""
        if args.level == "node":
            return flat_batches(graphs, args.batch_size, pad,
                                num_classes=num_class, device=device)
        return lib_batches(graphs)

    with obs.stage("library_build_train"):
        state = build(state, train.graphs, gen(seed_i + 1))
    obs.after("library_build_train", task=task, state=state, libcfg=libcfg,
              train=train, val=val, pad=pad)

    if finetune:
        optimizer = task.make_optimizer(state, args.lr)
        batches = list(task_batches(val.graphs))
        noise_gen = gen(seed_i + 2)
        for epoch in range(args.epochs):
            with obs.stage("finetune_epoch"):
                losses = [task.train_step(state, optimizer, b, noise_gen,
                                          mesh=mesh)
                          for b in batches]
            obs.after("finetune_epoch", losses=losses)
            if epoch % 10 == 0:     # the only host read of the losses
                log.info("epoch %d loss %.6f", epoch,
                         float(torch.stack(losses).mean()))
        obs.after("finetune", task=task, state=state, optimizer=optimizer,
                  batches=batches)

    # the protocol appends the val entries before the test
    with obs.stage("library_build_val"):
        state = build(state, val.graphs, gen(seed_i + 3))
    obs.after("library_build_val", task=task, state=state, libcfg=libcfg,
              train=train, val=val, pad=pad)
    with obs.stage("test_accuracy"):
        acc = task.accuracy(state, task_batches(test.graphs))
    return acc


def run_eval(args, device, observer: RunObserver | None = None,
             mesh=None) -> float:
    seed_everything(args.seed)
    ds = load_dataset(args)
    encoder_state = load_encoder_state(args.save_dir, args.dataset)
    accs = []
    for i in range(args.test_times):
        accs.append(100.0 * eval_once(args, ds, encoder_state, i, device,
                                      observer, mesh=mesh))
        log.info("run %d/%d: accuracy %.4f", i + 1, args.test_times,
                 accs[-1])
    mean, std = float(np.mean(accs)), float(np.std(accs))
    log.info("Mean: [%.4f]  Std: [%.4f]", mean, std)
    tag = "noise" if args.noise else args.mode
    out = os.path.join(args.results_dir,
                       f"{tag}_{args.level}_{args.dataset}.json")
    if parallel.is_writer():
        os.makedirs(args.results_dir, exist_ok=True)
        with open(out, "w") as f:
            json.dump({"mean": mean, "std": std, "accuracy": accs}, f,
                      indent=4)
        log.info("results written to %s", out)
    return mean


def main(argv=None, observer: RunObserver | None = None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.retrieve_rescore_pad and args.retrieve_dtype != "int8":
        parser.error("--retrieve-rescore-pad requires --retrieve-dtype int8")
    mesh, mesh_dev = (parallel.mesh_from_args(args.mesh, args.device,
                                              args.dist_backend)
                      if args.mode != "pretrain" else (None, None))
    RunLogger(save_dir=args.save_dir if parallel.is_writer() else None,
              exp_name="cli")
    if args.mode == "pretrain":
        try:
            terms, flavors = pretrain_terms(args.pretrain_loss)
        except ValueError as e:
            parser.error(str(e))
        return run_pretrain(args, terms, flavors, resolve_device(args.device),
                            observer)
    return run_eval(args, mesh_dev or resolve_device(args.device), observer,
                    mesh=mesh)


if __name__ == "__main__":
    main()
