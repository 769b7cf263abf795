"""Edge (recommendation) CLI of the port (counterpart of
``ragraph_tpu/cli/edge.py``).

``python -m ragraph_tpu_torch.cli.edge pretrain|finetune|vanilla`` with the
JAX CLI's flags plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch versions of the kernels):

- ``pretrain`` trains ``--model`` on the pretrain split (``GraphPro`` for
  the dynamic models ``roland``, ``evolvegcn_h`` and ``evolvegcn_o``) and
  writes the best tables to ``<save-dir>/pretrain_<model>_<dataset>.pkl``
  and the best metrics to the ``.json`` of the same name;
- ``finetune`` runs the staged finetuning from those tables (it pretrains
  first when they are missing) and writes
  ``<save-dir>/finetune_<tag>_<dataset>.json``, the tag being
  ``<model>[-<dynamic>][-<prompt>]``: ``--dynamic`` crosses a plugin model
  (SGL, SimGCL, MixGCF) with ROLAND or EvolveGCN, ``--prompt`` a plugin
  model or LightGCN with a prompt vector (with ``--model GP`` it picks
  GP's prompt mode); a dynamic run takes the dynamic staged loop
  (``staged_dynamic``); ``--noise``, ``--lora``, ``--stage-ckpt-dir`` and
  ``--resume`` as in the JAX CLI;
- ``vanilla`` runs the training-free staged evaluation from the tables.

Either package reads the other's ``pretrain_*.pkl``; ``--pre-model-path``
also takes a reference ``.pt`` (:func:`~ragraph_tpu_torch.train.torch_import.
tables_from_torch`). Each mode logs to the console and to
``<save-dir>/train_log_<stamp>.txt``.

``--mesh dp=D,idx=I`` runs one process per rank, launched by
``python -m torch.distributed.run --nproc-per-node D*I -m
ragraph_tpu_torch.cli.edge ...`` (a single process is a world of one):
batches split over ``dp``; ``idx>1`` row-shards the embedding tables and
runs the receiver-range propagation (``parallel/edge_sharded.py``), and
only the base models take it, as in the JAX CLI. Rank 0 writes the files,
which are those of a single-device run. ``--dist-backend`` (a flag of the
port alone) picks the process group's backend: NCCL by default on the
card, gloo on the CPU; gloo lets one card hold several ranks.

Dataset layout: ``<data>/pretrain.txt``, ``pretrain_val.txt``,
``fine_tune.txt``, ``test_1.txt..test_N.txt`` (N=8 for amazon, else 4);
``--data-path SYNTH`` runs on generated data.
"""

from __future__ import annotations

import argparse
import functools
import json
import os

import numpy as np
import torch

from ragraph_tpu_torch.convert import params_from_jax
from ragraph_tpu_torch.data.edgelist import (load_edge_dataset, merge_rows,
                                             parse_edge_file)
from ragraph_tpu_torch.data.synthetic import synthetic_edge_stream
from ragraph_tpu_torch.device import resolve_device
from ragraph_tpu_torch import parallel
from ragraph_tpu_torch.models.edge import (EdgeGraphArrays, EvolveGCNH,
                                           EvolveGCNO, GraphPro,
                                           GraphPromptEdge, LightGCNEdge,
                                           LightGCNPlugin, MixGCFPlugin,
                                           RAGraphEdge, Roland, SGLPlugin,
                                           SimGCLPlugin, edge_config_for,
                                           make_dynamic, make_prompted,
                                           staged_dynamic, staged_finetune)
from ragraph_tpu_torch.train.checkpoint import (BestCheckpointKeeper,
                                                restore_checkpoint)
from ragraph_tpu_torch.train.logging import RunLogger
from ragraph_tpu_torch.train.metrics import RankingEvaluator
from ragraph_tpu_torch.train.torch_import import tables_from_torch
from ragraph_tpu_torch.train.trainer import EdgeTrainer
from ragraph_tpu_torch.utils.seed import seed_everything

MODELS = {"RAGraph": RAGraphEdge, "GraphPro": GraphPro,
          "LightGCN": LightGCNEdge, "SGL": SGLPlugin,
          "SimGCL": SimGCLPlugin, "MixGCF": MixGCFPlugin,
          "GP": GraphPromptEdge, "roland": Roland,
          "evolvegcn_h": EvolveGCNH, "evolvegcn_o": EvolveGCNO}
DYNAMIC_MODELS = ("roland", "evolvegcn_h", "evolvegcn_o")


def build_parser():
    p = argparse.ArgumentParser("ragraph_tpu_torch.edge")
    p.add_argument("mode", choices=["pretrain", "finetune", "vanilla"])
    p.add_argument("--data-path", default="SYNTH")
    p.add_argument("--model", default="RAGraph",
                   choices=list(MODELS),
                   help="the model; the name also picks the tables to "
                        "load (pretrain_<model>_<dataset>)")
    p.add_argument("--dynamic", default=None, choices=list(DYNAMIC_MODELS),
                   help="cross a plugin --model (SGL, SimGCL, MixGCF) with "
                        "a dynamic-GNN evolution")
    p.add_argument("--prompt", default=None, choices=["graphprompt", "gpf"],
                   help="cross a plugin --model (or LightGCN) with a prompt "
                        "vector; with --model GP, GP's prompt mode")
    p.add_argument("--noise", action="store_true")
    p.add_argument("--retrieve-dtype", choices=["input", "int8"],
                   default="input")
    p.add_argument("--selection-dtype", choices=["f32", "bf16"],
                   default="f32")
    p.add_argument("--lora", default="off", choices=["off", "zero", "svd"])
    p.add_argument("--lbd", type=float, default=None)
    p.add_argument("--eps", type=float, default=None)
    p.add_argument("--n-negs", type=int, default=None)
    p.add_argument("--emb-size", type=int, default=64)
    p.add_argument("--num-layers", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=2048)
    p.add_argument("--edge-dropout", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--hour-interval", type=float, default=1.0)
    p.add_argument("--updt-inter", type=int, default=1)
    p.add_argument("--seed", type=int, default=2023)
    p.add_argument("--save-dir", default="saved")
    p.add_argument("--pre-model-path", default=None)
    p.add_argument("--stage-ckpt-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--mesh", default=None, metavar="dp=D,idx=I",
                   help="multi-device layout, one process per rank (python "
                        "-m torch.distributed.run): batches split over dp; "
                        "idx>1 row-shards the embedding tables and runs the "
                        "receiver-range propagation (parallel/"
                        "edge_sharded.py). idx>1 requires a base model "
                        "(RAGraph/GraphPro/LightGCN). dp*idx must equal the "
                        "world size.")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="with --mesh: the process group's backend (default "
                        "nccl on the card, gloo on the CPU); gloo lets "
                        "several ranks share one card")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch "
                        "versions of the kernels")
    return p


def _make_mesh(args):
    """``--mesh`` as ``(mesh, device)``: ``(None, --device)`` without it.
    Refuses ``idx>1`` for the plugin, dynamic and prompt models in the JAX
    CLI's words, before joining the process group."""
    if not args.mesh:
        return None, resolve_device(args.device)
    if parallel.parse_mesh(args.mesh).get("idx", 1) > 1 and (
            args.model not in ("RAGraph", "GraphPro", "LightGCN")
            or args.dynamic or args.prompt):
        raise SystemExit(
            "--mesh with idx>1 (sharded tables + shard_map propagation) "
            "supports the base models RAGraph/GraphPro/LightGCN; use a "
            "dp-only mesh for the plugin/dynamic/prompt baselines")
    return parallel.mesh_from_args(args.mesh, args.device, args.dist_backend)


def _arrays(ds, dev, mesh):
    arrays = EdgeGraphArrays.from_dataset(ds, dev)
    n_idx = parallel.axis_size(mesh, "idx")
    return arrays.with_sharding(n_idx) if n_idx > 1 else arrays


def _logger(args, exp_name):
    """The run's logger; its file only on the rank that writes."""
    return RunLogger(save_dir=args.save_dir if parallel.is_writer()
                     else None, exp_name=exp_name)


def _write_json(path, obj):
    if parallel.is_writer():
        with open(path, "w") as f:
            json.dump(obj, f, indent=2)


def _load_rows(args):
    """Returns ``(train, val, finetune, stages)`` row lists."""
    if args.data_path == "SYNTH":
        train, stages = synthetic_edge_stream(seed=0, num_users=64,
                                              num_items=128, num_stages=5)
        return train, stages[0], stages[0], stages[1:]
    base = args.data_path
    n = 8 if os.path.basename(base) == "amazon" else 4
    train = parse_edge_file(os.path.join(base, "pretrain.txt"))
    val_path = os.path.join(base, "pretrain_val.txt")
    finetune = parse_edge_file(os.path.join(base, "fine_tune.txt"))
    val = parse_edge_file(val_path) if os.path.exists(val_path) else finetune
    stages = [parse_edge_file(os.path.join(base, f"test_{i}.txt"))
              for i in range(1, n + 1)]
    return train, val, finetune, stages


def _cfg(args, phase, dataset_name, num_nodes=None):
    extra = {k: v for k, v in (("lbd", args.lbd), ("eps", args.eps),
                               ("n_negs", args.n_negs)) if v is not None}
    return edge_config_for(
        dataset_name, phase, num_nodes=num_nodes,
        emb_size=args.emb_size, num_layers=args.num_layers,
        edge_dropout=args.edge_dropout, lr=args.lr,
        num_epochs=args.epochs, early_stop_patience=args.patience,
        use_noise=args.noise,
        use_lora=args.lora != "off",
        lora_init_scale=1.0 if args.lora == "svd" else 0.0,
        lora_train_factors=args.lora != "svd",
        retrieve_dtype=args.retrieve_dtype,
        selection_dtype=args.selection_dtype,
        batch_size=args.batch_size, **extra)


def _model_cls(args):
    """``--model`` with its optional ``--dynamic`` / ``--prompt`` cross as a
    class, or the refusal of the JAX CLI."""
    return model_class(args.model, args.dynamic, args.prompt)


def model_class(name: str, dynamic: str | None = None,
                prompt: str | None = None):
    """The class that ``--model name`` with ``--dynamic`` / ``--prompt``
    trains, or the refusal of the JAX CLI."""
    cls = MODELS[name]
    if dynamic is not None:
        if name not in ("SGL", "SimGCL", "MixGCF"):
            raise SystemExit(f"--dynamic requires a plugin model "
                             f"(SGL/SimGCL/MixGCF), got {name}")
        cls = make_dynamic(cls, dynamic)
    if prompt is not None:
        if name == "GP":
            # plain GP takes the prompt mode itself
            return functools.partial(GraphPromptEdge, prompt_mode=prompt)
        if name not in ("SGL", "SimGCL", "MixGCF", "LightGCN"):
            raise SystemExit(f"--prompt requires a plugin model, got {name}")
        if name == "LightGCN":
            # LightGCNEdge never runs the per-layer loop, so graphprompt's
            # hook would be dead (a zero prompt gradient): the prompt
            # crosses wrap the plugin LightGCN
            cls = LightGCNPlugin
        cls = make_prompted(cls, prompt)
    return cls


def _is_dynamic(args):
    return args.model in DYNAMIC_MODELS or args.dynamic is not None


def _dynamic_mode(args):
    return args.model if args.model in DYNAMIC_MODELS else args.dynamic


def run_pretrain(args):
    """Train the model on the pretrain split, evaluate against the
    validation split, keep the best tables. Returns the checkpoint path."""
    mesh, dev = _make_mesh(args)
    log = _logger(args, "edge-pretrain")
    _, rng = seed_everything(args.seed)
    # the dynamic models are finetune-stage wrappers: their pretrain tables
    # come from GraphPro; --dynamic and --prompt play no part here
    model_cls = MODELS["GraphPro" if args.model in DYNAMIC_MODELS
                       else args.model]
    train_rows, val_rows, _, _ = _load_rows(args)
    ds = load_edge_dataset(train_rows, [(u, i) for (u, i, *_) in val_rows],
                           hour_interval=args.hour_interval)
    name = os.path.basename(args.data_path)
    model = model_cls(_cfg(args, "pretrain", name), _arrays(ds, dev, mesh),
                      phase="pretrain", mesh=mesh)
    params = model.init_params(torch.Generator(dev).manual_seed(args.seed))
    trainer = EdgeTrainer(model, ds, logger=log, mesh=mesh)
    result = trainer.train(
        params, torch.Generator(dev).manual_seed(args.seed + 1), rng=rng)
    keeper = BestCheckpointKeeper(args.save_dir,
                                  name=f"pretrain_{args.model}_{name}")
    if parallel.is_writer():
        keeper.update(float(result.best_perform["recall"][0]),
                      {"user_embedding": result.best_params["user_embedding"],
                       "item_embedding": result.best_params[
                           "item_embedding"]})
    parallel.barrier()      # the other ranks may read the checkpoint next
    path = os.path.join(args.save_dir, f"pretrain_{args.model}_{name}.pkl")
    log(f"best recall {result.best_perform['recall'][0]:.5f}; "
        f"checkpoint {path}")
    _write_json(os.path.join(args.save_dir,
                             f"pretrain_{args.model}_{name}.json"),
                {"best_recall": float(result.best_perform["recall"][0]),
                 "best_ndcg": float(result.best_perform["ndcg"][0])})
    return path


def run_finetune(args):
    """Staged finetuning from the pretrained tables; returns the
    :class:`StageResult`."""
    if args.resume and not args.stage_ckpt_dir:
        raise SystemExit("--resume needs --stage-ckpt-dir (nowhere to "
                         "load the staged state from)")
    mesh, dev = _make_mesh(args)
    log = _logger(args, "edge-finetune")
    seed_everything(args.seed)
    model_cls = _model_cls(args)
    train_rows, val_rows, ft_rows, stage_rows = _load_rows(args)
    name = os.path.basename(args.data_path)

    if args.pre_model_path:
        if args.pre_model_path.endswith(".pt"):
            tables = tables_from_torch(args.pre_model_path)
        else:
            tables = restore_checkpoint(args.pre_model_path)
    else:
        default = os.path.join(args.save_dir,
                               f"pretrain_{args.model}_{name}")
        if not os.path.exists(default + ".pkl"):
            log("no pretrain checkpoint; running pretrain first")
            run_pretrain(args)
        tables = restore_checkpoint(default)
        log(f"loaded pretrain tables from {default}")

    if _is_dynamic(args):
        result = staged_dynamic(
            train_rows, ft_rows, stage_rows, tables,
            cfg_factory=lambda phase: _cfg(args, phase, name),
            seed=args.seed, model_cls=model_cls, device=dev,
            mode=_dynamic_mode(args), hour_interval=args.hour_interval,
            num_epochs=args.epochs, logger=log, mesh=mesh,
            val_rows=val_rows, checkpoint_dir=args.stage_ckpt_dir,
            resume=args.resume)
    else:
        result = staged_finetune(
            train_rows, ft_rows, stage_rows, tables,
            cfg_factory=lambda phase: _cfg(args, phase, name),
            seed=args.seed, device=dev, hour_interval=args.hour_interval,
            updt_inter=args.updt_inter, num_epochs=args.epochs,
            logger=log, model_cls=model_cls, mesh=mesh, val_rows=val_rows,
            checkpoint_dir=args.stage_ckpt_dir, resume=args.resume)
    log(f"recalls: {result.recalls}")
    log(f"ndcgs:   {result.ndcgs}")
    log(f"avg recall {result.avg_recall:.5f} "
        f"avg ndcg {result.avg_ndcg:.5f}")
    tag = args.model + "".join(f"-{x}" for x in (args.dynamic, args.prompt)
                               if x)
    _write_json(os.path.join(args.save_dir, f"finetune_{tag}_{name}.json"),
                {"recalls": result.recalls, "ndcgs": result.ndcgs,
                 "avg_recall": result.avg_recall,
                 "avg_ndcg": result.avg_ndcg})
    return result


def run_vanilla(args):
    """Training-free staged eval: per stage, build the graph of all rows so
    far, generate, build the library, generate with RAG, evaluate."""
    mesh, dev = _make_mesh(args)
    log = _logger(args, "edge-vanilla")
    seed_everything(args.seed)
    train_rows, _, ft_rows, stage_rows = _load_rows(args)
    name = os.path.basename(args.data_path)
    tables = restore_checkpoint(
        os.path.join(args.save_dir, f"pretrain_{args.model}_{name}"))
    params = params_from_jax({"user_embedding": tables["user_embedding"],
                              "item_embedding": tables["item_embedding"]},
                             dev)
    if parallel.axis_size(mesh, "idx") > 1:
        params = {k: parallel.shard_rows(mesh, v) for k, v in params.items()}

    all_rows = [train_rows, ft_rows, *stage_rows]
    recalls, ndcgs = [], []
    ev = RankingEvaluator(ks=(20,))
    for stage in range(1, len(stage_rows) + 1):
        prompt_rows = merge_rows(all_rows[: stage + 1])
        ds = load_edge_dataset(prompt_rows, stage_rows[stage - 1],
                               hour_interval=args.hour_interval)
        cfg = _cfg(args, "vanilla", name, num_nodes=ds.num_nodes)
        model = RAGraphEdge(cfg, _arrays(ds, dev, mesh), phase="vanilla",
                            mesh=mesh)
        u0, i0 = model.generate(params)
        model.make_resource_graph(u0, i0,
                                  torch.Generator(dev).manual_seed(stage))
        del u0, i0
        user_emb, item_emb = model.generate(params)
        result = ev.evaluate(user_emb, item_emb, ds.test_user_dict,
                             ds.user_hist_dict)
        del user_emb, item_emb
        recalls.append(float(result["recall"][0]))
        ndcgs.append(float(result["ndcg"][0]))
        log(f"stage {stage}: recall={recalls[-1]:.5f} "
            f"ndcg={ndcgs[-1]:.5f}")
    log(f"avg recall {np.mean(recalls):.5f} "
        f"avg ndcg {np.mean(ndcgs):.5f}")
    return recalls, ndcgs


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mode == "pretrain":
        return run_pretrain(args)
    if args.mode == "vanilla":
        return run_vanilla(args)
    return run_finetune(args)


if __name__ == "__main__":
    main()
