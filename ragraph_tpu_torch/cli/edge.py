"""Edge (recommendation) CLI of the port (counterpart of
``ragraph_tpu/cli/edge.py``).

``python -m ragraph_tpu_torch.cli.edge vanilla --data-path SYNTH`` runs the
training-free staged evaluation (reference ``vanilla_ragraph.py:49-105``)
from the pretrained tables in ``<save-dir>/pretrain_<model>_<dataset>.pkl``,
which either package writes. It takes the JAX CLI's flags plus
``--device`` (default ``cuda``). ``pretrain`` and ``finetune`` are not
ported yet and exit with an error.

Dataset layout: ``<data>/pretrain.txt``, ``pretrain_val.txt``,
``fine_tune.txt``, ``test_1.txt..test_N.txt`` (N=8 for amazon, else 4);
``--data-path SYNTH`` runs on generated data.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np
import torch

from ragraph_tpu_torch.convert import params_from_jax
from ragraph_tpu_torch.data.edgelist import (load_edge_dataset, merge_rows,
                                             parse_edge_file)
from ragraph_tpu_torch.data.synthetic import synthetic_edge_stream
from ragraph_tpu_torch.device import resolve_device
from ragraph_tpu_torch.models.edge import (EdgeGraphArrays, RAGraphEdge,
                                           edge_config_for)
from ragraph_tpu_torch.train.checkpoint import restore_checkpoint
from ragraph_tpu_torch.train.metrics import RankingEvaluator


def build_parser():
    p = argparse.ArgumentParser("ragraph_tpu_torch.edge")
    p.add_argument("mode", choices=["pretrain", "finetune", "vanilla"])
    p.add_argument("--data-path", default="SYNTH")
    p.add_argument("--model", default="RAGraph",
                   choices=["RAGraph", "GraphPro", "LightGCN", "SGL",
                            "SimGCL", "MixGCF", "GP",
                            "roland", "evolvegcn_h", "evolvegcn_o"],
                   help="names the pretrained tables to load "
                        "(pretrain_<model>_<dataset>)")
    p.add_argument("--dynamic", default=None,
                   choices=["roland", "evolvegcn_h", "evolvegcn_o"])
    p.add_argument("--prompt", default=None, choices=["graphprompt", "gpf"])
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
    p.add_argument("--mesh", default=None, metavar="dp=D,idx=I")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch "
                        "versions of the kernels")
    return p


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


def _logger() -> logging.Logger:
    log = logging.getLogger("ragraph_tpu_torch.edge")
    if not log.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        log.addHandler(handler)
        log.setLevel(logging.INFO)
        log.propagate = False
    return log


def run_vanilla(args):
    """Training-free staged eval: per stage, build the graph of all rows so
    far, generate, build the library, generate with RAG, evaluate."""
    dev = resolve_device(args.device)
    log = _logger()
    train_rows, _, ft_rows, stage_rows = _load_rows(args)
    name = os.path.basename(args.data_path)
    tables = restore_checkpoint(
        os.path.join(args.save_dir, f"pretrain_{args.model}_{name}"))
    params = params_from_jax({"user_embedding": tables["user_embedding"],
                              "item_embedding": tables["item_embedding"]},
                             dev)

    all_rows = [train_rows, ft_rows, *stage_rows]
    recalls, ndcgs = [], []
    ev = RankingEvaluator(ks=(20,))
    for stage in range(1, len(stage_rows) + 1):
        prompt_rows = merge_rows(all_rows[: stage + 1])
        ds = load_edge_dataset(prompt_rows, stage_rows[stage - 1],
                               hour_interval=args.hour_interval)
        cfg = _cfg(args, "vanilla", name, num_nodes=ds.num_nodes)
        arrays = EdgeGraphArrays.from_dataset(ds, dev)
        model = RAGraphEdge(cfg, arrays, phase="vanilla")
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
        log.info(f"stage {stage}: recall={recalls[-1]:.5f} "
                 f"ndcg={ndcgs[-1]:.5f}")
    log.info(f"avg recall {np.mean(recalls):.5f} "
             f"avg ndcg {np.mean(ndcgs):.5f}")
    return recalls, ndcgs


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mode != "vanilla":
        raise SystemExit(f"ragraph_tpu_torch.cli.edge: mode {args.mode!r} "
                         "is not yet ported (ROADMAP.md); only 'vanilla' "
                         "runs")
    if args.mesh:
        raise SystemExit("ragraph_tpu_torch.cli.edge: --mesh is not yet "
                         "ported (ROADMAP.md, multi-device)")
    return run_vanilla(args)


if __name__ == "__main__":
    main()
