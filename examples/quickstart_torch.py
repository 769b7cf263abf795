"""ragraph_tpu_torch quickstart: the three pipelines of
``examples/quickstart.py`` through the PyTorch port.

Runs on the CUDA card by default; ``--device cpu`` runs the plain PyTorch
versions of the kernels instead (nothing falls back to the CPU on its
own: without a card the default raises):

  python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from ragraph_tpu_torch.data import (flat_batches, load_edge_dataset,
                                    stacked_batches, synthetic_edge_stream,
                                    synthetic_tu_dataset)
from ragraph_tpu_torch.device import resolve_device
from ragraph_tpu_torch.models import RAGraphNode, RAGraphNodeConfig
from ragraph_tpu_torch.models.edge import (EdgeGraphArrays, EdgeModelConfig,
                                           RAGraphEdge)
from ragraph_tpu_torch.rag import LibraryConfig
from ragraph_tpu_torch.train import EdgeTrainer


def node_classification(device):
    """Frozen encoder -> toy-graph library -> retrieval-augmented logits."""
    ds = synthetic_tu_dataset(seed=0, num_graphs=40, num_classes=3,
                              feat_dim=16)
    train, test = ds.subset(0, .7), ds.subset(.7, 1)
    pad = 8 * max(g.features.shape[0] for g in ds.graphs)

    cfg = RAGraphNodeConfig(
        emb_size=32, num_class=3,
        library=LibraryConfig(level="node", num_inverse_sample=0,
                              num_augment_scale=0, retrieve_num=4,
                              toy_graph_hop=2, use_positions=False))
    task = RAGraphNode(cfg, feature_dim=16, device=device)
    state = task.init_state(torch.Generator().manual_seed(0),
                            library_capacity=4096)

    # build the retrieval library from the train split (batched graphs)
    state = task.build_library(
        state, stacked_batches(train.graphs, 8, device=device),
        torch.Generator(device).manual_seed(1))
    print(f"library fill: {int(state.library.fill)} entries")

    # a couple of fine-tuning steps (encoder + decoder train jointly)
    optimizer = task.make_optimizer(state, 1e-2)
    for g in flat_batches(train.graphs, 8, pad, device=device):
        task.train_step(state, optimizer, g)
    acc = task.accuracy(state, flat_batches(test.graphs, 8, pad,
                                            device=device))
    print(f"node accuracy: {acc:.3f} (chance 0.333)")


def recommendation(device):
    """Temporal LightGCN + RAG resource graph + BPR training + serving."""
    train_rows, stages = synthetic_edge_stream(seed=0, num_users=48,
                                               num_items=96, num_stages=1)
    ds = load_edge_dataset(train_rows,
                           [(u, i) for (u, i, _) in stages[0]])
    cfg = EdgeModelConfig(emb_size=16, num_layers=2, batch_size=128,
                          early_stop_patience=3)
    graph = EdgeGraphArrays.from_dataset(ds, device)

    model = RAGraphEdge(cfg, graph, phase="pretrain")
    params = model.init_params(torch.Generator(device).manual_seed(0))
    trainer = EdgeTrainer(model, ds, logger=lambda *_: None)
    result = trainer.train(params, torch.Generator(device).manual_seed(1),
                           num_epochs=5, rng=np.random.default_rng(0))
    print(f"recall@20 after pretrain: "
          f"{float(result.best_perform['recall'][0]):.4f}")

    # serving: top-5 recommendations for the first 4 users
    scores, items = model.recommend(
        result.best_params, torch.arange(4, dtype=torch.int32,
                                         device=device), k=5)
    print("top-5 items for users 0-3:")
    print(items.cpu().numpy())


def fast_retrieval(device):
    """The retrieval entry point directly."""
    from ragraph_tpu_torch.ops.topk import cosine_topk

    rng = np.random.default_rng(0)
    keys = torch.from_numpy(rng.normal(size=(4096, 64)).astype(np.float32)
                            ).to(device)
    queries = torch.from_numpy(rng.normal(size=(32, 64)).astype(np.float32)
                               ).to(device)
    scores, idx = cosine_topk(queries, keys, 10)  # auto: exact f32 here;
    # above 32,768 rows the fused kernel C on the card (bf16 scores)
    print(f"retrieved top-10 of {keys.shape[0]} keys; "
          f"best score {float(scores[0, 0]):.3f}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "PyTorch versions")
    device = resolve_device(p.parse_args(argv).device)
    node_classification(device)
    recommendation(device)
    fast_retrieval(device)


if __name__ == "__main__":
    main()
