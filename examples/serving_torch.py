"""ragraph_tpu_torch serving skeleton: the recipe of
``examples/serving.py`` through the PyTorch port.

Two paths, as in a deployment:

- **model refresh** (per params or graph update): ``generate()``
  propagates the full graph once; the embeddings stay on the card between
  requests;
- **request path** (per query batch): ``recommend_from`` on the
  precomputed embeddings: one matmul, a top-(k + pad), the history filter.

On an "NVIDIA H100 80GB HBM3" at a 700.00 W power limit, at U = I =
131,072 and 2^21 edges, ``chip_smoke.py`` phase 3 measured a warm
``generate`` at 1.23 ms and ``recommend_from`` at 1.62 ms (B = 256) and
8.72 ms (B = 4,096) by CUDA events (PERF.md section 5).

Runs on the CUDA card by default; ``--device cpu`` runs the plain PyTorch
versions of the kernels (without a card the default raises):

    python examples/serving_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from ragraph_tpu_torch.data import load_edge_dataset, synthetic_edge_stream
from ragraph_tpu_torch.device import resolve_device
from ragraph_tpu_torch.models.edge import (EdgeGraphArrays, EdgeModelConfig,
                                           GraphPro)
from ragraph_tpu_torch.train import EdgeTrainer

K = 10
HIST_PAD = 16  # history path: top-(K+pad) off the matmul, then the filter


def train_quickly(device):
    """Stand-in for a real checkpoint: a few epochs on synthetic data."""
    train, stages = synthetic_edge_stream(seed=0, num_users=64,
                                          num_items=128, num_stages=2)
    ds = load_edge_dataset(train, [(u, i) for (u, i, _) in stages[0]])
    cfg = EdgeModelConfig(emb_size=16, num_layers=2, batch_size=128,
                          eval_batch_size=64, lr=5e-3)
    model = GraphPro(cfg, EdgeGraphArrays.from_dataset(ds, device),
                     phase="pretrain")
    params = model.init_params(torch.Generator(device).manual_seed(0))
    result = EdgeTrainer(model, ds, logger=lambda *_: None).train(
        params, torch.Generator(device).manual_seed(1), num_epochs=6,
        rng=np.random.default_rng(0))
    return model, result.best_params, ds


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "PyTorch versions")
    device = resolve_device(p.parse_args(argv).device)
    model, params, ds = train_quickly(device)

    # ---- model refresh: once per params/graph update ----------------
    # the embeddings stay on the device; requests move ids in and k
    # results out
    with torch.no_grad():
        user_emb, item_emb = model.generate(params)

    # ---- request path: one call per request -------------------------
    # history rows/cols = (batch-row, item) pairs to exclude; out-of-range
    # rows are ignored, so a buffer of fixed size can be padded with them
    def serve(user_ids, hist_rows, hist_cols):
        def put(a):
            return torch.from_numpy(a).to(device)
        return model.recommend_from(user_emb, item_emb, put(user_ids), k=K,
                                    hist_rows=put(hist_rows),
                                    hist_cols=put(hist_cols),
                                    hist_pad=HIST_PAD)

    def history_for(batch_users):
        rows, cols = [], []
        for r, u in enumerate(batch_users):
            for item in ds.user_hist_dict.get(int(u), ()):
                rows.append(r)
                cols.append(item)
        pad = max(1, len(rows))
        out_r = np.full(pad, 1 << 30, np.int32)  # out-of-range = inert
        out_c = np.zeros(pad, np.int32)
        out_r[:len(rows)], out_c[:len(cols)] = rows, cols
        return out_r, out_c

    # batch request
    batch = np.arange(8, dtype=np.int32)
    scores, items = serve(batch, *history_for(batch))
    print(f"batch of {len(batch)} users -> top-{K} items each:")
    print(items.cpu().numpy()[:3])

    # single-user request (B = 1)
    one = np.array([5], dtype=np.int32)
    scores, items = serve(one, *history_for(one))
    served = items.cpu().numpy()[0].tolist()
    print(f"user 5 -> {served}")

    # served items must exclude the user's history
    hist = set(ds.user_hist_dict.get(5, ()))
    assert not hist.intersection(served), \
        "history leaked into recommendations"
    print("history masking verified.")


if __name__ == "__main__":
    main()
