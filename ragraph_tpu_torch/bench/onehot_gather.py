"""Block-local row gather over a padded sender-sorted stream against a
plain row gather (counterpart of ``experiments/onehot_gather_bench.py``).

    python -m ragraph_tpu_torch.bench.onehot_gather [--device cpu --small]

At N = 2^18 table rows, D = 64 (bf16), 2^21 sender-sorted edges: table rows
are grouped into 128-row blocks, each block's edges are re-padded to a run
of P slots (``build_onehot_layout``), and kernel L copies each slot's row
out of the block held in shared memory. Beside it ``torch.index_select`` of
the same rows. The gathered stream is checked on the device, exactly,
before anything is timed.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ragraph_tpu_torch import native
from ragraph_tpu_torch.bench import timing
from ragraph_tpu_torch.device import resolve_device
from ragraph_tpu_torch.ops import probes

N, D, E = 1 << 18, 64, 2 << 20
SMALL = (2048, 16, 8192)     # 16 table blocks
ITERS = 30


def make_inputs(device, small: bool = False, seed: int = 0) -> dict:
    n, d, e = SMALL if small else (N, D, E)
    rng = np.random.default_rng(seed)
    senders = np.sort(rng.integers(0, n, e).astype(np.int32))
    col, p, counts, slot = probes.build_onehot_layout(senders, n)
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    return {"senders": torch.from_numpy(senders).to(device),
            "col": torch.from_numpy(col).to(device),
            "slot": torch.from_numpy(slot).to(device),
            "table": table.to(device).to(torch.bfloat16), "p": p,
            "mean_load": float(counts.mean()), "max_load": int(counts.max())}


def run(device, small: bool = False, seed: int = 0, iters: int = ITERS,
        inputs: dict | None = None) -> dict:
    inp = inputs or make_inputs(device, small, seed)
    senders, col, slot, table = (inp[k] for k in ("senders", "col", "slot",
                                                  "table"))
    idx = senders.long()
    nb, p = col.shape
    e = int(senders.shape[0])
    print(f"N={table.shape[0]} E={e} blocks={nb} P={p} (mean load "
          f"{inp['mean_load']:.0f}, max {inp['max_load']}) padded stream "
          f"{nb * p} slots ({nb * p / max(e, 1):.2f}x)")

    native.reset_launches()
    got = probes.onehot_block_gather(col, table)
    n_bad = int((got[slot] != table[idx]).sum())
    if n_bad:
        raise AssertionError(f"{n_bad} mismatched elements")
    real = torch.zeros(nb * p, dtype=torch.bool, device=got.device)
    real[slot] = True
    if bool((got[~real] != 0).any()):
        raise AssertionError("a padding slot is not a zero row")
    del got
    print("correctness OK (exact)")

    ms = {"index_select": timing.timed_ms(
              lambda: torch.index_select(table, 0, idx), reps=iters,
              device=device),
          "onehot_block_gather": timing.timed_ms(
              lambda: probes.onehot_block_gather(col, table), reps=iters,
              device=device)}
    for name, t in ms.items():
        print(f"{name:20s} {t:8.3f} ms ({e / t / 1e3:.0f} M rows/s)")
    return {"bench": "onehot_gather", "N": int(table.shape[0]),
            "D": int(table.shape[1]), "E": e, "blocks": nb, "P": p,
            "padded_slots": nb * p, "padded_over_edges": nb * p / max(e, 1),
            "iters": iters, "device": timing.device_record(device),
            "mismatched": n_bad, timing.times_key(device): ms,
            "launches": dict(native.LAUNCHES)}


def main(argv=None) -> dict:
    args = timing.bench_parser(__doc__.splitlines()[0]).parse_args(argv)
    device = resolve_device(args.device or "cuda")
    rec = run(device, args.small, args.seed, iters=3 if args.small else ITERS)
    return timing.emit(rec, args.out)


if __name__ == "__main__":
    main()
    sys.exit(0)
