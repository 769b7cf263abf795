"""Weighted segment sum from a packed table against the plain table
(counterpart of ``experiments/packed_table_gather_bench.py``).

    python -m ragraph_tpu_torch.bench.packed_table_gather [--device cpu --small]

At N = 2^18 rows, D = 64, 2^21 receiver-sorted edges, forward pass only:

  A       kernel A (``gather_scale_segsum``'s forward) on the (N, D) table
  B       kernel K on the (N/2, 2D) bf16 table packed two rows to one, with
          ``w_lo = w·(1 - parity)``, ``w_hi = w·parity``, ``idx >> 1``
  repack  the cast and reshape that B would pay once per layer

The two must agree before anything is timed: the largest difference under
5e-4 of the largest output, the JAX script's own limit. On the card both
walk the same edges in the same order and a zero weight adds nothing, so
they are expected to agree bit for bit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ragraph_tpu_torch import native
from ragraph_tpu_torch.bench import timing
from ragraph_tpu_torch.device import resolve_device
from ragraph_tpu_torch.ops import probes
from ragraph_tpu_torch.ops.csr_segment import _csr_gather_scale

N, D, E = 1 << 18, 64, 1 << 21
SMALL = (512, 16, 2048)
ITERS = 20
REL_LIMIT = 5e-4


def make_inputs(device, small: bool = False, seed: int = 0) -> dict:
    n, d, e = SMALL if small else (N, D, E)
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n, d)).astype(np.float32)
    recv = np.sort(rng.integers(0, n, e)).astype(np.int32)
    send = rng.integers(0, n, e).astype(np.int32)
    indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(recv, minlength=n))]).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in
            (("table", table), ("send", send), ("indptr", indptr), ("w", w))}


def run(device, small: bool = False, seed: int = 0, iters: int = ITERS,
        inputs: dict | None = None) -> dict:
    inp = inputs or make_inputs(device, small, seed)
    table, send, indptr, w = (inp[k] for k in ("table", "send", "indptr",
                                               "w"))
    parity = (send & 1).float()
    w_lo, w_hi = w * (1 - parity), w * parity
    idx_half = (send >> 1).contiguous()
    packed = probes.pack_table(table)

    native.reset_launches()
    a = _csr_gather_scale(table, w, send, indptr, True)
    b = probes.packed_table_segsum(packed, w_lo, w_hi, idx_half, indptr)
    rel = float((a - b).abs().max() / (a.abs().max() + 1e-9))
    print(f"max rel diff A vs B: {rel:.2e} (limit {REL_LIMIT:.0e})")
    if not rel < REL_LIMIT:
        raise AssertionError(f"packed-table kernel disagrees: {rel:.3e}")

    ms = {"A_plain_table": timing.timed_ms(
              lambda: _csr_gather_scale(table, w, send, indptr, True),
              reps=iters, device=device),
          "B_packed_table": timing.timed_ms(
              lambda: probes.packed_table_segsum(packed, w_lo, w_hi,
                                                 idx_half, indptr),
              reps=iters, device=device),
          "B_table_repack": timing.timed_ms(
              lambda: probes.pack_table(table), reps=iters, device=device)}
    n, d = table.shape
    print(f"N={n} D={d} E={send.shape[0]}, ms "
          f"({'CUDA events' if timing.is_cuda(device) else 'CPU host clock'})")
    print(f"A plain table  ({d}-wide rows):      {ms['A_plain_table']:8.3f}")
    print(f"B packed table ({2 * d}-wide rows):     "
          f"{ms['B_packed_table']:8.3f}  -> "
          f"{ms['A_plain_table'] / ms['B_packed_table']:.2f}x")
    print(f"B table repack (once per layer):    {ms['B_table_repack']:8.3f}")
    return {"bench": "packed_table_gather", "N": n, "D": d,
            "E": int(send.shape[0]), "iters": iters,
            "device": timing.device_record(device), "max_rel_diff": rel,
            timing.times_key(device): ms, "launches": dict(native.LAUNCHES)}


def main(argv=None) -> dict:
    args = timing.bench_parser(__doc__.splitlines()[0]).parse_args(argv)
    device = resolve_device(args.device or "cuda")
    rec = run(device, args.small, args.seed, iters=3 if args.small else ITERS)
    return timing.emit(rec, args.out)


if __name__ == "__main__":
    main()
    sys.exit(0)
