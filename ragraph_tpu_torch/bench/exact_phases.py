"""Phase-level breakdown of the exact bucketed top-k on the card
(counterpart of ``benchmarks/bench_exact_phases.py``).

    python -m ragraph_tpu_torch.bench.exact_phases [--device cpu --small]

At R = 262,144 keys, E = 128, Q = 2,048 queries, k = 10, milliseconds per
batch of these arms:

  library       bf16 ``torch.matmul`` + ``torch.topk``. It stands where the
                JAX script has ``approx_max_k``, which a GPU cannot run.
  full          ``bucketed_exact_topk`` (kernels D, E, F, G and the glue)
  phase1        kernel D alone: the bucket maxima
  matmul_proxy  kernel J: the full product on kernel C's tensor-core tile,
                one row in 128 written, no 128-group maximum
  glue          kernel E over a fixed bucket-max matrix plus the pair
                inversion (``invert_pairs``)

Two chains, as in the JAX script: an independent one (each batch's queries
are the first batch's plus the loop index times 1e-3) and a dependent one
(each batch's result perturbs the next batch's queries). The JAX script
needs the index perturbation to stop XLA from collapsing a loop-invariant
body; eager PyTorch launches every call, so here it only keeps the two
scripts' work alike. On one stream eager launches run in order either way,
so the two chains are expected to read alike; the script prints what it
found.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ragraph_tpu_torch import native
from ragraph_tpu_torch.bench import timing
from ragraph_tpu_torch.device import resolve_device
from ragraph_tpu_torch.ops import bucket_topk as bt
from ragraph_tpu_torch.ops import probes
from ragraph_tpu_torch.ops.similarity import l2_normalize

R, E, Q, K = 262_144, 128, 2048, 10
SMALL = (4096, 32, 64, 4)
ITERS = 30
P_MAX = 32


def make_inputs(device, small: bool = False, seed: int = 4) -> dict:
    r, e, q, k = SMALL if small else (R, E, Q, K)
    rng = np.random.default_rng(seed)
    keys = l2_normalize(torch.from_numpy(
        rng.normal(size=(r, e)).astype(np.float32)).to(device))
    queries = torch.from_numpy(
        rng.normal(size=(q, e)).astype(np.float32)).to(device)
    nb = -(-r // bt.LANE)
    bm_fixed = torch.from_numpy(
        rng.normal(size=(nb, q)).astype(np.float32)).to(device)
    return {"keys": keys.to(torch.bfloat16).contiguous(), "queries": queries,
            "q_bf": l2_normalize(queries).to(torch.bfloat16).contiguous(),
            "bm_fixed": bm_fixed, "k": k}


def _chain_independent(fn, first, iters, device) -> float:
    """Milliseconds per batch of ``iters`` independent batches, best of 3."""
    steps = [first + torch.tensor(i * 1e-3, dtype=first.dtype,
                                  device=first.device) for i in range(iters)]

    def run():
        for x in steps:
            fn(x)
    return min(timing.timed_ms(run, reps=1, warmup=1, device=device)
               for _ in range(3)) / iters


def _chain_dependent(fn, q0, iters, device) -> float:
    """Milliseconds per batch when each batch's scores ``(Q, k)`` perturb
    the next batch's queries, best of 3."""
    def run():
        qq = q0
        for _ in range(iters):
            s = fn(qq)
            qq = qq + (1e-6 * s[:, :1]).to(qq.dtype)
    return min(timing.timed_ms(run, reps=1, warmup=1, device=device)
               for _ in range(3)) / iters


def run(device, small: bool = False, seed: int = 4, iters: int = ITERS,
        inputs: dict | None = None) -> dict:
    inp = inputs or make_inputs(device, small, seed)
    keys, q_bf, k = inp["keys"], inp["q_bf"], inp["k"]
    q_unit = l2_normalize(inp["queries"])
    nb = -(-keys.shape[0] // bt.LANE)

    def library(q):
        return torch.topk(torch.matmul(q.to(torch.bfloat16), keys.T), k,
                          dim=1)[0]

    def full(q):
        return bt.bucketed_exact_topk(q, keys, k, p_max=P_MAX)[0]

    def glue(bm):
        bvals, ids = bt.column_topk(bm, k)
        ids = torch.where(bvals <= bt.NEG_INF, nb, ids)
        return bt.invert_pairs(ids, nb, P_MAX)[0]

    native.reset_launches()
    lat = {"library": _chain_dependent(library, q_unit, iters, device),
           "full_exact": _chain_dependent(full, q_unit, iters, device)}
    thr = {
        "library": _chain_independent(library, q_bf, iters, device),
        "full_exact": _chain_independent(full, q_bf, iters, device),
        "phase1": _chain_independent(lambda q: bt.bucket_max(keys, q), q_bf,
                                     iters, device),
        "matmul_proxy": _chain_independent(
            lambda q: probes.matmul_probe(keys, q, 0), q_bf, iters, device),
        "glue": _chain_independent(glue, inp["bm_fixed"], iters, device)}
    lat["ratio"] = lat["full_exact"] / lat["library"]
    thr["ratio"] = thr["full_exact"] / thr["library"]
    chains = lat["full_exact"] / thr["full_exact"]
    r, e = keys.shape
    print(f"R={r} Q={q_bf.shape[0]} E={e} k={k}, ms/batch "
          f"({'CUDA events' if timing.is_cuda(device) else 'CPU host clock'})")
    print("dependent chain (each batch waits for the last):")
    print(f"  library       {lat['library']:8.3f}")
    print(f"  full exact    {lat['full_exact']:8.3f}  "
          f"({lat['ratio']:.2f}x library)")
    print("independent chain:")
    print(f"  library       {thr['library']:8.3f}")
    print(f"  full exact    {thr['full_exact']:8.3f}  "
          f"({thr['ratio']:.2f}x library)")
    print(f"  phase1        {thr['phase1']:8.3f}")
    print(f"  matmul proxy  {thr['matmul_proxy']:8.3f}  (the group maximum "
          f"adds {max(thr['phase1'] - thr['matmul_proxy'], 0):.3f})")
    print(f"  glue          {thr['glue']:8.3f}")
    print(f"full exact, dependent over independent chain: {chains:.3f} "
          f"(eager launches on one stream: expected near 1)")
    return {"bench": "exact_phases", "R": r, "Q": q_bf.shape[0], "E": e,
            "k": k, "iters": iters, "device": timing.device_record(device),
            timing.times_key(device): {"latency": lat, "throughput": thr},
            "dependent_over_independent": chains,
            "launches": dict(native.LAUNCHES)}


def main(argv=None) -> dict:
    args = timing.bench_parser(__doc__.splitlines()[0]).parse_args(argv)
    device = resolve_device(args.device or "cuda")
    rec = run(device, args.small, args.seed + 4,
              iters=3 if args.small else ITERS)
    return timing.emit(rec, args.out)


if __name__ == "__main__":
    main()
    sys.exit(0)
