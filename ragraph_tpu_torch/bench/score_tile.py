"""Kernels C and D and the score matrix, the three users of the score
tile (``csrc/rg_mma.cuh``), by device time beside their bound.

    python -m ragraph_tpu_torch.bench.score_tile [--device cpu --small]
        [--out FILE]

At the main path's refresh chunk (2,048 queries against 262,144 keys) and
the widths 64 (the edge model's), 100 (rows padded to 104) and 512 (four
chunks of 128 columns): C at k = 10 and D at each, the score matrix of C's
k > 128 path at 100. Then C at its other paths' shapes: the graph level
(16 queries against a 65,536-row store of width 256 that holds 1,500 valid
rows, k = 4) and an edge finetune step (238,735 queries against as many
keys, width 64, k = 10 and 20). The inputs are L2-normalised bf16 rows
drawn from ``--seed``. For each call: the device's time alone
(``timing.device_ms``, under ``ms``) and the bound (the larger of the
bytes moved at 3.35 TB/s and the products at the 989 TFLOP/s bf16
tensor-core rate). To compare two checkouts, run the script in each in
turns.

The last line is one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import torch

from ragraph_tpu_torch import native
from ragraph_tpu_torch.bench import timing
from ragraph_tpu_torch.device import resolve_device

HBM_BYTES_PER_MS = 3.35e9
BF16_FLOP_PER_MS = 989e9
K = 10   # EdgeModelConfig().retrieve_num


def bound_ms(n_q: int, n_r: int, e: int, out_bytes: int) -> float:
    """The least device time of a call that reads both bf16 inputs once,
    writes ``out_bytes`` once and takes every product."""
    moved = 2 * (n_q + n_r) * e + out_bytes
    return max(moved / HBM_BYTES_PER_MS, 2 * n_q * n_r * e / BF16_FLOP_PER_MS)


def run(device, small: bool, seed: int = 0) -> dict:
    """Every width through C, D and (at the second width) the score
    matrix."""
    from ragraph_tpu_torch.ops.bucket_topk import bucket_max
    from ragraph_tpu_torch.ops.fused_retrieval import fused_cosine_topk
    from ragraph_tpu_torch.ops.score_tile import score_matrix
    from ragraph_tpu_torch.ops.similarity import l2_normalize
    native.reset_launches()
    n_q, n_r, widths = ((16, 1000, (12, 264)) if small
                        else (2048, 262_144, (64, 100, 512)))
    nb = -(-n_r // 128)
    cuda = timing.is_cuda(device)
    gen = torch.Generator(device).manual_seed(seed)
    times, bounds = {}, {}
    for e in widths:
        q = l2_normalize(torch.randn(n_q, e, generator=gen, device=device))
        keys = l2_normalize(torch.randn(n_r, e, generator=gen,
                                        device=device))
        q, keys = q.bfloat16(), keys.bfloat16()
        calls = {f"C_E{e}_k{K}": (lambda: fused_cosine_topk(q, keys, K),
                                  8 * n_q * K),
                 f"D_E{e}": (lambda: bucket_max(keys, q), 4 * nb * n_q)}
        if e == widths[1]:
            calls[f"score_matrix_E{e}"] = (lambda: score_matrix(keys, q),
                                           4 * n_q * nb * 128)
        for name, (fn, out_bytes) in calls.items():
            times[name] = (timing.device_ms(fn, 10) if cuda
                           else timing.timed_ms(fn, 2, 1, device))
            bounds[name] = bound_ms(n_q, n_r, e, out_bytes)
        del q, keys
        if cuda:
            torch.cuda.empty_cache()
    # C at the graph level's shape and at an edge finetune step's
    (g_q, g_r, g_e, fill), (f_q, f_r, f_e) = (
        ((4, 512, 16, 100), (1000, 1000, 64)) if small
        else ((16, 65_536, 256, 1_500), (238_735, 238_735, 64)))
    gq = l2_normalize(torch.randn(g_q, g_e, generator=gen, device=device))
    gk = l2_normalize(torch.randn(g_r, g_e, generator=gen, device=device))
    gq, gk = gq.bfloat16(), gk.bfloat16()
    valid = torch.arange(g_r, device=device) < fill
    calls = {f"C_graph_E{g_e}_k4": (
        lambda: fused_cosine_topk(gq, gk, 4, valid), g_q, g_r, g_e, 32 * g_q)}
    fq = l2_normalize(torch.randn(f_q, f_e, generator=gen, device=device))
    fk = l2_normalize(torch.randn(f_r, f_e, generator=gen, device=device))
    fq, fk = fq.bfloat16(), fk.bfloat16()
    for k in (K, 2 * K):
        calls[f"C_finetune_E{f_e}_k{k}"] = (
            lambda k=k: fused_cosine_topk(fq, fk, k), f_q, f_r, f_e,
            8 * f_q * k)
    for name, (fn, a, b, w, out_bytes) in calls.items():
        times[name] = (timing.device_ms(fn, 10) if cuda
                       else timing.timed_ms(fn, 2, 1, device))
        bounds[name] = bound_ms(a, b, w, out_bytes)
    return {"bench": "score_tile", "device": timing.device_record(device),
            "Q": n_q, "R": n_r, "widths": list(widths), "k": K,
            "bound_ms": bounds, timing.times_key(device): times,
            "launches": dict(native.LAUNCHES)}


def main(argv=None) -> dict:
    args = timing.bench_parser(__doc__.splitlines()[0]).parse_args(argv)
    device = resolve_device(args.device or "cuda")
    return timing.emit(run(device, args.small, args.seed), args.out)


if __name__ == "__main__":
    main()
