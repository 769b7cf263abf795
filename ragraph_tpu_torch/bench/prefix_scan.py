"""Kernel H, the row prefix sum, by device time beside its bound.

    python -m ragraph_tpu_torch.bench.prefix_scan [--device cpu --small]
        [--out FILE]

Shapes (``SHAPES``): the ops path's 2^21 x 64 messages, f32 exclusive (as
``sorted_segment_sum`` asks for them) and inclusive, a bf16 input, 2^18 x
512 (eight column slabs) and 2^21 x 33 (four columns a thread, loaded one at
a time). For each: the device's time alone (``timing.device_ms``, under
``ms``), the bound (the input read once and the output written once, at
3.35 TB/s) and the share of it, a ``Tensor.copy_`` of the same bytes into a
new f32 matrix (what moving them costs on this card), the largest error
against the plain version, and whether two calls gave the same bits.

The last line is one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import torch

from ragraph_tpu_torch import native
from ragraph_tpu_torch.bench import timing
from ragraph_tpu_torch.device import resolve_device

HBM_BYTES_PER_MS = 3.35e9
# (name, rows, columns, input dtype, exclusive)
SHAPES = (("f32_excl_2^21x64", 1 << 21, 64, "float32", True),
          ("f32_incl_2^21x64", 1 << 21, 64, "float32", False),
          ("bf16_incl_2^21x64", 1 << 21, 64, "bfloat16", False),
          ("f32_excl_2^18x512", 1 << 18, 512, "float32", True),
          ("f32_excl_2^21x33", 1 << 21, 33, "float32", True))
SMALL_SHAPES = (("f32_excl_small", 3000, 64, "float32", True),
                ("bf16_incl_small", 3000, 33, "bfloat16", False))


def bound_ms(n: int, d: int, dtype: str) -> float:
    """The least device time: the input read once, the f32 prefix and
    total written once."""
    in_bytes = 2 if dtype == "bfloat16" else 4
    return (n * d * (in_bytes + 4) + 4 * d) / HBM_BYTES_PER_MS


def run(device, small: bool, seed: int = 0) -> dict:
    """Every shape through ``ops.prefix_sum.prefix_sum``, held to the plain
    version."""
    from ragraph_tpu_torch.ops.prefix_sum import prefix_sum, prefix_sum_plain
    native.reset_launches()
    key = timing.times_key(device)
    shapes, times, copies = {}, {}, {}
    for name, n, d, dtype, exclusive in (SMALL_SHAPES if small else SHAPES):
        gen = torch.Generator(device).manual_seed(seed + n + d)
        x = torch.randn(n, d, generator=gen, device=device).to(
            getattr(torch, dtype))
        got, total = prefix_sum(x, exclusive)
        again, total2 = prefix_sum(x, exclusive)
        ref, ref_total = prefix_sum_plain(x, exclusive)
        rec = {"n": n, "d": d, "dtype": dtype, "exclusive": exclusive,
               "bound_ms": bound_ms(n, d, dtype),
               "max_abs_err": float((got - ref).abs().max()),
               "total_err": float((total - ref_total).abs().max()),
               "prefix_size": float(ref.abs().max()),
               "repeat_equal": bool(torch.equal(got, again)
                                    and torch.equal(total, total2))}
        del got, again, ref
        if timing.is_cuda(device):
            times[name] = timing.device_ms(lambda: prefix_sum(x, exclusive))
            rec["share_of_bound"] = rec["bound_ms"] / times[name]
            # the same bytes through PyTorch's copy kernel (the input read
            # once, an f32 matrix of its shape written once)
            copies[name] = timing.device_ms(
                lambda: torch.empty(n, d, dtype=torch.float32,
                                    device=x.device).copy_(x))
        else:
            times[name] = timing.timed_ms(lambda: prefix_sum(x, exclusive),
                                          3, 1, device)
        shapes[name] = rec
        del x
        if timing.is_cuda(device):
            torch.cuda.empty_cache()
    record = {"bench": "prefix_scan", "device": timing.device_record(device),
              "shapes": shapes, key: times}
    if copies:
        record["copy_same_bytes_ms"] = copies
    record["launches"] = dict(native.LAUNCHES)
    return record


def main(argv=None) -> dict:
    args = timing.bench_parser(__doc__.splitlines()[0]).parse_args(argv)
    device = resolve_device(args.device or "cuda")
    return timing.emit(run(device, args.small, args.seed), args.out)


if __name__ == "__main__":
    main()
