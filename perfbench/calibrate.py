"""The readings that the limits of ``correct`` are set from, in one process.

    python3 -m perfbench.calibrate --workload <name> --seeds 12 \\
        --control 3 --faults 3 [--first-seed N] [--out FILE]

For each of ``--seeds`` seeds: the cell's set-up as a run makes it and a
window of one unit (a step or an evaluation), then the numbers that the
cell's loop compares: the lower readings. For the first ``--control`` seeds
the loop's control: the reference one precision below the configuration's
in the program's place. For the first ``--faults`` seeds each fault the
loop says the cell can have, planted under the timed path. One JSON line
per reading; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from perfbench import spec
from perfbench.trace import Spans


def program_run(cell: dict, seed: int, device):
    """The cell's set-up and a window of one unit."""
    loop = cell["loop"]
    prog = cell["program"].Program(cell["config"], cell["mix"], seed, device,
                                   Spans(), test_rows=loop.TEST_ROWS)
    loop.setup(prog)
    loop.window(prog, 0.0)
    prog.close()
    return prog


def calibrate(cell: dict, seeds: list, n_control: int, n_faults: int,
              device, emit=print, faults=None) -> list:
    out = []

    def put(kind, seed, values):
        rec = {"workload": cell["workload"]["name"], "kind": kind,
               "seed": seed, **values}
        out.append(rec)
        emit(json.dumps(rec))

    loop = cell["loop"]
    for i, seed in enumerate(seeds):
        prog = program_run(cell, seed, device)
        put("program", seed, cell["loop"].readings(cell, prog, device))
        if i < n_control:
            put("control", seed, loop.control(cell, prog, device))
        del prog
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for i, seed in enumerate(seeds[:n_faults]):
        for name, fault in loop.faults(cell).items():
            if faults is not None and name not in faults:
                continue
            with fault():
                prog = program_run(cell, seed, device)
            put(name, seed, cell["loop"].readings(cell, prog, device))
            del prog
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--fault", action="append", default=None,
                    help="plant only these faults (default: all)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    f = open(args.out, "a") if args.out else None

    def emit(line):
        print(line, flush=True)
        if f:
            f.write(line + "\n")
            f.flush()
    try:
        from ragraph_tpu_torch import native
        native.lib()
        calibrate(cell, seeds, args.control, args.faults,
                  torch.device("cuda", 0), emit, args.fault)
    finally:
        if f:
            f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
