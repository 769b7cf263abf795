"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. It sets up the cell (inputs from the seed, the program's objects, the
first steps or evaluation), measures for ``--seconds``, checks what the
timed path produced against the plain reference, and prints one JSON
object as the last line of standard output: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics read from a
``torch.profiler`` trace of the window, with the device's busy time and a
breakdown. The numbers compared, each beside its limit, are the last
lines of standard error and the last key of the result.

It exits with a non-zero code, and prints no result, without a card, with
fewer cards than the cell asks for, or when ``jax``, ``jaxlib``, ``flax``
or ``ragraph_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

_T_IMPORT = time.time()
_REPO = Path(__file__).resolve().parent.parent
# every compile cache of the program inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR",
                      str(_REPO / ".perfbench_cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(_REPO / ".perfbench_cache" / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from perfbench import check, spec  # noqa: E402
from perfbench import device as devinfo  # noqa: E402
from perfbench.trace import Profiler, Spans  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ragraph_tpu")
# the longest traced window: the profiler's events of 10 s of
# taobao.pretrain take about 95 s to read, and a traced run ends within
# 360 s, set-up included
TRACE_SECONDS = 10.0


def process_start() -> float:
    """The epoch second this process started (Linux), else the import of
    this module."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(x.split()[1]) for x in f if x.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _T_IMPORT


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _span_summary(name: str, seconds: list) -> str:
    """``name=n/median/p90/max`` of a span's durations in the window, ms."""
    v = sorted(seconds)
    pick = [v[len(v) // 2], v[min(len(v) - 1, int(0.9 * len(v)))], v[-1]]
    return f"{name}={len(v)}/" + "/".join(f"{1e3 * x:.3f}" for x in pick)


def _metric(value, unit):
    return {"value": value, "unit": unit}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float | None = None) -> dict:
    """Set up, warm up, measure and check one cell; the result line as a
    dict (``checks`` last)."""
    t_start = time.time() if t_start is None else t_start
    t_imports = time.time() - t_start   # interpreter, torch, the harness
    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.zeros(1, device=device)
        t_cuda = time.perf_counter() - t0
        from ragraph_tpu_torch import native
        native.lib()                      # builds once per checkout
    else:
        t_cuda = 0.0
    t_build = time.perf_counter() - t0 - t_cuda
    loop = cell["loop"]
    spans = Spans(profile=trace)
    prog = cell["program"].Program(cell["config"], cell["mix"], seed, device,
                                   spans, test_rows=loop.TEST_ROWS)
    loop.setup(prog)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - t_start
    spans.seconds.clear()
    metrics = {}
    if trace:
        from ragraph_tpu_torch import native
        before = dict(native.LAUNCHES)
        with Profiler() as prof:
            loop.window(prog, min(seconds, TRACE_SECONDS))
        counters = {k: v - before.get(k, 0)
                    for k, v in native.LAUNCHES.items()}
        view = prof.view(prog.units, spans.seconds, counters,
                         prog.shapes(), device.type == "cuda")
        for m in cell["per_layer"]:
            value = spec.load_metric(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = _metric(value, m["unit"])
    else:
        measured = loop.measures(prog, loop.window(prog, seconds))
        for m in cell["end_to_end"]:
            base = m["name"].split(".")[0]
            if m["name"] == "setup_s":
                metrics["setup_s"] = _metric(setup_s, "s")
            elif base in measured:
                metrics[m["name"]] = _metric(measured[base], m["unit"])
            else:
                raise SystemExit(f"loop {cell['mix']['loop']!r} gives no "
                                 f"measure for {m['name']!r}")
    dev = devinfo.record(device, cell["chips"])
    if trace:
        dev.update(busy_s=view.busy_s, window_s=view.window_s)
    attempted = prog.units
    prog.close()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    values = cell["loop"].readings(cell, prog, device)
    stages = dict(start_and_imports=t_imports, cuda_init=t_cuda,
                  build=t_build, **prog.stages,
                  reference=time.perf_counter() - t_ref)
    print("stages " + " ".join(f"{k}={v:.3f}s" for k, v in stages.items()),
          file=sys.stderr)
    print("spans " + " ".join(_span_summary(k, v)
                              for k, v in spans.seconds.items()),
          file=sys.stderr)
    correct, checks = check.judge(cell["limits"], values)
    out = {"correct": correct, "attempted": attempted,
           "failed": 0 if correct else attempted, "metrics": metrics,
           "device": dev}
    if trace:
        out["breakdown"] = {"device_ops": view.top_device_ops(),
                            "idle_gaps": view.idle_gaps()}
    out["checks"] = checks
    return out


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    t_start = process_start()
    args = parse(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded in this process: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
