"""Timing helpers shared by the bench scripts and ``chip_smoke.py``.

On a CUDA device times are taken between CUDA events after a warm-up. On
the CPU (``--device cpu``, small sizes, for rehearsal) they are host-clock
times and every script reports them under ``cpu_host_ms``, never under the
device's ``ms``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch


def is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def timed_ms(fn, reps: int = 20, warmup: int = 2, device="cuda") -> float:
    """Milliseconds per call of ``fn`` over ``reps`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    if not is_cuda(device):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``, its kernels and copies: the
    stream is held by a sleeping kernel while the host queues ``reps``
    calls behind the start event, so the events time the device alone. A
    loop of calls between two events (:func:`timed_ms`) also counts the
    host's time between launches, which sets the pace of calls shorter than
    their Python wrappers. ``fn`` must not wait for the device."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)    # about 25 ms: longer than the queueing
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class StageTimer:
    """Per-stage milliseconds between CUDA events recorded on an idle
    stream before a stage and after it (host clock on the CPU); a stage's
    host work falls between them too."""

    def __init__(self, device="cuda"):
        self.ms = {}
        self.cuda = is_cuda(device)

    def __call__(self, name, fn):
        if not self.cuda:
            t0 = time.perf_counter()
            out = fn()
            self.ms[name] = (time.perf_counter() - t0) * 1e3
            return out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        self.ms[name] = start.elapsed_time(end)
        return out


def split_ms(parts, reps: int, device="cuda") -> list[float]:
    """Mean milliseconds of each callable of ``parts``, run in order
    ``reps + 1`` times (the first pass warms up), each between its own pair
    of marks."""
    cuda = is_cuda(device)
    sums = [0.0] * len(parts)
    for rep in range(reps + 1):
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(parts) + 1)]
            torch.cuda.synchronize()
            ev[0].record()
            for j, part in enumerate(parts):
                part()
                ev[j + 1].record()
            ev[-1].synchronize()
            took = [ev[j].elapsed_time(ev[j + 1]) for j in range(len(parts))]
        else:
            took = []
            for part in parts:
                t0 = time.perf_counter()
                part()
                took.append((time.perf_counter() - t0) * 1e3)
        if rep:
            sums = [s + t for s, t in zip(sums, took)]
    return [s / reps for s in sums]


def bench_parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--small", action="store_true",
                    help="a small shape, for a rehearsal on the CPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the JSON line to this file")
    return ap


def device_record(device) -> dict:
    """Which device the numbers were taken on, with the card's name and
    power limit as ``nvidia-smi`` gives them."""
    if not is_cuda(device):
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    idx = torch.device(device).index or 0
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(idx),
           "count": torch.cuda.device_count()}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(idx)],
            capture_output=True, text=True, timeout=60)
        if smi.returncode == 0 and smi.stdout.strip():
            rec["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return rec


def times_key(device) -> str:
    return "ms" if is_cuda(device) else "cpu_host_ms"


def emit(record: dict, out_path: str | None) -> dict:
    """Print ``record`` as the script's final JSON line; write it to
    ``out_path`` too when one is given."""
    line = json.dumps(record)
    print(line, flush=True)
    if out_path:
        with open(out_path, "w") as f:
            f.write(line + "\n")
    return record
