"""Profiling and numerical-sanity hooks (counterpart of
``ragraph_tpu/train/profiling.py``).

- :func:`phase`: a named wall-clock timer that also opens a
  ``torch.profiler.record_function`` range, so phases show in traces;
- :func:`annotate`: the same range around every call of a function;
- :func:`start_trace` / :func:`stop_trace`: a ``torch.profiler`` capture
  written as a Chrome trace;
- :func:`op_profile`: per-op self-times of a function from
  ``torch.profiler``'s ``key_averages()``, in the JAX function's rows;
- :func:`record_memory_analysis`: the CUDA caching allocator's counters;
- :func:`tree_all_finite` / :func:`assert_all_finite`: a finiteness sweep
  over a tree of tensors and arrays.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import numpy as np
import torch

_PHASE_TIMES: dict[str, float] = {}
_TRACE: dict = {}


@contextlib.contextmanager
def phase(name: str, log=None):
    """Time the block on the host clock and add it to the phase's total;
    ``log`` gets one line with both."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    _PHASE_TIMES[name] = _PHASE_TIMES.get(name, 0.0) + dt
    if log is not None:
        log(f"[phase] {name}: {dt:.3f}s (total {_PHASE_TIMES[name]:.3f}s)")


def phase_totals() -> dict:
    """Seconds spent in each phase name so far in this process."""
    return dict(_PHASE_TIMES)


def annotate(name: str | None = None):
    """Decorator: run the function inside a profiler range named ``name``
    (its own name by default)."""

    def deco(fn):
        label = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_trace(log_dir: str) -> None:
    """Start a ``torch.profiler`` capture (CPU, and the card where there is
    one); :func:`stop_trace` writes it under ``log_dir``."""
    if _TRACE:
        raise RuntimeError("a trace is already running")
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    _TRACE.update(prof=prof, log_dir=log_dir)


def stop_trace() -> str:
    """Stop the capture; return the path of its Chrome trace file."""
    if not _TRACE:
        raise RuntimeError("no trace is running")
    prof, log_dir = _TRACE.pop("prof"), _TRACE.pop("log_dir")
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


def _leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _self_us(evt, on_device: bool) -> float:
    if not on_device:
        return evt.self_cpu_time_total
    # the attribute was renamed in torch 2.4
    return getattr(evt, "self_device_time_total", None) \
        or getattr(evt, "self_cuda_time_total", 0.0)


def op_profile(fn, *args, iters: int = 3, min_ms: float = 0.05
               ) -> list[dict]:
    """Per-op self-times of ``fn(*args)``, averaged over ``iters`` calls
    after a warm one: ``[{"type", "name", "occurrences", "ms_per_call"},
    ...]``, the costliest first, those under ``min_ms`` dropped.

    When the result lies on the card the rows are the device's: every
    kernel, copy and fill by name (``type`` ``"kernel"``), timed on the
    device by CUPTI. On the CPU they are the operators' self-times on the
    host (``type`` ``"cpu_op"``). ``record_function`` ranges are left out
    (they span the ops inside them). The JAX function reads XLA's op
    statistics from an xprof trace instead.
    """
    def run():
        leaves = [t for t in _leaves(fn(*args))
                  if isinstance(t, torch.Tensor)]
        dev = leaves[0].device if leaves else torch.device("cpu")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return dev

    on_device = run().type == "cuda"
    with torch.profiler.profile(activities=_activities()) as prof:
        for _ in range(iters):
            run()
    rows = []
    for evt in prof.key_averages():
        is_device = evt.device_type == torch.autograd.DeviceType.CUDA
        # record_function ranges span the ops inside them: not ops
        if is_device != on_device or getattr(evt, "is_user_annotation",
                                             False):
            continue
        ms = _self_us(evt, on_device) / iters / 1000.0
        if ms >= min_ms:
            rows.append({"type": "kernel" if on_device else "cpu_op",
                         "name": str(evt.key), "occurrences": evt.count,
                         "ms_per_call": round(ms, 4)})
    return sorted(rows, key=lambda d: -d["ms_per_call"])


# Device-memory records of EdgeTrainer's first step (and of any caller)
# when RAGRAPH_MEM_ANALYSIS is set.
MEMORY_ANALYSES: list[dict] = []


def record_memory_analysis(tag: str, device, log=print) -> dict | None:
    """Append the CUDA caching allocator's counters for ``device`` (bytes:
    allocated now, the peak, reserved) and log them. Returns the entry, or
    ``None`` off the card.

    The JAX function records XLA's compile-time analysis of one program
    (arguments, temporaries, outputs, aliases). Eager PyTorch compiles no
    program, so there is no such analysis here: these are the live
    allocator's counters after the work ran.
    """
    dev = torch.device(device)
    if dev.type != "cuda":
        log(f"[mem] {tag}: no device memory statistics on {dev}")
        return None
    st = torch.cuda.memory_stats(dev)
    entry = {"tag": tag,
             "allocated_bytes": int(st.get("allocated_bytes.all.current", 0)),
             "peak_bytes": int(st.get("allocated_bytes.all.peak", 0)),
             "reserved_bytes": int(st.get("reserved_bytes.all.current", 0))}
    MEMORY_ANALYSES.append(entry)
    log(f"[mem] {tag}: allocated {entry['allocated_bytes'] / 2**30:.3f} GiB, "
        f"peak {entry['peak_bytes'] / 2**30:.3f} GiB, "
        f"reserved {entry['reserved_bytes'] / 2**30:.3f} GiB")
    return entry


def tree_all_finite(tree) -> bool:
    """Whether every floating tensor and array in a tree of dicts, lists
    and tuples is finite (one host read)."""
    flags = []
    for x in _leaves(tree):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            flags.append(torch.isfinite(x).all().cpu())
        elif isinstance(x, np.ndarray) and np.issubdtype(x.dtype,
                                                         np.floating):
            flags.append(torch.tensor(bool(np.isfinite(x).all())))
    return bool(torch.stack(flags).all()) if flags else True


def assert_all_finite(tree, what: str = "tree") -> None:
    """Raise ``ValueError`` if :func:`tree_all_finite` is false."""
    if not tree_all_finite(tree):
        raise ValueError(f"non-finite values detected in {what}")
