"""Profiling and numerical-sanity hooks (counterpart of
``ragraph_tpu/train/profiling.py``).

- :func:`span` / :func:`count`: the port's spans and counters, recorded
  only while a ``torch.profiler`` run is on; :func:`recorded` returns the
  latest recording, :func:`phase_totals` its host seconds by name; every
  garbage collection under a recording is a span too (``gc``);
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
import dataclasses
import gc
import os
import threading
import time

import numpy as np
import torch

_TRACE: dict = {}

# Spans and counters. Tracing is on exactly while a torch.profiler run
# records (the one check below); the store holds the latest recording.
_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_PREFIX = "rg."


@dataclasses.dataclass
class SpanRecord:
    """One span: its name, the enclosing span's name on its thread
    (``None`` at the top), its host seconds and, where it ran with a CUDA
    device, its device seconds: from the device reaching the first work
    enqueued inside the span to the device finishing the last."""
    name: str
    parent: str | None
    host_s: float
    device_s: float | None = None


@dataclasses.dataclass
class Recording:
    """The spans (:class:`SpanRecord`, in the order they closed) and the
    counters of one profiler recording."""
    spans: list = dataclasses.field(default_factory=list)
    counts: dict = dataclasses.field(default_factory=dict)
    # (record, start event, end event) whose device seconds are unread
    pending: list = dataclasses.field(default_factory=list)


_store = Recording()
_stale = False       # a span saw tracing off: the next recording starts anew
_lock = threading.Lock()
_local = threading.local()


def _recording() -> Recording:
    global _store, _stale
    if _stale:
        with _lock:
            if _stale:
                _store, _stale = Recording(), False
    return _store


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "parent", "range", "events", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.range = torch.profiler.record_function(_PREFIX + self.name)
        self.range.__enter__()
        self.events = None
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self.t0
        if self.events is not None:
            self.events[1].record()
        self.range.__exit__(*exc)
        _stack().pop()
        rec = SpanRecord(self.name, self.parent, host_s)
        store = _recording()
        store.spans.append(rec)
        if self.events is not None:
            store.pending.append((rec, *self.events))


def span(name: str):
    """A context manager: the block as span ``name``. With no profiler
    recording it returns at once (it only notes that the next recording
    starts anew). Under a recording the block is a
    ``torch.profiler.record_function`` range named ``"rg." + name``, on the
    profiler's clock, and a :class:`SpanRecord` in the store, with a pair
    of timing events on the current stream once CUDA is initialised.
    Put spans around whole layers' calls, not inside per-row loops."""
    global _stale
    if not _profiling():
        _stale = True
        return _OFF
    return _Span(name)


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name`` of the recording; nothing with no
    profiler recording. ``n`` may be a 0-d tensor on the device, read
    only when the recording is (:func:`recorded`)."""
    if not _profiling():
        return
    store = _recording()
    with _lock:
        store.counts[name] = store.counts.get(name, 0) + n


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: each collection under a recording is span
    ``gc`` (host seconds only; it may run on any thread)."""
    global _stale
    if phase == "start":
        if not _profiling():
            _stale = True
            return
        stack = _stack()
        rng = torch.profiler.record_function(_PREFIX + "gc")
        rng.__enter__()
        _local.gc = (stack[-1] if stack else None, rng, time.perf_counter())
    elif getattr(_local, "gc", None) is not None:
        parent, rng, t0 = _local.gc
        _local.gc = None
        host_s = time.perf_counter() - t0
        rng.__exit__(None, None, None)
        _recording().spans.append(SpanRecord("gc", parent, host_s))


gc.callbacks.append(_on_gc)


def recorded() -> Recording:
    """The latest recording: its spans in the order they closed, each with
    its device seconds read (this waits for the device), and its
    counters, those counted on the device read as ints."""
    store = _store
    if store.pending:
        pending, store.pending = store.pending, []
        for rec, start, end in pending:
            end.synchronize()
            rec.device_s = start.elapsed_time(end) / 1e3
    with _lock:
        for name, n in store.counts.items():
            if isinstance(n, torch.Tensor):
                store.counts[name] = int(n)
    return store


def phase_totals() -> dict:
    """Host seconds of the latest recording by span name."""
    out: dict[str, float] = {}
    for s in recorded().spans:
        out[s.name] = out.get(s.name, 0.0) + s.host_s
    return out


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
