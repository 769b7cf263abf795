"""Spans of the benchmark's own, and the reading of a ``torch.profiler``
trace into what the per-layer metrics take.

Spans are host-clock intervals that the harness puts around its calls into
the program's layers (the wait for a batch, a step, ``generate``, the
evaluator). With tracing on, each span is also a
``torch.profiler.record_function`` range, so that an idle gap on the device
can be named by what the host was doing.

:class:`TraceView` is what a metric reader sees: the device's operations
(kernels, copies, fills) with their times, the union of their intervals
(busy), the traced window, the spans, the program's launch counters over
the window, the units of work completed in it, and the cell's shapes.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
import time
from collections import defaultdict

import torch

PREFIX = "perfbench."


class Spans:
    """Host-clock durations by name; with ``profile`` also profiler
    ranges."""

    def __init__(self, profile: bool = False):
        self.profile = profile
        self.seconds: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.profile:
            with torch.profiler.record_function(PREFIX + name):
                yield
        else:
            yield
        self.seconds[name].append(time.perf_counter() - t0)


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces and template
    arguments: ``void ns::(anonymous namespace)::walk_kernel<...>(...)`` ->
    ``walk_kernel``."""
    base = re.sub(r"\(anonymous namespace\)::", "", name.strip())
    base = re.sub(r"^void\s+", "", base)
    m = re.match(r"[\w:]+", base)
    return (m.group(0).split("::")[-1] if m else base)[:64] or name[:64]


@dataclasses.dataclass
class TraceView:
    """One traced window, as the metric readers take it. Times in
    seconds; ``device_ops`` as ``(name, start, end)`` from the window's
    start."""
    window_s: float
    units: int                       # steps or evaluations completed
    device_ops: list
    spans: dict
    counters: dict
    shapes: dict
    host_ops: list = dataclasses.field(default_factory=list)

    def device_seconds(self, patterns) -> float:
        """Device seconds of the operations whose name holds any of
        ``patterns``."""
        return sum(e - s for n, s, e in self.device_ops
                   if any(p in n for p in patterns))

    def ran(self, patterns) -> bool:
        return any(any(p in n for p in patterns) for n, _, _ in
                   self.device_ops)

    def busy_intervals(self) -> list:
        out = []
        for _, s, e in sorted(self.device_ops, key=lambda x: x[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def per_unit(self, seconds: float) -> float:
        return seconds / max(self.units, 1)

    def top_device_ops(self, n: int = 10) -> list:
        tot = defaultdict(float)
        for name, s, e in self.device_ops:
            tot[short_name(name)] += e - s
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle time by what the host was doing when each gap
        began: the innermost benchmark span and the innermost host
        operation open at that moment."""
        busy = self.busy_intervals()
        edges = [(0.0, 0.0)] + [tuple(b) for b in busy] \
            + [(self.window_s, self.window_s)]
        gaps = [(a[1], b[0]) for a, b in zip(edges, edges[1:])
                if b[0] > a[1]]

        def innermost(ops, starts, mid, lookback):
            """The latest-starting range of ``ops`` open at ``mid``."""
            i = bisect.bisect_right(starts, mid)
            for name, s, e in reversed(ops[max(0, i - lookback):i]):
                if e >= mid:
                    return name
            return ""

        spans = sorted((o for o in self.host_ops
                        if o[0].startswith(PREFIX)
                        and o[0] != PREFIX + "window"), key=lambda x: x[1])
        ops = sorted((o for o in self.host_ops
                      if not o[0].startswith(PREFIX)), key=lambda x: x[1])
        span_starts = [o[1] for o in spans]
        op_starts = [o[1] for o in ops]
        tot = defaultdict(float)
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            # the benchmark's spans follow each other, seldom nested
            span = innermost(spans, span_starts, mid, 8)[len(PREFIX):]
            op = innermost(ops, op_starts, mid, 256)
            label = "/".join(x for x in (span, op) if x) or "outside spans"
            tot[label] += g1 - g0
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]


def _annotation(evt) -> bool:
    """A profiler range drawn on the device's timeline (a
    ``record_function`` of the benchmark or of PyTorch), not work."""
    name = str(evt.name)
    return bool(getattr(evt, "is_user_annotation", False)) \
        or name.startswith(PREFIX) or name.startswith("Optimizer.") \
        or name.startswith("ProfilerStep")


def read_profile(prof):
    """``(device_ops, host_ops, window_s)`` of a finished
    ``torch.profiler`` run over a ``window`` span: operations as ``(name,
    start_s, end_s)`` from the span's start, and the span's length."""
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for evt in prof.events():
        tr = evt.time_range
        rec = (str(evt.name), tr.start * 1e-6, tr.end * 1e-6)
        if getattr(evt, "device_type", None) != cuda:
            host.append(rec)
        elif not _annotation(evt):
            dev.append(rec)
    win = [r for r in host if r[0] == PREFIX + "window"]
    if not win:
        raise RuntimeError("the trace holds no window span")
    t0, t1 = win[0][1], win[0][2]

    def shift(ops):
        return [(n, max(s, t0) - t0, min(e, t1) - t0) for n, s, e in ops
                if e > t0 and s < t1]
    return shift(dev), shift(host), t1 - t0


class Profiler:
    """A ``torch.profiler`` run over the traced window (CPU and CUDA
    activity); :meth:`view` reads it."""

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)

    def view(self, units, spans, counters, shapes,
             on_device: bool) -> TraceView:
        device_ops, host_ops, window_s = read_profile(self.prof)
        if not on_device:
            # rehearsal on the CPU: no device; the host's operations stand
            # in so that the reading code runs end to end
            device_ops = [o for o in host_ops
                          if not o[0].startswith(PREFIX)]
        return TraceView(window_s=window_s, units=units,
                         device_ops=device_ops, spans=dict(spans),
                         counters=dict(counters), shapes=dict(shapes),
                         host_ops=host_ops)
