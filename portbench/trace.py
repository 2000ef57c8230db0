"""The traced run's spans and its reading of the device trace.

Spans come from the benchmark's own files: `spans()` puts a
`torch.profiler.record_function` range around every call into the layers
it names (the operators' `matvec`/`rmatvec`, the solve's `lsqr_solve`) by
wrapping them for the length of the traced run, and counts the products.
`profiled(fn)` runs fn under torch.profiler and reads the raw events: the
ranges on the host, the launches, and every operation on the device, each
run once (a record whose kernel, card, stream and start another holds is
dropped, as `chip_smoke.py::cuda_kernel_events` does).
"""

from __future__ import annotations

import contextlib
import functools
import time
from bisect import bisect_right
from collections import Counter, defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

WINDOW = "portbench.window"
# The profiler drops device events it places outside its window: idle
# margins on both sides of the traced work.
MARGIN_S = 0.1
# Operators whose products are traced, by the module that defines them.
OPERATORS = {
    "tomofastx_tpu_torch.ops.matrixfree": ("LatticeMatrixFreeKernel", "MatrixFreeKernel"),
    "tomofastx_tpu_torch.ops.sparse_kernel": ("DenseKernel", "PackedKernel"),
    "tomofastx_tpu_torch.ops.tile_kernel": ("TileKernel",),
    "tomofastx_tpu_torch.ops.bttb": ("BTTBKernel",),
}


@dataclass
class Products:
    """Products counted by the spans: calls[(class, method)] and the stored
    shape (rows, columns) of each call's operator, where it has one."""

    calls: Counter = field(default_factory=Counter)
    shapes: list = field(default_factory=list)


def _shape(op):
    S = getattr(op, "S", None)
    if isinstance(S, torch.Tensor):
        return (op.nrows, op.ncols)
    return None


@contextlib.contextmanager
def spans():
    """Wrap the operators' products and `lsqr_solve` in ranges named
    `portbench.op.<class>.<method>` and `portbench.lsqr` for as long as the
    context lasts; yields the Products it counts."""
    import importlib

    joint = importlib.import_module("tomofastx_tpu_torch.inversion.joint")
    products = Products()
    undo = []

    def wrap_method(cls, method):
        inner = cls.__dict__[method]
        name = f"portbench.op.{cls.__name__}.{method}"

        @functools.wraps(inner)
        def traced(self, *args, **kwargs):
            products.calls[(cls.__name__, method)] += 1
            products.shapes.append((cls.__name__, method, _shape(self)))
            with torch.profiler.record_function(name):
                return inner(self, *args, **kwargs)

        setattr(cls, method, traced)
        undo.append((cls, method, inner))

    for module, names in OPERATORS.items():
        mod = importlib.import_module(module)
        for cname in names:
            cls = getattr(mod, cname, None)
            for method in ("matvec", "rmatvec"):
                if cls is not None and method in cls.__dict__:
                    wrap_method(cls, method)
    lsqr = joint.lsqr_solve

    @functools.wraps(lsqr)
    def traced_lsqr(*args, **kwargs):
        with torch.profiler.record_function("portbench.lsqr"):
            return lsqr(*args, **kwargs)

    joint.lsqr_solve = traced_lsqr
    try:
        yield products
    finally:
        joint.lsqr_solve = lsqr
        for cls, method, inner in undo:
            setattr(cls, method, inner)


@dataclass
class Trace:
    """What one profiled call left: the window (host ns), the device
    operations (name, start ns, duration ns, range of their launch or None)
    and the host's CPU events for labelling idle gaps."""

    window: tuple
    device_ops: list
    cpu_events: list

    def busy_intervals(self):
        """Merged intervals (ns) in which some operation ran on the device,
        clipped to the window."""
        lo, hi = self.window
        spans_ = sorted((max(s, lo), min(s + d, hi)) for _, s, d, _ in self.device_ops if s + d > lo and s < hi)
        merged = []
        for s, e in spans_:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def device_s_in(self, prefix):
        """Device seconds of the operations launched inside ranges whose name
        starts with `prefix`."""
        return sum(d for _, _, d, r in self.device_ops if r is not None and r.startswith(prefix)) * 1e-9

    def top_ops(self, n=10):
        by_name = defaultdict(int)
        for name, _, d, _ in self.device_ops:
            by_name[name] += d
        return [[name, ns * 1e-9] for name, ns in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10):
        """The n longest idle gaps of the device in the window, each named by
        what the host was doing as it began: the innermost CPU event then."""
        lo, hi = self.window
        edges = [lo] + [t for iv in self.busy_intervals() for t in iv] + [hi]
        gaps = sorted(((edges[k + 1] - edges[k], edges[k]) for k in range(0, len(edges), 2)
                       if edges[k + 1] > edges[k]), reverse=True)[:n]
        if not self.cpu_events:
            return [["host", g * 1e-9] for g, _ in gaps]
        names = [e[0] for e in self.cpu_events]
        starts = np.array([e[1] for e in self.cpu_events], np.int64)
        ends = np.array([e[2] for e in self.cpu_events], np.int64)
        out = []
        for g, t in gaps:
            inside = np.nonzero((starts <= t) & (ends >= t))[0]
            label = names[inside[np.argmax(starts[inside])]] if inside.size else "host outside any event"
            out.append([label, g * 1e-9])
        return out


def _on_first_call(target, action):
    """Wrap the function `target` = (module, name) so that its first call
    runs action() before it; returns the undo."""
    module, name = target
    inner = getattr(module, name)

    @functools.wraps(inner)
    def first_call(*args, **kwargs):
        action()
        setattr(module, name, inner)
        return inner(*args, **kwargs)

    setattr(module, name, first_call)
    return lambda: setattr(module, name, inner)


def profiled(fn, stop_on=None):
    """fn() under torch.profiler (host and device), inside a `portbench.window`
    range; returns (fn's result, Trace). With `stop_on` = (module, name), the
    profiler stops at the first call of that module's function during fn():
    a fused inversion is traced up to its fused loop, whose CUDA graph with a
    WHILE node faults on the card under the profiler."""
    card = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if card else [])
    sync = torch.cuda.synchronize if card else (lambda: None)
    prof = torch.profiler.profile(activities=activities)
    window = torch.profiler.record_function(WINDOW)
    on = []

    def end():
        if on:
            sync()
            window.__exit__(None, None, None)
            time.sleep(MARGIN_S)
            prof.stop()
            on.clear()

    sync()
    prof.start()
    time.sleep(MARGIN_S)
    window.__enter__()
    on.append(True)
    undo = _on_first_call(stop_on, end) if stop_on is not None else (lambda: None)
    try:
        out = fn()
    finally:
        undo()
        end()
    return out, read_events(prof.profiler.kineto_results.events())


def read_events(events):
    """A Trace from the profiler's raw events."""
    device_type = torch.autograd.DeviceType
    ranges, launches, ops, cpu = [], {}, {}, []
    for e in events:
        if e.device_type() == device_type.CPU:
            name, start = e.name(), e.start_ns()
            end = start + e.duration_ns()
            if name.startswith("portbench."):
                ranges.append((name, start, end))
            if name.startswith(("cuda", "cu")) and "Launch" in name:
                launches[e.correlation_id()] = start
            cpu.append((name, start, end))
        elif e.device_type() == device_type.CUDA:
            key = (e.name(), e.device_index(), e.device_resource_id(), e.start_ns())
            ops[key] = (e.duration_ns(), e.correlation_id(), e.linked_correlation_id())
    # A host range comes back on the device too, as an annotation of the
    # same name: no operation of the device, so left out.
    annotations = {n for n, _, _ in ranges}
    ops = {key: v for key, v in ops.items() if key[0] not in annotations}
    window = next(((s, t) for n, s, t in ranges if n == WINDOW), None)
    if window is None:
        raise RuntimeError("the profiler's events hold no window range")
    # Products' ranges do not nest in one another: the range of a launch is
    # the last that began before it, if it has not ended yet.
    leaf = sorted((s, t, n) for n, s, t in ranges if n.startswith("portbench.op."))
    leaf_starts = [s for s, _, _ in leaf]

    def range_of(host_ns):
        if host_ns is None:
            return None
        k = bisect_right(leaf_starts, host_ns) - 1
        return leaf[k][2] if k >= 0 and leaf[k][1] >= host_ns else None

    device_ops = []
    for (name, _, _, start), (dur, corr, linked) in ops.items():
        host = launches.get(corr, launches.get(linked))
        device_ops.append((name, start, dur, range_of(host)))
    return Trace(window=window, device_ops=device_ops, cpu_events=cpu)
