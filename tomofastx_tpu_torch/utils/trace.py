"""Spans and counters of one inversion, on the host's clock.

span(name, timings, sync) times a phase of the workflow: its seconds go to
timings[name + "_s"], after sync() where given (summed over the problems, or
appended where that entry is a list: one a major). fine(name) marks finer
work (LSQR's iterations and reads, the system's blocks) and times nothing.
While a torch.profiler records, a span and a fine mark are also a
range named `tomofastx.<name>` in its trace, stamped on the same clock as
time.time_ns(); with none recording, neither enters a range, so a run that is
not traced pays one test a mark. count(name) adds to `counters`, which an
inversion zeroes as it starts and copies to its timings as it ends.

The ranges take torch's function scope (`_RecordFunctionFast`), as the
profiler's own operator events do. A range of torch.profiler.record_function's
user scope would also come back on the device's timeline, as an annotation
spanning the kernels launched inside it, which a reader of the device trace
would count as work of the device.
"""

from __future__ import annotations

import contextlib
import time

import torch

PREFIX = "tomofastx."
_enabled = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast
_NONE = contextlib.nullcontext()
counters: dict = {}  # count()'s totals, by name


def fine(name: str):
    """The range `tomofastx.<name>` while a profiler records; else nothing."""
    return _range(PREFIX + name) if _enabled() else _NONE


class span:
    """A phase named `name`, as a context: its seconds added to
    timings[name + "_s"] where timings is given, sync() called as it ends
    where given (so that the device's work is in it), and a
    `tomofastx.<name>` range while a profiler records. An exception leaves
    timings as they were. `seconds` reads the phase's time, and while it
    runs the time so far."""

    __slots__ = ("name", "timings", "sync", "start", "end", "_mark")

    def __init__(self, name: str, timings=None, sync=None):
        self.name, self.timings, self.sync = name, timings, sync
        self.start = self.end = None

    def __enter__(self):
        self._mark = fine(self.name)
        self._mark.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and self.sync is not None:
            self.sync()
        self.end = time.time_ns()
        self._mark.__exit__(exc_type, exc, tb)
        if exc_type is None and self.timings is not None:
            key = self.name + "_s"
            value = self.timings.get(key)
            if isinstance(value, list):
                value.append(self.seconds)
            else:
                self.timings[key] = (value or 0.0) + self.seconds
        return False

    @property
    def seconds(self) -> float:
        return ((self.end if self.end is not None else time.time_ns()) - self.start) * 1e-9


def count(name: str, n: int = 1):
    """Adds n to counters[name]."""
    counters[name] = counters.get(name, 0) + n
