#!/usr/bin/env python3
"""Where a benchmark cell's device idles, by the program's own ranges.

Sets up one cell of the port's benchmark (portbench/) from a seed, runs its
warm-up and one untraced inversion, then traces inversions as the
`--trace 1` run traces one (torch.profiler over `portbench.trace.profiled`,
the benchmark's product ranges on), with the program's `tomofastx.*` ranges
on, off, off and on (utils/trace.py's profiler test forced false turns
them off). It prints, as one JSON line last:

- the untraced inversion's timings;
- for the first traced inversion, the device's busy and idle seconds and
  the idle seconds by the innermost `tomofastx.*` range open as each gap
  begins (the five `block.*` kinds summed), and by the phase (a range
  without a dot) open then;
- each traced inversion's `total_s`: the ranges' cost while a profiler
  records.

    python3 scripts/probe_torch_idle_by_range.py <cell> <seed> [out.json]

from the root of a checkout. Needs one CUDA device (device "cpu" as a
fourth argument runs it on the CPU, where the device trace is empty)."""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
from collections import defaultdict

# The checkout whose program and benchmark run: the current directory.
sys.path.insert(0, os.getcwd())

PREFIX = "tomofastx."


def idle_by_range(trace) -> dict:
    """The device's idle seconds in a portbench Trace, by the innermost
    program range and by the phase open where each gap begins."""
    lo, hi = trace.window
    edges = [lo] + [t for iv in trace.busy_intervals() for t in iv] + [hi]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
    ranges = [(s, e, n[len(PREFIX):]) for n, s, e in trace.cpu_events if n.startswith(PREFIX)]
    inner, phase = defaultdict(float), defaultdict(float)
    for start, end in gaps:
        open_ = [(s, n) for s, e, n in ranges if s <= start < e]
        name = max(open_)[1] if open_ else "none"
        inner["block.*" if name.startswith("block.") else name] += (end - start) * 1e-9
        phases = [(s, n) for s, n in open_ if n != "total" and "." not in n]
        phase[max(phases)[1] if phases else "none"] += (end - start) * 1e-9
    return {"window_s": trace.window_s, "busy_s": trace.busy_s, "idle_s": trace.window_s - trace.busy_s,
            "idle_by_innermost": dict(sorted(inner.items(), key=lambda kv: -kv[1])),
            "idle_by_phase": dict(sorted(phase.items(), key=lambda kv: -kv[1]))}


def main(argv) -> int:
    import torch

    from portbench import run as prun
    from portbench import trace as tracing
    from portbench.window import Cell
    from tomofastx_tpu_torch.utils import trace as program_trace

    cell, seed = argv[0], int(argv[1])
    out = argv[2] if len(argv) > 2 else None
    device = argv[3] if len(argv) > 3 else "cuda"
    workload = prun.load_json("workloads", cell)
    config = prun.load_json("configs", workload["config"])
    work = tempfile.mkdtemp(prefix="idle-by-range-")
    c = Cell(work, config, workload, seed, device)
    try:
        c.warm_up()
        result = {"cell": cell, "seed": seed,
                  "device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                  "untraced_timings": c.solve().timings, "traced_total_s": []}
        enabled = program_trace._enabled
        for k, ranges in enumerate((True, False, False, True)):
            program_trace._enabled = enabled if ranges else (lambda: False)
            try:
                with tracing.spans():
                    inv, trace = tracing.profiled(c.solve)
            finally:
                program_trace._enabled = enabled
            result["traced_total_s"].append({"ranges": ranges, "total_s": inv.timings["total_s"]})
            if k == 0:
                result["traced"] = dict(idle_by_range(trace), timings=inv.timings)
    finally:
        c.close()
        shutil.rmtree(work, ignore_errors=True)
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
