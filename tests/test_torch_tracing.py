"""The port's spans and counters (tomofastx_tpu_torch/utils/trace.py) on
tiny host-driven inversions on the CPU: a matrix-free lattice problem (the
grid and survey of tests/test_torch_workflow.py) and the coupled joint
problem of tests/test_torch_coupled.py. Each phase span is a
`tomofastx.<name>` range of torch.profiler's trace whose time is its
timings entry; no range is entered with no profiler recording; the named
phases lie inside what read_inputs_s, build_s and solve_s leave of total_s;
host_reads counts the solve's reads of the device exactly; a fused run on
the CPU captures nothing. And the benchmark's readers of these spans
(portbench/metrics/) on a hand-made trace and run."""

import os
import sys
from types import SimpleNamespace

import pytest
import torch

from tomofastx_tpu_torch.config.parfile import parse_parfile_lines as tparse
from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag
from tomofastx_tpu_torch.utils import trace

from test_torch_coupled import coupled_lines, write_coupling_inputs
from test_torch_workflow import _write_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench.run import Run, load_metric  # noqa: E402
from portbench.trace import Trace  # noqa: E402

# The spans each problem's timings must hold.
PHASES = {
    "lattice": ("read_inputs", "depth_weight", "operator", "forward_data", "outputs", "solve", "total"),
    "joint": ("read_inputs", "depth_weight", "build", "row_weights", "forward_data", "outputs", "solve", "total"),
}


@pytest.fixture(scope="module")
def parfiles(tmp_path_factory):
    """Parfile lines of the two problems for an output folder: the lattice
    one matrix-free (3 majors of 6 LSQR iterations, a checkpoint every 2),
    the joint one dense and coupled by all three constraints."""
    lattice = _write_problem(str(tmp_path_factory.mktemp("lattice")), 8, 8, 4, 16, wtype=0, niter=6,
                             fmt="matrixfree")
    joint = str(tmp_path_factory.mktemp("joint"))
    write_coupling_inputs(joint)
    return {"lattice": lattice, "joint": lambda out: coupled_lines(joint, "all-three", out, fmt="dense")}


def _solve(parfiles, problem, out, **kw):
    return solve_problem_joint_gravmag(tparse(parfiles[problem](str(out))), solve_dtype=torch.float64,
                                       verbose=False, device="cpu", **kw)


def _ranges(prof):
    """(name, seconds) of the profiler's `tomofastx.*` ranges, in order."""
    return [(e.name(), e.duration_ns() * 1e-9) for e in sorted(prof.profiler.kineto_results.events(),
                                                              key=lambda e: e.start_ns())
            if e.name().startswith(trace.PREFIX)]


@pytest.mark.parametrize("problem", list(PHASES))
def test_phase_spans_are_profiler_ranges_of_their_time(parfiles, tmp_path, problem):
    """Under torch.profiler every phase is a `tomofastx.<name>` range; each
    name's ranges add up to its timings entry within 1 ms (solve_s: each
    major's range its own entry)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = _solve(parfiles, problem, tmp_path / "out")
    ranges = _ranges(prof)
    spans = {k[:-2] for k, v in res.timings.items() if k.endswith("_s")}
    assert set(PHASES[problem]) <= spans, sorted(spans)
    for name in spans:
        seconds = [s for n, s in ranges if n == trace.PREFIX + name]
        timed = res.timings[name + "_s"]
        if isinstance(timed, list):
            assert len(seconds) == len(timed) and max(abs(a - b) for a, b in zip(seconds, timed)) < 1e-3, name
        else:
            assert seconds and abs(sum(seconds) - timed) < 1e-3, (name, sum(seconds), timed)
    # The fine marks are there too, one LSQR iteration's each.
    names = {n for n, _ in ranges}
    assert {"tomofastx.lsqr.iteration", "tomofastx.lsqr.read", "tomofastx.sensit.matvec"} <= names
    if problem == "joint":
        kinds = ("damping", "damping_gradient", "admm", "cross_gradient", "clustering")
        assert {f"tomofastx.block.{k}.{p}" for k in kinds for p in ("matvec", "rmatvec")} <= names
        assert {"tomofastx.wavelet.forward", "tomofastx.wavelet.inverse"} <= names


def test_no_range_is_entered_without_a_profiler(parfiles, tmp_path, monkeypatch):
    """With no profiler recording, neither a span nor a fine mark enters a
    range: the name the tracer enters them by is never called. Under a
    profiler it is."""
    calls = []

    def entered(name):
        calls.append(name)
        return trace._NONE

    monkeypatch.setattr(trace, "_range", entered)
    res = _solve(parfiles, "joint", tmp_path / "out")
    assert calls == [] and res.timings["total_s"] > 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("phase"), trace.fine("mark"):
            pass
    assert calls == ["tomofastx.phase", "tomofastx.mark"]


@pytest.mark.parametrize("problem", list(PHASES))
def test_named_phases_lie_inside_the_remainder(parfiles, tmp_path, problem):
    """depth_weight_s + operator_s + forward_data_s + outputs_s is part of
    total_s - read_inputs_s - build_s - sum(solve_s): the spans that were
    there keep their extent, and the new ones do not overlap them."""
    t = _solve(parfiles, problem, tmp_path / "out").timings
    rest = t["total_s"] - t["read_inputs_s"] - t.get("build_s", 0.0) - sum(t["solve_s"])
    named = sum(t.get(k, 0.0) for k in ("depth_weight_s", "operator_s", "forward_data_s", "outputs_s"))
    assert 0.0 < named <= rest + 1e-3, (named, rest)


# host_reads from the loop: host-driven, one read an LSQR iteration (no
# misfit test; LSQR never meets rho = 0 here) and one copy of a major's
# results; fused, one copy of a chunk's results (solve_s has one entry a
# major, or a chunk).
LOOPS = {
    "host": ({}, lambda t: sum(t["lsqr_iters"]) + len(t["solve_s"])),
    "fused": ({"fused_chunk": 3}, lambda t: len(t["solve_s"])),
}


@pytest.mark.parametrize("loop", list(LOOPS))
def test_host_reads_counts_the_solves_reads(parfiles, tmp_path, loop):
    kw, expected = LOOPS[loop]
    t = _solve(parfiles, "lattice", tmp_path / "out", **kw).timings
    assert t["lsqr_iters"] == [6, 6, 6]
    assert t["host_reads"] == expected(t)
    if loop == "fused":
        # Cut at writeModelEveryNiter = 2: chunks of 2 and 1 majors.
        assert len(t["solve_s"]) == 2
        # The CPU's eager steps capture nothing.
        assert "capture_s" not in t and "capture_warmup_s" not in t


def test_count_adds_to_the_counters():
    """count() adds to trace.counters, which an inversion zeroes as it
    starts (the exact counts above, inversion after inversion)."""
    trace.counters.clear()
    trace.count("host_reads")
    trace.count("host_reads", 2)
    trace.count("other")
    assert trace.counters == {"host_reads": 3, "other": 1}


def test_span_adds_and_appends_and_leaves_timings_on_an_exception():
    timings = {"solve_s": []}
    for _ in range(2):
        with trace.span("phase", timings):
            pass
        with trace.span("solve", timings, sync=lambda: None):
            pass
    assert timings["phase_s"] > 0 and len(timings["solve_s"]) == 2
    before = dict(timings, solve_s=list(timings["solve_s"]))
    with pytest.raises(ValueError):
        with trace.span("phase", timings, sync=lambda: pytest.fail("synchronised after an exception")):
            raise ValueError
    assert timings == before


# ---- the benchmark's readers, on a hand-made run ----

MS = 1_000_000


def _run(each=(), trace_=None, traced=None):
    """A Run whose window holds untraced inversions of the timings in
    `each` and, where `traced` is given, the traced one after them."""
    inversions = [SimpleNamespace(timings=t) for t in each]
    window = SimpleNamespace(inversions=inversions + ([SimpleNamespace(timings=traced)] if traced else []))
    return Run(cell={}, workload={}, config={}, seed=0, setup_s=0.0, window=window, inversions=inversions,
               arrays={}, trace=trace_)


@pytest.mark.parametrize("metric", ["outputs_s", "forward_data_s", "operator_s", "capture_warmup_s"])
def test_span_readers_take_the_mean_and_nothing_from_a_program_without_the_span(metric):
    read = load_metric(metric)
    assert read(_run([{metric: 0.25}, {metric: 0.75}])) == pytest.approx(0.5)
    assert read(_run([{"total_s": 1.0}, {"total_s": 2.0}])) is None


def test_host_reads_per_iter_divides_the_reads_by_the_iterations():
    read = load_metric("host_reads_per_iter")
    each = [{"host_reads": 203, "lsqr_iters": [100, 100]}, {"host_reads": 104, "lsqr_iters": [50, 50]}]
    assert read(_run(each)) == pytest.approx(307 / 300)
    assert read(_run([{"lsqr_iters": [100]}, {"lsqr_iters": [100]}])) is None


def test_solve_idle_pct_counts_the_idle_time_inside_the_solve_ranges():
    """Device busy [100, 220] and [600, 700] (two overlapping operations
    merged); solve ranges [100, 400] and [500, 800]: 120 of 300 and 100 of
    300 busy, so 380 of 600 idle."""
    t = Trace(window=(0, 1000),
              device_ops=[("k", 100, 50, None), ("k", 120, 100, None), ("k", 600, 100, None), ("k", 900, 50, None)],
              cpu_events=[("tomofastx.solve", 100, 400), ("tomofastx.solve", 500, 800),
                          ("tomofastx.outputs", 850, 990), ("aten::mm", 120, 130)])
    read = load_metric("solve_idle_pct")
    assert read(_run(trace_=t)) == pytest.approx(100.0 * 380 / 600)
    assert read(_run(trace_=Trace(window=(0, 1000), device_ops=t.device_ops, cpu_events=[]))) is None
    assert read(_run()) is None


def test_blocks_dispatch_ms_is_the_block_ranges_over_the_traced_iterations():
    """3 + 4 + 5 ms in block ranges (a range of another name left out) over
    the traced inversion's 10 + 20 LSQR iterations."""
    t = Trace(window=(0, 100 * MS), device_ops=[],
              cpu_events=[("tomofastx.block.admm.matvec", 0, 3 * MS),
                          ("tomofastx.block.clustering.rmatvec", 5 * MS, 9 * MS),
                          ("tomofastx.block.cross_gradient.matvec", 10 * MS, 15 * MS),
                          ("tomofastx.sensit.matvec", 20 * MS, 40 * MS)])
    read = load_metric("blocks_dispatch_ms")
    untraced = [{"lsqr_iters": [1]}, {"lsqr_iters": [1]}]
    assert read(_run(untraced, t, traced={"lsqr_iters": [10, 20]})) == pytest.approx(12.0 / 30)
    # No traced inversion completed, or no block ranges: nothing to read.
    assert read(_run(untraced, t)) is None
    assert read(_run(untraced, Trace(window=t.window, device_ops=[], cpu_events=t.cpu_events[3:]),
                     traced={"lsqr_iters": [10]})) is None
