"""Host milliseconds inside the traced inversion's `tomofastx.block.*`
ranges (each constraint block's share of the system's products, launched
from the host) over that inversion's LSQR iterations. The profiler's own
cost a launch is in it: it compares traced runs with traced runs."""

PREFIX = "tomofastx.block."


def read(run):
    # The traced inversion is the window's last, where it completed.
    if run.trace is None or len(run.window.inversions) <= len(run.inversions):
        return None
    iters = sum(run.window.inversions[-1].timings.get("lsqr_iters", []))
    ns = sum(e - s for name, s, e in run.trace.cpu_events if name.startswith(PREFIX))
    return ns * 1e-6 / iters if iters and ns else None
