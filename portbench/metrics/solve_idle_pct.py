"""The share of the traced inversion's `tomofastx.solve` ranges (the
program's majors, each from its residuals to its results on the host) in
which no operation runs on the card: the device idle time that the solve
itself leaves, where `device_idle_pct` also counts the depth weight, the
operator's making, the data and the outputs. Not read in a fused cell, whose
traced inversion stops where its fused loop starts."""

SOLVE = "tomofastx.solve"


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.trace.window
    ranges = [(max(s, lo), min(e, hi)) for name, s, e in run.trace.cpu_events if name == SOLVE and e > lo and s < hi]
    total = sum(e - s for s, e in ranges)
    if total <= 0:
        return None
    busy = sum(max(0, min(be, e) - max(bs, s)) for bs, be in run.trace.busy_intervals() for s, e in ranges)
    return 100.0 * (1.0 - busy / total)
