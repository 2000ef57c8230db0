"""The program's `build_s` span (the stored kernels' build, both problems),
mean per inversion."""


def read(run):
    t = [inv.timings["build_s"] for inv in run.inversions if "build_s" in inv.timings]
    return sum(t) / len(t) if t else None
