"""The program's `operator_s` span (the matrix-free operator's making, its
near lists and stored near rows in it, ended with the device synchronised),
mean per inversion of the window."""


def read(run):
    t = [inv.timings["operator_s"] for inv in run.inversions if "operator_s" in inv.timings]
    return sum(t) / len(t) if t else None
