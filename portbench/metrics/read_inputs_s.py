"""The program's `read_inputs_s` span (grid and survey read), mean per
inversion of the window."""


def read(run):
    t = [inv.timings["read_inputs_s"] for inv in run.inversions if "read_inputs_s" in inv.timings]
    return sum(t) / len(t) if t else None
