"""The program's `forward_data_s` span (every forward product for the data
of a model, copied to the host: the synthetic, prior and starting data and
each host-driven major's new data), mean per inversion of the window."""


def read(run):
    t = [inv.timings["forward_data_s"] for inv in run.inversions if "forward_data_s" in inv.timings]
    return sum(t) / len(t) if t else None
