"""The share of the traced window (one whole host-driven inversion, traced
after the measured window) in which no operation runs on the card: the
complement of the union of the device trace's operation intervals. Not read
in a fused cell, whose traced inversion stops where its fused loop starts."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
