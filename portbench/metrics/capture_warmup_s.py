"""The program's `capture_warmup_s` span (the eager warm-up step on the side
stream before the fused major's capture, part of `capture_s`), mean per
inversion of the window."""


def read(run):
    t = [inv.timings["capture_warmup_s"] for inv in run.inversions if "capture_warmup_s" in inv.timings]
    return sum(t) / len(t) if t else None
