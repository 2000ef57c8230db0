"""The program's `capture_s` span (the fused major's CUDA graph captured,
its warm-up step in), mean per inversion."""


def read(run):
    t = [inv.timings["capture_s"] for inv in run.inversions if "capture_s" in inv.timings]
    return sum(t) / len(t) if t else None
