"""The solve's blocking reads of the device (the program's `host_reads`
counter: LSQR's exit and misfit tests, each major's or fused chunk's copy
of its results to the host) over its LSQR iterations, summed over the
window's inversions."""


def read(run):
    counted = [inv.timings for inv in run.inversions if "host_reads" in inv.timings]
    iters = sum(sum(t.get("lsqr_iters", [])) for t in counted)
    return sum(t["host_reads"] for t in counted) / iters if iters else None
