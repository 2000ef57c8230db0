"""Milliseconds an LSQR iteration: the window's solve seconds, less the
fused loop's capture, over its LSQR iterations (the program's spans)."""


def read(run):
    solve = capture = iters = 0.0
    for inv in run.inversions:
        solve += sum(inv.timings.get("solve_s", []))
        capture += inv.timings.get("capture_s", 0.0)
        iters += sum(inv.timings.get("lsqr_iters", []))
    return (solve - capture) / iters * 1e3 if iters else None
