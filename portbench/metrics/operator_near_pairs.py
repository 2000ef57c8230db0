"""The program's `operator_near_pairs` counter (the observation-cell pairs
that the blended lattice operator's near pass evaluates by the float64
closed forms; counted where the operator is made), mean per inversion of
the window. A count of the survey's geometry that explains the operator's
cost, not a target. A program without the counter reports nothing."""


def read(run):
    n = [inv.timings["operator_near_pairs"] for inv in run.inversions if "operator_near_pairs" in inv.timings]
    return sum(n) / len(n) if n else None
