"""What the program's spans leave of an inversion, mean per inversion:
total_s - read_inputs_s - build_s - sum(solve_s): the depth weight, the
synthetic data, the costs and the outputs."""


def read(run):
    rest = [t["total_s"] - t.get("read_inputs_s", 0.0) - t.get("build_s", 0.0) - sum(t.get("solve_s", []))
            for t in (inv.timings for inv in run.inversions) if "total_s" in t]
    return sum(rest) / len(rest) if rest else None
