"""The readings that a cell's limits are set from, on the chip, in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 ... [--control-seeds 3] [--fault-seeds 3]
        [--out FILE]

For each seed it writes the cell's inputs, runs one inversion through the
window's own entry (window.Cell, after one warm-up), the reference in
float64, and prints the comparison's numbers (check.py). On the first
`--control-seeds` seeds it also runs the control and prints its numbers
against the same reference: the cell's precision a step lower. For a
stored kernel the program's own bfloat16 path is the control
(`tpu.kernelStoreDtype = bfloat16`, the kernel held in bfloat16, each
product summed in float32); for the matrix-free operator, which has no such
path, the reference put in the program's place and computed in bfloat16,
its kernel and its solve. On the first `--fault-seeds` seeds it runs the
program once more for each constraint the Parfile switches on, with that
constraint switched off (FAULTS), against the same reference. The
benchmark's own runs do not run these.
Each seed's line is JSON; the last line sums them up: the largest reading
of the program, the smallest of the control and of each fault, per number.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from portbench import check
from portbench.reference import inversion as reference
from portbench.run import load_json
from portbench.window import Cell, Inversion

BF16_LINE = "tpu.kernelStoreDtype = bfloat16"
# Planted faults: the program run with one constraint switched off, each
# read where the cell's Parfile switches that constraint on.
FAULTS = {
    "cross_gradient": ["inversion.crossGradient.weight = 0"],
    "damping_gradient": ["inversion.dampingGradient.grav.weight = 0", "inversion.dampingGradient.magn.weight = 0"],
    "clustering": ["inversion.clustering.grav.weight = 0", "inversion.clustering.magn.weight = 0"],
    "admm": ["inversion.admm.enableADMM = 0"],
}


def as_inversion(r):
    """A reference result in the shape of a window's inversion."""
    return Inversion(timings={}, synthetic=r["synthetic"], model=r["model"], data=r["data"],
                     cost_history=r["cost_history"], constraint_history=r["constraint_history"])


def model_gap(inv, ref):
    """||m - m_ref|| / ||m_ref|| of the final models, the worst problem: not
    compared (it does not separate the control), read for the look."""
    return max(float(np.linalg.norm(inv.model[i] - m) / np.linalg.norm(m)) for i, m in ref["model"].items())


def major_gaps(inv, ref):
    """Each major's worst constraint-cost gap (check.constraint_gaps), for the look."""
    return [float(g) for g in check.constraint_gaps(check.constraint_costs_of(inv), ref["constraint_history"])]


def stored(config):
    return not any("kernelFormat = matrixfree" in line for line in config["parfile"])


def solve_with(cell, tag, lines):
    """The program's inversion of the cell's Parfile with `lines` appended
    (a later line sets its key anew)."""
    with open(cell.parfile) as f:
        text = f.read()
    path = cell.parfile.replace(".txt", f"_{tag}.txt")
    with open(path, "w") as f:
        f.write(text + "".join(line + "\n" for line in lines))
    return cell.solve(path)


def control(cell, config, device):
    """The control's inversion of the cell's Parfile and inputs."""
    if stored(config):
        return solve_with(cell, "bf16", [BF16_LINE])
    return as_inversion(reference.invert(cell.parfile, cell.arrays, device=device, solve_dtype=torch.bfloat16,
                                         store_dtype=torch.bfloat16, mixture=config.get("mixture")))


def readings(config, workload, seeds, control_seeds, device, emit, fault_seeds=0):
    """Each seed's numbers of the program (and of the control on the first
    `control_seeds`, of each planted fault on the first `fault_seeds`),
    emitted as they come; returns the summary line."""
    program_max, control_min, fault_min = {}, {}, {}
    warmed = False
    for n, seed in enumerate(seeds):
        work = tempfile.mkdtemp(prefix="portbench-calibrate-")
        try:
            cell = Cell(work, config, workload, seed, device)
            try:
                if not warmed:
                    cell.warm_up()
                    warmed = True
                t0 = time.time()
                inv = cell.solve()
                t1 = time.time()
                ref = reference.invert(cell.parfile, cell.arrays, device=device, mixture=config.get("mixture"))
                t2 = time.time()
                by_major = {"program": major_gaps(inv, ref)}
                line = {"seed": seed, "program": check.numbers([inv], ref), "program_model": model_gap(inv, ref),
                        "constraint_gaps_by_major": by_major,
                        "constraint_costs": [ref["costs"](inv.model), ref["costs"](ref["model"])],
                        "program_s": t1 - t0,
                        "reference_s": t2 - t1, "lsqr_iters": [inv.timings.get("lsqr_iters"), ref["lsqr_iters"]],
                        "costs": [inv.cost_history, ref["cost_history"]]}
                for k, v in line["program"].items():
                    program_max[k] = max(program_max.get(k, 0.0), v)
                if n < control_seeds:
                    t3 = time.time()
                    ctl = control(cell, config, device)
                    line["control"] = check.numbers([ctl], ref)
                    by_major["control"] = major_gaps(ctl, ref)
                    line["control_model"] = model_gap(ctl, ref)
                    line["control_s"] = time.time() - t3
                    line["control_costs"] = ctl.cost_history
                    for k, v in line["control"].items():
                        control_min[k] = min(control_min.get(k, float("inf")), v)
                if n < fault_seeds:
                    line["faults"] = {}
                    for name, lines in FAULTS.items():
                        if name in line["program"]:
                            broken = solve_with(cell, name, lines)
                            line["faults"][name] = check.numbers([broken], ref)
                            by_major[name] = major_gaps(broken, ref)
                            fault_min[name] = {k: min(fault_min.get(name, {}).get(k, float("inf")), v)
                                               for k, v in line["faults"][name].items()}
            finally:
                cell.close()
            del ref
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
            emit(line)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return {"workload": workload["name"], "seeds": list(seeds), "program_max": program_max,
            "control_min": control_min, "fault_min": fault_min,
            "ratio": {k: control_min[k] / program_max[k] for k in control_min if program_max.get(k)}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--fault-seeds", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None, help="also append each line to this file")
    args = parser.parse_args(argv)
    workload = load_json("workloads", args.workload)
    config = load_json("configs", workload["config"])
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    emit(readings(config, workload, args.seeds, args.control_seeds, args.device, emit, args.fault_seeds))
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
