"""Set-up and the measured window of one cell: a closed loop of one user
who runs whole inversions back to back.

Set-up writes the cell's inputs from the seed, then runs a short warm-up
inversion of the cell's own Parfile (the workload's `warmup` majors and LSQR
iterations), which builds the program's libraries (once in a checkout) and
warms every shape the window uses. The window starts inversions while its
elapsed time is under the run's seconds and ends when the last one
finishes. Each inversion is what `python -m tomofastx_tpu_torch -p Parfile`
runs on the card: the Parfile read, its parameters printed, the Parfile
copied into an output folder of the inversion's own, and
`solve_problem_joint_gravmag` called with the arguments the CLI passes for
`--device cuda` (and `--fused N` where the workload says so). The program's
own log goes to a file beside the outputs.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import traffic


@dataclass
class Inversion:
    """What one inversion of the window produced, for the comparison and the
    per-layer metrics."""

    timings: dict
    synthetic: dict  # problem -> (ndata * ndc,) the data of the true model
    model: dict  # problem -> (N,) the final model
    data: dict  # problem -> (ndata * ndc,) the final model's data
    cost_history: list  # [[grav, magn] post-update data cost of each major]
    out_dir: str = ""  # the outputs the inversion wrote, costs.txt among them
    constraint_history: object = None  # (majors, 13) where not read from costs.txt


@dataclass
class Window:
    seconds: float = 0.0
    attempted: int = 0
    failed: int = 0
    inversions: list = field(default_factory=list)
    each_s: list = field(default_factory=list)  # wall seconds of each inversion
    errors: list = field(default_factory=list)
    peak_bytes: int = 0


def solve_once(parfile, out_dir, fused, device, log):
    """One inversion, as the CLI runs it, into `out_dir`."""
    from tomofastx_tpu_torch.config.parfile import config_summary, read_parfile
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag

    cfg = read_parfile(parfile)
    cfg.path_output = out_dir.rstrip("/") + "/"
    with contextlib.redirect_stdout(log):
        print(config_summary(cfg))
        os.makedirs(cfg.path_output, exist_ok=True)
        shutil.copy(parfile, os.path.join(cfg.path_output, "Parfile_run.txt"))
        solve_dtype = torch.float64 if torch.device(device).type == "cpu" else torch.float32
        res = solve_problem_joint_gravmag(
            cfg, base_dir=".", solve_dtype=solve_dtype, compute_dtype=torch.float64, verbose=True,
            device=torch.device(device), mesh=None, near_field_f64=0, resume=False, debug_nans=False,
            fused_chunk=fused,
        )
        print("THE END.")
    return Inversion(
        timings=dict(res.timings),
        synthetic={i: np.asarray(d.val_meas, np.float64).reshape(-1) for i, d in res.data.items()},
        model={i: np.asarray(m.val[0], np.float64).copy() for i, m in res.models.items()},
        data={i: np.asarray(d.val_calc, np.float64).reshape(-1) for i, d in res.data.items()},
        cost_history=[list(h["cost_data"]) for h in res.costs_history],
        out_dir=cfg.path_output,
    )


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Cell:
    """One cell's inputs and Parfiles in a work folder, and its inversions."""

    def __init__(self, work, config, workload, seed, device):
        self.work, self.config, self.workload, self.device = work, config, workload, device
        self.files, self.arrays = traffic.write_inputs(os.path.join(work, "inputs"), config, seed)
        inv = config["inversion"]
        self.parfile = traffic.write_parfile(os.path.join(work, "Parfile.txt"), config, self.files,
                                             os.path.join(work, "output"), inv["majors"], inv["minors"])
        warm = workload["warmup"]
        self.warmup_parfile = traffic.write_parfile(os.path.join(work, "Parfile_warmup.txt"), config, self.files,
                                                    os.path.join(work, "warmup"), warm["majors"], warm["minors"])
        self.log = open(os.path.join(work, "program.log"), "w")
        self.count = 0

    def close(self):
        self.log.close()

    def solve(self, parfile=None):
        self.count += 1
        out = os.path.join(self.work, f"inversion_{self.count:03d}")
        return solve_once(parfile or self.parfile, out, int(self.workload.get("fused", 0)), self.device, self.log)

    def warm_up(self):
        self.solve(self.warmup_parfile)
        sync(self.device)

    def attempt(self, w, solve):
        """One inversion of the window by `solve`, counted in w; False where it
        failed (raised, or gave a missing or non-finite cost)."""
        w.attempted += 1
        t0 = time.perf_counter()
        try:
            inv = solve()
            costs = np.asarray(inv.cost_history, np.float64)
            if costs.size == 0 or not np.all(np.isfinite(costs)):
                raise FloatingPointError(f"non-finite or missing data costs: {inv.cost_history}")
        except Exception:  # a failed inversion is counted, reported, and ends the window
            w.failed += 1
            w.errors.append(traceback.format_exc())
            print(w.errors[-1], file=sys.stderr)
            return False
        w.inversions.append(inv)
        w.each_s.append(time.perf_counter() - t0)
        return True

    def window(self, seconds):
        """Inversions back to back while the elapsed time is under `seconds`."""
        w = Window()
        if torch.device(self.device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds and self.attempt(w, self.solve):
            pass
        sync(self.device)
        w.seconds = time.perf_counter() - t0
        if torch.device(self.device).type == "cuda":
            w.peak_bytes = torch.cuda.max_memory_allocated()
        return w
