"""The comparison that decides `correct`: every inversion of the window against
the reference's inversion of the same Parfile and inputs.

Each number is the worst over the window's inversions and the active
problems:

- `synthetic`: the data of the true model (the program's observed data),
  max |d - d_ref| / max |d_ref|: the operator, its build, depth weighting and
  compression;
- `data`: the final model's data as the program reports them, against the
  reference's kernel applied to the program's final model, over max |d_ref|:
  the operator at the solve's answer and the model update that made it;
- `misfit`: the program's final model's misfit to the reference's synthetic
  data through the reference's kernel, ||S m - d_ref|| / ||d_ref||: LSQR,
  ADMM, the constraints and the model update, judged by what they are for;
- `misfit_ratio`: that misfit over the reference's own final misfit, which
  takes out how hard the seed's model is to fit;
- `constraint_costs`: the constraint costs of the first CONSTRAINT_MAJORS
  majors as the program writes them to costs.txt (ADMM, damping gradient,
  cross-gradient, clustering: its columns 6-7 and 10-20), against the
  reference's own, major by major: the worst |c - c_ref| / |c_ref| (0 where
  both are 0). The constraint blocks of the timed path, each at the model of
  its major: a block left out reads 1, one weighed w' for w reads
  |w'^2 / w^2 - 1|;
- one number for each constraint the Parfile switches on (`cross_gradient`,
  `damping_gradient`, `clustering`, `admm`): what the constraint is for,
  measured on the program's final models (reference/costs.py), over the
  same measured on the reference's final models, less 1, the worst problem.
  A constraint that shapes the answer leaves its cost higher where it is
  dropped. On the configurations so far none does: a constraint switched
  off reads within the program's own readings (PERF.md section 4), so these
  are printed for the look and held by no workload.

A workload names the numbers it holds and their limits (`checks`); every
number is printed beside its limit, or beside none where it is not held.
"""

from __future__ import annotations

import os

import numpy as np


def _rel_max(a, b, scale):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / scale) if scale > 0 else float("inf")


# The constraint columns of costs.txt (0-based), in the reference's
# CONSTRAINT_COLUMNS order.
COSTS_TXT_COLUMNS = [5, 6] + list(range(9, 20))
# The majors whose constraint costs are compared: the first two, whose models
# the float32 and float64 solves still share closely (the first major's
# costs are those of the starting model).
CONSTRAINT_MAJORS = 2


def constraint_costs_of(inv):
    """Each major's constraint costs (majors, 13) from the inversion's costs.txt
    (a row of 20 columns a major; the last line, the final costs, is shorter)."""
    if inv.constraint_history is not None:
        return inv.constraint_history
    with open(os.path.join(inv.out_dir, "costs.txt")) as f:
        rows = [line.split() for line in f if not line.startswith("#")]
    return np.array([[float(r[c]) for c in COSTS_TXT_COLUMNS] for r in rows if len(r) == 20]).reshape(-1, 13)


def constraint_gaps(costs, ref_costs):
    """Each major's worst |c - c_ref| / |c_ref| (0 where both are 0); inf
    where the majors differ in number."""
    if costs.shape != ref_costs.shape:
        return np.full(max(len(costs), len(ref_costs), 1), np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        gap = np.abs(costs - ref_costs) / np.abs(ref_costs)
    return np.max(np.where((costs == 0.0) & (ref_costs == 0.0), 0.0, gap), axis=1)


def numbers(inversions, ref):
    """The comparison's numbers (name -> worst value) of `inversions` against
    the reference's result `ref` (reference.inversion.invert)."""
    ref_costs = ref["costs"](ref["model"])
    out = {"synthetic": 0.0, "data": 0.0, "misfit": 0.0, "misfit_ratio": 0.0, "constraint_costs": 0.0}
    out.update({k.split(".")[0]: -float("inf") for k in ref_costs})
    if not inversions:
        return {k: float("inf") for k in out}
    for inv in inversions:
        gap = float(np.max(constraint_gaps(constraint_costs_of(inv), ref["constraint_history"])[:CONSTRAINT_MAJORS]))
        out["constraint_costs"] = max(out["constraint_costs"], gap) if np.isfinite(gap) else float("inf")
        for k, c in ref["costs"](inv.model).items():
            v = (c - ref_costs[k]) / ref_costs[k] if ref_costs[k] > 0 else (0.0 if c == 0 else float("inf"))
            k = k.split(".")[0]
            out[k] = max(out[k], v) if np.isfinite(v) else float("inf")
        for i, d_ref in ref["synthetic"].items():
            scale = float(np.max(np.abs(d_ref)))
            through_ref = ref["forward"](i, inv.model[i])
            misfit = float(np.linalg.norm(through_ref - d_ref) / np.linalg.norm(d_ref))
            ref_misfit = float(np.linalg.norm(ref["data"][i] - d_ref) / np.linalg.norm(d_ref))
            values = {
                "synthetic": _rel_max(inv.synthetic[i], d_ref, scale),
                "data": _rel_max(inv.data[i], through_ref, scale),
                "misfit": misfit,
                "misfit_ratio": misfit / ref_misfit if ref_misfit > 0 else float("inf"),
            }
            for k, v in values.items():
                out[k] = max(out[k], v) if np.isfinite(v) else float("inf")
    return out


def judge(values, limits):
    """(correct, held): each number beside its limit; correct when every
    held number is finite and at most its limit."""
    held = {k: (v, limits.get(k)) for k, v in values.items()}
    correct = all(np.isfinite(v) and v <= lim for v, lim in held.values() if lim is not None)
    return correct, held
