"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have (one card: no exchange between chips to
leave out) and once for each constraint the cell's Parfile switches on, left
out of the program; a run of the program as it is comes out correct; the
control, a precision lower, fails the cell's limits too. Tiny sizes on the
CPU, the harness's look for a card skipped (run_cell on device "cpu")."""

from __future__ import annotations

import functools
import json

import pytest
import torch

from portbench import calibrate, run
from portbench.tests.conftest import cell, shrink

CELLS = ("draped_lattice.host", "joint_coupled.fused", "joint_coupled.host")


def unchanged_state(monkeypatch):
    """Each major's solve returns no update: the model stays where it began."""
    from tomofastx_tpu_torch.inversion import joint

    solve = joint.lsqr_solve

    def no_update(*args, **kwargs):
        res = solve(*args, **kwargs)
        return res._replace(x=torch.zeros_like(res.x))

    monkeypatch.setattr(joint, "lsqr_solve", no_update)


def half_the_data_left_out(monkeypatch):
    """The operators see the first half of the observations only."""
    from tomofastx_tpu_torch.ops import matrixfree, sparse_kernel

    for cls in (matrixfree.LatticeMatrixFreeKernel, sparse_kernel.DenseKernel):
        matvec, rmatvec = cls.matvec, cls.rmatvec

        def half_matvec(self, x, _f=matvec):
            y = _f(self, x).clone()
            y[y.shape[0] // 2 :] = 0
            return y

        def half_rmatvec(self, u, _f=rmatvec):
            u = u.clone()
            u[u.shape[0] // 2 :] = 0
            return _f(self, u)

        monkeypatch.setattr(cls, "matvec", half_matvec)
        monkeypatch.setattr(cls, "rmatvec", half_rmatvec)


def answer_altered(monkeypatch):
    """Every datum the program computes comes out 1e-4 of itself off."""
    from tomofastx_tpu_torch.inversion import workflow

    calculate = workflow.sens.calculate_data

    @functools.wraps(calculate)
    def altered(*args, **kwargs):
        return calculate(*args, **kwargs) * (1.0 + 1e-4)

    monkeypatch.setattr(workflow.sens, "calculate_data", altered)


FAULTS = {"unchanged_state": unchanged_state, "half_the_data_left_out": half_the_data_left_out,
          "answer_altered": answer_altered}

# Each constraint a cell's Parfile switches on, switched off in the program.
CONSTRAINTS = [(name, constraint) for name in CELLS for constraint in calibrate.FAULTS
               if name.startswith("joint") or constraint == "admm"]


def constraint_off(monkeypatch, constraint):
    """The program reads its Parfile with the constraint's weight set to 0
    (calibrate.FAULTS' lines appended): the reference reads it as it is."""
    from tomofastx_tpu_torch.config import parfile

    def read_without(path, *args, **kwargs):
        with open(path) as f:
            lines = f.readlines()
        return parfile.parse_parfile_lines(lines + [line + "\n" for line in calibrate.FAULTS[constraint]])

    monkeypatch.setattr(parfile, "read_parfile", read_without)


@pytest.mark.parametrize("name", CELLS)
def test_the_program_as_it_is_is_correct(tiny_root, name):
    root, b = tiny_root
    r = run.run_cell(str(root), b, cell(b, name), 3, 0.1, 0, device="cpu")
    assert r["correct"], json.dumps(r["checks"])


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, name, fault):
    root, b = tiny_root
    FAULTS[fault](monkeypatch)
    r = run.run_cell(str(root), b, cell(b, name), 3, 0.1, 0, device="cpu")
    assert not r["correct"], json.dumps(r["checks"])


@pytest.mark.parametrize("name,constraint", CONSTRAINTS)
def test_a_constraint_left_out_is_not_correct(tiny_root, monkeypatch, name, constraint):
    root, b = tiny_root
    constraint_off(monkeypatch, constraint)
    r = run.run_cell(str(root), b, cell(b, name), 3, 0.1, 0, device="cpu")
    assert not r["correct"], json.dumps(r["checks"])


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(name):
    workload = run.load_json("workloads", name)
    config = shrink(run.load_json("configs", workload["config"]))
    lines = []
    summary = calibrate.readings(config, workload, [5], 1, "cpu", lines.append)
    held = {k: v for k, v in workload["checks"].items() if v is not None}
    assert held and any(lines[0]["control"][k] > lim for k, lim in held.items()), json.dumps(summary)
    assert all(lines[0]["program"][k] <= lim for k, lim in held.items()), json.dumps(summary)
