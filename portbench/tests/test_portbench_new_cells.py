"""The fused draped g_z cell and the draped TMI cell at a tiny size on the CPU
(the harness's look for a card skipped: run_cell on device "cpu"): the
program as it is comes out correct; each fault of the timed path, and ADMM
switched off, come out not correct; the control, a precision lower, fails
the cell's limits; a traced run reports the per-layer metrics that list the
cell. And the TMI roofline's pair count against a count pair by pair."""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from portbench import calibrate, run, yardstick
from portbench.tests.conftest import REPO, cell, shrink
from portbench.tests.test_portbench_faults import FAULTS, constraint_off

CELLS = ("draped_lattice.fused", "draped_tmi.host")
# The per-layer metrics that list each cell, and those of them that read
# nothing on the CPU: the fused loop runs eagerly there, so its capture reads
# nothing, and a device trace has no card to read.
LISTED = {"draped_lattice.fused": {"lsqr_iter_ms", "host_reads_per_iter", "capture_s"},
          "draped_tmi.host": {"mag_lattice_op_roofline_pct", "operator_near_pairs"}}
CARD_ONLY = {"capture_s", "mag_lattice_op_roofline_pct"}


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


@pytest.mark.parametrize("name", CELLS)
def test_admm_left_out_is_not_correct(tiny_root, monkeypatch, name):
    root, b = tiny_root
    constraint_off(monkeypatch, "admm")
    r = run.run_cell(str(root), b, cell(b, name), 3, 0.1, 0, device="cpu")
    assert not r["correct"] and r["checks"]["constraint_costs"]["value"] == 1.0, json.dumps(r["checks"])


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(name):
    workload = run.load_json("workloads", name)
    config = shrink(run.load_json("configs", workload["config"]))
    lines = []
    summary = calibrate.readings(config, workload, [5], 1, "cpu", lines.append)
    held = {k: v for k, v in workload["checks"].items() if v is not None}
    assert set(held) == {"synthetic", "data", "misfit", "constraint_costs"}
    assert any(lines[0]["control"][k] > lim for k, lim in held.items()), json.dumps(summary)
    assert all(lines[0]["program"][k] <= lim for k, lim in held.items()), json.dumps(summary)


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_the_cells_per_layer_metrics(tiny_root, name):
    """The per-layer metrics whose `workloads` name the cell are each on the
    result line of a traced run, but for those left to the card
    (CARD_ONLY)."""
    root, b = tiny_root
    listed = {m["name"] for m in b["per_layer"] if name in m.get("workloads", [])}
    assert listed == LISTED[name]
    r = run.run_cell(str(root), b, cell(b, name), 3, 0.1, 1, device="cpu")
    assert r["correct"] and listed - CARD_ONLY <= set(r["metrics"]), json.dumps(r["metrics"])


def pairs_one_by_one(edges, points, radius):
    """(near, window, far) counted pair by pair: a cell is in an observation's
    window where, on every axis, its centre is among the W centres from the
    first within radius x the largest half-diagonal below the observation
    (W the most centres any interval of twice that length holds, the start
    moved back to keep W inside the lattice); near where its centre lies
    within NEAR_RADIUS of its own half-diagonals."""
    xe, ye, ze = (np.asarray(e, np.float64) for e in edges)
    D = radius * np.sqrt(sum(np.max(0.5 * np.diff(e)) ** 2 for e in (xe, ye, ze))) * (1.0 + 1.0e-5)
    axes = []
    for e in (xe, ye, ze):
        c, h = 0.5 * (e[:-1] + e[1:]), 0.5 * np.diff(e)
        W = max(sum(1 for b in c if a <= b <= a + 2.0 * D) for a in c)
        axes.append((c, h, W))
    near = window = far = 0
    for t in zip(*points):
        inside = []
        for (c, h, W), tt in zip(axes, t):
            lo = next((k for k in range(c.size) if c[k] >= tt - D), c.size)
            lo = min(lo, c.size - W)
            inside.append((np.arange(c.size) >= lo) & (np.arange(c.size) < lo + W))
        for k in range(axes[2][0].size):
            for j in range(axes[1][0].size):
                for i in range(axes[0][0].size):
                    if not (inside[0][i] and inside[1][j] and inside[2][k]):
                        far += 1
                        continue
                    r2 = sum((axes[a][0][n] - t[a]) ** 2 for a, n in enumerate((i, j, k)))
                    d2 = sum(axes[a][1][n] ** 2 for a, n in enumerate((i, j, k)))
                    if r2 <= yardstick.NEAR_RADIUS**2 * d2:
                        near += 1
                    else:
                        window += 1
    return near, window, far


@pytest.mark.parametrize("size", [(16, 16, 8), (40, 12, 6)])
def test_tmi_pairs_counted_pair_by_pair(size):
    """The TMI roofline's (near, window, far) on the TMI configuration's
    draped survey over a small lattice: as counted pair by pair at the
    tensor tier-2 radius, and the window the port's own TMI operator takes."""
    from tomofastx_tpu_torch.config.parfile import MagParams
    from tomofastx_tpu_torch.models.data import SurveyData
    from tomofastx_tpu_torch.models.grid import Grid
    from tomofastx_tpu_torch.ops.matrixfree import make_matrixfree_kernel

    from portbench import traffic

    spec = importlib.util.spec_from_file_location(
        "mag_lattice_op_roofline_pct", os.path.join(REPO, "portbench", "metrics", "mag_lattice_op_roofline_pct.py"))
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    config = shrink(run.load_json("configs", "magn_draped_lattice_262k"))
    config["grid"]["size"] = list(size)
    config["survey"]["side"] = size[0] // 2
    edges, points = traffic.grid_edges(config), traffic.survey_points(config)
    got = metric.tmi_pairs(edges, points)
    assert got == pairs_one_by_one(edges, points, 16.0)
    assert sum(got) == points[0].size * int(np.prod(size)) and got[0] > 0
    t = traffic.grid_table(config)
    grid = Grid(nx=size[0], ny=size[1], nz=size[2], X1=t[:, 0], X2=t[:, 1], Y1=t[:, 2], Y2=t[:, 3], Z1=t[:, 4],
                Z2=t[:, 5])
    data = SurveyData(ndata=points[0].size, ncomponents=1)
    data.X, data.Y, data.Z = points
    par = MagParams(nx=size[0], ny=size[1], nz=size[2], ndata=points[0].size, mi=60.0, md=10.0, intensity=50000.0)
    op = make_matrixfree_kernel(par, grid, data, np.ones(grid.nelements_total), 1.0, np.ones((points[0].size, 1)),
                                torch.float32, validate=False, force_no_fft=True, device="cpu")
    assert points[0].size * int(np.prod(op.win)) == got[0] + got[1]
