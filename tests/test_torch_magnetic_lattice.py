"""The port's corner-lattice operator on TMI surveys, held on the CPU against
the benchmark's plain reference (portbench/reference/: float64 PyTorch,
dense kernels, nothing of the program) and the JAX package: its products
against the reference's closed-form rows, a magnetic-only matrix-free
inversion against the reference's inversion and the JAX package's, and the
counters of the blend's near and 27-point pairs against the operator's own
near pairs and windows."""

import contextlib
import io
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tomofastx_tpu.config.parfile import read_parfile as jread
from tomofastx_tpu.inversion.workflow import solve_problem_joint_gravmag as jsolve
from tomofastx_tpu_torch.config.parfile import GravParams, MagParams
from tomofastx_tpu_torch.config.parfile import read_parfile
from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag
from tomofastx_tpu_torch.models.data import SurveyData
from tomofastx_tpu_torch.models.grid import Grid
from tomofastx_tpu_torch.ops.matrixfree import LatticeMatrixFreeKernel, make_matrixfree_kernel
from tomofastx_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench import check, traffic  # noqa: E402
from portbench.reference import inversion as reference  # noqa: E402
from portbench.reference import physics  # noqa: E402
from portbench.reference.parfile import MAGN  # noqa: E402
from portbench.run import load_json  # noqa: E402
from portbench.tests.conftest import shrink  # noqa: E402

# The inducing field of Tomofast-x's 2-body example (55,000 nT, inclination
# -60, declination 2).
FIELD = dict(mi=-60.0, md=2.0, theta=0.0, intensity=55000.0)
# The surveys, laid out by the benchmark's generator: the 2-body example's
# (50 m cells, a station above every column 5 m over the top, flat) and one
# draped 80-110 m over cells of 100 x 80 x 50 m, a station above every fifth
# column.
SURVEYS = {"2-body": ((50.0, 50.0, 50.0), 1, 5.0, 0.0), "draped": ((100.0, 80.0, 50.0), 5, 80.0, 30.0)}
# JAX's bound for its blended float32 operators against float64, a product
# (tests/test_matrixfree.py, chip_smoke.py's PRODUCT_BLEND_RTOL), held by the
# g_z products of kernel B3's blend: the 8- and 27-point rules' error where
# they take over from the closed forms, which float32 rounding stays far
# below.
PRODUCT_BLEND_RTOL = 5e-5


def survey(size, name):
    """Survey `name` (SURVEYS) over a lattice of `size` cells, laid out by the
    benchmark's generator (portbench/traffic.py): (grid, edges, points)."""
    cell_m, every, height, drape = SURVEYS[name]
    config = {"grid": {"size": list(size), "cell_m": list(cell_m)},
              "survey": {"side": size[0] // every, "height_m": height, "drape_m": drape}}
    t = traffic.grid_table(config)
    grid = Grid(nx=size[0], ny=size[1], nz=size[2], X1=t[:, 0], X2=t[:, 1], Y1=t[:, 2], Y2=t[:, 3], Z1=t[:, 4],
                Z2=t[:, 5])
    return grid, traffic.grid_edges(config), traffic.survey_points(config)


def port_operator(case, grid, points, dtype, cw, dw):
    X, Y, Z = points
    kw = dict(nx=grid.nx, ny=grid.ny, nz=grid.nz, ndata=X.size)
    par = MagParams(**kw, **FIELD) if case == "TMI" else GravParams(**kw)
    data = SurveyData(ndata=X.size, ncomponents=1)
    data.X, data.Y, data.Z = X, Y, Z
    return make_matrixfree_kernel(par, grid, data, cw, 1.0, dw, dtype, validate=False, force_no_fft=True,
                                  device="cpu")


def reference_rows(case, edges, points):
    """(ndata, N) float64 rows of the reference's corner-lattice closed forms."""
    xe, ye, ze = (torch.as_tensor(e, dtype=torch.float64) for e in edges)
    x, y, z = (torch.as_tensor(a, dtype=torch.float64) for a in points)
    magv = physics.dircos(FIELD["mi"], FIELD["md"], FIELD["theta"])
    problem = "magn" if case == "TMI" else "grav"
    rows = physics._lattice_closed_rows(xe, ye, ze, x, y, z, problem, 1, magv, FIELD["intensity"], 1, 1)
    return rows.reshape(x.shape[0], -1)


@pytest.mark.parametrize("name", sorted(SURVEYS))
@pytest.mark.parametrize("case", ["TMI", "g_z"])
@pytest.mark.parametrize("dtype", ["float64", "float32 blend"])
def test_lattice_operator_against_the_reference_rows(case, dtype, name):
    """matvec and rmatvec (column and row weights in) against the
    reference's dense float64 rows on a 40 x 12 x 6 lattice, long enough in x
    for every tier of the blend: the float64 closed forms to 1e-10 of
    max|y|, the float32 blend within PRODUCT_BLEND_RTOL in norm."""
    grid, edges, points = survey((40, 12, 6), name)
    rng = np.random.default_rng(7)
    cw, dw = 1.0 + rng.random(grid.nelements_total), 1.0 + rng.random((points[0].size, 1))
    dt = torch.float64 if dtype == "float64" else torch.float32
    op = port_operator(case, grid, points, dt, cw, dw)
    assert isinstance(op, LatticeMatrixFreeKernel) and op.far_quad == (dt == torch.float32)
    if op.far_quad:  # the 8-point rule, the 27-point rule and the closed forms each take some pairs
        assert 0 < op.near_cells.shape[0] and np.prod(op.win) < grid.nelements_total
    S = reference_rows(case, edges, points).numpy()
    x, u = rng.normal(size=S.shape[1]), rng.normal(size=S.shape[0])
    want = (dw[:, 0] * (S @ (cw * x)), cw * (S.T @ (dw[:, 0] * u)))
    got = (op.matvec(torch.as_tensor(x, dtype=dt)).double().numpy(),
           op.rmatvec(torch.as_tensor(u, dtype=dt)).double().numpy())
    for g, w in zip(got, want):
        if dt == torch.float64:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-10 * np.abs(w).max())
        else:
            assert np.linalg.norm(g - w) / np.linalg.norm(w) <= PRODUCT_BLEND_RTOL


# A magnetic-only matrix-free problem on a 16 x 16 x 8 lattice under 64
# stations of the draped survey (draped, so that it takes the lattice
# operator and not the FFT's): two blocks of 0.05 and 0.02 SI, power-3
# distance weighting, ADMM on 3 lithologies, problem weights 0 / 1.
TMI_PROBLEM = {
    "grid": {"size": [16, 16, 8], "cell_m": [100.0, 80.0, 50.0]},
    "survey": {"side": 8, "height_m": 80.0, "drape_m": 30.0},
    "model": {"blocks": [{"size": [4, 4, 3], "density": 0.0, "susceptibility": 0.05},
                         {"size": [6, 6, 4], "density": 0.0, "susceptibility": 0.02}],
              "susceptibility_per_density": 0.0},
    "parfile": [
        "global.outputFolderPath = {output}/",
        "modelGrid.size = 16 16 8",
        "modelGrid.magn.file = {grid}",
        "forward.data.magn.nData = 64",
        "forward.data.magn.dataGridFile = {data}",
        "forward.data.magn.useSyntheticModelForDataValues = 1",
        "forward.data.magn.syntheticModelFile = {synth_mag}",
        f"forward.magneticField.inclination = {FIELD['mi']}",
        f"forward.magneticField.declination = {FIELD['md']}",
        f"forward.magneticField.intensity_nT = {FIELD['intensity']}",
        "forward.depthWeighting.type = 2",
        "forward.depthWeighting.magn.power = 3",
        "forward.matrixCompression.type = 0",
        "sensit.readFromFiles = 0",
        "inversion.nMajorIterations = {majors}",
        "inversion.nMinorIterations = {minors}",
        "inversion.joint.grav.problemWeight = 0",
        "inversion.joint.magn.problemWeight = 1",
        "inversion.modelDamping.magn.weight = 1.d-8",
        "inversion.admm.enableADMM = 1",
        "inversion.admm.nLithologies = 3",
        "inversion.admm.magn.bounds = -0.002 0.002 0.018 0.022 0.048 0.052",
        "inversion.admm.magn.weight = 1.d-2",
        "tpu.kernelFormat = matrixfree",
        "tpu.sensitWriteCache = 0",
    ],
}


@pytest.fixture(scope="module")
def tmi_run(tmp_path_factory):
    """TMI_PROBLEM, 2 majors x 10 LSQR iterations: the port's inversion on the
    CPU in float64, the reference's, and the JAX package's (float64, its own
    output folder)."""
    work = str(tmp_path_factory.mktemp("tmi"))
    files, arrays = traffic.write_inputs(os.path.join(work, "inputs"), TMI_PROBLEM, 12345)
    results, said = {}, {}
    for name, read, solve, kw in (("port", read_parfile, solve_problem_joint_gravmag,
                                   dict(solve_dtype=torch.float64, device="cpu")),
                                  ("jax", jread, jsolve, dict(solve_dtype=jnp.float64, compute_dtype=jnp.float64))):
        parfile = traffic.write_parfile(os.path.join(work, f"Parfile_{name}.txt"), TMI_PROBLEM, files,
                                        os.path.join(work, f"{name}_out"), 2, 10)
        cfg = read(parfile)
        said[name] = io.StringIO()
        with contextlib.redirect_stdout(said[name]):
            results[name] = solve(cfg, verbose=name == "port", **kw)
        results[name].out_dir = cfg.path_output
    # The port's log names the operator it built: the lattice operator, not the FFT's.
    assert "mag kernel: matrix-free (LatticeMatrixFreeKernel" in said["port"].getvalue()
    return results["port"], reference.invert(parfile, arrays, device="cpu"), results["jax"]


def _costs_txt(out_dir):
    with open(os.path.join(out_dir, "costs.txt")) as f:
        return [np.array(line.split(), float) for line in f if not line.startswith("#")]


def test_magnetic_inversion_against_the_reference(tmi_run):
    """The magnetic problem alone, gravity inactive, on the lattice operator:
    synthetic data, final model and its data to 1e-9 of their largest, each
    major's data cost to 1e-8, and each major's constraint costs in
    costs.txt (ADMM on the susceptibility; the others 0) to 1e-8 of the
    reference's."""
    res, ref, _ = tmi_run
    assert res.timings["operator_s"] > 0 and set(res.models) == set(ref["model"]) == {MAGN}
    for got, want in ((res.data[MAGN].val_meas, ref["synthetic"][MAGN]), (res.models[MAGN].val[0], ref["model"][MAGN]),
                      (res.data[MAGN].val_calc, ref["data"][MAGN])):
        got = np.asarray(got, np.float64).reshape(-1)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())
    costs = np.array([h["cost_data"] for h in res.costs_history])
    np.testing.assert_allclose(costs, np.array(ref["cost_history"]), rtol=1e-8, atol=0)
    assert costs[:, 0].max() == 0.0 and costs[-1, 1] < costs[0, 1]
    written = check.constraint_costs_of(SimpleNamespace(constraint_history=None, out_dir=res.out_dir))
    assert written.shape == ref["constraint_history"].shape and ref["constraint_history"][-1, 1] > 0.0
    assert np.max(check.constraint_gaps(written, ref["constraint_history"])) <= 1e-8


def test_magnetic_inversion_against_the_jax_package(tmi_run):
    """The same Parfile through the JAX package's workflow, float64, held as
    the matrix-free workflows' parity holds it (tests/
    test_torch_matrixfree.py::_hold_workflows): every costs.txt row to rtol
    1e-8, the final susceptibility to 1e-8 of its range, its data rtol 1e-8;
    the synthetic data to 1e-9 of their largest."""
    res, _, jres = tmi_run
    assert set(jres.models) == set(res.models) == {MAGN}
    cj, ct = _costs_txt(jres.out_dir), _costs_txt(res.out_dir)
    assert len(cj) == len(ct) == 3 and ct[-1][2] < ct[0][2]
    for a, b in zip(cj, ct):
        np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-300)
    mj, mt = np.asarray(jres.models[MAGN].val), np.asarray(res.models[MAGN].val)
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-8 * (mj.max() - mj.min()))
    np.testing.assert_allclose(np.asarray(res.data[MAGN].val_calc), np.asarray(jres.data[MAGN].val_calc), rtol=1e-8)
    want = np.asarray(jres.data[MAGN].val_meas, np.float64)
    np.testing.assert_allclose(np.asarray(res.data[MAGN].val_meas, np.float64), want, rtol=0,
                               atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("case", ["TMI", "g_z"])
def test_pair_counters_are_the_operators_near_pairs_and_windows(case):
    """Making a blended lattice operator counts the pairs its near pass
    evaluates (operator_near_pairs: the near lists' candidates that the near
    mask keeps) and its windows' other pairs (operator_window_pairs), the
    observations' own; a float64 operator, which has no blend, counts none."""
    grid, _, points = survey((40, 12, 6), "draped")
    n = points[0].size
    cw, dw = np.ones(grid.nelements_total), np.ones((n, 1))
    trace.counters.clear()
    op = port_operator(case, grid, points, torch.float32, cw, dw)
    kept, candidates = op._near_pairs_plain()[0].shape[0], op.near_cells.shape[0]
    assert int(op.near_ptr[n]) == candidates and 0.9 * candidates <= kept < candidates
    assert trace.counters == {"operator_near_pairs": kept, "operator_window_pairs": n * int(np.prod(op.win)) - kept}
    trace.counters.clear()
    port_operator(case, grid, points, torch.float64, cw, dw)
    assert trace.counters == {}


def test_pair_counters_land_on_the_timings(tmp_path):
    """A float32 inversion of the cut TMI configuration on the CPU (the
    blended operator's plain loop) carries both counters on its timings,
    those of its one operator."""
    config = shrink(load_json("configs", "magn_draped_lattice_262k"), majors=1, minors=2)
    files, _ = traffic.write_inputs(str(tmp_path / "inputs"), config, 3)
    parfile = traffic.write_parfile(str(tmp_path / "Parfile.txt"), config, files, str(tmp_path / "out"), 1, 2)
    t = solve_problem_joint_gravmag(read_parfile(parfile), solve_dtype=torch.float32, verbose=False,
                                    device="cpu").timings
    assert t["operator_near_pairs"] > 0 and t["operator_window_pairs"] > 0
    assert t["operator_near_pairs"] + t["operator_window_pairs"] <= 64 * 16 * 16 * 8
