"""Port parity of the BTTB FFT operator on the CPU (ops/bttb.py): detection
and the factory's choice on the JAX package's positive and fallback
geometries (tests/test_bttb.py), the offset table, matvec and rmatvec for
every physics family in float64 and float32, layer blocking, the mesh
placement and a matrix-free workflow run on a gridded survey, each against
the JAX package on the same seeded numpy inputs."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tomofastx_tpu.config.parfile import parse_parfile_lines as jparse
from tomofastx_tpu.inversion.workflow import solve_problem_joint_gravmag as jsolve
from tomofastx_tpu.models.data import SurveyData as JSurveyData
from tomofastx_tpu.ops import bttb as jbttb
from tomofastx_tpu.ops.matrixfree import _Physics as JPhysics
from tomofastx_tpu.ops.matrixfree import make_matrixfree_kernel as jmake

from tomofastx_tpu_torch.config.parfile import GravParams as TGravParams
from tomofastx_tpu_torch.config.parfile import MagParams as TMagParams
from tomofastx_tpu_torch.config.parfile import parse_parfile_lines as tparse
from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag as tsolve
from tomofastx_tpu_torch.models.data import SurveyData as TSurveyData
from tomofastx_tpu_torch.models.grid import Grid as TGrid
from tomofastx_tpu_torch.ops import bttb as tbttb
from tomofastx_tpu_torch.ops.matrixfree import _Physics as TPhysics
from tomofastx_tpu_torch.ops.matrixfree import make_matrixfree_kernel as tmake
from tomofastx_tpu_torch.parallel import mesh as tmesh

from test_bttb import CASES, _problem, make_data, make_grid
from test_torch_matrixfree import _hold_workflows, _run_both_workflows
from test_torch_workflow import _write_problem


def port_grid(g):
    return TGrid(nx=g.nx, ny=g.ny, nz=g.nz, X1=g.X1, X2=g.X2, Y1=g.Y1, Y2=g.Y2, Z1=g.Z1, Z2=g.Z2)


def port_data(d):
    t = TSurveyData(ndata=d.ndata, ncomponents=d.ncomponents)
    t.X, t.Y, t.Z, t.weight = np.asarray(d.X), np.asarray(d.Y), np.asarray(d.Z), np.asarray(d.weight)
    return t


def port_params(par):
    P = TMagParams if type(par).__name__ == "MagParams" else TGravParams
    names = {f.name for f in dataclasses.fields(P)}
    return P(**{k: v for k, v in vars(par).items() if k in names})


def operators(case, dtype, nz=4, **kw):
    """The JAX and port operators of a family on test_bttb's strided,
    shuffled, offset survey over a grid of layers thickening downward."""
    rng = np.random.default_rng(0)
    g = make_grid(6, 5, nz)
    d = make_data(4, 3, 2, 1, 100.0, 80.0, 37.0, -11.0, -3.3)
    par, ndc = _problem(case, 6, 5, nz, d.ndata)
    d.ncomponents = ndc
    d.weight = 1.0 + rng.random((d.ndata, ndc))
    cw = 1.0 + rng.random(6 * 5 * nz)
    jdt, tdt = (jnp.float64, torch.float64) if dtype == "f64" else (jnp.float32, torch.float32)
    jo = jmake(par, g, d, cw, 1.7, d.weight, jdt, validate=False, **kw)
    to = tmake(port_params(par), port_grid(g), port_data(d), cw, 1.7, d.weight, tdt, validate=False, device="cpu",
               **kw)
    return jo, to, rng


def products(jo, to, rng, dtype):
    nd = to.nrows * to.ndc if hasattr(to, "ndc") else to.nrows * to.phys.ndc
    x, u = rng.normal(size=to.ncols), rng.normal(size=nd)
    jdt, tdt = (jnp.float64, torch.float64) if dtype == "f64" else (jnp.float32, torch.float32)
    j = (np.asarray(jo.matvec(jnp.asarray(x, jdt)), np.float64), np.asarray(jo.rmatvec(jnp.asarray(u, jdt)), np.float64))
    t = (to.matvec(torch.as_tensor(x, dtype=tdt)).double().numpy(), to.rmatvec(torch.as_tensor(u, dtype=tdt)).double().numpy())
    return x, u, j, t


@pytest.mark.parametrize("case", CASES)
def test_bttb_matches_jax_f64(case):
    """float64 matvec and rmatvec to 1e-10 of max|y|, and the adjoint pair
    consistent to 1e-12."""
    jo, to, rng = operators(case, "f64")
    assert isinstance(jo, jbttb.BTTBKernel) and isinstance(to, tbttb.BTTBKernel)
    assert (to.Py, to.Px) == (jo.Py, jo.Px) and to.Tf.dtype == torch.complex128
    x, u, (yj, gj), (yt, gt) = products(jo, to, rng, "f64")
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-10 * np.abs(yj).max())
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-10 * np.abs(gj).max())
    assert abs(yt @ u - x @ gt) <= 1e-12 * np.linalg.norm(yt) * np.linalg.norm(u)


@pytest.mark.parametrize("case", CASES)
def test_bttb_f32_as_accurate_as_jax(case):
    """float32 (complex64 spectrum): no further from the JAX package's
    float64 products than 1.5x its own float32 error."""
    j64, _, _ = operators(case, "f64")
    j32, t32, rng = operators(case, "f32")
    assert t32.Tf.dtype == torch.complex64
    x, u, a, b = products(j32, t32, rng, "f32")
    ref = (np.asarray(j64.matvec(jnp.asarray(x))), np.asarray(j64.rmatvec(jnp.asarray(u))))
    for r, ja, tb in zip(ref, a, b):
        err_jax, err_port = (np.linalg.norm(v - r) / np.linalg.norm(r) for v in (ja, tb))
        assert err_port <= 1.5 * err_jax, (err_port, err_jax)


@pytest.mark.parametrize("case", ["grav_gz", "grav_ftg", "mag_vec"])
def test_offset_table_matches_jax(case):
    """build_offset_table in float64 to 1e-12 of its largest entry."""
    g = make_grid(6, 5, 4)
    d = make_data(4, 3, 2, 1, 100.0, 80.0, 37.0, -11.0, -3.3)
    par, _ = _problem(case, 6, 5, 4, d.ndata)
    geom = jbttb.detect_bttb(g, d, nmc=par.nmodel_components, ndc=par.ndata_components)
    mag = case.startswith("mag")
    phys = dict(problem="magn" if mag else "grav", data_type=2 if case == "grav_ftg" else 1,
                nmc=par.nmodel_components, ndc=par.ndata_components,
                magv=(0.3, 0.2, 0.93) if mag else (0.0, 0.0, 1.0), intensity=5e4 if mag else 0.0, handle_inside=False)
    want = jbttb.build_offset_table(JPhysics(**phys), geom, 6, 5, 4)
    got = tbttb.build_offset_table(TPhysics(**phys), tbttb.detect_bttb(port_grid(g), port_data(d), nmc=phys["nmc"],
                                                                      ndc=phys["ndc"]), 6, 5, 4, device="cpu")
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


def _geometries():
    """(name, grid, data, detect_bttb keywords) of the JAX package's
    detection tests (tests/test_bttb.py:134-240), positive and fallback."""
    g = make_grid(6, 5, 4)
    base = dict(no_x=4, no_y=3, mx=1, my=1, hx=100.0, hy=80.0, ox=37.0, oy=-11.0, zd=-3.3)

    def data_with(**over):
        kw = dict(base, **over)
        return make_data(kw["no_x"], kw["no_y"], kw["mx"], kw["my"], kw["hx"], kw["hy"], kw["ox"], kw["oy"], kw["zd"])

    out = [
        ("single row", g, make_data(5, 1, 1, 1, 100.0, 80.0, 0.0, 40.0, -2.0), {}),
        ("coarse strides", g, make_data(3, 2, 2, 3, 100.0, 80.0, 50.0, 40.0, -2.0), {}),
        ("below the volume", g, make_data(3, 2, 1, 1, 100.0, 80.0, 50.0, 40.0, 1.0e5), {}),
        ("control", g, data_with(), {}),
        ("table at its cap", g, data_with(), {"max_table_bytes": 4 * 8 * 5 * 8}),
        ("table over its cap", g, data_with(), {"max_table_bytes": 4 * 8 * 5 * 8 - 1}),
        ("components over the cap", g, data_with(), {"nmc": 3, "ndc": 3, "max_table_bytes": 4 * 8 * 5 * 8}),
        ("components at the cap", g, data_with(), {"nmc": 3, "ndc": 3, "max_table_bytes": 9 * 4 * 8 * 5 * 8}),
        ("inside the volume's z-range", g, data_with(zd=100.0), {}),
        ("incommensurate spacing", g, data_with(hx=137.0), {}),
    ]
    d = data_with()
    d.X = d.X + np.random.default_rng(1).normal(0, 1.0, d.ndata)
    out.append(("scattered", g, d, {}))
    d = data_with()
    d.Z[0] = -5.0
    out.append(("two heights", g, d, {}))
    d = data_with()
    d.X, d.Y, d.Z, d.ndata = d.X[1:], d.Y[1:], d.Z[1:], d.ndata - 1
    out.append(("missing point", g, d, {}))
    d = data_with()
    d.X[1], d.Y[1] = d.X[0], d.Y[0]
    out.append(("duplicate point", g, d, {}))
    xe = np.array([0.0, 100.0, 250.0, 350.0, 450.0, 550.0, 650.0])
    i, j, k = np.tile(np.arange(6), 20), np.tile(np.repeat(np.arange(5), 6), 4), np.repeat(np.arange(4), 30)
    g2 = type(g)(nx=6, ny=5, nz=4, X1=xe[i], X2=xe[i + 1], Y1=j * 80.0, Y2=(j + 1) * 80.0, Z1=k * 50.0,
                 Z2=(k + 1) * 50.0)
    out.append(("non-uniform x spacing", g2, data_with(), {}))
    g3 = make_grid(6, 5, 4)
    g3.X1 = g3.X1.copy()
    g3.X1[7] += 1.0
    out.append(("irregular grid", g3, data_with(), {}))
    rng = np.random.default_rng(2)
    d = JSurveyData(ndata=7, ncomponents=1)
    d.X, d.Y, d.Z = rng.uniform(0, 600, 7), rng.uniform(0, 400, 7), np.full(7, -1.0)
    out.append(("scattered on a lattice grid", g, d, {}))
    return out


GEOMS = _geometries()


@pytest.mark.parametrize("index", range(len(GEOMS)), ids=[name for name, *_ in GEOMS])
def test_detection_and_factory_pick_what_jax_picks(index):
    """detect_bttb accepts or declines as the JAX package does, with the
    same geometry when it accepts; the factory builds the same class."""
    name, g, d, kw = GEOMS[index]
    want = jbttb.detect_bttb(g, d, **kw)
    got = tbttb.detect_bttb(port_grid(g), port_data(d), **kw)
    assert (got is None) == (want is None), name
    if want is not None:
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert (np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b), (name, f.name)
    if not kw:
        par, _ = _problem("grav_gz", g.nx, g.ny, g.nz, d.ndata)
        cw = np.ones(g.nelements_total)
        jo = jmake(par, g, d, cw, 1.0, np.ones((d.ndata, 1)), jnp.float64, validate=False)
        to = tmake(port_params(par), port_grid(g), port_data(d), cw, 1.0, np.ones((d.ndata, 1)), torch.float64,
                   validate=False, device="cpu")
        assert type(to).__name__ == type(jo).__name__, name


def test_layer_blocked_equals_unblocked():
    """layer_block 2 and 4 against the unblocked operator (nz = 8):
    float64 to 1e-14 of max|y|."""
    _, op, rng = operators("mag_vec", "f64", nz=8)
    x = torch.as_tensor(rng.normal(size=op.ncols))
    u = torch.as_tensor(rng.normal(size=op.nrows * op.ndc))
    assert op.layer_block is None
    for blk in (2, 4):
        opb = dataclasses.replace(op, layer_block=blk)
        for f, v in (("matvec", x), ("rmatvec", u)):
            a, b = getattr(op, f)(v), getattr(opb, f)(v)
            torch.testing.assert_close(b, a, rtol=0, atol=1e-14 * float(a.abs().max()))


@pytest.mark.parametrize("slots", [1, 2, 3, 4])
def test_shard_kernel_matches_the_unmeshed_operator(slots):
    """Over 2 and 4 CPU slots the table is split by layers (nz = 8), over 3
    it is replicated; the products equal the unmeshed ones to 1e-13 of
    max|y|, and over one slot to the last bit."""
    _, op, rng = operators("grav_ftg", "f64", nz=8)
    ops = tmesh.shard_kernel(op, tmesh.make_mesh(slots, device="cpu"))
    assert ops.layered == (8 % slots == 0) and len(ops.parts) == slots
    assert sum(p.nz for p in ops.parts) == (8 if ops.layered else 8 * slots)
    x = torch.as_tensor(rng.normal(size=op.ncols))
    u = torch.as_tensor(rng.normal(size=op.nrows * op.ndc))
    for f, v in (("matvec", x), ("rmatvec", u)):
        a, b = getattr(op, f)(v), getattr(ops, f)(v)
        if slots == 1:
            assert torch.equal(a, b)
        torch.testing.assert_close(b, a, rtol=0, atol=1e-13 * float(a.abs().max()))


def test_bttb_workflow_matches_jax(tmp_path, capsys):
    """tpu.kernelFormat = matrixfree on a gridded survey (every cell centre
    of an 8 x 8 lattice observed at one height) through
    solve_problem_joint_gravmag of both packages, float64: both logs name
    BTTBKernel; costs.txt rows rtol 1e-8, model to 1e-8 of its range; and
    the port's --mesh 1 run equal to its unmeshed run to the last bit."""
    lines = _write_problem(str(tmp_path), 8, 8, 4, 64, wtype=0, fmt="matrixfree", niter=6)
    rj, rt, jout, tout, said_j, said_t = _run_both_workflows(tmp_path, lines, capsys)
    for said in (said_j, said_t):
        assert "grav kernel: matrix-free (BTTBKernel, no row storage" in said
    _hold_workflows(rj, rt, jout, tout)
    meshed = tsolve(tparse(lines(str(tmp_path / "mesh1"))), solve_dtype=torch.float64, verbose=False, device="cpu",
                    mesh=tmesh.make_mesh(1, device="cpu"))
    assert np.array_equal(meshed.models[0].val, rt.models[0].val)
    with open(os.path.join(tout, "costs.txt"), "rb") as a, open(tmp_path / "mesh1" / "costs.txt", "rb") as b:
        assert a.read() == b.read()
