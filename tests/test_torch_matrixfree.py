"""Port parity of the matrix-free slice on the CPU: the far-field
quadrature, the blended rows, the per-cell and corner-lattice operators
(ops/matrixfree.py), their mesh placement, and matrix-free workflow runs,
each against the JAX package on the same seeded numpy inputs. The BTTB
operator has its own file (tests/test_torch_bttb.py)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tomofastx_tpu.config.parfile import GravParams as JGravParams
from tomofastx_tpu.config.parfile import MagParams as JMagParams
from tomofastx_tpu.config.parfile import parse_parfile_lines as jparse
from tomofastx_tpu.inversion.workflow import solve_problem_joint_gravmag as jsolve
from tomofastx_tpu.models.data import SurveyData as JSurveyData
from tomofastx_tpu.models.grid import Grid as JGrid
from tomofastx_tpu.ops import matrixfree as jmf
from tomofastx_tpu.ops import prism as jprism
from tomofastx_tpu.ops import sensitivity as jsens

from tomofastx_tpu_torch.config.parfile import GravParams as TGravParams
from tomofastx_tpu_torch.config.parfile import MagParams as TMagParams
from tomofastx_tpu_torch.config.parfile import parse_parfile_lines as tparse
from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag as tsolve
from tomofastx_tpu_torch.models.data import SurveyData as TSurveyData
from tomofastx_tpu_torch.models.grid import Grid as TGrid
from tomofastx_tpu_torch.ops import matrixfree as tmf
from tomofastx_tpu_torch.ops import prism as tprism
from tomofastx_tpu_torch.ops import sensitivity as tsens
from tomofastx_tpu_torch.parallel import mesh as tmesh

from test_torch_workflow import _costs, _write_problem
from util_fixtures import write_data_grid_file, write_values_file

FAMILIES = ["grav_gz", "grav_zz", "grav_ftg", "mag_tmi", "mag_3c", "mag_vec"]
BOUNDS = ("X1", "X2", "Y1", "Y2", "Z1", "Z2")


def grid_dict(nx, ny, nz, hx=100.0, hy=80.0, topography=False):
    """A tensor-product grid with layers thickening downward; with
    topography the top layer's upper faces follow a surface per column, so
    the grid is no lattice."""
    i = np.tile(np.arange(nx), ny * nz)
    j = np.tile(np.repeat(np.arange(ny), nx), nz)
    k = np.repeat(np.arange(nz), nx * ny)
    z1 = 50.0 * k + 5.0 * k * (k - 1)
    g = dict(nx=nx, ny=ny, nz=nz, X1=i * hx, X2=(i + 1) * hx, Y1=j * hy, Y2=(j + 1) * hy, Z1=z1, Z2=z1 + 50.0 + 10.0 * k)
    if topography:
        top = k == 0
        g["Z1"] = g["Z1"].copy()
        g["Z1"][top] -= 5.0 + 4.0 * np.sin(0.7 * i[top] + 1.3 * j[top])
    return g


def problem(case, g, X, Y, Z, seed=0):
    """(JAX params, port params, JAX data, port data, cw, data weights) of a
    physics family on grid g with observations X, Y, Z."""
    nd = len(X)
    if case.startswith("grav"):
        ndc = {"grav_gz": 1, "grav_zz": 1, "grav_ftg": 6}[case]
        kw = dict(data_type=1 if case == "grav_gz" else 2, ndata_components=ndc)
        P = (JGravParams, TGravParams)
    else:
        ndc = 3 if case == "mag_3c" else 1
        kw = dict(nmodel_components=3 if case == "mag_vec" else 1, ndata_components=ndc,
                  mi=55.0, md=12.0, theta=3.0, intensity=50000.0)
        P = (JMagParams, TMagParams)
    kw.update(nx=g["nx"], ny=g["ny"], nz=g["nz"], ndata=nd)
    rng = np.random.default_rng(seed)
    out = [P[0](**kw), P[1](**kw)]
    for D in (JSurveyData, TSurveyData):
        d = D(ndata=nd, ncomponents=ndc)
        d.X, d.Y, d.Z = np.asarray(X, float), np.asarray(Y, float), np.asarray(Z, float)
        out.append(d)
    return (*out, 1.0 + rng.random(g["nx"] * g["ny"] * g["nz"]), 1.0 + rng.random((nd, ndc)))


def scattered(g, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(g["X1"].min(), g["X2"].max(), n), rng.uniform(g["Y1"].min(), g["Y2"].max(), n),
            -rng.uniform(1.0, 30.0, n))


def both_operators(case, g, X, Y, Z, dtype, **kw):
    jp, tp, jd, td, cw, w = problem(case, g, X, Y, Z)
    jdt, tdt = (jnp.float64, torch.float64) if dtype == "f64" else (jnp.float32, torch.float32)
    jo = jmf.make_matrixfree_kernel(jp, JGrid(**g), jd, cw, 1.7, w, jdt, validate=False, **kw)
    to = tmf.make_matrixfree_kernel(tp, TGrid(**g), td, cw, 1.7, w, tdt, validate=False, device="cpu", **kw)
    return jo, to


def products(op, x, u, torch_op):
    if torch_op:
        dt = op.xd.dtype if hasattr(op, "xd") else op.cw.dtype
        return (op.matvec(torch.as_tensor(x, dtype=dt)).double().numpy(),
                op.rmatvec(torch.as_tensor(u, dtype=dt)).double().numpy())
    dt = op.cw.dtype
    return (np.asarray(op.matvec(jnp.asarray(x, dt)), np.float64), np.asarray(op.rmatvec(jnp.asarray(u, dt)), np.float64))


# ---------------------------------------------------------------- quadrature

QUAD = {
    "gravi_z_quad": 1, "gradi_zz_quad": 1, "gradi_full_quad": 6, "magnetic_tensor_quad": 9,
}


def _flat(out):
    """A quadrature function's result as a list of arrays (the magnetic
    tensor's 3 x 3 rows flattened)."""
    if not isinstance(out, (tuple, list)):
        return [np.asarray(out)]
    return [np.asarray(c) for o in out for c in (o if isinstance(o, (tuple, list)) else [o])]


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("name", list(QUAD))
def test_quadrature_matches_jax(name, order):
    """Each quadrature family at both orders, float64, to 1e-12 of the
    largest entry, for points near and far from the cells."""
    g = grid_dict(5, 4, 3)
    X, Y, Z = scattered(g, 4, 3)
    b = [g[k] for k in BOUNDS]
    got = _flat(getattr(tprism, name)(*(torch.as_tensor(a)[:, None] for a in (X, Y, Z)),
                                      *(torch.as_tensor(a) for a in b), order=order))
    assert len(got) == QUAD[name]
    for p in range(len(X)):
        want = _flat(getattr(jprism, name)(X[p], Y[p], Z[p], *(jnp.asarray(a) for a in b), order=order))
        for gc, wc in zip(got, want):
            np.testing.assert_allclose(gc[p], wc, rtol=0, atol=1e-12 * np.abs(wc).max())


@pytest.mark.parametrize("order", [0, 1, 4])
def test_quadrature_of_another_order_raises(order):
    """The JAX package takes any order but 3 as the 2-point rule; the port
    raises (an intended divergence, PERF.md)."""
    one = torch.ones(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="only orders 2 and 3"):
        tprism.gravi_z_quad(0.0, 0.0, -1.0, 0 * one, one, 0 * one, one, 0 * one, one, order=order)
    # The JAX package's own behaviour, which the port does not copy.
    b = [jnp.asarray(a) for a in (np.zeros(3), np.ones(3)) * 3]
    np.testing.assert_array_equal(jprism.gravi_z_quad(0.0, 0.0, -1.0, *b, order=order),
                                  jprism.gravi_z_quad(0.0, 0.0, -1.0, *b, order=2))


@pytest.mark.parametrize("radius", [None, 1.5, 6.0])
def test_far_mask_matches_jax(radius):
    g = grid_dict(24, 20, 4)
    X, Y, Z = scattered(g, 5, 4)
    b = [g[k] for k in BOUNDS]
    got = tprism.far_mask(*(torch.as_tensor(a)[:, None] for a in (X, Y, Z)), *(torch.as_tensor(a) for a in b),
                          radius=radius).numpy()
    for p in range(len(X)):
        want = np.asarray(jprism.far_mask(X[p], Y[p], Z[p], *(jnp.asarray(a) for a in b), radius=radius))
        np.testing.assert_array_equal(got[p], want)
    assert 0 < got.sum() < got.size


@pytest.mark.parametrize("case", FAMILIES)
def test_forward_rows_far_quad_matches_jax(case):
    """forward_rows(far_quad=True): closed forms near, 27-point quadrature
    beyond FAR_QUAD_RADIUS half-diagonals; float64, 1e-11 of the largest
    entry (a grid long enough for both kinds of cell)."""
    g = grid_dict(24, 3, 3)
    X, Y, Z = scattered(dict(g, X2=g["X2"] / 6), 3, 5)  # points over the near end
    jp, tp, *_ = problem(case, g, X, Y, Z)
    ph = (jp.nmodel_components, jp.ndata_components)
    mag = case.startswith("mag")
    magv = jprism.dircos(55.0, 12.0, 3.0) if mag else (0.0, 0.0, 1.0)
    args = ("magn" if mag else "grav", 1 if case in ("grav_gz",) or mag else 2, *ph, magv, 50000.0 if mag else 0.0, False)
    got = tsens.forward_rows(*args, tuple(torch.as_tensor(g[k]) for k in BOUNDS),
                             *(torch.as_tensor(a) for a in (X, Y, Z)), far_quad=True).numpy()
    for p in range(len(X)):
        want = np.asarray(jsens.forward_rows(*args, tuple(jnp.asarray(g[k]) for k in BOUNDS), X[p], Y[p], Z[p],
                                             far_quad=True))
        np.testing.assert_allclose(got[p], want, rtol=0, atol=1e-11 * np.abs(want).max())
        far = np.asarray(jprism.far_mask(X[p], Y[p], Z[p], *(jnp.asarray(g[k]) for k in BOUNDS)))
        assert 0 < far.sum() < far.size


# ------------------------------------------------------------ the operators

GEOMETRIES = {
    # (grid, force_no_fft) per operator class
    "lattice": (dict(), True, "LatticeMatrixFreeKernel"),
    "generic": (dict(topography=True), False, "MatrixFreeKernel"),
}


@pytest.mark.parametrize("case", FAMILIES)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_operator_matches_jax_f64(geometry, case):
    """matvec and rmatvec of the per-cell and lattice operators, float64
    (no blend), to 1e-10 of max|y|; the same class as the JAX package."""
    gkw, no_fft, cls = GEOMETRIES[geometry]
    g = grid_dict(6, 5, 4, **gkw)
    X, Y, Z = scattered(g, 7, 1)
    jo, to = both_operators(case, g, X, Y, Z, "f64", force_no_fft=no_fft)
    assert type(jo).__name__ == type(to).__name__ == cls
    rng = np.random.default_rng(2)
    x, u = rng.normal(size=to.ncols), rng.normal(size=to.nrows * (to.ndc if hasattr(to, "ndc") else to.phys.ndc))
    (yj, gj), (yt, gt) = products(jo, x, u, False), products(to, x, u, True)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-10 * np.abs(yj).max())
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-10 * np.abs(gj).max())


def test_tiered_blend_row_accuracy_outside_the_window():
    """The port's counterpart of the JAX package's bound
    (tests/test_matrixfree.py:1065): each full float32 row (8-point base +
    windowed correction) within 2e-5 of the float64 closed forms, also on
    cells far outside the tier-2 window, and 5x better than the raw float32
    closed rows."""
    nx, ny, nz = 96, 6, 4
    g = grid_dict(nx, ny, nz, hx=100.0, hy=130.0)
    g["Z1"], g["Z2"] = np.repeat(np.arange(nz), nx * ny) * 80.0, (np.repeat(np.arange(nz), nx * ny) + 1) * 80.0
    X, Y, Z = np.array([150.0, 250.0, 420.0]), np.full(3, 2.5 * 130.0), np.full(3, -1.0)
    _, tp, _, td, _, _ = problem("grav_gz", g, X, Y, Z)
    op = tmf.make_matrixfree_kernel(tp, TGrid(**g), td, np.ones(g["X1"].size), 1.0, np.ones((3, 1)),
                                    torch.float32, force_no_fft=True, validate=False, device="cpu")
    assert isinstance(op, tmf.LatticeMatrixFreeKernel) and op.far_quad and op.win[2] < nx // 2
    edges = [torch.as_tensor(np.arange(n + 1) * h) for n, h in ((nx, 100.0), (ny, 130.0), (nz, 80.0))]
    for p in range(3):
        row = op.rmatvec(torch.zeros(3).index_fill_(0, torch.tensor([p]), 1.0)).double().numpy()
        pt = [torch.tensor([v]) for v in (X[p], Y[p], Z[p])]
        args = ("grav", 1, (0.0, 0.0, 1.0), 0.0, 1, 1)
        ref = tmf._lattice_closed_rows(*edges, *pt, *args).numpy().reshape(-1)
        raw = tmf._lattice_closed_rows(op.xe, op.ye, op.ze, *(a.float() for a in pt), *args).double().numpy().reshape(-1)
        rel_blend = np.linalg.norm(row - ref) / np.linalg.norm(ref)
        rel_raw = np.linalg.norm(raw - ref) / np.linalg.norm(ref)
        assert rel_blend < 2e-5 and rel_blend < 0.2 * rel_raw, (rel_blend, rel_raw)


@pytest.mark.parametrize("spacing", ["uniform", "stretched"])
@pytest.mark.parametrize("problem_key", [("grav", 1), ("grav", 2), ("magn", 1)])
def test_lattice_near_window_equals_jax(spacing, problem_key):
    """Window sizes and starts equal exactly, at each tier-2 radius."""
    rng = np.random.default_rng(8)
    xe = np.arange(31) * 100.0
    if spacing == "stretched":
        xe = np.concatenate([[0.0], np.cumsum(100.0 * 1.05 ** np.arange(30))])
    ye, ze = np.arange(21) * 80.0, np.concatenate([[0.0], np.cumsum(50.0 + 10.0 * np.arange(12))])
    X, Y, Z = rng.uniform(-200, 3300, 40), rng.uniform(-200, 1800, 40), -rng.uniform(0, 50, 40)
    r = tmf.tier2_radius(*problem_key)
    assert r == jmf.tier2_radius(*problem_key)
    (wt, it), (wj, ij) = (m.lattice_near_window(xe, ye, ze, X, Y, Z, radius=r) for m in (tmf, jmf))
    assert wt == wj
    np.testing.assert_array_equal(it, ij)


def test_near_cell_indices_hold_every_near_cell():
    """K as in the JAX package, and each point's truly near cells are in the
    port's candidates and in the JAX package's (the order of ties at the
    K-th place may differ between top_k and torch.topk)."""
    g = grid_dict(9, 8, 5, topography=True)
    X, Y, Z = scattered(g, 11, 9)
    g6 = [g[k] for k in BOUNDS]
    got = tmf.near_cell_indices(tuple(torch.as_tensor(a) for a in g6), *(torch.as_tensor(a) for a in (X, Y, Z))).numpy()
    want = np.asarray(jmf.near_cell_indices(tuple(jnp.asarray(a) for a in g6), *(jnp.asarray(a) for a in (X, Y, Z))))
    assert got.shape == want.shape
    for p in range(len(X)):
        near = np.flatnonzero(~np.asarray(jprism.far_mask(X[p], Y[p], Z[p], *(jnp.asarray(a) for a in g6))))
        assert near.size and set(near) <= set(got[p]) and set(near) <= set(want[p])


def test_padded_cells_equal_unpadded():
    """pad_cells_to adds dummy cells with cw = 0: the products are those of
    the unpadded operator, float64 to 1e-13, and the patch's float32 too."""
    g = grid_dict(6, 5, 4, topography=True)
    X, Y, Z = scattered(g, 7, 1)
    for dt, tol in ((torch.float64, 1e-13), (torch.float32, 1e-6)):
        _, tp, _, td, cw, w = problem("grav_gz", g, X, Y, Z)
        ops = [tmf.make_matrixfree_kernel(tp, TGrid(**g), td, cw, 1.7, w, dt, pad_cells_to=p, device="cpu")
               for p in (1, 7)]
        assert ops[1].N == 126 and ops[1].ncols == ops[0].ncols == 120
        rng = np.random.default_rng(3)
        x, u = torch.as_tensor(rng.normal(size=120), dtype=dt), torch.as_tensor(rng.normal(size=7), dtype=dt)
        for f, v in (("matvec", x), ("rmatvec", u)):
            a, b = (getattr(o, f)(v) for o in ops)
            torch.testing.assert_close(b, a, rtol=0, atol=tol * float(a.abs().max()))


def test_probe_matvec_aborts_on_a_boundary_point():
    """An observation on a cell's corner makes the closed forms non-finite:
    the factory aborts with the reference's message, as the JAX one does."""
    g = grid_dict(4, 3, 2, topography=True)
    X, Y, Z = np.array([100.0, 150.0]), np.array([80.0, 90.0]), np.array([0.0, -10.0])
    jp, tp, jd, td, cw, w = problem("grav_gz", g, X, Y, Z)
    g["Z1"][:12] = 0.0  # the corner at (100, 80, 0) is a grid node
    for mod, par, d, dt, kw in ((jmf, jp, jd, jnp.float64, {}), (tmf, tp, td, torch.float64, {"device": "cpu"})):
        with pytest.raises(ValueError, match="Adjust the model grid"):
            mod.make_matrixfree_kernel(par, (JGrid if mod is jmf else TGrid)(**g), d, cw, 1.0, w, dt, **kw)


# ------------------------------------------------------------ the mesh

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_shard_kernel_matches_the_unmeshed_operator(geometry, dtype):
    """The per-cell operator cells-sharded over 7 slots and the lattice
    operator observation-sharded over 3 (re-padded, windows at the tier-2
    radius) give the unmeshed products, to 1e-12 (float64) or 1e-5
    (float32) of max|y|; over one slot they equal them to the last bit."""
    gkw, no_fft, cls = GEOMETRIES[geometry]
    g = grid_dict(6, 5, 4, **gkw)
    X, Y, Z = scattered(g, 11, 12)
    n = 7 if geometry == "generic" else 3
    _, tp, _, td, cw, w = problem("mag_tmi", g, X, Y, Z)

    def make(pad):
        return tmf.make_matrixfree_kernel(tp, TGrid(**g), td, cw, 1.3, w, dtype, chunk=4, pad_cells_to=pad,
                                          force_no_fft=no_fft, device="cpu")

    rng = np.random.default_rng(13)
    x, u = torch.as_tensor(rng.normal(size=120), dtype=dtype), torch.as_tensor(rng.normal(size=11), dtype=dtype)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    k = make(n if geometry == "generic" else 1)
    ks = tmesh.shard_kernel(k, tmesh.make_mesh(n, device="cpu"))
    assert type(k).__name__ == cls and len(ks.parts) == n
    for f, v in (("matvec", x), ("rmatvec", u)):
        a, b = getattr(k, f)(v), getattr(ks, f)(v)
        torch.testing.assert_close(b, a, rtol=0, atol=tol * float(a.abs().max()))
    if geometry == "lattice" and dtype == torch.float32:
        win, _ = tmf.lattice_near_window(*(e.double().numpy() for e in (k.xe, k.ye, k.ze)), X, Y, Z,
                                         radius=tmf.tier2_radius("magn", 1))
        assert k.far_quad and all(p.win == win == k.win for p in ks.parts)
    one = make(1)
    one_s = tmesh.shard_kernel(one, tmesh.make_mesh(1, device="cpu"))
    assert torch.equal(one_s.matvec(x), one.matvec(x)) and torch.equal(one_s.rmatvec(u), one.rmatvec(u))
    assert len(ks.slot_bytes()) == n and min(ks.slot_bytes()) > 0


def test_rmatvec_is_the_same_every_time():
    """The adjoint's scatter sums in a fixed order: two calls agree to the
    last bit (float32, the blend's candidates overlapping across points)."""
    g = grid_dict(6, 5, 4, topography=True)
    X, Y, Z = scattered(g, 16, 14)
    _, tp, _, td, cw, w = problem("grav_gz", g, X, Y, Z)
    op = tmf.make_matrixfree_kernel(tp, TGrid(**g), td, cw, 1.0, w, torch.float32, device="cpu")
    u = torch.as_tensor(np.random.default_rng(1).normal(size=16), dtype=torch.float32)
    assert op.phys.far_quad and torch.equal(op.rmatvec(u), op.rmatvec(u))


# ------------------------------------------------------------ the workflow


def _generic_problem(tmp, nx, ny, nz, ndata):
    """_write_problem's Parfile on grid_dict's grid with a topography (no
    lattice) and scattered observations above it."""
    lines = _write_problem(tmp, nx, ny, nz, ndata, wtype=0, fmt="matrixfree", niter=6)
    g = grid_dict(nx, ny, nz, topography=True)
    idx = np.indices((nz, ny, nx)).reshape(3, -1)[::-1] + 1
    with open(os.path.join(tmp, "grid.txt"), "w") as f:
        f.write(f"{nx * ny * nz}\n")
        np.savetxt(f, np.column_stack([g[k] for k in BOUNDS] + list(idx)), fmt="%.6f " * 6 + "%d %d %d")
    write_data_grid_file(os.path.join(tmp, "data.txt"), *scattered(g, ndata, 21))
    return lines


def _run_both_workflows(tmp_path, lines, capsys, extra=()):
    jout, tout = str(tmp_path / "jax_out"), str(tmp_path / "torch_out")
    rj = jsolve(jparse(lines(jout) + list(extra)), solve_dtype=jnp.float64, compute_dtype=jnp.float64)
    said_j = capsys.readouterr().out
    rt = tsolve(tparse(lines(tout) + list(extra)), solve_dtype=torch.float64, device="cpu")
    said_t = capsys.readouterr().out
    return rj, rt, jout, tout, said_j, said_t


def _hold_workflows(rj, rt, jout, tout):
    """costs.txt rows to rtol 1e-8, final model to 1e-8 of its range, final
    data rtol 1e-8; no cache written by either package."""
    cj, ct = _costs(os.path.join(jout, "costs.txt")), _costs(os.path.join(tout, "costs.txt"))
    assert len(cj) == len(ct) == 4 and ct[-1][1] < ct[0][1]
    for a, b in zip(cj, ct):
        np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-300)
    mj, mt = rj.models[0].val, rt.models[0].val
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-8 * (mj.max() - mj.min()))
    np.testing.assert_allclose(rt.data[0].val_calc, rj.data[0].val_calc, rtol=1e-8)
    assert not os.path.exists(os.path.join(tout, "SENSIT")) and not os.path.exists(os.path.join(jout, "SENSIT"))


@pytest.mark.parametrize("geometry", ["lattice", "generic"])
def test_matrixfree_workflow_matches_jax(tmp_path, capsys, geometry):
    """tpu.kernelFormat = matrixfree through solve_problem_joint_gravmag of
    both packages, float64: the same operator class in both logs, and the
    results held as in _hold_workflows (the BTTB geometry:
    tests/test_torch_bttb.py)."""
    if geometry == "lattice":
        lines = _write_problem(str(tmp_path), 8, 8, 4, 16, wtype=0, fmt="matrixfree", niter=6)
        cls = "LatticeMatrixFreeKernel"
    else:
        lines = _generic_problem(str(tmp_path), 8, 8, 4, 16)
        cls = "MatrixFreeKernel"
    rj, rt, jout, tout, said_j, said_t = _run_both_workflows(tmp_path, lines, capsys)
    assert f"grav kernel: matrix-free ({cls}, no row storage" in said_j
    assert f"grav kernel: matrix-free ({cls}, no row storage" in said_t
    _hold_workflows(rj, rt, jout, tout)


def test_auto_goes_matrixfree_in_both_packages(tmp_path, capsys, monkeypatch):
    """kernelFormat = auto on an uncompressed kernel with each package's
    device memory patched so that the dense kernel passes 0.55 of it: both
    logs say matrix-free and name the lattice operator; results held as in
    _hold_workflows."""
    from tomofastx_tpu_torch.inversion import workflow as twf

    lines = _write_problem(str(tmp_path), 8, 8, 4, 16, wtype=0, fmt="auto", niter=6)
    limit = int(16 * 256 * 4 / 0.56)
    monkeypatch.setattr(twf, "_device_memory_bytes", lambda device: limit)

    class Device:
        def memory_stats(self):
            return {"bytes_limit": limit}

    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real(*a, **k) if (a or k) else [Device()])
    rj, rt, jout, tout, said_j, said_t = _run_both_workflows(tmp_path, lines, capsys)
    for said in (said_j, said_t):
        assert "-> matrix-free" in said and "grav kernel: matrix-free (LatticeMatrixFreeKernel" in said
    _hold_workflows(rj, rt, jout, tout)


def test_matrixfree_workflow_over_a_mesh_of_cpu_slots(tmp_path):
    """The lattice and per-cell runs over CPU slots: --mesh 1 equals the
    unmeshed run to the last bit; over 3 slots the model is within 1e-10 of
    its range (float64)."""
    for name, lines in (("lattice", _write_problem(str(tmp_path), 8, 8, 4, 16, wtype=0, fmt="matrixfree", niter=6)),
                        ("generic", _generic_problem(str(tmp_path), 8, 8, 4, 16))):
        runs = {}
        for n in (0, 1, 3):
            mesh = tmesh.make_mesh(n, device="cpu") if n else None
            r = tsolve(tparse(lines(str(tmp_path / f"{name}_{n}"))), solve_dtype=torch.float64, verbose=False,
                       device="cpu", mesh=mesh)
            runs[n] = r.models[0].val
        assert np.array_equal(runs[1], runs[0]), name
        ref = runs[0]
        np.testing.assert_allclose(runs[3], ref, rtol=0, atol=1e-10 * (ref.max() - ref.min()))
