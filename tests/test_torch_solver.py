"""Port parity for the solver side: LSQR, the damping block, the ADMM
projection, the per-major solve, and the Parfile parser, against the JAX
package on the CPU in float64 from the same numpy inputs."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tomofastx_tpu.config import parfile as jparfile
from tomofastx_tpu.inversion import joint as jjoint
from tomofastx_tpu.inversion import operators as jops
from tomofastx_tpu.ops import tile_kernel as jtile
from tomofastx_tpu.ops.lsqr import lsqr_solve as jlsqr

from tomofastx_tpu_torch import convert
from tomofastx_tpu_torch.config import parfile as tparfile
from tomofastx_tpu_torch.inversion import joint as tjoint
from tomofastx_tpu_torch.inversion import operators as tops
from tomofastx_tpu_torch.ops.lsqr import lsqr_solve as tlsqr


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# --------------------------------------------------------------------- LSQR


def _both_lsqr(A, b, niter, rmin, gamma=0.0, target=0.0):
    At, Aj = _t(A), jnp.asarray(A)
    misfit_t = misfit_j = None
    if target > 0.0:
        misfit_t = lambda x: torch.sqrt(torch.sum((At @ x - _t(b)) ** 2) / b.size)  # noqa: E731
        misfit_j = lambda x: jnp.sqrt(jnp.sum((Aj @ x - jnp.asarray(b)) ** 2) / b.size)  # noqa: E731
    rt = tlsqr(lambda x: At @ x, lambda u: At.T @ u, _t(b), A.shape[1], niter, rmin, gamma, target, misfit_t)
    rj = jlsqr(lambda x: Aj @ x, lambda u: Aj.T @ u, jnp.asarray(b), A.shape[1], niter, rmin, gamma, target, misfit_j)
    return rt, rj


def _well_conditioned(m, n, seed):
    """A with singular values in [1, 4] and a right-hand side in its range
    plus a little noise: rounding differences between the two packages are
    not amplified, so iteration counts can be compared."""
    rng = np.random.default_rng(seed)
    k = min(m, n)
    U, _ = np.linalg.qr(rng.normal(size=(m, k)))
    V, _ = np.linalg.qr(rng.normal(size=(n, k)))
    A = (U * rng.uniform(1.0, 4.0, k)) @ V.T
    b = A @ rng.normal(size=n) + 1e-2 * rng.normal(size=m)
    return A, b


@pytest.mark.parametrize(
    "m,n,niter,rmin,gamma",
    [
        (30, 20, 12, 1e-13, 0.0),  # overdetermined, capped
        (20, 40, 15, 1e-13, 0.0),  # underdetermined, capped
        (25, 25, 200, 1e-3, 0.0),  # exits on r <= rmin
        (40, 10, 200, 5e-2, 0.0),  # exits on r <= rmin, early
        (30, 20, 30, 1e-13, 0.05),  # soft threshold
        (12, 12, 1, 1e-13, 0.0),  # one iteration
        (12, 12, 0, 1e-13, 0.0),  # none
    ],
)
def test_lsqr_matches_jax(m, n, niter, rmin, gamma):
    """Same iteration count; x to 1e-10 of its largest entry; r to 1e-9."""
    A, b = _well_conditioned(m, n, 100 + m + n)
    rt, rj = _both_lsqr(A, b, niter, rmin, gamma)
    assert rt.iters == int(rj.iters)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0, atol=1e-10 * max(np.abs(xj).max(), 1e-300))
    np.testing.assert_allclose(float(rt.r), float(rj.r), rtol=1e-7, atol=1e-15)


def test_lsqr_consistent_system_stops_early_like_jax():
    """b in the range of a low-rank A: the recurrence breaks down (rhobar or
    rho ~ 0) and both stop at the same count."""
    rng = np.random.default_rng(7)
    A = rng.normal(size=(10, 3)) @ rng.normal(size=(3, 8))
    b = A @ rng.normal(size=8)
    rt, rj = _both_lsqr(A, b, 50, 1e-13)
    assert rt.iters == int(rj.iters) < 50
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-8)


def test_lsqr_zero_rhs_returns_zeros():
    A = np.eye(4)
    rt, rj = _both_lsqr(A, np.zeros(4), 10, 1e-13)
    assert rt.iters == int(rj.iters)
    assert not rt.x.any()


def test_lsqr_target_misfit_exit_matches_jax():
    rng = np.random.default_rng(9)
    A = rng.normal(size=(30, 10))
    b = A @ rng.normal(size=10)
    rt, rj = _both_lsqr(A, b, 100, 1e-13, target=1e-3)
    assert rt.iters == int(rj.iters) < 100
    np.testing.assert_allclose(float(rt.misfit), float(rj.misfit), rtol=1e-6)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-9)


def test_lsqr_float32_keeps_dtype():
    rng = np.random.default_rng(10)
    A = torch.as_tensor(rng.normal(size=(9, 5)), dtype=torch.float32)
    r = tlsqr(lambda x: A @ x, lambda u: A.T @ u, A @ torch.ones(5), 5, 20, 1e-6)
    assert r.x.dtype == torch.float32
    np.testing.assert_allclose(r.x.numpy(), np.ones(5), atol=1e-3)


# --------------------------------------------------------------- operators


@pytest.mark.parametrize("offset", [(1, 0, 0), (-1, 0, 0), (0, 2, 0), (0, 0, -1), (1, -1, 1), (0, 0, 0)])
def test_shift_matches_jax(offset):
    rng = np.random.default_rng(20)
    cube = rng.normal(size=(3, 4, 5))
    src = _t(cube)
    got = tops.shift(src, offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.shift(jnp.asarray(cube), offset)))
    np.testing.assert_array_equal(src.numpy(), cube)


@pytest.mark.parametrize("ctype,wavelet_domain", [(0, False), (1, True), (1, False), (2, True)])
@pytest.mark.parametrize("norm_power,local", [(2.0, False), (1.5, False), (2.0, True)])
def test_make_damping_matches_jax(ctype, wavelet_domain, norm_power, local):
    """dcoef, rhs, cost and both products: rtol 1e-12."""
    rng = np.random.default_rng(21)
    nx, ny, nz = 8, 4, 4
    N = nx * ny * nz
    model, prior = rng.normal(size=(2, 1, N))
    cw = rng.uniform(0.5, 2.0, N)
    cw[5] = 0.0
    lw = rng.uniform(0.5, 2.0, N) if local else None
    args = (3e-2, 0.7, norm_power)
    t = tops.make_damping(*args, _t(model), _t(prior), _t(cw), None if lw is None else _t(lw),
                          wavelet_domain, ctype, nx, ny, nz)
    j = jops.make_damping(*args, jnp.asarray(model), jnp.asarray(prior), jnp.asarray(cw),
                          None if lw is None else jnp.asarray(lw), wavelet_domain, ctype, nx, ny, nz)
    np.testing.assert_allclose(t.dcoef.numpy(), np.asarray(j.dcoef), rtol=1e-12)
    np.testing.assert_allclose(t.rhs.numpy(), np.asarray(j.rhs), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(float(t.cost), float(j.cost), rtol=1e-12)
    assert t.nrows == j.nrows
    x = rng.normal(size=(1, N))
    np.testing.assert_allclose(t.matvec(_t(x)).numpy(), np.asarray(j.matvec(jnp.asarray(x))), rtol=1e-12)
    np.testing.assert_allclose(t.rmatvec(_t(x.reshape(-1))).numpy(), np.asarray(j.rmatvec(jnp.asarray(x.reshape(-1)))), rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admm_iterate_matches_jax_exactly(seed):
    """Same z, u, x0 bit for bit, ties at interval midpoints included
    (first minimum wins in both)."""
    rng = np.random.default_rng(seed)
    N = 200
    mins = np.array([-10.0, 90.0, 240.0])[:, None].repeat(N, 1)
    maxs = np.array([10.0, 110.0, 260.0])[:, None].repeat(N, 1)
    x = rng.uniform(-50, 300, N)
    x[:4] = [50.0, 175.0, 10.0, 90.0]  # two exact midpoints, two bounds
    u = rng.normal(size=N) * 5.0
    u[:4] = 0.0
    z = rng.normal(size=N)
    got = tjoint.admm_iterate(_t(z), _t(u), _t(x), _t(mins), _t(maxs))
    want = jjoint.admm_iterate(jnp.asarray(z), jnp.asarray(u), jnp.asarray(x), jnp.asarray(mins), jnp.asarray(maxs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0][0].item() == 10.0 and got[0][1].item() == 110.0


@pytest.mark.parametrize(
    "field,value,expect",
    [
        (None, None, True), ("cross_grad_weight", 1.0, False), ("clustering_weight_glob", (0.0, 1.0), False),
        ("beta", (1.0, 0.0), False), ("norm_power", 1.5, False), ("admm_bound_type", 2, False),
        ("apply_local_damping_weight", 1, False),
    ],
)
def test_decide_wavelet_domain_matches_jax(field, value, expect):
    ti, ji = tparfile.InversionParams(), jparfile.InversionParams()
    if field:
        setattr(ti, field, value)
        setattr(ji, field, value)
    assert tjoint.decide_wavelet_domain(ti) is expect
    assert jjoint.decide_wavelet_domain(ji) is expect


# ----------------------------------------------------- the per-major solve


def _jax_spec(**kw):
    base = dict(
        active=(0,), ncomp=1, nx=8, ny=4, nz=4, ndata_rows=(13,), compression_type=1, wavelet_domain=True,
        problem_weight=(1.0, 0.0), alpha=(1e-3, 0.0), norm_power=2.0, add_damping=(True, False),
        beta=(0.0, 0.0), add_damping_gradient=(False, False), admm_enabled=(True, False), nlithos=2,
        cross_grad=False, cross_grad_weight=0.0, der_type=1, keep_model_constant=(0, 0), vec_field_type=0,
        clustering=False, clustering_weight_glob=(0.0, 0.0), clustering_opt_type=2,
        apply_local_damping_weight=False, niter=12, rmin=1e-13, gamma=0.0, target_misfit=0.0,
    )
    base.update(kw)
    return jjoint.SystemSpec(**base)


def _torch_spec(js):
    names = {f.name for f in dataclasses.fields(tjoint.SystemSpec)}
    return tjoint.SystemSpec(**{k: v for k, v in dataclasses.asdict(js).items() if k in names})


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"wavelet_domain": False},
        {"compression_type": 0, "wavelet_domain": False},
        {"admm_enabled": (False, False)},
        {"add_damping": (False, False)},
        {"apply_local_damping_weight": True, "wavelet_domain": False},
        {"target_misfit": 1.0, "niter": 40},
        {"compression_type": 2},
        {"beta": (1e-2, 0.0), "add_damping_gradient": (True, False), "wavelet_domain": False},
    ],
    ids=["wavelet", "model-domain", "uncompressed", "no-admm", "no-damping", "local-weight", "target-misfit", "d4",
         "damping-gradient"],
)
def test_solver_matches_jax(kw):
    """One major iteration's solve from identical state (convert.py): same
    LSQR iteration count, delta 1e-9 of its largest entry, ADMM state exact
    to 1e-12, costs rtol 1e-10."""
    rng = np.random.default_rng(30)
    js = _jax_spec(**kw)
    ts = _torch_spec(js)
    N, nd = js.N, js.ndata_rows[0]
    S = rng.normal(size=(nd, N)).astype(np.float32)
    S[rng.random(S.shape) > 0.3] = 0.0
    jk = jtile.pack_tiles(S)
    tk = convert.tile_kernel_from_numpy(
        *[np.asarray(getattr(jk, f)) for f in ("uvals", "ubidx", "uvalsT", "ubidxT")], nd, N, device="cpu"
    )
    model = rng.uniform(-20, 120, (1, N))
    prior = np.zeros((1, N))
    cw = rng.uniform(0.5, 2.0, N)
    z, u = rng.normal(size=(2, N))
    rho = [0.3, 1e5]
    mins = np.array([-10.0, 90.0])[:, None].repeat(N, 1)
    maxs = np.array([10.0, 110.0])[:, None].repeat(N, 1)
    bw = rng.uniform(0.5, 1.5, N)
    dw = rng.uniform(0.5, 1.5, N)
    dgw = rng.uniform(0.5, 1.5, (3, N))
    dxyz = [rng.uniform(0.5, 2.0, n) for n in (js.nx, js.ny, js.nz)]
    resid = rng.normal(size=(nd, 1))

    tarr = convert.solver_state_from_numpy([model], [prior], [cw], [z], [u], rho, device="cpu")
    tarr.update(S=(tk,), residuals=(_t(resid),), min_bound=(_t(mins),), max_bound=(_t(maxs),),
                bound_weight=(_t(bw),), damping_weight=(_t(dw),), damping_grad_weight=(_t(dgw),),
                dX=_t(dxyz[0]), dY=_t(dxyz[1]), dZ=_t(dxyz[2]))
    J = jnp.asarray
    jarr = dict(
        S=(jk,), cw=(J(cw),), dX=J(dxyz[0]), dY=J(dxyz[1]), dZ=J(dxyz[2]),
        model=(J(model),), prior=(J(prior),), residuals=(J(resid),), admm_z=(J(z),), admm_u=(J(u),),
        rho_admm=J(rho), min_bound=(J(mins),), max_bound=(J(maxs),), bound_weight=(J(bw),),
        damping_weight=(J(dw),), damping_grad_weight=(J(dgw),),
    )
    tout = tjoint.make_solver(ts)(tarr)
    jout = jjoint.make_solver(js)(jarr)
    assert tout["lsqr_iters"] == int(jout["lsqr_iters"])
    if js.target_misfit > 0.0:
        assert 0 < tout["lsqr_iters"] < js.niter  # left through the misfit check
    dj = np.asarray(jout["delta"][0])
    np.testing.assert_allclose(tout["delta"][0].numpy(), dj, rtol=0, atol=1e-9 * np.abs(dj).max())
    np.testing.assert_allclose(tout["admm_z"][0].numpy(), np.asarray(jout["admm_z"][0]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tout["admm_u"][0].numpy(), np.asarray(jout["admm_u"][0]), rtol=0, atol=1e-12)
    assert set(tout["costs"]) == set(jout["costs"])
    for k in tout["costs"]:
        np.testing.assert_allclose(float(tout["costs"][k]), float(jout["costs"][k]), rtol=1e-10)


# ------------------------------------------------------------------ Parfile

PARFILE = """
global.outputFolderPath = out/x/
global.description = a test
modelGrid.size = 16 8 4
modelGrid.grav.file = grid.txt
forward.data.grav.nData = 50
forward.data.grav.dataGridFile = data.txt
forward.data.grav.useSyntheticModelForDataValues = 1
forward.data.grav.syntheticModelFile = synth.txt
forward.depthWeighting.type = 2
forward.depthWeighting.grav.power = 1.5d0
forward.matrixCompression.type = 1
forward.matrixCompression.rate = 0.15
sensit.readFromFiles = 0
sensit.folderPath = SENSIT/
inversion.nMajorIterations = 3
inversion.nMinorIterations = 20
inversion.minResidual = 1.d-13
inversion.modelDamping.grav.weight = 1.d-11
inversion.joint.grav.columnWeightMultiplier = 4.d+3
inversion.admm.enableADMM = 1
inversion.admm.nLithologies = 3
inversion.admm.grav.bounds = -10 10 90 110 240 260
inversion.admm.grav.weight = 1.e-7
inversion.admm.weightMultiplier = 2.0
tpu.kernelFormat = tiled
tpu.latticeBuild = 1
output.paraview.grav.modelLabel = density
# a comment
"""


def test_parfile_defaults_field_equal():
    assert dataclasses.asdict(tparfile.Config()) == dataclasses.asdict(jparfile.Config())


def test_parfile_parse_field_equal():
    lines = PARFILE.splitlines()
    t, j = tparfile.parse_parfile_lines(lines), jparfile.parse_parfile_lines(lines)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.grav.kernel_format == "tiled" and t.inversion.admm_bounds[0] == [-10, 10, 90, 110, 240, 260]
    assert tparfile.config_summary(t) == jparfile.config_summary(j)


@pytest.mark.parametrize(
    "line",
    ["inversion.admm.grav.bounds = 1 2 3", "forward.data.grav.nData = many", "tpu.kernelStoreDtype = int8",
     "tpu.refineForwardPrecision = half"],
)
def test_parfile_bad_values_raise_in_both(line):
    lines = PARFILE.splitlines() + [line]
    with pytest.raises(ValueError):
        tparfile.parse_parfile_lines(lines)
    with pytest.raises(ValueError):
        jparfile.parse_parfile_lines(lines)


def test_parfile_unknown_key_warns(capsys):
    tparfile.parse_parfile_lines(["no.such.key = 1"])
    assert "unknown Parfile key 'no.such.key'" in capsys.readouterr().err


def test_read_parfile_from_disk(tmp_path):
    p = tmp_path / "Parfile.txt"
    p.write_text(PARFILE)
    assert dataclasses.asdict(tparfile.read_parfile(str(p))) == dataclasses.asdict(jparfile.read_parfile(str(p)))
