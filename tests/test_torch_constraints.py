"""The constraint blocks that couple and smooth the models: the damping
gradient, the cross-gradient (both derivative types, a vector field on either
model, each model kept constant, with and without the weights) and the
clustering mixture (1-D and 2-D Gaussians, both optimisation types), and the
mixture reader. The JAX package (float64) against the port (torch float64)
on the CPU, from seeded numpy inputs, on grids of uneven sides of at least 3
cells (an axis of one cell puts every cell on both boundaries, which zeroes
the cross-gradient); then each block's products against JAX's, and a
dot-product test of each adjoint."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tomofastx_tpu.config.parfile import parse_parfile_lines as jparse
from tomofastx_tpu.inversion import operators as jops
from tomofastx_tpu.inversion import workflow as jwf

from tomofastx_tpu_torch.config.parfile import parse_parfile_lines as tparse
from tomofastx_tpu_torch.inversion import operators as tops
from tomofastx_tpu_torch.inversion import workflow as twf

NX, NY, NZ = 7, 5, 4
N = NX * NY * NZ
FIELD_TOL = 1e-12  # of each field's max |.|: two float64 evaluations of one expression
ADJOINT_TOL = 1e-10  # <A x, u> against <x, A^T u>, relative to |A x| |u|


def _inputs(seed=0):
    """Two smooth models with seeded roughness, column weights and cell
    sizes, all float64 numpy."""
    rng = np.random.default_rng(seed)
    k, j, i = np.meshgrid(np.arange(NZ), np.arange(NY), np.arange(NX), indexing="ij")
    m1 = (np.sin(0.7 * i + 0.3 * j) * np.cos(0.5 * k) + 0.1 * rng.normal(size=i.shape)).reshape(-1)
    m2 = (np.cos(0.4 * i - 0.6 * j + 0.8 * k) + 0.1 * rng.normal(size=i.shape)).reshape(-1)
    return dict(
        m1=250.0 * m1, m2=0.05 * m2,
        cw1=rng.uniform(0.5, 2.0, N), cw2=rng.uniform(1e-3, 4e-3, N),
        dX=rng.uniform(80.0, 120.0, NX), dY=rng.uniform(60.0, 100.0, NY), dZ=rng.uniform(40.0, 60.0, NZ),
        lw=rng.uniform(0.5, 1.5, N), vf=rng.normal(size=(N, 3)),
    )


def _j(a):
    return jnp.asarray(a, jnp.float64)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, what, tol=FIELD_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err:.3e} of max {scale:.3e}"


def _adjoint(matvec, rmatvec, nin, nout, seed):
    """<A x, u> = <x, A^T u> for seeded x, u."""
    rng = np.random.default_rng(seed)
    x, u = _t(rng.normal(size=nin)), _t(rng.normal(size=nout))
    ax, atu = matvec(x), rmatvec(u)
    lhs, rhs = float(torch.dot(ax, u)), float(torch.dot(x, atu))
    assert abs(lhs - rhs) <= ADJOINT_TOL * float(torch.linalg.vector_norm(ax) * torch.linalg.vector_norm(u)), (lhs, rhs)


def test_shift_matches_jax():
    x = np.random.default_rng(1).normal(size=(NZ, NY, NX))
    for off in jops._XG_OFFSETS + ((2, -1, 1), (-2, 3, -1)):
        np.testing.assert_array_equal(tops.shift(_t(x), off).numpy(), np.asarray(jops.shift(_j(x), off)))


@pytest.mark.parametrize("direction", [1, 2, 3])
def test_damping_gradient_matches_jax(direction):
    """Coefficients, right-hand side and cost at 1e-12 of their max; the
    products on a seeded vector at 1e-12; the adjoint at 1e-10."""
    d = _inputs()
    args = (2.5, 0.7)
    jo = jops.make_damping_gradient(*args, _j(d["m1"]), _j(d["cw1"]), _j(d["lw"]), _j(d["dX"]), _j(d["dY"]),
                                    _j(d["dZ"]), NX, NY, NZ, direction)
    to = tops.make_damping_gradient(*args, _t(d["m1"]), _t(d["cw1"]), _t(d["lw"]), _t(d["dX"]), _t(d["dY"]),
                                    _t(d["dZ"]), NX, NY, NZ, direction)
    assert to.offset == jo.offset and to.rhs.dtype == torch.float64
    for name in ("coefA", "coefB", "rhs", "cost"):
        _close(getattr(to, name), getattr(jo, name), name)
    assert float(to.cost) > 0.0 and np.abs(np.asarray(jo.coefA)).max() > 0.0
    rng = np.random.default_rng(2)
    x, u = rng.normal(size=(NZ, NY, NX)), rng.normal(size=N)
    _close(to.matvec(_t(x)), jo.matvec(_j(x)), "matvec")
    _close(to.rmatvec(_t(u)), jo.rmatvec(_j(u)), "rmatvec")
    _adjoint(lambda v: to.matvec(v.reshape(NZ, NY, NX)), lambda w: to.rmatvec(w).reshape(-1), N, N, 3)


XGRAD_CASES = (
    [(der, vft, keep, True) for der in (1, 2) for vft in (0, 1, 2) for keep in ((0, 0), (1, 0), (0, 1))]
    + [(1, 0, (0, 0), False), (2, 0, (0, 0), False)]
)


@pytest.mark.parametrize("der_type,vec_field_type,keep,add_weights", XGRAD_CASES)
def test_cross_gradient_matches_jax(der_type, vec_field_type, keep, add_weights):
    """C1, C2, rhs, cost and magnitude at 1e-12 of their max; matvec and
    rmatvec against JAX's at 1e-12; the adjoint at 1e-10. vec_field_type 1
    (2) puts the seeded vector field in place of model 1's (2's)
    gradient."""
    d = _inputs()
    common = (3.0e-4, der_type, keep)
    tail = (NX, NY, NZ, add_weights)
    vf = d["vf"] if vec_field_type else None
    jo = jops.make_cross_gradient(_j(d["m1"]), _j(d["m2"]), _j(d["cw1"]), _j(d["cw2"]), *common,
                                  None if vf is None else _j(vf), vec_field_type,
                                  _j(d["dX"]), _j(d["dY"]), _j(d["dZ"]), *tail)
    to = tops.make_cross_gradient(_t(d["m1"]), _t(d["m2"]), _t(d["cw1"]), _t(d["cw2"]), *common,
                                  None if vf is None else _t(vf), vec_field_type,
                                  _t(d["dX"]), _t(d["dY"]), _t(d["dZ"]), *tail)
    for name in ("C1", "C2", "rhs", "cost", "magnitude"):
        t, j = getattr(to, name), getattr(jo, name)
        assert t.dtype == torch.float64, name
        if name == "C1" and keep[0] or name == "C2" and keep[1]:
            assert not t.any(), name
            continue
        _close(t, j, name)
    assert float(to.cost.min()) > 0.0
    rng = np.random.default_rng(4)
    x1, x2, u = rng.normal(size=(NZ, NY, NX)), rng.normal(size=(NZ, NY, NX)), rng.normal(size=3 * N)
    _close(to.matvec(_t(x1), _t(x2)), jo.matvec(_j(x1), _j(x2)), "matvec")
    for name, t, j in zip(("rmatvec 1", "rmatvec 2"), to.rmatvec(_t(u)), jo.rmatvec(_j(u))):
        if np.abs(np.asarray(j)).max() > 0:
            _close(t, j, name)
        else:
            assert not t.any(), name
    _adjoint(lambda v: to.matvec(v[:N].reshape(NZ, NY, NX), v[N:].reshape(NZ, NY, NX)),
             lambda w: torch.cat([g.reshape(-1) for g in to.rmatvec(w)]), 2 * N, 3 * N, 5)


@pytest.mark.parametrize("nx", [1, 2])
def test_cross_gradient_on_a_thin_axis(nx):
    """One cell along an axis puts every cell on both boundaries: no row of
    the cross-gradient survives, in both packages. Two cells leave the
    one-sided schemes, and both packages agree as on a thick grid."""
    d = _inputs()
    n = nx * NY * NZ
    args = [d["m1"][:n], d["m2"][:n], d["cw1"][:n], d["cw2"][:n]]
    to = tops.make_cross_gradient(*map(_t, args), 1.0, 2, (0, 0), None, 0, _t(d["dX"][:nx]), _t(d["dY"]),
                                  _t(d["dZ"]), nx, NY, NZ)
    jo = jops.make_cross_gradient(*map(_j, args), 1.0, 2, (0, 0), None, 0, _j(d["dX"][:nx]), _j(d["dY"]),
                                  _j(d["dZ"]), nx, NY, NZ)
    if nx == 1:
        assert not to.C1.any() and not to.C2.any() and not to.cost.any()
        assert not np.asarray(jo.C1).any() and not np.asarray(jo.cost).any()
    else:
        assert float(to.cost.min()) > 0.0
        for name in ("C1", "C2", "rhs", "cost", "magnitude"):
            _close(getattr(to, name), getattr(jo, name), name)


def _mixture(C=3, seed=6):
    rng = np.random.default_rng(seed)
    mu = np.stack([rng.uniform(-50.0, 300.0, C), rng.uniform(-0.01, 0.06, C)])
    s11, s22 = rng.uniform(20.0, 60.0, C), rng.uniform(0.005, 0.02, C)
    # A small correlation keeps the 2-D covariance positive definite.
    s12 = np.sqrt(0.3 * s11 * s22)
    cell_weight = rng.uniform(0.1, 1.0, (N, C))
    return mu, np.stack([s11, s22, s12]), cell_weight / cell_weight.sum(1, keepdims=True)


GAUSS_LOC = pytest.mark.parametrize("weight_loc", [(1.0, 0.0), (0.0, 1.0), (1.0, 1.0)], ids=["1d-grav", "1d-mag", "2d"])


@GAUSS_LOC
def test_gaussian_mixture_matches_jax(weight_loc):
    """Value and derivatives at 1e-12 of their max, with some cells far out
    in the tails (the exp(-100) floor)."""
    d = _inputs()
    mu, sigma, cw = _mixture()
    v1, v2 = d["m1"].copy(), d["m2"].copy()
    v1[:5], v2[:5] = 1e5, 10.0  # beyond the floor
    gt, dt = tops.gaussian_mixture(_t(v1), _t(v2), _t(mu), _t(sigma), _t(cw), weight_loc)
    gj, dj = jops.gaussian_mixture(_j(v1), _j(v2), _j(mu), _j(sigma), _j(cw), weight_loc)
    _close(gt, gj, "gauss")
    _close(dt, dj, "deriv")
    # The floor, summed over clusters whose cell weights add up to 1.
    np.testing.assert_allclose(gt[:5].numpy(), np.asarray(gj)[:5], rtol=1e-15)
    np.testing.assert_allclose(gt[:5].numpy(), np.exp(-100.0), rtol=1e-15)


@GAUSS_LOC
@pytest.mark.parametrize("opt_type", [1, 2])
@pytest.mark.parametrize("problem", [0, 1])
def test_clustering_matches_jax(weight_loc, opt_type, problem):
    """dcoef, rhs, cost and probabilities at 1e-12 of their max; the block's
    products (dcoef * x forward, dcoef * u back: a diagonal, so its own
    adjoint) against JAX's."""
    d = _inputs()
    mu, sigma, cw = _mixture()
    wg = (2.0 * weight_loc[0], 3.0 * weight_loc[1])
    mmax = np.random.default_rng(7).uniform(1.0, 2.0, N) * 1e-3
    jo = jops.make_clustering(_j(d["m1"]), _j(d["m2"]), _j(d["cw1"]), _j(d["cw2"]), wg, _j(mu), _j(sigma), _j(cw),
                              _j(mmax), opt_type, problem)
    to = tops.make_clustering(_t(d["m1"]), _t(d["m2"]), _t(d["cw1"]), _t(d["cw2"]), wg, _t(mu), _t(sigma), _t(cw),
                              _t(mmax), opt_type, problem)
    assert to.problem == problem
    for name in ("dcoef", "rhs", "cost", "probabilities"):
        t, j = getattr(to, name), getattr(jo, name)
        if np.abs(np.asarray(j)).max() > 0:
            _close(t, j, name)
        else:
            assert not t.any(), name  # the weight of this problem is 0
    x = np.random.default_rng(8).normal(size=N)
    _close(to.dcoef * _t(x), jo.dcoef * _j(x), "product")


def test_clustering_refuses_an_unknown_optimisation_type():
    d = _inputs()
    mu, sigma, cw = _mixture()
    with pytest.raises(ValueError, match="optimization type"):
        tops.make_clustering(_t(d["m1"]), _t(d["m2"]), _t(d["cw1"]), _t(d["cw2"]), (1.0, 1.0), _t(mu), _t(sigma),
                             _t(cw), _t(np.ones(N)), 3, 0)


def write_mixture_files(tmp, C=2, seed=9):
    """A mixture file (cluster weight, mu1, s11, mu2, s22, s12 per row) and a
    cell-weights file (header N C) of C clusters."""
    rng = np.random.default_rng(seed)
    mu, sigma, cw = _mixture(C, seed)
    table = np.column_stack([rng.uniform(0.5, 2.0, C), mu[0], sigma[0], mu[1], sigma[1], sigma[2]])
    mix, cells = os.path.join(tmp, "mixture.txt"), os.path.join(tmp, "cell_weights.txt")
    with open(mix, "w") as f:
        f.write(f"{C}\n")
        np.savetxt(f, table, fmt="%.12E")
    with open(cells, "w") as f:
        f.write(f"{N} {C}\n")
        np.savetxt(f, cw, fmt="%.12E")
    return mix, cells


@pytest.mark.parametrize("constraints_type", [1, 2], ids=["global-weights", "cell-weights-file"])
@GAUSS_LOC
def test_read_mixtures_matches_jax(tmp_path, constraints_type, weight_loc):
    """_read_mixtures of both packages on the same files: mu, sigma, the cell
    weights equal, the mixture maximum at 1e-12."""
    mix, cells = write_mixture_files(str(tmp_path))
    lines = [f"modelGrid.size = {NX} {NY} {NZ}", "inversion.clustering.nClusters = 2",
             f"inversion.clustering.mixtureFile = {mix}", f"inversion.clustering.cellWeightsFile = {cells}",
             f"inversion.clustering.constraintsType = {constraints_type}",
             f"inversion.clustering.grav.weight = {weight_loc[0]}", f"inversion.clustering.magn.weight = {weight_loc[1]}"]
    jm = jwf._read_mixtures(jparse(lines), "/")
    tm = twf._read_mixtures(tparse(lines), "/")
    assert sorted(tm) == sorted(jm)
    for k in ("mixture_mu", "mixture_sigma", "cell_weight"):
        np.testing.assert_array_equal(tm[k], jm[k])
    _close(tm["mixture_max"], jm["mixture_max"], "mixture_max")
    assert tm["mixture_max"].dtype == np.float64 and tm["mixture_max"].shape == (N,)


def test_read_mixtures_refuses_inconsistent_files(tmp_path):
    mix, cells = write_mixture_files(str(tmp_path))
    lines = [f"modelGrid.size = {NX} {NY} {NZ}", f"inversion.clustering.mixtureFile = {mix}",
             f"inversion.clustering.cellWeightsFile = {cells}", "inversion.clustering.grav.weight = 1"]
    with pytest.raises(ValueError, match="number of clusters"):
        twf._read_mixtures(tparse(lines + ["inversion.clustering.nClusters = 3"]), "/")
    with open(cells, "w") as f:
        f.write(f"{N + 1} 2\n")
    with pytest.raises(ValueError, match="cell weights"):
        twf._read_mixtures(tparse(lines + ["inversion.clustering.nClusters = 2"]), "/")
