"""Port parity, module by module: prism and lattice rows, wavelets, depth
weights and the row compression of the PyTorch package against the JAX
package, on the CPU in float64, from the same numpy inputs."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tomofastx_tpu.models.data import SurveyData as JSurveyData
from tomofastx_tpu.models.grid import Grid as JGrid
from tomofastx_tpu.ops import matrixfree as jmf
from tomofastx_tpu.ops import prism as jprism
from tomofastx_tpu.ops import sensitivity as jsens
from tomofastx_tpu.ops import wavelet as jwav

from tomofastx_tpu_torch.models.data import SurveyData as TSurveyData
from tomofastx_tpu_torch.models.grid import Grid as TGrid
from tomofastx_tpu_torch.ops import matrixfree as tmf
from tomofastx_tpu_torch.ops import prism as tprism
from tomofastx_tpu_torch.ops import sensitivity as tsens
from tomofastx_tpu_torch.ops import wavelet as twav


def _lattice(nx, ny, nz, h=(100.0, 80.0, 50.0), jitter=None):
    """Flat per-cell bounds of a tensor-product grid, i fastest."""
    xe = np.arange(nx + 1) * h[0]
    ye = np.arange(ny + 1) * h[1]
    ze = np.arange(nz + 1) * h[2]
    if jitter is not None:  # uneven spacing, still a lattice
        xe = xe + np.concatenate([[0.0], np.cumsum(jitter.random(nx) * 10.0)])
    k, j, i = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    i, j, k = i.reshape(-1), j.reshape(-1), k.reshape(-1)
    return dict(
        nx=nx, ny=ny, nz=nz,
        X1=xe[i], X2=xe[i + 1], Y1=ye[j], Y2=ye[j + 1], Z1=ze[k], Z2=ze[k + 1],
    )


def _points(rng, g, n):
    X = rng.uniform(g["X1"].min(), g["X2"].max(), n)
    Y = rng.uniform(g["Y1"].min(), g["Y2"].max(), n)
    Z = -rng.uniform(0.5, 30.0, n)
    return X, Y, Z


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# ---------------------------------------------------------------- prism rows


@pytest.mark.parametrize("shape", [(4, 3, 2), (8, 8, 4), (5, 7, 3)])
def test_gravi_z_matches_jax(shape):
    """Per-cell g_z rows, float64: 1e-12 of the row's largest entry (same
    formula; the 8 corner terms cancel, so libm's last-bit differences show
    more on the small entries than on the large ones)."""
    rng = np.random.default_rng(11)
    g = _lattice(*shape)
    X, Y, Z = _points(rng, g, 6)
    bounds = [g[k] for k in ("X1", "X2", "Y1", "Y2", "Z1", "Z2")]
    got = tprism.gravi_z(_t(X)[:, None], _t(Y)[:, None], _t(Z)[:, None], *[_t(b) for b in bounds])
    for p in range(len(X)):
        want = np.asarray(jprism.gravi_z(X[p], Y[p], Z[p], *[jnp.asarray(b) for b in bounds]))
        np.testing.assert_allclose(got[p].numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_gravi_z_float32_armored_logs_match_jax():
    """The float32 branch (armored logs) follows the JAX float32 branch:
    rtol 2e-4 of the row's largest entry (float32 cancellation noise)."""
    rng = np.random.default_rng(12)
    g = _lattice(6, 5, 3)
    X, Y, Z = _points(rng, g, 3)
    bounds = [g[k] for k in ("X1", "X2", "Y1", "Y2", "Z1", "Z2")]
    f32 = torch.float32
    got = tprism.gravi_z(
        _t(X, f32)[:, None], _t(Y, f32)[:, None], _t(Z, f32)[:, None], *[_t(b, f32) for b in bounds]
    )
    assert got.dtype == f32
    for p in range(len(X)):
        want = np.asarray(
            jprism.gravi_z(
                jnp.float32(X[p]), jnp.float32(Y[p]), jnp.float32(Z[p]),
                *[jnp.asarray(b, jnp.float32) for b in bounds],
            )
        )
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[p].numpy(), want, rtol=0, atol=2e-4 * scale)


@pytest.mark.parametrize("name", ["_half_log_ratio", "_log_R_plus"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_armored_helpers_match_jax(name, dtype):
    rng = np.random.default_rng(13)
    t = rng.normal(size=50) * 100.0
    o2 = rng.uniform(1.0, 1e4, 50)
    Rs = np.sqrt(t * t + o2)
    tdt = getattr(torch, dtype)
    got = getattr(tprism, name)(_t(Rs, tdt), _t(t, tdt), _t(o2, tdt)).numpy()
    jdt = getattr(jnp, dtype)
    want = np.asarray(
        getattr(jprism, name)(jnp.asarray(Rs, jdt), jnp.asarray(t, jdt), jnp.asarray(o2, jdt))
    )
    tol = 1e-12 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_log_ratio_pp_matches_jax():
    rng = np.random.default_rng(14)
    t1, t2 = rng.normal(size=(2, 40)) * 50.0
    o1, o2 = rng.uniform(1.0, 1e3, (2, 40))
    a1, a2 = np.sqrt(t1 * t1 + o1), np.sqrt(t2 * t2 + o2)
    got = tprism._log_ratio_pp(*[_t(a) for a in (t1, a1, t2, a2, o1, o2)]).numpy()
    want = np.asarray(jprism._log_ratio_pp(*[jnp.asarray(a) for a in (t1, a1, t2, a2, o1, o2)]))
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("shape,uneven", [((4, 3, 2), False), ((8, 8, 4), False), ((6, 5, 3), True)])
def test_lattice_rows_match_jax(shape, uneven):
    """Corner-lattice g_z rows for a batch of points against the JAX rows
    point by point: rtol 1e-12 of the row's largest entry."""
    rng = np.random.default_rng(21)
    g = _lattice(*shape, jitter=rng if uneven else None)
    tg = TGrid(**g)
    edges = tmf.detect_lattice(tg)
    jedges = jmf.detect_lattice(JGrid(**g))
    assert edges is not None
    for a, b in zip(edges, jedges):
        np.testing.assert_array_equal(a, b)
    X, Y, Z = _points(rng, g, 5)
    got = tmf._lattice_closed_rows(*[_t(e) for e in edges], _t(X), _t(Y), _t(Z), "grav", 1, (0.0, 0.0, 1.0), 0.0, 1, 1)
    assert tuple(got.shape) == (5, shape[2], shape[1], shape[0], 1, 1)
    got = got[..., 0, 0]
    for p in range(5):
        want = np.asarray(
            jmf.lattice_rows_for_point(
                *[jnp.asarray(e) for e in jedges], X[p], Y[p], Z[p], "grav", 1,
                (0.0, 0.0, 1.0), 0.0, 1, 1,
            )
        )[..., 0, 0]
        np.testing.assert_allclose(got[p].numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_lattice_rows_match_percell_rows():
    """The two builds of the port agree with each other (summation order
    differs): 1e-9 of the row's largest entry."""
    rng = np.random.default_rng(22)
    g = _lattice(6, 6, 4)
    X, Y, Z = _points(rng, g, 4)
    edges = tmf.detect_lattice(TGrid(**g))
    lat = tmf._lattice_closed_rows(*[_t(e) for e in edges], _t(X), _t(Y), _t(Z), "grav", 1, (0.0, 0.0, 1.0), 0.0, 1, 1)
    bounds = [_t(g[k]) for k in ("X1", "X2", "Y1", "Y2", "Z1", "Z2")]
    per = tsens.forward_rows("grav", 1, 1, 1, (0.0, 0.0, 1.0), 0.0, False, bounds, _t(X), _t(Y), _t(Z))[:, :, 0, 0]
    scale = per.abs().max().item()
    np.testing.assert_allclose(lat.reshape(4, -1).numpy(), per.numpy(), rtol=0, atol=1e-9 * scale)


def test_detect_lattice_rejects_broken_grid():
    g = _lattice(4, 4, 2)
    g["X2"] = g["X2"].copy()
    g["X2"][3] += 1.0
    assert tmf.detect_lattice(TGrid(**g)) is None
    assert jmf.detect_lattice(JGrid(**g)) is None


def test_unported_rows_are_refused():
    """Every forward family is ported; what is still refused are the
    component counts the reference refuses too (sensitivity_gravmag.F90:211,
    magnetic_field.f90:118-297), with the reference's messages."""
    e = _t(np.arange(3.0))
    with pytest.raises(ValueError, match="data components"):
        tmf._lattice_closed_rows(e, e, e, _t([0.5]), _t([0.5]), _t([-1.0]), "magn", 1, (0.0, 0.0, 1.0), 5e4, 1, 2)
    with pytest.raises(ValueError, match="model components"):
        tmf._lattice_closed_rows(e, e, e, _t([0.5]), _t([0.5]), _t([-1.0]), "magn", 1, (0.0, 0.0, 1.0), 5e4, 2, 1)
    with pytest.raises(ValueError, match="gradiometry data components"):
        tsens.forward_rows("grav", 2, 1, 3, (0.0, 0.0, 1.0), 0.0, False, [e] * 6, _t([0.5]), _t([0.5]), _t([-1.0]))


def test_validate_finite():
    tprism.validate_finite("ok", np.ones(3))
    tprism.validate_finite("ok", torch.ones(3))
    with pytest.raises(FloatingPointError):
        tprism.validate_finite("bad", np.array([1.0, np.inf]))
    with pytest.raises(FloatingPointError):
        tprism.validate_finite("bad", torch.tensor([1.0, float("nan")]))


# ------------------------------------------------------------------ wavelets


@pytest.mark.parametrize("L", list(range(1, 18)) + [31, 32, 33, 64, 100, 128])
def test_n_scales_matches_jax(L):
    assert twav.n_scales(L) == jwav.n_scales(L)


def test_n_scales_is_the_truncated_float_quotient():
    """The reference's int(log L / log 2), rounding quirks and all, not a
    bit count: whatever the float quotient truncates to where the test runs."""
    import math

    for L in (8, 125, 243, 1000, 2**29):
        assert twav.n_scales(L) == int(math.log(float(L)) / math.log(2.0))
    assert twav.n_scales(1) == 0 and twav.n_scales(0) == 0


@pytest.mark.parametrize("wtype", [twav.HAAR, twav.DAUB4])
@pytest.mark.parametrize("shape", [(4, 8, 8), (8, 16, 16), (3, 5, 7), (2, 6, 12), (1, 1, 9)])
@pytest.mark.parametrize("inverse", [False, True])
def test_wavelet_3d_matches_jax(wtype, shape, inverse):
    """Forward and inverse lifting transforms, float64, batch of 3 fields:
    1e-13 of the field's largest entry."""
    rng = np.random.default_rng(31)
    s = rng.normal(size=(3,) + shape)
    tfn = twav.inverse_wavelet_3d if inverse else twav.forward_wavelet_3d
    jfn = jwav.inverse_wavelet_3d if inverse else jwav.forward_wavelet_3d
    src = _t(s)
    got = tfn(src, wtype).numpy()
    want = np.asarray(jfn(jnp.asarray(s), wtype))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * np.abs(want).max())
    np.testing.assert_array_equal(src.numpy(), s)  # the input is left as it was


@pytest.mark.parametrize("wtype", [twav.HAAR, twav.DAUB4])
@pytest.mark.parametrize("dims", [(8, 8, 4), (16, 16, 8), (7, 5, 3)])
def test_wavelet_flat_roundtrip_and_jax(wtype, dims):
    nx, ny, nz = dims
    rng = np.random.default_rng(32)
    v = rng.normal(size=(2, nx * ny * nz))
    w = twav.forward_wavelet_flat(_t(v), nx, ny, nz, wtype)
    want = np.asarray(jwav.forward_wavelet_flat(jnp.asarray(v), nx, ny, nz, wtype))
    np.testing.assert_allclose(w.numpy(), want, rtol=0, atol=1e-13 * np.abs(want).max())
    back = twav.inverse_wavelet_flat(w, nx, ny, nz, wtype).numpy()
    np.testing.assert_allclose(back, v, rtol=0, atol=1e-12)


def test_wavelet_unknown_type_raises():
    with pytest.raises(ValueError):
        twav.forward_wavelet_3d(torch.zeros(2, 2, 2), 7)


# ------------------------------------------------------------- depth weights


def _par(**kw):
    base = dict(
        depth_weighting_type=1, depth_weighting_power=2.0, depth_weighting_beta=1.0, Z0=0.0,
        apply_local_weight=0, local_weight_file="None",
    )
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("wtype", [1, 2, 3])
@pytest.mark.parametrize("shape,nd", [((6, 5, 3), 7), ((8, 8, 4), 20)])
def test_depth_weight_matches_jax(wtype, shape, nd):
    """Column weights of the three weighting types: rtol 1e-12."""
    rng = np.random.default_rng(41)
    g = _lattice(*shape)
    X, Y, Z = _points(rng, g, nd)
    par = _par(depth_weighting_type=wtype, depth_weighting_power=1.7, depth_weighting_beta=1.3, Z0=5.0)
    got = tsens.calculate_depth_weight(par, TGrid(**g), TSurveyData(ndata=nd, X=X, Y=Y, Z=Z), device="cpu")
    want = jsens.calculate_depth_weight(par, JGrid(**g), JSurveyData(ndata=nd, X=X, Y=Y, Z=Z))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_depth_weight_errors():
    g = _lattice(3, 3, 2)
    data = TSurveyData(ndata=1, X=np.zeros(1), Y=np.zeros(1), Z=-np.ones(1))
    with pytest.raises(ValueError):
        tsens.calculate_depth_weight(_par(depth_weighting_type=9), TGrid(**g), data, device="cpu")
    with pytest.raises(ValueError):
        tsens.calculate_depth_weight(_par(Z0=-1000.0), TGrid(**g), data, device="cpu")


def test_local_depth_weighting_matches_jax(tmp_path):
    rng = np.random.default_rng(42)
    n = 30
    local = rng.uniform(0.5, 2.0, n)
    local[[3, 7]] = 0.0
    path = tmp_path / "local.txt"
    with open(path, "w") as f:
        f.write(f"{n}\n")
        np.savetxt(f, local)
    cw = rng.uniform(1.0, 5.0, n)
    par = _par(apply_local_weight=1, local_weight_file=str(path))
    np.testing.assert_array_equal(
        tsens.apply_local_depth_weighting(par, cw), jsens.apply_local_depth_weighting(par, cw)
    )
    assert tsens.apply_local_depth_weighting(_par(), cw) is cw


# ------------------------------------------------------------ compression


@pytest.mark.parametrize("wtype", [1, 2])
@pytest.mark.parametrize("dims,rate", [((8, 8, 4), 0.15), ((16, 8, 4), 0.05), ((7, 5, 3), 0.3), ((8, 8, 4), 1.0)])
def test_compress_lines_matches_jax(wtype, dims, rate):
    """Wavelet + (k+1)-th-largest threshold: nnz per row equal, kept values
    1e-12 of the largest, error sums rtol 1e-9."""
    nx, ny, nz = dims
    N = nx * ny * nz
    rng = np.random.default_rng(51)
    lines = rng.normal(size=(5, 1, 1, N)) * np.exp(rng.normal(size=(5, 1, 1, N)))
    k = int(rate * N)
    gc, gn, ge = tsens._compress_lines(_t(lines), nx, ny, nz, wtype, k, torch.float32)
    wc, wn, we = jsens._compress_lines(jnp.asarray(lines), nx, ny, nz, wtype, k, jnp.float32)
    assert gc.dtype == torch.float32
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    if k < N:
        assert (gn.numpy() <= k).all()
    wc = np.asarray(wc)
    np.testing.assert_array_equal(gc.numpy() != 0, wc != 0)
    np.testing.assert_allclose(gc.numpy(), wc, rtol=0, atol=1e-6 * np.abs(wc).max())
    np.testing.assert_allclose(ge.numpy(), np.asarray(we), rtol=1e-9, atol=1e-14)


def test_compress_lines_ties_keep_strictly_greater():
    """Equal magnitudes at the threshold are all dropped, as in JAX."""
    nx, ny, nz = 4, 2, 1  # n_scales gives no transform on sizes 1/2... values pass through
    lines = np.array([[[[5.0, -3.0, 3.0, 3.0, 1.0, -3.0, 0.5, 0.0]]]])
    for wtype in (1,):
        gc, gn, _ = tsens._compress_lines(_t(lines), 8, 1, 1, wtype, 3, torch.float64)
        wc, wn, _ = jsens._compress_lines(jnp.asarray(lines), 8, 1, 1, wtype, 3, jnp.float64)
        np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-14)


def test_compress_lines_zero_row_has_floor():
    gc, gn, ge = tsens._compress_lines(torch.zeros(2, 1, 1, 64, dtype=torch.float64), 4, 4, 4, 1, 9, torch.float32)
    assert int(gn.sum()) == 0 and float(ge.sum()) == 0.0 and not gc.any()


@pytest.mark.parametrize("nd,batch", [(10, 256), (512, 256), (300, 256), (1000, 256), (7, 3), (4096, 256)])
def test_chunk_plan_matches_jax(nd, batch):
    assert tsens._chunk_plan(nd, batch) == jsens._chunk_plan(nd, batch)


@pytest.mark.parametrize("ct", [0, 1, 2])
def test_domain_maps_match_jax(ct):
    rng = np.random.default_rng(61)
    kw = dict(S=None, ndata=1, ndata_components=1, nmodel_components=1, nx=8, ny=4, nz=4, compression_type=ct)
    tk, jk = tsens.SensitKernel(**kw), jsens.SensitKernel(**kw)
    x = rng.normal(size=(2, 128))
    a = tk.to_solver_domain(_t(x))
    np.testing.assert_allclose(a.numpy(), np.asarray(jk.to_solver_domain(jnp.asarray(x))), atol=1e-13)
    np.testing.assert_allclose(tk.from_solver_domain(a).numpy(), x, atol=1e-12)
    assert tk.nrows == jk.nrows and tk.N == jk.N
