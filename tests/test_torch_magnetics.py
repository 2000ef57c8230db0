"""Port parity for the magnetic and gradiometry physics and their build: the
prism functions, the corner-lattice rows of every forward family, the
streamed and dense builds (lattice, per-cell and borehole, compressed and
not) with their cache files and the three cache readers, against the JAX
package on the CPU in float64 from seeded numpy inputs. Cells are
100 x 80 x 50 m."""

import filecmp
import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tomofastx_tpu.config.parfile import GravParams as JGravParams
from tomofastx_tpu.config.parfile import MagParams as JMagParams
from tomofastx_tpu.io import sensit_cache as jcache
from tomofastx_tpu.models.data import SurveyData as JSurveyData
from tomofastx_tpu.models.grid import Grid as JGrid
from tomofastx_tpu.ops import matrixfree as jmf
from tomofastx_tpu.ops import prism as jprism
from tomofastx_tpu.ops import sensitivity as jsens
from tomofastx_tpu.ops import tile_kernel as jtile

from tomofastx_tpu_torch.config.parfile import GravParams as TGravParams
from tomofastx_tpu_torch.config.parfile import MagParams as TMagParams
from tomofastx_tpu_torch.io import sensit_cache as tcache
from tomofastx_tpu_torch.models.data import SurveyData as TSurveyData
from tomofastx_tpu_torch.models.grid import Grid as TGrid
from tomofastx_tpu_torch.ops import matrixfree as tmf
from tomofastx_tpu_torch.ops import prism as tprism
from tomofastx_tpu_torch.ops import sensitivity as tsens
from tomofastx_tpu_torch.ops import tile_kernel as ttile

H = (100.0, 80.0, 50.0)
NX, NY, NZ = 8, 6, 5
MAGV = tprism.dircos(60.0, 10.0, 0.0)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _grid_dict(nx=NX, ny=NY, nz=NZ):
    k, j, i = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    i, j, k = (a.reshape(-1).astype(float) for a in (i, j, k))
    return dict(
        nx=nx, ny=ny, nz=nz,
        X1=i * H[0], X2=(i + 1) * H[0], Y1=j * H[1], Y2=(j + 1) * H[1], Z1=k * H[2], Z2=(k + 1) * H[2],
    )


def _points(rng, n, inside=False):
    """n observation points above the grid; the first stands exactly above a
    lattice node (on a lattice line in x and y), and with `inside` the
    second lies inside a cell, off every face (a borehole point)."""
    X = rng.uniform(10.0, NX * H[0] - 10.0, n)
    Y = rng.uniform(10.0, NY * H[1] - 10.0, n)
    Z = -rng.uniform(1.0, 30.0, n)
    X[0], Y[0] = 2 * H[0], 3 * H[1]
    if inside:
        X[1], Y[1], Z[1] = 3.3 * H[0], 2.6 * H[1], 1.7 * H[2]
    return X, Y, Z


def _close(got, want, rel=1e-12, finite=True):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(want).all() or not finite
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want[np.isfinite(want)]).max())


# ---------------------------------------------------------------- prism


def _cells():
    g = _grid_dict()
    return [g[k] for k in ("X1", "X2", "Y1", "Y2", "Z1", "Z2")]


def _per_point(name, X, Y, Z, *args):
    """The JAX function point by point, stacked on a leading axis (tuples of
    outputs flattened in order)."""
    fn = getattr(jprism, name)
    out = []
    for p in range(len(X)):
        r = fn(X[p], Y[p], Z[p], *[jnp.asarray(c) for c in _cells()], *args)
        out.append(np.stack([np.asarray(a) for a in _flat(r)]))
    return np.stack(out)


def _flat(r):
    if isinstance(r, (tuple, list)):
        return [a for item in r for a in _flat(item)]
    return [r]


def _port(name, X, Y, Z, *args):
    fn = getattr(tprism, name)
    r = fn(_t(X)[:, None], _t(Y)[:, None], _t(Z)[:, None], *[_t(c) for c in _cells()], *args)
    parts = [a.expand(len(X), NX * NY * NZ) if a.dim() == 2 else a for a in _flat(r)]
    if len(parts) == 1 and parts[0].dim() > 2:  # magprism_row: (B, N, nmc, ndc)
        return parts[0].numpy()
    return torch.stack(parts, dim=1).numpy()


@pytest.mark.parametrize("name", ["gravi_full", "gradi_zz", "gradi_full", "sharmbox"])
def test_prism_functions_match_jax(name):
    """Each per-cell kernel for a batch of points, one of them above a
    lattice node and one inside a cell: 1e-12 of the largest value. The
    horizontal components of gravi_full (on no build path, in either
    package) take log(R + z) = log(0) straight above a lattice node: the
    same entries are non-finite in both."""
    X, Y, Z = _points(np.random.default_rng(1), 5, inside=True)
    _close(_port(name, X, Y, Z), _per_point(name, X, Y, Z), finite=name != "gravi_full")


@pytest.mark.parametrize("handle_inside", [False, True], ids=["outside", "borehole"])
def test_magnetic_tensor_matches_jax(handle_inside):
    """The tensor with and without the 6-subprism branch, a point inside a
    cell among them: 1e-12 of the largest value."""
    X, Y, Z = _points(np.random.default_rng(2), 4, inside=True)
    _close(_port("magnetic_tensor", X, Y, Z, handle_inside), _per_point("magnetic_tensor", X, Y, Z, handle_inside))


@pytest.mark.parametrize("nmc,ndc", [(1, 1), (1, 3), (3, 1), (3, 3)])
@pytest.mark.parametrize("handle_inside", [False, True], ids=["outside", "borehole"])
def test_magprism_row_matches_jax(nmc, ndc, handle_inside):
    """Susceptibility or magnetization vector x TMI or three components,
    with the unit scaling: (B, N, nmc, ndc), 1e-12 of the largest value."""
    X, Y, Z = _points(np.random.default_rng(3), 4, inside=True)
    got = _port("magprism_row", X, Y, Z, MAGV, 5.0e4, nmc, ndc, handle_inside)
    want = np.stack([
        np.asarray(jprism.magprism_row(X[p], Y[p], Z[p], *[jnp.asarray(c) for c in _cells()], MAGV, 5.0e4,
                                       nmodel_components=nmc, ndata_components=ndc, handle_inside=handle_inside))
        for p in range(4)
    ])
    assert got.shape == (4, NX * NY * NZ, nmc, ndc)
    _close(got, want)


@pytest.mark.parametrize("name", ["mag_corner_potentials", "ftg_corner_potentials", "gz_corner_potential"])
def test_corner_potentials_match_jax(name):
    """Corner antiderivatives on offsets of both signs, zeros among them
    (a corner straight below an observation): 1e-12 of the largest value."""
    rng = np.random.default_rng(4)
    x, y, z = (rng.normal(size=60) * 300.0 for _ in range(3))
    x[:5], y[:5] = 0.0, 0.0
    z[:5] = np.abs(z[:5]) + 1.0
    got = np.stack([a.numpy() for a in _flat(getattr(tprism, name)(_t(x), _t(y), _t(z)))])
    want = np.stack([np.asarray(a) for a in _flat(getattr(jprism, name)(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)))])
    _close(got, want)


@pytest.mark.parametrize("nmc,ndc", [(1, 1), (1, 3), (3, 1), (3, 3)])
def test_combine_mag_tensor_matches_jax(nmc, ndc):
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(3, 3, 7, 11))
    got = tprism.combine_mag_tensor(*[tuple(_t(r) for r in row) for row in rows], MAGV, 5.0e4, nmc, ndc)
    want = jprism.combine_mag_tensor(*[tuple(jnp.asarray(r) for r in row) for row in rows], MAGV, 5.0e4, nmc, ndc)
    assert tuple(got.shape) == (7, 11, nmc, ndc)
    _close(got.numpy(), want)


def test_combine_mag_tensor_refuses_other_component_counts():
    t = (_t(np.ones(2)),) * 3
    with pytest.raises(ValueError, match="data components"):
        tprism.combine_mag_tensor(t, t, t, MAGV, 1.0, 1, 2)
    with pytest.raises(ValueError, match="model components"):
        tprism.combine_mag_tensor(t, t, t, MAGV, 1.0, 2, 1)


@pytest.mark.parametrize("incl,decl,azim", [(60.0, 10.0, 0.0), (-35.5, 200.0, 15.0), (90.0, 0.0, 0.0), (0.0, -30.0, 45.0)])
def test_dircos_matches_jax(incl, decl, azim):
    assert tprism.dircos(incl, decl, azim) == jprism.dircos(incl, decl, azim)
    assert math.isclose(sum(c * c for c in tprism.dircos(incl, decl, azim)), 1.0)


def test_subprism_bounds_match_jax():
    """The six prisms around the void of an in-cell point fill the cell
    less the void: their volumes add up."""
    c = [float(v[17]) for v in _cells()]
    xd, yd, zd, w = c[0] + 30.0, c[2] + 20.0, c[4] + 10.0, 0.1
    got = tprism._subprism_bounds(xd, yd, zd, *c, w)
    assert got == jprism._subprism_bounds(xd, yd, zd, *c, w)
    vol = sum((b[1] - b[0]) * (b[3] - b[2]) * (b[5] - b[4]) for b in got)
    assert math.isclose(vol, H[0] * H[1] * H[2] - (2 * w) ** 3, rel_tol=1e-12)


# ---------------------------------------------------------- lattice rows


FAMILIES = pytest.mark.parametrize(
    "problem,data_type,nmc,ndc",
    [("grav", 1, 1, 1), ("grav", 2, 1, 1), ("grav", 2, 1, 6),
     ("magn", 1, 1, 1), ("magn", 1, 1, 3), ("magn", 1, 3, 1), ("magn", 1, 3, 3)],
    ids=["gz", "gzz", "ftg", "tmi", "mag-3-components", "magnetization-vector", "magnetization-vector-3-components"],
)


def _lattice_rows(problem, data_type, nmc, ndc, X, Y, Z):
    edges = tmf.detect_lattice(TGrid(**_grid_dict()))
    return tmf._lattice_closed_rows(*[_t(e) for e in edges], _t(X), _t(Y), _t(Z), problem, data_type,
                                    MAGV, 5.0e4, nmc, ndc)


@FAMILIES
def test_lattice_rows_match_jax(problem, data_type, nmc, ndc):
    """Corner-lattice rows of a batch of points against the JAX rows point by
    point, a point above a lattice node among them: 1e-12 of the largest."""
    X, Y, Z = _points(np.random.default_rng(6), 4)
    got = _lattice_rows(problem, data_type, nmc, ndc, X, Y, Z)
    jedges = jmf.detect_lattice(JGrid(**_grid_dict()))
    want = np.stack([
        np.asarray(jmf._lattice_closed_rows(*[jnp.asarray(e) for e in jedges], X[p], Y[p], Z[p], problem, data_type,
                                            MAGV, 5.0e4, nmc, ndc))
        for p in range(4)
    ])
    assert tuple(got.shape) == (4, NZ, NY, NX, nmc, ndc) == want.shape
    _close(got.numpy(), want)


@FAMILIES
def test_lattice_rows_match_the_ports_percell_rows(problem, data_type, nmc, ndc):
    """The port's two builds of the same rows (summation orders differ):
    1e-11 of each row's largest entry, as the JAX package holds its own."""
    X, Y, Z = _points(np.random.default_rng(7), 4)
    lat = _lattice_rows(problem, data_type, nmc, ndc, X, Y, Z).reshape(4, -1, nmc, ndc)
    per = tsens.forward_rows(problem, data_type, nmc, ndc, MAGV, 5.0e4, False, [_t(c) for c in _cells()],
                             _t(X), _t(Y), _t(Z))
    assert per.shape == lat.shape
    scale = per.abs().amax(dim=1, keepdim=True)
    np.testing.assert_allclose((lat / scale).numpy(), (per / scale).numpy(), rtol=0, atol=1e-11)


# ----------------------------------------------------------------- build


KINDS = {
    # name: (magnetic, data_type, nmc, ndc, observations inside the grid)
    "tmi": (True, 1, 1, 1, False),
    "mag-3-components": (True, 1, 1, 3, False),
    "magnetization-vector": (True, 1, 3, 1, False),
    "borehole": (True, 1, 1, 1, True),
    "gzz": (False, 2, 1, 1, False),
    "ftg": (False, 2, 1, 6, False),
}


def _kind_problem(kind, ctype, nd=12, seed=8):
    mag, data_type, nmc, ndc, inside = KINDS[kind]
    rng = np.random.default_rng(seed)
    X, Y, Z = _points(rng, nd, inside=inside)
    kw = dict(nx=NX, ny=NY, nz=NZ, ndata=nd, compression_type=ctype, compression_rate=0.2, depth_weighting_type=1,
              nmodel_components=nmc, ndata_components=ndc)
    if mag:
        kw.update(mi=60.0, md=10.0, intensity=5.0e4)
    else:
        kw.update(data_type=data_type)
    cw = rng.uniform(1.0, 3.0, NX * NY * NZ)
    pars = (JMagParams, TMagParams) if mag else (JGravParams, TGravParams)
    return (X, Y, Z), kw, cw, pars


def _stream_both(tmp_path, kind, ctype, batch=4):
    (X, Y, Z), kw, cw, (JPar, TPar) = _kind_problem(kind, ctype)
    nd = kw["ndata"]
    out = {}
    for name, sens, cache, Par, Grid, Data, f64, f32, extra in (
        ("j", jsens, jcache, JPar, JGrid, JSurveyData, jnp.float64, jnp.float32, {}),
        ("t", tsens, tcache, TPar, TGrid, TSurveyData, torch.float64, torch.float32, {"device": "cpu"}),
    ):
        d = str(tmp_path / name)
        par, grid = Par(**kw), Grid(**_grid_dict())
        w = cache.SensitStreamWriter(d, par, grid, cw, ctype)
        chunks = []

        def sink(c, s, w=w, chunks=chunks):
            chunks.append(np.asarray(c))
            w.write_chunk(c, s)

        k = sens.compute_sensitivity(par, grid, Data(ndata=nd, X=X, Y=Y, Z=Z), cw, compute_dtype=f64,
                                     store_dtype=f32, batch_size=batch, row_sink=sink, **extra)
        w.finalize(k.comp_error)
        out[name] = (d, k, par, grid, np.concatenate(chunks))
    return out, kw, cw


@pytest.mark.parametrize("ctype", [1, 0], ids=["haar", "uncompressed"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_streamed_build_matches_jax(tmp_path, kind, ctype):
    """compute_sensitivity(row_sink=writer) in both packages, float64 built,
    float32 stored, chunks of 4 rows: the same entries kept, values within
    1e-6 of the largest (one float32 rounding of two float64 results that
    differ in their last bits), the nnz and weight files byte-equal, nnz
    equal, comp_error rtol 1e-9. The borehole case takes the per-cell rows
    in both packages. The same chunks through the port's writer give the
    JAX writer's files byte for byte."""
    out, kw, cw = _stream_both(tmp_path, kind, ctype)
    (dj, kj, parj, gridj, cj), (dt, kt, part, gridt, ct) = out["j"], out["t"]
    mag, _, nmc, ndc, _ = KINDS[kind]
    assert ct.shape == cj.shape == (kw["ndata"], ndc, nmc, NX * NY * NZ) and ct.dtype == np.float32
    np.testing.assert_array_equal(ct != 0, cj != 0)
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-6 * np.abs(cj).max())
    assert kt.nnz == kj.nnz
    np.testing.assert_allclose(kt.comp_error, kj.comp_error, rtol=1e-9, atol=0)
    sfx = "magn" if mag else "grav"
    for f in ("nnz", "weight"):
        assert filecmp.cmp(os.path.join(dj, f"sensit_{sfx}_{f}"), os.path.join(dt, f"sensit_{sfx}_{f}"), shallow=False)
    d2 = str(tmp_path / "t_of_j")
    w = tcache.SensitStreamWriter(d2, part, gridt, cw, ctype)
    w.write_chunk(cj, 0)
    w.finalize(kj.comp_error)
    for f in ("1_0", "meta.txt", "nnz", "weight"):
        assert filecmp.cmp(os.path.join(dj, f"sensit_{sfx}_{f}"), os.path.join(d2, f"sensit_{sfx}_{f}"), shallow=False), f


@pytest.mark.parametrize("kind", ["tmi", "magnetization-vector", "ftg"])
def test_dense_build_matches_jax(kind):
    """The dense build (no row sink), Haar at 0.2: (nd * ndc, nmc * N)
    float32, entries kept alike, values within 1e-6 of the largest."""
    (X, Y, Z), kw, cw, (JPar, TPar) = _kind_problem(kind, 1, seed=9)
    nd = kw["ndata"]
    kj = jsens.compute_sensitivity(JPar(**kw), JGrid(**_grid_dict()), JSurveyData(ndata=nd, X=X, Y=Y, Z=Z), cw,
                                   compute_dtype=jnp.float64, store_dtype=jnp.float32, batch_size=4)
    kt = tsens.compute_sensitivity(TPar(**kw), TGrid(**_grid_dict()), TSurveyData(ndata=nd, X=X, Y=Y, Z=Z), cw,
                                   batch_size=4, device="cpu")
    Sj, St = np.asarray(kj.S), kt.S.numpy()
    _, _, nmc, ndc, _ = KINDS[kind]
    assert St.shape == Sj.shape == (nd * ndc, nmc * NX * NY * NZ)
    np.testing.assert_array_equal(St != 0, Sj != 0)
    np.testing.assert_allclose(St, Sj, rtol=0, atol=1e-6 * np.abs(Sj).max())
    assert kt.nnz == kj.nnz


@pytest.mark.parametrize("kind", ["tmi", "mag-3-components", "magnetization-vector"])
def test_readers_of_a_magnetic_cache_equal_jax(tmp_path, kind):
    """The JAX build's magnetic cache (suffix magn, several data or model
    components) through the port's three readers and JAX's: tile packs and
    packed arrays array_equal, the dense kernels equal."""
    out, kw, _ = _stream_both(tmp_path, kind, 1)
    dj, _, parj, gridj, _ = out["j"]
    _, _, part, gridt, _ = out["t"]
    tk, tmeta = ttile.tile_kernel_from_cache(dj, part, gridt, device="cpu")
    jk, jmeta = jtile.tile_kernel_from_cache(dj, parj, gridj)
    assert tmeta["nnz"] == jmeta["nnz"]
    for f in ("uvals", "ubidx", "uvalsT", "ubidxT"):
        np.testing.assert_array_equal(getattr(tk, f).numpy(), np.asarray(getattr(jk, f)), err_msg=f)
    tp, _ = tcache.read_kernel_cache_packed(dj, part, gridt, device="cpu")
    jp, _ = jcache.read_kernel_cache_packed(dj, parj, gridj)
    for f in ("row_vals", "row_idx", "dense_cols", "dense_block", "light_cols", "light_vals", "light_idx"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), err_msg=f)
    kt = tcache.try_read_kernel_cache(dj, part, gridt, device="cpu")
    kj = jcache.try_read_kernel_cache(dj, parj, gridj)
    np.testing.assert_array_equal(kt.S.numpy(), np.asarray(kj.S))
    assert (kt.ndata_components, kt.nmodel_components) == (kj.ndata_components, kj.nmodel_components)


def test_observation_inside_grid_matches_jax():
    g = _grid_dict()
    for inside in (False, True):
        X, Y, Z = _points(np.random.default_rng(10), 6, inside=inside)
        t = tsens.observation_inside_grid(TGrid(**g), TSurveyData(ndata=6, X=X, Y=Y, Z=Z))
        j = jsens.observation_inside_grid(JGrid(**g), JSurveyData(ndata=6, X=X, Y=Y, Z=Z))
        assert t == j == inside


def test_borehole_build_takes_the_percell_rows(monkeypatch):
    """An observation inside the grid sends a magnetic build to the per-cell
    rows (the 6-subprism branch cannot share corners); without one the
    lattice rows serve, and gravity keeps the lattice either way."""
    calls = []
    orig = tsens._lattice_closed_rows
    monkeypatch.setattr(tsens, "_lattice_closed_rows", lambda *a: calls.append(a[6]) or orig(*a))
    for kind in ("borehole", "tmi"):
        (X, Y, Z), kw, cw, (_, TPar) = _kind_problem(kind, 1)
        tsens.compute_sensitivity(TPar(**kw), TGrid(**_grid_dict()), TSurveyData(ndata=12, X=X, Y=Y, Z=Z), cw,
                                  device="cpu")
    assert calls == ["magn"] * len(tsens._chunk_plan(12, 256))


@pytest.mark.parametrize("slots", [None, 3], ids=["unmeshed", "3-slot mesh"])
@pytest.mark.parametrize("problem", ["grav", "magn"])
@pytest.mark.parametrize("ctype", [0, 1], ids=["uncompressed", "haar"])
def test_observation_on_a_cell_edge_raises_in_every_build(problem, ctype, slots):
    """An observation on the grid's top face above a cell edge makes a row
    non-finite. The port raises whether or not the build compresses, and
    whether or not a mesh cuts the chunk: the rows are flagged before the
    threshold, whose mask would store the NaNs as zeros (the JAX package's
    compressed build does, PERF.md), and the flags of every part are read
    before anything reaches the sink."""
    from tomofastx_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(11)
    X, Y, Z = _points(rng, 4)
    X[2], Y[2], Z[2] = 2 * H[0], 1.5 * H[1], 0.0
    kw = dict(nx=NX, ny=NY, nz=NZ, ndata=4, compression_type=ctype, compression_rate=0.2, depth_weighting_type=1)
    par = TMagParams(**kw) if problem == "magn" else TGravParams(**kw)
    sunk = []
    with pytest.raises(FloatingPointError, match="Adjust the model grid"):
        tsens.compute_sensitivity(par, TGrid(**_grid_dict()), TSurveyData(ndata=4, X=X, Y=Y, Z=Z),
                                  np.ones(NX * NY * NZ), row_sink=lambda c, s: sunk.append(s), device="cpu",
                                  mesh=None if slots is None else make_mesh(slots, device="cpu"))
    assert sunk == []


@pytest.mark.parametrize(
    "problem,nmc,ndc,want",
    [("grav", 1, 1, 256), ("grav", 1, 6, 42), ("magn", 1, 1, 128), ("magn", 3, 3, 14), ("grav", 1, 1, 256)],
)
def test_build_chunk_is_cut_to_the_rows_bytes_on_a_card(problem, nmc, ndc, want):
    """At 64^3 cells a chunk of g_z rows stays 256 observations (every
    earlier build's); gradiometry and magnetic rows are cut to the same
    bytes, on a card as on the CPU."""
    assert tsens._build_batch(256, problem, nmc, ndc, 64 ** 3) == want
    assert tsens._build_batch(8, problem, nmc, ndc, 64 ** 3) == min(8, want)


def test_build_chunks_on_the_cpu_follow_the_jax_plan():
    """Where the rows' bytes stay under the cap (every small build) the chunk
    is the caller's batch: the build's chunks are the JAX package's
    _chunk_plan."""
    (X, Y, Z), kw, cw, (_, TPar) = _kind_problem("magnetization-vector", 1, nd=21)
    seen = []
    tsens.compute_sensitivity(TPar(**kw), TGrid(**_grid_dict()), TSurveyData(ndata=21, X=X, Y=Y, Z=Z), cw,
                              batch_size=8, row_sink=lambda c, s: seen.append((s, c.shape[0])), device="cpu")
    assert seen == jsens._chunk_plan(21, 8) == tsens._chunk_plan(21, 8)


@pytest.mark.parametrize("ctype", [0, 1], ids=["uncompressed", "haar"])
def test_build_chunk_cut_on_the_cpu_leaves_the_rows_unchanged(monkeypatch, ctype):
    """A cap under one batch of rows cuts the chunks on the CPU as on a card;
    the rows (and so the cache, which takes them in order) are the uncut
    build's, bit for bit."""
    (X, Y, Z), kw, cw, (_, TPar) = _kind_problem("magnetization-vector", ctype, nd=21)
    args = (TPar(**kw), TGrid(**_grid_dict()), TSurveyData(ndata=21, X=X, Y=Y, Z=Z), cw)
    whole = tsens.compute_sensitivity(*args, device="cpu")
    per_row = 64 * NX * NY * NZ * 3 * 1 * 2  # magnetization vector, TMI data
    monkeypatch.setattr(tsens, "BUILD_CHUNK_BYTES", 5 * per_row)
    seen = []
    cut = tsens.compute_sensitivity(*args, device="cpu", progress=lambda done, total: seen.append(done))
    assert seen == [s + n for s, n in tsens._chunk_plan(21, 5)] and len(seen) > 1
    assert torch.equal(cut.S, whole.S) and cut.nnz == whole.nnz
