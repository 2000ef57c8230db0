"""Kernel B3's wrappers (ops/lattice_matvec.py) on the CPU, where they are the
corner-lattice operator's plain chunk loop: the products equal the loop's to
the last bit for every family in float64, the float32 blend and float32
closed forms; they match the JAX package's LatticeMatrixFreeKernel; no
library is ever built; the operator is not captured into a graph; the
launch's choices (family, mode, tile, splits) are what
csrc/lattice_matvec.cu expects; the observation-sharded operator's parts,
summed, give the JAX products; and the library's build tag covers the header
the source includes. The kernels themselves run on the card only:
chip_smoke.py holds them against these plain versions there."""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tomofastx_tpu.models.grid import Grid as JGrid
from tomofastx_tpu.ops import matrixfree as jmf

from tomofastx_tpu_torch.inversion import joint as tjoint
from tomofastx_tpu_torch.models.grid import Grid as TGrid
from tomofastx_tpu_torch.ops import _cuda_build
from tomofastx_tpu_torch.ops import lattice_matvec as lm
from tomofastx_tpu_torch.ops import matrixfree as tmf
from tomofastx_tpu_torch.parallel import mesh as tmesh

from test_torch_matrixfree import grid_dict, problem, scattered

# The lattice families: "mag_vec3" is the magnetization vector with three data
# components.
FAMILIES = ["grav_gz", "grav_zz", "grav_ftg", "mag_tmi", "mag_3c", "mag_vec", "mag_vec3"]
SHAPE = {"grav_gz": (lm.GZ, 1, 1), "grav_zz": (lm.GZZ, 1, 1), "grav_ftg": (lm.FTG, 1, 6), "mag_tmi": (lm.MAG, 1, 1),
         "mag_3c": (lm.MAG, 1, 3), "mag_vec": (lm.MAG, 3, 1), "mag_vec3": (lm.MAG, 3, 3)}
SLOTS = 3


def _problem(case, g, X, Y, Z):
    jp, tp, jd, td, cw, w = problem("mag_3c" if case == "mag_vec3" else case, g, X, Y, Z)
    if case == "mag_vec3":
        jp.nmodel_components = tp.nmodel_components = 3
    return jp, tp, jd, td, cw, w


def _grid_and_points():
    """A 12 x 5 x 4 lattice (partial tiles on every axis) and 9 observations
    above it, two of them on lattice planes (x and y on cell faces)."""
    g = grid_dict(12, 5, 4)
    X, Y, Z = scattered(g, 9, 4)
    X[:2], Y[:2] = g["X1"][[3, 7]], g["Y1"][[12, 36]]
    return g, X, Y, Z


def _port_operator(case, dtype, **par_kw):
    g, X, Y, Z = _grid_and_points()
    _, tp, _, td, cw, w = _problem(case, g, X, Y, Z)
    for k, v in par_kw.items():
        setattr(tp, k, v)
    op = tmf.make_matrixfree_kernel(tp, TGrid(**g), td, cw, 1.7, w, dtype, chunk=4, validate=False, force_no_fft=True,
                                    device="cpu")
    assert isinstance(op, tmf.LatticeMatrixFreeKernel)
    return op


def _vectors(op, seed=5):
    rng = np.random.default_rng(seed)
    dt = op.xd.dtype
    return (torch.as_tensor(rng.normal(size=op.ncols), dtype=dt),
            torch.as_tensor(rng.normal(size=op.nrows * op.ndc), dtype=dt))


@pytest.fixture(scope="module", params=FAMILIES)
def jax_family(request):
    """(family, the JAX package's float64 LatticeMatrixFreeKernel products on
    the seeded vectors, x, u): one JAX build and one pair of products a
    family."""
    case = request.param
    g, X, Y, Z = _grid_and_points()
    jp, _, jd, _, cw, w = _problem(case, g, X, Y, Z)
    jo = jmf.make_matrixfree_kernel(jp, JGrid(**g), jd, cw, 1.7, w, jnp.float64, validate=False, force_no_fft=True)
    assert type(jo).__name__ == "LatticeMatrixFreeKernel"
    x, u = (v.numpy() for v in _vectors(_port_operator(case, torch.float64)))
    return case, np.asarray(jo.matvec(jnp.asarray(x))), np.asarray(jo.rmatvec(jnp.asarray(u))), x, u


MODES = {"f64": (torch.float64, {}), "f32 blend": (torch.float32, {}),
         "f32 closed": (torch.float32, {"far_field_quad": 0})}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", FAMILIES)
def test_wrappers_on_cpu_are_the_plain_loop(case, mode):
    """On CPU tensors the wrappers return the chunk loop's partial products,
    and the operator's products equal those it had before kernel B3 (the
    loop between the column and row weights) to the last bit."""
    dtype, kw = MODES[mode]
    op = _port_operator(case, dtype, **kw)
    assert op.xd.shape[0] == 12 and op.far_quad == (mode == "f32 blend")
    x, u = _vectors(op)
    xw = op.cw[None, :] * x.reshape(op.nmc, op.N)
    u_pad = op._padded_residual(u)
    assert torch.equal(lm.lattice_matvec(op, xw), op._partial_matvec(xw))
    assert torch.equal(lm.lattice_rmatvec(op, u_pad), op._partial_rmatvec(u_pad))
    before_y = (op.row_w * op._partial_matvec(xw))[: op.nrows].reshape(-1)
    before_g = (op.cw[None, :] * op._partial_rmatvec(u_pad)).reshape(-1)
    assert torch.equal(op.matvec(x), before_y) and torch.equal(op.rmatvec(u), before_g)
    assert torch.isfinite(before_y).all() and torch.isfinite(before_g).all()


def test_products_match_jax_f64(jax_family):
    """The float64 products through the wrappers against the JAX package's
    LatticeMatrixFreeKernel, to 1e-10 of max|y| (the tolerance of
    test_operator_matches_jax_f64), observations on lattice planes
    included."""
    case, yj, gj, x, u = jax_family
    op = _port_operator(case, torch.float64)
    yt, gt = op.matvec(torch.as_tensor(x)).numpy(), op.rmatvec(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-10 * np.abs(yj).max())
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-10 * np.abs(gj).max())


@pytest.mark.parametrize("case", ["grav_gz", "mag_vec3"])
def test_f32_blend_as_accurate_as_jax(case):
    """The float32 blend through the wrappers is no further from the JAX
    package's float64 products than 1.5x the JAX package's own float32
    error (the bound of test_operator_f32_blend_as_accurate_as_jax), on a
    16 x 4 x 3 lattice with the observations over one end."""
    g = grid_dict(16, 4, 3)
    X, Y, Z = scattered(dict(g, X2=g["X2"] / 4), 6, 6)
    jp, tp, jd, td, cw, w = _problem(case, g, X, Y, Z)
    j64, j32 = (jmf.make_matrixfree_kernel(jp, JGrid(**g), jd, cw, 1.7, w, dt, validate=False, force_no_fft=True)
                for dt in (jnp.float64, jnp.float32))
    t32 = tmf.make_matrixfree_kernel(tp, TGrid(**g), td, cw, 1.7, w, torch.float32, validate=False, force_no_fft=True,
                                     device="cpu")
    assert t32.far_quad and lm.launch_plan(t32)["mode"] == lm.BLEND
    rng = np.random.default_rng(4)
    x, u = rng.normal(size=t32.ncols), rng.normal(size=t32.nrows * t32.ndc)
    ref = [np.asarray(f(jnp.asarray(v)), np.float64) for f, v in ((j64.matvec, x), (j64.rmatvec, u))]
    jax32 = [np.asarray(f(jnp.asarray(v, jnp.float32)), np.float64) for f, v in ((j32.matvec, x), (j32.rmatvec, u))]
    port32 = [f(torch.as_tensor(v, dtype=torch.float32)).double().numpy() for f, v in ((t32.matvec, x), (t32.rmatvec, u))]
    for r, a, b in zip(ref, jax32, port32):
        err_jax, err_port = (np.linalg.norm(v - r) / np.linalg.norm(r) for v in (a, b))
        assert err_port <= 1.5 * err_jax, (err_port, err_jax)


def test_cpu_products_never_build_the_library(monkeypatch):
    """A CPU tensor never reaches nvcc or the loader, and never counts as a
    launch."""

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA library was asked for on the CPU")

    monkeypatch.setattr(_cuda_build, "build_library", refuse)
    monkeypatch.setattr(_cuda_build, "load_library", refuse)
    launches = (lm.lattice_matvec.launches, lm.lattice_rmatvec.launches)
    for dtype in (torch.float64, torch.float32):
        op = _port_operator("mag_vec", dtype)
        x, u = _vectors(op)
        assert torch.isfinite(op.matvec(x)).all() and torch.isfinite(op.rmatvec(u)).all()
    assert (lm.lattice_matvec.launches, lm.lattice_rmatvec.launches) == launches


def test_not_captured_on_the_cpu():
    """graph_capturable is false for the operator and its observation-
    sharded form on CPU slots, and capture_unit says cpu; the log names the
    plain loop."""
    op = _port_operator("grav_gz", torch.float32)
    ks = tmesh.shard_kernel(op, tmesh.make_mesh(SLOTS, device="cpu"))
    assert op.graph_capturable is False and ks.graph_capturable is False
    assert all(p.graph_capturable is False for p in ks.parts)
    for S in (op, ks):
        assert tjoint.capture_unit({"cw": (op.cw,), "S": (S,)}) == ("cpu", "eager steps on the CPU")
    assert op.products_by == "the plain chunk loop on the CPU"


@pytest.mark.parametrize("case", FAMILIES)
def test_launch_plan_by_family_type_and_mode(case):
    """Family, shape, tile, field and mode of each operator: the float64
    operator and a float32 one with tpu.farFieldQuad = 0 evaluate the closed
    forms, the float32 blend blends on its windows (int32 starts); the scale
    is combine_mag_tensor's over 4 pi."""
    family, nmc, ndc = SHAPE[case]
    ops = {name: _port_operator(case, dt, **kw) for name, (dt, kw) in MODES.items()}
    for name, op in ops.items():
        plan = lm.launch_plan(op)
        assert (plan["family"], plan["nmc"], plan["ndc"]) == (family, nmc, ndc)
        assert plan["mode"] == (lm.BLEND if name == "f32 blend" else lm.CLOSED)
        assert plan["is_double"] == (name == "f64")
        assert plan["tile"] == ((4 if nmc * ndc > 6 else 8), 8, 8) == lm.tile_shape(nmc, ndc)
        if name == "f32 blend":
            assert op.wi0.dtype == torch.int32 and plan["window"] == tuple(op.win) and min(op.win) > 0
        else:
            assert plan["window"] == (0, 0, 0) and op.wi0 is None
        if family == lm.MAG:
            scale = 50000.0 if nmc == 1 else 4.0e-7 * np.pi * 1.0e9
            assert plan["s4pi"] == pytest.approx(scale / (4.0 * np.pi), rel=1e-15)
            assert np.linalg.norm(plan["magv"]) == pytest.approx(1.0, rel=1e-12)


@pytest.mark.parametrize("case", ["mag_tmi", "mag_vec"])
def test_borehole_survey_takes_the_per_cell_operator(case):
    """A magnetic survey with an observation inside the lattice grid (the
    borehole branch, which kernel B3 does not compute) gets the per-cell
    operator with its borehole rows, never the lattice one."""
    g, X, Y, Z = _grid_and_points()
    Z = Z.copy()
    Z[4] = 0.5 * (g["Z1"].min() + g["Z2"].max())
    _, tp, _, td, cw, w = _problem(case, g, X, Y, Z)
    op = tmf.make_matrixfree_kernel(tp, TGrid(**g), td, cw, 1.7, w, torch.float32, chunk=4, validate=False,
                                    force_no_fft=True, device="cpu")
    assert isinstance(op, tmf.MatrixFreeKernel) and op.phys.handle_inside


def test_launch_plan_refuses_what_the_kernels_do_not_take():
    """A bfloat16 operator, a float64 blend, a blend without int32 windows
    and rows of a shape no family has raise; the wrappers refuse a device
    that is neither the card nor the CPU."""
    op = _port_operator("mag_tmi", torch.float32)
    with pytest.raises(TypeError, match="float32 or float64"):
        lm.launch_plan(dataclasses.replace(op, xd=op.xd.bfloat16()))
    op64 = _port_operator("grav_gz", torch.float64)
    with pytest.raises(ValueError, match="blend"):
        lm.launch_plan(dataclasses.replace(op64, far_quad=True, win=op.win, wi0=op.wi0))
    with pytest.raises(ValueError, match="windows"):
        lm.launch_plan(dataclasses.replace(op, wi0=op.wi0.long()))
    with pytest.raises(ValueError, match="windows"):
        lm.launch_plan(dataclasses.replace(op, win=None))
    with pytest.raises(ValueError, match="data components"):
        lm.launch_plan(dataclasses.replace(op64, data_type=2, ndc=3))
    with pytest.raises(ValueError, match="cuda or cpu"):
        lm.lattice_matvec(op, torch.zeros((1, op.N), device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        lm.lattice_rmatvec(op, torch.zeros((op.xd.shape[0], 1), device="meta"))


@pytest.mark.parametrize("nrows, n, nv", [
    (4096, (64, 64, 64), 1), (4096, (64, 64, 64), 9), (512, (64, 64, 64), 6), (12, (4, 5, 12), 1),
    (12, (4, 5, 12), 9), (16384, (64, 128, 128), 1), (1, (1, 1, 1), 1), (130, (9, 17, 33), 3),
])
def test_tiles_and_splits_cover_every_cell_and_observation_once(nrows, n, nv):
    """The kernels' grid: the tiles of tile_shape cover every cell of the
    lattice exactly once, the observation splits (whole staged batches)
    every observation once, with about TARGET_BLOCKS blocks where there is
    work for them; the smoke's shape takes 512 tiles and 4 splits of 1024
    observations."""
    nmc, ndc = (3, 3) if nv == 9 else (1, nv)
    nz, ny, nx = n
    op = dataclasses.replace(_port_operator("grav_gz", torch.float64), nx=nx, ny=ny, nz=nz, nmc=nmc, ndc=ndc)
    tz, ty, tx = lm.tile_shape(nmc, ndc)
    tiles = lm.n_tiles(op)
    count = np.zeros((nz, ny, nx), int)
    ntx, nty = -(-nx // tx), -(-ny // ty)
    for t in range(tiles):  # csrc/lattice_matvec.cu: blockIdx.x -> the tile's origin
        z0, y0, x0 = (t // (ntx * nty)) * tz, ((t // ntx) % nty) * ty, (t % ntx) * tx
        count[z0 : z0 + tz, y0 : y0 + ty, x0 : x0 + tx] += 1
    assert (count == 1).all()
    splits, per = lm.obs_splits(nrows, tiles)
    assert per % lm.BATCH == 0 and splits * per >= nrows > (splits - 1) * per
    assert splits * tiles <= lm.TARGET_BLOCKS + tiles or splits == 1
    if -(-nrows // lm.BATCH) >= -(-lm.TARGET_BLOCKS // tiles):
        assert splits * tiles >= lm.TARGET_BLOCKS // 2
    if (nrows, n, nv) == (4096, (64, 64, 64), 1):
        assert (tiles, splits, per) == (512, 4, 1024)


@pytest.mark.parametrize("nrows, n, far_quad, want", [
    (4096, (64, 64, 64), True, ((512 + 1) * 4096 * 8, (4 + 1) * 262144 * 8)),
    (4096, (64, 64, 64), False, (512 * 4096 * 8, 4 * 262144 * 8)),
    (2032, (100, 200, 200), True, ((13 * 25 * 25 + 1) * 2032 * 8, 2 * 4_000_000 * 8)),
    (2032, (200, 400, 400), True, ((25 * 50 * 50 + 1) * 2032 * 8, 2 * 32_000_000 * 8)),
])
def test_partial_bytes_of_a_product(nrows, n, far_quad, want):
    """The float64 partial sums one product of kernel B3 allocates: a slot a
    cell tile of the padded rows for the matvec, a slot a split of the
    observations of the cells for the rmatvec, each with one more for the
    blend's near pass; the smoke's shape and the 4M- and 32M-cell rungs'
    (1.016 GB for the 32M-cell matvec). The operator's partial_nbytes is the
    larger."""
    nz, ny, nx = n
    base = _port_operator("grav_gz", torch.float32 if far_quad else torch.float64)
    op = dataclasses.replace(base, nx=nx, ny=ny, nz=nz, far_quad=far_quad,
                             xd=torch.zeros(nrows, dtype=base.xd.dtype))
    assert lm.partial_bytes(op) == want
    assert op.partial_nbytes == max(want)


def test_sharded_parts_against_jax(jax_family):
    """The observation-sharded lattice operator over 3 CPU slots (12
    observations padded to 4 a slot): each part's rows through the
    wrappers, the matvec's concatenated and the rmatvec's summed, give the
    JAX package's products to 1e-10 of max|y|."""
    case, yj, gj, x, u = jax_family
    op = _port_operator(case, torch.float64)
    ks = tmesh.shard_kernel(op, tmesh.make_mesh(SLOTS, device="cpu"))
    assert [p.xd.shape[0] for p in ks.parts] == [4] * SLOTS
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    np.testing.assert_allclose(ks.matvec(xt).numpy(), yj, rtol=0, atol=1e-10 * np.abs(yj).max())
    np.testing.assert_allclose(ks.rmatvec(ut).numpy(), gj, rtol=0, atol=1e-10 * np.abs(gj).max())
    xw = op.cw[None, :] * xt.reshape(op.nmc, op.N)
    u_pad = torch.zeros((4 * SLOTS, op.ndc), dtype=torch.float64)
    u_pad[: op.nrows] = ut.reshape(op.nrows, op.ndc)
    ys, gs = [], 0.0
    for s, p in enumerate(ks.parts):
        ys.append(p.row_w * lm.lattice_matvec(p, xw))
        gs = gs + p.cw[None, :] * lm.lattice_rmatvec(p, u_pad[4 * s : 4 * (s + 1)] * p.row_w)
    y = torch.cat(ys)[: op.nrows].reshape(-1).numpy()
    np.testing.assert_allclose(y, yj, rtol=0, atol=1e-10 * np.abs(yj).max())
    np.testing.assert_allclose(gs.reshape(-1).numpy(), gj, rtol=0, atol=1e-10 * np.abs(gj).max())


def test_build_tag_covers_the_included_header(tmp_path, monkeypatch):
    """The library's name hashes the .cu source and the csrc/ headers it
    includes, directly or through another header: an edit of the shared
    header renames kernel B3's library and both of B2's (its float32 and
    float64 sources include it through prism_matvec.cuh), an edit of B2's
    own header renames B2's two and not B3's, and an edit of another source
    renames only its own."""
    pkg = tmp_path / "pkg"
    shutil.copytree(os.path.join(os.path.dirname(_cuda_build.source_path("lattice_matvec"))), pkg / "csrc")
    monkeypatch.setattr(_cuda_build, "_PACKAGE_DIR", str(pkg))
    files = [os.path.basename(f) for f in _cuda_build.source_files("lattice_matvec")]
    assert files == ["lattice_matvec.cu", "prism_common.cuh"]
    for name in ("prism_matvec_f32", "prism_matvec_f64"):
        assert [os.path.basename(f) for f in _cuda_build.source_files(name)] == [f"{name}.cu", "prism_matvec.cuh",
                                                                                 "prism_common.cuh"]
    names = ("lattice_matvec", "prism_matvec_f32", "prism_matvec_f64", "tile_matvec")
    before = {n: _cuda_build.source_tag(n) for n in names}
    with open(pkg / "csrc" / "prism_common.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _cuda_build.source_tag(n) for n in names}
    assert all(after[n] != before[n] for n in names[:3])
    assert after["tile_matvec"] == before["tile_matvec"]
    with open(pkg / "csrc" / "prism_matvec.cuh", "a") as f:
        f.write("// edited\n")
    again = {n: _cuda_build.source_tag(n) for n in names}
    assert again["prism_matvec_f32"] != after["prism_matvec_f32"] and again["prism_matvec_f64"] != after["prism_matvec_f64"]
    assert again["lattice_matvec"] == after["lattice_matvec"]
    with open(pkg / "csrc" / "tile_matvec.cu", "a") as f:
        f.write("// edited\n")
    assert _cuda_build.source_tag("lattice_matvec") == after["lattice_matvec"]
    assert _cuda_build.source_tag("tile_matvec") != before["tile_matvec"]
