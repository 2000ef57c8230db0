"""Kernel B2's wrappers (ops/prism_matvec.py) on the CPU, where they are the
per-cell operator's plain chunk loop: the products equal the loop's to the
last bit for every family in float64 and float32, no library is ever built,
the operator is not captured into a graph, the launch's choices (family,
mode, splits) are what csrc/prism_matvec.cu expects, and the cells-sharded
operator's parts, each from its own cell_lo, give the JAX package's
MatrixFreeKernel products. The kernels themselves run on the card only:
chip_smoke.py holds them against these plain versions there."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tomofastx_tpu.models.grid import Grid as JGrid
from tomofastx_tpu.ops import matrixfree as jmf

from tomofastx_tpu_torch.inversion import joint as tjoint
from tomofastx_tpu_torch.models.grid import Grid as TGrid
from tomofastx_tpu_torch.ops import _cuda_build
from tomofastx_tpu_torch.ops import matrixfree as tmf
from tomofastx_tpu_torch.ops import prism_matvec as pm
from tomofastx_tpu_torch.parallel import mesh as tmesh

from test_torch_matrixfree import grid_dict, problem, scattered

# The per-cell families; "borehole" is TMI with the observations inside the grid.
FAMILIES = ["grav_gz", "grav_zz", "grav_ftg", "mag_tmi", "mag_3c", "mag_vec", "borehole"]
SLOTS = 3


def _points(case, g):
    X, Y, Z = scattered(g, 9, 4)
    if case == "borehole":
        Z = 60.0 + 7.3 * np.arange(9)  # inside the second and third layers, off their faces
    return X, Y, Z


def _port_operator(case, dtype, pad_cells_to=1, **par_kw):
    g = grid_dict(6, 5, 4, topography=True)
    X, Y, Z = _points(case, g)
    _, tp, _, td, cw, w = problem("mag_tmi" if case == "borehole" else case, g, X, Y, Z)
    for k, v in par_kw.items():
        setattr(tp, k, v)
    return tmf.make_matrixfree_kernel(tp, TGrid(**g), td, cw, 1.7, w, dtype, chunk=4, pad_cells_to=pad_cells_to,
                                      validate=False, device="cpu")


def _vectors(op, seed=5):
    rng = np.random.default_rng(seed)
    dt = op.xd.dtype
    return (torch.as_tensor(rng.normal(size=op.ncols), dtype=dt),
            torch.as_tensor(rng.normal(size=op.nrows * op.phys.ndc), dtype=dt))


@pytest.fixture(scope="module", params=FAMILIES)
def jax_family(request):
    """(family, the JAX package's float64 MatrixFreeKernel products on the
    seeded vectors, x, u): one JAX build and one pair of products a family."""
    case = request.param
    g = grid_dict(6, 5, 4, topography=True)
    X, Y, Z = _points(case, g)
    jp, _, jd, _, cw, w = problem("mag_tmi" if case == "borehole" else case, g, X, Y, Z)
    jo = jmf.make_matrixfree_kernel(jp, JGrid(**g), jd, cw, 1.7, w, jnp.float64, validate=False)
    to = _port_operator(case, torch.float64)
    assert type(jo).__name__ == "MatrixFreeKernel" and jo.phys.handle_inside == to.phys.handle_inside
    x, u = (v.numpy() for v in _vectors(to))
    return case, np.asarray(jo.matvec(jnp.asarray(x))), np.asarray(jo.rmatvec(jnp.asarray(u))), x, u


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", FAMILIES)
def test_wrappers_on_cpu_are_the_plain_loop(case, dtype):
    """On CPU tensors the wrappers return the chunk loop's partial products,
    and the operator's products equal those it had before kernel B2 (the
    loop between the column and row weights) to the last bit."""
    op = _port_operator(case, dtype, pad_cells_to=7)
    assert op.N == 126 and op.xd.shape[0] == 12 and op.phys.far_quad == (dtype == torch.float32)
    x, u = _vectors(op)
    xw = op.cw[None, :] * op._padded_model(x)
    u_pad = op._padded_residual(u)
    assert torch.equal(pm.prism_matvec(op, xw), op._partial_matvec(xw))
    assert torch.equal(pm.prism_rmatvec(op, u_pad), op._partial_rmatvec(u_pad))
    before_y = (op.row_w * op._partial_matvec(xw))[: op.nrows].reshape(-1)
    before_g = (op.cw[None, :] * op._partial_rmatvec(u_pad))[:, : op.N_true].reshape(-1)
    assert torch.equal(op.matvec(x), before_y) and torch.equal(op.rmatvec(u), before_g)


def test_cpu_products_never_build_the_library(monkeypatch):
    """A CPU tensor never reaches nvcc or the loader, and never counts as a
    launch."""

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA library was asked for on the CPU")

    monkeypatch.setattr(_cuda_build, "build_library", refuse)
    monkeypatch.setattr(_cuda_build, "load_library", refuse)
    launches = (pm.prism_matvec.launches, pm.prism_rmatvec.launches)
    for dtype in (torch.float64, torch.float32):
        op = _port_operator("mag_vec", dtype)
        x, u = _vectors(op)
        assert torch.isfinite(op.matvec(x)).all() and torch.isfinite(op.rmatvec(u)).all()
    assert (pm.prism_matvec.launches, pm.prism_rmatvec.launches) == launches


def test_not_captured_on_the_cpu():
    """graph_capturable is false for the operator and its cells-sharded form
    on CPU slots, and capture_unit says cpu; the log names the plain loop."""
    op = _port_operator("grav_gz", torch.float32, pad_cells_to=SLOTS)
    ks = tmesh.shard_kernel(op, tmesh.make_mesh(SLOTS, device="cpu"))
    assert op.graph_capturable is False and ks.graph_capturable is False
    assert all(p.graph_capturable is False for p in ks.parts)
    for S in (op, ks):
        assert tjoint.capture_unit({"cw": (op.cw,), "S": (S,)}) == ("cpu", "eager steps on the CPU")
    assert op.products_by == "the plain chunk loop on the CPU"


def test_sharded_parts_against_jax(jax_family):
    """The cells-sharded per-cell operator over 3 CPU slots (6 x 5 x 4 = 120
    cells, 40 a slot) against the JAX package's
    MatrixFreeKernel: each part's gradient is the JAX gradient's columns
    from its own cell_lo, and the summed products are JAX's, float64 to
    1e-10 of max|y|."""
    case, yj, gj, x, u = jax_family
    op = _port_operator(case, torch.float64, pad_cells_to=SLOTS)
    ks = tmesh.shard_kernel(op, tmesh.make_mesh(SLOTS, device="cpu"))
    assert [p.cell_lo for p in ks.parts] == [0, 40, 80] and all(p.N == 40 for p in ks.parts)
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    yt, gt = ks.matvec(xt).numpy(), ks.rmatvec(ut).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-10 * np.abs(yj).max())
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-10 * np.abs(gj).max())
    nmc = op.phys.nmc
    u_pad = op._padded_residual(ut)
    for p in ks.parts:
        part = (p.cw[None, :] * pm.prism_rmatvec(p, u_pad)).numpy()
        want = gj.reshape(nmc, -1)[:, p.cell_lo : p.cell_lo + p.N]
        np.testing.assert_allclose(part, want, rtol=0, atol=1e-10 * np.abs(gj).max())


@pytest.mark.parametrize("case, family, shape", [
    ("grav_gz", pm.GZ, (1, 1)), ("grav_zz", pm.GZZ, (1, 1)), ("grav_ftg", pm.FTG, (1, 6)),
    ("mag_tmi", pm.MAG, (1, 1)), ("mag_3c", pm.MAG, (1, 3)), ("mag_vec", pm.MAG, (3, 1)), ("borehole", pm.MAG, (1, 1)),
])
def test_launch_plan_by_family_and_type(case, family, shape):
    """Family, shape, field and mode of each operator: the float64 operator
    and a float32 one with tpu.farFieldQuad = 0 evaluate the closed forms,
    the float32 blend blends; the scale is combine_mag_tensor's over 4 pi."""
    ops = {
        "f64": _port_operator(case, torch.float64),
        "f32": _port_operator(case, torch.float32),
        "f32 closed": _port_operator(case, torch.float32, far_field_quad=0),
    }
    for name, op in ops.items():
        plan = pm.launch_plan(op)
        assert (plan["family"], plan["nmc"], plan["ndc"]) == (family, *shape)
        assert plan["mode"] == (pm.BLEND if name == "f32" else pm.CLOSED)
        assert plan["is_double"] == (name == "f64")
        assert plan["handle_inside"] == op.phys.handle_inside and (case != "borehole" or plan["handle_inside"])
        if family == pm.MAG:
            scale = 50000.0 if shape[0] == 1 else 4.0e-7 * np.pi * 1.0e9
            assert plan["s4pi"] == pytest.approx(scale / (4.0 * np.pi), rel=1e-15)
            assert np.linalg.norm(plan["magv"]) == pytest.approx(1.0, rel=1e-12)


def test_launch_plan_refuses_what_the_kernels_do_not_take():
    """A blend without its near candidates, a float64 blend, and rows of a
    shape no family has raise; the wrappers refuse a device that is neither
    the card nor the CPU."""
    op = _port_operator("grav_gz", torch.float32)
    with pytest.raises(ValueError, match="near candidates"):
        pm.launch_plan(dataclasses.replace(op, near_idx=None))
    op64 = _port_operator("grav_gz", torch.float64)
    with pytest.raises(ValueError, match="blend"):
        pm.launch_plan(dataclasses.replace(op64, phys=dataclasses.replace(op64.phys, far_quad=True),
                                               near_idx=op.near_idx))
    with pytest.raises(ValueError, match="data components"):
        pm.launch_plan(dataclasses.replace(op64, phys=dataclasses.replace(op64.phys, data_type=2, ndc=3)))
    x = torch.zeros((1, op.N), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pm.prism_matvec(op, x)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pm.prism_rmatvec(op, torch.zeros((op.xd.shape[0], 1), device="meta"))


@pytest.mark.parametrize("nrows, N", [(4096, 262144), (512, 262144), (546, 262144), (12, 126), (4096, 65536),
                                      (16384, 1048576), (1, 1), (130, 129)])
def test_matvec_splits_cover_every_cell_once(nrows, N):
    """The matvec's splits: whole staged tiles of THREADS cells, every cell
    in exactly one split, and about TARGET_BLOCKS blocks where there are
    cells for them; the smoke's shape takes 64 splits of 4096 cells."""
    splits, per = pm.matvec_splits(nrows, N)
    assert per % pm.THREADS == 0 and splits * per >= N > (splits - 1) * per
    tiles = -(-nrows // pm.THREADS)
    assert splits * tiles <= pm.TARGET_BLOCKS + tiles or splits == 1
    if N >= pm.TARGET_BLOCKS * pm.THREADS:
        assert splits * tiles >= pm.TARGET_BLOCKS // 2
    if (nrows, N) == (4096, 262144):
        assert (splits, per) == (64, 4096)
