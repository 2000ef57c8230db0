"""Port parity for the mesh path: the port's single-process mesh of CPU slots
against the JAX package on its 8-device CPU mesh (tests/conftest.py). The
mesh itself, the padding helpers, the sharded tile contraction (kernel A2,
through its plain version here: the CUDA kernel cannot run without the card,
chip_smoke.py holds it there), the sharded dense and packed operators, the
row-sharded build, whole solves with mesh= and the CLI's --mesh. Inputs are
made with numpy from a seed; JAX x64 against torch float64 unless stated."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tomofastx_tpu.config.parfile import GravParams as JGravParams
from tomofastx_tpu.config.parfile import parse_parfile_lines as jparse
from tomofastx_tpu.inversion.workflow import solve_problem_joint_gravmag as jsolve
from tomofastx_tpu.models.data import SurveyData as JSurveyData
from tomofastx_tpu.models.grid import Grid as JGrid
from tomofastx_tpu.ops import sensitivity as jsens
from tomofastx_tpu.ops import sparse_kernel as jsparse
from tomofastx_tpu.ops import tile_kernel as jtile
from tomofastx_tpu.parallel import mesh as jmesh

from tomofastx_tpu_torch import convert
from tomofastx_tpu_torch.config.parfile import GravParams as TGravParams
from tomofastx_tpu_torch.config.parfile import parse_parfile_lines as tparse
from tomofastx_tpu_torch.inversion import workflow as twf
from tomofastx_tpu_torch.io import sensit_cache as tcache
from tomofastx_tpu_torch.models.data import SurveyData as TSurveyData
from tomofastx_tpu_torch.models.grid import Grid as TGrid
from tomofastx_tpu_torch.ops import sensitivity as tsens
from tomofastx_tpu_torch.ops import sparse_kernel as tsparse
from tomofastx_tpu_torch.ops import tile_kernel as ttile
from tomofastx_tpu_torch.ops import tile_matvec as tmv
from tomofastx_tpu_torch.parallel import mesh as tmesh

from test_torch_formats import _problem
from test_torch_workflow import _costs, _run, _write_problem

TILE_FIELDS = ("uvals", "ubidx", "uvalsT", "ubidxT")
PACKED_FIELDS = ("row_vals", "row_idx", "dense_cols", "dense_block", "light_cols", "light_vals", "light_idx")


def _sparse(rng, nrows, ncols, keep=0.2, dtype=np.float64):
    S = rng.normal(size=(nrows, ncols)).astype(dtype)
    S[rng.random(S.shape) > keep] = 0.0
    return S


# ---------------------------------------------------------------- the mesh


@pytest.mark.parametrize(
    "spec,names,shape", [(8, ("cells",), (8,)), ((2, 4), ("obs", "cells"), (2, 4)),
                         ("2x4", ("obs", "cells"), (2, 4)), ("8", ("cells",), (8,)), ("3", ("cells",), (3,))],
)
def test_make_mesh_specs(spec, names, shape):
    """A count, a (no, nc) tuple and an "RxC" string give the JAX package's
    axes and shape; on the CPU every slot is the CPU."""
    m = tmesh.make_mesh(spec, device="cpu")
    j = jmesh.make_mesh(spec)
    assert m.axis_names == j.axis_names == names
    assert m.devices.shape == j.devices.shape == shape
    assert m.slots == [torch.device("cpu")] * j.devices.size and m.home == torch.device("cpu")
    assert tmesh.obs_axis(m) == jmesh.obs_axis(j)


def test_make_mesh_refuses_more_cards_than_there_are():
    """On cuda a mesh takes distinct cards and never fewer: one slot more
    than the machine has cards (two on a machine without any) raises."""
    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="CUDA devices"):
        tmesh.make_mesh(n, device="cuda")
    with pytest.raises(ValueError, match="at least one slot"):
        tmesh.make_mesh((0, 4), device="cpu")


def test_a_mesh_takes_any_devices():
    """Mesh itself accepts repeated devices (several slots on one card, as
    chip_smoke.py makes them) and refuses axes that do not fit its shape."""
    m = tmesh.Mesh(np.array(["cpu"] * 4, dtype=object), ("cells",))
    assert m.slots == [torch.device("cpu")] * 4 and m.devices.shape == (4,)
    with pytest.raises(ValueError):
        tmesh.Mesh(np.array(["cpu"] * 4, dtype=object).reshape(2, 2), ("cells",))


# ---------------------------------------------------------------- padding


@pytest.mark.parametrize("n", [3, 8])
def test_pad_tiles_for_mesh_equals_jax(n):
    S = _sparse(np.random.default_rng(13), 27, 333, dtype=np.float32)
    jk = jtile.pad_tiles_for_mesh(jtile.pack_tiles(S), n)
    tk = ttile.pad_tiles_for_mesh(ttile.pack_tiles(S, device="cpu"), n)
    for f in TILE_FIELDS:
        a, b = getattr(tk, f).numpy(), np.asarray(getattr(jk, f))
        assert a.dtype == b.dtype and a.shape[0] % n == 0
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (tk.nrows, tk.ncols) == (jk.nrows, jk.ncols)
    same = ttile.pack_tiles(np.eye(16, 256, dtype=np.float32), device="cpu")
    assert ttile.pad_tiles_for_mesh(same, 2) is same  # 2 tiles each way: divides


@pytest.mark.parametrize("multiple", [3, 8])
def test_pad_dense_columns_and_rows_equal_jax(multiple):
    rng = np.random.default_rng(3)
    S = rng.normal(size=(13, 105))
    jk = jsparse.DenseKernel(jnp.asarray(S), jnp.asarray(S.T.copy()))
    tk = convert.dense_kernel_from_numpy(S, S.T.copy(), device="cpu")
    for pad in ("pad_dense_columns", "pad_dense_rows"):
        jp, tp = getattr(jsparse, pad)(jk, multiple), getattr(tsparse, pad)(tk, multiple)
        np.testing.assert_array_equal(tp.S.numpy(), np.asarray(jp.S), err_msg=pad)
        np.testing.assert_array_equal(tp.ST.numpy(), np.asarray(jp.ST), err_msg=pad)
        assert (tp.ncols_true, tp.nrows_true, tp.nrows, tp.ncols) == (jp.ncols_true, jp.nrows_true, jp.nrows, jp.ncols)
    both = tsparse.pad_dense_rows(tsparse.pad_dense_columns(tk, multiple), multiple)
    assert tsparse.pad_dense_columns(both, multiple) is both


@pytest.mark.parametrize("n", [3, 8])
def test_pad_packed_for_mesh_equals_jax(n):
    S = _sparse(np.random.default_rng(11), 24, 333)
    jk = jsparse.pad_packed_for_mesh(jsparse.pack_dense(S), n)
    tk = tsparse.pad_packed_for_mesh(tsparse.pack_dense(S, device="cpu"), n)
    for f in PACKED_FIELDS:
        a, b = getattr(tk, f).numpy(), np.asarray(getattr(jk, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (tk.nrows, tk.ncols) == (jk.nrows, jk.ncols)


# ---------------------------------------------------------------- kernel A2


def _tile_pair(seed, nrows, ncols):
    """The same tile-union pack in both packages, and both sharded over 8."""
    S = _sparse(np.random.default_rng(seed), nrows, ncols, dtype=np.float32)
    jk = jtile.pack_tiles(S)
    tk = convert.tile_kernel_from_numpy(*[np.asarray(getattr(jk, f)) for f in TILE_FIELDS], nrows, ncols, device="cpu")
    return jk, tk, jmesh.make_mesh(8), tmesh.make_mesh(8, device="cpu")


# The fixtures of test_sharding.py: 27 x 333 (4 and 42 tiles, neither divides
# 8) and 61 x 640.
A2_CASES = pytest.mark.parametrize("seed,nrows,ncols", [(13, 27, 333), (17, 61, 640)], ids=["27x333", "61x640"])


@A2_CASES
@pytest.mark.parametrize("direction", ["forward", "adjoint"])
def test_sharded_tile_contraction_matches_jax_shard_map_pallas(seed, nrows, ncols, direction):
    """The port's A2 on an 8-slot CPU mesh against
    TileKernel._shard_map_pallas(interpret=True) on make_mesh(8), float32
    vectors, 1e-5 (as test_sharding.py); and equal bit for bit to the port's
    unsharded contraction."""
    jk, tk, jm, tm = _tile_pair(seed, nrows, ncols)
    jks, tks = jmesh.shard_kernel(jk, jm), tmesh.shard_kernel(tk, tm)
    assert len(tks.parts) == len(tks.partsT) == 8
    assert {p[0].shape[0] for p in tks.parts} == {jks.uvals.shape[0] // 8}
    n_in, n_out = (ncols, nrows) if direction == "forward" else (nrows, ncols)
    v = np.random.default_rng(seed + 1).normal(size=n_in).astype(np.float32)
    vpad = np.pad(v, (0, (-n_in) % 128))
    uv, ub = (jks.uvals, jks.ubidx) if direction == "forward" else (jks.uvalsT, jks.ubidxT)
    with jm:
        want = np.asarray(jks._shard_map_pallas(uv, ub, jnp.asarray(vpad), interpret=True))[:n_out]
    op = "matvec" if direction == "forward" else "rmatvec"
    got = getattr(tks, op)(torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, getattr(tk, op)(torch.from_numpy(v)))


@A2_CASES
@pytest.mark.parametrize("direction", ["forward", "adjoint"])
def test_sharded_tile_contraction_f64_matches_jax_sharded_kernel(seed, nrows, ncols, direction):
    """float64 vectors: the JAX Pallas body accumulates in float32, so the
    reference is its sharded TileKernel's float64 contraction (GSPMD over the
    same 8-device tile split), 1e-12; the port's sharded result equals its
    unsharded one bit for bit."""
    jk, tk, jm, tm = _tile_pair(seed, nrows, ncols)
    jks, tks = jmesh.shard_kernel(jk, jm), tmesh.shard_kernel(tk, tm)
    n_in = ncols if direction == "forward" else nrows
    v = np.random.default_rng(seed + 2).normal(size=n_in)
    op = "matvec" if direction == "forward" else "rmatvec"
    with jm:
        want = np.asarray(jax.jit(lambda k, x: getattr(k, op)(x))(jks, jnp.asarray(v)))
    got = getattr(tks, op)(torch.from_numpy(v))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    assert torch.equal(got, getattr(tk, op)(torch.from_numpy(v)))


def test_tile_matvec_sharded_on_cpu_parts_is_its_plain_version():
    """On CPU parts the wrapper takes the plain version and counts no launch;
    the gather is in part order; ragged parts of any length work."""
    rng = np.random.default_rng(5)
    uv = torch.from_numpy(rng.normal(size=(11, 7, 8, 128)).astype(np.float32))
    ub = torch.from_numpy(rng.integers(0, 5, size=(11, 7)).astype(np.int32))
    x = torch.from_numpy(rng.normal(size=5 * 128))
    parts = [(uv[:4], ub[:4].clone()), (uv[4:5], ub[4:5].clone()), (uv[5:], ub[5:].clone())]
    before = tmv.tile_matvec_sharded.launches
    got = tmv.tile_matvec_sharded(parts, x, "cpu")
    assert tmv.tile_matvec_sharded.launches == before
    assert torch.equal(got, tmv.tile_matvec_sharded_plain(parts, x, "cpu"))
    assert torch.equal(got, tmv.tile_matvec(uv, ub, x))
    with pytest.raises(ValueError, match="ubidx"):
        tmv.tile_matvec_sharded([(uv[:4], ub[:3].clone())], x, "cpu")


# ---------------------------------------------------------------- dense and packed


@pytest.mark.parametrize("spec", [8, (2, 4)], ids=["8", "2x4"])
def test_sharded_dense_kernel_matches_jax(spec):
    """DenseKernel over 8 cells slots and over a 2x4 obs x cells mesh: the
    blocks are the JAX package's shards (16 x 105 padded to 16 x 112), and the
    products agree with JAX's shard_kernel at 1e-12 (float64)."""
    rng = np.random.default_rng(3)
    S = rng.normal(size=(15, 105))  # neither axis divides the mesh
    jm, tm = jmesh.make_mesh(spec), tmesh.make_mesh(spec, device="cpu")
    jks = jmesh.shard_kernel(jsparse.DenseKernel(jnp.asarray(S)), jm)
    tks = tmesh.shard_kernel(convert.dense_kernel_from_numpy(S, device="cpu"), tm)
    shard_shapes = {sh.data.shape for sh in jks.S.addressable_shards}
    assert {tuple(b.shape) for row in tks.blocks for b in row} == shard_shapes
    assert (tks.nrows, tks.ncols) == (15, 105) and len(tks.slot_bytes()) == 8
    x, u = rng.normal(size=105), rng.normal(size=15)
    with jm:
        y = np.asarray(jax.jit(lambda k, v: k.matvec(v))(jks, jnp.asarray(x)))
        g = np.asarray(jax.jit(lambda k, v: k.rmatvec(v))(jks, jnp.asarray(u)))
    np.testing.assert_allclose(tks.matvec(torch.from_numpy(x)).numpy(), y, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tks.rmatvec(torch.from_numpy(u)).numpy(), g, rtol=1e-12, atol=1e-12)
    # With the contiguous transposes the CPU keeps, cut the same way.
    tkt = tmesh.shard_kernel(convert.dense_kernel_from_numpy(S, S.T.copy(), device="cpu"), tm)
    assert [b.shape[::-1] for row in tkt.blocksT for b in row] == [b.shape for row in tkt.blocks for b in row]
    np.testing.assert_allclose(tkt.rmatvec(torch.from_numpy(u)).numpy(), g, rtol=1e-12, atol=1e-12)


def test_sharded_packed_kernel_matches_jax():
    """PackedKernel on 8 slots against JAX's shard_kernel on make_mesh(8),
    1e-12 (float64 vectors on the float32 pack)."""
    rng = np.random.default_rng(11)
    S = _sparse(rng, 24, 333)
    jk, tk = jsparse.pack_dense(S), tsparse.pack_dense(S, device="cpu")
    jm, tm = jmesh.make_mesh(8), tmesh.make_mesh(8, device="cpu")
    jks, tks = jmesh.shard_kernel(jk, jm), tmesh.shard_kernel(tk, tm)
    assert len(tks.row_parts) == 8 and {p[0].shape[1] for p in tks.row_parts} == {jks.row_vals.shape[1] // 8}
    x, u = rng.normal(size=333), rng.normal(size=24)
    with jm:
        y = np.asarray(jax.jit(lambda k, v: k.matvec(v))(jks, jnp.asarray(x)))
        g = np.asarray(jax.jit(lambda k, v: k.rmatvec(v))(jks, jnp.asarray(u)))
    np.testing.assert_allclose(tks.matvec(torch.from_numpy(x)).numpy(), y, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tks.rmatvec(torch.from_numpy(u)).numpy(), g, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("what", ["object", "dense SensitKernel"])
def test_unported_operator_types_are_refused(what):
    op = object() if what == "object" else tsens.SensitKernel(torch.zeros(2, 8), 2, 1, 1, 2, 2, 2, 0)
    with pytest.raises(NotImplementedError, match="not a sensitivity operator"):
        tmesh.shard_kernel(op, tmesh.make_mesh(2, device="cpu"))


def test_shard_system_arrays_shards_operators_once_and_keeps_vectors_home():
    S = _sparse(np.random.default_rng(2), 16, 300, dtype=np.float32)
    tm = tmesh.make_mesh(4, device="cpu")
    cw = torch.ones(300, dtype=torch.float64)
    arrays = {"S": (ttile.pack_tiles(S, device="cpu"),), "cw": (cw,), "rho_admm": torch.ones(2)}
    out = tmesh.shard_system_arrays(arrays, tm)
    assert isinstance(out["S"][0], ttile.ShardedTileKernel) and out["cw"][0] is cw
    again = tmesh.shard_system_arrays(out, tm)
    assert again["S"][0] is out["S"][0]  # a second placement is a no-op
    with pytest.raises(ValueError, match="another mesh"):
        tmesh.shard_kernel(out["S"][0], tmesh.make_mesh(4, device="cpu"))


# ---------------------------------------------------------------- the row-sharded build


@pytest.mark.parametrize("compression", [0, 1], ids=["uncompressed", "haar"])
def test_row_sharded_build(tmp_path, compression):
    """nd = 13 observations in chunks of 5 on 8 slots (every chunk padded
    with dummy rows). The dense kernel and the streamed cache are equal bit
    for bit to the unsharded port build, nnz too; comp_error to 1e-12 (its
    sums run over other shapes); and within 1e-6 of the largest entry of the
    JAX package's mesh build (two libms, float32 storage)."""
    g, (X, Y, Z), kw, cw = _problem(4, 4, 4, 13, compression, 0.3, 40)
    tm = tmesh.make_mesh(8, device="cpu")

    def port(mesh, sink=None):
        return tsens.compute_sensitivity(
            TGravParams(**kw), TGrid(**g), TSurveyData(ndata=13, X=X, Y=Y, Z=Z), cw,
            batch_size=5, device="cpu", mesh=mesh, row_sink=sink,
        )

    plain, meshed = port(None), port(tm)
    assert torch.equal(plain.S, meshed.S) and plain.nnz == meshed.nnz
    np.testing.assert_allclose(meshed.comp_error, plain.comp_error, rtol=1e-12)
    files = {}
    for name, mesh in (("plain", None), ("mesh", tm)):
        d = str(tmp_path / name)
        w = tcache.SensitStreamWriter(d, TGravParams(**kw), TGrid(**g), cw, compression)
        k = port(mesh, w.write_chunk)
        w.finalize(k.comp_error)
        with open(os.path.join(d, "sensit_grav_1_0"), "rb") as f:
            files[name] = f.read()
    assert files["plain"] == files["mesh"]
    kj = jsens.compute_sensitivity(
        JGravParams(**kw), JGrid(**g), JSurveyData(ndata=13, X=X, Y=Y, Z=Z), cw, batch_size=5, mesh=jmesh.make_mesh(8),
    )
    Sj = np.asarray(kj.S)
    np.testing.assert_allclose(meshed.S.numpy(), Sj, rtol=0, atol=1e-6 * np.abs(Sj).max())


# ---------------------------------------------------------------- whole solves


def _solve_both(tmp_path, fmt, spec, niter=8):
    """Both packages on the synthetic problem of test_torch_workflow.py with a
    mesh of `spec`; the port solves from the cache the JAX run wrote."""
    lines = _write_problem(str(tmp_path), 12, 8, 4, 24, niter=niter, fmt=fmt)
    jout, tout = str(tmp_path / "jax_out"), str(tmp_path / "torch_out")
    rj = jsolve(jparse(lines(jout)), solve_dtype=jnp.float64, compute_dtype=jnp.float64, verbose=False,
                mesh=jmesh.make_mesh(spec))
    tlines = lines(tout) + ["sensit.readFromFiles = 1", f"sensit.folderPath = {jout}/SENSIT/"]
    rt = twf.solve_problem_joint_gravmag(tparse(tlines), solve_dtype=torch.float64, verbose=False, device="cpu",
                                         mesh=tmesh.make_mesh(spec, device="cpu"))
    return rj, rt, jout, tout


@pytest.mark.parametrize(
    "fmt,spec,operator",
    [("tiled", 8, "ShardedTileKernel"), (None, 8, "ShardedDenseKernel"), ("packed", 8, "ShardedPackedKernel"),
     (None, (2, 4), "ShardedDenseKernel")],
    ids=["tiled-8", "dense-8", "packed-8", "dense-2x4"],
)
def test_mesh_solve_matches_jax(tmp_path, monkeypatch, fmt, spec, operator):
    """solve_problem_joint_gravmag(mesh=...) of both packages from one cache:
    every costs.txt column rtol 1e-8, final model to 1e-8 of its range, final
    data rtol 1e-8; 8 minor iterations on 24 data rows."""
    made = []
    orig = twf.shard_kernel
    monkeypatch.setattr(twf, "shard_kernel", lambda k, m: made.append(orig(k, m)) or made[-1])
    rj, rt, jout, tout = _solve_both(tmp_path, fmt, spec)
    assert [type(k).__name__ for k in made] == [operator]
    assert rt.timings["lsqr_iters"] == [8] * 3 and "shard_s" in rt.timings
    for a, b in zip(_costs(os.path.join(jout, "costs.txt")), _costs(os.path.join(tout, "costs.txt"))):
        np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-300)
    mj, mt = rj.models[0].val, rt.models[0].val
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-8 * (mj.max() - mj.min()))
    np.testing.assert_allclose(rt.data[0].val_calc, rj.data[0].val_calc, rtol=1e-8)


def test_tiled_mesh_run_puts_every_product_through_the_sharded_contraction(tmp_path, monkeypatch):
    """From scratch on 4 slots (row-sharded build into the cache): each
    product is one call of tile_matvec_sharded over 4 parts and none of the
    unsharded tile_matvec; the result equals the unmeshed run to the last
    bit, costs.txt included."""
    calls = {"sharded": 0, "unsharded": 0}
    sharded, unsharded = ttile.tile_matvec_sharded, ttile.tile_matvec

    def count_sharded(parts, x, home):
        assert len(parts) == 4
        calls["sharded"] += 1
        return sharded(parts, x, home)

    def count_unsharded(*a):
        calls["unsharded"] += 1
        return unsharded(*a)

    monkeypatch.setattr(ttile, "tile_matvec_sharded", count_sharded)
    monkeypatch.setattr(ttile, "tile_matvec", count_unsharded)
    lines = _write_problem(str(tmp_path), 8, 8, 4, 16, niter=6, fmt="tiled")
    one = twf.solve_problem_joint_gravmag(tparse(lines(str(tmp_path / "one"))), verbose=False, device="cpu")
    assert calls == {"sharded": 0, "unsharded": 3 * (2 * 6 + 1) + 6}
    calls["unsharded"] = 0
    four = twf.solve_problem_joint_gravmag(tparse(lines(str(tmp_path / "four"))), verbose=False, device="cpu",
                                          mesh=tmesh.make_mesh(4, device="cpu"))
    assert calls == {"sharded": 3 * (2 * 6 + 1) + 6, "unsharded": 0}
    np.testing.assert_array_equal(four.models[0].val, one.models[0].val)
    for f in ("costs.txt", "SENSIT/sensit_grav_1_0"):
        with open(tmp_path / "one" / f, "rb") as a, open(tmp_path / "four" / f, "rb") as b:
            assert a.read() == b.read(), f


def test_a_mesh_of_another_device_type_is_refused(tmp_path):
    lines = _write_problem(str(tmp_path), 8, 8, 4, 16, niter=6)
    cpu_mesh = tmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="mesh of cpu slots"):
        twf.solve_problem_joint_gravmag(tparse(lines(str(tmp_path / "a"))), verbose=False, device="cuda", mesh=cpu_mesh)


def test_cli_mesh_on_cpu_slots(tmp_path):
    """--device cpu --mesh 4 runs to THE END and logs the slots' bytes; a
    mesh spec that names no slot is an ERROR line and exit code 1."""
    lines = _write_problem(str(tmp_path), 8, 8, 4, 16, niter=6, fmt="tiled")
    par = tmp_path / "Parfile.txt"
    par.write_text("\n".join(lines(str(tmp_path / "out"))))
    p = _run(["-m", "tomofastx_tpu_torch", "-p", str(par), "--device", "cpu", "--mesh", "4"], str(tmp_path))
    assert p.returncode == 0, p.stderr
    assert "THE END." in p.stdout and "lsqr iters = 6" in p.stdout
    assert "kernel sharded over a 4 mesh ('cells',)" in p.stdout and "slot 3 (cpu)" in p.stdout
    q = _run(["-m", "tomofastx_tpu_torch", "-p", str(par), "--device", "cpu", "--mesh", "0x4", "-q"], str(tmp_path))
    assert q.returncode == 1 and "ERROR: --mesh 0x4" in q.stderr
