"""Port parity of the build and storage variants on the CPU: the float32
threshold select, the compensated float32 build (--build-precision single),
the mixed build (--fast-build K), the float32-compressed float64 build
(tpu.f64BuildF32Compress), bfloat16 kernel storage with its GEMV pair
(ops/bf16_gemv.py, plain versions here) and the refinement forward
(tpu.refineForward), each against the JAX package (x64) on the same inputs,
made from a seed with numpy; and the workflows of each, with and without a
mesh of CPU slots."""

import dataclasses
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tomofastx_tpu.config.parfile import GravParams as JGravParams
from tomofastx_tpu.config.parfile import MagParams as JMagParams
from tomofastx_tpu.config.parfile import parse_parfile_lines as jparse
from tomofastx_tpu.inversion.workflow import solve_problem_joint_gravmag as jsolve
from tomofastx_tpu.models.data import SurveyData as JSurveyData
from tomofastx_tpu.models.grid import Grid as JGrid
from tomofastx_tpu.ops import sensitivity as jsens
from tomofastx_tpu.ops.sparse_kernel import DenseKernel as JDenseKernel

from tomofastx_tpu_torch import cli, convert
from tomofastx_tpu_torch.config.parfile import GravParams as TGravParams
from tomofastx_tpu_torch.config.parfile import MagParams as TMagParams
from tomofastx_tpu_torch.config.parfile import parse_parfile_lines as tparse
from tomofastx_tpu_torch.inversion import workflow as twf
from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag as tsolve
from tomofastx_tpu_torch.io import sensit_cache as tcache
from tomofastx_tpu_torch.models.data import SurveyData as TSurveyData
from tomofastx_tpu_torch.models.grid import Grid as TGrid
from tomofastx_tpu_torch.ops import bf16_gemv
from tomofastx_tpu_torch.ops import sensitivity as tsens
from tomofastx_tpu_torch.ops.sparse_kernel import ShardedDenseKernel, pad_dense_columns
from tomofastx_tpu_torch.parallel import mesh as tmesh

from test_torch_workflow import _costs, _write_problem

H = (100.0, 80.0, 50.0)
NX, NY, NZ = 8, 6, 5
N = NX * NY * NZ


def _grid_dict():
    k, j, i = np.meshgrid(np.arange(NZ), np.arange(NY), np.arange(NX), indexing="ij")
    i, j, k = (a.reshape(-1).astype(float) for a in (i, j, k))
    return dict(nx=NX, ny=NY, nz=NZ, X1=i * H[0], X2=(i + 1) * H[0], Y1=j * H[1], Y2=(j + 1) * H[1],
                Z1=k * H[2], Z2=(k + 1) * H[2])


# kind: (magnetic, data_type, ndc)
KINDS = {"gz": (False, 1, 1), "tmi": (True, 1, 1), "ftg": (False, 2, 6)}


def _problem(kind, ctype, nd=12, seed=9, rate=0.2):
    """Observations 0.5-20 m above the grid (float32-exact coordinates, so
    that the mixed build's float32 points widen back to themselves), column
    weights, and both packages' parameters."""
    mag, data_type, ndc = KINDS[kind]
    rng = np.random.default_rng(seed)
    X = np.round(rng.uniform(10.0, NX * H[0] - 10.0, nd), 2).astype(np.float32).astype(np.float64)
    Y = np.round(rng.uniform(10.0, NY * H[1] - 10.0, nd), 2).astype(np.float32).astype(np.float64)
    Z = -np.round(rng.uniform(0.5, 20.0, nd), 2).astype(np.float32).astype(np.float64)
    kw = dict(nx=NX, ny=NY, nz=NZ, ndata=nd, compression_type=ctype, compression_rate=rate, depth_weighting_type=1,
              ndata_components=ndc)
    if mag:
        kw.update(mi=60.0, md=10.0, intensity=5.0e4)
    else:
        kw.update(data_type=data_type)
    cw = rng.uniform(1.0, 3.0, N)
    return (X, Y, Z), kw, cw, ((JMagParams, TMagParams) if mag else (JGravParams, TGravParams))


def _builds(kind, ctype, compute, store, near=0, seed=9, **extra):
    """The kernel of one problem built by each package with the same
    options: (JAX's S, the port's S), both as float64 numpy arrays."""
    (X, Y, Z), kw, cw, (JPar, TPar) = _problem(kind, ctype, seed=seed)
    nd = kw["ndata"]
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    kj = jsens.compute_sensitivity(JPar(**kw, **extra), JGrid(**_grid_dict()), JSurveyData(ndata=nd, X=X, Y=Y, Z=Z),
                                   cw, compute_dtype=jdt[compute], store_dtype=jdt[store], batch_size=4,
                                   near_field_f64=near)
    kt = tsens.compute_sensitivity(TPar(**kw, **extra), TGrid(**_grid_dict()), TSurveyData(ndata=nd, X=X, Y=Y, Z=Z),
                                   cw, compute_dtype=compute, store_dtype=store, batch_size=4, device="cpu",
                                   near_field_f64=near)
    assert kt.S.dtype == store
    return np.asarray(kj.S).astype(np.float64), kt.S.double().numpy()


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ---------------------------------------------------------------- the float32 select

_RNG = np.random.default_rng(11)
_ROWS = np.abs(_RNG.normal(size=(5, 1000))).astype(np.float32)
_WITH_ZEROS = _ROWS.copy()
_WITH_ZEROS[:, ::3] = 0.0
SELECT_CASES = {
    "random-k150": (_ROWS, 150), "k=1": (_ROWS, 1), "k=N-1": (_ROWS, 999),
    "heavy-ties": (np.repeat(np.abs(_RNG.normal(size=(3, 100))).astype(np.float32), 10, axis=1), 37),
    "zeros": (_WITH_ZEROS, 500),
}


@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_kth_largest_bisect_equals_topk_and_jax(case):
    """The bisection on the float32 bit pattern equals torch.topk's k-th
    value and JAX's bisection exactly, on the cases of the JAX package's own
    test (tests/test_matrixfree.py::test_threshold_bisect_matches_topk)."""
    arr, k = SELECT_CASES[case]
    got = tsens._kth_largest_bisect_f32(torch.from_numpy(arr), k)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), torch.topk(torch.from_numpy(arr), k, dim=-1)[0][..., -1].numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsens._kth_largest_bisect_f32(jnp.asarray(arr), k)))


def test_compress_lines_float32_matches_jax():
    """float32 rows through both packages' wavelet and threshold: the same
    entries kept, values within 1e-6 of the largest, nnz equal."""
    rng = np.random.default_rng(5)
    lines = rng.normal(size=(4, 1, 1, 8 * 8 * 4)).astype(np.float32)
    cj, nj, ej = jsens._compress_lines(jnp.asarray(lines), 8, 8, 4, 1, 100, jnp.float32)
    ct, nt, et = tsens._compress_lines(torch.from_numpy(lines), 8, 8, 4, 1, 100, torch.float32)
    cj = np.asarray(cj)
    assert ct.dtype == torch.float32
    np.testing.assert_array_equal(ct.numpy() != 0, cj != 0)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=1e-6 * np.abs(cj).max())
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-5)


# ---------------------------------------------------------------- the build variants


@pytest.mark.parametrize("ctype", [0, 1], ids=["uncompressed", "haar"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_float32_build_as_accurate_as_jax(kind, ctype):
    """--build-precision single: float32 per-cell rows with the far cells by
    quadrature. The two packages' float32 closed forms round differently, so
    the port is held by JAX's own yardstick: its Frobenius distance from the
    float64 build within 1.5x of JAX's (tests/test_torch_matrixfree_f32.py)."""
    j64, _ = _builds(kind, ctype, torch.float64, torch.float64)
    j32, t32 = _builds(kind, ctype, torch.float32, torch.float32)
    err_jax, err_port = _rel(j32, j64), _rel(t32, j64)
    assert err_port <= 1.5 * err_jax, (err_port, err_jax)
    assert err_port < 1e-4


@pytest.mark.parametrize("kind", list(KINDS))
def test_mixed_build_patches_the_nearest_cells_in_float64(kind):
    """--fast-build 16 stored in float64: the cells strictly inside each
    row's 16-cell cut equal the port's float64 per-cell build (the rows the
    patch recomputes; tpu.latticeBuild = 0) at rtol 1e-12 (the cut has
    distance ties on this grid: which tied cell is patched is left to the
    tie rule, as in tests/test_matrixfree.py:170-178), and the whole kernel
    is within 1e-3 of the float64 build (Frobenius)."""
    (X, Y, Z), kw, cw, (_, TPar) = _problem(kind, 0)
    grid, data = TGrid(**_grid_dict()), TSurveyData(ndata=kw["ndata"], X=X, Y=Y, Z=Z)
    k64 = tsens.compute_sensitivity(TPar(**kw, lattice_build=0), grid, data, cw, store_dtype=torch.float64,
                                    device="cpu").S.numpy()
    kmx = tsens.compute_sensitivity(TPar(**kw), grid, data, cw, torch.float32, torch.float64, device="cpu",
                                    near_field_f64=16).S.numpy()
    ndc = KINDS[kind][2]
    g = _grid_dict()
    xc, yc, zc = ((g[a] + g[b]) / 2 for a, b in (("X1", "X2"), ("Y1", "Y2"), ("Z1", "Z2")))
    patched = 0
    for r in range(kw["ndata"]):
        d2 = (xc - X[r]) ** 2 + (yc - Y[r]) ** 2 + (zc - Z[r]) ** 2
        near = np.nonzero(d2 < np.sort(d2)[15])[0]
        patched += near.size
        rows = slice(r * ndc, (r + 1) * ndc)
        np.testing.assert_allclose(kmx[rows][:, near], k64[rows][:, near], rtol=1e-12)
    assert patched >= 8 * kw["ndata"]
    assert np.linalg.norm(kmx - k64) < 1e-3 * np.linalg.norm(k64)


@pytest.mark.parametrize("ctype", [0, 1], ids=["uncompressed", "haar"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_mixed_build_matches_jax(kind, ctype):
    """--fast-build 16 stored in float32 (the patched rows rounded to float32
    after the float64 weighting, the wavelet and threshold in float32):
    the same entries kept as in JAX's kernel, and the two within the float32
    rounding of the unpatched cells' closed forms, which the two packages
    round differently (up to 7e-6 of the norm here, the size of either
    package's distance from the float64 build): 2e-5 of the norm
    (Frobenius); and the port's distance from JAX's float64 build within
    1.5x of JAX's own (the yardstick of test_float32_build_as_accurate_as_jax)."""
    sj, st = _builds(kind, ctype, torch.float32, torch.float32, near=16)
    j64, _ = _builds(kind, ctype, torch.float64, torch.float64)
    np.testing.assert_array_equal(st != 0, sj != 0)
    assert _rel(st, sj) < 2e-5
    assert _rel(st, j64) <= 1.5 * _rel(sj, j64)


def _tie_swaps_bounded(A, B):
    """The bound of tests/test_matrixfree.py:490-503: supports differ only by
    threshold tie-swaps, few and no larger than twice the row's threshold."""
    mism = (A != 0) != (B != 0)
    assert mism.sum() <= max(4, 0.01 * (B != 0).sum())
    thresh = np.where((B != 0).any(axis=1), np.min(np.abs(np.where(B != 0, B, np.inf)), axis=1), 0.0)
    assert not (np.abs(np.where(mism, A + B, 0.0)) > 2.0 * thresh[:, None]).any()


@pytest.mark.parametrize("kind", list(KINDS))
def test_f64_build_f32_compress_matches_jax(kind):
    """tpu.f64BuildF32Compress at rate 0.3, stored float32: against JAX's
    kernel of the same flag and against the port's float64 pipeline, the
    common support at 2e-6 of each row's largest entry and the tie-swaps
    bounded, the JAX package's own bounds (tests/test_matrixfree.py:460-503)."""
    sj, st = _builds(kind, 1, torch.float64, torch.float32, f64_build_f32_compress=1)
    _, ref = _builds(kind, 1, torch.float64, torch.float32)
    for other in (sj, ref):
        common = (st != 0) & (other != 0)
        scale = np.max(np.abs(other), axis=1, keepdims=True)
        np.testing.assert_allclose(np.where(common, st, 0.0) / scale, np.where(common, other, 0.0) / scale,
                                   rtol=0, atol=2e-6)
        _tie_swaps_bounded(st, other)


def test_f64_build_f32_compress_is_inert_for_float64_storage():
    """The flag leaves a float64-stored build's float64 pipeline alone: the
    kernels are equal to the last bit."""
    (X, Y, Z), kw, cw, (_, TPar) = _problem("gz", 1)
    grid, data = TGrid(**_grid_dict()), TSurveyData(ndata=kw["ndata"], X=X, Y=Y, Z=Z)
    a, b = (tsens.compute_sensitivity(TPar(**kw, f64_build_f32_compress=f), grid, data, cw,
                                      store_dtype=torch.float64, device="cpu").S for f in (0, 1))
    assert torch.equal(a, b)


def test_bfloat16_dense_build_rounds_the_float32_build():
    """A dense bfloat16 build is written straight into bfloat16 and holds the
    float32 build's entries rounded to bfloat16 (entries within one bfloat16
    rounding, 2^-8 relative), the same entries kept; the cache refuses it."""
    (X, Y, Z), kw, cw, (_, TPar) = _problem("gz", 1)
    grid, data = TGrid(**_grid_dict()), TSurveyData(ndata=kw["ndata"], X=X, Y=Y, Z=Z)
    k16 = tsens.compute_sensitivity(TPar(**kw), grid, data, cw, store_dtype=torch.bfloat16, device="cpu")
    k32 = tsens.compute_sensitivity(TPar(**kw), grid, data, cw, store_dtype=torch.float32, device="cpu")
    assert k16.S.dtype == torch.bfloat16 and k16.nnz == k32.nnz
    np.testing.assert_array_equal((k16.S != 0).numpy(), (k32.S != 0).numpy())
    np.testing.assert_allclose(k16.S.double().numpy(), k32.S.double().numpy(), rtol=2.0 ** -8, atol=0)
    with pytest.raises(ValueError, match="float32 format"):
        tcache.write_kernel_cache("unused", TPar(**kw), k16, cw)


@pytest.mark.parametrize("variant", ["single", "fast-build", "f32-compress"])
def test_build_variants_stream_to_the_cache_and_split_over_a_mesh(tmp_path, variant):
    """Each variant streamed to the cache writer and built over a 3-slot CPU
    mesh: the cache rows equal the dense build's, and the mesh build holds
    the unmeshed one's entries, values within 1e-6 of the largest. (Rows are
    built independently, but on the CPU a few float32 entries move by an ulp
    with the shape of the batch they are computed in: the unmeshed build in
    chunks of 2 rows instead of 4 differs from itself alike. The float64
    variant is equal bit for bit.)"""
    (X, Y, Z), kw, cw, (_, TPar) = _problem("tmi", 1, nd=13)
    par = TPar(**kw, f64_build_f32_compress=int(variant == "f32-compress"))
    grid, data = TGrid(**_grid_dict()), TSurveyData(ndata=kw["ndata"], X=X, Y=Y, Z=Z)
    opts = dict(compute_dtype=torch.float32 if variant != "f32-compress" else torch.float64,
                near_field_f64=16 if variant == "fast-build" else 0, batch_size=4, device="cpu")
    dense = tsens.compute_sensitivity(par, grid, data, cw, **opts).S
    chunks = []
    w = tcache.SensitStreamWriter(str(tmp_path), par, grid, cw, 1)

    def sink(c, s):
        chunks.append(c.clone())
        w.write_chunk(c, s)

    tsens.compute_sensitivity(par, grid, data, cw, row_sink=sink, **opts)
    w.close()
    assert torch.equal(torch.cat(chunks).reshape(dense.shape), dense)
    meshed = tsens.compute_sensitivity(par, grid, data, cw, mesh=tmesh.make_mesh(3, device="cpu"), **opts).S
    assert torch.equal(meshed != 0, dense != 0)
    if variant == "f32-compress":
        assert torch.equal(meshed, dense)
    torch.testing.assert_close(meshed, dense, rtol=0, atol=1e-6 * float(dense.abs().max()))


# ---------------------------------------------------------------- the bfloat16 GEMV pair


def _bf16(shape, seed):
    """A bfloat16 matrix with zeros, as a numpy ml_dtypes array."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=shape) * np.exp(rng.normal(size=shape))
    a[rng.random(shape) < 0.3] = 0.0
    return a.astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("shape", [(37, 264), (300, 100), (5, 2053)], ids=["rows-8x", "rows-past-a-block", "ragged"])
@pytest.mark.parametrize("vec", ["float64", "float32"])
def test_bf16_dense_kernel_matches_jax(shape, vec):
    """The JAX package's bfloat16 DenseKernel (its S an ml_dtypes.bfloat16
    array) carried into the port by convert.py bit for bit: matvec and
    rmatvec (the plain versions on the CPU) against JAX's on the same
    vectors, at rtol 1e-6 of the largest output (float32 vectors: float32
    sums in two orders)."""
    Snp = _bf16(shape, 3)
    dk = convert.dense_kernel_from_numpy(Snp, device="cpu")
    assert dk.S.dtype == torch.bfloat16
    np.testing.assert_array_equal(dk.S.view(torch.int16).numpy(), Snp.view(np.int16))
    jk = JDenseKernel(jnp.asarray(Snp))
    rng = np.random.default_rng(4)
    x, u = rng.normal(size=shape[1]).astype(vec), rng.normal(size=shape[0]).astype(vec)
    for got, want in ((dk.matvec(torch.from_numpy(x)), jk.matvec(jnp.asarray(x))),
                      (dk.rmatvec(torch.from_numpy(u)), jk.rmatvec(jnp.asarray(u)))):
        want = np.asarray(want)
        assert got.dtype == getattr(torch, vec) and want.dtype == np.dtype(vec)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_bf16_plain_versions_sum_in_the_vectors_type():
    """With float64 vectors the plain versions equal the float64 products of
    the exactly widened matrix to summation order (1e-13)."""
    Snp = _bf16((300, 136), 7)
    S = convert.dense_kernel_from_numpy(Snp, device="cpu").S
    S64 = torch.from_numpy(Snp.astype(np.float64))
    rng = np.random.default_rng(8)
    x, u = torch.from_numpy(rng.normal(size=136)), torch.from_numpy(rng.normal(size=300))
    for got, want in ((bf16_gemv.bf16_matvec(S, x), S64 @ x), (bf16_gemv.bf16_rmatvec(S, u), S64.T @ u)):
        assert got.dtype == torch.float64
        torch.testing.assert_close(got, want, rtol=0, atol=1e-13 * float(want.abs().max()))


def test_bf16_wrappers_refuse_what_the_kernels_do_not_take():
    S = torch.zeros((4, 16), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        bf16_gemv.bf16_matvec(S.float(), torch.zeros(16))
    with pytest.raises(ValueError, match="16 entries"):
        bf16_gemv.bf16_matvec(S, torch.zeros(15))
    with pytest.raises(ValueError, match="4 entries"):
        bf16_gemv.bf16_rmatvec(S, torch.zeros(16))
    with pytest.raises(TypeError, match="float32 or float64"):
        bf16_gemv.bf16_rmatvec(S, torch.zeros(4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="cuda or cpu"):
        bf16_gemv.bf16_matvec(S.to("meta"), torch.zeros(16, device="meta"))
    # The launch counts move only where a kernel launches: not on the CPU.
    before = (bf16_gemv.bf16_matvec.launches, bf16_gemv.bf16_rmatvec.launches)
    bf16_gemv.bf16_matvec(S, torch.zeros(16))
    bf16_gemv.bf16_rmatvec(S, torch.zeros(4))
    assert (bf16_gemv.bf16_matvec.launches, bf16_gemv.bf16_rmatvec.launches) == before


def test_bf16_kernel_source_is_shipped_with_the_package():
    """csrc/bf16_gemv.cu: the four plain C entry points the wrappers bind, no
    library kernel, and no atomics (every sum in a fixed order)."""
    assert os.path.exists(bf16_gemv._SOURCE)
    src = open(bf16_gemv._SOURCE).read()
    for fn in ("bf16_matvec_f32", "bf16_matvec_f64", "bf16_rmatvec_f32", "bf16_rmatvec_f64"):
        assert f'extern "C" int {fn}(' in src
    for word in ("cublas", "torch/", "cutlass", "atomicadd"):
        assert word not in src.lower()


@pytest.mark.parametrize("nrows,ncols,want", [(4096, 262144, 16), (24576, 262144, 16), (16, 256, 1),
                                              (4096, 2048, 128), (7, 100, 1)])
def test_bf16_rmatvec_slabs_follow_the_shape(nrows, ncols, want):
    """The adjoint's slabs: enough thread blocks of 2048 columns to fill the
    card, never slabs of fewer than 32 rows, and a function of the shape."""
    assert bf16_gemv.slabs(nrows, ncols) == want


def test_bf16_kernels_held_by_the_mesh_operators():
    """A bfloat16 DenseKernel padded and sharded over CPU slots keeps its
    dtype in every block; one slot equals the unsharded operator bit for
    bit, three slots to summation order."""
    Snp = _bf16((24, 100), 9)
    dk = convert.dense_kernel_from_numpy(Snp, device="cpu")
    assert pad_dense_columns(dk, 8).S.dtype == torch.bfloat16
    rng = np.random.default_rng(2)
    x, u = torch.from_numpy(rng.normal(size=100)), torch.from_numpy(rng.normal(size=24))
    for spec in (1, 3, (2, 2)):
        m = tmesh.make_mesh(spec, device="cpu")
        sk = tmesh.shard_kernel(dk, m)
        assert isinstance(sk, ShardedDenseKernel) and all(b.dtype == torch.bfloat16 for r in sk.blocks for b in r)
        for got, want in ((sk.matvec(x), dk.matvec(x)), (sk.rmatvec(u), dk.rmatvec(u))):
            if spec == 1:
                assert torch.equal(got, want)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-13 * float(want.abs().max()))


# ---------------------------------------------------------------- the workflows


def _both(tmp_path, lines, extra=(), jkw=None, tkw=None, share_cache=False):
    """One Parfile through both packages (float64 solve); with share_cache the
    port solves from the cache of the JAX run."""
    jout, tout = str(tmp_path / "jax_out"), str(tmp_path / "torch_out")
    rj = jsolve(jparse(lines(jout) + list(extra)), solve_dtype=jnp.float64, verbose=False, **(jkw or {}))
    tlines = lines(tout) + list(extra)
    if share_cache:
        tlines += ["sensit.readFromFiles = 1", f"sensit.folderPath = {jout}/SENSIT/"]
    rt = tsolve(tparse(tlines), solve_dtype=torch.float64, verbose=False, device="cpu", **(tkw or {}))
    return rj, rt, jout, tout


def _hold(rj, rt, jout, tout, cost_rtol, model_tol, niter=8):
    """costs.txt column by column, the final costs and the final model (to
    model_tol of its range)."""
    assert rt.timings["lsqr_iters"] == [niter] * 3
    cj, ct = _costs(os.path.join(jout, "costs.txt")), _costs(os.path.join(tout, "costs.txt"))
    assert len(cj) == len(ct) == 4
    for a, b in zip(cj, ct):
        np.testing.assert_allclose(b, a, rtol=cost_rtol, atol=1e-300)
    assert ct[1][1] < ct[0][1]
    np.testing.assert_allclose(rt.cost_data, rj.cost_data, rtol=cost_rtol)
    mj, mt = rj.models[0].val, rt.models[0].val
    np.testing.assert_allclose(mt, mj, rtol=0, atol=model_tol * (mj.max() - mj.min()))


# Each variant through both packages' workflows on one input set, each
# package building its own kernel: (Parfile lines, JAX's arguments, the
# port's, cost rtol, model tolerance of the range). The float64 builds are
# held as two builds are (tests/test_torch_workflow.py::
# test_slice_from_scratch_matches_jax): a bfloat16 kernel, rounded from the
# two packages' float64 rows, flips an entry to its neighbour far more
# rarely than a float32 one. The float32 physics of the two packages round
# differently (test_float32_build_as_accurate_as_jax), which the solve
# carries into the costs and the model: measured 2.5e-5 and 6.7e-6 for the
# float32 and mixed builds, 4.7e-7 and 7.6e-8 for the float32 pipeline.
VARIANTS = {
    "bf16-storage-dense": (["tpu.kernelStoreDtype = bfloat16", "tpu.kernelFormat = dense"], {}, {}, 1e-6, 1e-6),
    "refine-forward-tiled": (["tpu.refineForward = 1"], {}, {}, 1e-6, 1e-6),
    "refine-forward-double-dense": (["tpu.refineForward = 1", "tpu.refineForwardPrecision = double",
                                     "tpu.kernelFormat = dense"], {}, {}, 1e-6, 1e-6),
    "f64-build-f32-compress": (["tpu.f64BuildF32Compress = 1"], {}, {}, 5e-6, 1e-6),
    "mixed-build-dense": (["tpu.kernelFormat = dense"], {"near_field_f64": 16}, {"near_field_f64": 16}, 1e-4, 5e-5),
    "float32-build-tiled": ([], {"compute_dtype": jnp.float32}, {"compute_dtype": torch.float32}, 1e-4, 5e-5),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_workflow_matches_jax(tmp_path, variant):
    """One Parfile run of each variant, the kernel built by each package
    (tolerances stated at VARIANTS)."""
    extra, jkw, tkw, cost_rtol, model_tol = VARIANTS[variant]
    lines = _write_problem(str(tmp_path), 12, 8, 4, 24, niter=8)
    made, orig = [], twf._kernel_operator
    twf._kernel_operator = lambda ctx, device: made.append(orig(ctx, device)) or made[-1]
    try:
        rj, rt, jout, tout = _both(tmp_path, lines, extra, jkw, tkw)
    finally:
        twf._kernel_operator = orig
    _hold(rj, rt, jout, tout, cost_rtol, model_tol)
    if variant.startswith("bf16"):
        assert made[-1].S.dtype == torch.bfloat16 and made[-1].ST is None
        assert not os.path.exists(os.path.join(tout, "SENSIT", "sensit_grav_1_0"))
        assert not os.path.exists(os.path.join(jout, "SENSIT", "sensit_grav_1_0"))


@pytest.mark.parametrize("variant", ["bf16-storage", "refine-forward-tiled", "refine-forward-double"])
def test_variant_from_a_shared_cache_matches_jax(tmp_path, variant):
    """Both packages solve from the one float32 cache of a first JAX run, so
    they hold the same matrix (a bfloat16 one: the same float32 values,
    weighted and rounded alike): every costs.txt column rtol 1e-8, the model
    to 1e-8 of its range."""
    extra = {"bf16-storage": ["tpu.kernelStoreDtype = bfloat16", "tpu.kernelFormat = dense"],
             "refine-forward-tiled": ["tpu.refineForward = 1"],
             "refine-forward-double": ["tpu.refineForward = 1", "tpu.refineForwardPrecision = double"]}[variant]
    lines = _write_problem(str(tmp_path), 12, 8, 4, 24, niter=8)
    jsolve(jparse(lines(str(tmp_path / "cache"))), solve_dtype=jnp.float64, verbose=False)
    shared = ["sensit.readFromFiles = 1", f"sensit.folderPath = {tmp_path}/cache/SENSIT/"]
    rj, rt, jout, tout = _both(tmp_path, lines, extra + shared)
    _hold(rj, rt, jout, tout, 1e-8, 1e-8)
    np.testing.assert_allclose(rt.data[0].val_calc, rj.data[0].val_calc, rtol=1e-8)


def test_refinement_forward_predicts_the_exact_physics(tmp_path, capsys):
    """Under tpu.refineForward the predicted data are the matrix-free
    operator's, not the compressed kernel's: the final data equal an exact
    uncompressed forward of the final model, and the log names the
    operator."""
    lines = _write_problem(str(tmp_path), 12, 8, 4, 24, niter=8)
    out = str(tmp_path / "a")
    cfg = tparse(lines(out) + ["tpu.refineForward = 1"])
    r = twf.solve_problem_joint_gravmag(cfg, solve_dtype=torch.float64, device="cpu")
    said = capsys.readouterr().out
    assert "grav refinement forward: LatticeMatrixFreeKernel (float64" in said
    cw = twf._read_depth_weight_file(os.path.join(out, "SENSIT"), 0)
    S = tsens.compute_sensitivity(dataclasses.replace(cfg.grav, compression_type=0), r.models[0].grid, r.data[0],
                                  cw, store_dtype=torch.float64, device="cpu").S.numpy()
    want = S @ (r.models[0].val[0] / cw)
    np.testing.assert_allclose(r.data[0].val_calc.reshape(-1), want, rtol=0, atol=1e-10 * np.abs(want).max())


def _joint_lines(tmp):
    """A joint grav+mag problem, uncompressed, magnetic weight 1e-8 (the rows
    of both problems on one scale)."""
    from test_torch_joint import _lines, _write_inputs

    _write_inputs(tmp)

    def lines(out):
        ls = [ln.replace("forward.matrixCompression.type = 1", "forward.matrixCompression.type = 0")
              for ln in _lines(tmp, "joint", out, fmt=None)]
        return ls + ["tpu.refineForward = 1"]

    return lines


def test_refinement_joint_run_with_one_matrix_free_problem(tmp_path, capsys):
    """A joint run whose gravity problem is matrix-free and whose magnetic
    problem is stored: the matrix-free operator is its own refinement
    forward and the magnetic one gets one, in both packages; costs rtol 1e-6
    and models 1e-6 of their ranges (two float64 builds)."""
    lines = _joint_lines(str(tmp_path))
    jout, tout = str(tmp_path / "jax_out"), str(tmp_path / "torch_out")
    cj, ct = jparse(lines(jout)), tparse(lines(tout))
    cj.grav.kernel_format = ct.grav.kernel_format = "matrixfree"
    rj = jsolve(cj, solve_dtype=jnp.float64, verbose=False)
    made = []
    orig = twf.make_matrixfree_kernel
    twf.make_matrixfree_kernel = lambda *a, **k: made.append(orig(*a, **k)) or made[-1]
    try:
        rt = tsolve(ct, solve_dtype=torch.float64, device="cpu")
    finally:
        twf.make_matrixfree_kernel = orig
    said = capsys.readouterr().out
    assert "grav kernel: matrix-free" in said and "mag refinement forward:" in said
    assert "grav refinement forward" not in said and len(made) == 2  # the gravity operator, the magnetic forward
    for i in (0, 1):
        mj, mt = rj.models[i].val, rt.models[i].val
        np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-6 * (mj.max() - mj.min()))
    np.testing.assert_allclose(rt.cost_data, rj.cost_data, rtol=1e-6)


def test_refinement_is_set_for_every_problem_or_ignored(tmp_path, capsys):
    """tpu.refineForward on one problem of two: ignored with the JAX
    package's warning; on a matrix-free run: a no-op, with its note."""
    lines = _joint_lines(str(tmp_path))
    cfg = tparse(lines(str(tmp_path / "a")))
    cfg.magn.refine_forward = 0
    tsolve(cfg, solve_dtype=torch.float64, device="cpu")
    assert "WARNING: tpu.refineForward ignored" in capsys.readouterr().out
    cfg = tparse(lines(str(tmp_path / "b")) + ["tpu.kernelFormat = matrixfree"])
    tsolve(cfg, solve_dtype=torch.float64, device="cpu")
    said = capsys.readouterr().out
    assert "NOTE: tpu.refineForward is a no-op" in said and "refinement forward:" not in said


@pytest.mark.parametrize("variant", ["bf16-dense", "refine-tiled"])
def test_variant_over_a_mesh_of_two_cpu_slots(tmp_path, variant):
    """--mesh 2 on CPU slots against the unmeshed run: the bfloat16 blocks
    and the sharded refinement forward; the column (or observation) partials
    are summed in another order, so costs rtol 1e-10 and the model 1e-10 of
    its range."""
    extra = {"bf16-dense": ["tpu.kernelStoreDtype = bfloat16", "tpu.kernelFormat = dense"],
             "refine-tiled": ["tpu.refineForward = 1"]}[variant]
    lines = _write_problem(str(tmp_path), 12, 8, 4, 24, niter=8)
    runs = {}
    for name, mesh in (("plain", None), ("mesh", tmesh.make_mesh(2, device="cpu"))):
        runs[name] = tsolve(tparse(lines(str(tmp_path / name)) + extra), solve_dtype=torch.float64, verbose=False,
                            device="cpu", mesh=mesh)
    a, b = runs["plain"], runs["mesh"]
    np.testing.assert_allclose(b.cost_data, a.cost_data, rtol=1e-10)
    ma, mb = a.models[0].val, b.models[0].val
    np.testing.assert_allclose(mb, ma, rtol=0, atol=1e-10 * (ma.max() - ma.min()))
    assert "shard_s" in b.timings


def test_cli_takes_the_build_flags(tmp_path):
    """--build-precision single, --fast-build K and --f32-compress reach the
    build (a float32, a mixed and a float32-compressed kernel: the caches
    differ from the float64 build's and from each other); --fused M > 0
    runs (costs.txt written, the data cost falling)."""
    lines = _write_problem(str(tmp_path), 8, 8, 4, 16, niter=6)
    caches = {}
    for name, flags in (("double", []), ("single", ["--build-precision", "single"]),
                        ("fast", ["--fast-build", "16"]), ("compress", ["--f32-compress"])):
        par = tmp_path / f"Parfile_{name}.txt"
        par.write_text("\n".join(lines(str(tmp_path / name))))
        assert cli.main(["-p", str(par), "--device", "cpu", "-q"] + flags) == 0
        with open(tmp_path / name / "SENSIT" / "sensit_grav_1_0", "rb") as f:
            caches[name] = f.read()
    assert len(set(caches.values())) == 4
    par = tmp_path / "Parfile_fused.txt"
    par.write_text("\n".join(lines(str(tmp_path / "fused"))))
    assert cli.main(["-p", str(par), "--device", "cpu", "-q", "--fused", "2"]) == 0
    rows = _costs(str(tmp_path / "fused" / "costs.txt"))
    assert len(rows) == 4 and rows[1][1] < rows[0][1]
