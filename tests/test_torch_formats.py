"""Port parity for the stored-kernel formats: the plain version of
blocked_matvec against the JAX package's Pallas body (interpret mode) and its
XLA lowering; the packed top-k layout and the dense kernel against the JAX
package's, array for array; the dense build; the cache writer and the two
cache readers, each package reading the other's files. CPU, numpy inputs
from a seed, JAX x64 against torch float64. The CUDA kernel itself cannot run
without the card; chip_smoke.py holds it against the plain version there."""

import filecmp
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from tomofastx_tpu.config.parfile import GravParams as JGravParams
from tomofastx_tpu.config.parfile import MagParams as JMagParams
from tomofastx_tpu.io import sensit_cache as jcache
from tomofastx_tpu.models.data import SurveyData as JSurveyData
from tomofastx_tpu.models.grid import Grid as JGrid
from tomofastx_tpu.ops import pallas_kernels as jpk
from tomofastx_tpu.ops import sensitivity as jsens
from tomofastx_tpu.ops import sparse_kernel as jsparse

from tomofastx_tpu_torch import convert
from tomofastx_tpu_torch.config.parfile import GravParams as TGravParams
from tomofastx_tpu_torch.config.parfile import MagParams as TMagParams
from tomofastx_tpu_torch.io import sensit_cache as tcache
from tomofastx_tpu_torch.models.data import SurveyData as TSurveyData
from tomofastx_tpu_torch.models.grid import Grid as TGrid
from tomofastx_tpu_torch.ops import _cuda_build
from tomofastx_tpu_torch.ops import blocked_matvec as tbm
from tomofastx_tpu_torch.ops import sensitivity as tsens
from tomofastx_tpu_torch.ops import sparse_kernel as tsparse

PACKED_FIELDS = ("row_vals", "row_idx", "dense_cols", "dense_block", "light_cols", "light_vals", "light_idx")


def _assert_packed_equal(tk, jk):
    for f in PACKED_FIELDS:
        a, b = getattr(tk, f).numpy(), np.asarray(getattr(jk, f))
        assert a.dtype == b.dtype and a.shape == b.shape, (f, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (tk.nrows, tk.ncols) == (jk.nrows, jk.ncols)
    assert tk.nbytes == jk.nbytes


def _compressed_like(rng, nrows, ncols, rate, n_heavy):
    """A matrix with the stored kernel's kind of sparsity: a few columns
    that every row keeps, and a random support per row beside them."""
    S = np.zeros((nrows, ncols), np.float32)
    S[:, :n_heavy] = rng.normal(size=(nrows, n_heavy))
    k = int(rate * ncols)
    for r in range(nrows):
        cols = rng.choice(np.arange(n_heavy, ncols), size=k, replace=False)
        S[r, cols] = rng.normal(size=k)
    return S


# ------------------------------------------------------ blocked_matvec


def _row_blocks(rng, nrows, NB, B):
    """A ragged row layout: row r uses a random number of its B slots; the
    rest are pad slots (block 0, zero values)."""
    bidx = np.sort(rng.integers(0, NB, size=(nrows, B)).astype(np.int32), axis=1)
    bvals = rng.normal(size=(nrows, B, 128)).astype(np.float32)
    widths = rng.integers(1, B + 1, size=nrows)
    pad = np.arange(B)[None, :] >= widths[:, None]
    bvals[pad] = 0.0
    bidx[pad] = 0
    return bvals, bidx


def _pallas_interpret(bvals, bidx, x, tm=8):
    """The JAX package's kernel body under the Pallas interpreter, as its own
    test runs it (no memory spaces); rows padded to a whole number of
    programs with zero rows."""
    nrows, B, BS = bvals.shape
    npad = (-nrows) % tm
    bv = np.concatenate([bvals, np.zeros((npad, B, BS), np.float32)])
    bi = np.concatenate([bidx, np.zeros((npad, B), np.int32)])
    NB = x.shape[0] // BS
    grid_spec = pl.GridSpec(
        grid=(bv.shape[0] // tm,),
        in_specs=[
            pl.BlockSpec((tm, B), lambda i: (i, 0)),
            pl.BlockSpec((tm, B, BS), lambda i: (i, 0, 0)),
            pl.BlockSpec((NB, BS), lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((tm, 1), lambda i: (i, 0)),
    )
    out = pl.pallas_call(
        jpk._blocked_matvec_kernel,
        out_shape=jax.ShapeDtypeStruct((bv.shape[0], 1), jnp.float32),
        grid_spec=grid_spec,
        interpret=True,
    )(jnp.asarray(bi), jnp.asarray(bv), jnp.asarray(x).reshape(NB, BS))
    return np.asarray(out)[:nrows, 0]


@pytest.mark.parametrize("nrows,NB,B", [(16, 32, 6), (24, 20, 1), (13, 9, 13), (5, 3, 40), (1, 1, 1)])
def test_blocked_plain_matches_pallas_interpret_and_xla(nrows, NB, B):
    """float32 vector: blocked_matvec_plain against the Pallas body under the
    interpreter and against blocked_matvec_xla, row counts that are and are
    not multiples of the TPU kernel's 8-row program. 1e-5 of the largest
    output (float32 sums in another order)."""
    rng = np.random.default_rng(20)
    bvals, bidx = _row_blocks(rng, nrows, NB, B)
    x = rng.normal(size=NB * 128).astype(np.float32)
    got = tbm.blocked_matvec_plain(torch.as_tensor(bvals), torch.as_tensor(bidx), torch.as_tensor(x))
    assert got.dtype == torch.float32 and got.shape == (nrows,)
    xla = np.asarray(jpk.blocked_matvec_xla(jnp.asarray(bvals), jnp.asarray(bidx), jnp.asarray(x)))
    scale = np.abs(xla).max()
    np.testing.assert_allclose(got.numpy(), xla, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got.numpy(), _pallas_interpret(bvals, bidx, x), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("nrows,NB,B", [(27, 7, 5), (8, 2, 2), (3, 50, 33)])
def test_blocked_wrapper_on_cpu_matches_dense_product_f64(nrows, NB, B):
    """float64 vector through the wrapper (which takes the plain version for
    CPU tensors and launches nothing) against the dense product of the same
    layout, repeated blocks added: 1e-12 of the largest output."""
    rng = np.random.default_rng(21)
    bvals, bidx = _row_blocks(rng, nrows, NB, B)
    x = rng.normal(size=NB * 128)
    S = np.zeros((nrows, NB, 128))
    for r in range(nrows):
        for b in range(B):
            S[r, bidx[r, b]] += bvals[r, b]
    want = S.reshape(nrows, -1) @ x
    before = tbm.blocked_matvec.launches
    got = tbm.blocked_matvec(torch.as_tensor(bvals), torch.as_tensor(bidx), torch.as_tensor(x))
    assert tbm.blocked_matvec.launches == before
    assert got.dtype == torch.float64 and got.shape == (nrows,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize(
    "bad",
    ["bvals_shape", "bvals_ndim", "bidx_shape", "x_len", "x_ndim", "bvals_f64", "bvals_bf16", "bidx_dtype",
     "x_dtype", "device"],
)
def test_blocked_wrapper_rejects_what_the_kernel_does_not_take(bad):
    bvals = torch.zeros(4, 3, 128)
    bidx = torch.zeros(4, 3, dtype=torch.int32)
    x = torch.zeros(256)
    if bad == "bvals_shape":
        bvals = torch.zeros(4, 3, 64)
    elif bad == "bvals_ndim":
        bvals = torch.zeros(4, 3, 1, 128)
    elif bad == "bidx_shape":
        bidx = torch.zeros(4, 2, dtype=torch.int32)
    elif bad == "x_len":
        x = torch.zeros(200)
    elif bad == "x_ndim":
        x = torch.zeros(2, 128)
    elif bad == "bvals_f64":
        bvals = bvals.double()
    elif bad == "bvals_bf16":
        bvals = bvals.bfloat16()
    elif bad == "bidx_dtype":
        bidx = bidx.long()
    elif bad == "x_dtype":
        x = x.half()
    elif bad == "device":
        x = torch.zeros(256, device="meta")
    with pytest.raises((ValueError, TypeError)) as e:
        tbm.blocked_matvec(bvals, bidx, x)
    if bad == "bvals_bf16":
        assert "bfloat16" in str(e.value)


def test_block_ids_outside_the_vector_are_refused():
    bidx = torch.tensor([[0, 3], [1, 2]], dtype=torch.int32)
    tbm.check_block_ids(bidx, 512)  # 4 blocks: fine
    tbm.check_block_ids(bidx, 385)  # 3 blocks and a part: 4 when padded
    tbm.check_block_ids(bidx[:0], 128)
    with pytest.raises(ValueError):
        tbm.check_block_ids(bidx, 384)  # 3 blocks
    with pytest.raises(ValueError):
        tbm.check_block_ids(-bidx, 512)


def test_kernel_wrappers_refuse_strided_and_unaligned_tensors():
    """What both kernels' wrappers check before a launch: contiguity and
    16-byte alignment (the kernels read 16 bytes a lane)."""
    ok = torch.zeros(8, 128)
    _cuda_build.require_launchable(a=ok, b=ok[2:])
    with pytest.raises(ValueError, match="contiguous"):
        _cuda_build.require_launchable(a=ok.T)
    with pytest.raises(ValueError, match="aligned"):
        _cuda_build.require_launchable(a=torch.zeros(257)[1:])


def test_blocked_kernel_source_is_shipped_with_the_package():
    assert os.path.exists(tbm._SOURCE)
    src = open(tbm._SOURCE).read()
    assert 'extern "C" int blocked_matvec_f32' in src and 'extern "C" int blocked_matvec_f64' in src
    for word in ("cublas", "torch/", "cutlass"):
        assert word not in src.lower()


# ------------------------------------------- packed and dense operators


PACK_CASES = pytest.mark.parametrize(
    "nrows,ncols,rate,n_heavy,pad",
    [(37, 400, 0.15, 8, 8), (10, 64, 0.2, 1, 8), (64, 300, 0.05, 3, 4), (5, 40, 0.5, 0, 8), (12, 90, 0.0, 2, 8)],
)


@PACK_CASES
def test_pack_dense_equals_jax_packs(nrows, ncols, rate, n_heavy, pad):
    S = _compressed_like(np.random.default_rng(22), nrows, ncols, rate, n_heavy)
    _assert_packed_equal(tsparse.pack_dense(S, pad_multiple=pad, device="cpu"), jsparse.pack_dense(S, pad_multiple=pad))


def test_pack_dense_of_nothing_and_of_everything():
    for S in (np.zeros((4, 24), np.float32), np.ones((4, 24), np.float32)):
        _assert_packed_equal(tsparse.pack_dense(S, device="cpu"), jsparse.pack_dense(S))


@PACK_CASES
def test_packed_products_match_jax_and_dense(nrows, ncols, rate, n_heavy, pad):
    """The JAX package's pack carried over array for array: both products
    against its own (1e-12 of the largest output) and against the dense
    matrix (float64 sums of float32 values, 1e-12)."""
    rng = np.random.default_rng(23)
    S = _compressed_like(rng, nrows, ncols, rate, n_heavy)
    jk = jsparse.pack_dense(S, pad_multiple=pad)
    tk = convert.packed_kernel_from_numpy(*[np.asarray(getattr(jk, f)) for f in PACKED_FIELDS], jk.nrows, jk.ncols, device="cpu")
    x, u = rng.normal(size=ncols), rng.normal(size=nrows)
    y, g = tk.matvec(torch.as_tensor(x)), tk.rmatvec(torch.as_tensor(u))
    assert y.dtype == g.dtype == torch.float64 and y.shape == (nrows,) and g.shape == (ncols,)
    Sd = S.astype(np.float64)
    for got, jax_out, dense in ((y, jk.matvec(jnp.asarray(x)), Sd @ x), (g, jk.rmatvec(jnp.asarray(u)), Sd.T @ u)):
        tol = 1e-12 * max(np.abs(dense).max(), 1e-300)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), rtol=0, atol=tol)
        np.testing.assert_allclose(got.numpy(), dense, rtol=0, atol=tol)
    # float32 vectors stay float32 (the card's solve type).
    assert tk.matvec(torch.as_tensor(x, dtype=torch.float32)).dtype == torch.float32
    assert tk.rmatvec(torch.as_tensor(u, dtype=torch.float32)).dtype == torch.float32


@pytest.mark.parametrize("nrows,ncols", [(37, 400), (9, 64)])
def test_apply_row_weights_packed_equals_jax(nrows, ncols):
    rng = np.random.default_rng(24)
    S = _compressed_like(rng, nrows, ncols, 0.15, 4)
    w = rng.uniform(0.5, 2.0, nrows)
    jk = jsparse.apply_row_weights_packed(jsparse.pack_dense(S), w)
    tk = tsparse.apply_row_weights_packed(tsparse.pack_dense(S, device="cpu"), w)
    _assert_packed_equal(tk, jk)
    with pytest.raises(ValueError):
        tsparse.apply_row_weights_packed(tk, w[:-1])


@pytest.mark.parametrize("transpose", [False, True], ids=["strided-adjoint", "stored-transpose"])
@pytest.mark.parametrize("pad_rows,pad_cols", [(0, 0), (3, 0), (0, 5), (2, 7)])
def test_dense_kernel_matches_jax_dense_kernel(pad_rows, pad_cols, transpose):
    """DenseKernel with and without zero padding on either axis and with and
    without the stored transpose: both products against the JAX package's
    operator and the logical matrix, 1e-12 of the largest output."""
    rng = np.random.default_rng(25)
    nrows, ncols = 11, 30
    S = rng.normal(size=(nrows, ncols))
    Sp = np.zeros((nrows + pad_rows, ncols + pad_cols))
    Sp[:nrows, :ncols] = S
    nr, nc = (nrows if pad_rows else None), (ncols if pad_cols else None)
    ST = np.ascontiguousarray(Sp.T) if transpose else None
    tk = convert.dense_kernel_from_numpy(Sp, ST, ncols_true=nc, nrows_true=nr, device="cpu")
    jk = jsparse.DenseKernel(jnp.asarray(Sp), None if ST is None else jnp.asarray(ST), nc, nr)
    assert (tk.nrows, tk.ncols) == (jk.nrows, jk.ncols) == (nrows, ncols)
    assert tk.nbytes == Sp.nbytes * (2 if transpose else 1)
    x, u = rng.normal(size=ncols), rng.normal(size=nrows)
    y, g = tk.matvec(torch.as_tensor(x)), tk.rmatvec(torch.as_tensor(u))
    assert y.shape == (nrows,) and g.shape == (ncols,)
    for got, jax_out, dense in ((y, jk.matvec(jnp.asarray(x)), S @ x), (g, jk.rmatvec(jnp.asarray(u)), S.T @ u)):
        tol = 1e-12 * np.abs(dense).max()
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), rtol=0, atol=tol)
        np.testing.assert_allclose(got.numpy(), dense, rtol=0, atol=tol)


# ------------------------------------------------- the dense build and its cache


def _grid_dict(nx, ny, nz, h=(100.0, 80.0, 50.0)):
    k, j, i = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    i, j, k = (a.reshape(-1).astype(float) for a in (i, j, k))
    return dict(
        nx=nx, ny=ny, nz=nz,
        X1=i * h[0], X2=(i + 1) * h[0], Y1=j * h[1], Y2=(j + 1) * h[1], Z1=k * h[2], Z2=(k + 1) * h[2],
    )


def _problem(nx, ny, nz, nd, ctype, rate, seed):
    rng = np.random.default_rng(seed)
    g = _grid_dict(nx, ny, nz)
    X = rng.uniform(0, nx * 100.0, nd)
    Y = rng.uniform(0, ny * 80.0, nd)
    Z = -rng.uniform(0.5, 20.0, nd)
    kw = dict(nx=nx, ny=ny, nz=nz, ndata=nd, compression_type=ctype, compression_rate=rate, depth_weighting_type=1)
    cw = rng.uniform(1.0, 3.0, nx * ny * nz)
    return g, (X, Y, Z), kw, cw


def _build_both(dims, nd, ctype, rate, batch, seed=30):
    g, (X, Y, Z), kw, cw = _problem(*dims, nd, ctype, rate, seed)
    kj = jsens.compute_sensitivity(
        JGravParams(**kw), JGrid(**g), JSurveyData(ndata=nd, X=X, Y=Y, Z=Z), cw,
        compute_dtype=jnp.float64, store_dtype=jnp.float32, batch_size=batch,
    )
    seen = []
    kt = tsens.compute_sensitivity(
        TGravParams(**kw), TGrid(**g), TSurveyData(ndata=nd, X=X, Y=Y, Z=Z), cw,
        compute_dtype=torch.float64, store_dtype=torch.float32, batch_size=batch,
        progress=lambda done, total: seen.append((done, total)), device="cpu",
    )
    assert seen and seen[-1] == (nd, nd)
    return g, kw, cw, kj, kt


@pytest.mark.parametrize(
    "dims,nd,ctype,rate,batch",
    [((8, 8, 4), 12, 1, 0.15, 256), ((16, 8, 4), 21, 1, 0.1, 8), ((8, 8, 4), 9, 2, 0.2, 4), ((8, 4, 4), 7, 0, 1.0, 3)],
    ids=["haar", "haar-chunked", "d4", "uncompressed"],
)
def test_dense_build_matches_jax(dims, nd, ctype, rate, batch):
    """compute_sensitivity without a row sink in both packages, float64 build
    stored float32 in the solver's 2-D layout: the same entries kept, values
    to 1e-6 of the largest (one float32 rounding of two float64 results that
    differ in their last bits), nnz equal, comp_error rtol 1e-9."""
    _, _, _, kj, kt = _build_both(dims, nd, ctype, rate, batch)
    Sj, St = np.asarray(kj.S), kt.S.numpy()
    assert St.dtype == Sj.dtype == np.float32 and St.shape == Sj.shape == (nd, dims[0] * dims[1] * dims[2])
    assert kt.nnz == kj.nnz and (kt.nrows, kt.N, kt.compression_type) == (kj.nrows, kj.N, kj.compression_type)
    np.testing.assert_array_equal(St != 0, Sj != 0)
    np.testing.assert_allclose(St, Sj, rtol=0, atol=1e-6 * np.abs(Sj).max())
    np.testing.assert_allclose(kt.comp_error, kj.comp_error, rtol=1e-9, atol=0)


def test_dense_build_equals_streamed_build():
    """The same chunks, kept on the device or handed to a sink: equal."""
    g, (X, Y, Z), kw, cw = _problem(8, 8, 4, 10, 1, 0.2, 31)
    args = (TGravParams(**kw), TGrid(**g), TSurveyData(ndata=10, X=X, Y=Y, Z=Z), cw)
    dense = tsens.compute_sensitivity(*args, batch_size=4, device="cpu")
    chunks = []
    streamed = tsens.compute_sensitivity(*args, batch_size=4, row_sink=lambda c, s: chunks.append(c), device="cpu")
    assert streamed.S is None and streamed.nnz == dense.nnz and streamed.comp_error == dense.comp_error
    assert torch.equal(dense.S, torch.cat(chunks).reshape(10, -1))


def test_uncompressed_dense_build_reports_a_non_finite_row():
    """An observation on the grid's top face above a cell edge: the
    uncompressed dense build raises, as the streamed one does."""
    g, (X, Y, Z), kw, cw = _problem(4, 4, 2, 3, 0, 1.0, 32)
    X[1], Y[1], Z[1] = 50.0, 80.0, 0.0
    with pytest.raises(FloatingPointError):
        tsens.compute_sensitivity(TGravParams(**kw), TGrid(**g), TSurveyData(ndata=3, X=X, Y=Y, Z=Z), cw, device="cpu")


@pytest.mark.parametrize("ctype", [0, 1])
def test_row_weights_and_forward_data_on_a_dense_kernel_match_jax(ctype):
    """apply_row_weights on one and the same float32 matrix: array_equal and
    in place; calculate_data through the weighted dense kernel: rtol 1e-12."""
    rng = np.random.default_rng(33)
    nd, dims = 9, (8, 4, 4)
    N = dims[0] * dims[1] * dims[2]
    S = rng.normal(size=(nd, N)).astype(np.float32)
    dw = rng.uniform(0.5, 2.0, (nd, 1))
    cw = rng.uniform(1.0, 3.0, N)
    m = rng.normal(size=(1, N))
    meta = dict(ndata=nd, ndata_components=1, nmodel_components=1, nx=dims[0], ny=dims[1], nz=dims[2],
                compression_type=ctype)
    kj = jsens.apply_row_weights(jsens.SensitKernel(S=jnp.asarray(S), **meta), 0.7, dw)
    unweighted = tsens.SensitKernel(S=torch.tensor(S), **meta)
    storage = unweighted.S.data_ptr()
    kt = tsens.apply_row_weights(unweighted, 0.7, dw)
    assert unweighted.S is None and kt.S.data_ptr() == storage
    np.testing.assert_array_equal(kt.S.numpy(), np.asarray(kj.S))
    dj = jsens.calculate_data(kj, m, cw, 0.7, dw, solve_dtype=jnp.float64)
    dt = tsens.calculate_data(kt, m, cw, 0.7, dw, ctype, *dims, solve_dtype=torch.float64, device="cpu")
    assert dt.shape == dj.shape == (nd, 1)
    np.testing.assert_allclose(dt, dj, rtol=1e-12, atol=0)
    with pytest.raises(ValueError):
        tsens.apply_row_weights(kt, 0.7, dw[:-1])


CACHE_FILES = ("sensit_grav_1_0", "sensit_grav_meta.txt", "sensit_grav_nnz", "sensit_grav_weight")


@pytest.mark.parametrize("ctype,rate", [(1, 0.15), (2, 0.3), (0, 1.0)], ids=["haar", "d4", "uncompressed"])
def test_kernel_cache_files_and_dense_readers_both_ways(tmp_path, ctype, rate):
    """One dense kernel (the JAX package's build) through write_kernel_cache
    of both packages: every file byte-equal. Then try_read_kernel_cache of
    each package on the other's files: the matrix array_equal to what was
    written, the counts and the error equal."""
    dims, nd = (8, 8, 4), 11
    g, kw, cw, kj, _ = _build_both(dims, nd, ctype, rate, 5, seed=34)
    S = np.asarray(kj.S)
    kt = tsens.SensitKernel(
        S=torch.tensor(S), ndata=nd, ndata_components=1, nmodel_components=1,
        nx=dims[0], ny=dims[1], nz=dims[2], compression_type=ctype, comp_error=kj.comp_error, nnz=kj.nnz,
    )
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    jcache.write_kernel_cache(dj, JGravParams(**kw), kj, cw)
    tcache.write_kernel_cache(dt, TGravParams(**kw), kt, cw)
    for f in CACHE_FILES:
        assert filecmp.cmp(os.path.join(dj, f), os.path.join(dt, f), shallow=False), f
    from_j = tcache.try_read_kernel_cache(dj, TGravParams(**kw), TGrid(**g), device="cpu")
    from_t = jcache.try_read_kernel_cache(dt, JGravParams(**kw), JGrid(**g))
    assert from_j.S.dtype == torch.float32
    np.testing.assert_array_equal(from_j.S.numpy(), S)
    np.testing.assert_array_equal(np.asarray(from_t.S), S)
    assert from_j.nnz == from_t.nnz == kj.nnz
    assert from_j.comp_error == from_t.comp_error
    assert (from_j.ndata, from_j.N, from_j.compression_type) == (nd, S.shape[1], ctype)


def _write_records(cache, Par, Grid, d, g, kw, cw, chunks, ctype):
    w = cache.SensitStreamWriter(d, Par(**kw), Grid(**g), cw, ctype)
    w.write_chunk(chunks, 0)
    w.finalize(2.5e-3)


@pytest.mark.parametrize("flush", [16 << 20, 37], ids=["one-batch", "many-batches"])
@pytest.mark.parametrize(
    "nmc,ndc,ctype,keep", [(1, 1, 1, 0.25), (3, 1, 1, 0.25), (1, 2, 1, 0.1), (1, 1, 0, 0.5)],
    ids=["grav", "three-model-components", "two-data-components", "uncompressed-records"],
)
def test_packed_reader_equals_jax_both_ways(tmp_path, monkeypatch, nmc, ndc, ctype, keep, flush):
    """read_kernel_cache_packed of each package on files the other wrote:
    all seven arrays array_equal, whether the port's reader takes the file in
    one batch or in many; the heavy columns are those every row keeps. With
    one model component the column histogram is the cache's _nnz file, with
    three it is rebuilt from the records."""
    rng = np.random.default_rng(35)
    nd, dims = 14, (8, 4, 2)
    N = dims[0] * dims[1] * dims[2]
    g, _, kw, cw = _problem(*dims, nd, ctype, 0.2, 36)
    Par_j, Par_t = (JGravParams, TGravParams) if nmc == 1 else (JMagParams, TMagParams)
    kw.update(nmodel_components=nmc, ndata_components=ndc)
    chunks = rng.normal(size=(nd, ndc, nmc, N)).astype(np.float32)
    chunks[rng.random(chunks.shape) > keep] = 0.0
    chunks[..., :2] = rng.normal(size=(nd, ndc, nmc, 2))  # columns that every row keeps
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    _write_records(jcache, Par_j, JGrid, dj, g, kw, cw, chunks, ctype)
    _write_records(tcache, Par_t, TGrid, dt, g, kw, cw, chunks, ctype)
    monkeypatch.setattr(tcache, "iter_cache_coo", functools.partial(tcache.iter_cache_coo, flush=flush))
    tk, tmeta = tcache.read_kernel_cache_packed(dj, Par_t(**kw), TGrid(**g), col_cap_factor=2.0, device="cpu")
    jk, jmeta = jcache.read_kernel_cache_packed(dt, Par_j(**kw), JGrid(**g), col_cap_factor=2.0)
    assert tmeta == jmeta
    _assert_packed_equal(tk, jk)
    # Uncompressed records store every entry, so no column stands out there.
    assert tk.dense_block.shape[1] >= (2 * nmc if ctype else 0) and tk.light_vals.shape[0] > 0
    # ... and the pack is the matrix: both products against the dense one.
    S = chunks.reshape(nd * ndc, nmc * N).astype(np.float64)
    x, u = rng.normal(size=nmc * N), rng.normal(size=nd * ndc)
    np.testing.assert_allclose(tk.matvec(torch.as_tensor(x)).numpy(), S @ x, rtol=0, atol=1e-12 * np.abs(S @ x).max())
    np.testing.assert_allclose(tk.rmatvec(torch.as_tensor(u)).numpy(), S.T @ u, rtol=0,
                               atol=1e-12 * np.abs(S.T @ u).max())


def test_packed_reader_equals_pack_dense_of_the_dense_reader(tmp_path):
    """Inside the port: the streamed pack of a cache equals pack_dense of
    the matrix the dense reader gives."""
    g, kw, cw, _, kt = _build_both((8, 8, 4), 13, 1, 0.15, 256, seed=37)
    d = str(tmp_path / "c")
    tcache.write_kernel_cache(d, TGravParams(**kw), kt, cw)
    streamed, meta = tcache.read_kernel_cache_packed(d, TGravParams(**kw), TGrid(**g), device="cpu")
    dense = tcache.try_read_kernel_cache(d, TGravParams(**kw), TGrid(**g), device="cpu")
    assert meta["nnz"] == dense.nnz == kt.nnz
    packed = tsparse.pack_dense(dense.S, device="cpu")
    for f in PACKED_FIELDS:
        assert torch.equal(getattr(streamed, f), getattr(packed, f)), f


def test_readers_without_a_cache(tmp_path):
    g, _, kw, _ = _problem(4, 4, 2, 3, 1, 0.2, 38)
    par, grid = TGravParams(**kw), TGrid(**g)
    assert tcache.try_read_kernel_cache(str(tmp_path / "no"), par, grid, device="cpu") is None
    assert tcache.read_kernel_cache_packed(str(tmp_path / "no"), par, grid, device="cpu") == (None, None)
