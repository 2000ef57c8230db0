"""Port parity for the kernel module and what feeds it: the plain version of
tile_matvec against the JAX package's Pallas kernel (interpret mode) and its
XLA lowering, the tile-union packer against the JAX packer's arrays, the
sensitivity cache files, and the streamed build. CPU, numpy inputs from a
seed. The CUDA kernel itself cannot run without the card; chip_smoke.py holds
it against the plain version there."""

import filecmp
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tomofastx_tpu.config.parfile import GravParams as JGravParams
from tomofastx_tpu.io import sensit_cache as jcache
from tomofastx_tpu.models.data import SurveyData as JSurveyData
from tomofastx_tpu.models.grid import Grid as JGrid
from tomofastx_tpu.ops import pallas_kernels as jpk
from tomofastx_tpu.ops import sensitivity as jsens
from tomofastx_tpu.ops import tile_kernel as jtile

from tomofastx_tpu_torch import convert
from tomofastx_tpu_torch.config.parfile import GravParams as TGravParams
from tomofastx_tpu_torch.io import sensit_cache as tcache
from tomofastx_tpu_torch.models.data import SurveyData as TSurveyData
from tomofastx_tpu_torch.models.grid import Grid as TGrid
from tomofastx_tpu_torch.ops import sensitivity as tsens
from tomofastx_tpu_torch.ops import tile_kernel as ttile
from tomofastx_tpu_torch.ops import tile_matvec as tmv

PACK_FIELDS = ("uvals", "ubidx", "uvalsT", "ubidxT")


def _rand_sparse(rng, nrows, ncols, keep=0.2):
    S = rng.normal(size=(nrows, ncols)).astype(np.float32)
    S[rng.random(S.shape) > keep] = 0.0
    return S


def _assert_packs_equal(tk, jk):
    for f in PACK_FIELDS:
        a, b = getattr(tk, f).numpy(), np.asarray(getattr(jk, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (tk.nrows, tk.ncols) == (jk.nrows, jk.ncols)


# ------------------------------------------------------- the kernel module


@pytest.mark.parametrize("nrows,N,keep", [(16, 384, 0.3), (27, 512, 0.15), (512, 384, 0.3), (5, 128, 1.0)])
def test_plain_matches_pallas_interpret_and_xla(nrows, N, keep):
    """float32 vector: tile_matvec_plain against the Pallas kernel under the
    interpreter and against tile_matvec_xla, as the JAX package's own tests
    run them. rtol 1e-5 of the largest output (float32 sums in another
    order)."""
    rng = np.random.default_rng(6)
    S = _rand_sparse(rng, nrows, N, keep)
    uvals, ubidx, _ = jpk.pack_tile_union(S, tm=8)
    x = rng.normal(size=(N,)).astype(np.float32)
    got = tmv.tile_matvec_plain(torch.as_tensor(uvals), torch.as_tensor(ubidx), torch.as_tensor(x))
    assert got.dtype == torch.float32 and got.shape == (uvals.shape[0] * 8,)
    uv, ub, xj = jnp.asarray(uvals), jnp.asarray(ubidx), jnp.asarray(x)
    scale = np.abs(S.astype(np.float64) @ x).max()
    for want in (jpk.tile_matvec(uv, ub, xj, interpret=True), jpk.tile_matvec_xla(uv, ub, xj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(-1), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("nrows,ncols", [(27, 333), (8, 128), (40, 256), (3, 1000), (130, 77)])
def test_wrapper_on_cpu_matches_dense_products_f64(nrows, ncols):
    """float64 vector through TileKernel.matvec / rmatvec (the wrapper takes
    the plain version for CPU tensors) against S @ x and S^T @ u, rows and
    columns uneven against 8 and 128: 1e-12 of the largest output."""
    rng = np.random.default_rng(7)
    S = _rand_sparse(rng, nrows, ncols)
    tk = ttile.pack_tiles(S, device="cpu")
    Sd = S.astype(np.float64)
    x, u = rng.normal(size=ncols), rng.normal(size=nrows)
    before = tmv.tile_matvec.launches
    y = tk.matvec(torch.as_tensor(x))
    g = tk.rmatvec(torch.as_tensor(u))
    assert tmv.tile_matvec.launches == before  # no kernel launch on the CPU
    assert y.dtype == torch.float64 and y.shape == (nrows,) and g.shape == (ncols,)
    np.testing.assert_allclose(y.numpy(), Sd @ x, rtol=0, atol=1e-12 * np.abs(Sd @ x).max())
    np.testing.assert_allclose(g.numpy(), Sd.T @ u, rtol=0, atol=1e-12 * np.abs(Sd.T @ u).max())


def test_tile_kernel_matches_jax_tile_kernel_products():
    """Same pack, same vectors, both packages' operators: 1e-12."""
    rng = np.random.default_rng(8)
    S = _rand_sparse(rng, 45, 300)
    jk = jtile.pack_tiles(S)
    tk = convert.tile_kernel_from_numpy(
        *[np.asarray(getattr(jk, f)) for f in PACK_FIELDS], jk.nrows, jk.ncols, device="cpu"
    )
    x, u = rng.normal(size=300), rng.normal(size=45)
    np.testing.assert_allclose(
        tk.matvec(torch.as_tensor(x)).numpy(), np.asarray(jk.matvec(jnp.asarray(x))), rtol=1e-12, atol=1e-12
    )
    np.testing.assert_allclose(
        tk.rmatvec(torch.as_tensor(u)).numpy(), np.asarray(jk.rmatvec(jnp.asarray(u))), rtol=1e-12, atol=1e-12
    )
    assert tk.nbytes == jk.nbytes


@pytest.mark.parametrize(
    "bad",
    ["uvals_shape", "ubidx_shape", "x_len", "uvals_dtype", "ubidx_dtype", "x_dtype", "x_ndim"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    uvals = torch.zeros(2, 3, 8, 128)
    ubidx = torch.zeros(2, 3, dtype=torch.int32)
    x = torch.zeros(256)
    if bad == "uvals_shape":
        uvals = torch.zeros(2, 3, 4, 128)
    elif bad == "ubidx_shape":
        ubidx = torch.zeros(2, 4, dtype=torch.int32)
    elif bad == "x_len":
        x = torch.zeros(200)
    elif bad == "uvals_dtype":
        uvals = uvals.double()
    elif bad == "ubidx_dtype":
        ubidx = ubidx.long()
    elif bad == "x_dtype":
        x = x.half()
    elif bad == "x_ndim":
        x = torch.zeros(2, 128)
    with pytest.raises((ValueError, TypeError)):
        tmv.tile_matvec(uvals, ubidx, x)


def test_operator_rejects_wrong_vector_length():
    tk = ttile.pack_tiles(np.eye(9, 140, dtype=np.float32), device="cpu")
    with pytest.raises(ValueError):
        tk.matvec(torch.zeros(141, dtype=torch.float64))
    with pytest.raises(ValueError):
        tk.rmatvec(torch.zeros(8, dtype=torch.float64))


def test_pack_with_block_ids_out_of_range_is_refused():
    uv, ub = np.zeros((1, 2, 8, 128), np.float32), np.array([[0, 3]], np.int32)
    uvT, ubT = np.zeros((32, 1, 8, 128), np.float32), np.zeros((32, 1), np.int32)
    convert.tile_kernel_from_numpy(uv, ub, uvT, ubT, nrows=8, ncols=512, device="cpu")  # 4 blocks: fine
    with pytest.raises(ValueError):
        convert.tile_kernel_from_numpy(uv, ub, uvT, ubT, nrows=8, ncols=256, device="cpu")  # 2 blocks
    with pytest.raises(ValueError):
        convert.tile_kernel_from_numpy(uv, -ub, uvT, ubT, nrows=8, ncols=512, device="cpu")


def test_kernel_source_is_shipped_with_the_package():
    assert os.path.exists(tmv._SOURCE)
    src = open(tmv._SOURCE).read()
    assert 'extern "C" int tile_matvec_f32' in src and 'extern "C" int tile_matvec_f64' in src


def _sum_orders(bu, ntiles):
    """Each tile's sum order under the launch's plan: for every block of
    the tile (by rank among the tile's blocks) and every warp that adds its
    slots, that warp's slots in order; and how often each (tile, slot) is
    added."""
    cluster, rows, nblocks = tmv.launch_table([ntiles], bu)
    assert rows == [(0, 0, ntiles)]
    blocks, tiles = tmv.work_plan(bu)
    added, orders = {}, {}
    for lb in range(nblocks):
        for w, (tile, slots) in enumerate(tmv.block_slots(bu, ntiles, lb)):
            for b in slots:
                added[tile, b] = added.get((tile, b), 0) + 1
            if slots:
                # A short tile is one warp's: which warp does not change its order.
                key = (lb % blocks, w) if bu > tmv.SHORT else (0, 0)
                orders.setdefault(tile, {})[key] = slots
    return added, orders, cluster


@pytest.mark.parametrize("bu", [1, 31, 32, 37, 255, 256, 257, 1932, 1955])
def test_the_work_plan_adds_every_slot_once_in_an_order_set_by_bu(bu):
    """The kernel's work plan (tmv.work_plan, block_slots, launch_table):
    every slot of every tile is added exactly once, and each tile's sum
    order (which block, which warp, in which order) depends on BU alone:
    equal for every tile, for any number of tiles, and that of the kernel
    of one block a tile before it (8 chains of every 8th slot)."""
    want_order = None
    for ntiles in (1, 5, 13):
        added, orders, cluster = _sum_orders(bu, ntiles)
        assert added == {(t, b): 1 for t in range(ntiles) for b in range(bu)}
        for tile in range(ntiles):
            want_order = want_order or orders[0]
            assert orders[tile] == want_order
        blocks, tiles = tmv.work_plan(bu)
        assert (blocks, tiles) == ((1, tmv.WARPS) if bu <= tmv.SHORT else (tmv.CHAINS, 1))
        assert cluster == int(bu > tmv.SHORT)
        # The mode follows BU, whatever the tiles a block (one, say).
        assert tmv.launch_table([ntiles], bu, warps=1)[0] == cluster
    # Either way the order of the one-block-a-tile kernel: chain c adds slots
    # c, c + 8, ..., and the chains follow one another.
    assert [b for key in sorted(want_order) for b in want_order[key]] == tmv.chain_order(bu)
    assert tmv.chain_order(bu) == [b for c in range(8) for b in range(c, bu, 8)]


@pytest.mark.parametrize("bu", [31, 257])
def test_the_group_table_of_one_launch_over_parts(bu):
    """Kernel 2's one launch over parts of (7, 0, 20, 18) tiles: each part's
    outputs start where the one before ends, its blocks follow the one
    before's, and its blocks add each of its slots once."""
    part_tiles = [7, 0, 20, 18]
    cluster, rows, nblocks = tmv.launch_table(part_tiles, bu)
    blocks, tiles = tmv.work_plan(bu)
    assert [r[0] for r in rows] == [0, 7, 7, 27] and [r[2] for r in rows] == part_tiles
    per_part = [-(-n // tiles) * blocks for n in part_tiles]
    assert [r[1] for r in rows] == [0, per_part[0], per_part[0], per_part[0] + per_part[2]]
    assert nblocks == sum(per_part)
    for (tile0, block0, n), nb in zip(rows, per_part):
        added, _, _ = _sum_orders(bu, n) if n else ({}, None, None)
        assert sum(added.values()) == n * bu and len(added) == n * bu
        # A cluster's blocks never straddle two parts.
        assert block0 % blocks == 0 and nb % blocks == 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("cuts", [(26,), (9, 9, 8), (7, 1, 12, 6)])
def test_sharded_product_over_cpu_slots_equals_one_product(cuts, dtype):
    """tile_matvec_sharded over 1, 3 and 4 CPU slots, ragged parts
    included, equals one tile_matvec on the whole pack to the last bit."""
    rng = np.random.default_rng(len(cuts))
    uv = torch.from_numpy(rng.normal(size=(26, 37, 8, 128)).astype(np.float32))
    ub = torch.from_numpy(rng.integers(0, 50, size=(26, 37)).astype(np.int32))
    x = torch.from_numpy(rng.normal(size=50 * 128)).to(dtype)
    starts = np.cumsum((0,) + cuts)
    parts = [(uv[a:b].clone(), ub[a:b].clone()) for a, b in zip(starts[:-1], starts[1:])]
    got = tmv.tile_matvec_sharded(parts, x, "cpu")
    assert got.dtype == dtype and torch.equal(got, tmv.tile_matvec(uv, ub, x))


# ----------------------------------------------------------------- packer


@pytest.mark.parametrize(
    "nrows,ncols,keep", [(27, 333, 0.2), (40, 256, 0.2), (8, 128, 0.5), (100, 1000, 0.02), (17, 129, 1.0), (9, 300, 0.0)]
)
def test_pack_tiles_equals_jax_packs(nrows, ncols, keep):
    rng = np.random.default_rng(1)
    S = _rand_sparse(rng, nrows, ncols, keep)
    _assert_packs_equal(ttile.pack_tiles(S, device="cpu"), jtile.pack_tiles(S))


def test_streaming_coo_pack_equals_jax_streaming_pack():
    """Ragged chunks of nonzeros in shuffled order through scan_coo/fill_coo."""
    rng = np.random.default_rng(2)
    nrows, ncols = 53, 700
    S = _rand_sparse(rng, nrows, ncols, 0.1)
    r, c = np.nonzero(S)
    perm = rng.permutation(r.size)
    r, c = r[perm], c[perm]
    v = S[r, c]
    tb, jb = ttile.TileKernelBuilder(nrows, ncols, device="cpu"), jtile.TileKernelBuilder(nrows, ncols)
    cuts = [0, 5, 400, r.size]
    for b in (tb, jb):
        for s, e in zip(cuts[:-1], cuts[1:]):
            b.scan_coo(r[s:e], c[s:e])
        b.finalize_scan()
        for s, e in zip(cuts[:-1], cuts[1:]):
            b.fill_coo(r[s:e], c[s:e], v[s:e])
    assert (tb.BU, tb.BUT) == (jb.BU, jb.BUT)
    np.testing.assert_array_equal(tb.slot_f.numpy(), jb.slot_f)
    np.testing.assert_array_equal(tb.slot_a.numpy(), jb.slot_a)
    _assert_packs_equal(tb.build(), jb.build())


def test_fill_before_scan_raises():
    b = ttile.TileKernelBuilder(8, 128, device="cpu")
    with pytest.raises(RuntimeError):
        b.fill_coo(np.array([0]), np.array([0]), np.array([1.0], np.float32))


@pytest.mark.parametrize("nrows,ncols", [(27, 333), (130, 200)])
def test_apply_row_weights_equals_jax(nrows, ncols):
    rng = np.random.default_rng(3)
    S = _rand_sparse(rng, nrows, ncols)
    w = rng.uniform(0.5, 2.0, nrows)
    jk = jtile.apply_row_weights_tiled(jtile.pack_tiles(S), w)
    tk = ttile.apply_row_weights_tiled(ttile.pack_tiles(S, device="cpu"), w)
    _assert_packs_equal(tk, jk)
    with pytest.raises(ValueError):
        ttile.apply_row_weights_tiled(tk, w[:-1])


def test_solver_state_from_numpy():
    rng = np.random.default_rng(4)
    m = rng.normal(size=(1, 12))
    st = convert.solver_state_from_numpy(
        [m], [m * 0], [np.ones(12)], [np.zeros(12)], [np.zeros(12)], [1e-7, 1e5], dtype=torch.float32, device="cpu"
    )
    assert set(st) == {"model", "prior", "cw", "admm_z", "admm_u", "rho_admm"}
    assert st["model"][0].dtype == torch.float32 and st["model"][0].shape == (1, 12)
    np.testing.assert_allclose(st["model"][0].numpy(), m.astype(np.float32))
    np.testing.assert_allclose(st["rho_admm"].numpy(), np.array([1e-7, 1e5], np.float32))


# ------------------------------------------------- cache files and the build


def _grid_dict(nx, ny, nz, h=(100.0, 100.0, 50.0)):
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
    Y = rng.uniform(0, ny * 100.0, nd)
    Z = -rng.uniform(0.5, 20.0, nd)
    kw = dict(nx=nx, ny=ny, nz=nz, ndata=nd, compression_type=ctype, compression_rate=rate,
              depth_weighting_type=1, kernel_format="tiled")
    cw = rng.uniform(1.0, 3.0, nx * ny * nz)
    return g, (X, Y, Z), kw, cw


CACHE_FILES = ("sensit_grav_1_0", "sensit_grav_meta.txt", "sensit_grav_nnz", "sensit_grav_weight")


@pytest.mark.parametrize("ctype", [0, 1])
def test_stream_writer_files_byte_equal(tmp_path, ctype):
    """The same float32 chunks through both writers: every file byte-equal."""
    rng = np.random.default_rng(5)
    g, _, kw, cw = _problem(8, 4, 2, 11, ctype, 0.2, 5)
    chunks = rng.normal(size=(11, 1, 1, 64)).astype(np.float32)
    chunks[rng.random(chunks.shape) > 0.3] = 0.0
    dirs = {}
    for name, mod, Par, Grid in (("j", jcache, JGravParams, JGrid), ("t", tcache, TGravParams, TGrid)):
        d = str(tmp_path / name)
        w = mod.SensitStreamWriter(d, Par(**kw), Grid(**g), cw, ctype)
        w.write_chunk(chunks[:4], 0)
        w.write_chunk(chunks[4:], 4)
        w.finalize(1.25e-3)
        dirs[name] = d
    for f in CACHE_FILES:
        assert filecmp.cmp(os.path.join(dirs["j"], f), os.path.join(dirs["t"], f), shallow=False), f
    # ... and each package reads the other's files.
    tmeta = tcache.read_cache_meta(dirs["j"], TGravParams(**kw), TGrid(**g))
    jmeta = jcache.read_cache_meta(dirs["t"], JGravParams(**kw), JGrid(**g))
    assert tmeta == jmeta
    for a, b in zip(tcache.iter_cache_rows(dirs["j"], tmeta), jcache.iter_cache_rows(dirs["t"], jmeta)):
        assert a[:3] == b[:3]
        np.testing.assert_array_equal(a[3], b[3])
        np.testing.assert_array_equal(a[4], b[4])


def test_stream_writer_refuses_incomplete_and_reader_checks_meta(tmp_path):
    g, _, kw, cw = _problem(4, 4, 2, 3, 1, 0.2, 6)
    w = tcache.SensitStreamWriter(str(tmp_path), TGravParams(**kw), TGrid(**g), cw, 1)
    w.write_chunk(np.ones((2, 1, 1, 32), np.float32), 0)
    with pytest.raises(ValueError):
        w.finalize(0.0)
    assert tcache.read_cache_meta(str(tmp_path / "none"), TGravParams(**kw), TGrid(**g)) is None


@pytest.mark.parametrize(
    "dims,nd,ctype,rate,batch",
    [((8, 8, 4), 12, 1, 0.15, 256), ((16, 8, 4), 21, 1, 0.1, 8), ((8, 8, 4), 9, 2, 0.2, 4)],
)
def test_streamed_build_cache_and_packs_match_jax(tmp_path, dims, nd, ctype, rate, batch):
    """compute_sensitivity(row_sink=writer) in both packages, float64 build
    stored float32, then cache -> tile packs in both. nnz per cell and per
    row equal; kept values 1e-6 of the largest (one float32 rounding of two
    float64 results that differ in the last bits); comp_error rtol 1e-9;
    packs of the same cache array_equal."""
    g, (X, Y, Z), kw, cw = _problem(*dims, nd, ctype, rate, 9)
    out = {}
    for name, sens, cache, Par, Grid, Data, f64, f32, extra in (
        ("j", jsens, jcache, JGravParams, JGrid, JSurveyData, jnp.float64, jnp.float32, {}),
        ("t", tsens, tcache, TGravParams, TGrid, TSurveyData, torch.float64, torch.float32, {"device": "cpu"}),
    ):
        d = str(tmp_path / name)
        par, grid = Par(**kw), Grid(**g)
        w = cache.SensitStreamWriter(d, par, grid, cw, ctype)
        k = sens.compute_sensitivity(
            par, grid, Data(ndata=nd, X=X, Y=Y, Z=Z), cw, compute_dtype=f64, store_dtype=f32,
            batch_size=batch, row_sink=w.write_chunk, **extra,
        )
        w.finalize(k.comp_error)
        out[name] = (d, k, par, grid)
    (dj, kj, parj, gridj), (dt, kt, part, gridt) = out["j"], out["t"]
    assert kt.S is None and kt.nnz == kj.nnz
    np.testing.assert_allclose(kt.comp_error, kj.comp_error, rtol=1e-9)
    assert filecmp.cmp(os.path.join(dj, "sensit_grav_nnz"), os.path.join(dt, "sensit_grav_nnz"), shallow=False)
    assert filecmp.cmp(os.path.join(dj, "sensit_grav_weight"), os.path.join(dt, "sensit_grav_weight"), shallow=False)
    mt = tcache.read_cache_meta(dt, part, gridt)
    mj = jcache.read_cache_meta(dj, parj, gridj)
    vmax = 0.0
    rows_t = list(tcache.iter_cache_rows(dt, mt))
    rows_j = list(jcache.iter_cache_rows(dj, mj))
    assert len(rows_t) == len(rows_j) == nd
    for a, b in zip(rows_j, rows_t):
        vmax = max(vmax, float(np.abs(a[4]).max()))
    for a, b in zip(rows_j, rows_t):
        assert a[:3] == b[:3]
        np.testing.assert_array_equal(a[3], b[3])
        np.testing.assert_allclose(b[4], a[4], rtol=0, atol=1e-6 * vmax)

    # Packs from ONE cache (the JAX package's) through both readers: equal.
    tk, tmeta = ttile.tile_kernel_from_cache(dj, part, gridt, device="cpu")
    jk, jmeta = jtile.tile_kernel_from_cache(dj, parj, gridj)
    assert tmeta["nnz"] == jmeta["nnz"] == kj.nnz
    _assert_packs_equal(tk, jk)


def test_tile_kernel_from_cache_small_flush_and_missing(tmp_path, monkeypatch):
    """Absent cache -> (None, None); the packs do not depend on how the
    stream is cut into batches."""
    g, (X, Y, Z), kw, cw = _problem(8, 8, 4, 10, 1, 0.2, 10)
    par, grid = TGravParams(**kw), TGrid(**g)
    assert ttile.tile_kernel_from_cache(str(tmp_path / "no"), par, grid, device="cpu") == (None, None)
    d = str(tmp_path / "c")
    w = tcache.SensitStreamWriter(d, par, grid, cw, 1)
    k = tsens.compute_sensitivity(par, grid, TSurveyData(ndata=10, X=X, Y=Y, Z=Z), cw, row_sink=w.write_chunk, device="cpu")
    w.finalize(k.comp_error)
    one, _ = ttile.tile_kernel_from_cache(d, par, grid, device="cpu")
    rows = [(i, c, v) for i, _, _, c, v in tcache.iter_cache_rows(d, tcache.read_cache_meta(d, par, grid))]
    b = ttile.TileKernelBuilder(10, 256, device="cpu")
    for i, c, v in rows:
        b.scan_coo(np.full(c.size, i), c)
    b.finalize_scan()
    for i, c, v in rows:
        b.fill_coo(np.full(c.size, i), c, v)
    two = b.build()
    for f in PACK_FIELDS:
        assert torch.equal(getattr(one, f), getattr(two, f))


def test_compute_sensitivity_refuses_unported_paths():
    """Every forward family builds, and every build variant: nothing is
    refused any more. The float32 build (--build-precision single) and
    tpu.f64BuildF32Compress return kernels of the build's shape (their
    values: tests/test_torch_build_variants.py)."""
    g, (X, Y, Z), kw, cw = _problem(4, 4, 2, 3, 1, 0.2, 11)
    par, grid, data = TGravParams(**kw), TGrid(**g), TSurveyData(ndata=3, X=X, Y=Y, Z=Z)
    from tomofastx_tpu_torch.config.parfile import MagParams

    k32 = tsens.compute_sensitivity(par, grid, data, cw, compute_dtype=torch.float32, device="cpu")
    assert k32.S.shape == (3, 32) and k32.S.dtype == torch.float32 and bool(torch.isfinite(k32.S).all())
    kc = tsens.compute_sensitivity(TGravParams(**kw, f64_build_f32_compress=1), grid, data, cw, device="cpu")
    assert kc.S.shape == (3, 32) and kc.S.dtype == torch.float32 and kc.nnz > 0
    assert tsens.compute_sensitivity(MagParams(**kw), grid, data, cw, row_sink=lambda c, s: None, device="cpu").S is None
    assert tsens.compute_sensitivity(MagParams(**kw), grid, data, cw, device="cpu").S.shape == (3, 32)
    # Without a row_sink a gravity kernel is accumulated densely (tests/test_torch_formats.py).
    assert tsens.compute_sensitivity(par, grid, data, cw, device="cpu").S.shape == (3, 32)


def test_observation_on_a_cell_edge_is_reported():
    """An observation on the grid's top face above a cell edge makes the
    closed forms non-finite. An uncompressed build raises in both packages.
    A compressed build raises in the port too: it checks the rows before the
    threshold, whose mask would turn the row's NaNs into zeros. The JAX
    package checks after it and stores the row as zeros (an intended
    divergence, PERF.md)."""
    g, (X, Y, Z), kw, cw = _problem(4, 4, 2, 3, 0, 0.2, 13)
    X[1], Y[1], Z[1] = 50.0, 100.0, 0.0
    with pytest.raises(FloatingPointError):
        tsens.compute_sensitivity(
            TGravParams(**kw), TGrid(**g), TSurveyData(ndata=3, X=X, Y=Y, Z=Z), cw,
            row_sink=lambda c, s: None, device="cpu",
        )
    with pytest.raises(FloatingPointError):
        jsens.compute_sensitivity(
            JGravParams(**kw), JGrid(**g), JSurveyData(ndata=3, X=X, Y=Y, Z=Z), cw,
            row_sink=lambda c, s: None,
        )
    kw["compression_type"] = 1
    with pytest.raises(FloatingPointError):
        tsens.compute_sensitivity(
            TGravParams(**kw), TGrid(**g), TSurveyData(ndata=3, X=X, Y=Y, Z=Z), cw,
            row_sink=lambda c, s: None, device="cpu",
        )
    chunks = []
    jsens.compute_sensitivity(
        JGravParams(**kw), JGrid(**g), JSurveyData(ndata=3, X=X, Y=Y, Z=Z), cw,
        row_sink=lambda c, s: chunks.append(np.asarray(c)),
    )
    assert not np.any(chunks[0][1])  # the JAX package's compressed build stores the row as zeros


def test_percell_build_matches_lattice_build(tmp_path):
    """tpu.latticeBuild = 0 takes the per-cell rows: same kept set, values
    1e-6 of the largest after float32 storage."""
    g, (X, Y, Z), kw, cw = _problem(8, 8, 4, 6, 1, 0.2, 12)
    got = {}
    for lat in (0, 1):
        par = TGravParams(**kw, lattice_build=lat)
        chunks = []
        tsens.compute_sensitivity(
            par, TGrid(**g), TSurveyData(ndata=6, X=X, Y=Y, Z=Z), cw,
            row_sink=lambda c, s: chunks.append(c.numpy()), device="cpu",
        )
        got[lat] = np.concatenate(chunks)
    assert got[0].shape == (6, 1, 1, 256) and got[0].dtype == np.float32
    np.testing.assert_array_equal(got[0] != 0, got[1] != 0)
    np.testing.assert_allclose(got[0], got[1], rtol=0, atol=1e-6 * np.abs(got[1]).max())
