"""The blend's near pass of kernels B3 and B2 on the CPU: the near lists that
the blended lattice and per-cell operators build once at construction hold
every (observation, cell) pair the JAX package's far mask calls near, each
once, and their transposes the same pairs; the plain version of the
kernels' split (the main loop with the near cells zeroed, plus the near pass
over the lists, summed in float64) equals the chunk loop and is as accurate
as the JAX package's float32 operators; the sharded operators' parts hold
the whole operator's near pairs between them; a blend without its lists is
refused, the lists count in nbytes, and the near-pass wrappers take the
plain version on CPU tensors without building a library. The stored near
rows, as their plain build lays them out for a blended operator or a
sharded part (on the card each builds its own with a kernel), hold every
pair the JAX package's far mask calls near once, by observation and by
cell, with the JAX package's closed forms; the plain product over them
equals the plain near passes; they count in nbytes, and a CPU operator
stores none.
The kernels themselves run on the card only: chip_smoke.py holds them
against these plain versions there."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tomofastx_tpu.models.grid import Grid as JGrid
from tomofastx_tpu.ops import matrixfree as jmf
from tomofastx_tpu.ops import prism as jprism
from tomofastx_tpu.ops import sensitivity as jsens

from tomofastx_tpu_torch.models.grid import Grid as TGrid
from tomofastx_tpu_torch.ops import _cuda_build
from tomofastx_tpu_torch.ops import lattice_matvec as lm
from tomofastx_tpu_torch.ops import matrixfree as tmf
from tomofastx_tpu_torch.ops import prism_matvec as pm
from tomofastx_tpu_torch.parallel import mesh as tmesh

from test_torch_matrixfree import grid_dict, problem, scattered

# The families of the split's checks: "mag_vec3" is the magnetization vector
# with three data components.
FAMILIES = ["grav_gz", "grav_ftg", "mag_tmi", "mag_vec3"]
SLOTS = 3


def _problem(case, g, X, Y, Z):
    jp, tp, jd, td, cw, w = problem("mag_3c" if case == "mag_vec3" else case, g, X, Y, Z)
    if case == "mag_vec3":
        jp.nmodel_components = tp.nmodel_components = 3
    return jp, tp, jd, td, cw, w


def _survey(kind):
    """A draped lattice survey (12 x 5 x 4 cells, 10 observations at heights
    varying point to point, two on lattice planes) or a topography grid (6 x
    5 x 4 cells, 9 observations): (grid, X, Y, Z)."""
    if kind == "lattice":
        g = grid_dict(12, 5, 4)
        X, Y, Z = scattered(g, 10, 4)
        X[:2], Y[:2] = g["X1"][[3, 7]], g["Y1"][[12, 36]]
        return g, X, Y, Z
    g = grid_dict(6, 5, 4, topography=True)
    return (g, *scattered(g, 9, 4))


def _operator(kind, case, dtype=torch.float32, **kw):
    g, X, Y, Z = _survey(kind)
    _, tp, _, td, cw, w = _problem(case, g, X, Y, Z)
    force = {"force_no_fft": True} if kind == "lattice" else {"force_generic": True}
    op = tmf.make_matrixfree_kernel(tp, TGrid(**g), td, cw, 1.7, w, dtype, chunk=4, validate=False, device="cpu",
                                    **force, **kw)
    assert isinstance(op, tmf.LatticeMatrixFreeKernel if kind == "lattice" else tmf.MatrixFreeKernel)
    return op


def _csr_pairs(ptr, idx):
    ptr, idx = ptr.long().numpy(), idx.long().numpy()
    return [(r, int(c)) for r in range(len(ptr) - 1) for c in idx[ptr[r] : ptr[r + 1]]]


def _jax_near(op, kind):
    """{(observation, cell)}: the pairs the JAX package's far mask
    (tomofastx_tpu/ops/prism.py far_mask) calls near in float32, every
    padded observation against every cell; for the lattice operator only
    the cells of the observation's window, as its _corr_window takes them
    (and none outside it)."""
    if kind == "lattice":
        k, j, i = (a.reshape(-1) for a in np.meshgrid(np.arange(op.nz), np.arange(op.ny), np.arange(op.nx),
                                                       indexing="ij"))
        xe, ye, ze = (a.numpy() for a in (op.xe, op.ye, op.ze))
        bounds = [jnp.asarray(b, jnp.float32) for b in (xe[i], xe[i + 1], ye[j], ye[j + 1], ze[k], ze[k + 1])]
    else:
        bounds = [jnp.asarray(a.numpy(), jnp.float32) for a in op.grid6]
    pts = [jnp.asarray(a.numpy(), jnp.float32)[:, None] for a in (op.xd, op.yd, op.zd)]
    near = ~np.asarray(jprism.far_mask(*pts, *bounds))
    pairs = {(int(b), int(n)) for b, n in zip(*np.nonzero(near))}
    if kind == "lattice":
        wi0 = op.wi0.numpy()
        inside = {(b, n) for b, n in pairs if all(
            0 <= i - wi0[b, a] < op.win[a] for a, i in enumerate((n // (op.nx * op.ny), (n // op.nx) % op.ny,
                                                                   n % op.nx)))}
        assert inside == pairs, "a near cell outside its observation's window"
    return pairs


def _listed(op, kind):
    """(pairs by observation, pairs by cell) of the operator's near lists."""
    if kind == "lattice":
        by_obs = _csr_pairs(op.near_ptr, op.near_cells)
    else:
        idx = op.near_idx.long().numpy() - op.cell_lo
        by_obs = [(b, int(n)) for b in range(idx.shape[0]) for n in idx[b] if 0 <= n < op.N]
    by_cell = [(b, n) for n, b in _csr_pairs(op.near_tptr, op.near_obs)]
    return by_obs, by_cell


@pytest.mark.parametrize("kind", ["lattice", "per_cell"])
@pytest.mark.parametrize("case", ["grav_gz", "mag_tmi"])
def test_near_lists_hold_every_near_pair_once(kind, case):
    """The lists by observation hold every pair the JAX package's float32
    far mask calls near, each once (the candidates are a superset, within
    1.001 times the near radius), in increasing order of cell; their
    transpose holds the same pairs, in increasing order of observation; all
    int32."""
    op = _operator(kind, case)
    lists = (op.near_ptr, op.near_cells, op.near_tptr, op.near_obs) if kind == "lattice" else (
        op.near_idx, op.near_tptr, op.near_obs)
    assert all(a.dtype == torch.int32 for a in lists)
    by_obs, by_cell = _listed(op, kind)
    near = _jax_near(op, kind)
    assert near and near <= set(by_obs)
    assert len(set(by_obs)) == len(by_obs)
    assert sorted(by_cell) == sorted(by_obs)
    assert by_cell == sorted(by_cell, key=lambda p: (p[1], p[0]))
    if kind == "lattice":
        assert by_obs == sorted(by_obs)
        assert op.near_ptr.shape[0] == op.xd.shape[0] + 1 and op.near_tptr.shape[0] == op.N + 1
        # Candidates of the window only: every one within the margin.
        assert len(by_obs) < 1.2 * len(near)


@pytest.mark.parametrize("kind", ["lattice", "per_cell"])
@pytest.mark.parametrize("case", FAMILIES)
def test_plain_split_equals_the_chunk_loop(kind, case):
    """The plain version of the kernels' split (main loop with the near cells
    zeroed, plus the near pass over the lists, in float64 sums) against the
    chunk loop on the float32 blend: within 1e-6 of max|y|."""
    op = _operator(kind, case)
    rng = np.random.default_rng(8)
    nmc, ndc = (op.nmc, op.ndc) if kind == "lattice" else (op.phys.nmc, op.phys.ndc)
    xw = op.cw[None, :] * torch.as_tensor(rng.normal(size=(nmc, op.N)), dtype=torch.float32)
    u = op.row_w * torch.as_tensor(rng.normal(size=(op.xd.shape[0], ndc)), dtype=torch.float32)
    for split, loop in ((op._split_matvec(xw), op._partial_matvec(xw)),
                        (op._split_rmatvec(u), op._partial_rmatvec(u))):
        assert split.dtype == torch.float32 and split.shape == loop.shape
        scale = float(loop.abs().max())
        assert float((split - loop).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("kind, case", [("lattice", "grav_gz"), ("lattice", "mag_vec3"), ("per_cell", "grav_gz")])
def test_plain_split_as_accurate_as_jax(kind, case):
    """The products through the plain split, weighted as the operator
    weights them, are no further from the float64 products than 1.5x the
    JAX package's own float32 error (the bound of the existing blend tests).
    The float64 products are the port's float64 operator's, which
    test_torch_matrixfree.py::test_operator_matches_jax_f64 holds to the JAX
    package's within 1e-10 of max|y|: the JAX package's float64 operator
    would only trace its products a second time."""
    g, X, Y, Z = _survey(kind)
    jp, tp, jd, td, cw, w = _problem(case, g, X, Y, Z)
    force = {"force_no_fft": True} if kind == "lattice" else {"force_generic": True}
    j32 = jmf.make_matrixfree_kernel(jp, JGrid(**g), jd, cw, 1.7, w, jnp.float32, validate=False, **force)
    op, op64 = _operator(kind, case), _operator(kind, case, torch.float64)
    rng = np.random.default_rng(4)
    x, u = rng.normal(size=op.ncols), rng.normal(size=op.nrows * (op.ndc if kind == "lattice" else op.phys.ndc))
    xt, ut = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(u, dtype=torch.float32)
    if kind == "lattice":
        y = (op.row_w * op._split_matvec(op.cw[None, :] * xt.reshape(op.nmc, op.N)))[: op.nrows].reshape(-1)
        gr = (op.cw[None, :] * op._split_rmatvec(op._padded_residual(ut))).reshape(-1)
    else:
        y = (op.row_w * op._split_matvec(op.cw[None, :] * op._padded_model(xt)))[: op.nrows].reshape(-1)
        gr = (op.cw[None, :] * op._split_rmatvec(op._padded_residual(ut)))[:, : op.N_true].reshape(-1)
    ref = [f(torch.as_tensor(v)).numpy() for f, v in ((op64.matvec, x), (op64.rmatvec, u))]
    jax32 = [np.asarray(f(jnp.asarray(v, jnp.float32)), np.float64) for f, v in ((j32.matvec, x), (j32.rmatvec, u))]
    for r, a, b in zip(ref, jax32, (y.double().numpy(), gr.double().numpy())):
        err_jax, err_split = (np.linalg.norm(v - r) / np.linalg.norm(r) for v in (a, b))
        assert err_split <= 1.5 * err_jax, (err_split, err_jax)


@pytest.mark.parametrize("kind", ["lattice", "per_cell"])
def test_sharded_parts_hold_the_near_pairs(kind):
    """Over 3 CPU slots, each part's lists (the lattice operator's parts
    hold observations, each its own lists; the per-cell operator's hold
    cells, each the candidates of its own cells) hold between them exactly
    the whole operator's candidate pairs, and every pair the JAX package's
    mask calls near; each part's plain split of its products sums to the
    whole operator's."""
    op = _operator(kind, "grav_gz", pad_cells_to=SLOTS) if kind == "per_cell" else _operator(kind, "grav_gz")
    ks = tmesh.shard_kernel(op, tmesh.make_mesh(SLOTS, device="cpu"))
    whole = set(_listed(op, kind)[0])
    union = []
    for s, p in enumerate(ks.parts):
        by_obs, by_cell = _listed(p, kind)
        assert sorted(by_obs) == sorted(by_cell)
        if kind == "lattice":
            union += [(b + s * p.xd.shape[0], n) for b, n in by_obs]
        else:
            union += [(b, n + p.cell_lo) for b, n in by_obs]
    near = _jax_near(op, kind)
    if kind == "lattice":
        # The parts re-pad the observations: compare the real ones.
        union = [(b, n) for b, n in union if b < op.nrows]
        whole = {(b, n) for b, n in whole if b < op.nrows}
        near = {(b, n) for b, n in near if b < op.nrows}
    assert len(union) == len(set(union)) and set(union) == whole and near <= whole
    rng = np.random.default_rng(2)
    xw = op.cw[None, :] * torch.as_tensor(rng.normal(size=(1, op.N)), dtype=torch.float32)
    if kind == "per_cell":
        parts = sum(p._split_rmatvec(op._padded_residual(torch.ones(op.nrows))).shape[1] for p in ks.parts)
        assert parts == op.N
        y = sum(p._split_matvec(xw[:, p.cell_lo : p.cell_lo + p.N]).double() for p in ks.parts)
        ref = op._split_matvec(xw).double()
        assert float((y - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


@pytest.mark.parametrize("kind", ["lattice", "per_cell"])
def test_blend_without_lists_is_refused_and_lists_are_counted(kind):
    """launch_plan refuses a blended operator without any one of its near
    lists, or with one not in int32; nbytes counts the lists; the float64
    operator has none."""
    op = _operator(kind, "grav_gz")
    plan, names = (lm.launch_plan, ("near_ptr", "near_cells", "near_tptr", "near_obs")) if kind == "lattice" else (
        pm.launch_plan, ("near_idx", "near_tptr", "near_obs"))
    assert plan(op)["mode"] == lm.BLEND
    for name in names:
        with pytest.raises(ValueError, match="near"):
            plan(dataclasses.replace(op, **{name: None}))
        with pytest.raises(ValueError, match="near"):
            plan(dataclasses.replace(op, **{name: getattr(op, name).long()}))
    lists = sum(getattr(op, n).numel() * 4 for n in names)
    assert op.nbytes - dataclasses.replace(op, **{n: None for n in names}).nbytes == lists
    op64 = _operator(kind, "grav_gz", torch.float64)
    assert all(getattr(op64, n) is None for n in names)


@pytest.mark.parametrize("kind", ["lattice", "per_cell"])
def test_near_wrappers_on_cpu_are_the_plain_near_pass(kind, monkeypatch):
    """On CPU tensors the near-pass wrappers return the operator's plain near
    pass (float64, into `out` where the wrapper takes one), build and load
    no library and count no launch; a device that is neither the card nor
    the CPU is refused."""

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA library was asked for on the CPU")

    monkeypatch.setattr(_cuda_build, "build_library", refuse)
    monkeypatch.setattr(_cuda_build, "load_library", refuse)
    op = _operator(kind, "mag_tmi")
    if kind == "lattice":
        near_mv, near_rmv, nmc, ndc = lm.lattice_near_matvec, lm.lattice_near_rmatvec, op.nmc, op.ndc
    else:
        near_mv, near_rmv, nmc, ndc = pm.prism_near_matvec, pm.prism_near_rmatvec, op.phys.nmc, op.phys.ndc
    launches = (near_mv.launches, near_rmv.launches)
    rng = np.random.default_rng(6)
    xw = torch.as_tensor(rng.normal(size=(nmc, op.N)), dtype=torch.float32)
    u = torch.as_tensor(rng.normal(size=(op.xd.shape[0], ndc)), dtype=torch.float32)
    y, g = near_mv(op, xw), near_rmv(op, u)
    assert y.dtype == g.dtype == torch.float64
    assert torch.equal(y, op._near_matvec(xw)) and torch.equal(g, op._near_rmatvec(u))
    assert float(y.abs().max()) > 0 and float(g.abs().max()) > 0
    if kind == "lattice":
        out = torch.empty((op.xd.shape[0], ndc), dtype=torch.float64)
        assert near_mv(op, xw, out=out) is out and torch.equal(out, y)
    assert (near_mv.launches, near_rmv.launches) == launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        near_mv(op, torch.zeros((nmc, op.N), device="meta"))


@functools.lru_cache(maxsize=None)
def _stored_operators(kind, case, part):
    """The blended operator of _operator (per-cell: its cells padded to a
    multiple of SLOTS) or, part=True, the parts of it sharded over SLOTS
    CPU slots, in slot order: a tuple of operators, each with the stored
    near rows of its plain build (near_rows_plain; on the CPU an operator
    stores none of its own, as no CPU product reads them)."""
    op = _operator(kind, case, pad_cells_to=SLOTS) if kind == "per_cell" else _operator(kind, case)
    ops = tuple(tmesh.shard_kernel(op, tmesh.make_mesh(SLOTS, device="cpu")).parts) if part else (op,)
    assert all(p.near_rval is None for p in ops)
    return tuple(dataclasses.replace(p, **p.near_rows_plain()) for p in ops)


@functools.lru_cache(maxsize=None)
def _jax_rows(kind, case):
    """{(observation, cell): row}: every pair of the whole operator of
    _stored_operators that the JAX package's far mask calls near
    (_jax_near), with its row as the JAX package's float64 closed forms
    give it (tomofastx_tpu/ops/sensitivity.py forward_rows, the dense
    build's), rounded to float32."""
    op = _stored_operators(kind, case, False)[0]
    near = sorted(_jax_near(op, kind))
    b, n = (np.asarray(v) for v in zip(*near))
    if kind == "lattice":
        xe, ye, ze = (a.double().numpy() for a in (op.xe, op.ye, op.ze))
        i, j, k = n % op.nx, (n // op.nx) % op.ny, n // (op.nx * op.ny)
        cells = (xe[i], xe[i + 1], ye[j], ye[j + 1], ze[k], ze[k + 1])
        phys = (op.problem, op.data_type, op.nmc, op.ndc, op.magv, op.intensity, False)
    else:
        cells = tuple(a.double().numpy()[n] for a in op.grid6)
        ph = op.phys
        phys = (ph.problem, ph.data_type, ph.nmc, ph.ndc, ph.magv, ph.intensity, ph.handle_inside)
    pts = (a.double().numpy()[b] for a in (op.xd, op.yd, op.zd))
    rows = np.asarray(jsens.forward_rows(*phys, tuple(jnp.asarray(c) for c in cells), *(jnp.asarray(v) for v in pts)))
    return dict(zip(near, rows.astype(np.float32)))


def _offsets(kind, s, op):
    """What the s-th operator of _stored_operators adds to its observations'
    and cells' numbers to give the whole operator's."""
    return (s * op.xd.shape[0], 0) if kind == "lattice" else (0, op.cell_lo)


def _candidates(op, kind):
    """(b, n) int64 of every candidate pair of the operator's near lists
    among its own cells."""
    if kind == "lattice":
        return tmf._csr_pairs(op.near_ptr, op.near_cells)
    local = op.near_idx.long() - op.cell_lo
    own = (local >= 0) & (local < op.N)
    return torch.arange(op.xd.shape[0])[:, None].expand_as(local)[own], local[own]


STORED_CASES = [(kind, case, part) for kind in ("lattice", "per_cell") for case in FAMILIES for part in (False, True)]


@pytest.mark.parametrize("kind, case, part", STORED_CASES)
def test_stored_near_rows_hold_every_near_pair_once(kind, case, part):
    """The stored near rows hold, each once, exactly the pairs of the
    operator's own observations and cells that the JAX package's float32 far
    mask calls near (_jax_near): by observation in increasing order of
    (observation, cell), by cell over the cells that have one in increasing
    order of (cell, observation), the rows of a pair the same in both
    orders; each row within 1e-6 of max|row| of the JAX package's float64
    closed forms rounded to float32 (a few may land on the neighbouring
    float32, as on the card); the indices int32, the rows float32, the lanes
    one of STREAM_LANES."""
    jax_rows = _jax_rows(kind, case)
    scale = max(float(np.abs(r).max()) for r in jax_rows.values())
    for s, op in enumerate(_stored_operators(kind, case, part)):
        db, dn = _offsets(kind, s, op)
        near = sorted((b - db, n - dn) for b, n in jax_rows if 0 <= b - db < op.xd.shape[0] and 0 <= n - dn < op.N)
        assert near, "no near pair to store"
        by_obs = _csr_pairs(op.near_rptr, op.near_rcell)
        assert by_obs == near and op.near_rptr.shape[0] == op.xd.shape[0] + 1
        assert set(by_obs) <= set(zip(*(v.tolist() for v in _candidates(op, kind))))
        cells = op.near_ccell.long().tolist()
        by_cell = [(b_, cells[c]) for c, b_ in _csr_pairs(op.near_cptr, op.near_cobs)]
        assert by_cell == sorted(near, key=lambda p: (p[1], p[0]))
        assert cells == sorted(set(cells)) and len(op.near_cptr) == len(cells) + 1
        for f in tmf.NEAR_ROW_FIELDS:
            assert getattr(op, f).dtype == (torch.float32 if f.endswith("val") else torch.int32)
        row_of = dict(zip(by_obs, op.near_rval))
        assert all(torch.equal(row, row_of[p]) for p, row in zip(by_cell, op.near_cval))
        want = np.stack([jax_rows[(b + db, n + dn)] for b, n in by_obs])
        assert float(np.abs(op.near_rval.numpy() - want).max()) <= 1e-6 * scale
        assert all(lanes in tmf.STREAM_LANES for lanes in op.near_lanes)


@pytest.mark.parametrize("kind, case, part", STORED_CASES)
def test_stored_product_equals_the_plain_near_pass(kind, case, part):
    """The plain product over the stored rows (the kernels' plain version)
    equals the plain near pass that evaluates every row again, within 1e-12
    of max|y| (float64 sums in another order), both products."""
    rng = np.random.default_rng(12)
    for op in _stored_operators(kind, case, part):
        nmc, ndc = (op.nmc, op.ndc) if kind == "lattice" else (op.phys.nmc, op.phys.ndc)
        xw = torch.as_tensor(rng.normal(size=(nmc, op.N)), dtype=torch.float32)
        u = torch.as_tensor(rng.normal(size=(op.xd.shape[0], ndc)), dtype=torch.float32)
        for got, want in ((op._stored_near_matvec(xw), op._near_matvec(xw)),
                          (op._stored_near_rmatvec(u), op._near_rmatvec(u))):
            assert got.dtype == torch.float64 and got.shape == want.shape
            scale = float(want.abs().max())
            assert scale > 0 and float((got - want).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("kind", ["lattice", "per_cell"])
def test_nbytes_counts_the_stored_rows_and_the_plan_needs_them(kind):
    """nbytes counts the stored near rows (near_rows_nbytes, both orders);
    a launch's checks (_operands) refuse a blended operator without any one
    of them or with one of another type, while its build's and launch_plan
    take it; an operator on the CPU stores none (its with_near_rows builds
    nothing), nor does a float64 one."""
    cpu = _operator(kind, "mag_tmi")
    assert cpu.near_rows_nbytes == 0 and cpu.with_near_rows() is cpu
    op = dataclasses.replace(cpu, **cpu.near_rows_plain())
    mod = lm if kind == "lattice" else pm
    stored = sum(getattr(op, f).numel() * getattr(op, f).element_size() for f in tmf.NEAR_ROW_FIELDS)
    assert op.near_rows_nbytes == stored > 0 and op.nbytes - cpu.nbytes == stored

    def operands(o, **kw):
        return mod._operands(o, o.xd, (o.xd.shape[0],), "xd", **kw)

    operands(op)
    assert mod.launch_plan(cpu)["mode"] == mod.BLEND and operands(cpu, stored=False)
    with pytest.raises(ValueError, match="stored near rows"):
        operands(cpu)
    for f in tmf.NEAR_ROW_FIELDS + ("near_lanes",):
        with pytest.raises(ValueError, match="stored near rows"):
            operands(dataclasses.replace(op, **{f: None}))
    for f in ("near_rcell", "near_rval"):
        with pytest.raises(ValueError, match="stored near rows"):
            operands(dataclasses.replace(op, **{f: getattr(op, f).double()}))
    op64 = _operator(kind, "mag_tmi", torch.float64)
    assert op64.near_rows_nbytes == 0 and op64.with_near_rows() is op64


@pytest.mark.parametrize("kind", ["lattice", "per_cell"])
def test_near_build_on_cpu_is_the_plain_build(kind, monkeypatch):
    """On the CPU the build wrapper returns the plain build
    (_near_pairs_plain), with no library built or loaded and no launch
    counted, and near_rows_plain lays it out; a device that is neither the
    card nor the CPU is refused."""

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA library was asked for on the CPU")

    monkeypatch.setattr(_cuda_build, "build_library", refuse)
    monkeypatch.setattr(_cuda_build, "load_library", refuse)
    build = lm.lattice_near_build if kind == "lattice" else pm.prism_near_build
    launches = build.launches
    op = _operator(kind, "grav_ftg")
    b, n, rows = build(op)
    pb, pn, prows = op._near_pairs_plain()
    assert torch.equal(b, pb) and torch.equal(n, pn) and torch.equal(rows, prows) and b.shape[0] > 0
    layout, want = op.near_rows_plain(), tmf.near_row_layout(b, n, rows, op.xd.shape[0])
    assert all(torch.equal(layout[f], want[f]) for f in tmf.NEAR_ROW_FIELDS)
    assert layout["near_lanes"] == want["near_lanes"] and build.launches == launches
    meta = dataclasses.replace(op, near_cells=op.near_cells.to("meta")) if kind == "lattice" else (
        dataclasses.replace(op, near_idx=op.near_idx.to("meta")))
    with pytest.raises(ValueError, match="cuda or cpu"):
        build(meta)


@pytest.mark.parametrize("pairs, segments, lanes", [
    (0, 4096, 1), (4096, 4096, 1), (12, 4, 1), (17, 4, 2), (433_832, 4096, 32), (404_349, 4096, 32),
    (43_006_158, 2032, 256), (43_006_158, 3_900_000, 4), (229_060, 2032, 32), (2032 * 1023, 2032, 32),
])
def test_stream_lanes(pairs, segments, lanes):
    """The lanes a near pass gives a segment: about 4 pairs a lane up to a
    warp, a block of 256 from 1024 pairs a segment on the mean (the smoke's
    shapes: a warp an observation; generic4m's: a block an observation)."""
    assert tmf.stream_lanes(pairs, segments) == lanes


def test_near_row_layout_of_a_few_pairs():
    """near_row_layout on 5 pairs of 3 observations and 6 cells: the offsets
    by observation (an observation with none included), the cells that have
    a pair in increasing order with their observations, the rows permuted
    alike."""
    b = torch.tensor([0, 0, 2, 2, 2])
    n = torch.tensor([1, 4, 0, 1, 5])
    rows = torch.arange(10, dtype=torch.float32).reshape(5, 1, 2)
    out = tmf.near_row_layout(b, n, rows, 3)
    assert out["near_rptr"].tolist() == [0, 2, 2, 5] and out["near_rcell"].tolist() == [1, 4, 0, 1, 5]
    assert out["near_ccell"].tolist() == [0, 1, 4, 5] and out["near_cptr"].tolist() == [0, 1, 3, 4, 5]
    assert out["near_cobs"].tolist() == [2, 0, 2, 0, 2]
    assert torch.equal(out["near_cval"], rows[[2, 0, 3, 1, 4]]) and torch.equal(out["near_rval"], rows)
    assert out["near_lanes"] == (1, 1) and tmf.near_row_layout(b, n, rows, 3, (8, 2))["near_lanes"] == (8, 2)
