"""Sensitivity-kernel construction: depth weighting + streamed kernel build +
wavelet-domain thresholding ("compression").

Counterpart of the reference forward layer (sensitivity_gravmag.F90,
weights_gravmag.f90):

- Rows are built a chunk of observation points at a time, as a batch of
  closed-form prism evaluations on the device — the "hot loop" of the
  reference (sensitivity_gravmag.F90:189-318) becomes a few tensor
  operations per chunk.
- "Compression" keeps the reference's exact operator semantics — depth
  weight, 3-D wavelet transform of each row, per-row threshold at the
  (nel_kept+1)-th largest |coefficient| with a 1e-30 floor
  (sensitivity_gravmag.F90:237-272) — realised as dense wavelet-domain rows
  with the discarded entries zeroed, which the cache writer then stores
  sparsely.
- The per-row compression-error metric r = sqrt(discarded/full) after
  Li & Oldenburg (2003) is returned for parity with the reference's printout
  (sensitivity_gravmag.F90:282-285, 346-355).

Every forward family is ported: gravity g_z, gravity gradiometry (Gzz or
the full tensor) and magnetics (TMI or three-component data, susceptibility
or magnetization vector, with the borehole branch), corner-lattice and
per-cell, built either into one dense tensor on the device or streamed to a
`row_sink`. The chunk is the caller's `batch_size`, cut to the rows' bytes
(`_build_batch`) on every device. The JAX package's caps on it answer limits
of another device and are not carried over.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tomofastx_tpu_torch.config.parfile import MagParams
from tomofastx_tpu_torch.models.data import SurveyData
from tomofastx_tpu_torch.models.grid import Grid
from tomofastx_tpu_torch.ops import prism
from tomofastx_tpu_torch.ops import wavelet as W
from tomofastx_tpu_torch.ops.matrixfree import _lattice_closed_rows, detect_lattice
from tomofastx_tpu_torch.ops.sparse_kernel import DenseKernel


# =============================================================================
# Depth weighting (reference: weights_gravmag.f90:46-250)
# =============================================================================


def calculate_depth_weight(
    par, grid: Grid, data: SurveyData, dtype=torch.float64, device="cuda"
) -> np.ndarray:
    """Normalized depth/distance weight per cell, inverted into the matrix
    *column weight* W^-1 (reference: calculate_depth_weight,
    weights_gravmag.f90:46-199). Returns the full (N,) column weight."""
    dV = grid.cell_volume()

    if par.depth_weighting_type == 1:
        # Empirical (z + z0)^(-power/2) at the cell center
        # (weights_gravmag.f90:71-79, 204-223).
        _, _, zc = grid.cell_centers()
        depth = zc + par.Z0
        if np.any(depth <= 0.0):
            raise ValueError("Error: non-positive depth in depth weighting type 1!")
        w = depth ** (-par.depth_weighting_power / 2.0)

    elif par.depth_weighting_type == 2:
        # Integrated distance weighting, Li & Oldenburg (2000) Eq. 19,
        # 8-point in-cell quadrature (weights_gravmag.f90:81-138).
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        w = _distance_weight(
            t(grid.X1), t(grid.X2), t(grid.Y1), t(grid.Y2), t(grid.Z1), t(grid.Z2),
            t(data.X), t(data.Y), t(data.Z),
            par.depth_weighting_power, par.depth_weighting_beta,
        ).cpu().numpy()

    elif par.depth_weighting_type == 3:
        # Minimum-distance weighting (weights_gravmag.f90:140-161).
        xc, yc, zc = grid.cell_centers()
        R0 = 0.01
        d2 = (
            (xc[:, None] - data.X[None, :]) ** 2
            + (yc[:, None] - data.Y[None, :]) ** 2
            + (zc[:, None] - data.Z[None, :]) ** 2
        )
        mindist = np.sqrt(d2.min(axis=1))
        w = np.sqrt(1.0 / (mindist + R0) ** par.depth_weighting_power)

    else:
        raise ValueError(f"Not known depth weight type {par.depth_weighting_type}!")

    # Scale by sqrt(cell volume), normalize by the global max, then invert
    # into the column weight (weights_gravmag.f90:170-195).
    w = w * np.sqrt(dV)
    norm = w.max()
    if norm == 0.0:
        raise ValueError("Zero depth weight norm!")
    w = w / norm
    if np.any(w == 0.0):
        raise ValueError("Zero damping weight!")
    return 1.0 / w


def _distance_weight(X1, X2, Y1, Y2, Z1, Z2, xd, yd, zd, power: float, beta: float):
    R0 = 0.1
    dfactor = 0.25
    dhx = dfactor * torch.abs(X2 - X1)
    dhy = dfactor * torch.abs(Y2 - Y1)
    dhz = dfactor * torch.abs(Z2 - Z1)
    dV = torch.abs((X2 - X1) * (Y2 - Y1) * (Z2 - Z1))

    # 8 quadrature points per cell: corners moved inside by dfactor*h.
    px = torch.stack([X1 + dhx, X2 - dhx])  # (2, N)
    py = torch.stack([Y1 + dhy, Y2 - dhy])
    pz = torch.stack([Z1 + dhz, Z2 - dhz])

    # Accumulate over data points in chunks: all points at once would
    # materialize an (ndata, N) intermediate per term. Chunks keep memory
    # at chunk x N with a deterministic reduction order.
    N = X1.shape[0]
    nd = xd.shape[0]
    chunk = max(1, min(nd, (1 << 26) // max(N, 1)))
    wr = torch.zeros_like(X1)
    for s in range(0, nd, chunk):
        xj = xd[s : s + chunk, None, None]
        yj = yd[s : s + chunk, None, None]
        zj = zd[s : s + chunk, None, None]
        dx2 = (px - xj) ** 2  # (chunk, 2, N)
        dy2 = (py - yj) ** 2
        dz2 = (pz - zj) ** 2
        # Sum over the 8 combinations (ii, jj, kk).
        integral = 0.0
        for ii in range(2):
            for jj in range(2):
                for kk in range(2):
                    Rij = torch.sqrt(dx2[:, ii] + dy2[:, jj] + dz2[:, kk])
                    integral = integral + 1.0 / (Rij + R0) ** power
        integral = integral * dV / 8.0
        wr = wr + torch.sum(integral**2, dim=0)
    return (1.0 / torch.sqrt(dV)) * wr ** (beta / 4.0)


def apply_local_depth_weighting(par, column_weight: np.ndarray) -> np.ndarray:
    """Divide column weights by per-cell local weights from file
    (reference: weights_gravmag.f90:255-311)."""
    if par.apply_local_weight > 0:
        from tomofastx_tpu_torch.io.model_io import read_local_weights

        local = read_local_weights(par.local_weight_file, column_weight.shape[0])
        out = np.where(local != 0.0, column_weight / np.where(local != 0.0, local, 1.0), 0.0)
        return out
    return column_weight


# =============================================================================
# Kernel build (reference: calculate_and_write_sensit,
# sensitivity_gravmag.F90:82-410)
# =============================================================================


@dataclass
class SensitKernel:
    """Description of a built sensitivity operator for one problem.

    The operator has shape (ndata * ndata_components, nmodel_components * N)
    and is stored in float32, like the reference's stored kernel
    (global_typedefs.F90:42). In compressed mode its columns live in the
    wavelet domain. S is None after a streamed build: the rows went to the
    sink."""

    S: torch.Tensor | None  # (nrows, ncols)
    ndata: int
    ndata_components: int
    nmodel_components: int
    nx: int
    ny: int
    nz: int
    compression_type: int  # 0 none, 1 Haar, 2 Daubechies D4
    comp_error: float = 0.0
    nnz: int = 0

    @property
    def nrows(self) -> int:
        return self.ndata * self.ndata_components

    @property
    def N(self) -> int:
        return self.nx * self.ny * self.nz

    def to_solver_domain(self, xm: torch.Tensor) -> torch.Tensor:
        """Model-scaled space -> matrix column space (wavelet if compressed).
        xm: (..., ncomp*N) flat."""
        if self.compression_type > 0:
            shape = xm.shape
            cube = xm.reshape(*shape[:-1], self.nmodel_components, self.nz, self.ny, self.nx)
            cube = W.forward_wavelet_3d(cube, self.compression_type)
            return cube.reshape(shape)
        return xm

    def from_solver_domain(self, xw: torch.Tensor) -> torch.Tensor:
        """Matrix column space -> model-scaled space (inverse wavelet)."""
        if self.compression_type > 0:
            shape = xw.shape
            cube = xw.reshape(*shape[:-1], self.nmodel_components, self.nz, self.ny, self.nx)
            cube = W.inverse_wavelet_3d(cube, self.compression_type)
            return cube.reshape(shape)
        return xw


def forward_rows(problem: str, data_type: int, nmc: int, ndc: int, magv, intensity,
                 handle_inside: bool, grid_arrays, xd, yd, zd, far_quad: bool = False):
    """Raw physics rows for a batch of observation points xd, yd, zd of
    shape (B,) -> (B, N, nmodel_components, ndata_components). The physics
    dispatch shared by the per-cell build and the matrix-free operators
    (reference: sensitivity_gravmag.F90:193-219). The cell bounds are (N,),
    or (B, K) for K cells of each point's own.

    far_quad=True is the compensated-float32 blend: cells farther than
    prism.FAR_QUAD_RADIUS half-diagonals take the 27-point Gauss-Legendre
    quadrature of the smooth point-source integrand instead of the closed
    form, whose 8-corner alternating sum turns float32 rounding into noise
    in the far field. Meant for float32; the float64 closed forms carry
    enough mantissa everywhere."""
    X1, X2, Y1, Y2, Z1, Z2 = grid_arrays
    xd, yd, zd = xd[:, None], yd[:, None], zd[:, None]
    if problem == "magn":
        rows = prism.magprism_row(
            xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2, magv, intensity,
            nmodel_components=nmc, ndata_components=ndc, handle_inside=handle_inside,
        )
    elif data_type == 1:
        rows = prism.gravi_z(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2)[:, :, None, None]
    elif ndc == 1:
        rows = prism.gradi_zz(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2)[:, :, None, None]
    elif ndc != 6:
        # Reference: sensitivity_gravmag.F90:211.
        raise ValueError("Wrong number of gravity gradiometry data components! (use 1 or 6)")
    else:
        comps = prism.gradi_full(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2)
        rows = torch.stack(comps, dim=-1)[:, :, None, :]
    if far_quad:
        quad = _forward_rows_quad(problem, data_type, nmc, ndc, magv, intensity, grid_arrays,
                                  xd[:, 0], yd[:, 0], zd[:, 0])
        mask = prism.far_mask(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2)
        rows = torch.where(mask[..., None, None], quad, rows)
    return rows


def _forward_rows_quad(problem: str, data_type: int, nmc: int, ndc: int, magv, intensity,
                       grid_arrays, xd, yd, zd):
    """Far-field quadrature counterpart of forward_rows (same shapes), by
    the 27-point Gauss-Legendre rule."""
    X1, X2, Y1, Y2, Z1, Z2 = grid_arrays
    xd, yd, zd = xd[:, None], yd[:, None], zd[:, None]
    if problem == "magn":
        tx, ty, tz = prism.magnetic_tensor_quad(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2)
        return prism.combine_mag_tensor(tx, ty, tz, magv, intensity, nmc, ndc)
    if data_type == 1:
        return prism.gravi_z_quad(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2)[:, :, None, None]
    if ndc == 1:
        return prism.gradi_zz_quad(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2)[:, :, None, None]
    comps = prism.gradi_full_quad(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2)
    return torch.stack(comps, dim=-1)[:, :, None, :]


def observation_inside_grid(grid, data) -> bool:
    """Whether any observation point lies inside the model volume (decides
    the magnetic 6-subprism borehole branch, magnetic_field.f90:139-141)."""
    (xmin, xmax), (ymin, ymax), (zmin, zmax) = grid.bounds()
    return bool(
        np.any(
            (data.X > xmin) & (data.X < xmax)
            & (data.Y > ymin) & (data.Y < ymax)
            & (data.Z > zmin) & (data.Z < zmax)
        )
    )


def _compress_lines(lines, nx, ny, nz, compression_type, nel_compressed, store_dtype):
    """Wavelet-transform + threshold a batch of weighted rows.

    lines: (B, ..., N) in model domain (already column-weighted).
    Returns (compressed (B, ..., N) in store_dtype, per-observation nnz
    counts (B,), per-observation summed compression errors r_i (B,))."""
    N = nx * ny * nz
    cost_full = torch.sum(lines**2, dim=-1)

    wl = W.forward_wavelet_flat(lines, nx, ny, nz, compression_type)
    absw = torch.abs(wl)

    if nel_compressed >= N:
        threshold = torch.full(absw.shape[:-1], -1.0, dtype=absw.dtype, device=absw.device)
    elif absw.dtype == torch.float32:
        threshold = _kth_largest_bisect_f32(absw, nel_compressed + 1)
    else:
        # (nel_compressed + 1)-th largest |coefficient| per row
        # (= sorted_ascending[N - nel_compressed], sensitivity_gravmag.F90:248-249).
        threshold = torch.topk(absw, nel_compressed + 1, dim=-1, sorted=True)[0][..., -1]
    threshold = torch.clamp(threshold, min=1.0e-30)

    mask = absw > threshold[..., None]
    zero = torch.zeros((), dtype=wl.dtype, device=wl.device)
    compressed = torch.where(mask, wl, zero).to(store_dtype)

    cost_discarded = torch.sum(torch.where(mask, zero, wl) ** 2, dim=-1)
    err = torch.sqrt(cost_discarded / torch.where(cost_full > 0, cost_full, 1.0))
    inner = tuple(range(1, lines.ndim - 1))
    nnz = torch.sum(mask, dim=inner + (-1,))
    return compressed, nnz, torch.sum(err, dim=inner)


# The mixed build (near_field_f64 > 0) with float32 (or bfloat16) storage
# rounds the patched float64 rows to float32 right after the float64 depth
# weighting and runs the wavelet and the threshold in float32: the float64
# digits only have to survive until the storage rounding. False keeps the
# float64 pipeline to the end. As in the JAX package, a module constant.
MIXED_BUILD_F32_COMPRESS = True


def _kth_largest_bisect_f32(absw, k: int):
    """Exact k-th largest value along the last axis of a non-negative
    float32 tensor, by binary search on the int32 bit pattern (non-negative
    floats order as their bit patterns do): 32 halvings, each one masked
    count. Equals torch.topk(absw, k)[0][..., -1], ties included: bisecting
    on the count of strictly greater entries pins the k-th order statistic.
    The JAX package selects its float32 thresholds this way, and the two
    agree to the bit."""
    bits = absw.contiguous().view(torch.int32)
    # Invariant: count(> lo) >= k and count(> hi) < k, so the k-th largest
    # pattern lies in (lo, hi]; lo = -1 (below +0.0's pattern 0) and hi =
    # the row's largest pattern hold for any 1 <= k <= N.
    lo = torch.full(absw.shape[:-1], -1, dtype=torch.int32, device=absw.device)
    hi = absw.amax(dim=-1).contiguous().view(torch.int32)
    for _ in range(32):
        mid = lo + torch.div(hi - lo, 2, rounding_mode="floor")
        above = torch.sum(bits > mid[..., None], dim=-1) >= k
        lo = torch.where(above, mid, lo)
        hi = torch.where(above, hi, mid)
    return hi.view(torch.float32)


def _chunk_plan(nd: int, batch: int):
    """Split nd rows into chunks of at most `batch` rows using as few
    distinct chunk sizes as possible: an exact divisor of nd in
    (batch/2, batch] when there is one, otherwise near-equal sizes
    differing by one row. Returns [(start, size), ...]. Same plan as the
    JAX package's, so a streamed cache has the same chunk boundaries."""
    if nd <= batch:
        return [(0, nd)]
    for b in range(batch, batch // 2, -1):
        if nd % b == 0:
            return [(s, b) for s in range(0, nd, b)]
    nchunks = -(-nd // batch)
    base, extra = divmod(nd, nchunks)
    plan = []
    s = 0
    for c in range(nchunks):
        nb = base + (1 if c < extra else 0)
        plan.append((s, nb))
        s += nb
    return plan


# Bytes a build chunk may take: the float64 rows and the copies
# that the corner lattice, the depth weight, the wavelet and the threshold make
# of them. 2^32 is what 256 g_z rows at 64^3 cells took in every earlier
# build; a row of the magnetic tensor, with its five corner channels, counts
# twice. The float32 and mixed builds hold less a row element: the float32
# closed forms and quadrature, then (mixed) the sort's 16 bytes and a
# float64 copy of the rows beside the float32 one, as the JAX package's
# memory cap counts them (12 bytes).
BUILD_CHUNK_BYTES = 1 << 32


def _build_batch(batch_size: int, problem: str, nmc: int, ndc: int, N: int) -> int:
    """The chunk of observations for a build: batch_size, or fewer where the
    rows of nmc x ndc components would pass BUILD_CHUNK_BYTES. The cache rows
    stream in order, so the files do not depend on the chunk."""
    per_row = 64 * N * nmc * ndc * (2 if problem == "magn" else 1)
    return max(1, min(batch_size, BUILD_CHUNK_BYTES // per_row))


def _patch_near_field(rows, near, K, xd, yd, zd, problem, data_type, nmc, ndc, magv, intensity,
                      handle_inside):
    """The mixed build's patch: the rows in float64, with the K cells
    nearest each point (by the float32 squared centre distance, ties to the
    lower cell index) recomputed from float64 cell bounds at the float32
    point widened to float64, as in the JAX package. rows: (B, N, nmc, ndc)."""
    grid64, (xc, yc, zc) = near
    d2 = (xc - xd[:, None]) ** 2 + (yc - yd[:, None]) ** 2 + (zc - zd[:, None]) ** 2
    # A stable sort keeps equal distances in cell order: the set is the
    # K lowest-indexed among ties, whatever the device.
    idx = torch.sort(d2, dim=-1, stable=True)[1][:, :K].contiguous()
    del d2
    sub64 = tuple(a[idx] for a in grid64)
    rows64 = forward_rows(problem, data_type, nmc, ndc, magv, intensity, handle_inside, sub64,
                          xd.double(), yd.double(), zd.double())
    rows = rows.double()
    rows.scatter_(1, idx[:, :, None, None].expand(-1, -1, nmc, ndc), rows64)
    return rows


def compute_sensitivity(
    par,
    grid: Grid,
    data: SurveyData,
    column_weight: np.ndarray,
    compute_dtype=torch.float64,
    store_dtype=torch.float32,
    batch_size: int = 256,
    progress=None,
    row_sink=None,
    device="cuda",
    mesh=None,
    near_field_f64: int = 0,
) -> SensitKernel:
    """Build the (optionally wavelet-compressed) sensitivity rows, into one
    dense tensor on `device` or streamed to `row_sink`.

    compute_dtype is the physics' precision: float64 (the reference's
    policy; the corner-lattice build on a tensor-product grid) or float32,
    the compensated build (--build-precision single): per-cell float32
    closed forms with the far cells by Gauss quadrature (tpu.farFieldQuad).

    near_field_f64 = K > 0 is the mixed build (--fast-build K): float32
    rows, with the K cells nearest each observation, where the closed forms
    lose digits to cancellation, recomputed in float64 and patched in. The
    K cells are the K smallest squared centre distances (float32), ties to
    the lower cell index, as lax.top_k picks them in the JAX package. With
    float32 or bfloat16 storage the patched rows are rounded to float32
    after the float64 depth weighting (MIXED_BUILD_F32_COMPRESS).

    par.f64_build_f32_compress (tpu.f64BuildF32Compress, --f32-compress):
    a float64 build rounds its weighted rows to float32 before the wavelet
    and the threshold; inert for float64 storage.

    store_dtype: float32, float64, or bfloat16 (tpu.kernelStoreDtype),
    which a dense build writes straight into a bfloat16 tensor, with no
    float32 intermediate of the whole kernel.

    Mirrors calculate_and_write_sensit (sensitivity_gravmag.F90:82-410):
    physics row -> multiply by column weight -> (wavelet + threshold) ->
    cast to storage precision. Data/problem weights are not applied here;
    the reference applies them when re-reading the kernel
    (sensitivity_gravmag.F90:836-843), and so do apply_row_weights and its
    packed and tiled counterparts.

    progress: optional callable(done_rows, total_rows) invoked after each
    chunk (the reference's 10% ticker, sensitivity_gravmag.F90:313-316).

    row_sink: callable(chunk (B, ndc, nmc, N) float32 tensor on `device`,
    start_row). Chunks stream to the sink (e.g. a SensitStreamWriter, which
    compacts them where they lie) and are not accumulated — memory stays
    one chunk, and the returned SensitKernel has S = None. This is the
    counterpart of the reference's write-inside-the-hot-loop streaming
    (sensitivity_gravmag.F90:306-309).

    Without a row_sink the chunks are written straight into one
    (nd * ndc, nmc * N) tensor of store_dtype on `device`, the solver's
    layout, which the returned SensitKernel holds as S: the finished kernel
    never passes through the host.

    mesh: optional parallel.mesh.Mesh. The observations of every chunk are
    then cut over all of its slots (the reference's data-row parallel build,
    sensitivity_gravmag.F90:179-189): the chunk is padded with far-away
    dummy points to a multiple of the slot count, part k is built on slot
    k's device, the parts meet on `device` and the dummy rows are dropped
    before anything is stored or counted. Rows are built independently, so
    the kept rows equal the unsharded build's bit for bit. For a mesh of
    distinct cards the caller passes the host as `device`
    (parallel.mesh.assembly_device), so that no card holds the whole
    kernel."""
    N = grid.nelements_total
    nd, ndc, nmc = par.ndata, par.ndata_components, par.nmodel_components

    is_mag = isinstance(par, MagParams)
    problem = "magn" if is_mag else "grav"
    magv = prism.dircos(par.mi, par.md, par.theta) if is_mag else (0.0, 0.0, 1.0)
    intensity = par.intensity if is_mag else 0.0
    # Only pay for the 6-subprism in-cell branch when some observation point
    # lies inside the grid volume.
    handle_inside = is_mag and observation_inside_grid(grid, data)

    device = torch.device(device)

    def t(a, dev=device, dtype=compute_dtype):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=dev)

    # Corner-lattice build on a tensor-product grid: evaluate the corner
    # antiderivatives once per lattice node per observation and difference
    # into per-cell rows. Same corner expressions as the per-cell sums, so
    # values agree to summation-order rounding. Only for float64 physics,
    # as in the JAX package; opt out with tpu.latticeBuild = 0. The
    # borehole branch is per-cell and cannot share corners.
    lattice_edges = None
    if getattr(par, "lattice_build", 1) and compute_dtype == torch.float64 and (
        problem == "grav" or not handle_inside
    ):
        lattice_edges = detect_lattice(grid)
    slots = [device] if mesh is None else mesh.slots
    # The compensated float32 physics: far cells by quadrature wherever the
    # closed forms run in float32.
    far_quad = bool(getattr(par, "far_field_quad", 1) and compute_dtype == torch.float32)
    K = min(near_field_f64, N) if near_field_f64 > 0 else 0
    narrow_store = torch.empty((), dtype=store_dtype).element_size() <= 4
    f32_pipeline = bool(getattr(par, "f64_build_f32_compress", 0))
    cells = (grid.X1, grid.X2, grid.Y1, grid.Y2, grid.Z1, grid.Z2)

    def operands(dev):
        """The grid (lattice edges or cell bounds), the column weight and,
        for the mixed build, the float64 cell bounds and the cell centres
        on dev. The column weight stays float64 in the mixed build, so that
        the patched rows keep their digits."""
        lat = tuple(t(e, dev) for e in lattice_edges) if lattice_edges is not None else ()
        grid_arrays = () if lat else tuple(t(a, dev) for a in cells)
        cw = t(column_weight, dev, torch.float64 if K else compute_dtype)
        near = ()
        if K:
            near = (tuple(t(a, dev, torch.float64) for a in cells),
                    tuple(t(0.5 * (lo + hi), dev) for lo, hi in zip(cells[::2], cells[1::2])))
        return lat, grid_arrays, cw, near

    # Keyed by the device the tensors landed on ("cuda" lands on cuda:0).
    ops = {}
    for dev in dict.fromkeys(slots):
        o = operands(dev)
        ops[o[2].device] = o

    if par.compression_type > 0:
        nel_compressed = int(par.compression_rate * N)
    else:
        nel_compressed = N

    def build_chunk(xd, yd, zd):
        lat, grid_arrays, cw, near = ops[xd.device]
        if lat:
            rows = _lattice_closed_rows(*lat, xd, yd, zd, problem, par.data_type, magv, intensity, nmc, ndc)
            rows = rows.reshape(-1, N, nmc, ndc)
        else:
            rows = forward_rows(
                problem, par.data_type, nmc, ndc, magv, intensity, handle_inside, grid_arrays, xd, yd, zd,
                far_quad=far_quad,
            )
        if K:
            rows = _patch_near_field(rows, near, K, xd, yd, zd, problem, par.data_type, nmc, ndc, magv,
                                     intensity, handle_inside)
        rows = rows * cw[:, None, None]  # depth weighting (float64 in the mixed build)
        # The float32 pipelines' rounding points, as in the JAX package: with
        # a store of 32 bits or fewer, the mixed build's patched rows and a
        # float64 build under tpu.f64BuildF32Compress go to float32 after
        # the weighting.
        if K and MIXED_BUILD_F32_COMPRESS and narrow_store:
            rows = rows.to(compute_dtype)
        elif not K and f32_pipeline and rows.dtype == torch.float64 and narrow_store:
            rows = rows.to(torch.float32)
        rows = rows.permute(0, 3, 2, 1)  # (B, ndc, nmc, N): lines over N
        # Flagged before the threshold: its mask (|w| > t) is false for NaN
        # and would store a non-finite row as zeros. The JAX package checks
        # after it and lets such a row pass a compressed build. The flag
        # stays on the device until every part of the chunk is built.
        finite = torch.isfinite(rows).all()
        if par.compression_type > 0:
            return (*_compress_lines(
                rows, grid.nx, grid.ny, grid.nz, par.compression_type, nel_compressed, store_dtype
            ), finite)
        comp = rows.to(store_dtype)
        B = comp.shape[0]
        return (
            comp,
            torch.full((B,), ndc * nmc * N, device=comp.device),
            torch.zeros((B,), dtype=compute_dtype, device=comp.device),
            finite,
        )

    xs, ys, zs = (np.asarray(a, np.float64) for a in (data.X, data.Y, data.Z))
    if mesh is not None:
        # Dummy points far outside the volume: finite closed forms, rows
        # dropped after the chunk (as in the JAX package's sharded build).
        far = (float(np.max(grid.X2)) + 1.0e6, float(np.max(grid.Y2)) + 1.0e6, float(np.min(grid.Z1)) - 1.0e6)

    def build_rows(s, e):
        """Rows of observations [s, e) -> (comp, nnz, err, finite) on
        `device`; every part is queued before anything is read back."""
        if mesh is None:
            return build_chunk(t(xs[s:e]), t(ys[s:e]), t(zs[s:e]))
        n, nb = len(slots), e - s
        per = -(-nb // n)
        coords = [np.full(per * n, f) for f in far]
        for c, a in zip(coords, (xs, ys, zs)):
            c[:nb] = a[s:e]
        parts = [
            build_chunk(*(t(c[k * per : (k + 1) * per], dev) for c in coords))
            for k, dev in enumerate(slots)
        ]
        if n == 1:
            return tuple(a.to(device) for a in parts[0])
        return (
            *(torch.cat([p[q].to(device) for p in parts])[:nb] for q in range(3)),
            torch.stack([p[3].to(device) for p in parts]).all(),
        )

    S = None
    if row_sink is None:
        # Assembled on the host for a mesh of distinct cards (the workflow's
        # parallel.mesh.assembly_device): pinned, so that each card's part
        # is copied from it without staging.
        pin = device.type == "cpu" and any(d.type == "cuda" for d in slots)
        S = torch.empty((nd * ndc, nmc * N), dtype=store_dtype, device=device, pin_memory=pin)

    batch_size = _build_batch(batch_size, problem, nmc, ndc, N)
    nnz_total = 0
    err_total = 0.0
    for s, nb in _chunk_plan(nd, batch_size):
        e = s + nb
        comp, nnz, err_sum, finite = build_rows(s, e)
        prism.require_finite("sensitivity kernel chunk", finite)
        if row_sink is not None:
            row_sink(comp, s)
        else:
            S[s * ndc : e * ndc] = comp.reshape(nb * ndc, nmc * N)
        nnz_total += int(nnz.sum())
        err_total += float(err_sum.sum())
        if progress is not None:
            progress(e, nd)

    comp_error = err_total / (nd * ndc * nmc) if par.compression_type > 0 else 0.0
    return SensitKernel(
        S=S,
        ndata=nd,
        ndata_components=ndc,
        nmodel_components=nmc,
        nx=grid.nx,
        ny=grid.ny,
        nz=grid.nz,
        compression_type=par.compression_type,
        comp_error=comp_error,
        nnz=nnz_total,
    )


def apply_row_weights(kernel: SensitKernel, problem_weight: float, data_weight: np.ndarray) -> SensitKernel:
    """Bake problem_weight * data_weight into the matrix rows, in storage
    precision (reference: read_sensitivity_kernel,
    sensitivity_gravmag.F90:836-843). data_weight: (ndata, ndc).

    S is scaled in place — a multi-GB kernel does not exist twice — and
    kernel.S is set to None so that the unweighted name cannot be used."""
    wrow = (problem_weight * np.asarray(data_weight)).reshape(-1).astype(np.float32)
    if wrow.shape[0] != kernel.nrows:
        raise ValueError(f"{wrow.shape[0]} row weights for {kernel.nrows} rows")
    S = kernel.S
    S.mul_(torch.as_tensor(wrow, device=S.device).to(S.dtype)[:, None])
    kernel.S = None
    return dataclasses.replace(kernel, S=S)


def calculate_data(
    operator,
    model_val: np.ndarray,
    column_weight: np.ndarray,
    problem_weight: float,
    data_weight: np.ndarray,
    compression_type: int,
    nx: int,
    ny: int,
    nz: int,
    solve_dtype=torch.float64,
    device="cuda",
) -> np.ndarray:
    """Forward d = S m through a stored, row-weighted operator with a
    `matvec`, or a dense SensitKernel (reference: model_calculate_data,
    model.F90:220-307): scale the model by 1/column_weight,
    wavelet-transform if compressed, multiply, then undo the problem and
    data weights. Returns (ndata, ndc)."""
    if problem_weight == 0.0:
        raise ValueError("Zero problem weight in calculate_data!")
    if isinstance(operator, SensitKernel):
        S = operator.S
        operator = DenseKernel(S if S.dtype == torch.bfloat16 else S.to(solve_dtype))
    cw = np.asarray(column_weight)
    dw = np.asarray(data_weight)
    m = np.asarray(model_val).reshape(-1, cw.shape[0])
    m_scaled = np.where(cw != 0.0, m / np.where(cw != 0.0, cw, 1.0), 0.0)
    x = torch.as_tensor(m_scaled, dtype=solve_dtype, device=device)
    if compression_type:
        x = W.forward_wavelet_flat(x, nx, ny, nz, compression_type)
    d = operator.matvec(x.reshape(-1)).cpu().numpy().reshape(dw.shape)
    d = d / problem_weight
    d = d / dw
    return d
