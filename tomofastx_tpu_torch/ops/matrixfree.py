"""Matrix-free sensitivity operators: recompute prism responses on the fly.

Counterpart of tomofastx_tpu/ops/matrixfree.py. The reference's answer to
kernel memory is wavelet compression and a disk cache
(sensitivity_gravmag.F90); the matrix-free answer is to store no kernel at
all and regenerate the rows of a chunk of observations inside every
product. The closed-form prism integrals are a few hundred operations per
(datum, cell) pair and need no memory traffic, so a survey whose kernel
outgrows the card still solves. Select with ``tpu.kernelFormat =
matrixfree`` (compression off), or ``auto`` falls back to it when a dense
kernel would not fit.

Three operators, the fastest that applies wins (make_matrixfree_kernel):
- BTTBKernel (ops/bttb.py): per-layer 2-D FFT convolutions, on a uniform
  lattice with the observations on a commensurate lattice at one height;
- LatticeMatrixFreeKernel: the corner-lattice factorization of the closed
  forms on any tensor-product grid;
- MatrixFreeKernel: per-cell rows on any grid.

In float32 the lattice and per-cell operators blend in the far-field
Gauss-Legendre quadrature (prism.FAR_QUAD_RADIUS): the closed forms'
8-corner cancellation turns float32 rounding into noise far from a cell.
Every forward family is supported (gravity g_z, FTG Gzz and the full
tensor, magnetic TMI or three-component data on susceptibility or the
magnetization vector); depth weighting (the column weight) and the
problem x data row weights are applied on the fly
(sensitivity_gravmag.F90:228, 836-843).

On a CUDA device the per-cell operator's products are kernel B2
(ops/prism_matvec.py, csrc/prism_matvec_f32.cu and _f64.cu) and the
lattice operator's kernel B3 (ops/lattice_matvec.py, csrc/lattice_matvec.cu):
every (observation, cell) pair evaluated on the fly, no row stored. On the
CPU they are the plain chunk loops below. The JAX package corrects each
observation's near cells with a sequential per-point scan, a workaround for
a TPU worker crash. Here a chunk's corrections are gathered and scattered in
one batch; the adjoint's scatter sums every cell's terms in one fixed order
(_index_add_in_order), so two runs agree to the last bit, as two runs of
kernels B2 and B3 do.

The float32 kernels take the blend's near cells out of their main loops. Each
blended operator builds its near lists once at construction, on its device
(its candidate cells by observation and, transposed, its candidate
observations by cell: near_cell_indices and near_idx_transpose for the
per-cell operator, lattice_near_lists for the lattice one), and from them,
on the card, its stored near rows (with_near_rows): the pairs the main
loop's own test calls near, each row's closed forms in float64 rounded to
float32, by observation and by cell (near_row_layout). A near pass is a read
of those rows. On the CPU no product reads them, so none are stored there. The operators' _split_matvec / _split_rmatvec are the plain version of
that split (the main loop with the near cells zeroed, plus the near pass
_near_matvec / _near_rmatvec, which evaluates the rows again), in float64
sums; _stored_near_matvec / _stored_near_rmatvec are the near pass over the
stored rows, and _near_pairs_plain the plain version of their build.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from tomofastx_tpu_torch.ops import prism
from tomofastx_tpu_torch.ops.prism import (
    G_GRAV,
    combine_mag_tensor,
    ftg_corner_potentials,
    gz_corner_potential,
    mag_corner_potentials,
)
from tomofastx_tpu_torch.ops._cuda_build import NEAR_ROW_FIELDS
from tomofastx_tpu_torch.ops.lattice_matvec import lattice_matvec, lattice_near_build, lattice_rmatvec
from tomofastx_tpu_torch.ops.lattice_matvec import partial_bytes as lattice_partial_bytes
from tomofastx_tpu_torch.ops.prism_matvec import partial_bytes as prism_partial_bytes
from tomofastx_tpu_torch.ops.prism_matvec import prism_matvec, prism_near_build, prism_rmatvec
from tomofastx_tpu_torch.utils.trace import count

PROBE_ABORT = (
    "Data coordinate coincides with model grid boundary. Adjust the model grid! (non-finite "
    "matrix-free probe matvec; reference aborts here, gravity_field.f90:99-107)"
)


def _index_add_in_order(target: torch.Tensor, index: torch.Tensor, values: torch.Tensor):
    """target[index] += values (1-D), duplicates summed in one fixed order:
    index_put_ with accumulate under torch's deterministic mode (sort-based
    on CUDA, serial on the CPU), not atomics."""
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        target.index_put_((index,), values, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


def _in_float64(cells, xs, ys, zs):
    """A blend's near-cell operands in float64: (cells, xs, ys, zs).

    The blended float32 operators evaluate the closed forms of the near
    cells (a few hundred a point) in float64 and round the rows to the
    operator's dtype: float32 corner sums carry a cancellation error that
    the quadrature does not, and the card runs float64 natively. The JAX
    package evaluates them in float32 (float64 is emulated on a TPU); the
    port's float32 operators are the more accurate for it (PERF.md)."""
    return tuple(c.double() for c in cells), xs.double(), ys.double(), zs.double()


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


# Pairs a plain near pass evaluates at a time.
PAIR_CHUNK = 1 << 16


def _csr_pairs(ptr, idx):
    """(row, column) int64 of every entry of a CSR list (ptr (rows + 1,),
    idx the columns of each row in turn), in its order."""
    rows = torch.repeat_interleave(torch.arange(ptr.shape[0] - 1, device=idx.device), (ptr[1:] - ptr[:-1]).long())
    return rows, idx.long()


def candidate_transpose(ptr, idx, ncols):
    """The transpose of a CSR list over ncols columns: (ptr (ncols + 1,),
    the rows of each column in increasing order), int32, by a stable sort of
    the pairs by column on the lists' device."""
    rows, cols = _csr_pairs(ptr, idx)
    tptr = torch.zeros(ncols + 1, dtype=torch.int64, device=idx.device)
    tptr[1:] = torch.cumsum(torch.bincount(cols, minlength=ncols), 0)
    return tptr.to(torch.int32), rows[torch.sort(cols, stable=True).indices].to(torch.int32)


# The lanes a segment of the stored near rows may take in a near pass
# (csrc/prism_common.cuh near_stream): a power of two up to a warp, or a
# block of 256.
STREAM_LANES = (1, 2, 4, 8, 16, 32, 256)


def stream_lanes(pairs: int, segments: int) -> int:
    """The lanes a near pass gives each of `segments` segments of `pairs`
    stored pairs in all: about 4 pairs a lane, up to a warp; a block of 256
    where a segment holds 1024 pairs or more on the mean."""
    mean = pairs / max(segments, 1)
    if mean >= 1024:
        return 256
    lanes = 1
    while lanes < 32 and 4 * lanes < mean:
        lanes *= 2
    return lanes


def near_row_layout(b, n, rows, nrows, lanes=None) -> dict:
    """A blended operator's stored near rows from its near pairs (b, n)
    (int64, in increasing order of (b, n)) and their rows (P, nmc, ndc):
    {near_rptr (nrows + 1,), near_rcell, near_rval} by observation (the near
    matvec's), {near_ccell, near_cptr (cells + 1,), near_cobs, near_cval} by
    cell over the cells that have a near pair, each cell's observations in
    increasing order (the near rmatvec's), indices in int32, and near_lanes,
    (lanes a row, lanes a cell) of the near passes (stream_lanes, unless
    given: a sharded part takes its whole operator's, so that each cell's sum
    keeps its order)."""
    dev = rows.device
    rptr = torch.zeros(nrows + 1, dtype=torch.int64, device=dev)
    rptr[1:] = torch.cumsum(torch.bincount(b, minlength=nrows), 0)
    order = torch.sort(n, stable=True).indices
    ccell, counts = torch.unique_consecutive(n[order], return_counts=True)
    cptr = torch.zeros(ccell.shape[0] + 1, dtype=torch.int64, device=dev)
    cptr[1:] = torch.cumsum(counts, 0)
    if lanes is None:
        lanes = (stream_lanes(b.shape[0], nrows), stream_lanes(b.shape[0], ccell.shape[0]))
    return {"near_rptr": rptr.to(torch.int32), "near_rcell": n.to(torch.int32), "near_rval": rows.contiguous(),
            "near_ccell": ccell.to(torch.int32), "near_cptr": cptr.to(torch.int32),
            "near_cobs": b[order].to(torch.int32), "near_cval": rows[order].contiguous(), "near_lanes": tuple(lanes)}


def _stored_near_matvec(op, xw, ndc):
    """(nrows_padded, ndc) float64: the near matvec over op's stored rows by
    observation, each row's terms summed in one fixed order."""
    pairs = _csr_pairs(op.near_rptr, op.near_rcell)
    return _near_sum((op.near_rptr.shape[0] - 1, ndc), pairs, lambda s, e: op.near_rval[s:e],
                     _matvec_terms(xw, ndc), xw.device)


def _stored_near_rmatvec(op, u, ncells):
    """(nmc, ncells) float64: the near rmatvec over op's stored rows by cell,
    each cell's terms summed in one fixed order."""
    seg, b = _csr_pairs(op.near_cptr, op.near_cobs)
    return _near_sum((op.near_cval.shape[1], ncells), (b, op.near_ccell.long()[seg]), lambda s, e: op.near_cval[s:e],
                     _rmatvec_terms(u, ncells), u.device)


def _pair_rows(rows_of, b, n):
    """rows_at for _near_sum: rows_of(b, n) of the pairs s .. e - 1."""
    return lambda s, e: rows_of(b[s:e], n[s:e])


def _near_sum(shape, pairs, rows_at, terms_of, device):
    """A plain near pass: float64 zeros of `shape` plus, for the pairs (b,
    n), PAIR_CHUNK at a time, the (index, terms) that terms_of(rows, b, n)
    gives, rows = rows_at(s, e) of the pairs s .. e - 1 in float64, summed
    in one fixed order."""
    out = torch.zeros(shape, dtype=torch.float64, device=device)
    b, n = pairs
    for s in range(0, b.shape[0], PAIR_CHUNK):
        e = min(b.shape[0], s + PAIR_CHUNK)
        index, terms = terms_of(rows_at(s, e).double(), b[s:e], n[s:e])
        _index_add_in_order(out.view(-1), index.reshape(-1), terms.reshape(-1))
    return out


def _matvec_terms(xw, ndc):
    """terms_of for a near matvec: each pair's row times xw, at (b, j)."""
    x64 = xw.double()
    j = torch.arange(ndc, device=xw.device)
    return lambda rows, b, n: (b[:, None] * ndc + j, torch.einsum("pkd,kp->pd", rows, x64[:, n]))


def _rmatvec_terms(u, ncells):
    """terms_of for a near rmatvec: each pair's row times u[b], at (k, n)."""
    u64 = u.double()
    return lambda rows, b, n: (torch.arange(rows.shape[1], device=u.device)[:, None] * ncells + n,
                               torch.einsum("pkd,pd->kp", rows, u64[b]))


def _near_pairs_kept(b, n, mask_of, rows_of):
    """(b, n, rows) of the candidate pairs (b, n) that mask_of(b, n) calls
    near, in their order, and rows_of(b, n) of them, PAIR_CHUNK at a time."""
    keep = torch.cat([mask_of(b[s : s + PAIR_CHUNK], n[s : s + PAIR_CHUNK])
                      for s in range(0, b.shape[0], PAIR_CHUNK)] or [torch.zeros(0, dtype=torch.bool, device=b.device)])
    b, n = b[keep], n[keep]
    rows = [rows_of(b[s : s + PAIR_CHUNK], n[s : s + PAIR_CHUNK]) for s in range(0, b.shape[0], PAIR_CHUNK)]
    return b, n, torch.cat(rows) if rows else rows_of(b, n)


# =============================================================================
# The generic per-cell operator
# =============================================================================


@dataclass(frozen=True)
class _Physics:
    """Static physics description."""

    problem: str  # "grav" | "magn"
    data_type: int  # gravity: 1 = g, 2 = gradiometry
    nmc: int  # model components
    ndc: int  # data components
    magv: Tuple[float, float, float]
    intensity: float
    handle_inside: bool
    # Compensated-float32 blend: far cells by Gauss quadrature (see
    # ops/prism.py). Set for float32 per-cell operators.
    far_quad: bool = False


def _rows(phys: _Physics, grid6, xs, ys, zs, base_only=False):
    """(B, N, nmc, ndc) physics rows for a batch of observation points, by
    the dispatch the stored build uses (ops/sensitivity.py::forward_rows).
    base_only=True: the 27-point quadrature for every cell; the blended
    operator adds the near cells' closed-form difference by _corr_rows."""
    from tomofastx_tpu_torch.ops.sensitivity import _forward_rows_quad, forward_rows

    args = (phys.problem, phys.data_type, phys.nmc, phys.ndc, phys.magv, phys.intensity)
    if base_only:
        return _forward_rows_quad(*args, grid6, xs, ys, zs)
    return forward_rows(*args, phys.handle_inside, grid6, xs, ys, zs, far_quad=phys.far_quad)


def _corr_rows(phys: _Physics, grid6, xs, ys, zs, idx):
    """(B, K, nmc, ndc) near-patch correction rows on each point's candidate
    cells idx (B, K): where(near, closed - quad, 0), so that the blended
    operator is quadrature everywhere plus this correction. The closed forms
    are evaluated in float64 (_in_float64)."""
    from tomofastx_tpu_torch.ops.sensitivity import _forward_rows_quad, forward_rows

    sub = tuple(a[idx] for a in grid6)
    args = (phys.problem, phys.data_type, phys.nmc, phys.ndc, phys.magv, phys.intensity)
    closed = forward_rows(*args, phys.handle_inside, *_in_float64(sub, xs, ys, zs)).to(xs.dtype)
    quad = _forward_rows_quad(*args, sub, xs, ys, zs)
    near = ~prism.far_mask(xs[:, None], ys[:, None], zs[:, None], *sub)
    return torch.where(near[..., None, None], closed - quad, torch.zeros_like(closed))


def near_cell_indices(grid6, xd, yd, zd, margin=1.001):
    """(npoints, K) int64 candidate near-cell indices for the generic blended
    operator, computed once at construction on the grid's device.

    K = the most cells any point has within margin x the blend radius (in
    own-half-diagonal units, the prism.far_mask criterion), rounded up to a
    multiple of 8; each point keeps the K cells of largest nearness score
    radius^2 d2 - r2, so all of its truly near cells are in (their count is
    at most K and their scores top the order). The margin absorbs rounding
    between this pass and the operator's own mask. Ties at the K-th place
    may be ordered otherwise than by the JAX package's top_k; the near
    cells are in either way."""
    N = grid6[0].shape[0]
    npts = xd.shape[0]
    # The JAX package's chunk: about 0.5 GB of float32 scores.
    chunk = max(8, min(512, (1 << 29) // (4 * max(N, 1))))
    rad = prism.FAR_QUAD_RADIUS * margin
    X1, X2, Y1, Y2, Z1, Z2 = grid6
    cx, cy, cz = 0.5 * (X1 + X2), 0.5 * (Y1 + Y2), 0.5 * (Z1 + Z2)
    hx, hy, hz = 0.5 * (X2 - X1), 0.5 * (Y2 - Y1), 0.5 * (Z2 - Z1)
    d2 = hx * hx + hy * hy + hz * hz
    spans = [(s, min(npts, s + chunk)) for s in range(0, npts, chunk)]

    counts = torch.stack([
        (~prism.far_mask(xd[s:e, None], yd[s:e, None], zd[s:e, None], *grid6, radius=rad)).sum(1).max()
        for s, e in spans
    ])
    K = int(counts.max())
    K = min(max(((K + 7) // 8) * 8, 8), N)

    def top(s, e):
        r2 = (cx - xd[s:e, None]) ** 2 + (cy - yd[s:e, None]) ** 2 + (cz - zd[s:e, None]) ** 2
        return torch.topk((rad * rad) * d2 - r2, K, dim=1).indices

    return torch.cat([top(s, e) for s, e in spans])


def near_idx_transpose(near_idx, cell_lo, ncells):
    """(near_tptr (ncells + 1,), near_obs) int32: the candidates of
    near_idx (nrows, K) among the cells [cell_lo, cell_lo + ncells),
    transposed: each of those cells' observations in increasing order."""
    local = near_idx.long() - cell_lo
    own = (local >= 0) & (local < ncells)
    ptr = torch.zeros(near_idx.shape[0] + 1, dtype=torch.int64, device=near_idx.device)
    ptr[1:] = torch.cumsum(own.sum(1), 0)
    return candidate_transpose(ptr, local[own], ncells)


@dataclass
class MatrixFreeKernel:
    """Row-regenerating sensitivity operator ((nrows*ndc) x (nmc*N_true)).

    The cell axis may be zero-padded (N >= N_true) so that it divides a
    mesh: padding cells are dummy prisms far outside the model volume with
    cw = 0, so their rows contribute nothing; matvec pads x and rmatvec
    slices the gradient back. cell_lo is the first cell of this operator's
    cells when it is one slot's part of a cells-sharded operator
    (ShardedMatrixFreeKernel); near_idx keeps the whole grid's numbering,
    -1 where a candidate is another part's cell.
    The products run kernel B2 (prism_matvec, prism_rmatvec) on the card
    and the chunk loop (_partial_matvec, _partial_rmatvec) on the CPU. The
    blend's near candidates, near_idx and its transpose over this operator's
    cells (near_tptr, near_obs; near_idx_transpose), and on the card its
    stored near rows (near_rptr .. near_cval, near_lanes; with_near_rows),
    which the near passes read, are built once at construction."""

    grid6: tuple  # (X1, X2, Y1, Y2, Z1, Z2), each (N,)
    xd: torch.Tensor  # (nrows_padded,)
    yd: torch.Tensor
    zd: torch.Tensor
    cw: torch.Tensor  # (N,) column weight; 0 on cell padding
    row_w: torch.Tensor  # (nrows_padded, ndc) problem x data weights; 0 on padding
    phys: _Physics
    chunk: int
    nrows: int  # true data count
    N_true: int = None  # logical cell count; None = no cell padding
    # (nrows_padded, K) int32 candidate near-cell indices (near_cell_indices)
    # for the blend; None when phys.far_quad is off.
    near_idx: torch.Tensor = None
    cell_lo: int = 0
    # The candidates transposed over this operator's cells (N + 1,) and
    # (pairs,), int32: each cell's observations in increasing order.
    near_tptr: torch.Tensor = None
    near_obs: torch.Tensor = None
    # The stored near rows (near_row_layout): the pairs the main loop's far
    # test calls near, by observation (near_rptr, near_rcell, near_rval) and
    # by cell (near_ccell, near_cptr, near_cobs, near_cval), and the near
    # passes' lanes a segment; None when phys.far_quad is off, and off the
    # card.
    near_rptr: torch.Tensor = None
    near_rcell: torch.Tensor = None
    near_rval: torch.Tensor = None
    near_ccell: torch.Tensor = None
    near_cptr: torch.Tensor = None
    near_cobs: torch.Tensor = None
    near_cval: torch.Tensor = None
    near_lanes: tuple = None

    @property
    def graph_capturable(self) -> bool:
        """Whether the fused loop captures a major over this operator as a
        CUDA graph (inversion/joint.py::capture_unit): on the card, where
        its products are kernel B2's few launches, and not on the CPU."""
        return self.cw.device.type == "cuda"

    @property
    def products_by(self) -> str:
        """What computes the products, for the log."""
        if self.cw.device.type == "cuda":
            return f"kernel B2, csrc/prism_matvec_{'f64' if self.xd.dtype == torch.float64 else 'f32'}.cu"
        return "the plain chunk loop on the CPU"

    @property
    def N(self) -> int:
        return self.grid6[0].shape[0]

    @property
    def ncols(self) -> int:
        return self.phys.nmc * (self.N_true if self.N_true is not None else self.N)

    @property
    def nbytes(self) -> int:
        return _nbytes(*self.grid6, self.xd, self.yd, self.zd, self.cw, self.row_w, self.near_idx, self.near_tptr,
                       self.near_obs) + self.near_rows_nbytes

    @property
    def near_rows_nbytes(self) -> int:
        """Bytes of the stored near rows, in both orders (part of nbytes)."""
        return _nbytes(*(getattr(self, f) for f in NEAR_ROW_FIELDS))

    def with_near_rows(self, lanes=None) -> "MatrixFreeKernel":
        """This operator with its stored near rows, built once, at
        construction, by kernel B2's build (ops/prism_matvec.py
        prism_near_build) and laid out by near_row_layout. As it is without
        a blend, and off the card, where no product reads them: the CPU's
        products run the chunk loop, its near wrappers _near_matvec /
        _near_rmatvec (near_rows_plain gives the layout on any device)."""
        if not self.phys.far_quad or self.near_idx is None or self.xd.device.type != "cuda":
            return self
        return dataclasses.replace(self, **near_row_layout(*prism_near_build(self), self.xd.shape[0], lanes))

    @property
    def partial_nbytes(self) -> int:
        """Bytes of the float64 partial sums one product of kernel B2
        allocates on the card (the larger of its matvec's and its
        rmatvec's), beside nbytes, which the operator holds between
        products."""
        return max(prism_partial_bytes(self))

    @property
    def _patched(self) -> bool:
        return self.phys.far_quad and self.near_idx is not None

    def _chunks(self):
        return [slice(s, s + self.chunk) for s in range(0, self.xd.shape[0], self.chunk)]

    def _local_candidates(self, sl):
        """(idx, valid): this chunk's candidate cells in this operator's own
        numbering, and which of them are its cells."""
        idx = self.near_idx[sl] - self.cell_lo
        valid = (idx >= 0) & (idx < self.N)
        return idx.clamp(0, self.N - 1), valid

    def _padded_model(self, x):
        x2 = x.reshape(self.phys.nmc, -1)
        if x2.shape[1] < self.N:
            x2 = torch.nn.functional.pad(x2, (0, self.N - x2.shape[1]))
        return x2

    def _partial_matvec(self, xw):
        """(nrows_padded, ndc) sum over this operator's cells of
        rows x (cw x), before the row weights: the plain version of kernel
        B2's matvec (ops/prism_matvec.py::prism_matvec)."""
        out = []
        for sl in self._chunks():
            xs, ys, zs = self.xd[sl], self.yd[sl], self.zd[sl]
            d = torch.einsum("bnkd,kn->bd", _rows(self.phys, self.grid6, xs, ys, zs, base_only=self._patched), xw)
            if self._patched:
                idx, valid = self._local_candidates(sl)
                corr = _corr_rows(self.phys, self.grid6, xs, ys, zs, idx)
                corr = torch.where(valid[..., None, None], corr, torch.zeros_like(corr))
                d = d + torch.einsum("bjkd,kbj->bd", corr, xw[:, idx])
            out.append(d)
        return torch.cat(out)

    def _partial_rmatvec(self, u_pad):
        """(nmc, N) sum over the observations of rows^T u, before cw: the
        plain version of kernel B2's rmatvec (prism_rmatvec)."""
        nmc = self.phys.nmc
        g = torch.zeros((nmc, self.N), dtype=u_pad.dtype, device=u_pad.device)
        for sl in self._chunks():
            xs, ys, zs, uc = self.xd[sl], self.yd[sl], self.zd[sl], u_pad[sl]
            g = g + torch.einsum("bnkd,bd->kn", _rows(self.phys, self.grid6, xs, ys, zs, base_only=self._patched), uc)
            if self._patched:
                idx, valid = self._local_candidates(sl)
                corr = _corr_rows(self.phys, self.grid6, xs, ys, zs, idx)
                corr = torch.where(valid[..., None, None], corr, torch.zeros_like(corr))
                vals = torch.einsum("bjkd,bd->kbj", corr, uc)  # (nmc, B, K)
                flat = torch.arange(nmc, device=g.device)[:, None, None] * self.N + idx[None]
                _index_add_in_order(g.view(-1), flat.reshape(-1), vals.reshape(-1))
        return g

    def _near_pair_rows(self, b, n):
        """(P, nmc, ndc) rows of candidate pairs (observation b, cell n of
        this operator) as kernel B2's near pass evaluates them: the closed
        forms in float64 rounded to the operator's type where the far mask
        calls the pair near, else 0."""
        from tomofastx_tpu_torch.ops.sensitivity import forward_rows

        sub = tuple(a[n][:, None] for a in self.grid6)
        xs, ys, zs = self.xd[b], self.yd[b], self.zd[b]
        args = (self.phys.problem, self.phys.data_type, self.phys.nmc, self.phys.ndc, self.phys.magv,
                self.phys.intensity, self.phys.handle_inside)
        closed = forward_rows(*args, *_in_float64(sub, xs, ys, zs)).to(xs.dtype)[:, 0]
        return torch.where(self._near_pair_mask(b, n)[:, None, None], closed, torch.zeros_like(closed))

    def _near_pair_mask(self, b, n):
        """(P,) bool: which candidate pairs (observation b, cell n of this
        operator) the far mask calls near."""
        sub = tuple(a[n][:, None] for a in self.grid6)
        return ~prism.far_mask(self.xd[b][:, None], self.yd[b][:, None], self.zd[b][:, None], *sub)[:, 0]

    def _near_pairs_plain(self):
        """(b, n, rows): the plain version of the stored near rows' build
        (ops/prism_matvec.py::prism_near_build): the candidates of near_idx
        among this operator's cells that the far mask calls near, in
        increasing order of (b, n), and their _near_pair_rows."""
        K = self.near_idx.shape[1]
        local = self.near_idx.long() - self.cell_lo
        own = (local >= 0) & (local < self.N)
        b = torch.arange(self.xd.shape[0], device=local.device)[:, None].expand(-1, K)[own]
        n = local[own]
        key = torch.sort(b * self.N + n).values
        return _near_pairs_kept(key // self.N, key % self.N, self._near_pair_mask, self._near_pair_rows)

    def near_rows_plain(self) -> dict:
        """The stored near rows as their plain build gives them
        (near_row_layout of _near_pairs_plain, with this operator's lanes)."""
        return near_row_layout(*self._near_pairs_plain(), self.xd.shape[0], self.near_lanes)

    def _stored_near_matvec(self, xw):
        """(nrows_padded, ndc) float64: the near matvec over the stored rows
        (the plain version of prism_near_matvec's kernel)."""
        return _stored_near_matvec(self, xw, self.phys.ndc)

    def _stored_near_rmatvec(self, u_pad):
        """(nmc, N) float64: the near rmatvec over the stored rows (the plain
        version of prism_near_rmatvec's kernel)."""
        return _stored_near_rmatvec(self, u_pad, self.N)

    def _near_matvec(self, xw):
        """(nrows_padded, ndc) float64: the blend's near pass of the matvec
        over near_idx, this operator's candidates of each observation, each
        pair's row evaluated again (the plain version of
        ops/prism_matvec.py::prism_near_matvec)."""
        K = self.near_idx.shape[1]
        local = self.near_idx.long() - self.cell_lo
        own = (local >= 0) & (local < self.N)
        b = torch.arange(self.xd.shape[0], device=local.device)[:, None].expand(-1, K)
        b, n = b[own], local[own]
        return _near_sum((self.xd.shape[0], self.phys.ndc), (b, n), _pair_rows(self._near_pair_rows, b, n),
                         _matvec_terms(xw, self.phys.ndc), xw.device)

    def _near_rmatvec(self, u_pad):
        """(nmc, N) float64: the blend's near pass of the rmatvec over the
        transposed candidates (the plain version of prism_near_rmatvec)."""
        n, b = _csr_pairs(self.near_tptr, self.near_obs)
        return _near_sum((self.phys.nmc, self.N), (b, n), _pair_rows(self._near_pair_rows, b, n),
                         _rmatvec_terms(u_pad, self.N), u_pad.device)

    def _main_rows(self, xs, ys, zs):
        """(B, N, nmc, ndc) rows of kernel B2's main loop: the 27-point rule,
        zero where the far mask calls a cell near."""
        quad = _rows(self.phys, self.grid6, xs, ys, zs, base_only=True)
        near = ~prism.far_mask(xs[:, None], ys[:, None], zs[:, None], *self.grid6)
        return torch.where(near[..., None, None], torch.zeros_like(quad), quad)

    def _split_matvec(self, xw):
        """(nrows_padded, ndc) rows x xw as kernel B2 splits the blend: its
        main loop plus its near pass, summed in float64 and rounded once (the
        plain version of prism_matvec's split; _partial_matvec, the chunk
        loop, adds the near correction to float32 rows)."""
        x64 = xw.double()
        d = torch.cat([torch.einsum("bnkd,kn->bd", self._main_rows(self.xd[sl], self.yd[sl], self.zd[sl]).double(),
                                    x64) for sl in self._chunks()])
        return (d + self._near_matvec(xw)).to(xw.dtype)

    def _split_rmatvec(self, u_pad):
        """(nmc, N) rows^T u as kernel B2 splits the blend (_split_matvec)."""
        u64 = u_pad.double()
        g = self._near_rmatvec(u_pad)
        for sl in self._chunks():
            g = g + torch.einsum("bnkd,bd->kn", self._main_rows(self.xd[sl], self.yd[sl], self.zd[sl]).double(),
                                 u64[sl])
        return g.to(u_pad.dtype)

    def _padded_residual(self, u):
        u_pad = torch.zeros((self.xd.shape[0], self.phys.ndc), dtype=u.dtype, device=u.device)
        u_pad[: self.nrows] = u.reshape(self.nrows, self.phys.ndc)
        return u_pad * self.row_w

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        d = prism_matvec(self, self.cw[None, :] * self._padded_model(x))
        return (self.row_w * d)[: self.nrows].reshape(-1)

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        g = self.cw[None, :] * prism_rmatvec(self, self._padded_residual(u))
        if self.N_true is not None and self.N_true != self.N:
            g = g[:, : self.N_true]
        return g.reshape(-1)


@dataclass
class ShardedMatrixFreeKernel:
    """A MatrixFreeKernel cut over the cells: slot s holds the cells
    [s*N/n, (s+1)*N/n) with their column weights, and every observation.
    matvec adds the slots' partial data on the home device in slot order;
    rmatvec concatenates the slots' gradients. The candidate near cells
    stay in the whole grid's numbering; each slot keeps those of its own
    (the others -1), their transpose over its cells and, on the card, its
    stored near rows. `whole` is the unsharded operator on the home device
    without stored near rows: it only pads the vectors and weights the
    rows."""

    whole: MatrixFreeKernel
    parts: list
    mesh: object  # parallel.mesh.Mesh

    @property
    def graph_capturable(self) -> bool:
        """Captured where every part sits on one card (capture_unit
        refuses a mesh of several cards on its own)."""
        return len({p.cw.device for p in self.parts}) == 1 and all(p.graph_capturable for p in self.parts)

    @classmethod
    def shard(cls, k: MatrixFreeKernel, mesh) -> "ShardedMatrixFreeKernel":
        n = len(mesh.slots)
        if k.N % n:
            raise ValueError(
                f"matrix-free kernel has {k.N} (padded) cells, not divisible by the {n}-slot mesh; "
                f"build it with pad_cells_to={n}"
            )
        per = k.N // n
        parts = []
        for s, dev in enumerate(mesh.slots):
            sl = slice(s * per, (s + 1) * per)
            near = {}
            if k.near_idx is not None:
                idx = k.near_idx.to(dev)
                near["near_idx"] = torch.where((idx >= s * per) & (idx < (s + 1) * per), idx, -1)
                near["near_tptr"], near["near_obs"] = near_idx_transpose(near["near_idx"], s * per, per)
            part = dataclasses.replace(
                k, grid6=tuple(a[sl].to(dev) for a in k.grid6), xd=k.xd.to(dev), yd=k.yd.to(dev),
                zd=k.zd.to(dev), cw=k.cw[sl].to(dev), row_w=k.row_w.to(dev), N_true=None, cell_lo=s * per, **near,
                **dict.fromkeys(NEAR_ROW_FIELDS),
            )
            # Each part's stored near rows, with the whole operator's lanes:
            # each cell's near sum then runs as unsharded, to the last bit.
            parts.append(part.with_near_rows(k.near_lanes))
        whole = dataclasses.replace(k, **{f: getattr(k, f).to(mesh.home) for f in ("xd", "cw", "row_w")},
                                    **dict.fromkeys(NEAR_ROW_FIELDS), near_lanes=None)
        return cls(whole, parts, mesh)

    @property
    def nrows(self) -> int:
        return self.whole.nrows

    @property
    def ncols(self) -> int:
        return self.whole.ncols

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        home, x2 = self.mesh.home, self.whole._padded_model(x)
        d = None
        for p in self.parts:
            xs = x2[:, p.cell_lo : p.cell_lo + p.N].to(p.cw.device)
            part = prism_matvec(p, p.cw[None, :] * xs).to(home)
            d = part if d is None else d + part
        return (self.whole.row_w * d)[: self.nrows].reshape(-1)

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        home, u_pad = self.mesh.home, self.whole._padded_residual(u)
        g = torch.cat([(p.cw[None, :] * prism_rmatvec(p, u_pad.to(p.cw.device))).to(home) for p in self.parts],
                      dim=1)
        return g[:, : self.ncols // self.whole.phys.nmc].reshape(-1)

    def slot_bytes(self) -> list:
        return [p.nbytes for p in self.parts]


# =============================================================================
# The corner-lattice operator
# =============================================================================


def detect_lattice(grid):
    """Return (xe, ye, ze) edge vectors when the grid is a tensor-product
    lattice (every cell face shared exactly), else None. Exact float
    comparison: lattice grids written by the shipped tools repeat the
    same edge literals, and any mismatch safely falls back to the general
    per-cell rows."""
    nx, ny, nz = grid.nx, grid.ny, grid.nz

    def edges(lo, hi, axis):
        a = np.asarray(lo).reshape(nz, ny, nx)
        b = np.asarray(hi).reshape(nz, ny, nx)
        # lo must vary only along `axis` (0 = z, 1 = y, 2 = x).
        ref = [slice(0, 1)] * 3
        ref[axis] = slice(None)
        if not np.array_equal(a, np.broadcast_to(a[tuple(ref)], a.shape)):
            return None
        if not np.array_equal(b, np.broadcast_to(b[tuple(ref)], b.shape)):
            return None
        lo1 = a[tuple(ref)].reshape(-1)
        hi1 = b[tuple(ref)].reshape(-1)
        if not np.array_equal(lo1[1:], hi1[:-1]):
            return None
        return np.concatenate([lo1, hi1[-1:]])

    xe = edges(grid.X1, grid.X2, 2)
    ye = edges(grid.Y1, grid.Y2, 1)
    ze = edges(grid.Z1, grid.Z2, 0)
    if xe is None or ye is None or ze is None:
        return None
    return xe, ye, ze


def _diff3(F, axes=(-3, -2, -1)):
    """D[F](i,j,k) = sum_{K,L,M} (-1)^(K+L+M) F[i+K,j+L,k+M] over the three
    lattice axes `axes` (per axis out[i] = F[i] - F[i+1]): corners -> cells,
    keeping the cancellation local to each cell's own 8 corner values."""
    g = F
    for ax in axes:
        n = g.shape[ax]
        g = g.narrow(ax, 0, n - 1) - g.narrow(ax, 1, n - 1)
    return g


def _lattice_closed_rows(xe, ye, ze, x, y, z, problem, data_type, magv, intensity, nmc, ndc):
    """Corner-difference closed-form rows on a lattice, for a batch of
    observation points x, y, z of shape (B,): (B, nz, ny, nx, nmc, ndc).
    The edges are shared, (n+1,), or each point's own, (B, n+1) (a window
    of the lattice). Each lattice corner's antiderivative is evaluated once
    and shared by up to 8 cells (~8x fewer transcendentals than the
    per-cell 8-corner sums the reference loops, gravity_field.f90:131-195,
    magnetic_field.f90:321-457)."""
    cx = (x[:, None] - xe)[:, None, None, :]
    cy = (y[:, None] - ye)[:, None, :, None]
    cz = (z[:, None] - ze)[:, :, None, None]

    if problem == "grav" and data_type == 1:
        rows = -G_GRAV * _diff3(gz_corner_potential(cx, cy, cz))
        return rows[..., None, None]

    if problem == "grav":  # data_type 2: FTG
        # The gradiprism kernels flip z internally (ZZ = -(zd - Z)); -cz turns
        # a +0.0 offset into -0.0, as in the JAX package, which decides the
        # atan2 branch of an observation on a lattice plane.
        ps = ftg_corner_potentials(cx, cy, -cz)
        if ndc == 1:  # Gzz only
            rows = -G_GRAV * _diff3(ps[2])
            return rows[..., None, None]
        rows = torch.stack([-G_GRAV * _diff3(pc) for pc in ps], dim=-1)
        return rows[..., None, :]

    # Magnetic corner potentials are evaluated at s = corner - obs (the
    # sharmbox convention, magnetic_field.f90:330-335), not obs - corner:
    # f3 = log(R + s_z) is singular on the ray {s_x = s_y = 0, s_z < 0},
    # which with s = corner - obs points up, away from the grid; with
    # obs - corner an observation exactly above a lattice node would hit
    # log(0). The combination with the field is linear with scalar
    # coefficients and D is linear, so the corner potentials are combined
    # first and each output channel is differenced once (txx = D[f1],
    # txy = -D[f3], tyz = -D[f4], txz = -D[f5], tzz = -D[f1 + f2]).
    f1, f2, f3, f4, f5 = mag_corner_potentials(-cx, -cy, -cz)
    Fc = combine_mag_tensor(
        (f1, -f3, -f5), (-f3, f2, -f4), (-f5, -f4, -(f1 + f2)),
        magv, intensity, nmc, ndc,
    )  # (B, nz+1, ny+1, nx+1, nmc, ndc)
    return _diff3(Fc, axes=(-5, -4, -3))


def _lattice_bounds(xe, ye, ze):
    """Cell bounds of a lattice (edges (n+1,) or per point (B, n+1)) shaped
    to broadcast over (B, nz, ny, nx): x bounds vary along the last axis
    only, y along the third, z along the second."""

    def axis(e, dim):
        e = e if e.ndim == 2 else e[None]
        shape = [e.shape[0], 1, 1, 1]
        shape[dim] = e.shape[1] - 1
        return e[:, :-1].reshape(shape), e[:, 1:].reshape(shape)

    return (*axis(xe, 3), *axis(ye, 2), *axis(ze, 1))


def _lattice_quad_rows(xe, ye, ze, x, y, z, problem, data_type, magv, intensity, nmc, ndc, order=3):
    """order^3-point Gauss-quadrature rows for every lattice cell, for a
    batch of points (B,): (B, nz, ny, nx, nmc, ndc); the edges as in
    _lattice_closed_rows. order=2 is the blended operator's cheap base tier
    (prism.FAR_QUAD2_RADIUS_*), order=3 its middle tier. The cell bounds
    broadcast along their lattice axes: the values are those of flat
    per-cell bounds, which the JAX package uses because the broadcast form
    crashed its TPU worker above ~2M cells."""
    bounds = _lattice_bounds(xe, ye, ze)
    xs, ys, zs = (a[:, None, None, None] for a in (x, y, z))
    if problem == "magn":
        tq, uq, vq = prism.magnetic_tensor_quad(xs, ys, zs, *bounds, order=order)
        return combine_mag_tensor(tq, uq, vq, magv, intensity, nmc, ndc)
    if data_type == 1:
        return prism.gravi_z_quad(xs, ys, zs, *bounds, order=order)[..., None, None]
    if ndc == 1:
        return prism.gradi_zz_quad(xs, ys, zs, *bounds, order=order)[..., None, None]
    return torch.stack(prism.gradi_full_quad(xs, ys, zs, *bounds, order=order), dim=-1)[..., None, :]


def tier2_radius(problem: str, data_type: int) -> float:
    """Tier-2 window radius (in half-diagonals) of the tiered blend, shared
    by the factory and parallel/mesh.py::shard_kernel so that meshed and
    unmeshed operators use the same windows."""
    return prism.FAR_QUAD2_RADIUS_GZ if (problem == "grav" and data_type == 1) else prism.FAR_QUAD2_RADIUS_TENSOR


def lattice_near_window(xe, ye, ze, xd, yd, zd, radius=None):
    """Host geometry of the blended lattice operator's near window.

    Returns ((wz, wy, wx), wi0): the per-axis window sizes cover every cell
    whose centre lies within radius x the largest half-diagonal of any
    point, and wi0 (npoints, 3) holds each point's window start indices
    (z, y, x). Every near cell of a point (centre distance <= radius x its
    own half-diagonal) is inside that point's window: near implies
    |c_ax - t_ax| <= D := radius x the largest half-diagonal per axis, the
    window size is the most cell centres in any closed interval of length
    2D, and the start is clamped to keep the window in range. A relative
    margin of 1e-5 on D absorbs float32 rounding of the operator's own mask
    at the boundary. Float64 numpy throughout, as in the JAX package, so
    both pick the same windows."""
    if radius is None:
        radius = prism.FAR_QUAD_RADIUS
    xe = np.asarray(xe, np.float64)
    ye = np.asarray(ye, np.float64)
    ze = np.asarray(ze, np.float64)
    maxh2 = (
        np.max(0.5 * np.diff(xe)) ** 2
        + np.max(0.5 * np.diff(ye)) ** 2
        + np.max(0.5 * np.diff(ze)) ** 2
    )
    D = radius * np.sqrt(maxh2) * (1.0 + 1.0e-5)

    def axis(e, t):
        c = 0.5 * (e[:-1] + e[1:])
        n = len(c)
        W = int(np.max(np.searchsorted(c, c + 2.0 * D, side="right") - np.arange(n)))
        W = max(1, min(W, n))
        lo = np.searchsorted(c, np.asarray(t, np.float64) - D, side="left")
        i0 = np.clip(lo, 0, n - W)
        return W, i0.astype(np.int32)

    wx, ix = axis(xe, xd)
    wy, iy = axis(ye, yd)
    wz, iz = axis(ze, zd)
    return (wz, wy, wx), np.stack([iz, iy, ix], axis=1)


def _lattice_near_mask(xe_w, ye_w, ze_w, xs, ys, zs):
    """(B, wz, wy, wx): which cells of each point's window (edges (B, w+1)
    each) are near it, the far mask's complement in float: the plain loop's
    choice of the closed forms, and kernel B3's of its near pass."""
    X1, X2, Y1, Y2, Z1, Z2 = _lattice_bounds(xe_w, ye_w, ze_w)
    r2 = (
        (0.5 * (X1 + X2) - xs[:, None, None, None]) ** 2
        + (0.5 * (Y1 + Y2) - ys[:, None, None, None]) ** 2
        + (0.5 * (Z1 + Z2) - zs[:, None, None, None]) ** 2
    )
    hx, hy, hz = 0.5 * (X2 - X1), 0.5 * (Y2 - Y1), 0.5 * (Z2 - Z1)
    return r2 <= (prism.FAR_QUAD_RADIUS * prism.FAR_QUAD_RADIUS) * (hx * hx + hy * hy + hz * hz)


def lattice_near_lists(xe, ye, ze, xd, yd, zd, win, wi0, margin=1.001):
    """The blended lattice operator's near lists, built once on the
    operator's device: {near_ptr (nrows + 1,), near_cells, near_tptr
    (N + 1,), near_obs}, int32, the operator's fields. The candidates of observation b are the
    cells of its window (win, wi0) whose centre lies within margin x
    FAR_QUAD_RADIUS of their own half-diagonals, evaluated in float64: a
    superset of its near cells, which kernel B3's near pass and the plain
    version pick by the operator's own float mask. near_cells[near_ptr[b]:
    near_ptr[b + 1]] holds b's as flat cell indices in increasing order;
    transposed (candidate_transpose), near_obs[near_tptr[n]:near_tptr[n + 1]]
    holds cell n's observations in increasing order. Chunked over the
    observations, as near_cell_indices is."""
    nx, ny, nz = xe.shape[0] - 1, ye.shape[0] - 1, ze.shape[0] - 1
    dev = xd.device
    rad2 = (prism.FAR_QUAD_RADIUS * margin) ** 2
    cells = []
    for e, t in ((ze, zd), (ye, yd), (xe, xd)):
        e = e.double()
        cells.append((0.5 * (e[:-1] + e[1:]), 0.5 * (e[1:] - e[:-1]), t.double()))
    nrows = xd.shape[0]
    chunk = max(1, (1 << 24) // (win[0] * win[1] * win[2]))
    counts, found = [], []
    for s in range(0, nrows, chunk):
        e = min(nrows, s + chunk)
        idx, d2, h2 = [], [], []
        for a, (w, (c, h, t)) in enumerate(zip(win, cells)):
            i = wi0[s:e, a, None].long() + torch.arange(w, device=dev)  # (B, w)
            idx.append(i)
            d2.append((c[i] - t[s:e, None]) ** 2)
            h2.append(h[i] ** 2)
        shape = [(slice(None), slice(None), None, None), (slice(None), None, slice(None), None),
                 (slice(None), None, None, slice(None))]
        r2 = d2[0][shape[0]] + d2[1][shape[1]] + d2[2][shape[2]]
        near = r2 <= rad2 * (h2[0][shape[0]] + h2[1][shape[1]] + h2[2][shape[2]])
        flat = (idx[0][shape[0]] * ny + idx[1][shape[1]]) * nx + idx[2][shape[2]]
        counts.append(near.sum((1, 2, 3)))
        found.append(flat.expand_as(near)[near])
    ptr = torch.zeros(nrows + 1, dtype=torch.int64, device=dev)
    ptr[1:] = torch.cumsum(torch.cat(counts), 0)
    near_cells = torch.cat(found)
    tptr, obs = candidate_transpose(ptr, near_cells, nx * ny * nz)
    return {"near_ptr": ptr.to(torch.int32), "near_cells": near_cells.to(torch.int32), "near_tptr": tptr,
            "near_obs": obs}


def lattice_rows_for_point(xe, ye, ze, x, y, z, problem, data_type, magv, intensity, nmc, ndc):
    """Per-cell closed-form rows for a batch of points by the corner
    lattice: (B, nz, ny, nx, nmc, ndc). The stored build's float64 rows and
    the near ingredient of the blended operator, whose correction window
    (LatticeMatrixFreeKernel._corr_window) evaluates them on a sub-lattice."""
    return _lattice_closed_rows(xe, ye, ze, x, y, z, problem, data_type, magv, intensity, nmc, ndc)


@dataclass
class LatticeMatrixFreeKernel:
    """Corner-lattice factorization of the matrix-free operator (gravity g_z
    and FTG, and the magnetic family but for the borehole branch).

    On a tensor-product grid the prism closed forms are alternating 2x2x2
    corner sums of point antiderivatives, and each corner is shared by up
    to 8 cells. Instead of 8 corners per cell (the reference's per-cell
    loop, gravity_field.f90:131-195), f is evaluated once per lattice corner
    and the corner field is differenced back to per-cell rows:

        rows_obs   = -d3^T F_obs          (2x2x2 alternating stencil)
        S @ x      = sum_cells rows_obs * (cw*x)
        S^T u      = cw * sum_obs u_obs * rows_obs

    ~8x fewer transcendentals per product than the per-cell operator, with
    the same local cancellation (each cell value is a difference of its own
    8 corner values). Moving the stencil onto the model vector and summing
    F * (-d3(cw*x)) over corners is the same mathematics but numerically
    fatal in float32: F is O(1e5-1e6) while the result is many orders
    smaller, so the global sum cancels past float32's mantissa (the JAX
    package measured a data misfit floor of 4e-3 instead of 1e-7 at 4M
    cells).

    In float32 (far_quad) the rows are the tiered blend: the 2^3 quadrature
    everywhere plus, on each point's window (win, wi0 from
    lattice_near_window at tier2_radius), where(near, closed, 3^3) - 2^3.

    The products run kernel B3 (lattice_matvec, lattice_rmatvec) on the card
    and the chunk loop (_partial_matvec, _partial_rmatvec) on the CPU, both
    between the column weight and the row weights. Kernel B3's blend adds
    the near cells in a pass of its own over their stored rows
    (with_near_rows), built once with the operator on the card from its
    near lists (lattice_near_lists)."""

    xe: torch.Tensor  # (nx+1,)
    ye: torch.Tensor  # (ny+1,)
    ze: torch.Tensor  # (nz+1,)
    xd: torch.Tensor  # (nrows_padded,)
    yd: torch.Tensor
    zd: torch.Tensor
    cw: torch.Tensor  # (N,)
    row_w: torch.Tensor  # (nrows_padded, ndc)
    chunk: int
    nrows: int
    nx: int
    ny: int
    nz: int
    problem: str = "grav"
    magv: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    intensity: float = 0.0
    nmc: int = 1
    ndc: int = 1
    data_type: int = 1  # gravity: 1 = g_z, 2 = gradiometry (FTG)
    far_quad: bool = False
    win: Tuple[int, int, int] = None  # (wz, wy, wx) when far_quad
    # (nrows_padded, 3) int32 window starts (z, y, x) when far_quad: kernel
    # B3 reads them as they are, so they are made int32 at construction.
    wi0: torch.Tensor = None
    # The near lists when far_quad (lattice_near_lists), int32: each
    # observation's candidate cells, near_cells[near_ptr[b]:near_ptr[b + 1]],
    # and each cell's candidate observations, near_obs[near_tptr[n]:...].
    near_ptr: torch.Tensor = None
    near_cells: torch.Tensor = None
    near_tptr: torch.Tensor = None
    near_obs: torch.Tensor = None
    # The stored near rows when far_quad, on the card (near_row_layout), as
    # the per-cell operator's: by observation, by cell, and the near passes'
    # lanes.
    near_rptr: torch.Tensor = None
    near_rcell: torch.Tensor = None
    near_rval: torch.Tensor = None
    near_ccell: torch.Tensor = None
    near_cptr: torch.Tensor = None
    near_cobs: torch.Tensor = None
    near_cval: torch.Tensor = None
    near_lanes: tuple = None

    @property
    def graph_capturable(self) -> bool:
        """Whether the fused loop captures a major over this operator as a
        CUDA graph (inversion/joint.py::capture_unit): on the card, where
        its products are kernel B3's few launches, and not on the CPU."""
        return self.cw.device.type == "cuda"

    @property
    def products_by(self) -> str:
        """What computes the products, for the log."""
        if self.cw.device.type == "cuda":
            return "kernel B3, csrc/lattice_matvec.cu"
        return "the plain chunk loop on the CPU"

    @property
    def N(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def ncols(self) -> int:
        return self.nmc * self.N

    @property
    def nbytes(self) -> int:
        return _nbytes(self.xe, self.ye, self.ze, self.xd, self.yd, self.zd, self.cw, self.row_w, self.wi0,
                       self.near_ptr, self.near_cells, self.near_tptr, self.near_obs) + self.near_rows_nbytes

    @property
    def near_rows_nbytes(self) -> int:
        """Bytes of the stored near rows, in both orders (part of nbytes)."""
        return _nbytes(*(getattr(self, f) for f in NEAR_ROW_FIELDS))

    def with_near_rows(self, lanes=None) -> "LatticeMatrixFreeKernel":
        """This operator with its stored near rows, built once, at
        construction, by kernel B3's build (ops/lattice_matvec.py
        lattice_near_build) and laid out by near_row_layout. As it is
        without a blend, and off the card, where no product reads them (as
        MatrixFreeKernel.with_near_rows)."""
        if not self.far_quad or self.near_cells is None or self.xd.device.type != "cuda":
            return self
        return dataclasses.replace(self, **near_row_layout(*lattice_near_build(self), self.xd.shape[0], lanes))

    @property
    def partial_nbytes(self) -> int:
        """Bytes of the float64 partial sums one product of kernel B3
        allocates on the card (the larger of its matvec's and its
        rmatvec's), beside nbytes, which the operator holds between
        products."""
        return max(lattice_partial_bytes(self))

    def _physics(self):
        return (self.problem, self.data_type, self.magv, self.intensity, self.nmc, self.ndc)

    def _base_rows(self, xs, ys, zs):
        """(B, nz, ny, nx, nmc, ndc): the 2^3 quadrature when far_quad (every
        cell; accurate beyond the tier-2 window), else the closed forms."""
        if self.far_quad:
            return _lattice_quad_rows(self.xe, self.ye, self.ze, xs, ys, zs, *self._physics(), order=2)
        return _lattice_closed_rows(self.xe, self.ye, self.ze, xs, ys, zs, *self._physics())

    def _window_index(self, i0):
        """Per-axis cell indices (iz (B, wz), iy (B, wy), ix (B, wx)) of each
        point's window."""
        dev = i0.device
        return tuple(i0[:, a, None] + torch.arange(w, device=dev) for a, w in enumerate(self.win))

    def _corr_window(self, xs, ys, zs, i0):
        """(B, wz, wy, wx, nmc, ndc) tiered correction rows on each point's
        window: where(near, closed, quad3) - quad2, so that the blended
        operator evaluates the closed forms within FAR_QUAD_RADIUS, the
        27-point rule from there to the window's edge, and the 8-point rule
        beyond (every cell outside the window is at least the tier-2 radius
        away along some axis). The closed forms are evaluated in float64
        (_in_float64)."""
        dev = i0.device
        iz, iy, ix = (i0[:, a, None] + torch.arange(w + 1, device=dev) for a, w in enumerate(self.win))
        xe_w, ye_w, ze_w = self.xe[ix], self.ye[iy], self.ze[iz]
        args = (xs, ys, zs, *self._physics())
        edges64, *pts64 = _in_float64((xe_w, ye_w, ze_w), xs, ys, zs)
        closed = _lattice_closed_rows(*edges64, *pts64, *self._physics()).to(xs.dtype)
        quad3 = _lattice_quad_rows(xe_w, ye_w, ze_w, *args, order=3)
        quad2 = _lattice_quad_rows(xe_w, ye_w, ze_w, *args, order=2)
        near = _lattice_near_mask(xe_w, ye_w, ze_w, xs, ys, zs)
        return torch.where(near[..., None, None], closed, quad3) - quad2

    def _chunks(self):
        return [slice(s, s + self.chunk) for s in range(0, self.xd.shape[0], self.chunk)]

    def _partial_matvec(self, xw):
        """(nrows_padded, ndc) sum over the cells of rows x (cw x), before
        the row weights: the plain version of kernel B3's matvec
        (ops/lattice_matvec.py::lattice_matvec)."""
        y = xw.reshape(self.nmc, self.nz, self.ny, self.nx)
        out = []
        for sl in self._chunks():
            xs, ys, zs = self.xd[sl], self.yd[sl], self.zd[sl]
            d = torch.einsum("bzyxkd,kzyx->bd", self._base_rows(xs, ys, zs), y)
            if self.far_quad:
                i0 = self.wi0[sl]
                iz, iy, ix = self._window_index(i0)
                yw = y[:, iz[:, :, None, None], iy[:, None, :, None], ix[:, None, None, :]]  # (nmc, B, wz, wy, wx)
                d = d + torch.einsum("bzyxkd,kbzyx->bd", self._corr_window(xs, ys, zs, i0), yw)
            out.append(d)
        return torch.cat(out)

    def _partial_rmatvec(self, u_pad):
        """(nmc, N) sum over the observations of rows^T u, before cw: the
        plain version of kernel B3's rmatvec (lattice_rmatvec)."""
        g = torch.zeros((self.nmc, self.nz, self.ny, self.nx), dtype=u_pad.dtype, device=u_pad.device)
        for sl in self._chunks():
            xs, ys, zs, uc = self.xd[sl], self.yd[sl], self.zd[sl], u_pad[sl]
            g = g + torch.einsum("bd,bzyxkd->kzyx", uc, self._base_rows(xs, ys, zs))
            if self.far_quad:
                i0 = self.wi0[sl]
                iz, iy, ix = self._window_index(i0)
                contrib = torch.einsum("bzyxkd,bd->kbzyx", self._corr_window(xs, ys, zs, i0), uc)
                k = torch.arange(self.nmc, device=g.device)[:, None, None, None, None]
                flat = ((k * self.nz + iz[None, :, :, None, None]) * self.ny
                        + iy[None, :, None, :, None]) * self.nx + ix[None, :, None, None, :]
                _index_add_in_order(g.view(-1), flat.reshape(-1), contrib.reshape(-1))
        return g.reshape(self.nmc, self.N)

    def _near_pair_rows(self, b, n):
        """(P, nmc, ndc) rows of candidate pairs (observation b, flat cell
        n) as kernel B3's near pass evaluates them: each cell's closed forms
        from its own 8 corners in float64, rounded to the operator's type,
        where the window's near mask calls the pair near, else 0."""
        xs, ys, zs = self.xd[b], self.yd[b], self.zd[b]
        edges64, *pts64 = _in_float64(self._pair_edges(n), xs, ys, zs)
        closed = _lattice_closed_rows(*edges64, *pts64, *self._physics()).to(xs.dtype)[:, 0, 0, 0]
        return torch.where(self._near_pair_mask(b, n)[:, None, None], closed, torch.zeros_like(closed))

    def _pair_edges(self, n):
        """(x, y, z) edges (P, 2) of the flat cells n."""
        ix, iy, iz = n % self.nx, (n // self.nx) % self.ny, n // (self.nx * self.ny)
        return tuple(torch.stack((e[i], e[i + 1]), 1) for e, i in ((self.xe, ix), (self.ye, iy), (self.ze, iz)))

    def _near_pair_mask(self, b, n):
        """(P,) bool: which candidate pairs (observation b, flat cell n) the
        window's near mask calls near."""
        return _lattice_near_mask(*self._pair_edges(n), self.xd[b], self.yd[b], self.zd[b])[:, 0, 0, 0]

    def near_pairs(self) -> int:
        """The observation-cell pairs that the blend's near pass evaluates by
        the float64 closed forms: its stored near rows' on the card, else the
        near lists' candidates that the near mask calls near."""
        if self.near_rcell is not None:
            return int(self.near_rcell.shape[0])
        b, n = _csr_pairs(self.near_ptr, self.near_cells)
        return sum(int(self._near_pair_mask(b[s : s + PAIR_CHUNK], n[s : s + PAIR_CHUNK]).sum())
                   for s in range(0, b.shape[0], PAIR_CHUNK))

    def _near_pairs_plain(self):
        """(b, n, rows): the plain version of the stored near rows' build
        (ops/lattice_matvec.py::lattice_near_build): the candidates of the
        near lists that the near mask calls near, in increasing order of (b,
        n), and their _near_pair_rows."""
        b, n = _csr_pairs(self.near_ptr, self.near_cells)
        return _near_pairs_kept(b, n, self._near_pair_mask, self._near_pair_rows)

    def near_rows_plain(self) -> dict:
        """The stored near rows as their plain build gives them
        (near_row_layout of _near_pairs_plain, with this operator's lanes)."""
        return near_row_layout(*self._near_pairs_plain(), self.xd.shape[0], self.near_lanes)

    def _stored_near_matvec(self, xw):
        """(nrows_padded, ndc) float64: the near matvec over the stored rows
        (the plain version of lattice_near_matvec's kernel)."""
        return _stored_near_matvec(self, xw, self.ndc)

    def _stored_near_rmatvec(self, u_pad):
        """(nmc, N) float64: the near rmatvec over the stored rows (the plain
        version of lattice_near_rmatvec's kernel)."""
        return _stored_near_rmatvec(self, u_pad, self.N)

    def _near_matvec(self, xw):
        """(nrows_padded, ndc) float64: the blend's near pass of the matvec
        over each observation's candidates, each pair's row evaluated again
        (the plain version of ops/lattice_matvec.py::lattice_near_matvec)."""
        b, n = _csr_pairs(self.near_ptr, self.near_cells)
        return _near_sum((self.xd.shape[0], self.ndc), (b, n), _pair_rows(self._near_pair_rows, b, n),
                         _matvec_terms(xw, self.ndc), xw.device)

    def _near_rmatvec(self, u_pad):
        """(nmc, N) float64: the blend's near pass of the rmatvec over each
        cell's candidate observations (the plain version of
        lattice_near_rmatvec)."""
        n, b = _csr_pairs(self.near_tptr, self.near_obs)
        return _near_sum((self.nmc, self.N), (b, n), _pair_rows(self._near_pair_rows, b, n),
                         _rmatvec_terms(u_pad, self.N), u_pad.device)

    def _main_rows(self, xs, ys, zs, i0):
        """(B, nz, ny, nx, nmc, ndc) rows of kernel B3's main loop: the
        8-point rule, on each point's window the 27-point rule, zero where
        near."""
        rows = _lattice_quad_rows(self.xe, self.ye, self.ze, xs, ys, zs, *self._physics(), order=2)
        iz, iy, ix = self._window_index(i0)
        ez, ey, ex = (torch.cat((i, i[:, -1:] + 1), 1) for i in (iz, iy, ix))
        xe_w, ye_w, ze_w = self.xe[ex], self.ye[ey], self.ze[ez]
        quad3 = _lattice_quad_rows(xe_w, ye_w, ze_w, xs, ys, zs, *self._physics(), order=3)
        near = _lattice_near_mask(xe_w, ye_w, ze_w, xs, ys, zs)
        b = torch.arange(xs.shape[0], device=xs.device)[:, None, None, None]
        rows[b, iz[:, :, None, None], iy[:, None, :, None], ix[:, None, None, :]] = torch.where(
            near[..., None, None], torch.zeros_like(quad3), quad3)
        return rows

    def _split_matvec(self, xw):
        """(nrows_padded, ndc) rows x xw as kernel B3 splits the blend: its
        main loop plus its near pass, summed in float64 and rounded once (the
        plain version of lattice_matvec's split; _partial_matvec, the chunk
        loop, adds the window's correction to float32 rows)."""
        y = xw.reshape(self.nmc, self.nz, self.ny, self.nx).double()
        d = torch.cat([torch.einsum("bzyxkd,kzyx->bd", self._main_rows(self.xd[sl], self.yd[sl], self.zd[sl],
                                                                       self.wi0[sl]).double(), y)
                       for sl in self._chunks()])
        return (d + self._near_matvec(xw)).to(xw.dtype)

    def _split_rmatvec(self, u_pad):
        """(nmc, N) rows^T u as kernel B3 splits the blend (_split_matvec)."""
        u64 = u_pad.double()
        g = self._near_rmatvec(u_pad).reshape(self.nmc, self.nz, self.ny, self.nx)
        for sl in self._chunks():
            rows = self._main_rows(self.xd[sl], self.yd[sl], self.zd[sl], self.wi0[sl]).double()
            g = g + torch.einsum("bd,bzyxkd->kzyx", u64[sl], rows)
        return g.reshape(self.nmc, self.N).to(u_pad.dtype)

    def _padded_residual(self, u):
        u_pad = torch.zeros((self.xd.shape[0], self.ndc), dtype=u.dtype, device=u.device)
        u_pad[: self.nrows] = u.reshape(self.nrows, self.ndc)
        return u_pad * self.row_w

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        d = lattice_matvec(self, self.cw[None, :] * x.reshape(self.nmc, self.N))
        return (self.row_w * d)[: self.nrows].reshape(-1)

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        return (self.cw[None, :] * lattice_rmatvec(self, self._padded_residual(u))).reshape(-1)


def _far_points(xe, ye, ze):
    """A point far outside a lattice (or grid) whose closed forms are finite
    for every cell: where padding observations are parked."""
    return float(np.max(xe)) + 1.0e6, float(np.max(ye)) + 1.0e6, float(np.min(ze)) - 1.0e6


@dataclass
class ShardedLatticeMatrixFreeKernel:
    """A LatticeMatrixFreeKernel cut over the observations: the observations
    are padded to a multiple of chunk x n (padding parked far outside the
    lattice, row weight 0) and slot s holds the block [s*P, (s+1)*P) with
    the whole lattice and column weight. matvec concatenates the slots'
    data on the home device; rmatvec adds their gradients there in slot
    order. This is the reference's data-row split of the forward
    (sensitivity_gravmag.F90:179-189) with its summed adjoint
    (lsqr_solver2.F90:208-214)."""

    parts: list
    nrows: int
    ndc: int
    mesh: object  # parallel.mesh.Mesh

    @property
    def graph_capturable(self) -> bool:
        """Captured where every part sits on one card (capture_unit
        refuses a mesh of several cards on its own)."""
        return len({p.cw.device for p in self.parts}) == 1 and all(p.graph_capturable for p in self.parts)

    @classmethod
    def shard(cls, k: LatticeMatrixFreeKernel, mesh) -> "ShardedLatticeMatrixFreeKernel":
        slots = mesh.slots
        n = len(slots)
        nd_pad = -(-k.nrows // (k.chunk * n)) * (k.chunk * n)
        per = nd_pad // n
        xe, ye, ze = (a.cpu().double().numpy() for a in (k.xe, k.ye, k.ze))
        far = _far_points(xe, ye, ze)

        def repad(a, fill):
            out = np.full(nd_pad, fill)
            out[: k.nrows] = a[: k.nrows].cpu().double().numpy()
            return out

        xd, yd, zd = repad(k.xd, far[0]), repad(k.yd, far[1]), repad(k.zd, far[2])
        rw = torch.zeros((nd_pad, k.ndc), dtype=k.row_w.dtype, device=k.row_w.device)
        rw[: k.nrows] = k.row_w[: k.nrows]
        win = wi0 = None
        if k.far_quad:
            # The windows of the re-padded observations at the tier-2 radius
            # of the factory: the near radius here would collapse the
            # middle tier on meshed runs (the JAX package's round-5 fault).
            win, wi0 = lattice_near_window(xe, ye, ze, xd, yd, zd, radius=tier2_radius(k.problem, k.data_type))
        dt = k.xd.dtype
        parts = []
        for s, dev in enumerate(slots):
            sl = slice(s * per, (s + 1) * per)

            def put(a):
                return torch.as_tensor(a[sl], dtype=dt, device=dev)

            part = dict(xe=k.xe.to(dev), ye=k.ye.to(dev), ze=k.ze.to(dev), xd=put(xd), yd=put(yd), zd=put(zd))
            if k.far_quad:
                # Each part's near lists (and rows) from its own observations
                # and windows.
                part["wi0"] = torch.as_tensor(wi0[sl], dtype=torch.int32, device=dev)
                part.update(lattice_near_lists(*(part[f] for f in ("xe", "ye", "ze", "xd", "yd", "zd")), win,
                                               part["wi0"]))
            part = dataclasses.replace(k, cw=k.cw.to(dev), row_w=rw[sl].to(dev), nrows=per, win=win, **part,
                                       **dict.fromkeys(NEAR_ROW_FIELDS))
            # Each part's stored near rows, with the whole operator's lanes.
            parts.append(part.with_near_rows(k.near_lanes))
        return cls(parts, k.nrows, k.ndc, mesh)

    @property
    def ncols(self) -> int:
        return self.parts[0].ncols

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        home = self.mesh.home
        d = torch.cat([p.matvec(x.to(p.cw.device)).to(home) for p in self.parts])
        return d[: self.nrows * self.ndc]

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        home = self.mesh.home
        per = self.parts[0].nrows
        u_pad = torch.zeros((per * len(self.parts), self.ndc), dtype=u.dtype, device=home)
        u_pad[: self.nrows] = u.reshape(self.nrows, self.ndc)
        g = None
        for s, p in enumerate(self.parts):
            part = p.rmatvec(u_pad[s * per : (s + 1) * per].reshape(-1).to(p.cw.device)).to(home)
            g = part if g is None else g + part
        return g

    def slot_bytes(self) -> list:
        return [p.nbytes for p in self.parts]


# =============================================================================
# The factory
# =============================================================================


def make_matrixfree_kernel(
    par, grid, data, column_weight, problem_weight, data_weight, dtype=torch.float32,
    chunk=None, pad_cells_to: int = 1, validate: bool = True,
    force_generic: bool = False, force_no_fft: bool = False, device="cuda",
):
    """Build the operator from the problem description (no kernel storage)
    on `device`.

    The fastest operator that applies wins: the FFT/BTTB operator
    (ops/bttb.py; a lattice grid with uniform x/y spacing and observations
    on a commensurate lattice at one height), then the corner-lattice
    operator on any tensor-product grid whose physics it covers, else the
    per-cell MatrixFreeKernel. force_no_fft skips the FFT operator,
    force_generic both fast ones (tests).

    pad_cells_to > 1 zero-pads the per-cell operator's cell axis to that
    multiple (dummy far prisms with cw = 0) so that it shards over a mesh of
    that size for any N (parallel/mesh.py::shard_kernel).

    validate=True runs one probe matvec at construction and aborts on
    non-finite output, as the stored build does on a boundary-coincident
    observation point (gravity_field.f90:99-107).

    In float32 the lattice and per-cell operators blend in the far-field
    quadrature (tpu.farFieldQuad, on by default) at every size: the JAX
    package turns the per-cell blend off above 2M cells off the CPU
    (GENERIC_BLEND_MAX_CELLS), for a TPU worker crash."""
    from tomofastx_tpu_torch.config.parfile import MagParams
    from tomofastx_tpu_torch.ops.sensitivity import observation_inside_grid

    if par.compression_type > 0:
        raise ValueError("matrix-free mode requires forward.matrixCompression.type = 0")
    device = torch.device(device)

    far_quad = bool(getattr(par, "far_field_quad", 1) and dtype == torch.float32)
    if isinstance(par, MagParams):
        phys = _Physics(
            problem="magn", data_type=1, nmc=par.nmodel_components, ndc=par.ndata_components,
            magv=prism.dircos(par.mi, par.md, par.theta), intensity=par.intensity,
            handle_inside=observation_inside_grid(grid, data), far_quad=far_quad,
        )
    else:
        phys = _Physics(
            problem="grav", data_type=par.data_type, nmc=1, ndc=par.ndata_components,
            magv=(0.0, 0.0, 1.0), intensity=0.0, handle_inside=False, far_quad=far_quad,
        )

    def probe(op):
        if validate:
            y = op.matvec(torch.ones((op.ncols,), dtype=dtype, device=device))
            if not bool(torch.isfinite(y).all()):
                raise ValueError(PROBE_ABORT)
        return op

    # The FFT/BTTB operator: exact physics (float64-built offset table) at
    # O(nz P log P) per product; it shards over z-layers, no cell padding.
    if not force_generic and not force_no_fft:
        from tomofastx_tpu_torch.ops.bttb import detect_bttb, make_bttb_kernel

        geom = detect_bttb(grid, data, nmc=phys.nmc, ndc=phys.ndc)
        if geom is not None:
            return make_bttb_kernel(phys, geom, grid, column_weight, problem_weight, data_weight, dtype,
                                    device=device)

    N = grid.nelements_total
    nd = par.ndata
    if chunk is None:
        # The JAX package's rule, sized on a TPU v5e (its chunk sweep
        # measured 128 fastest there); kept for parity.
        chunk = max(8, min(128, (1 << 26) // max(N * phys.nmc * phys.ndc, 1)))
    nd_pad = -(-nd // chunk) * chunk
    # Padding rows must evaluate to finite numbers (a corner-touching point
    # yields log(0), and 0 * nan = nan): park them far outside the volume.
    far = (float(np.max(grid.X2)) + 1.0e6, float(np.max(grid.Y2)) + 1.0e6, float(np.min(grid.Z1)) - 1.0e6)

    def pad(a, fill):
        out = np.full(nd_pad, fill)
        out[:nd] = a
        return out

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    row_w = np.zeros((nd_pad, phys.ndc))
    row_w[:nd] = problem_weight * np.asarray(data_weight).reshape(nd, phys.ndc)
    xd_p, yd_p, zd_p = pad(data.X, far[0]), pad(data.Y, far[1]), pad(data.Z, far[2])

    # The corner-lattice operator: g_z and FTG, and every magnetic
    # combination but the borehole branch, which is per-cell. It needs no
    # cell padding under a mesh: it shards over the observations.
    lattice_ok = not force_generic and (
        (phys.problem == "grav" and phys.nmc == 1) or (phys.problem == "magn" and not phys.handle_inside)
    )
    if lattice_ok:
        lat = detect_lattice(grid)
        if lat is not None:
            xe, ye, ze = lat
            geometry = dict(xe=t(xe), ye=t(ye), ze=t(ze), xd=t(xd_p), yd=t(yd_p), zd=t(zd_p))
            if phys.far_quad:
                # The window reaches the tier-2 radius, where the cheap 2^3
                # rule becomes accurate; the near lists are built on it.
                win, wi0 = lattice_near_window(
                    xe, ye, ze, xd_p, yd_p, zd_p, radius=tier2_radius(phys.problem, phys.data_type)
                )
                geometry.update(win=win, wi0=t(wi0, torch.int32))
                geometry.update(lattice_near_lists(*(geometry[f] for f in ("xe", "ye", "ze", "xd", "yd", "zd")), win,
                                                   geometry["wi0"]))
            op = LatticeMatrixFreeKernel(
                cw=t(column_weight), row_w=t(row_w), chunk=chunk, nrows=nd,
                nx=grid.nx, ny=grid.ny, nz=grid.nz, problem=phys.problem, magv=phys.magv,
                intensity=phys.intensity, nmc=phys.nmc, ndc=phys.ndc, data_type=phys.data_type,
                far_quad=phys.far_quad, **geometry,
            ).with_near_rows()
            if phys.far_quad:
                # The observation-cell pairs of the blend's tiers: those the
                # near pass evaluates by the float64 closed forms, and the
                # windows' others, at the 27-point rule. Padding rows lie far
                # from every cell.
                near = op.near_pairs()
                count("operator_near_pairs", near)
                count("operator_window_pairs", nd * win[0] * win[1] * win[2] - near)
            return probe(op)

    # Cell padding: dummy unit prisms far outside the model volume (finite
    # closed forms for every real observation point) with cw = 0.
    N_pad = -(-N // pad_cells_to) * pad_cells_to
    ncpad = N_pad - N

    def pad_cells(a, base):
        out = np.empty(N_pad)
        out[:N] = a
        out[N:] = base + 10.0 * np.arange(ncpad)  # spread along x: no two coincide
        return t(out)

    fx = float(np.max(grid.X2)) + 2.0e6
    fy = float(np.max(grid.Y2)) + 2.0e6
    fz = float(np.max(grid.Z2)) + 2.0e6
    grid6 = (
        pad_cells(grid.X1, fx), pad_cells(grid.X2, fx + 1.0),
        pad_cells(grid.Y1, fy), pad_cells(grid.Y2, fy + 1.0),
        pad_cells(grid.Z1, fz), pad_cells(grid.Z2, fz + 1.0),
    )
    cw_pad = np.zeros(N_pad)
    cw_pad[:N] = np.asarray(column_weight)
    xd_t, yd_t, zd_t = t(xd_p), t(yd_p), t(zd_p)
    near = {}
    if phys.far_quad:
        # Built once, in int32: kernel B2's build of the near rows reads them
        # as they are.
        near["near_idx"] = near_cell_indices(grid6, xd_t, yd_t, zd_t).to(torch.int32)
        near["near_tptr"], near["near_obs"] = near_idx_transpose(near["near_idx"], 0, N_pad)
    return probe(MatrixFreeKernel(
        grid6=grid6, xd=xd_t, yd=yd_t, zd=zd_t, cw=t(cw_pad), row_w=t(row_w), phys=phys,
        chunk=chunk, nrows=nd, N_true=N, **near,
    ).with_near_rows())
