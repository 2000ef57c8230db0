"""Stored sensitivity operators: the dense kernel and the packed top-k
layout (hybrid row pack + heavy/light column packs).

The wavelet-compressed kernel keeps ~rate*N coefficients per row
(sensitivity_gravmag.F90:237-272). The dense representation stores the
zeros too. The packed layout stores the kept entries in a structured form
instead of the reference's CSR (sparse_matrix.f90):

- ``S @ x``: fixed-width row packing (nrows, K) value/index planes; the
  product is a vector gather and a reduction.
- ``S^T @ u``: the column-population histogram of a wavelet kernel is
  heavy-tailed — coarse-scale coefficients are kept by nearly every row
  (that histogram is exactly the reference's per-cell nnz load-balancing
  input, sensitivity_gravmag.F90:378-392). A fixed-width column packing
  would degenerate to dense. So columns are split: *heavy* columns
  (population > cap) form a small dense block handled by a transposed
  matrix-vector product; *light* columns are packed fixed-width and handled
  by a second gather. Both adjoint paths write every output once.

Both operators are plain tensor operations here, as they are outside any
hand-written kernel in the JAX package (the dense pair is ``torch.mv``),
except the dense pair on a bfloat16 kernel (tpu.kernelStoreDtype =
bfloat16), which goes through the hand-written kernels of ops/bf16_gemv.py.
Their forms cut over the slots of a mesh (ShardedDenseKernel,
ShardedPackedKernel) and the padding helpers serve parallel/mesh.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from tomofastx_tpu_torch.ops.bf16_gemv import bf16_matvec, bf16_rmatvec


@dataclass
class PackedKernel:
    """Hybrid packed sparse matrix (nrows x ncols). Values are stored
    float32 and promoted to the vector's type in each product."""

    # Row layout: all entries.
    row_vals: torch.Tensor  # (nrows, K)
    row_idx: torch.Tensor  # (nrows, K) int32; padding points at column 0 with val 0
    # Adjoint layout.
    dense_cols: torch.Tensor  # (n_dense,) int32 column ids
    dense_block: torch.Tensor  # (nrows, n_dense) dense values of heavy columns
    light_cols: torch.Tensor  # (n_light,) int32 column ids
    light_vals: torch.Tensor  # (n_light, KT)
    light_idx: torch.Tensor  # (n_light, KT) int32 row ids; padding -> row 0, val 0
    nrows: int
    ncols: int

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("rk,rk->r", self.row_vals.to(x.dtype), x[self.row_idx])

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        # Heavy/light column partitions are disjoint by construction, so
        # add == set on the zero-initialized gradient; add keeps padding
        # entries (column 0, value 0) harmless.
        g = torch.zeros((self.ncols,), dtype=u.dtype, device=u.device)
        if self.dense_block.shape[1]:
            g.index_add_(0, self.dense_cols, torch.mv(self.dense_block.to(u.dtype).T, u))
        if self.light_vals.shape[0]:
            contrib = torch.einsum("ck,ck->c", self.light_vals.to(u.dtype), u[self.light_idx])
            g.index_add_(0, self.light_cols, contrib)
        return g

    @property
    def nbytes(self) -> int:
        return sum(
            a.numel() * a.element_size()
            for a in (self.row_vals, self.row_idx, self.dense_block, self.light_vals, self.light_idx)
        )


def _pad_to(n: int, multiple: int) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def heavy_light_split(col_counts: torch.Tensor, nnz: int, ncols: int, col_cap_factor: float):
    """Column ids of the heavy columns (population above col_cap_factor
    times the mean) and of the light ones (the rest that hold anything).
    col_counts: (ncols,) integer tensor."""
    mean_pop = max(nnz / max(ncols, 1), 1.0)
    # Counts are integers, so "count > cap" is "count > floor(cap)": compared
    # as integers, whatever the tensor library would promote a float cap to.
    cap = math.floor(col_cap_factor * mean_pop)
    heavy = torch.nonzero(col_counts > cap)[:, 0]
    light = torch.nonzero((col_counts <= cap) & (col_counts > 0))[:, 0]
    return heavy, light


def pack_dense(
    S,
    pad_multiple: int = 8,
    dtype=torch.float32,
    col_cap_factor: float = 4.0,
    device="cuda",
) -> PackedKernel:
    """Pack a dense (nrows, ncols) matrix with structured zeros, with tensor
    operations on `device`.

    Heavy columns (population > col_cap_factor * mean) go to the dense
    block; the rest are packed fixed-width."""
    S = torch.as_tensor(S, device=device)
    nrows, ncols = S.shape
    mask = S != 0.0
    nnz = int(mask.sum())

    # ---- row packing: one nonzero scan over the whole matrix, positions
    # within each row by cumulative offsets ----
    row_counts = mask.sum(dim=1)
    K = _pad_to(int(row_counts.max()) if nrows else 1, pad_multiple)
    row_vals = torch.zeros((nrows, K), dtype=dtype, device=S.device)
    row_idx = torch.zeros((nrows, K), dtype=torch.int32, device=S.device)
    rr, cc = torch.nonzero(mask, as_tuple=True)  # row-major: rows grouped, cols ascending
    starts = torch.cumsum(row_counts, 0) - row_counts
    pos = torch.arange(rr.shape[0], device=S.device) - starts[rr]
    row_vals[rr, pos] = S[rr, cc].to(dtype)
    row_idx[rr, pos] = cc.to(torch.int32)

    # ---- adjoint layout ----
    col_counts = mask.sum(dim=0)
    heavy, light = heavy_light_split(col_counts, nnz, ncols, col_cap_factor)
    dense_block = S[:, heavy].to(dtype).contiguous()

    countsL = col_counts[light]
    KT = _pad_to(int(countsL.max()) if light.numel() else 1, pad_multiple)
    light_vals = torch.zeros((light.numel(), KT), dtype=dtype, device=S.device)
    light_idx = torch.zeros((light.numel(), KT), dtype=torch.int32, device=S.device)
    # Column-major walk over the light submatrix: per light column, rows ascending.
    rrL, ccL = torch.nonzero(mask[:, light].T, as_tuple=True)
    startsL = torch.cumsum(countsL, 0) - countsL
    posL = torch.arange(rrL.shape[0], device=S.device) - startsL[rrL]
    light_vals[rrL, posL] = S[ccL, light[rrL]].to(dtype)
    light_idx[rrL, posL] = ccL.to(torch.int32)

    return PackedKernel(
        row_vals=row_vals,
        row_idx=row_idx,
        dense_cols=heavy.to(torch.int32),
        dense_block=dense_block,
        light_cols=light.to(torch.int32),
        light_vals=light_vals,
        light_idx=light_idx,
        nrows=nrows,
        ncols=ncols,
    )


def _mv(S, x):
    """S x: torch.mv, or the bfloat16 kernel on a bfloat16 S (float32 or
    float64 sums; the float32 matrix never exists)."""
    return bf16_matvec(S, x) if S.dtype == torch.bfloat16 else torch.mv(S, x)


def _rmv(S, ST, u):
    """S^T u from S, or from its contiguous transpose ST where one is held
    (never for a bfloat16 S: its kernel reads the row-major S)."""
    if S.dtype == torch.bfloat16:
        return bf16_rmatvec(S, u)
    return torch.mv(ST if ST is not None else S.T, u)


@dataclass
class DenseKernel:
    """Dense counterpart with the same operator interface. S is held in the
    type of the vectors it meets (the workflow casts it once), or in
    bfloat16, whose products sum in the vectors' type (ops/bf16_gemv.py).

    ST: optional contiguous transpose. On the CPU the strided S.T @ u
    product is much slower than a contiguous one, so the workflow
    materializes ST for CPU tensors; on a CUDA device the library's
    transposed product reads S as it lies and ST would only double the
    kernel's memory.

    ncols_true: when set and smaller than S.shape[1], the trailing columns
    of S are zero padding; matvec pads x, rmatvec slices the gradient back.

    nrows_true: same for the row (observation) axis; matvec slices the
    output back, rmatvec pads u."""

    S: torch.Tensor  # (nrows_padded, ncols_padded)
    ST: torch.Tensor = None  # optional (ncols_padded, nrows_padded) transpose
    ncols_true: int = None  # logical column count; None = no padding
    nrows_true: int = None  # logical row count; None = no padding

    def matvec(self, x):
        npad = self.S.shape[1] - x.shape[0]
        if npad:
            x = torch.nn.functional.pad(x, (0, npad))
        d = _mv(self.S, x)
        if self.nrows_true is not None and d.shape[0] != self.nrows_true:
            d = d[: self.nrows_true]
        return d

    def rmatvec(self, u):
        npad = self.S.shape[0] - u.shape[0]
        if npad:
            u = torch.nn.functional.pad(u, (0, npad))
        g = _rmv(self.S, self.ST, u)
        if self.ncols_true is not None and g.shape[0] != self.ncols_true:
            g = g[: self.ncols_true]
        return g

    @property
    def nrows(self):
        return self.nrows_true if self.nrows_true is not None else self.S.shape[0]

    @property
    def ncols(self):
        return self.ncols_true if self.ncols_true is not None else self.S.shape[1]

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in (self.S, self.ST) if a is not None)


def apply_row_weights_packed(pk: PackedKernel, wrow) -> PackedKernel:
    """Bake per-row weights (problem_weight * data_weight) into a packed
    kernel, in storage precision — the packed counterpart of
    sensitivity.apply_row_weights (reference: sensitivity_gravmag.F90:836-843).
    wrow: (nrows,). The packs are scaled in place, so `pk` must not be used
    afterwards; the returned kernel shares its storage."""
    w = torch.as_tensor(np.asarray(wrow).reshape(-1), device=pk.row_vals.device).to(pk.row_vals.dtype)
    if w.shape[0] != pk.nrows:
        raise ValueError(f"{w.shape[0]} row weights for {pk.nrows} rows")
    return PackedKernel(
        row_vals=pk.row_vals.mul_(w[:, None]),
        row_idx=pk.row_idx,
        dense_cols=pk.dense_cols,
        dense_block=pk.dense_block.mul_(w[:, None]),
        light_cols=pk.light_cols,
        light_vals=pk.light_vals.mul_(w[pk.light_idx]),
        light_idx=pk.light_idx,
        nrows=pk.nrows,
        ncols=pk.ncols,
    )


# =============================================================================
# Mesh placement (parallel/mesh.py::shard_kernel): padding helpers with the
# JAX package's conventions and the sharded operators.
# =============================================================================


def pad_axis(a: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    """Zero-pad one axis of a to a multiple; a itself when it divides."""
    pad = (-a.shape[axis]) % multiple
    if pad == 0:
        return a
    shape = list(a.shape)
    shape[axis] = pad
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def pad_packed_for_mesh(pk: PackedKernel, n: int) -> PackedKernel:
    """Pad every sharded axis of a PackedKernel to a multiple of n: the row
    pack's slot axis, the heavy block's columns and the light pack's leading
    axis. Padding points at index 0 with value 0, which the add-based
    products treat as no-ops. Returns pk itself when all axes divide."""
    K, nd, nl = pk.row_vals.shape[1], pk.dense_block.shape[1], pk.light_vals.shape[0]
    if K % n == 0 and nd % n == 0 and nl % n == 0:
        return pk
    return PackedKernel(
        row_vals=pad_axis(pk.row_vals, 1, n),
        row_idx=pad_axis(pk.row_idx, 1, n),
        dense_cols=pad_axis(pk.dense_cols, 0, n),
        dense_block=pad_axis(pk.dense_block, 1, n),
        light_cols=pad_axis(pk.light_cols, 0, n),
        light_vals=pad_axis(pk.light_vals, 0, n),
        light_idx=pad_axis(pk.light_idx, 0, n),
        nrows=pk.nrows,
        ncols=pk.ncols,
    )


def pad_dense_columns(dk: DenseKernel, multiple: int) -> DenseKernel:
    """Zero-pad the column axis of a DenseKernel (and of its transpose) to
    the next multiple. Returns dk itself when it divides already."""
    if dk.S.shape[1] % multiple == 0:
        return dk
    S = pad_axis(dk.S, 1, multiple)
    ST = pad_axis(dk.ST, 0, multiple) if dk.ST is not None else None
    return DenseKernel(S, ST, dk.ncols, dk.nrows_true)


def pad_dense_rows(dk: DenseKernel, multiple: int) -> DenseKernel:
    """Zero-pad the row (observation) axis to the next multiple, for the obs
    axis of a 2-D mesh. Padding rows are zero, so they add nothing to S^T u,
    and their matvec outputs are cut off."""
    if dk.S.shape[0] % multiple == 0:
        return dk
    S = pad_axis(dk.S, 0, multiple)
    ST = pad_axis(dk.ST, 1, multiple) if dk.ST is not None else None
    return DenseKernel(S, ST, dk.ncols_true, dk.nrows)


def _place(a: torch.Tensor, device, own: bool) -> torch.Tensor:
    """a on `device`, contiguous; a copy of its own when `own` (so that the
    unsharded array can be freed) or when a is a strided view."""
    return a.to(device, copy=own).contiguous()


def _sum_in_order(parts):
    """Partial results added on the home device in slot order."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


@dataclass
class ShardedDenseKernel:
    """A DenseKernel cut into a grid of blocks: rows over the obs axis (one
    row of blocks on a 1-D mesh), columns over the cells axis; block (i, j)
    lies on grid[i, j], in the kernel's dtype (bfloat16 blocks take the
    bfloat16 kernels). matvec adds each row of blocks' partial products on
    the home device in slot order and concatenates the rows; rmatvec does
    the same with the transposed products."""

    blocks: list  # blocks[i][j]: (rows_i, cols_j)
    blocksT: list  # None, or contiguous transposes blocksT[i][j]: (cols_j, rows_i)
    nrows_true: int
    ncols_true: int
    mesh: object  # parallel.mesh.Mesh

    @classmethod
    def shard(cls, dk: DenseKernel, grid: np.ndarray, mesh) -> "ShardedDenseKernel":
        no, nc = grid.shape
        nrows, ncols = dk.nrows, dk.ncols
        dk = pad_dense_rows(pad_dense_columns(dk, nc), no)
        rb, cb = dk.S.shape[0] // no, dk.S.shape[1] // nc
        own = any(dev != dk.S.device for dev in grid.flat)
        blocks = [
            [_place(dk.S[i * rb : (i + 1) * rb, j * cb : (j + 1) * cb], grid[i, j], own) for j in range(nc)]
            for i in range(no)
        ]
        blocksT = None
        if dk.ST is not None:
            blocksT = [
                [_place(dk.ST[j * cb : (j + 1) * cb, i * rb : (i + 1) * rb], grid[i, j], own) for j in range(nc)]
                for i in range(no)
            ]
        return cls(blocks, blocksT, nrows, ncols, mesh)

    def matvec(self, x):
        home = self.mesh.home
        cb = self.blocks[0][0].shape[1]
        x = pad_axis(x, 0, cb * len(self.blocks[0]))
        rows = [
            _sum_in_order([
                _mv(S, x[j * cb : (j + 1) * cb].to(S.device)).to(home) for j, S in enumerate(row)
            ])
            for row in self.blocks
        ]
        return torch.cat(rows)[: self.nrows_true] if len(rows) > 1 else rows[0][: self.nrows_true]

    def rmatvec(self, u):
        home = self.mesh.home
        no, nc = len(self.blocks), len(self.blocks[0])
        rb = self.blocks[0][0].shape[0]
        u = pad_axis(u, 0, rb * no)
        cols = []
        for j in range(nc):
            parts = []
            for i in range(no):
                S = self.blocks[i][j]
                ui = u[i * rb : (i + 1) * rb].to(S.device)
                parts.append(_rmv(S, self.blocksT[i][j] if self.blocksT else None, ui).to(home))
            cols.append(_sum_in_order(parts))
        return torch.cat(cols)[: self.ncols_true] if nc > 1 else cols[0][: self.ncols_true]

    @property
    def nrows(self):
        return self.nrows_true

    @property
    def ncols(self):
        return self.ncols_true

    def slot_bytes(self) -> list:
        return [
            sum(a.numel() * a.element_size() for a in ([S] + ([self.blocksT[i][j]] if self.blocksT else [])))
            for i, row in enumerate(self.blocks) for j, S in enumerate(row)
        ]


@dataclass
class ShardedPackedKernel:
    """A PackedKernel cut into one part per slot: the row pack along its slot
    axis K (each slot holds a slice of every row's gather list, and matvec
    adds the slots' partial sums on the home device in slot order), the
    heavy block along its column axis and the light pack along its leading
    axis (rmatvec scatters each slot's column results into the home
    gradient; the column sets are disjoint, so no sum depends on the
    order)."""

    row_parts: list  # [(row_vals_k, row_idx_k)]
    heavy_parts: list  # [(dense_cols_k on home, dense_block_k)]
    light_parts: list  # [(light_cols_k on home, light_vals_k, light_idx_k)]
    nrows: int
    ncols: int
    mesh: object  # parallel.mesh.Mesh

    @classmethod
    def shard(cls, pk: PackedKernel, slots, mesh) -> "ShardedPackedKernel":
        n, home = len(slots), mesh.home
        pk = pad_packed_for_mesh(pk, n)
        own = any(dev != pk.row_vals.device for dev in slots)
        K, nd, nl = pk.row_vals.shape[1] // n, pk.dense_block.shape[1] // n, pk.light_vals.shape[0] // n

        def cut(k, dev):
            rk, hk, lk = slice(k * K, (k + 1) * K), slice(k * nd, (k + 1) * nd), slice(k * nl, (k + 1) * nl)
            return (
                (_place(pk.row_vals[:, rk], dev, own), _place(pk.row_idx[:, rk], dev, own)),
                (pk.dense_cols[hk].to(home), _place(pk.dense_block[:, hk], dev, own)),
                (pk.light_cols[lk].to(home), _place(pk.light_vals[lk], dev, own), _place(pk.light_idx[lk], dev, own)),
            )

        rows, heavy, light = zip(*(cut(k, dev) for k, dev in enumerate(slots)))
        return cls(list(rows), list(heavy), list(light), pk.nrows, pk.ncols, mesh)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        home = self.mesh.home
        return _sum_in_order([
            torch.einsum("rk,rk->r", vals.to(x.dtype), x.to(vals.device)[idx]).to(home)
            for vals, idx in self.row_parts
        ])

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        home = self.mesh.home
        g = torch.zeros((self.ncols,), dtype=u.dtype, device=home)
        for cols, block in self.heavy_parts:
            if block.shape[1]:
                g.index_add_(0, cols, torch.mv(block.to(u.dtype).T, u.to(block.device)).to(home))
        for cols, vals, idx in self.light_parts:
            if vals.shape[0]:
                contrib = torch.einsum("ck,ck->c", vals.to(u.dtype), u.to(vals.device)[idx])
                g.index_add_(0, cols, contrib.to(home))
        return g

    def slot_bytes(self) -> list:
        return [
            sum(a.numel() * a.element_size() for a in (*r, h[1], l[1], l[2]))
            for r, h, l in zip(self.row_parts, self.heavy_parts, self.light_parts)
        ]
