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
hand-written kernel in the JAX package (the dense pair is ``torch.mv``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


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
    device="cpu",
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


@dataclass
class DenseKernel:
    """Dense counterpart with the same operator interface. S is held in the
    type of the vectors it meets (the workflow casts it once).

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
        d = torch.mv(self.S, x)
        if self.nrows_true is not None and d.shape[0] != self.nrows_true:
            d = d[: self.nrows_true]
        return d

    def rmatvec(self, u):
        npad = self.S.shape[0] - u.shape[0]
        if npad:
            u = torch.nn.functional.pad(u, (0, npad))
        g = torch.mv(self.ST if self.ST is not None else self.S.T, u)
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
