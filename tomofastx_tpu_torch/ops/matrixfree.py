"""Corner-lattice closed-form sensitivity rows on tensor-product grids.

This slice of the port holds what the stored-kernel build needs from the
matrix-free module: lattice detection, the 2x2x2 corner difference and the
g_z closed-form rows. The matrix-free operators themselves are not ported
yet.
"""

from __future__ import annotations

import numpy as np

from tomofastx_tpu_torch.ops.prism import G_GRAV, gz_corner_potential


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


def _diff3(F):
    """D[F](i,j,k) = sum_{K,L,M} (-1)^(K+L+M) F[i+K,j+L,k+M] over the last
    three axes (per axis out[i] = F[i] - F[i+1]): corners -> cells, keeping
    the cancellation local to each cell's own 8 corner values."""
    g = F
    for ax in (-3, -2, -1):
        n = g.shape[ax]
        g = g.narrow(ax, 0, n - 1) - g.narrow(ax, 1, n - 1)
    return g


def _lattice_closed_rows(xe, ye, ze, x, y, z, problem, data_type):
    """Corner-difference closed-form g_z rows on a lattice, for a batch of
    observation points x, y, z of shape (B,): (B, nz, ny, nx). Each lattice
    corner's antiderivative is evaluated once and shared by up to 8 cells
    (~8x fewer transcendentals than the per-cell 8-corner sums the
    reference loops, gravity_field.f90:131-195)."""
    if problem != "grav" or data_type != 1:
        raise NotImplementedError(
            "only gravity g_z lattice rows are ported (magnetic and "
            "gradiometry rows are not yet)"
        )
    cx = (x[:, None] - xe[None, :])[:, None, None, :]
    cy = (y[:, None] - ye[None, :])[:, None, :, None]
    cz = (z[:, None] - ze[None, :])[:, :, None, None]
    return -G_GRAV * _diff3(gz_corner_potential(cx, cy, cz))
