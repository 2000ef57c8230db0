"""Corner-lattice closed-form sensitivity rows on tensor-product grids.

This part of the port holds what the stored-kernel build needs from the
matrix-free module: lattice detection, the 2x2x2 corner difference and the
closed-form rows of every forward family (gravity g_z, FTG Gzz and the full
tensor, magnetic TMI or three-component data on susceptibility or the
magnetization vector). The matrix-free operators themselves are not ported
yet.
"""

from __future__ import annotations

import numpy as np
import torch

from tomofastx_tpu_torch.ops.prism import (
    G_GRAV,
    combine_mag_tensor,
    ftg_corner_potentials,
    gz_corner_potential,
    mag_corner_potentials,
)


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
    Each lattice corner's antiderivative is evaluated once and shared by up
    to 8 cells (~8x fewer transcendentals than the per-cell 8-corner sums
    the reference loops, gravity_field.f90:131-195,
    magnetic_field.f90:321-457)."""
    cx = (x[:, None] - xe[None, :])[:, None, None, :]
    cy = (y[:, None] - ye[None, :])[:, None, :, None]
    cz = (z[:, None] - ze[None, :])[:, :, None, None]

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
