"""The benchmark's yardstick of the operators' work: the published peaks of
one H100 and the least time a product needs, counted from the inputs (the
survey and the lattice) and not from the kernels that do the work.

Frozen copies of `chip_smoke.py`'s bound arithmetic (`MEMORY_BYTES_PER_S`,
`MUFU_PER_S`, `b3_pairs`) and of the blended lattice operator's window
geometry that `b3_pairs` reads (ops/matrixfree.py `lattice_near_window`,
`tier2_radius`; ops/prism.py `far_mask` and its radii), as they were.
"""

from __future__ import annotations

import numpy as np

# Published peaks of one H100 SXM (NVIDIA's data sheet), at the card's full
# 700 W: HBM bandwidth, and the special function unit's reciprocal square
# roots (16 a clock an SM x 132 SMs x the 1.98 GHz boost clock).
MEMORY_BYTES_PER_S = 3.35e12
MUFU_PER_S = 132 * 16 * 1.98e9

# The float32 blend of the corner-lattice operator: a cell nearer than
# NEAR_RADIUS of its half-diagonals takes the float64 closed forms, one
# inside the tier-2 window (TIER2_RADIUS_GZ for g_z) the 27-point rule, and
# every other cell the 8-point rule.
NEAR_RADIUS = 4.0
TIER2_RADIUS_GZ = 12.0
RSQRT_WINDOW, RSQRT_FAR = 27, 8


def lattice_window(edges, points, radius=TIER2_RADIUS_GZ):
    """((wz, wy, wx), starts (npoints, 3)) of each point's tier-2 window."""
    xe, ye, ze = (np.asarray(e, np.float64) for e in edges)
    maxh2 = sum(np.max(0.5 * np.diff(e)) ** 2 for e in (xe, ye, ze))
    D = radius * np.sqrt(maxh2) * (1.0 + 1.0e-5)

    def axis(e, t):
        c = 0.5 * (e[:-1] + e[1:])
        n = len(c)
        W = int(np.max(np.searchsorted(c, c + 2.0 * D, side="right") - np.arange(n)))
        W = max(1, min(W, n))
        lo = np.searchsorted(c, np.asarray(t, np.float64) - D, side="left")
        return W, np.clip(lo, 0, n - W)

    wx, ix = axis(xe, points[0])
    wy, iy = axis(ye, points[1])
    wz, iz = axis(ze, points[2])
    return (wz, wy, wx), np.stack([iz, iy, ix], axis=1)


def lattice_pairs(edges, points, chunk=256):
    """(near, window, far) observation-cell pairs of the blended g_z lattice
    operator: the window's cells within NEAR_RADIUS half-diagonals, the
    window's others, and the cells outside the window."""
    xe, ye, ze = (np.asarray(e, np.float64) for e in edges)
    X, Y, Z = (np.asarray(a, np.float64) for a in points)
    (wz, wy, wx), start = lattice_window(edges, points)
    near = 0
    for s in range(0, X.size, chunk):
        sl = slice(s, s + chunk)

        def cells(e, a, w):
            idx = start[sl, a, None] + np.arange(w)
            return 0.5 * (e[idx] + e[idx + 1]), 0.5 * (e[idx + 1] - e[idx])

        cz, hz = cells(ze, 0, wz)
        cy, hy = cells(ye, 1, wy)
        cx, hx = cells(xe, 2, wx)
        r2 = ((cz - Z[sl, None]) ** 2)[:, :, None, None] + ((cy - Y[sl, None]) ** 2)[:, None, :, None] \
            + ((cx - X[sl, None]) ** 2)[:, None, None, :]
        d2 = (hz**2)[:, :, None, None] + (hy**2)[:, None, :, None] + (hx**2)[:, None, None, :]
        near += int(np.count_nonzero(r2 <= NEAR_RADIUS * NEAR_RADIUS * d2))
    ncells = (xe.size - 1) * (ye.size - 1) * (ze.size - 1)
    window = X.size * wz * wy * wx
    return near, window - near, X.size * ncells - window


def lattice_product_s(edges, points):
    """Least seconds of one product (matvec or rmatvec) of the blended g_z
    lattice operator: its quadrature points' reciprocal square roots on the
    special function unit (the near pairs' float64 closed forms, a few
    hundred thousand, are left out)."""
    _, window, far = lattice_pairs(edges, points)
    return (RSQRT_WINDOW * window + RSQRT_FAR * far) / MUFU_PER_S


def stored_product_s(nrows, ncols, itemsize=4):
    """Least seconds of one product of a stored (nrows, ncols) kernel: its
    bytes, x and y, each read or written once, at the HBM bandwidth."""
    return (nrows * ncols + nrows + ncols) * itemsize / MEMORY_BYTES_PER_S
