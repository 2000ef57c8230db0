"""What the coupling and bound constraints are for, measured on a final
model: plain NumPy from the constraints' definitions, written apart from
the program's and the reference's constraint blocks.

- `cross_gradient`: sum over cells of |grad m_grav x grad m_magn|^2, the
  structural coupling's residual;
- `damping_gradient.<problem>`: sum over cells of |grad m|^2, the roughness
  the damping gradient penalises;
- `clustering`: sum over cells of the squared distance, in standard
  deviations, of (m_grav, m_magn) to the nearest centre of the mixture;
- `admm.<problem>`: sum over cells of the squared distance of m to the
  nearest lithology interval of the ADMM bounds.

Gradients are central differences over the cell centres (one-sided at the
edges), the cells i fastest, then j, then k. A constraint a Parfile does not
switch on is left out.
"""

from __future__ import annotations

import numpy as np

NAMES = ("grav", "magn")


def cell_centres(edges):
    return tuple(0.5 * (np.asarray(e, np.float64)[1:] + np.asarray(e, np.float64)[:-1]) for e in edges)


def gradient(m, centres):
    """(d/dx, d/dy, d/dz) of the cell values m (N,) on the lattice."""
    xc, yc, zc = centres
    cube = np.asarray(m, np.float64).reshape(zc.size, yc.size, xc.size)
    dz, dy, dx = np.gradient(cube, zc, yc, xc)
    return dx, dy, dz


def cross_gradient(a, b, centres):
    ax, ay, az = gradient(a, centres)
    bx, by, bz = gradient(b, centres)
    tx, ty, tz = ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx
    return float(np.sum(tx * tx + ty * ty + tz * tz))


def damping_gradient(m, centres):
    return float(sum(np.sum(g * g) for g in gradient(m, centres)))


def clustering(a, b, mixture):
    """mixture: rows (weight, mu_grav, sigma_grav, mu_magn, sigma_magn, ...)."""
    t = np.asarray(mixture, np.float64)
    d = ((np.asarray(a)[:, None] - t[None, :, 1]) / t[None, :, 2]) ** 2 \
        + ((np.asarray(b)[:, None] - t[None, :, 3]) / t[None, :, 4]) ** 2
    return float(np.sum(np.min(d, axis=1)))


def bound_distance(m, lower, upper):
    """lower, upper: (nlithos,) the intervals' ends."""
    m = np.asarray(m, np.float64)[:, None]
    lo, hi = np.asarray(lower, np.float64)[None, :], np.asarray(upper, np.float64)[None, :]
    d = np.maximum(lo - m, 0.0) + np.maximum(m - hi, 0.0)
    return float(np.sum(np.min(d * d, axis=1)))


def costs(models, edges, switched, mixture=None, bounds=None):
    """Each switched-on constraint's cost of `models` (problem -> (N,)).

    switched: {"cross_gradient": bool, "damping_gradient": (problems),
    "clustering": bool, "admm": (problems)}; bounds: problem -> (lower,
    upper)."""
    centres = cell_centres(edges)
    out = {}
    if switched.get("cross_gradient"):
        out["cross_gradient"] = cross_gradient(models[0], models[1], centres)
    for i in switched.get("damping_gradient", ()):
        out[f"damping_gradient.{NAMES[i]}"] = damping_gradient(models[i], centres)
    if switched.get("clustering"):
        out["clustering"] = clustering(models[0], models[1], mixture)
    for i in switched.get("admm", ()):
        out[f"admm.{NAMES[i]}"] = bound_distance(models[i], *bounds[i])
    return out
