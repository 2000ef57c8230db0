"""Closed-form rectangular-prism gravity kernels.

Counterparts of the reference's per-row scalar loops
(gravity_field.f90:41-364): every function here is vectorized over all
cells at once and broadcasts over a leading batch of observation points, so
a block of sensitivity rows is a handful of tensor operations.

Conventions (identical to the reference):
- coordinates in meters, X east, Y north, Z down (depth space);
- gravity output in m/s^2 per unit density (kg/m^3), G = 6.674e-11.

All math is done in the dtype of the inputs; the reference computes in
float64 and stores float32 (global_typedefs.F90:37-45).
"""

from __future__ import annotations

import math

import numpy as np
import torch

G_GRAV = 6.674e-11
TWO_PI = 2.0 * math.pi
# Corner index triples (K, L, M) in {0,1}^3; the sign of a corner is
# signo[K]*signo[L]*signo[M] with signo = (-1, +1) (gravity_field.f90:53).
_CORNERS = [(K, L, M) for K in (0, 1) for L in (0, 1) for M in (0, 1)]


def _wrap_atan2(y, x):
    """atan2 wrapped to [0, 2*pi) (reference: gravity_field.f90:81-93)."""
    a = torch.atan2(y, x)
    return torch.where(a < 0.0, a + TWO_PI, a)


def _log_R_plus(Rs, t, o2):
    """log(Rs + t), cancellation-armored for float32.

    For t < 0 and |t| ~ Rs (a far cell nearly aligned with the observation
    point along this axis), Rs + t loses all mantissa bits in float32. The
    identity Rs + t = (Rs^2 - t^2)/(Rs - t) = o2/(Rs - t) (o2 = sum of the
    other two squared coordinates) has no cancellation. The float64 path
    keeps the reference's literal formula (gravity_field.f90:110-117) for
    bit-parity."""
    if Rs.dtype != torch.float32:
        return torch.log(Rs + t)
    return torch.log(torch.where(t < 0.0, o2 / (Rs - t), Rs + t))


def _half_log_ratio(Rs, t, o2):
    """0.5 * log((Rs - t)/(Rs + t)), stable for both signs of t (float32);
    the float64 path keeps the reference's literal form
    (gravity_field.f90:268-271)."""
    if Rs.dtype != torch.float32:
        return 0.5 * torch.log((Rs - t) / (Rs + t))
    big = torch.where(t < 0.0, Rs - t, Rs + t)  # the non-cancelling side
    ratio = torch.where(t < 0.0, big * big / o2, o2 / (big * big))
    return 0.5 * torch.log(ratio)


def _log_ratio_pp(t_num, a_num, t_den, a_den, o2_num, o2_den):
    """log((t_num + a_num)/(t_den + a_den)) with a_i = sqrt(t_i^2 + o2_i),
    float32-armored via t + a = o2/(a - t) for t < 0 (see _log_R_plus); the
    float64 path keeps the reference's literal form
    (magnetic_field.f90:380-457)."""
    if a_num.dtype != torch.float32:
        return torch.log((t_num + a_num) / (t_den + a_den))

    def stab(t, a, o2):
        return torch.where(t < 0.0, o2 / (a - t), t + a)

    return torch.log(stab(t_num, a_num, o2_num) / stab(t_den, a_den, o2_den))


def _corner_coords(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2):
    """Relative corner coordinates XX[2], YY[2], ZZ[2] per cell."""
    XX = (xd - X1, xd - X2)
    YY = (yd - Y1, yd - Y2)
    ZZ = (zd - Z1, zd - Z2)
    return XX, YY, ZZ


def gravi_z(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2):
    """g_z of unit-density prisms (G included, as the reference stores
    G*gz): vectorized graviprism_z (gravity_field.f90:131-195).

    xd, yd, zd broadcast against the (ncells,) bounds: scalars give
    (ncells,), (B, 1) columns give (B, ncells)."""
    XX, YY, ZZ = _corner_coords(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2)
    gz = 0.0
    for K, L, M in _CORNERS:
        mu = (-1.0) ** (K + L + M + 1)
        x, y, z = XX[K], YY[L], ZZ[M]
        Rs = torch.sqrt(x * x + y * y + z * z)
        arg3 = _wrap_atan2(x * y, z * Rs)
        arg4 = _log_R_plus(Rs, x, y * y + z * z)
        arg5 = _log_R_plus(Rs, y, x * x + z * z)
        gz = gz + mu * (z * arg3 - x * arg5 - y * arg4)
    return G_GRAV * gz


def gz_corner_potential(x, y, z):
    """The per-corner antiderivative of the prism g_z closed form:
    f(x, y, z) = z*atan2(xy, zR) - x*log(R + y) - y*log(R + x), so that
    gz_cell = G * sum_{K,L,M} (-1)^(K+L+M+1) f(xd - Xe[i+K], ...) — the
    corner-lattice factorization of graviprism_z
    (gravity_field.f90:131-195). On a tensor-product grid each corner
    value is shared by up to 8 cells. Uses the same wrapped atan2 and
    armored logs as gravi_z, so the per-cell alternating sum of these
    values is gravi_z's."""
    Rs = torch.sqrt(x * x + y * y + z * z)
    arg3 = _wrap_atan2(x * y, z * Rs)
    arg4 = _log_R_plus(Rs, x, y * y + z * z)
    arg5 = _log_R_plus(Rs, y, x * x + z * z)
    return z * arg3 - x * arg5 - y * arg4


def validate_finite(name: str, arr):
    """Guard replacing the reference's in-loop aborts on boundary-touching
    observation points (gravity_field.f90:99-107). Takes a numpy array or
    a tensor; a tensor is reduced where it lies, so one flag crosses to
    the host."""
    if isinstance(arr, torch.Tensor):
        ok = bool(torch.isfinite(arr).all())
    else:
        ok = bool(np.all(np.isfinite(np.asarray(arr))))
    if not ok:
        raise FloatingPointError(
            f"Non-finite values in {name}: a data coordinate likely coincides with a "
            "model grid boundary. Adjust the model grid!"
        )
