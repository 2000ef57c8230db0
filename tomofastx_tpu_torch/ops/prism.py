"""Closed-form rectangular-prism field kernels (gravity, FTG, magnetics).

Counterparts of the reference's per-row scalar loops
(gravity_field.f90:41-364, magnetic_field.f90:321-457): every function here
is vectorized over all cells at once and broadcasts over a leading batch of
observation points, so a block of sensitivity rows is a handful of tensor
operations.

Conventions (identical to the reference):
- coordinates in meters, X east, Y north, Z down (depth space);
- gravity output in m/s^2 per unit density (kg/m^3), G = 6.674e-11;
- FTG tensor after Dubey & Tiwari (2015), Z sign flipped internally;
- magnetic tensor after Sharma (1966); susceptibility output scaled by
  ambient intensity (nT), magnetization-vector output scaled by mu0*1e9;
  both divided by 4*pi for SI (magnetic_field.f90:286-295).

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


def gravi_full(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2):
    """All three gravity components (gx, gy, gz) per cell: vectorized
    graviprism_full (gravity_field.f90:41-126)."""
    XX, YY, ZZ = _corner_coords(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2)
    gx = gy = gz = 0.0
    for K, L, M in _CORNERS:
        mu = (-1.0) ** (K + L + M + 1)
        x, y, z = XX[K], YY[L], ZZ[M]
        Rs = torch.sqrt(x * x + y * y + z * z)
        arg1 = _wrap_atan2(y * z, x * Rs)
        arg2 = _wrap_atan2(x * z, y * Rs)
        arg3 = _wrap_atan2(x * y, z * Rs)
        lg4 = _log_R_plus(Rs, x, y * y + z * z)
        lg5 = _log_R_plus(Rs, y, x * x + z * z)
        lg6 = _log_R_plus(Rs, z, x * x + y * y)
        gx = gx + mu * (x * arg1 - y * lg6 - z * lg5)
        gy = gy + mu * (y * arg2 - z * lg4 - x * lg6)
        gz = gz + mu * (z * arg3 - x * lg5 - y * lg4)
    return G_GRAV * gx, G_GRAV * gy, G_GRAV * gz


def _wrap_neg_atan2(y, x):
    """-atan2(y, x) wrapped to [0, 2*pi): the Gzz corner term
    (gravity_field.f90:341-346)."""
    v = -torch.atan2(y, x)
    return torch.where(v < 0.0, v + TWO_PI, v)


def gradi_zz(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2):
    """Gzz gravity-gradiometry component per cell: vectorized gradiprism_zz
    (gravity_field.f90:314-364). Note the internal Z sign flip
    (ZZ = -(zd - Z))."""
    XX = (xd - X1, xd - X2)
    YY = (yd - Y1, yd - Y2)
    ZZ = (-(zd - Z1), -(zd - Z2))
    gzz = 0.0
    for K, L, M in _CORNERS:
        mu = (-1.0) ** (K + L + M + 1)
        x, y, z = XX[K], YY[L], ZZ[M]
        Rs = torch.sqrt(x * x + y * y + z * z)
        gzz = gzz + mu * _wrap_neg_atan2(x * y, Rs * z)
    return G_GRAV * gzz


def gradi_full(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2):
    """Full FTG tensor (Gxx, Gyy, Gzz, Gxy, Gyz, Gzx) per cell: vectorized
    gradiprism_full (gravity_field.f90:207-309), after Dubey & Tiwari
    (2015). Component order matches the reference's data component order
    xx, yy, zz, xy, yz, xz (Parameters_all.txt:56)."""
    XX = (xd - X1, xd - X2)
    YY = (yd - Y1, yd - Y2)
    ZZ = (-(zd - Z1), -(zd - Z2))
    g = [0.0] * 6
    for K, L, M in _CORNERS:
        mu = (-1.0) ** (K + L + M + 1)
        p = ftg_corner_potentials(XX[K], YY[L], ZZ[M])
        # ftg_corner_potentials returns (xx, yy, zz, xy, yz, xz).
        g = [gc + mu * pc for gc, pc in zip(g, p)]
    return tuple(G_GRAV * gc for gc in g)


def dircos(incl: float, decl: float, azim: float):
    """Direction cosines from inclination/declination (degrees), with the
    X-axis azimuth convention of the reference (magnetic_field.f90:91-110):
    declination is first converted via mod(450 - decl, 360)."""
    d2r = math.pi / 180.0
    decl2 = math.fmod(450.0 - decl, 360.0)
    xi, xd, xa = incl * d2r, decl2 * d2r, azim * d2r
    a = math.cos(xi) * math.cos(xd - xa)
    b = math.cos(xi) * math.sin(xd - xa)
    c = math.sin(xi)
    return a, b, c


def sharmbox(x0, y0, z0, x1, x2, y1, y2, z1, z2):
    """Magnetic tensor of prisms at the observation points (Sharma 1966):
    vectorized sharmbox (magnetic_field.f90:321-457); the corner arguments
    are ordered (x1, x2, y1, y2, z1, z2) like every other kernel here.
    Returns (ts_x, ts_y, ts_z), each a tuple of 3 tensors (the tensor rows):
    ts_x = (txx, txy, txz), etc."""
    rx1 = x1 - x0
    rx2 = x2 - x0
    ry1 = y1 - y0
    ry2 = y2 - y0
    rz1 = z1 - z0
    rz2 = z2 - z0

    rx1s, rx2s = rx1 * rx1, rx2 * rx2
    ry1s, ry2s = ry1 * ry1, ry2 * ry2
    rz1s, rz2s = rz1 * rz1, rz2 * rz2

    R1 = ry2s + rx2s
    R2 = ry2s + rx1s
    R3 = ry1s + rx2s
    R4 = ry1s + rx1s
    a1 = torch.sqrt(rz2s + R2)
    a2 = torch.sqrt(rz2s + R1)
    a3 = torch.sqrt(rz1s + R1)
    a4 = torch.sqrt(rz1s + R2)
    a5 = torch.sqrt(rz2s + R3)
    a6 = torch.sqrt(rz2s + R4)
    a7 = torch.sqrt(rz1s + R4)
    a8 = torch.sqrt(rz1s + R3)

    atan2 = torch.atan2
    txx = (
        atan2(ry1 * rz2, rx2 * a5)
        - atan2(ry2 * rz2, rx2 * a2)
        + atan2(ry2 * rz1, rx2 * a3)
        - atan2(ry1 * rz1, rx2 * a8)
        + atan2(ry2 * rz2, rx1 * a1)
        - atan2(ry1 * rz2, rx1 * a6)
        + atan2(ry1 * rz1, rx1 * a7)
        - atan2(ry2 * rz1, rx1 * a4)
    )
    tyx = (
        _log_ratio_pp(rz2, a2, rz1, a3, R1, R1)
        - _log_ratio_pp(rz2, a1, rz1, a4, R2, R2)
        + _log_ratio_pp(rz2, a6, rz1, a7, R4, R4)
        - _log_ratio_pp(rz2, a5, rz1, a8, R3, R3)
    )
    tyy = (
        atan2(rx1 * rz2, ry2 * a1)
        - atan2(rx2 * rz2, ry2 * a2)
        + atan2(rx2 * rz1, ry2 * a3)
        - atan2(rx1 * rz1, ry2 * a4)
        + atan2(rx2 * rz2, ry1 * a5)
        - atan2(rx1 * rz2, ry1 * a6)
        + atan2(rx1 * rz1, ry1 * a7)
        - atan2(rx2 * rz1, ry1 * a8)
    )

    R1 = ry2s + rz1s
    R2 = ry2s + rz2s
    R3 = ry1s + rz1s
    R4 = ry1s + rz2s
    b1 = torch.sqrt(rx1s + R1)
    b2 = torch.sqrt(rx2s + R1)
    b3 = torch.sqrt(rx1s + R2)
    b4 = torch.sqrt(rx2s + R2)
    b5 = torch.sqrt(rx1s + R3)
    b6 = torch.sqrt(rx2s + R3)
    b7 = torch.sqrt(rx1s + R4)
    b8 = torch.sqrt(rx2s + R4)
    tyz = (
        _log_ratio_pp(rx1, b1, rx2, b2, R1, R1)
        - _log_ratio_pp(rx1, b3, rx2, b4, R2, R2)
        + _log_ratio_pp(rx1, b7, rx2, b8, R4, R4)
        - _log_ratio_pp(rx1, b5, rx2, b6, R3, R3)
    )

    R1 = rx2s + rz1s
    R2 = rx2s + rz2s
    R3 = rx1s + rz1s
    R4 = rx1s + rz2s
    c1 = torch.sqrt(ry1s + R1)
    c2 = torch.sqrt(ry2s + R1)
    c3 = torch.sqrt(ry1s + R2)
    c4 = torch.sqrt(ry2s + R2)
    c5 = torch.sqrt(ry1s + R3)
    c6 = torch.sqrt(ry2s + R3)
    c7 = torch.sqrt(ry1s + R4)
    c8 = torch.sqrt(ry2s + R4)
    txz = (
        _log_ratio_pp(ry1, c1, ry2, c2, R1, R1)
        - _log_ratio_pp(ry1, c3, ry2, c4, R2, R2)
        + _log_ratio_pp(ry1, c7, ry2, c8, R4, R4)
        - _log_ratio_pp(ry1, c5, ry2, c6, R3, R3)
    )

    tzz = -(txx + tyy)  # Gauss (trace-free)
    return (txx, tyx, txz), (tyx, tyy, tyz), (txz, tyz, tzz)


def mag_corner_potentials(rx, ry, rz):
    """Per-corner antiderivatives of the Sharma (1966) magnetic tensor:
    every 8-term sum in sharmbox (magnetic_field.f90:321-457) is an
    alternating corner sum of one of these five functions —

        txx =  D[f1],  f1 = atan2(ry*rz, rx*R)
        tyy =  D[f2],  f2 = atan2(rx*rz, ry*R)
        txy = -D[f3],  f3 = log(R + rz)
        tyz = -D[f4],  f4 = log(R + rx)
        txz = -D[f5],  f5 = log(R + ry)
        tzz = -(txx + tyy)

    with D = sum_{K,L,M} (-1)^(K+L+M) at the cell's 8 corners. The logs use
    the same float32-armored form as the per-cell kernels (the float64
    per-cell path takes the log of a ratio, equal up to ~1 ulp)."""
    R = torch.sqrt(rx * rx + ry * ry + rz * rz)
    f1 = torch.atan2(ry * rz, rx * R)
    f2 = torch.atan2(rx * rz, ry * R)
    f3 = _log_R_plus(R, rz, rx * rx + ry * ry)
    f4 = _log_R_plus(R, rx, ry * ry + rz * rz)
    f5 = _log_R_plus(R, ry, rx * rx + rz * rz)
    return f1, f2, f3, f4, f5


def ftg_corner_potentials(x, y, z):
    """Per-corner antiderivatives of the FTG tensor (Dubey & Tiwari 2015,
    gravity_field.f90:207-364), order (xx, yy, zz, xy, yz, xz):
    G_c = -D[p_c] with D = sum (-1)^(K+L+M) over the cell's corners.
    The caller passes the flipped z offset (ze - zd): the reference's
    gradiprism kernels negate ZZ internally."""
    Rs = torch.sqrt(x * x + y * y + z * z)
    p_xx = _wrap_atan2(x * y, x * x + Rs * z + z * z)
    p_yy = _wrap_atan2(x * y, Rs * Rs + Rs * z - x * x)
    p_zz = _wrap_neg_atan2(x * y, Rs * z)
    p_xy = _log_R_plus(Rs, z, x * x + y * y)
    p_yz = _half_log_ratio(Rs, x, y * y + z * z)
    p_xz = _half_log_ratio(Rs, y, x * x + z * z)
    return p_xx, p_yy, p_zz, p_xy, p_yz, p_xz


def combine_mag_tensor(tx, ty, tz, magv, intensity, nmodel_components: int, ndata_components: int):
    """Combine magnetic tensor rows into sensitivity entries: the
    susceptibility / magnetization-vector x TMI / 3-component dispatch and
    unit scaling of magnetic_field_magprism (magnetic_field.f90:118-297).
    tx/ty/tz: 3-tuples of tensors (any shape); returns
    (..., nmodel_components, ndata_components)."""
    mu0_T2nT = 4.0e-7 * math.pi * 1.0e9
    mv = magv

    if nmodel_components == 1:
        mx = tx[0] * mv[0] + tx[1] * mv[1] + tx[2] * mv[2]
        my = ty[0] * mv[0] + ty[1] * mv[1] + ty[2] * mv[2]
        mz = tz[0] * mv[0] + tz[1] * mv[1] + tz[2] * mv[2]
        if ndata_components == 1:
            cols = [[mx * mv[0] + my * mv[1] + mz * mv[2]]]
        elif ndata_components == 3:
            cols = [[mx, my, mz]]
        else:
            raise ValueError("Wrong number of data components in magprism_row!")
        scale = intensity
    elif nmodel_components == 3:
        if ndata_components == 1:
            cols = [[tx[k] * mv[0] + ty[k] * mv[1] + tz[k] * mv[2]] for k in range(3)]
        elif ndata_components == 3:
            cols = [[tx[k], ty[k], tz[k]] for k in range(3)]
        else:
            raise ValueError("Wrong number of data components in magprism_row!")
        scale = mu0_T2nT
    else:
        raise ValueError("Wrong number of model components in magprism_row!")

    out = torch.stack([torch.stack(kcols, dim=-1) for kcols in cols], dim=-2)
    return out * (scale / (4.0 * math.pi))


def _subprism_bounds(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2, width):
    """The 6 sub-prisms around a void of half-width `width` at an
    observation point inside a cell (reference:
    magnetic_field.f90:155-203). Returns a list of 6 bound tuples."""
    return [
        (X1, X2, Y1, Y2, Z1, zd - width),  # top
        (X1, X2, Y1, Y2, zd + width, Z2),  # bottom
        (X1, xd - width, Y1, Y2, zd - width, zd + width),  # west
        (xd + width, X2, Y1, Y2, zd - width, zd + width),  # east
        (xd - width, xd + width, Y1, yd - width, zd - width, zd + width),  # south
        (xd - width, xd + width, yd + width, Y2, zd - width, zd + width),  # north
    ]


def magnetic_tensor(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2, handle_inside: bool = False):
    """Magnetic tensor rows (tx, ty, tz) per cell, with the optional in-cell
    (borehole) observation handled by 6-subprism decomposition
    (reference: magnetic_field.f90:135-238)."""
    tx, ty, tz = sharmbox(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2)

    if handle_inside:
        inside = (X1 < xd) & (X2 > xd) & (Y1 < yd) & (Y2 > yd) & (Z1 < zd) & (Z2 > zd)
        min_clr = torch.minimum(
            torch.minimum(torch.abs(xd - X1), torch.abs(xd - X2)),
            torch.minimum(
                torch.minimum(torch.abs(yd - Y1), torch.abs(yd - Y2)),
                torch.minimum(torch.abs(zd - Z1), torch.abs(zd - Z2)),
            ),
        )
        width = torch.where(0.1 > min_clr, 0.5 * min_clr, 0.1)

        sub = [[0.0] * 3 for _ in range(3)]
        for b in _subprism_bounds(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2, width):
            for row, srow in zip(sub, sharmbox(xd, yd, zd, *b)):
                for c in range(3):
                    row[c] = row[c] + srow[c]

        tx, ty, tz = (
            tuple(torch.where(inside, s, t) for s, t in zip(srow, trow))
            for srow, trow in zip(sub, (tx, ty, tz))
        )

    return tx, ty, tz


def magprism_row(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2, magv, intensity,
                 nmodel_components: int = 1, ndata_components: int = 1, handle_inside: bool = False):
    """Magnetic sensitivity rows -> (..., ncells, nmodel_components,
    ndata_components): vectorized magnetic_field_magprism
    (magnetic_field.f90:118-297), susceptibility (1 model component) or
    magnetization vector (3); TMI (1 data component) or three-component
    data (3); unit scaling included."""
    tx, ty, tz = magnetic_tensor(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2, handle_inside)
    return combine_mag_tensor(tx, ty, tz, magv, intensity, nmodel_components, ndata_components)


# ---------------------------------------------------------------------------
# Far-field Gauss-Legendre quadrature (the compensated-float32 blend).
#
# The closed-form prism kernels are 8-corner sign-alternating sums whose
# cancellation amplifies rounding by ~(R/h)^3 (the alternating sum is a third
# difference of the corner antiderivative): at R/h = 100 a float32 evaluation
# has lost all significant bits. The reference computes them in double for
# this reason (gravity_field.f90:41-126). The stable float32 form is to stop
# differencing: for a far cell, integrate the smooth point-source integrand
# with a fixed Gauss-Legendre rule. A 3x3x3 rule's truncation error on these
# kernels is O((h/2R)^6): at the blend radius R = 4 half-diagonals both the
# float32 closed form and the quadrature sit at ~1e-5 relative, and the
# quadrature's error falls with distance while the closed form's grows.
# ---------------------------------------------------------------------------

# 3-point Gauss-Legendre nodes and weights on [-1, 1].
_GL3 = (
    (-math.sqrt(3.0 / 5.0), 5.0 / 9.0),
    (0.0, 8.0 / 9.0),
    (math.sqrt(3.0 / 5.0), 5.0 / 9.0),
)

# 2-point rule: the cheap far tier of the tiered lattice blend (8 rsqrt
# passes per cell instead of 27). Truncation error ~C (h/2R)^4.
_GL2 = (
    (-1.0 / math.sqrt(3.0), 1.0),
    (1.0 / math.sqrt(3.0), 1.0),
)

_RULES = {2: _GL2, 3: _GL3}

# Blend radius in cell half-diagonals: cells whose centre lies farther than
# FAR_QUAD_RADIUS * d use the quadrature, nearer cells the closed form.
FAR_QUAD_RADIUS = 4.0

# Tier-2 radius: beyond it the 2^3 rule replaces the 3^3 rule in the
# corner-lattice blended operator. The JAX package calibrated them on a
# 100x100x50 m prism against the float64 closed forms:
#     r/halfdiag:      8        12       16       20
#     g_z   GL2 err:   1.2e-5   2.4e-6   7.6e-7   3.1e-7
#     Gzz   GL2 err:   6.6e-5   1.3e-5   4.1e-6   1.7e-6
# At these radii the 2^3 rule's error matches the 3^3 rule's at the near
# radius 4 and falls as r^-4 beyond; the 1/r^5 tensor kernels (FTG,
# magnetics) need the larger radius.
FAR_QUAD2_RADIUS_GZ = 12.0
FAR_QUAD2_RADIUS_TENSOR = 16.0


def _quad_accumulate(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2, point_fn, n_out, order=3):
    """sum_i w_i * point_fn(source_i - obs) * V/8 over an order^3 Gauss rule.

    point_fn maps relative source coordinates (x, y, z) = (source - obs) to
    a tuple of n_out integrand tensors; returns a tuple of per-cell
    integrals. The order is 2 or 3; any other order raises ValueError (the
    JAX package takes any order but 3 as 2)."""
    if order not in _RULES:
        raise ValueError(f"Gauss-Legendre quadrature of order {order}: only orders 2 and 3 exist here")
    rule = _RULES[order]
    cx, hx = 0.5 * (X1 + X2), 0.5 * (X2 - X1)
    cy, hy = 0.5 * (Y1 + Y2), 0.5 * (Y2 - Y1)
    cz, hz = 0.5 * (Z1 + Z2), 0.5 * (Z2 - Z1)
    acc = [0.0] * n_out
    for u, wu in rule:
        for v, wv in rule:
            for w, ww in rule:
                x = cx + u * hx - xd
                y = cy + v * hy - yd
                z = cz + w * hz - zd
                vals = point_fn(x, y, z)
                wgt = wu * wv * ww
                for i in range(n_out):
                    acc[i] = acc[i] + wgt * vals[i]
    vol8 = hx * hy * hz  # cell volume / 8 (the weights sum to 2 per axis)
    return tuple(a * vol8 for a in acc)


def _second_derivatives(x, y, z):
    """(3 r_i r_j - r^2 d_ij) / r^5 in the order (xx, yy, zz, xy, yz, zx)."""
    r2 = x * x + y * y + z * z
    inv_r = torch.rsqrt(r2)
    ir2 = inv_r * inv_r
    inv_r5 = ir2 * ir2 * inv_r
    return (
        (3.0 * x * x - r2) * inv_r5,
        (3.0 * y * y - r2) * inv_r5,
        (3.0 * z * z - r2) * inv_r5,
        3.0 * x * y * inv_r5,
        3.0 * y * z * inv_r5,
        3.0 * x * z * inv_r5,
    )


def gravi_z_quad(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2, order=3):
    """Far-field g_z by quadrature of the point-mass integrand
    G (z_s - z_o) / r^3 (positive toward a source below in Z-down space, as
    gravi_z)."""

    def f(x, y, z):
        ir = torch.rsqrt(x * x + y * y + z * z)
        return (z * (ir * ir * ir),)

    (gz,) = _quad_accumulate(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2, f, 1, order=order)
    return G_GRAV * gz


def gradi_zz_quad(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2, order=3):
    """Far-field Gzz by quadrature of G (3 z^2 - r^2) / r^5 (signs as
    gradi_zz)."""

    def f(x, y, z):
        r2 = x * x + y * y + z * z
        inv_r = torch.rsqrt(r2)
        ir2 = inv_r * inv_r
        return ((3.0 * z * z - r2) * (ir2 * ir2 * inv_r),)

    (gzz,) = _quad_accumulate(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2, f, 1, order=order)
    return G_GRAV * gzz


def gradi_full_quad(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2, order=3):
    """Far-field FTG tensor (Gxx, Gyy, Gzz, Gxy, Gyz, Gzx) by quadrature of
    the Newtonian second-derivative tensor; component signs as gradi_full."""
    comps = _quad_accumulate(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2, _second_derivatives, 6, order=order)
    return tuple(G_GRAV * t for t in comps)


def magnetic_tensor_quad(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2, order=3):
    """Far-field magnetic tensor rows by quadrature of the dipole kernel
    (Sharma 1966's closed form is its prism integral), in sharmbox's layout
    ((txx, txy, txz), (tyx, tyy, tyz), (tzx, tzy, tzz))."""
    xx, yy, zz, xy, yz, zx = _quad_accumulate(
        xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2, _second_derivatives, 6, order=order
    )
    return (xx, xy, zx), (xy, yy, yz), (zx, yz, zz)


def far_mask(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2, radius=None):
    """Per cell: centre distance > radius * half-diagonal (the blend's
    decision)."""
    if radius is None:
        radius = FAR_QUAD_RADIUS
    cx, hx = 0.5 * (X1 + X2), 0.5 * (X2 - X1)
    cy, hy = 0.5 * (Y1 + Y2), 0.5 * (Y2 - Y1)
    cz, hz = 0.5 * (Z1 + Z2), 0.5 * (Z2 - Z1)
    r2 = (cx - xd) ** 2 + (cy - yd) ** 2 + (cz - zd) ** 2
    d2 = hx * hx + hy * hy + hz * hz
    return r2 > (radius * radius) * d2


def validate_finite(name: str, arr):
    """Guard replacing the reference's in-loop aborts on boundary-touching
    observation points (gravity_field.f90:99-107). Takes a numpy array or
    a tensor; a tensor is reduced where it lies, so one flag crosses to
    the host."""
    if isinstance(arr, torch.Tensor):
        ok = torch.isfinite(arr).all()
    else:
        ok = np.all(np.isfinite(np.asarray(arr)))
    require_finite(name, ok)


def require_finite(name: str, ok):
    """Raise validate_finite's error unless ok: a bool, or the boolean
    tensor of a finite check made where the values lay (read here, once)."""
    if not bool(ok):
        raise FloatingPointError(
            f"Non-finite values in {name}: a data coordinate likely coincides with a "
            "model grid boundary. Adjust the model grid!"
        )
