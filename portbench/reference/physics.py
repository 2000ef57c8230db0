"""Frozen copy of the program's float64 kernel build for the benchmark's
reference (later changes to the program do not reach it): the corner-lattice
closed forms of g_z and of TMI (ops/prism.py, ops/matrixfree.py), the
distance weighting and the wavelet threshold of the rows
(ops/sensitivity.py), as they were."""

from __future__ import annotations

import math

import torch

from portbench.reference import wavelet as W

G_GRAV = 6.674e-11
TWO_PI = 2.0 * math.pi


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

    if problem == "grav":
        raise NotImplementedError("the reference builds g_z and TMI rows only")

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
