"""Frozen copy of the program's inversion/operators.py for the benchmark's reference
(later changes to the program do not reach it), from here on as it was:

Matrix-free constraint operators for the joint least-squares system.

The reference assembles every constraint into a CSR "constraints matrix"
each major iteration (joint_inverse_problem.F90:264-359, damping.F90,
damping_gradient.F90, cross_gradient.F90, clustering.F90). Here each
constraint is a *linearized operator*: an assembly step (tensor operations
over all cells) produces coefficient fields + RHS + cost, and matvec/rmatvec
are elementwise/stencil ops. No sparse indices, no row bookkeeping.

Every new tensor takes its dtype and device from the model it is made for:
a bare torch.zeros would be float32 and silently round a float64 solve.

Conventions:
- x segments are in the *scaled model* domain m~ = m / column_weight
  (or its wavelet transform when solving in the wavelet domain);
- all coefficient math follows the reference's exact weighting order, cited
  per function;
- "cube" means shape (nz, ny, nx) with the i-fastest flat order.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from portbench.reference import wavelet as W


def shift(cube, offset: Tuple[int, int, int]):
    """shift(x, o)[p] = x[p + o] with zero fill; o = (di, dj, dk) cell offsets.
    Matches the reference's zero-padded out-of-grid lookups
    (gradient.F90:210-218)."""
    out = cube
    for axis, d in ((2, offset[0]), (1, offset[1]), (0, offset[2])):
        if d == 0:
            continue
        out = torch.roll(out, -d, dims=axis)  # a new tensor, zeroed in place below
        n = out.shape[axis]
        idx = [slice(None)] * 3
        if d > 0:
            idx[axis] = slice(n - d, n)
        else:
            idx[axis] = slice(0, -d)
        out[tuple(idx)] = 0.0
    return out


# =============================================================================
# Damping (model prior term) — reference: damping.F90:97-234
# =============================================================================


class DampingOp(NamedTuple):
    """alpha * W * (m - m_prior) rows: diagonal in the scaled-model space."""

    dcoef: torch.Tensor  # (ncomp, N) diagonal coefficients
    rhs: torch.Tensor  # (ncomp, N)
    cost: torch.Tensor  # scalar

    def matvec(self, xseg):
        # xseg: (ncomp, N) scaled-model segment of this problem.
        return (self.dcoef * xseg).reshape(-1)

    def rmatvec(self, u):
        return self.dcoef * u.reshape(self.dcoef.shape)

    @property
    def nrows(self):
        return self.rhs.numel()


def make_damping(
    alpha: float,
    problem_weight: float,
    norm_power: float,
    model: torch.Tensor,  # (ncomp, N)
    model_prior: torch.Tensor,  # (ncomp, N)
    column_weight: torch.Tensor,  # (N,)
    local_weight: Optional[torch.Tensor],  # (N,) or None
    wavelet_domain: bool,
    compression_type: int,
    nx: int,
    ny: int,
    nz: int,
) -> DampingOp:
    """Assemble the damping block (reference: damping_add, damping.F90:97-201):
    matrix value = alpha*pw*(Lp multiplier)*(local weight) on the diagonal,
    RHS = -alpha*pw*diff*(Lp)*(local), diff = (m - m_prior)/column_weight,
    wavelet-transformed when solving in the wavelet domain
    (damping.F90:135-149)."""
    cw = column_weight[None, :]
    diff = torch.where(cw != 0.0, (model - model_prior) / torch.where(cw != 0.0, cw, 1.0), 0.0)

    if compression_type > 0 and wavelet_domain:
        diff = W.forward_wavelet_flat(diff, nx, ny, nz, compression_type)

    base = alpha * problem_weight
    if norm_power != 2.0:
        lp = torch.where(diff != 0.0, torch.abs(diff) ** (norm_power / 2.0 - 1.0), 1.0)
    else:
        lp = 1.0
    lw = 1.0 if local_weight is None else local_weight[None, :]
    dcoef = base * lp * lw * torch.ones_like(diff)
    rhs = -base * diff * lp * lw
    cost = torch.sum(rhs**2)
    return DampingOp(dcoef=dcoef, rhs=rhs, cost=cost)


# ADMM reuses DampingOp on a single-component slice; the system assembly
# scatters the contribution into the right component (the reference adds the
# ADMM quadratic term through the same damping machinery,
# joint_inverse_problem.F90:497-527).


# Axis index in a (nz, ny, nx) cube for direction 1=x, 2=y, 3=z.
_DIR_AXIS = {1: 2, 2: 1, 3: 0}


def _axis_index(shape, axis, device):
    """The position of every cell of a cube along `axis`, broadcastable to
    `shape` (jax.lax.broadcasted_iota)."""
    view = [1, 1, 1]
    view[axis] = shape[axis]
    return torch.arange(shape[axis], device=device).reshape(view)


# =============================================================================
# Damping gradient (first-difference smoothing) —
# reference: damping_gradient.F90:94-205
# =============================================================================


class DampingGradientOp(NamedTuple):
    """Rows (pw*beta/delta) (m~_{p+1} w_{p+1} - m~_p w_p) per direction.

    coefA multiplies the shifted (next-cell) column, coefB the diagonal;
    both are cubes."""

    coefA: torch.Tensor  # (nz, ny, nx)
    coefB: torch.Tensor  # (nz, ny, nx)
    rhs: torch.Tensor  # (N,)
    cost: torch.Tensor
    offset: Tuple[int, int, int]

    def matvec(self, x_comp_cube):
        return (self.coefA * shift(x_comp_cube, self.offset) + self.coefB * x_comp_cube).reshape(-1)

    def rmatvec(self, u):
        ucube = u.reshape(self.coefB.shape)
        neg = tuple(-o for o in self.offset)
        return self.coefB * ucube + shift(self.coefA * ucube, neg)

    @property
    def nrows(self):
        return self.rhs.numel()


def make_damping_gradient(
    beta: float,
    problem_weight: float,
    model_comp: torch.Tensor,  # (N,) actual model values of one component
    column_weight: torch.Tensor,  # (N,)
    local_weight: torch.Tensor,  # (N,) per-direction local weights
    dX: torch.Tensor,
    dY: torch.Tensor,
    dZ: torch.Tensor,
    nx: int,
    ny: int,
    nz: int,
    direction: int,  # 1=x, 2=y, 3=z
) -> DampingGradientOp:
    """Assemble one direction of the smoothing block (reference:
    damping_gradient_add, damping_gradient.F90:94-205). Boundary rows
    (last cell along the direction) are empty with zero RHS."""
    m = model_comp.reshape(nz, ny, nx)
    cw = column_weight.reshape(nz, ny, nx)
    lw = local_weight.reshape(nz, ny, nx)

    axis = _DIR_AXIS[direction]
    if direction == 1:
        delta = dX.reshape(1, 1, nx)
        offset = (1, 0, 0)
    elif direction == 2:
        delta = dY.reshape(1, ny, 1)
        offset = (0, 1, 0)
    else:
        delta = dZ.reshape(nz, 1, 1)
        offset = (0, 0, 1)

    interior = _axis_index(m.shape, axis, m.device) < (m.shape[axis] - 1)

    grad = (shift(m, offset) - m) / delta  # forward difference (zero-padded)
    base = problem_weight * beta

    coefA = torch.where(interior, base / delta * shift(cw, offset) * lw, 0.0)
    coefB = torch.where(interior, -base / delta * cw * lw, 0.0)
    rhs = torch.where(interior, -base * grad * lw, 0.0).reshape(-1)
    cost = torch.sum(torch.where(interior, grad, 0.0) ** 2)
    return DampingGradientOp(coefA=coefA, coefB=coefB, rhs=rhs, cost=cost, offset=offset)


# =============================================================================
# Cross-gradient coupling — reference: cross_gradient.F90:220-391
# =============================================================================

# Stencil offsets used by the forward/backward/central schemes.
_XG_OFFSETS = (
    (0, 0, 0),
    (1, 0, 0),
    (-1, 0, 0),
    (0, 1, 0),
    (0, -1, 0),
    (0, 0, 1),
    (0, 0, -1),
)


class CrossGradientOp(NamedTuple):
    """3 row sets (tau_x, tau_y, tau_z), each with stencil coefficients on
    both models.  C1/C2: (3, n_offsets, nz, ny, nx); rhs: (3, N)."""

    C1: torch.Tensor
    C2: torch.Tensor
    rhs: torch.Tensor  # (3, N) = -tau * glob_weight
    cost: torch.Tensor  # (3,) per component sum tau^2
    magnitude: torch.Tensor  # (N,) |tau| per cell (for VTK output)

    def matvec(self, x1_cube, x2_cube):
        outs = []
        for c in range(3):
            acc = None
            for oi, off in enumerate(_XG_OFFSETS):
                t1 = self.C1[c, oi] * shift(x1_cube, off)
                acc = t1 if acc is None else acc + t1
                acc = acc + self.C2[c, oi] * shift(x2_cube, off)
            outs.append(acc.reshape(-1))
        return torch.cat(outs)

    def rmatvec(self, u):
        shp = self.C1.shape[-3:]
        N = shp[0] * shp[1] * shp[2]
        g1 = torch.zeros(shp, dtype=u.dtype, device=u.device)
        g2 = torch.zeros(shp, dtype=u.dtype, device=u.device)
        for c in range(3):
            ucube = u[c * N : (c + 1) * N].reshape(shp)
            for oi, off in enumerate(_XG_OFFSETS):
                neg = tuple(-o for o in off)
                g1 += shift(self.C1[c, oi] * ucube, neg)
                g2 += shift(self.C2[c, oi] * ucube, neg)
        return g1, g2

    @property
    def nrows(self):
        return self.rhs.numel()


def _scheme_gradient(m, delta, scheme: str):
    """Per-axis finite differences of cube m with zero-padded lookups
    (reference: get_grad, gradient.F90:71-175). delta = (dXc, dYc, dZc) cubes."""
    dXc, dYc, dZc = delta
    offs = {"x": (1, 0, 0), "y": (0, 1, 0), "z": (0, 0, 1)}
    out = {}
    for ax, off in offs.items():
        d = {"x": dXc, "y": dYc, "z": dZc}[ax]
        neg = tuple(-o for o in off)
        if scheme == "fwd":
            out[ax] = (shift(m, off) - m) / d
        elif scheme == "bwd":
            out[ax] = (m - shift(m, neg)) / d
        else:
            out[ax] = (shift(m, off) - shift(m, neg)) / (2.0 * d)
    return out["x"], out["y"], out["z"]


def make_cross_gradient(
    model1: torch.Tensor,  # (N,) actual values (component 1)
    model2: torch.Tensor,
    column_weight1: torch.Tensor,
    column_weight2: torch.Tensor,
    glob_weight: float,
    der_type: int,  # 1 = forward, 2 = central (with boundary switching)
    keep_model_constant: Tuple[int, int],
    vec_field: Optional[torch.Tensor],  # (N, 3) or None
    vec_field_type: int,
    dX: torch.Tensor,
    dY: torch.Tensor,
    dZ: torch.Tensor,
    nx: int,
    ny: int,
    nz: int,
    add_weights: bool = True,
) -> CrossGradientOp:
    """Assemble the cross-gradient constraint tau = grad m1 x grad m2
    (reference: cross_gradient_calculate, cross_gradient.F90:220-391) with
    per-cell scheme selection: forward in the interior (der_type=1) or
    central (der_type=2), backward on the right boundary, forward on the left
    boundary (der_type=2), and disabled where a cell touches both boundaries
    (cross_gradient.F90:262-287). An axis of one cell puts every cell on
    both boundaries, which disables the whole constraint."""
    shp = (nz, ny, nx)
    m1 = model1.reshape(shp)
    m2 = model2.reshape(shp)
    cw1 = column_weight1.reshape(shp)
    cw2 = column_weight2.reshape(shp)
    dXc = dX.reshape(1, 1, nx)
    dYc = dY.reshape(1, ny, 1)
    dZc = dZ.reshape(nz, 1, 1)
    delta = (dXc, dYc, dZc)

    dev = m1.device
    ii, jj, kk = (_axis_index(shp, axis, dev) for axis in (2, 1, 0))
    on_left = (ii == 0) | (jj == 0) | (kk == 0)
    on_right = (ii == nx - 1) | (jj == ny - 1) | (kk == nz - 1)
    mask_zero = on_left & on_right
    if der_type == 1:
        mask_bwd = on_right & ~mask_zero
        mask_fwd = ~on_right & ~mask_zero
        mask_cnt = None
    elif der_type == 2:
        mask_bwd = on_right & ~mask_zero
        mask_fwd = on_left & ~on_right & ~mask_zero
        mask_cnt = ~on_left & ~on_right
    else:
        raise ValueError(f"Unsupported derivative type {der_type}!")

    def gradients(m, use_field: bool):
        if use_field:
            vf = vec_field.T.reshape(3, nz, ny, nx)
            return {s: (vf[0], vf[1], vf[2]) for s in ("fwd", "bwd", "cnt")}
        return {s: _scheme_gradient(m, delta, s) for s in ("fwd", "bwd", "cnt")}

    g1 = gradients(m1, vec_field_type == 1 and vec_field is not None)
    g2 = gradients(m2, vec_field_type == 2 and vec_field is not None)

    n_off = len(_XG_OFFSETS)
    off_index = {o: i for i, o in enumerate(_XG_OFFSETS)}
    C1 = torch.zeros((3, n_off) + shp, dtype=m1.dtype, device=dev)
    C2 = torch.zeros_like(C1)
    tau = torch.zeros((3,) + shp, dtype=m1.dtype, device=dev)

    def accumulate(scheme, mask):
        """Add one scheme's tau and Jacobian stencils where mask holds."""
        m1x, m1y, m1z = g1[scheme]
        m2x, m2y, m2z = g2[scheme]
        # tau = g1 x g2
        t = (
            m1y * m2z - m1z * m2y,
            m1z * m2x - m1x * m2z,
            m1x * m2y - m1y * m2x,
        )
        for c, tc in enumerate(t):
            tau[c] += torch.where(mask, tc, 0.0)

        if scheme == "fwd":
            sx, sy, sz = dXc, dYc, dZc
            # (component, model, offset, value) entries; reference
            # cross_gradient.F90:486-575 with der_type = 1.
            entries = [
                (0, 1, (0, 1, 0), m2z / sy), (0, 2, (0, 1, 0), -m1z / sy),
                (0, 1, (0, 0, 1), -m2y / sz), (0, 2, (0, 0, 1), m1y / sz),
                (0, 1, (0, 0, 0), -(m2z / sy - m2y / sz)), (0, 2, (0, 0, 0), -(m1y / sz - m1z / sy)),
                (1, 1, (1, 0, 0), -m2z / sx), (1, 2, (1, 0, 0), m1z / sx),
                (1, 1, (0, 0, 1), m2x / sz), (1, 2, (0, 0, 1), -m1x / sz),
                (1, 1, (0, 0, 0), -(m2x / sz - m2z / sx)), (1, 2, (0, 0, 0), -(m1z / sx - m1x / sz)),
                (2, 1, (1, 0, 0), m2y / sx), (2, 2, (1, 0, 0), -m1y / sx),
                (2, 1, (0, 1, 0), -m2x / sy), (2, 2, (0, 1, 0), m1x / sy),
                (2, 1, (0, 0, 0), -(m2y / sx - m2x / sy)), (2, 2, (0, 0, 0), -(m1x / sy - m1y / sx)),
            ]
        elif scheme == "bwd":
            sx, sy, sz = dXc, dYc, dZc
            # reference: cross_gradient_calculate_tau_backward,
            # cross_gradient.F90:675-743.
            entries = [
                (0, 1, (0, -1, 0), -m2z / sy), (0, 2, (0, -1, 0), m1z / sy),
                (0, 1, (0, 0, -1), m2y / sz), (0, 2, (0, 0, -1), -m1y / sz),
                (0, 1, (0, 0, 0), m2z / sy - m2y / sz), (0, 2, (0, 0, 0), m1y / sz - m1z / sy),
                (1, 1, (-1, 0, 0), m2z / sx), (1, 2, (-1, 0, 0), -m1z / sx),
                (1, 1, (0, 0, -1), -m2x / sz), (1, 2, (0, 0, -1), m1x / sz),
                (1, 1, (0, 0, 0), m2x / sz - m2z / sx), (1, 2, (0, 0, 0), m1z / sx - m1x / sz),
                (2, 1, (-1, 0, 0), -m2y / sx), (2, 2, (-1, 0, 0), m1y / sx),
                (2, 1, (0, -1, 0), m2x / sy), (2, 2, (0, -1, 0), -m1x / sy),
                (2, 1, (0, 0, 0), m2y / sx - m2x / sy), (2, 2, (0, 0, 0), m1x / sy - m1y / sx),
            ]
        else:  # central: step doubled, no diagonal entry
            sx, sy, sz = 2.0 * dXc, 2.0 * dYc, 2.0 * dZc
            entries = [
                (0, 1, (0, 1, 0), m2z / sy), (0, 2, (0, 1, 0), -m1z / sy),
                (0, 1, (0, 0, 1), -m2y / sz), (0, 2, (0, 0, 1), m1y / sz),
                (0, 1, (0, -1, 0), -m2z / sy), (0, 2, (0, -1, 0), m1z / sy),
                (0, 1, (0, 0, -1), m2y / sz), (0, 2, (0, 0, -1), -m1y / sz),
                (1, 1, (1, 0, 0), -m2z / sx), (1, 2, (1, 0, 0), m1z / sx),
                (1, 1, (0, 0, 1), m2x / sz), (1, 2, (0, 0, 1), -m1x / sz),
                (1, 1, (-1, 0, 0), m2z / sx), (1, 2, (-1, 0, 0), -m1z / sx),
                (1, 1, (0, 0, -1), -m2x / sz), (1, 2, (0, 0, -1), m1x / sz),
                (2, 1, (1, 0, 0), m2y / sx), (2, 2, (1, 0, 0), -m1y / sx),
                (2, 1, (0, 1, 0), -m2x / sy), (2, 2, (0, 1, 0), m1x / sy),
                (2, 1, (-1, 0, 0), -m2y / sx), (2, 2, (-1, 0, 0), m1y / sx),
                (2, 1, (0, -1, 0), m2x / sy), (2, 2, (0, -1, 0), -m1x / sy),
            ]

        # C1 and C2 are this function's own tensors: adding in place is
        # JAX's functional .at[].add.
        for (c, mdl, off, val) in entries:
            (C1 if mdl == 1 else C2)[c, off_index[off]] += torch.where(mask, val, 0.0)

    accumulate("fwd", mask_fwd)
    accumulate("bwd", mask_bwd)
    if der_type == 2:
        accumulate("cnt", mask_cnt)

    # keep_model_constant zeroes that model's derivatives
    # (cross_gradient.F90:294-295).
    if keep_model_constant[0]:
        C1.zero_()
    if keep_model_constant[1]:
        C2.zero_()

    # Matrix entries carry column weights and the global weight
    # (cross_gradient.F90:320-321); the weight sits at the *column* cell.
    if add_weights:
        for oi, off in enumerate(_XG_OFFSETS):
            C1[:, oi] *= (glob_weight * shift(cw1, off))[None]
            C2[:, oi] *= (glob_weight * shift(cw2, off))[None]

    rhs = (-glob_weight * tau).reshape(3, -1)
    cost = torch.sum(tau.reshape(3, -1) ** 2, dim=1)
    magnitude = torch.sqrt(torch.sum(tau**2, dim=0)).reshape(-1)
    return CrossGradientOp(C1=C1, C2=C2, rhs=rhs, cost=cost, magnitude=magnitude)


# =============================================================================
# Clustering (petrophysical Gaussian-mixture prior) —
# reference: clustering.F90:393-649
# =============================================================================


class ClusteringOp(NamedTuple):
    """One row set per problem; diagonal on that problem's first component."""

    dcoef: torch.Tensor  # (N,) on this problem's model
    rhs: torch.Tensor  # (N,)
    cost: torch.Tensor
    probabilities: torch.Tensor  # (N,) P(m) per cell for output
    problem: int

    @property
    def nrows(self):
        return self.rhs.numel()


# exp floor of the mixture (clustering.F90:584-588), a Python float so that
# it takes the dtype of the tensor it meets.
_EXP_FLOOR = math.exp(-100.0)


def gaussian_mixture(
    val1, val2, mu, sigma, cell_weight, weight_loc
):
    """Gaussian mixture value and derivatives per cell.

    val1/val2: (N,); mu: (2, C); sigma: (3, C) rows (s11, s22, s12);
    cell_weight: (N, C); weight_loc: (w1, w2) flags choosing 1-D vs 2-D
    Gaussians (reference: clustering.F90:514-649). Returns (gauss (N,),
    deriv (2, N))."""
    x = val1[:, None]
    y = val2[:, None]
    mu1, mu2 = mu[0][None, :], mu[1][None, :]
    s11, s22, s12 = sigma[0][None, :], sigma[1][None, :], sigma[2][None, :]

    both = (weight_loc[0] != 0.0) and (weight_loc[1] != 0.0)
    if both:
        det = s12**4 - s11**2 * s22**2
        arg = (
            -((-mu2 + y) * (mu2 * s11**2 - mu1 * s12**2 + s12**2 * x - s11**2 * y)) / det
            - ((-mu1 + x) * (mu2 * s12**2 - mu1 * s22**2 + s22**2 * x - s12**2 * y)) / (-det)
        ) / 2.0
        norm = 2.0 * math.pi * torch.sqrt(-det)
    elif weight_loc[1] == 0.0:
        arg = -((x - mu1) ** 2) / s11**2 / 2.0
        norm = torch.sqrt(2.0 * math.pi * s11**2)
    else:
        arg = -((y - mu2) ** 2) / s22**2 / 2.0
        norm = torch.sqrt(2.0 * math.pi * s22**2)

    g = torch.where(arg < -100.0, _EXP_FLOOR, torch.exp(torch.clamp(arg, min=-100.0)) / norm)

    gauss_loc = cell_weight * g  # (N, C)
    gauss = torch.sum(gauss_loc, dim=1)

    det = s12**4 - s11**2 * s22**2
    coef1 = (s22**2 * (-mu1 + x) + s12**2 * (mu2 - y)) / det
    coef2 = (s12**2 * (mu1 - x) + s11**2 * (-mu2 + y)) / det
    d1 = torch.sum(coef1 * gauss_loc, dim=1)
    d2 = torch.sum(coef2 * gauss_loc, dim=1)
    return gauss, torch.stack([d1, d2])


def make_clustering(
    model1: torch.Tensor,
    model2: torch.Tensor,
    column_weight1: torch.Tensor,
    column_weight2: torch.Tensor,
    weight_glob: Tuple[float, float],
    mu: torch.Tensor,
    sigma: torch.Tensor,
    cell_weight: torch.Tensor,  # (N, C)
    mixture_max: torch.Tensor,  # (N,)
    opt_type: int,
    problem: int,  # 0 or 1: which row set
) -> ClusteringOp:
    """Assemble one problem's clustering rows (reference: clustering_add,
    clustering.F90:393-508)."""
    weight_loc = tuple(1.0 if w != 0.0 else 0.0 for w in weight_glob)
    gauss, deriv = gaussian_mixture(model1, model2, mu, sigma, cell_weight, weight_loc)

    if opt_type == 2:
        deriv = torch.where(gauss != 0.0, -deriv / torch.where(gauss != 0.0, gauss, 1.0), 0.0)
        func_val = torch.where(
            gauss > 0.0, -torch.log(torch.where(gauss > 0.0, gauss, 1.0)) + torch.log(mixture_max), 0.0
        )
    elif opt_type == 1:
        func_val = gauss - mixture_max
    else:
        raise ValueError(f"Wrong optimization type {opt_type} in clustering!")

    Cp = [1.0 if weight_loc[i] != 0.0 else 0.0 for i in range(2)]
    cw = column_weight1 if problem == 0 else column_weight2
    dcoef = weight_glob[problem] * cw * deriv[problem] * Cp[problem]
    rhs = -weight_glob[problem] * func_val * Cp[problem]
    cost = torch.sum(rhs**2)
    return ClusteringOp(
        dcoef=dcoef, rhs=rhs, cost=cost, probabilities=gauss, problem=problem
    )
