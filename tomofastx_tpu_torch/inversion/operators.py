"""Matrix-free constraint operators for the joint least-squares system.

The reference assembles every constraint into a CSR "constraints matrix"
each major iteration (joint_inverse_problem.F90:264-359, damping.F90).
Here each constraint is a *linearized operator*: an assembly step (tensor
operations over all cells) produces coefficient fields + RHS + cost, and
matvec/rmatvec are elementwise ops. No sparse indices, no row bookkeeping.

Ported so far: the zero-fill shift and the damping block (which also
carries the ADMM term). The gradient, cross-gradient and clustering blocks
are not ported yet.

Conventions:
- x segments are in the *scaled model* domain m~ = m / column_weight
  (or its wavelet transform when solving in the wavelet domain);
- all coefficient math follows the reference's exact weighting order, cited
  per function;
- "cube" means shape (nz, ny, nx) with the i-fastest flat order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from tomofastx_tpu_torch.ops import wavelet as W


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
