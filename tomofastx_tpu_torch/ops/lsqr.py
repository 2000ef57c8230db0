"""LSQR (Paige & Saunders) over an abstract linear operator.

Counterpart of the reference's column-parallel solver
(lsqr_solver2.F90:47-473):

- The operator is a pair of closures (matvec, rmatvec) instead of CSR
  matrices.
- The minor loop is a Python loop over tensor operations. All scalars of the
  recurrence stay 0-dim tensors on the vectors' device; the early-exit
  criteria (relative residual <= rmin, |rhobar| < 1e-30, rho == 0, optional
  target-misfit RMSE check) are tested in the order of the JAX package's
  loop, mirroring lsqr_solver2.F90:163, 185-188, 251-254, 286-289, and are
  read on the host once per iteration (twice with the misfit check).

All vectors here live in the *scaled/solver* domain; wavelet-domain
conversions are the operator's business (see inversion/joint.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class LSQRResult(NamedTuple):
    x: torch.Tensor
    iters: int
    r: torch.Tensor  # relative residual phibar / b1
    misfit: torch.Tensor  # last computed data RMSE (inf if never computed)


def _soft_threshold(x, gamma):
    """ISTA soft thresholding (reference: apply_soft_thresholding,
    lsqr_solver2.F90:478-494)."""
    return torch.sign(x) * torch.clamp(torch.abs(x) - gamma, min=0.0)


def lsqr_solve(
    matvec: Callable,
    rmatvec: Callable,
    b: torch.Tensor,
    ncols: int,
    niter: int,
    rmin: float,
    gamma: float = 0.0,
    target_misfit: float = 0.0,
    misfit_fn: Optional[Callable] = None,
) -> LSQRResult:
    """Solve min ||A x - b|| with LSQR.

    matvec(x: (ncols,)) -> (nlines,);  rmatvec(u: (nlines,)) -> (ncols,).
    If target_misfit > 0 and misfit_fn is given, misfit_fn(x) is evaluated at
    the top of every iteration and the loop exits once it reaches
    target_misfit (reference: lsqr_solver2.F90:168-189).
    """
    dtype, device = b.dtype, b.device
    calc_misfit = (target_misfit > 0.0) and (misfit_fn is not None)
    one = torch.ones((), dtype=dtype, device=device)

    def normalize(vec):
        s = torch.linalg.vector_norm(vec)
        # A zero vector stays as it is (divided by 1).
        return vec / torch.where(s != 0.0, s, one), s

    u, beta = normalize(b)
    b1 = beta

    v, alpha = normalize(rmatvec(u))

    x = torch.zeros((ncols,), dtype=dtype, device=device)
    w = v
    rhobar = alpha
    phibar = beta
    r = one
    misfit = torch.full((), float("inf"), dtype=dtype, device=device)
    it = 1
    # Loop condition of the reference: it <= niter, r > rmin, not stopped.
    # r starts at 1, so the first test needs no device read.
    go = niter >= 1 and 1.0 > rmin

    while go:
        # Optional data-misfit early exit.
        if calc_misfit:
            misfit = misfit_fn(x)
            if bool(misfit <= target_misfit):
                break

        # u = -alpha*u + A v ;  beta = ||u|| ; u /= beta
        u, beta = normalize(-alpha * u + matvec(v))
        # v = -beta*v + A^T u ; alpha = ||v|| ; v /= alpha
        v, alpha = normalize(-beta * v + rmatvec(u))

        rho = torch.sqrt(rhobar * rhobar + beta * beta)
        rho_ok = rho != 0.0
        rho_inv = 1.0 / torch.where(rho_ok, rho, one)
        cc = rhobar * rho_inv
        ss = beta * rho_inv
        theta = ss * alpha
        rhobar = -cc * alpha
        phi = cc * phibar
        phibar = ss * phibar
        t1 = phi * rho_inv
        t2 = -theta * rho_inv

        x_new = t1 * w + x
        w_new = t2 * w + v
        if gamma != 0.0:
            x_new = _soft_threshold(x_new, gamma)
        r_new = phibar / b1

        stop = (~rho_ok) | (torch.abs(rhobar) < 1.0e-30)
        # One read of the device per iteration: (rho != 0, stop, r > rmin).
        rho_ok_h, stop_h, above_h = torch.stack([rho_ok, stop, r_new > rmin]).tolist()
        if not rho_ok_h:
            # When rho == 0 the reference exits before updating x.
            break
        x, w, r = x_new, w_new, r_new
        it += 1
        go = it <= niter and above_h and not stop_h

    # Guard for ||b|| == 0: the model is exact, return zeros
    # (reference: lsqr_solver2.F90:123-126).
    x = torch.where(b1 != 0.0, x, torch.zeros_like(x))
    return LSQRResult(x=x, iters=it - 1, r=r, misfit=misfit)
