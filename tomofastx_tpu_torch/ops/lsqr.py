"""LSQR (Paige & Saunders) over an abstract linear operator.

Counterpart of the reference's column-parallel solver
(lsqr_solver2.F90:47-473):

- The operator is a pair of closures (matvec, rmatvec) instead of CSR
  matrices.
- The minor loop is a Python loop over tensor operations. All scalars of the
  recurrence stay 0-dim tensors on the vectors' device; the early-exit
  criteria (relative residual <= rmin, |rhobar| < 1e-30, rho == 0, optional
  target-misfit RMSE check) are tested in the order of the JAX package's
  loop, mirroring lsqr_solver2.F90:163, 185-188, 251-254, 286-289. With an
  int bound they are read on the host once per iteration (twice with the
  misfit check); with a tensor bound nothing reads the device, so that a
  major iteration can be captured as one CUDA graph.

All vectors here live in the *scaled/solver* domain; wavelet-domain
conversions are the operator's business (see inversion/joint.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class LSQRResult(NamedTuple):
    x: torch.Tensor
    iters: object  # int, or a 0-dim int64 tensor under a tensor bound
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
    niter,
    rmin: float,
    gamma: float = 0.0,
    target_misfit: float = 0.0,
    misfit_fn: Optional[Callable] = None,
    max_iter: Optional[int] = None,
) -> LSQRResult:
    """Solve min ||A x - b|| with LSQR.

    matvec(x: (ncols,)) -> (nlines,);  rmatvec(u: (nlines,)) -> (ncols,).
    If target_misfit > 0 and misfit_fn is given, misfit_fn(x) is evaluated at
    the top of every iteration and the loop exits once it reaches
    target_misfit (reference: lsqr_solver2.F90:168-189).

    With niter an int, the exit tests are read on the host each iteration
    and the loop stops at the first that holds; `iters` is an int. With
    niter a 0-dim integer tensor on b's device (at most max_iter, which is
    then required), nothing reads the device: the counterpart of the JAX
    package's lax.while_loop (tomofastx_tpu/ops/lsqr.py:107-161), which the
    fused major loop caps to 0 on a masked step. The loop then runs max_iter
    iterations' worth of tensor operations; each tests the loop's condition
    on the device (it <= niter, r > rmin, not stopped) and, with the misfit
    check, the target at its top, and an iteration that fails it leaves the
    carry as it was, by torch.where. A frozen iteration still computes both
    products on the frozen vectors, whose quotients may be inf or NaN: where
    selects, so none of that reaches x (a 0/1 mask would carry inf*0 = NaN
    in). x and the iteration count equal the host-exit form's to the last
    bit; `iters` is a 0-dim int64 tensor."""
    resident = isinstance(niter, torch.Tensor)
    if resident and max_iter is None:
        raise ValueError("lsqr_solve needs max_iter when niter is a tensor")
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
    if resident:
        it = torch.ones((), dtype=torch.int64, device=device)
        stop = torch.zeros((), dtype=torch.bool, device=device)
    else:
        it = 1
    # Loop condition of the reference: it <= niter, r > rmin, not stopped.
    # r starts at 1, so the host form's first test needs no device read.
    n_loop = max_iter if resident else (niter if 1.0 > rmin else 0)

    for _ in range(n_loop):
        if resident:
            go = (it <= niter) & (r > rmin) & ~stop
        # Optional data-misfit early exit.
        if calc_misfit:
            m = misfit_fn(x)
            if not resident:
                misfit = m
                if bool(m <= target_misfit):
                    break
            else:
                misfit = torch.where(go, m, misfit)
                reached = go & (m <= target_misfit)
                stop = stop | reached
                go = go & ~reached

        # u = -alpha*u + A v ;  beta = ||u|| ; u /= beta
        u_n, beta_n = normalize(-alpha * u + matvec(v))
        # v = -beta*v + A^T u ; alpha = ||v|| ; v /= alpha
        v_n, alpha_n = normalize(-beta_n * v + rmatvec(u_n))

        rho = torch.sqrt(rhobar * rhobar + beta_n * beta_n)
        rho_ok = rho != 0.0
        rho_inv = 1.0 / torch.where(rho_ok, rho, one)
        cc = rhobar * rho_inv
        ss = beta_n * rho_inv
        theta = ss * alpha_n
        rhobar_n = -cc * alpha_n
        phi = cc * phibar
        phibar_n = ss * phibar
        t1 = phi * rho_inv
        t2 = -theta * rho_inv

        x_n = t1 * w + x
        w_n = t2 * w + v_n
        if gamma != 0.0:
            x_n = _soft_threshold(x_n, gamma)
        r_n = phibar_n / b1
        stop_n = ~rho_ok | (torch.abs(rhobar_n) < 1.0e-30)

        # When rho == 0 the reference exits before updating x.
        if not resident:
            # One read of the device per iteration: (rho != 0, stop, r > rmin).
            rho_ok_h, stop_h, above_h = torch.stack([rho_ok, stop_n, r_n > rmin]).tolist()
            if not rho_ok_h:
                break
            x, w, r, it = x_n, w_n, r_n, it + 1
            u, v, alpha, beta, rhobar, phibar = u_n, v_n, alpha_n, beta_n, rhobar_n, phibar_n
            if not above_h or stop_h:
                break
        else:
            upd = go & rho_ok
            x = torch.where(upd, x_n, x)
            w = torch.where(upd, w_n, w)
            r = torch.where(upd, r_n, r)
            it = torch.where(upd, it + 1, it)
            u = torch.where(go, u_n, u)
            v = torch.where(go, v_n, v)
            alpha = torch.where(go, alpha_n, alpha)
            beta = torch.where(go, beta_n, beta)
            rhobar = torch.where(go, rhobar_n, rhobar)
            phibar = torch.where(go, phibar_n, phibar)
            stop = stop | (go & stop_n)

    # Guard for ||b|| == 0: the model is exact, return zeros
    # (reference: lsqr_solver2.F90:123-126).
    x = torch.where(b1 != 0.0, x, torch.zeros_like(x))
    return LSQRResult(x=x, iters=it - 1, r=r, misfit=misfit)
