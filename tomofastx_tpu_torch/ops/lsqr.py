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
  misfit check), each read counted in host_reads and marked `lsqr.read`,
  each iteration marked `lsqr.iteration` (utils/trace.py); with a tensor
  bound nothing reads the device, so that a major iteration can be captured
  as CUDA graphs.

All vectors here live in the *scaled/solver* domain; wavelet-domain
conversions are the operator's business (see inversion/joint.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from tomofastx_tpu_torch.utils.trace import count, fine


class LSQRResult(NamedTuple):
    x: torch.Tensor
    iters: object  # int, or a 0-dim int64 tensor under a tensor bound
    r: torch.Tensor  # relative residual phibar / b1
    misfit: torch.Tensor  # last computed data RMSE (inf if never computed)


class LSQRLoop(NamedTuple):
    """The loop of the split form, as lsqr_solve hands it to its runner:
    `iterate()` runs one iteration on the carry's buffers and writes the
    loop's condition for the next one into `go`; the runner calls it while
    `go` holds, at most `max_iter` times (while_on_the_host, or the WHILE
    node of ops/graph_while.py)."""

    go: torch.Tensor  # 0-dim bool: it <= niter, r > rmin and not stopped
    carry: dict  # the carry's buffers, each written in place
    iterate: Callable
    max_iter: int


# The carry of the device-resident loop (the JAX package's Carry,
# tomofastx_tpu/ops/lsqr.py:91-105).
CARRY = ("x", "w", "u", "v", "alpha", "beta", "rhobar", "phibar", "r", "it", "stop", "misfit")


def _read(t: torch.Tensor):
    """t's value on the host (tolist): a wait for the device, counted."""
    with fine("lsqr.read"):
        count("host_reads")
        return t.tolist()


def while_on_the_host(loop: LSQRLoop) -> int:
    """Drives the split form from the host as the WHILE node drives it on
    the card: one iteration a pass while the flag holds, at most max_iter
    passes; returns the passes."""
    runs = 0
    while runs < loop.max_iter and _read(loop.go):
        loop.iterate()
        runs += 1
    return runs


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
    loop: Optional[Callable] = None,
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
    fused major loop caps to 0 on a masked step. Each iteration tests the
    loop's condition on the device (it <= niter, r > rmin, not stopped)
    and, with the misfit check, the target at its top, and an iteration
    that fails it leaves the carry as it was, by torch.where. Such an
    iteration still computes both products on the frozen vectors, whose
    quotients may be inf or NaN: where selects, so none of that reaches x
    (a 0/1 mask would carry inf*0 = NaN in). `iters` is a 0-dim int64
    tensor. Two forms run it:

    - without `loop`, max_iter iterations unrolled (the eager steps);
    - with `loop`, the split form: the first products and the carry, in
      buffers made once, then loop(LSQRLoop) runs the iterations (each
      copies its carry into those buffers and writes the next condition
      into a one-byte flag), then the result. The fused major loop's runner
      captures one iteration as the body of a CUDA WHILE node, which stops
      where the JAX package's loop stops; while_on_the_host drives it on the
      host.

    x and the iteration count of either equal the host-exit form's to the
    last bit."""
    resident = isinstance(niter, torch.Tensor)
    if resident and max_iter is None:
        raise ValueError("lsqr_solve needs max_iter when niter is a tensor")
    if loop is not None and not resident:
        raise ValueError("lsqr_solve takes a loop runner only with a tensor bound")
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

    c = {"x": torch.zeros((ncols,), dtype=dtype, device=device), "w": v, "u": u, "v": v, "alpha": alpha,
         "beta": beta, "rhobar": alpha, "phibar": beta, "r": one,
         "misfit": torch.full((), float("inf"), dtype=dtype, device=device)}

    def advance(c):
        """One LSQR step from the carry c: the new x, w, u, v, alpha, beta,
        rhobar, phibar and r; rho != 0; and the stop test."""
        # u = -alpha*u + A v ;  beta = ||u|| ; u /= beta
        u_n, beta_n = normalize(-c["alpha"] * c["u"] + matvec(c["v"]))
        # v = -beta*v + A^T u ; alpha = ||v|| ; v /= alpha
        v_n, alpha_n = normalize(-beta_n * c["v"] + rmatvec(u_n))

        rho = torch.sqrt(c["rhobar"] * c["rhobar"] + beta_n * beta_n)
        rho_ok = rho != 0.0
        rho_inv = 1.0 / torch.where(rho_ok, rho, one)
        cc = c["rhobar"] * rho_inv
        ss = beta_n * rho_inv
        theta = ss * alpha_n
        rhobar_n = -cc * alpha_n
        phi = cc * c["phibar"]
        phibar_n = ss * c["phibar"]
        t1 = phi * rho_inv
        t2 = -theta * rho_inv

        x_n = t1 * c["w"] + c["x"]
        w_n = t2 * c["w"] + v_n
        if gamma != 0.0:
            x_n = _soft_threshold(x_n, gamma)
        new = {"x": x_n, "w": w_n, "u": u_n, "v": v_n, "alpha": alpha_n, "beta": beta_n, "rhobar": rhobar_n,
               "phibar": phibar_n, "r": phibar_n / b1}
        return new, rho_ok, ~rho_ok | (torch.abs(rhobar_n) < 1.0e-30)

    def finish(x, iters, r, misfit):
        # Guard for ||b|| == 0: the model is exact, return zeros
        # (reference: lsqr_solver2.F90:123-126).
        return LSQRResult(x=torch.where(b1 != 0.0, x, torch.zeros_like(x)), iters=iters, r=r, misfit=misfit)

    if not resident:
        it = 1
        # Loop condition of the reference: it <= niter, r > rmin, not stopped.
        # r starts at 1, so the first test needs no device read.
        for _ in range(niter if 1.0 > rmin else 0):
            with fine("lsqr.iteration"):
                # Optional data-misfit early exit.
                if calc_misfit:
                    c["misfit"] = misfit_fn(c["x"])
                    if _read(c["misfit"] <= target_misfit):
                        break
                new, rho_ok, stop_n = advance(c)
                # One read of the device per iteration: (rho != 0, stop, r > rmin).
                rho_ok_h, stop_h, above_h = _read(torch.stack([rho_ok, stop_n, new["r"] > rmin]))
                # When rho == 0 the reference exits before updating x.
                if not rho_ok_h:
                    break
                c.update(new)
                it += 1
                if not above_h or stop_h:
                    break
        return finish(c["x"], it - 1, c["r"], c["misfit"])

    c["it"] = torch.ones((), dtype=torch.int64, device=device)
    c["stop"] = torch.zeros((), dtype=torch.bool, device=device)

    def condition(c):
        return (c["it"] <= niter) & (c["r"] > rmin) & ~c["stop"]

    def iteration(c):
        """One iteration of the device-resident loop: the new carry, the
        old one's values where the loop's condition fails."""
        go, stop, misfit = condition(c), c["stop"], c["misfit"]
        if calc_misfit:
            m = misfit_fn(c["x"])
            misfit = torch.where(go, m, misfit)
            reached = go & (m <= target_misfit)
            stop = stop | reached
            go = go & ~reached
        new, rho_ok, stop_n = advance(c)
        # When rho == 0 the reference exits before updating x.
        upd = go & rho_ok
        out = {k: torch.where(upd, new[k], c[k]) for k in ("x", "w", "r")}
        out["it"] = torch.where(upd, c["it"] + 1, c["it"])
        out.update({k: torch.where(go, new[k], c[k]) for k in ("u", "v", "alpha", "beta", "rhobar", "phibar")})
        out["stop"] = stop | (go & stop_n)
        out["misfit"] = misfit
        return out

    if loop is None:
        for _ in range(max_iter):
            c = iteration(c)
        return finish(c["x"], c["it"] - 1, c["r"], c["misfit"])

    # The split form: every carry value in a buffer of its own (w and v,
    # rhobar and alpha, phibar and beta start as one tensor), never re-bound.
    c = {k: c[k].clone() for k in CARRY}
    go = condition(c).clone()

    def iterate():
        new = iteration(c)
        for k in CARRY:
            c[k].copy_(new[k])
        go.copy_(condition(c))

    loop(LSQRLoop(go=go, carry=c, iterate=iterate, max_iter=int(max_iter)))
    return finish(c["x"], c["it"] - 1, c["r"], c["misfit"])
