"""Joint inversion system: operator stack + per-major-iteration solve.

Counterpart of t_joint_inversion (joint_inverse_problem.F90). Instead of
assembling CSR constraint rows each major iteration, the per-iteration solve
— ADMM dual updates, constraint linearization, LSQR with the sensitivity
operator's matvecs, wavelet conversions, and the final un-weighting of the
model update — is one function of a dictionary of tensors.

Row-block order of the stacked system (norms are order-independent; this
fixes the layout): [data blocks per active problem] then per active problem
[damping (ncomp*N rows)], then ADMM blocks (N rows each). The gradient,
cross-gradient and clustering blocks are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from tomofastx_tpu_torch.inversion import operators as ops
from tomofastx_tpu_torch.ops import wavelet as W
from tomofastx_tpu_torch.ops.lsqr import lsqr_solve


@dataclass(frozen=True)
class SystemSpec:
    """Static description of the joint system."""

    active: Tuple[int, ...]  # active problem indices (subset of (0, 1))
    ncomp: int
    nx: int
    ny: int
    nz: int
    ndata_rows: Tuple[int, ...]  # ndata * ndata_components per active problem
    compression_type: int
    wavelet_domain: bool
    problem_weight: Tuple[float, float]
    alpha: Tuple[float, float]
    norm_power: float
    add_damping: Tuple[bool, bool]
    admm_enabled: Tuple[bool, bool]
    nlithos: int
    apply_local_damping_weight: bool
    niter: int
    rmin: float
    gamma: float
    target_misfit: float

    @property
    def N(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def seg_size(self) -> int:
        return self.ncomp * self.N

    @property
    def admm_comp(self) -> int:
        # Bounds act on Mz for magnetization-vector models
        # (joint_inverse_problem.F90:499-506).
        return 2 if self.ncomp == 3 else 0


def decide_wavelet_domain(ipar) -> bool:
    """Solve for the update in wavelet coordinates only when no constraint
    needs model-space rows (reference: joint_inverse_problem.F90:189-200).
    Takes an InversionParams."""
    if ipar.cross_grad_weight != 0.0:
        return False
    if ipar.clustering_weight_glob[0] != 0.0 or ipar.clustering_weight_glob[1] != 0.0:
        return False
    if any(b != 0.0 and pw != 0.0 for b, pw in zip(ipar.beta, ipar.problem_weight)):
        return False
    if ipar.norm_power != 2.0:
        return False
    if ipar.admm_bound_type != 1:
        return False
    if ipar.apply_local_damping_weight > 0:
        return False
    return True


def admm_iterate(z, u, x, min_bound, max_bound):
    """ADMM scaled-dual iteration (reference: admm_method.F90:70-134):
    z = Pc(x + u) projecting onto the nearest of the disjoint intervals,
    u += x - z; returns (z, u, x0 = z - u).

    min_bound/max_bound: (L, N); candidate scan order (min_j, max_j, j=1..L)
    with first-minimum tie-breaking matches the reference's strict-< scan
    (torch.argmin returns the first of equal minima)."""
    arg = x + u
    inside = torch.any((min_bound <= arg[None, :]) & (arg[None, :] <= max_bound), dim=0)
    # Interleave candidates in reference scan order: min1, max1, min2, max2...
    cand = torch.stack([min_bound, max_bound], dim=1).reshape(-1, arg.shape[0])
    dist = torch.abs(cand - arg[None, :])
    closest = cand.gather(0, torch.argmin(dist, dim=0)[None, :])[0]
    z_new = torch.where(inside, arg, closest)
    u_new = u + x - z_new
    return z_new, u_new, z_new - u_new


def _to_solver(spec: SystemSpec, seg):
    """Scaled-model flat segment (ncomp*N,) -> matrix column (wavelet) domain."""
    if spec.compression_type == 0:
        return seg
    return W.forward_wavelet_flat(
        seg.reshape(spec.ncomp, spec.N), spec.nx, spec.ny, spec.nz, spec.compression_type
    ).reshape(-1)


def _from_solver(spec: SystemSpec, seg):
    if spec.compression_type == 0:
        return seg
    return W.inverse_wavelet_flat(
        seg.reshape(spec.ncomp, spec.N), spec.nx, spec.ny, spec.nz, spec.compression_type
    ).reshape(-1)


def _build_solve_fn(spec: SystemSpec):
    """Build the per-major-iteration solve function."""

    nseg = len(spec.active)
    seg = spec.seg_size
    offsets = [a * seg for a in range(nseg)]
    ncols = nseg * seg
    wconv = spec.compression_type > 0 and not spec.wavelet_domain

    def solve_once(arr: Dict):
        S = arr["S"]  # tuple per active problem: operators with matvec/rmatvec
        cw = arr["cw"]  # tuple (N,)

        costs = {}

        # ---------------- ADMM dual update + x0 ----------------
        new_z, new_u = [], []
        admm_x0 = []
        for a, i in enumerate(spec.active):
            if spec.admm_enabled[i]:
                x_comp = arr["model"][a][spec.admm_comp]
                z, u, x0 = admm_iterate(
                    arr["admm_z"][a], arr["admm_u"][a], x_comp,
                    arr["min_bound"][a], arr["max_bound"][a],
                )
                new_z.append(z)
                new_u.append(u)
                admm_x0.append(x0)
                # ADMM cost |x - z| / |z| (joint_inverse_problem.F90:522-525,
                # costs.f90: cost(arr1=z, arr2=x)).
                denom = torch.sum(z**2)
                costs[f"admm_cost_{i}"] = torch.where(
                    denom != 0.0,
                    torch.sqrt(torch.sum((z - x_comp) ** 2) / torch.where(denom != 0.0, denom, 1.0)),
                    0.0,
                )
            else:
                new_z.append(arr["admm_z"][a])
                new_u.append(arr["admm_u"][a])
                admm_x0.append(None)
                costs[f"admm_cost_{i}"] = torch.zeros((), dtype=cw[a].dtype, device=cw[a].device)

        # ---------------- constraint blocks ----------------
        damping_ops = {}
        admm_ops = {}

        for a, i in enumerate(spec.active):
            if spec.add_damping[i]:
                lw = arr["damping_weight"][a] if spec.apply_local_damping_weight else None
                damping_ops[a] = ops.make_damping(
                    spec.alpha[i], spec.problem_weight[i], spec.norm_power,
                    arr["model"][a], arr["prior"][a], cw[a], lw,
                    spec.wavelet_domain, spec.compression_type,
                    spec.nx, spec.ny, spec.nz,
                )
                costs[f"damping_cost_{i}"] = damping_ops[a].cost

            if spec.admm_enabled[i]:
                # ADMM quadratic term via the damping machinery with
                # alpha = rho_ADMM, norm 2, local weight = bound_weight
                # (joint_inverse_problem.F90:509-520). rho changes between
                # major iterations, so it comes with the tensors.
                rho = arr["rho_admm"][i]
                cwk = cw[a]
                diff = torch.where(
                    cwk != 0.0,
                    (arr["model"][a][spec.admm_comp] - admm_x0[a]) / torch.where(cwk != 0.0, cwk, 1.0),
                    0.0,
                )
                if spec.compression_type > 0 and spec.wavelet_domain:
                    diff = W.forward_wavelet_flat(diff, spec.nx, spec.ny, spec.nz, spec.compression_type)
                base = rho * spec.problem_weight[i]
                bw = arr["bound_weight"][a]
                admm_ops[a] = ops.DampingOp(
                    dcoef=(base * bw)[None, :],
                    rhs=(-base * diff * bw)[None, :],
                    cost=torch.zeros((), dtype=cwk.dtype, device=cwk.device),
                )

        # ---------------- right-hand side ----------------
        b_parts = []
        for a, i in enumerate(spec.active):
            b_parts.append(spec.problem_weight[i] * arr["residuals"][a].reshape(-1))
        for a, i in enumerate(spec.active):
            if a in damping_ops:
                b_parts.append(damping_ops[a].rhs.reshape(-1))
        for a, i in enumerate(spec.active):
            if a in admm_ops:
                b_parts.append(admm_ops[a].rhs.reshape(-1))
        b = torch.cat(b_parts)

        ndata_total = sum(spec.ndata_rows)

        # ---------------- operator closures ----------------
        def split_x(x):
            return [x[off : off + seg].reshape(spec.ncomp, spec.N) for off in offsets]

        def sensit_matvec(segs):
            parts = []
            for a, i in enumerate(spec.active):
                xw = _to_solver(spec, segs[a].reshape(-1)) if wconv else segs[a].reshape(-1)
                parts.append(S[a].matvec(xw))
            return parts

        def matvec(x):
            segs = split_x(x)
            parts = sensit_matvec(segs)
            for a, i in enumerate(spec.active):
                if a in damping_ops:
                    parts.append(damping_ops[a].matvec(segs[a]))
            for a, i in enumerate(spec.active):
                if a in admm_ops:
                    parts.append(admm_ops[a].matvec(segs[a][spec.admm_comp : spec.admm_comp + 1]))
            return torch.cat(parts)

        def rmatvec(u):
            out = []
            pos = 0
            for a, i in enumerate(spec.active):
                rows = spec.ndata_rows[a]
                g = S[a].rmatvec(u[pos : pos + rows])
                if wconv:
                    g = _from_solver(spec, g)
                # A fresh tensor per problem: the blocks below add into it.
                out.append(g.reshape(spec.ncomp, spec.N).clone())
                pos += rows
            for a, i in enumerate(spec.active):
                if a in damping_ops:
                    rows = spec.ncomp * spec.N
                    out[a] = out[a] + damping_ops[a].rmatvec(u[pos : pos + rows])
                    pos += rows
            for a, i in enumerate(spec.active):
                if a in admm_ops:
                    rows = spec.N
                    contrib = admm_ops[a].rmatvec(u[pos : pos + rows])
                    out[a][spec.admm_comp] += contrib.reshape(-1)
                    pos += rows
            return torch.cat([o.reshape(-1) for o in out])

        # Data misfit early-exit check (lsqr_solver2.F90:168-189).
        b0_data = b[:ndata_total]

        def misfit_fn(x):
            Sx = torch.cat(sensit_matvec(split_x(x)))
            return torch.sqrt(torch.sum((Sx - b0_data) ** 2) / ndata_total)

        # ---------------- LSQR ----------------
        res = lsqr_solve(
            matvec, rmatvec, b, ncols,
            niter=spec.niter,
            rmin=spec.rmin, gamma=spec.gamma,
            target_misfit=spec.target_misfit,
            misfit_fn=misfit_fn if spec.target_misfit > 0.0 else None,
        )

        # ---------------- convert update to model space ----------------
        deltas = []
        for a, i in enumerate(spec.active):
            d = res.x[offsets[a] : offsets[a] + seg]
            if spec.compression_type > 0 and spec.wavelet_domain:
                d = _from_solver(spec, d)
            d = d.reshape(spec.ncomp, spec.N) * cw[a][None, :]  # rescale_model
            deltas.append(d)

        return {
            "delta": tuple(deltas),
            "costs": costs,
            "admm_z": tuple(new_z),
            "admm_u": tuple(new_u),
            "lsqr_iters": res.iters,
            "lsqr_r": res.r,
        }

    return solve_once


def make_solver(spec: SystemSpec):
    """Per-major-iteration solve: solve(arrays) -> dict with delta models,
    costs, new ADMM state and LSQR stats. Runs eagerly, without gradients."""
    return torch.no_grad()(_build_solve_fn(spec))
