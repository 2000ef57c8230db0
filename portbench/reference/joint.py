"""Frozen copy of the program's inversion/joint.py for the benchmark's reference
(later changes to the program do not reach it): the host-driven major's
solve, as it was; the fused loop left out.

Joint inversion system: operator stack + per-major-iteration solve.

Counterpart of t_joint_inversion (joint_inverse_problem.F90). Instead of
assembling CSR constraint rows each major iteration, the per-iteration solve
— ADMM dual updates, constraint linearization, LSQR with the sensitivity
operator's matvecs, wavelet conversions, and the final un-weighting of the
model update — is one function of a dictionary of tensors.

make_fused_solver runs several whole major iterations with no read of the
device in between: on a CUDA device one major is one CUDA graph, launched
once a major, whose LSQR loop is a WHILE node (ops/graph_while.py).

Row-block order of the stacked system (norms are order-independent; this
fixes the layout): [data blocks per active problem] then per active problem
[damping (ncomp*N rows), damping-gradient (3*ncomp*N rows)], then ADMM
blocks (N rows each), then cross-gradient (3N), then clustering (N per
problem).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from portbench.reference import operators as ops
from portbench.reference import wavelet as W
from portbench.reference.lsqr import lsqr_solve


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
    beta: Tuple[float, float]
    add_damping_gradient: Tuple[bool, bool]
    admm_enabled: Tuple[bool, bool]
    nlithos: int
    cross_grad: bool
    cross_grad_weight: float
    der_type: int
    keep_model_constant: Tuple[int, int]
    vec_field_type: int
    clustering: bool
    clustering_weight_glob: Tuple[float, float]
    clustering_opt_type: int
    apply_local_damping_weight: bool
    niter: int
    rmin: float
    gamma: float
    target_misfit: float
    # Dynamic ADMM weight adjustment (next_admm_weight).
    admm_cost_threshold: float = 1.0e-4
    admm_weight_multiplier: float = 1.0
    admm_max_weight: float = 1.0e10
    # Iterative refinement (tpu.refineForward): the fused loop's predicted
    # data go through the exact-physics operators of arrays["S_fwd"] (model
    # domain, weights baked) while LSQR keeps the stored kernel.
    refine_forward: bool = False

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


class System(NamedTuple):
    """One major iteration's linearised system: its right-hand side, its
    products, and what the assembly computed on the way. `blocks` holds the
    constraint operators by kind ("damping", "damping_gradient", "admm",
    "cross_gradient", "clustering"), for whoever times them one by one."""

    b: torch.Tensor
    matvec: Callable
    rmatvec: Callable
    misfit_fn: Callable
    costs: Dict
    extras: Dict
    admm_z: Tuple
    admm_u: Tuple
    blocks: Dict


def assemble_system(spec: SystemSpec, arr: Dict) -> System:
    """ADMM dual update, constraint linearisation and the stacked operator
    of one major iteration (everything of the solve before LSQR)."""
    nseg = len(spec.active)
    seg = spec.seg_size
    offsets = [a * seg for a in range(nseg)]
    cube_shape = (spec.nz, spec.ny, spec.nx)
    wconv = spec.compression_type > 0 and not spec.wavelet_domain

    S = arr["S"]  # tuple per active problem: operators with matvec/rmatvec
    cw = arr["cw"]  # tuple (N,)

    costs = {}
    extras = {}

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
    dampgrad_ops = {}
    admm_ops = {}
    xgrad_op = None
    clustering_ops = {}
    if spec.cross_grad or any(spec.add_damping_gradient):
        dXdYdZ = (arr["dX"], arr["dY"], arr["dZ"])

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

        if spec.add_damping_gradient[i]:
            per_dir = []
            for k in range(spec.ncomp):
                for direction in (1, 2, 3):
                    op = ops.make_damping_gradient(
                        spec.beta[i], spec.problem_weight[i],
                        arr["model"][a][k], cw[a],
                        arr["damping_grad_weight"][a][direction - 1],
                        *dXdYdZ, spec.nx, spec.ny, spec.nz, direction,
                    )
                    per_dir.append((k, direction, op))
            dampgrad_ops[a] = per_dir
            # Sum cost over components per direction
            # (joint_inverse_problem.F90:483-486).
            for direction in (1, 2, 3):
                costs[f"damping_gradient_cost_{'xyz'[direction - 1]}_{i}"] = sum(
                    op.cost for (k, d, op) in per_dir if d == direction
                )

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

    if spec.cross_grad:
        a1, a2 = 0, 1  # requires both problems active
        xgrad_op = ops.make_cross_gradient(
            arr["model"][a1][0], arr["model"][a2][0], cw[a1], cw[a2],
            spec.cross_grad_weight, spec.der_type, spec.keep_model_constant,
            arr.get("vec_field"), spec.vec_field_type,
            *dXdYdZ, spec.nx, spec.ny, spec.nz,
        )
        costs["cross_grad_cost"] = xgrad_op.cost
        extras["cross_grad_magnitude"] = xgrad_op.magnitude

    if spec.clustering:
        for t in range(2):
            op = ops.make_clustering(
                arr["model"][0][0], arr["model"][1][0],
                cw[0], cw[1],
                spec.clustering_weight_glob,
                arr["mixture_mu"], arr["mixture_sigma"],
                arr["cell_weight"], arr["mixture_max"],
                spec.clustering_opt_type, t,
            )
            clustering_ops[t] = op
            costs[f"clustering_cost_{t}"] = op.cost
        extras["clustering_probabilities"] = clustering_ops[0].probabilities

    # ---------------- right-hand side ----------------
    b_parts = []
    for a, i in enumerate(spec.active):
        b_parts.append(spec.problem_weight[i] * arr["residuals"][a].reshape(-1))
    for a, i in enumerate(spec.active):
        if a in damping_ops:
            b_parts.append(damping_ops[a].rhs.reshape(-1))
        if a in dampgrad_ops:
            for (_, _, op) in dampgrad_ops[a]:
                b_parts.append(op.rhs)
    for a, i in enumerate(spec.active):
        if a in admm_ops:
            b_parts.append(admm_ops[a].rhs.reshape(-1))
    if xgrad_op is not None:
        b_parts.append(xgrad_op.rhs.reshape(-1))
    for t, op in clustering_ops.items():
        b_parts.append(op.rhs)
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
            if a in dampgrad_ops:
                for (k, d, op) in dampgrad_ops[a]:
                    parts.append(op.matvec(segs[a][k].reshape(cube_shape)))
        for a, i in enumerate(spec.active):
            if a in admm_ops:
                parts.append(admm_ops[a].matvec(segs[a][spec.admm_comp : spec.admm_comp + 1]))
        if xgrad_op is not None:
            parts.append(xgrad_op.matvec(segs[0][0].reshape(cube_shape), segs[1][0].reshape(cube_shape)))
        for t, op in clustering_ops.items():
            parts.append(op.dcoef * segs[t][0])
        return torch.cat(parts)

    def rmatvec(u):
        out = []
        pos = 0
        for a, i in enumerate(spec.active):
            rows = spec.ndata_rows[a]
            g = S[a].rmatvec(u[pos : pos + rows])
            if wconv:
                g = _from_solver(spec, g)
            # A fresh tensor per problem: the blocks below add into it, and
            # the operator's output must not see those adds.
            out.append(g.reshape(spec.ncomp, spec.N).clone())
            pos += rows
        for a, i in enumerate(spec.active):
            if a in damping_ops:
                rows = spec.ncomp * spec.N
                out[a] = out[a] + damping_ops[a].rmatvec(u[pos : pos + rows])
                pos += rows
            if a in dampgrad_ops:
                for (k, d, op) in dampgrad_ops[a]:
                    rows = spec.N
                    out[a][k] += op.rmatvec(u[pos : pos + rows]).reshape(-1)
                    pos += rows
        for a, i in enumerate(spec.active):
            if a in admm_ops:
                rows = spec.N
                contrib = admm_ops[a].rmatvec(u[pos : pos + rows])
                out[a][spec.admm_comp] += contrib.reshape(-1)
                pos += rows
        if xgrad_op is not None:
            rows = 3 * spec.N
            g1, g2 = xgrad_op.rmatvec(u[pos : pos + rows])
            out[0][0] += g1.reshape(-1)
            out[1][0] += g2.reshape(-1)
            pos += rows
        for t, op in clustering_ops.items():
            rows = spec.N
            out[t][0] += op.dcoef * u[pos : pos + rows]
            pos += rows
        return torch.cat([o.reshape(-1) for o in out])

    # Data misfit early-exit check (lsqr_solver2.F90:168-189).
    b0_data = b[:ndata_total]

    def misfit_fn(x):
        Sx = torch.cat(sensit_matvec(split_x(x)))
        return torch.sqrt(torch.sum((Sx - b0_data) ** 2) / ndata_total)

    blocks = {"damping": damping_ops, "damping_gradient": dampgrad_ops, "admm": admm_ops,
              "cross_gradient": xgrad_op, "clustering": clustering_ops}
    return System(b=b, matvec=matvec, rmatvec=rmatvec, misfit_fn=misfit_fn, costs=costs, extras=extras,
                  admm_z=tuple(new_z), admm_u=tuple(new_u), blocks=blocks)


def _build_solve_fn(spec: SystemSpec):
    """Build the per-major-iteration solve function."""

    seg = spec.seg_size
    ncols = len(spec.active) * seg

    def solve_once(arr: Dict, lsqr_loop=None):
        system = assemble_system(spec, arr)

        # ---------------- LSQR ----------------
        # "niter_cap" is the fused loop's bound on the device (0 on a masked
        # step): LSQR then runs without a read of the device, unrolled to
        # spec.niter iterations, or, given lsqr_loop, in its split form
        # driven by that runner. Without it, the host reads the exit tests
        # and stops early.
        res = lsqr_solve(
            system.matvec, system.rmatvec, system.b, ncols, arr.get("niter_cap", spec.niter),
            rmin=spec.rmin, gamma=spec.gamma, target_misfit=spec.target_misfit,
            misfit_fn=system.misfit_fn if spec.target_misfit > 0.0 else None, max_iter=spec.niter, loop=lsqr_loop,
        )

        # ---------------- convert update to model space ----------------
        deltas = []
        for a, i in enumerate(spec.active):
            d = res.x[a * seg : (a + 1) * seg]
            if spec.compression_type > 0 and spec.wavelet_domain:
                d = _from_solver(spec, d)
            d = d.reshape(spec.ncomp, spec.N) * arr["cw"][a][None, :]  # rescale_model
            deltas.append(d)

        return {
            "delta": tuple(deltas),
            "costs": system.costs,
            "admm_z": system.admm_z,
            "admm_u": system.admm_u,
            "lsqr_iters": res.iters,
            "lsqr_r": res.r,
            "extras": system.extras,
        }

    return solve_once


def make_solver(spec: SystemSpec):
    """Per-major-iteration solve: solve(arrays) -> dict with delta models,
    costs, new ADMM state, LSQR stats and output fields (extras). Runs
    eagerly, without gradients."""
    return torch.no_grad()(_build_solve_fn(spec))


def next_admm_weight(spec: SystemSpec, rho: torch.Tensor, post_cost_data) -> torch.Tensor:
    """The dynamic ADMM weight after a major (problem_joint_gravmag.F90:
    618-638): an ADMM problem's weight grows by admm_weight_multiplier while
    its post-update data cost is under admm_cost_threshold and the weight
    under admm_max_weight. rho is the (2,) weight tensor, post_cost_data the
    active problems' data costs (0-dim tensors); both loops decide it here,
    the host-driven one on float64 host tensors."""
    if spec.admm_weight_multiplier == 1.0:
        return rho
    rho_list = [rho[0], rho[1]]
    for a, i in enumerate(spec.active):
        if spec.admm_enabled[i]:
            grow = (post_cost_data[a] < spec.admm_cost_threshold) & (rho[i] < spec.admm_max_weight)
            rho_list[i] = torch.where(grow, spec.admm_weight_multiplier * rho[i], rho[i])
    return torch.stack(rho_list)
