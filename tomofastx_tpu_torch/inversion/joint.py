"""Joint inversion system: operator stack + per-major-iteration solve.

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

from tomofastx_tpu_torch.inversion import operators as ops
from tomofastx_tpu_torch.ops import wavelet as W
from tomofastx_tpu_torch.ops.graph_while import WhileGraph, while_graph_launch
from tomofastx_tpu_torch.ops.lsqr import lsqr_solve
from tomofastx_tpu_torch.utils.trace import count, fine, span


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
    with fine("wavelet.forward"):
        return W.forward_wavelet_flat(
            seg.reshape(spec.ncomp, spec.N), spec.nx, spec.ny, spec.nz, spec.compression_type
        ).reshape(-1)


def _from_solver(spec: SystemSpec, seg):
    if spec.compression_type == 0:
        return seg
    with fine("wavelet.inverse"):
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

    # Each block's share of the products is marked `block.<kind>.<matvec|rmatvec>`
    # and the stored or matrix-free products `sensit.<matvec|rmatvec>` (utils/trace.py).
    def sensit_matvec(segs):
        parts = []
        for a, i in enumerate(spec.active):
            xw = _to_solver(spec, segs[a].reshape(-1)) if wconv else segs[a].reshape(-1)
            with fine("sensit.matvec"):
                parts.append(S[a].matvec(xw))
        return parts

    def matvec(x):
        segs = split_x(x)
        parts = sensit_matvec(segs)
        for a, i in enumerate(spec.active):
            if a in damping_ops:
                with fine("block.damping.matvec"):
                    parts.append(damping_ops[a].matvec(segs[a]))
            if a in dampgrad_ops:
                with fine("block.damping_gradient.matvec"):
                    for (k, d, op) in dampgrad_ops[a]:
                        parts.append(op.matvec(segs[a][k].reshape(cube_shape)))
        for a, i in enumerate(spec.active):
            if a in admm_ops:
                with fine("block.admm.matvec"):
                    parts.append(admm_ops[a].matvec(segs[a][spec.admm_comp : spec.admm_comp + 1]))
        if xgrad_op is not None:
            with fine("block.cross_gradient.matvec"):
                parts.append(xgrad_op.matvec(segs[0][0].reshape(cube_shape), segs[1][0].reshape(cube_shape)))
        if clustering_ops:
            with fine("block.clustering.matvec"):
                for t, op in clustering_ops.items():
                    parts.append(op.dcoef * segs[t][0])
        return torch.cat(parts)

    def rmatvec(u):
        out = []
        pos = 0
        for a, i in enumerate(spec.active):
            rows = spec.ndata_rows[a]
            with fine("sensit.rmatvec"):
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
                with fine("block.damping.rmatvec"):
                    out[a] = out[a] + damping_ops[a].rmatvec(u[pos : pos + rows])
                pos += rows
            if a in dampgrad_ops:
                with fine("block.damping_gradient.rmatvec"):
                    for (k, d, op) in dampgrad_ops[a]:
                        rows = spec.N
                        out[a][k] += op.rmatvec(u[pos : pos + rows]).reshape(-1)
                        pos += rows
        for a, i in enumerate(spec.active):
            if a in admm_ops:
                rows = spec.N
                with fine("block.admm.rmatvec"):
                    contrib = admm_ops[a].rmatvec(u[pos : pos + rows])
                    out[a][spec.admm_comp] += contrib.reshape(-1)
                pos += rows
        if xgrad_op is not None:
            rows = 3 * spec.N
            with fine("block.cross_gradient.rmatvec"):
                g1, g2 = xgrad_op.rmatvec(u[pos : pos + rows])
                out[0][0] += g1.reshape(-1)
                out[1][0] += g2.reshape(-1)
            pos += rows
        if clustering_ops:
            with fine("block.clustering.rmatvec"):
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


# =============================================================================
# The fused major loop: counterpart of the JAX package's make_fused_solver
# (tomofastx_tpu/inversion/joint.py:421-595), whose lax.scan becomes one
# CUDA graph a major, launched once a major, and whose LSQR lax.while_loop
# becomes a WHILE node of that graph.
# =============================================================================

# The entries of the solver's dictionary that a major advances: its carry.
CARRY_KEYS = ("model", "admm_z", "admm_u", "rho_admm")


def tree_map(fn, *trees):
    """fn over the leaves of nested dicts, tuples and lists of one structure
    (the first tree's), returning the same structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


def capture_unit(arr) -> Tuple[str, str]:
    """How the fused loop runs a major over arr's operators, and why:
    ("graph", ...) one CUDA graph a major, LSQR as a WHILE node; ("step", ...) the same
    device-resident step launched eagerly (over an operator that says
    graph_capturable is false, or whose mesh spans several devices);
    ("cpu", ...) eager steps on the CPU. The per-cell and lattice
    matrix-free operators say so per instance: capturable on the card, where
    their products are the few launches of kernels B2 and B3, and not where
    their tensors lie on the CPU (their plain chunk loops)."""
    if arr["cw"][0].device.type != "cuda":
        return "cpu", "eager steps on the CPU"
    for op in [op for key in ("S", "S_fwd") for op in arr.get(key, ()) if op is not None]:
        mesh = getattr(op, "mesh", None)
        if mesh is not None and mesh.n_devices > 1:
            return "step", f"the device-resident step without a graph ({type(op).__name__} over {mesh.n_devices} devices)"
        if not getattr(op, "graph_capturable", True):
            return "step", f"the device-resident step without a graph ({type(op).__name__}: not capturable)"
    return "graph", "one CUDA graph a major, LSQR as a WHILE node"


class FusedSolver:
    """n_steps full major iterations with no read of the device: residuals,
    the solve, the model update, the forward data of the new model, the
    per-major costs and the dynamic ADMM weight
    (problem_joint_gravmag.F90:473-547). Built by make_fused_solver.

    solver(arrays) takes the per-major solve's dictionary of tensors plus,
    per active problem, "val_meas" and "data_weight" ((nd, ndc) observed
    data and 1/sigma weights); "S_fwd" under spec.refine_forward; and
    optionally "active_steps", an int k <= n_steps: steps from k on are
    masked and advance no state. It returns the final "model", "admm_z",
    "admm_u", "rho_admm", "extras", "final_d_calc", "final_cost_data" and
    "final_cost_model", and "per_iteration": one row a step of
    "pre_cost_data", "pre_cost_model", "post_cost_data", "costs", "rho" and
    "lsqr_iters" (n_steps rows; a masked step's row holds its frozen state's
    costs and 0 iterations on the CPU, zeros on a CUDA device, which runs no
    masked step).

    On the CPU every step runs eagerly, with the JAX package's masking. On
    a CUDA device the carry (models, ADMM z and u, rho, the forward data,
    the coupling fields) and every input tensor live in buffers of the
    solver. The first call runs one eager warm-up step on a side stream, on
    scratch copies of the carry, its LSQR for one iteration in the split
    form (_warm_up: it loads the kernels' libraries, makes the cuBLAS
    handles and cuFFT plans and allocates; nothing of that may happen inside
    a capture, and one iteration launches every kernel that any iteration
    does), then captures one whole major as three
    torch.cuda.CUDAGraphs in one memory pool: the head (the step up to
    LSQR's first products, with the split form's buffers and its first
    condition), the body (one LSQR iteration) and the tail (the rest of the
    step, its new carry copied into the buffers). ops/graph_while.py joins
    them into one CUDA graph whose LSQR loop is a WHILE node, which stops at
    the first exit test that holds, as the JAX package's lax.while_loop
    does. Each call launches that graph active_steps times, the step's row
    and the body's runs (`body_runs`) copied out after each launch. A later
    call copies its tensors into the same buffers and launches the same
    graph; it is captured again only when a tensor's shape, type or device,
    or an operator, changes. A failed capture raises: nothing runs the
    major eagerly, or unrolled, in its place. Over an operator that cannot
    be captured, and over operators spread across devices, the same step
    runs eagerly on the device (capture_unit), its LSQR unrolled. The
    kernels' launch counters count a captured launch once, at the capture:
    a major launches the head's and tail's launches once and the body's
    once a run.
    """

    def __init__(self, spec: SystemSpec, n_steps: int):
        self.spec, self.n_steps = spec, int(n_steps)
        self._solve_once = _build_solve_fn(spec)
        self._key = self._graph = self._static = self._carry = self._row = None
        self.captures = 0  # majors captured
        self.replays = 0  # majors run as a launch of the captured graph
        # Wall seconds of the captures (capture_s, each warm-up step in) and of
        # their warm-up steps (capture_warmup_s), summed over the captures;
        # last_capture: the pair of the last capture.
        self.timings = {}
        self.last_capture = None
        self.body_runs = None  # on a CUDA device: the LSQR body's runs in each major of the last call

    # ---- the step (tomofastx_tpu/inversion/joint.py:445-577, line for line) ----

    def _forward(self, arr, model):
        """d_calc per problem (model.F90:220-307). Under refine_forward the
        product goes through the exact-physics operator (model domain, no
        wavelet), in its own precision."""
        spec = self.spec
        ds = []
        for a, i in enumerate(spec.active):
            cw = arr["cw"][a][None, :]
            x = torch.where(cw != 0.0, model[a] / torch.where(cw != 0.0, cw, 1.0), 0.0)
            xw = x.reshape(-1)
            if spec.refine_forward:
                d = arr["S_fwd"][a].matvec(xw)
            else:
                if spec.compression_type > 0:
                    xw = _to_solver(spec, xw)
                d = arr["S"][a].matvec(xw)
            d = d.reshape(arr["val_meas"][a].shape)
            ds.append(d / spec.problem_weight[i] / arr["data_weight"][a])
        return tuple(ds)

    def _data_cost(self, arr, d_calc):
        """Relative data cost per problem (data_gravmag.f90:123-129)."""
        out = []
        for a in range(len(self.spec.active)):
            meas = arr["val_meas"][a]
            denom = torch.sqrt(torch.sum(meas**2))
            out.append(torch.where(
                denom != 0.0,
                torch.sqrt(torch.sum((d_calc[a] - meas) ** 2)) / torch.where(denom != 0.0, denom, 1.0),
                0.0,
            ))
        return tuple(out)

    def _model_cost(self, arr, model):
        """Lp model-prior cost per problem (costs.f90:74-113)."""
        out = []
        for a in range(len(self.spec.active)):
            cw = arr["cw"][a]
            diff = torch.where(cw != 0.0, (model[a][0] - arr["prior"][a][0]) / torch.where(cw != 0.0, cw, 1.0), 0.0)
            out.append(torch.sum(torch.abs(diff) ** self.spec.norm_power))
        return tuple(out)

    def _init_carry(self, arr):
        spec = self.spec
        dt, dev = arr["cw"][0].dtype, arr["cw"][0].device
        extras = {}
        if spec.cross_grad:
            extras["cross_grad_magnitude"] = torch.zeros((spec.N,), dtype=dt, device=dev)
        if spec.clustering:
            extras["clustering_probabilities"] = torch.zeros((spec.N,), dtype=dt, device=dev)
        # d_calc of the incoming model rides the carry: step k's post-update
        # forward is step k+1's pre-update one, one product a major.
        return {"model": tuple(arr["model"]), "admm_z": tuple(arr["admm_z"]), "admm_u": tuple(arr["admm_u"]),
                "rho_admm": arr["rho_admm"], "extras": extras, "d_calc": self._forward(arr, arr["model"])}

    def _step(self, arr, carry, s, n_active, lsqr_loop=None):
        """One major: (the new carry, this major's row). s and n_active are
        0-dim tensors; a step with s >= n_active returns the carry as it
        was. lsqr_loop: the runner of LSQR's split form (ops/lsqr.py), if
        any."""
        spec = self.spec
        active = s < n_active
        model, rho, d_calc = carry["model"], carry["rho_admm"], carry["d_calc"]
        # Pre-update costs: the "previous iteration" entries of the costs.txt
        # row (problem_joint_gravmag.F90:519-528).
        pre_cost_data = self._data_cost(arr, d_calc)
        pre_cost_model = self._model_cost(arr, model)
        # Cast to the solve dtype at the LSQR boundary: a float64 refinement
        # forward keeps a float64 residual up to here.
        residuals = tuple(
            (arr["data_weight"][a] * (arr["val_meas"][a] - d_calc[a])).reshape(-1).to(model[a].dtype)
            for a in range(len(spec.active))
        )
        arr2 = dict(arr)
        arr2.update(model=model, admm_z=carry["admm_z"], admm_u=carry["admm_u"], rho_admm=rho,
                    residuals=residuals, niter_cap=torch.where(active, spec.niter, 0))
        out = self._solve_once(arr2, lsqr_loop)
        model_new = tuple(m + d for m, d in zip(model, out["delta"]))

        # The post-update data cost drives the dynamic ADMM weight; rho
        # stays on the device.
        d_calc_new = self._forward(arr, model_new)
        post_cost_data = self._data_cost(arr, d_calc_new)
        rho_new = next_admm_weight(spec, rho, post_cost_data)

        row = {
            "pre_cost_data": torch.stack(pre_cost_data),
            "pre_cost_model": torch.stack(pre_cost_model),
            "post_cost_data": torch.stack(post_cost_data),
            "costs": out["costs"],
            "rho": rho.clone(),  # the weight the reference logs for this row (the carry's buffer moves on)
            "lsqr_iters": out["lsqr_iters"],
        }
        new = {"model": model_new, "admm_z": out["admm_z"], "admm_u": out["admm_u"], "rho_admm": rho_new,
               "extras": out["extras"] or carry["extras"], "d_calc": d_calc_new}
        # A masked step advances no state: the ADMM dual update and the rho
        # adjustment above ran all the same.
        return tree_map(lambda nw, old: torch.where(active, nw, old), new, carry), row

    def _result(self, arr, carry, per):
        return {
            "model": carry["model"], "admm_z": carry["admm_z"], "admm_u": carry["admm_u"],
            "rho_admm": carry["rho_admm"], "extras": carry["extras"], "per_iteration": per,
            "final_d_calc": carry["d_calc"],
            "final_cost_data": torch.stack(self._data_cost(arr, carry["d_calc"])),
            "final_cost_model": torch.stack(self._model_cost(arr, carry["model"])),
        }

    # ---- the three ways to run it ----

    def __call__(self, arrays: Dict) -> Dict:
        arr = dict(arrays)
        n_active = int(arr.pop("active_steps", self.n_steps))
        if not 0 <= n_active <= self.n_steps:
            raise ValueError(f"active_steps = {n_active} outside 0..{self.n_steps}")
        with torch.no_grad():
            unit, _ = capture_unit(arr)
            if unit == "graph":
                return self._run_graph(arr, n_active)
            return self._run_eager(arr, n_active, all_steps=unit == "cpu")

    def _run_eager(self, arr, n_active, all_steps):
        """Step after step, launched from the host. all_steps runs the masked
        steps too (the JAX package's scan), else only the first n_active."""
        carry = self._init_carry(arr)
        dev = carry["rho_admm"].device
        n_act = torch.tensor(n_active, device=dev)
        self.body_runs = None
        rows = []
        for s in range(self.n_steps if all_steps else max(n_active, 1)):
            carry, row = self._step(arr, carry, torch.tensor(s, device=dev), n_act)
            rows.append(row)
        rows += [tree_map(torch.zeros_like, rows[0])] * (self.n_steps - len(rows))
        per = tree_map(lambda *xs: torch.stack(xs), *rows)
        return self._result(arr, carry, per)

    def _key_of(self, static, carry0):
        def sig(x):
            return (tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor) else id(x)

        return tuple(static), tuple(sig(x) for x in _leaves(static)), tuple(sig(x) for x in _leaves(carry0))

    def _capture(self, static, carry0, key):
        """Buffers for every input tensor and the carry, the warm-up step
        (_warm_up: one LSQR iteration) on a side stream, then the capture of
        one major. Timed as `capture` and, its warm-up step ended by a wait
        for the side stream, `capture_warmup`."""
        with span("capture", self.timings) as whole:
            self._release()  # the old graph and its pool go first
            self._static = tree_map(_clone, static)
            self._carry = tree_map(torch.clone, self._init_carry({**self._static, **carry0}))
            dev = self._carry["rho_admm"].device
            self._s = torch.zeros((), dtype=torch.int64, device=dev)
            self._n_active = torch.full((), self.n_steps, dtype=torch.int64, device=dev)
            self._runs = torch.zeros((), dtype=torch.int32, device=dev)
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with span("capture_warmup", self.timings, stream.synchronize) as warmup, torch.cuda.stream(stream):
                self._warm_up(self._static, self._carry)
            torch.cuda.current_stream(dev).wait_stream(stream)
            self._graph, self._row = self._capture_graph(stream)
            torch.cuda.synchronize(dev)
            self._key = key
            self.captures += 1
        self.last_capture = (whole.seconds, warmup.seconds)

    def _warm_up(self, static, carry):
        """One eager step on scratch copies of the carry before a capture,
        its LSQR in the split form for one iteration: the head, one body
        iteration and the tail, the code that _capture_graph records, in the
        same order. Every iteration launches the same kernels (the exit tests
        are selects, not branches), so one iteration makes every first use
        that may not happen inside a capture. Its outputs are thrown away.
        Counts the iterations it ran as `capture_warmup_iters`."""

        def one_iteration(loop):
            # Unconditional, as the capture records the body: nothing reads the device.
            loop.iterate()
            count("capture_warmup_iters")

        dev = carry["rho_admm"].device
        s = torch.zeros((), dtype=torch.int64, device=dev)
        n_active = torch.full((), self.n_steps, dtype=torch.int64, device=dev)
        self._step(static, tree_map(torch.clone, carry), s, n_active, lsqr_loop=one_iteration)

    def _release(self):
        self._key = self._row = None
        if self._graph is not None:
            self._graph.close()
        self._graph = None

    def _capture_graph(self, stream):
        """One major, captured on `stream` as head, body and tail graphs in
        one pool (the step on the buffers, its new carry copied into them
        and the step index advanced) and joined into a WhileGraph. Returns
        (the graph, the step's row)."""
        pool = torch.cuda.graph_pool_handle()
        head, body, tail = (torch.cuda.CUDAGraph(keep_graph=True) for _ in range(3))
        kept = {}
        capturing = [head]

        def lsqr_loop(loop):
            # Ends the head with the loop's first condition and the body
            # counter zeroed, captures one iteration, begins the tail.
            self._runs.zero_()
            head.capture_end()
            capturing.pop()
            kept["loop"] = loop  # the carry's buffers and what the body reads, kept with the graph
            capturing.append(body)
            self._capture_body(body, pool, loop)
            capturing.pop()
            tail.capture_begin(pool=pool)
            capturing.append(tail)

        with torch.cuda.stream(stream):
            head.capture_begin(pool=pool)
            try:
                new, row = self._step(self._static, self._carry, self._s, self._n_active, lsqr_loop=lsqr_loop)
                if "loop" not in kept:
                    raise RuntimeError("the fused step ran no LSQR loop to capture")
                tree_map(_copy_into, self._carry, new)
                self._s.add_(1)
            except BaseException:
                for graph in capturing:  # end the open capture; the first error is the one to raise
                    try:
                        graph.capture_end()
                    except Exception:
                        pass
                raise
            tail.capture_end()
        loop = kept["loop"]
        return WhileGraph(head, body, tail, loop.go, self._runs, loop.max_iter, keep=(loop, new, row)), row

    def _capture_body(self, body, pool, loop):
        """The WHILE node's body: one LSQR iteration on the carry's buffers."""
        body.capture_begin(pool=pool)
        loop.iterate()
        body.capture_end()

    def _launch(self):
        """One major: one launch of the captured graph."""
        while_graph_launch(self._graph)

    def _run_graph(self, arr, n_active):
        static = {k: v for k, v in arr.items() if k not in CARRY_KEYS}
        carry0 = {k: arr[k] for k in CARRY_KEYS}
        key = self._key_of(static, carry0)
        if key != self._key:
            self._capture(static, carry0, key)
        else:
            tree_map(_copy_into, self._static, static)
            tree_map(_copy_into, self._carry, self._init_carry({**self._static, **carry0}))
        self._s.zero_()
        self._n_active.fill_(n_active)
        per = tree_map(lambda t: t.new_zeros((self.n_steps,) + tuple(t.shape)), self._row)
        self.body_runs = torch.zeros((self.n_steps,), dtype=torch.int32, device=self._runs.device)
        for k in range(n_active):
            self._launch()
            self.replays += 1
            tree_map(lambda dst, src: dst[k].copy_(src), per, self._row)
            self.body_runs[k].copy_(self._runs)
        return self._result(self._static, tree_map(torch.clone, self._carry), per)


def make_fused_solver(spec: SystemSpec, n_steps: int) -> FusedSolver:
    """The fused major loop of n_steps majors (FusedSolver): the JAX
    package's make_fused_solver, on the port's devices."""
    return FusedSolver(spec, n_steps)
