"""The benchmark's reference: the whole inversion that a Parfile describes,
host-driven, with the kernels held dense, on plain tensors.

It follows the program's host-driven path (inversion/workflow.py) step by
step with the frozen copies beside this file: the depth weight, the
float64 corner-lattice rows times the column weight, the Haar transform and
threshold of each row, the problem weight, the synthetic data of the true
model, the starting model and its costs, then each major's ADMM update,
constraint blocks and LSQR (joint.py) and the model update, data and costs.
It imports nothing of the program and takes nothing the program made: the
grid, the survey and the true models come from the benchmark's generator.

In float64 (the default) it is the yardstick. With `store_dtype` and
`solve_dtype` bfloat16 it is the control that a comparison has to fail:
the inversion computed a precision below the configuration's float32.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import joint, physics
from portbench.reference.costs import costs as constraint_costs_of
from portbench.reference.operators import gaussian_mixture
from portbench.reference.parfile import GRAV, MAGN, read_parfile

ROW_BLOCK = 256  # rows of a bfloat16 kernel widened to the vectors' type at once


class DenseOperator:
    """S (rows, cols) held in `S.dtype`; products in the vectors' type."""

    def __init__(self, S):
        self.S = S

    def matvec(self, x):
        if self.S.dtype == x.dtype:
            return torch.mv(self.S, x)
        return torch.cat([torch.mv(self.S[s : s + ROW_BLOCK].to(x.dtype), x)
                          for s in range(0, self.S.shape[0], ROW_BLOCK)])

    def rmatvec(self, u):
        if self.S.dtype == u.dtype:
            return torch.mv(self.S.T, u)
        g = torch.zeros(self.S.shape[1], dtype=u.dtype, device=u.device)
        for s in range(0, self.S.shape[0], ROW_BLOCK):
            g += torch.mv(self.S[s : s + ROW_BLOCK].to(u.dtype).T, u[s : s + ROW_BLOCK])
        return g


def lattice_cells(edges):
    """Per-cell bounds (X1, X2, Y1, Y2, Z1, Z2), i fastest, of a lattice."""
    xe, ye, ze = (np.asarray(e, np.float64) for e in edges)
    k, j, i = np.meshgrid(np.arange(ze.size - 1), np.arange(ye.size - 1), np.arange(xe.size - 1), indexing="ij")
    i, j, k = i.reshape(-1), j.reshape(-1), k.reshape(-1)
    return xe[i], xe[i + 1], ye[j], ye[j + 1], ze[k], ze[k + 1]


def depth_weight(par, cells, points, device):
    """The column weight 1 / w of depth weighting type 2 (distance weighting,
    scaled by sqrt(cell volume) and normalized by its maximum)."""
    if par.depth_weighting_type != 2:
        raise NotImplementedError("the reference weights by distance (type 2) only")

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    w = physics._distance_weight(*(t(a) for a in cells), *(t(a) for a in points),
                                 par.depth_weighting_power, par.depth_weighting_beta).cpu().numpy()
    X1, X2, Y1, Y2, Z1, Z2 = cells
    w = w * np.sqrt(np.abs((X2 - X1) * (Y2 - Y1) * (Z2 - Z1)))
    w = w / w.max()
    return 1.0 / w


def build_kernel(par, edges, points, cw, size, store_dtype, device, batch=32):
    """The rows of every observation times the column weight, wavelet
    transformed and thresholded when compressed: (nd * ndc, nmc * N)."""
    nx, ny, nz = size
    N = nx * ny * nz
    nd, ndc, nmc = par.ndata, par.ndata_components, par.nmodel_components
    is_mag = par.is_magn
    magv = physics.dircos(par.mi, par.md, par.theta) if is_mag else (0.0, 0.0, 1.0)
    intensity = par.intensity if is_mag else 0.0
    f64 = dict(dtype=torch.float64, device=device)
    xe, ye, ze = (torch.as_tensor(np.asarray(e), **f64) for e in edges)
    xs, ys, zs = (torch.as_tensor(np.asarray(a), **f64) for a in points)
    cwt = torch.as_tensor(cw, **f64)
    keep = int(par.compression_rate * N) if par.compression_type > 0 else N
    S = torch.empty((nd * ndc, nmc * N), dtype=store_dtype, device=device)
    for s in range(0, nd, batch):
        e = min(s + batch, nd)
        rows = physics._lattice_closed_rows(xe, ye, ze, xs[s:e], ys[s:e], zs[s:e], "magn" if is_mag else "grav",
                                            par.data_type, magv, intensity, nmc, ndc)
        rows = (rows.reshape(-1, N, nmc, ndc) * cwt[:, None, None]).permute(0, 3, 2, 1)
        if par.compression_type > 0:
            comp = physics._compress_lines(rows, nx, ny, nz, par.compression_type, keep, store_dtype)[0]
        else:
            comp = rows.to(store_dtype)
        S[s * ndc : e * ndc] = comp.reshape((e - s) * ndc, nmc * N)
    return S


def calculate_data(op, m, cw, problem_weight, size, compression_type, dtype, device):
    """d = S (m / cw), through the wavelet when compressed, less the problem
    weight (the data weights are 1)."""
    x = torch.as_tensor(np.where(cw != 0.0, m / np.where(cw != 0.0, cw, 1.0), 0.0), dtype=dtype, device=device)
    if compression_type:
        x = physics.W.forward_wavelet_flat(x, *size, compression_type)
    return op.matvec(x.reshape(-1)).double().cpu().numpy() / problem_weight


def mixture_arrays(mixture, ipar, N):
    """The clustering mixture's arrays (global cell weights: constraintsType 1)."""
    table = np.asarray(mixture, np.float64)
    if ipar.clustering_constraints_type != 1:
        raise NotImplementedError("the reference takes the mixture's global weights only")
    mu = np.stack([table[:, 1], table[:, 3]])
    sigma = np.stack([table[:, 2], table[:, 4], table[:, 5]])
    cell_weight = np.repeat((table[:, 0] / table[:, 0].sum())[None, :], N, axis=0)
    weight_loc = tuple(1.0 if w != 0.0 else 0.0 for w in ipar.clustering_weight_glob)
    mu_t, sigma_t, cell_t = (torch.as_tensor(a, dtype=torch.float64) for a in (mu, sigma, cell_weight))
    maxima = [gaussian_mixture(torch.full((N,), float(mu[0, c]), dtype=torch.float64),
                               torch.full((N,), float(mu[1, c]), dtype=torch.float64),
                               mu_t, sigma_t, cell_t, weight_loc)[0].numpy() for c in range(table.shape[0])]
    return dict(mixture_mu=mu, mixture_sigma=sigma, cell_weight=cell_weight,
                mixture_max=np.max(np.stack(maxima), axis=0))


# The constraints' costs of a major, in the order of their columns in the
# program's costs.txt (6-7 and 10-20 of its 20, problem_joint_gravmag.F90:519-528).
CONSTRAINT_COLUMNS = ("admm.grav", "admm.magn") + tuple(
    f"damping_gradient.{d}.{p}" for p in ("grav", "magn") for d in "xyz") + tuple(
    f"cross_gradient.{d}" for d in "xyz") + ("clustering.grav", "clustering.magn")


def constraint_row(costs):
    """A major's constraint costs (the solver's `costs`) in CONSTRAINT_COLUMNS' order."""

    def get(key):
        return float(costs[key]) if key in costs else 0.0

    xg = np.zeros(3)
    if "cross_grad_cost" in costs:
        c = np.asarray(costs["cross_grad_cost"].cpu(), np.float64).reshape(-1)
        xg[: c.size] = c
    return ([get("admm_cost_0"), get("admm_cost_1")]
            + [get(f"damping_gradient_cost_{d}_{i}") for i in (0, 1) for d in "xyz"]
            + list(xg) + [get("clustering_cost_0"), get("clustering_cost_1")])


def invert(parfile, arrays, device="cuda", solve_dtype=torch.float64, store_dtype=torch.float64, mixture=None):
    """The inversion of `parfile` on the generator's `arrays` (edges, points,
    models). Returns, for each active problem, the synthetic data, the final
    model and its data, the post-update data cost of every major,
    `forward(i, m)`, the data of any model through the reference's kernel,
    `costs(models)`, the switched-on constraints' costs of any models, and
    `constraint_history`, each major's constraint costs as the program's
    costs.txt lays them out (CONSTRAINT_COLUMNS)."""
    device = torch.device(device)
    cfg = read_parfile(parfile)
    ipar = cfg.inversion
    active = [i for i in (GRAV, MAGN) if cfg.solve_problem(i)]
    size = (ipar.nx, ipar.ny, ipar.nz)
    N = int(np.prod(size))
    cells = lattice_cells(arrays["edges"])
    points = arrays["points"]

    def on_device(a):
        return torch.as_tensor(np.asarray(a), dtype=solve_dtype, device=device)

    cw, op, meas, calc, model, prior = {}, {}, {}, {}, {}, {}
    bounds = {}
    for i in active:
        par = cfg.problem_params(i)
        if par.kernel_format not in ("dense", "matrixfree") or par.use_data_error or not par.use_synthetic_model:
            raise NotImplementedError("the reference runs synthetic data with unit data weights")
        cw[i] = ipar.column_weight_multiplier[i] * depth_weight(par, cells, points, device)
        S = build_kernel(par, arrays["edges"], points, cw[i], size, store_dtype, device)
        S.mul_(torch.tensor(ipar.problem_weight[i], dtype=torch.float64).to(store_dtype))
        op[i] = DenseOperator(S)
        ct = par.compression_type
        meas[i] = calculate_data(op[i], arrays["models"][i], cw[i], ipar.problem_weight[i], size, ct, solve_dtype,
                                 device)
        prior[i] = np.full((1, N), par.prior_model_val * par.model_units_mult)
        model[i] = np.full((1, N), par.start_model_val * par.model_units_mult)
        calc[i] = calculate_data(op[i], model[i][0], cw[i], ipar.problem_weight[i], size, ct, solve_dtype, device)
        if ipar.admm_type > 0:
            b = np.asarray(ipar.admm_bounds[i], np.float64) * par.model_units_mult
            bounds[i] = (np.repeat(b[0::2, None], N, axis=1), np.repeat(b[1::2, None], N, axis=1), np.ones(N))
    synthetic = {i: meas[i].copy() for i in active}

    wavelet_domain = joint.decide_wavelet_domain(ipar) if ipar.compression_type > 0 else False
    spec = joint.SystemSpec(
        active=tuple(active), ncomp=ipar.nmodel_components, nx=size[0], ny=size[1], nz=size[2],
        ndata_rows=tuple(ipar.ndata[i] * ipar.ndata_components[i] for i in active),
        compression_type=ipar.compression_type, wavelet_domain=wavelet_domain,
        problem_weight=ipar.problem_weight, alpha=ipar.alpha, norm_power=ipar.norm_power,
        add_damping=tuple(ipar.alpha[i] != 0.0 and ipar.problem_weight[i] != 0.0 for i in (0, 1)),
        beta=ipar.beta,
        add_damping_gradient=tuple(ipar.beta[i] != 0.0 and ipar.problem_weight[i] != 0.0 for i in (0, 1)),
        admm_enabled=tuple(ipar.admm_type > 0 and ipar.problem_weight[i] != 0.0 for i in (0, 1)),
        nlithos=ipar.nlithos, cross_grad=ipar.cross_grad_weight != 0.0, cross_grad_weight=ipar.cross_grad_weight,
        der_type=ipar.derivative_type, keep_model_constant=ipar.keep_model_constant,
        vec_field_type=ipar.vec_field_type,
        clustering=(ipar.clustering_weight_glob[0] != 0.0 or ipar.clustering_weight_glob[1] != 0.0),
        clustering_weight_glob=ipar.clustering_weight_glob, clustering_opt_type=ipar.clustering_opt_type,
        apply_local_damping_weight=ipar.apply_local_damping_weight > 0, niter=ipar.niter, rmin=ipar.rmin,
        gamma=ipar.gamma, target_misfit=ipar.target_misfit, admm_cost_threshold=ipar.data_cost_threshold_ADMM,
        admm_weight_multiplier=ipar.weight_multiplier_ADMM, admm_max_weight=ipar.max_weight_ADMM,
    )
    if ipar.vec_field_type > 0 or ipar.damp_grad_weight_type > 1 or ipar.apply_local_damping_weight > 0:
        raise NotImplementedError("the reference takes no weight or field files")
    solver = joint.make_solver(spec)
    xe, ye, ze = (np.asarray(e, np.float64) for e in arrays["edges"])
    static = {
        "S": tuple(op[i] for i in active),
        "cw": tuple(on_device(cw[i]) for i in active),
        "dX": on_device(np.diff(xe)), "dY": on_device(np.diff(ye)), "dZ": on_device(np.diff(ze)),
    }
    if any(spec.add_damping_gradient[i] for i in active):
        static["damping_grad_weight"] = tuple(
            on_device(np.ones((3, N))) if spec.add_damping_gradient[i] else None for i in active)
    if spec.clustering:
        static.update({k: on_device(v) for k, v in mixture_arrays(mixture, ipar, N).items()})
    if any(spec.admm_enabled[i] for i in active):
        static["min_bound"] = tuple(on_device(bounds[i][0]) for i in active)
        static["max_bound"] = tuple(on_device(bounds[i][1]) for i in active)
        static["bound_weight"] = tuple(on_device(bounds[i][2]) for i in active)

    def data_cost(i):
        denom = np.linalg.norm(meas[i])
        return float(np.linalg.norm(calc[i] - meas[i]) / denom) if denom else 0.0

    admm_z = [torch.zeros((N if spec.admm_enabled[i] else 1,), dtype=solve_dtype, device=device) for i in active]
    admm_u = [torch.zeros_like(z) for z in admm_z]
    rho_admm = list(ipar.rho_ADMM)
    history, iters, constraint_history = [], [], []
    with torch.no_grad():
        for _ in range(ipar.ninversions):
            arr = dict(static)
            arr.update(
                model=tuple(on_device(model[i]) for i in active),
                prior=tuple(on_device(prior[i]) for i in active),
                residuals=tuple(on_device(meas[i] - calc[i]) for i in active),
                admm_z=tuple(admm_z), admm_u=tuple(admm_u), rho_admm=on_device(rho_admm),
            )
            out = solver(arr)
            constraint_history.append(constraint_row(out["costs"]))
            admm_z, admm_u = list(out["admm_z"]), list(out["admm_u"])
            iters.append(int(out["lsqr_iters"]))
            for a, i in enumerate(active):
                model[i] = model[i] + out["delta"][a].double().cpu().numpy().reshape(model[i].shape)
                calc[i] = calculate_data(op[i], model[i][0], cw[i], ipar.problem_weight[i], size,
                                         ipar.compression_type, solve_dtype, device)
            costs = [data_cost(i) if i in active else 0.0 for i in (0, 1)]
            history.append(costs)
            rho_admm = joint.next_admm_weight(spec, torch.tensor(rho_admm, dtype=torch.float64),
                                              [torch.tensor(costs[i], dtype=torch.float64) for i in active]).tolist()
    def forward(i, m):
        """The data of a model m (N,) of problem i through this reference's kernel."""
        return calculate_data(op[i], m, cw[i], ipar.problem_weight[i], size, ipar.compression_type, solve_dtype,
                              device)

    switched = {
        "cross_gradient": spec.cross_grad and len(active) == 2,
        "damping_gradient": tuple(i for i in active if spec.add_damping_gradient[i]),
        "clustering": spec.clustering and len(active) == 2,
        "admm": tuple(i for i in active if spec.admm_enabled[i]),
    }
    admm_bounds = {i: (bounds[i][0][:, 0], bounds[i][1][:, 0]) for i in switched["admm"]}

    def constraint_costs(models):
        """What the constraints are for (costs.py), of `models` (problem -> (N,))."""
        return constraint_costs_of(models, arrays["edges"], switched, mixture, admm_bounds)

    return {"synthetic": synthetic, "model": {i: model[i][0] for i in active}, "data": calc,
            "cost_history": history, "lsqr_iters": iters, "forward": forward, "costs": constraint_costs,
            "constraint_history": np.array(constraint_history).reshape(-1, len(CONSTRAINT_COLUMNS))}
