"""End-to-end joint gravity and magnetic inversion workflow.

Counterpart of solve_problem_joint_gravmag
(problem_joint_gravmag.F90:65-613): grid + data loading, depth weights,
sensitivity build, synthetic data, prior-model loop, the major inversion
loop with costs.txt logging, dynamic ADMM weight adjustment, stop-file early
exit, and all model/data outputs.

Host-side orchestration is plain Python (it does I/O) on numpy state; the
numerics of the build, the operator and each major iteration's solve run as
tensor operations on `device` (inversion/joint.py).

Ported so far: the gravity problem (g_z or gradiometry, Gzz or the full
tensor), the magnetic problem (TMI or three-component data, susceptibility
or magnetization vector) and the two together, each with a stored kernel —
dense (the default), packed top-k or tile-union (``tpu.kernelFormat = dense
| packed | tiled | auto``), wavelet-compressed or not, built, read from a
cache or rebuilt with the cache's depth weight (``sensit.readFromFiles = 0 |
1 | 2``) — or with no stored kernel (``tpu.kernelFormat = matrixfree``, and
``auto`` on an uncompressed kernel too large for the device: the BTTB,
corner-lattice or per-cell operators of ops/matrixfree.py) — with damping,
damping gradient, ADMM, and the coupling of the two problems by
cross-gradient and clustering, on one device or on a mesh of slots
(``mesh=``: the build's rows and the operator's cells split over the slots,
parallel/mesh.py); checkpoints and resume; the float32, mixed and
float32-compressed builds, bfloat16 kernel storage (ops/bf16_gemv.py) and
the refinement forward (``tpu.refineForward``: the data predicted by the
exact physics, a matrix-free operator, while LSQR keeps the stored kernel).
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from tomofastx_tpu_torch.config.parfile import Config, GRAV, MAGN
from tomofastx_tpu_torch.inversion.joint import (
    SystemSpec,
    capture_unit,
    decide_wavelet_domain,
    make_fused_solver,
    make_solver,
    next_admm_weight,
    tree_map,
)
from tomofastx_tpu_torch.inversion.operators import gaussian_mixture
from tomofastx_tpu_torch.io import data_io, model_io, vtk
from tomofastx_tpu_torch.io.sensit_cache import (
    SensitStreamWriter,
    read_kernel_cache_packed,
    try_read_kernel_cache,
    write_kernel_cache,
)
from tomofastx_tpu_torch.io.tableio import load_table
from tomofastx_tpu_torch.models.data import SurveyData
from tomofastx_tpu_torch.models.model import ModelState
from tomofastx_tpu_torch.ops import sensitivity as sens
from tomofastx_tpu_torch.ops.matrixfree import make_matrixfree_kernel
from tomofastx_tpu_torch.ops.sparse_kernel import DenseKernel, apply_row_weights_packed
from tomofastx_tpu_torch.ops.tile_kernel import apply_row_weights_tiled, tile_kernel_from_cache
from tomofastx_tpu_torch.parallel.mesh import assembly_device, shard_kernel, slot_bytes_line
from tomofastx_tpu_torch.utils.memory import report as memory_report

PROBLEM_PREFIX = ("grav", "mag")  # output file name prefixes (reference usage)


@dataclass
class ProblemContext:
    """Everything belonging to one of the two joint problems."""

    index: int  # 0 = grav, 1 = magn
    par: object  # GravParams | MagParams
    model: ModelState = None
    data: SurveyData = None
    column_weight: np.ndarray = None
    kernel: object = None  # row-weighted dense SensitKernel (dense format only)
    operator: object = None  # row-weighted operator (Dense-, Packed-, TileKernel or matrix-free)
    forward_op: object = None  # exact-physics operator of the predicted data (tpu.refineForward)
    forward_dtype: torch.dtype = None  # the vectors forward_op takes
    residuals: np.ndarray = None


@dataclass
class WorkflowResult:
    models: Dict[int, ModelState]
    data: Dict[int, SurveyData]
    cost_data: List[float]
    cost_model: List[float]
    costs_history: List[dict] = field(default_factory=list)
    # Wall seconds of the phases, for whoever reports where the time went.
    timings: Dict[str, object] = field(default_factory=dict)


def _mkoutdir(cfg: Config) -> str:
    # Outputs resolve against the current directory, like the reference
    # binary; base_dir only anchors the *input* paths. (Otherwise a
    # read-only data tree would receive the output folder.)
    out = cfg.path_output
    os.makedirs(out, exist_ok=True)
    return out


def _model_write(ctx: ProblemContext, out_dir, prefix, write_ascii=False):
    """Model snapshot outputs (reference: model_write, model_IO.F90:481-612):
    structured-grid VTK, x/y/z half-slice lego VTKs, optional ASCII."""
    g = ctx.model.grid
    pv = os.path.join(out_dir, "Paraview")
    common = dict(
        X1=g.X1, Y1=g.Y1, Z1=g.Z1, X2=g.X2, Y2=g.Y2, Z2=g.Z2,
        nx=g.nx, ny=g.ny, nz=g.nz,
        invert_z=True, units_mult=ctx.model.units_mult, label=ctx.model.vtk_label,
    )
    val = ctx.model.val.T  # (N, ncomp)
    vtk.write_struct_grid(os.path.join(pv, f"{prefix}model3D_full.vtk"), val, **common)
    vtk.write_lego_grid(
        os.path.join(pv, f"{prefix}model3D_half_x.vtk"), val,
        i1=g.nx // 2 + 1, i2=g.nx // 2 + 1, **common,
    )
    vtk.write_lego_grid(
        os.path.join(pv, f"{prefix}model3D_half_y.vtk"), val,
        j1=g.ny // 2 + 1, j2=g.ny // 2 + 1, **common,
    )
    vtk.write_lego_grid(
        os.path.join(pv, f"{prefix}model3D_half_z.vtk"), val,
        k1=g.nz // 2 + 1, k2=g.nz // 2 + 1, **common,
    )
    if write_ascii:
        model_io.write_model_ascii(
            ctx.model, os.path.join(out_dir, "model", f"{prefix}model_full.txt")
        )


def _data_write(ctx: ProblemContext, out_dir, name, which):
    """Data outputs in ASCII + VTK (reference: data_write,
    data_gravmag.f90:293-354)."""
    data_io.write_data_points(ctx.data, os.path.join(out_dir, "data", f"{name}.txt"), which)
    val = ctx.data.val_meas if which == 1 else ctx.data.val_calc
    vtk.write_points(
        os.path.join(out_dir, "Paraview", f"data_{name}.vtk"),
        val, ctx.data.X, ctx.data.Y, ctx.data.Z,
        invert_z=True, units_mult=ctx.data.units_mult,
    )


def _calculate_data(ctx: ProblemContext, cfg: Config, solve_dtype, device):
    """d_calc = S m through the stored row-weighted operator
    (model.F90:220-307), or, under tpu.refineForward, through the exact
    physics of the forward operator in the model domain: the residuals then
    carry the stored kernel's compression or bfloat16 error, and the major
    loop corrects it (the stored kernel only preconditions the update)."""
    g = ctx.model.grid
    op, ct, dtype = ctx.operator, ctx.par.compression_type, solve_dtype
    if ctx.forward_op is not None:
        op, ct, dtype = ctx.forward_op, 0, ctx.forward_dtype
    ctx.data.val_calc = sens.calculate_data(
        op,
        ctx.model.val,
        ctx.column_weight,
        cfg.inversion.problem_weight[ctx.index],
        ctx.data.weight,
        ct, g.nx, g.ny, g.nz,
        solve_dtype=dtype, device=device,
    )


def _calculate_model_cost(ctx: ProblemContext, norm_power: float) -> float:
    """Lp model-prior cost (reference: calculate_cost_model, costs.f90:74-113)."""
    cw = ctx.column_weight
    diff = np.where(cw != 0.0, (ctx.model.val[0] - ctx.model.val_prior[0]) / np.where(cw != 0.0, cw, 1.0), 0.0)
    return float(np.sum(np.abs(diff) ** norm_power))


COSTS_HEADER = (
    "# 1:iteration, 2:data_cost_grav, 3:data_cost_mag, 4:model_cost_grav, 5:model_cost_mag,"
    " 6:ADMM_cost_grav, 7:ADMM_cost_mag, 8:ADMM_weight_grav, 9:ADMM_weight_mag,"
    " 10:damp_gradient_cost_x_grav, 11:damp_gradient_cost_y_grav, 12:damp_gradient_cost_z_grav,"
    " 13:damp_gradient_cost_x_mag, 14:damp_gradient_cost_y_mag, 15:damp_gradient_cost_z_mag,"
    " 16:cross_grad_cost_x, 17:cross_grad_cost_y, 18:cross_grad_cost_z,"
    " 19:clustering_cost_grav, 20:clustering_cost_mag"
)


def _device_memory_bytes(device) -> int:
    """Total memory of the device the kernel would live on: the card's own
    total (the JAX package reads its TPU's bytes_limit, 16 GB by default)."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[1]
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _kernel_operator(ctx: ProblemContext, device):
    """Solver-side operator: the packed and tiled operators are built in
    phase III (ctx.operator); everything else is the dense matrix-vector
    pair on the stored kernel."""
    if ctx.operator is not None:
        return ctx.operator
    S = ctx.kernel.S
    # Contiguous transpose for fast adjoint products on the CPU; a CUDA
    # device reads S as it lies, and a second copy would double its memory.
    # A bfloat16 S never has one: its adjoint reads the row-major S.
    cpu_transpose = device.type == "cpu" and S.dtype != torch.bfloat16
    return DenseKernel(S, S.T.contiguous() if cpu_transpose else None)


def _refinement_forward(ctxs, active, ipar, solve_dtype, mesh, device, log):
    """tpu.refineForward: give each active problem an exact-physics forward
    operator (matrix-free, row weights baked in) for the predicted data,
    while LSQR keeps the stored kernel: iterative refinement over the
    majors. Set for every active problem or ignored, with a warning; a
    no-op where every solve operator is matrix-free already; a matrix-free
    solve operator of a mixed-format joint run is its own forward. Under
    tpu.refineForwardPrecision = double the forward is float64. The JAX
    package forces the non-FFT operator for a float64 forward off the CPU,
    for a TPU without complex128 FFTs; the card has them, so the BTTB
    operator serves here too."""
    from tomofastx_tpu_torch.ops.bttb import BTTBKernel
    from tomofastx_tpu_torch.ops.matrixfree import LatticeMatrixFreeKernel, MatrixFreeKernel

    requested = [i for i in active if getattr(ctxs[i].par, "refine_forward", 0)]
    if not requested:
        return
    if len(requested) != len(active):
        log("WARNING: tpu.refineForward ignored — it must be enabled for "
            "ALL active problems (set for "
            f"{[PROBLEM_PREFIX[i] for i in requested]} only).")
        return
    mf = (MatrixFreeKernel, LatticeMatrixFreeKernel, BTTBKernel)
    exact = [i for i in active if ctxs[i].kernel is None and isinstance(ctxs[i].operator, mf)]
    if len(exact) == len(active):
        log("NOTE: tpu.refineForward is a no-op with kernelFormat = "
            "matrixfree (the solve already uses exact physics).")
        return
    for i in active:
        ctx = ctxs[i]
        if i in exact:
            ctx.forward_op, ctx.forward_dtype = ctx.operator, solve_dtype
            continue
        double = getattr(ctx.par, "refine_forward_precision", "") == "double"
        ctx.forward_dtype = torch.float64 if double else solve_dtype
        ctx.forward_op = make_matrixfree_kernel(
            dataclasses.replace(ctx.par, compression_type=0), ctx.model.grid, ctx.data, ctx.column_weight,
            ipar.problem_weight[i], ctx.data.weight, ctx.forward_dtype,
            pad_cells_to=len(mesh.slots) if mesh is not None else 1, device=device,
        )
        log(f"  {PROBLEM_PREFIX[i]} refinement forward: {type(ctx.forward_op).__name__} "
            f"({str(ctx.forward_dtype).replace('torch.', '')}, {ctx.forward_op.nbytes / 1e6:.1f} MB on {device})")


def solve_problem_joint_gravmag(
    cfg: Config,
    base_dir: str = ".",
    solve_dtype=None,
    compute_dtype=None,
    verbose: bool = True,
    device="cuda",
    mesh=None,
    resume: bool = False,
    debug_nans: bool = False,
    near_field_f64: int = 0,
    fused_chunk: int = 0,
) -> WorkflowResult:
    """Run the full inversion described by a Parfile configuration on
    `device` ("cuda" unless the caller asks for "cpu").

    mesh: optional parallel.mesh.Mesh whose slots are devices of `device`'s
    type. The kernel build then cuts each chunk's observations over the
    slots, and after the row weights each operator is sharded once over the
    mesh (parallel/mesh.py::shard_kernel); the unsharded operator is
    dropped, and the forward products and the solve both go through the
    sharded one. The vectors stay on the mesh's home device, which the run
    takes as its device.

    solve_dtype defaults to float32 on a CUDA device and float64 on the CPU;
    compute_dtype (the kernel build) to float64 — the reference computes in
    double and stores single (global_typedefs.F90:37-45), and a float32
    build suffers cancellation in the prism integrals; float32 is the
    compensated build (--build-precision single). near_field_f64 = K > 0
    is the mixed build (--fast-build K): float32 rows with the K nearest
    cells in float64 (ops/sensitivity.py::compute_sensitivity).

    resume=True restarts from <output>/checkpoint.npz if present (written
    every writeModelEveryNiter iterations together with the model
    snapshots): restores models, ADMM dual state z/u, rho, and the
    iteration counter. Either package reads the other's checkpoint.

    debug_nans=True checks, at the end of each major's solve, that its
    costs, the LSQR residual and each problem's model update are finite, and
    raises FloatingPointError naming the first that is not (with
    fused_chunk: at each chunk's end, its majors' costs and the models).

    fused_chunk = M > 0 runs the majors in chunks of up to M with no read of
    the device inside a chunk (inversion/joint.py::FusedSolver: on a CUDA
    device one CUDA graph a major, its LSQR loop a WHILE node), cut at
    writeModelEveryNiter and at the last major; the stop file, the model
    snapshots and the checkpoint are handled at the chunk ends. 0 (the
    default) is the host-driven loop."""
    device = torch.device(device)
    if mesh is not None:
        if mesh.home.type != device.type:
            raise ValueError(f"a mesh of {mesh.home.type} slots for a run on {device}")
        device = mesh.home
    if solve_dtype is None:
        solve_dtype = torch.float64 if device.type == "cpu" else torch.float32
    if compute_dtype is None:
        compute_dtype = torch.float64

    def log(*a):
        if verbose:
            print(*a, flush=True)

    def on_device(a):
        return torch.as_tensor(np.asarray(a), dtype=solve_dtype, device=device)

    def sync():
        # Phase times are read on the host's clock: wait for the devices first.
        if device.type == "cuda":
            for d in dict.fromkeys(mesh.slots if mesh is not None else [device]):
                torch.cuda.synchronize(d)

    t_start = time.time()
    timings: Dict[str, object] = {}
    ipar = cfg.inversion

    def add_time(key, t0):
        """Seconds since t0, added to timings[key] (summed over the problems)."""
        sync()
        dt = time.time() - t0
        timings[key] = timings.get(key, 0.0) + dt
        return dt

    # Where each kernel is assembled before a mesh cuts it: the home card
    # when every slot is on it, else the host (parallel/mesh.py).
    build_device = device if mesh is None else assembly_device(mesh)

    if ipar.method != 1:
        raise ValueError(f"Unknown solver type {ipar.method}! (only 1 = LSQR)")
    active = [i for i in (GRAV, MAGN) if cfg.solve_problem(i)]
    if not active:
        raise ValueError("No active problems (both problem weights are zero).")

    out_dir = _mkoutdir(cfg)

    # Memory checkpoint 1/4: startup (reference prints Pss at MPI init,
    # program_tomofastx.F90:60-61).
    log(memory_report("(init) ", device))

    ctxs: Dict[int, ProblemContext] = {
        i: ProblemContext(index=i, par=cfg.problem_params(i)) for i in active
    }
    log(f"Solving problem grav/mag. active = {[PROBLEM_PREFIX[i] for i in active]}")

    # ---- (I) model grid ----
    for i, ctx in ctxs.items():
        par = ctx.par
        grid = model_io.read_model_grid(
            os.path.join(base_dir, par.model_grid_file), par.nx, par.ny, par.nz, par.z_axis_dir
        )
        ctx.model = ModelState(
            grid=grid,
            ncomponents=par.nmodel_components,
            units_mult=par.model_units_mult,
            vtk_label=par.vtk_model_label,
        )

    # ---- (II) data ----
    for i, ctx in ctxs.items():
        par = ctx.par
        ctx.data = data_io.read_data_points(
            os.path.join(base_dir, par.data_grid_file), par.ndata, par.ndata_components,
            par.data_units_mult, par.z_axis_dir, grid_only=True,
        )
        if par.use_data_error == 1:
            data_io.read_data_error(ctx.data, os.path.join(base_dir, par.data_error_file))
    timings["read_inputs_s"] = time.time() - t_start

    # ---- (III) depth weights + sensitivity ----
    for i, ctx in ctxs.items():
        par = ctx.par
        sensit_dir = os.path.join(out_dir, "SENSIT")
        t0 = time.time()
        if par.sensit_read == 0:
            log(f"Calculating the depth weight for {PROBLEM_PREFIX[i]}, type = {par.depth_weighting_type}")
            cw = sens.calculate_depth_weight(par, ctx.model.grid, ctx.data, compute_dtype, device)
            cw = ipar.column_weight_multiplier[i] * cw
            cw = sens.apply_local_depth_weighting(par, cw)
            ctx.column_weight = cw
        else:
            # read = 1 and read = 2 both take the depth weight from the
            # cache (sensitivity_gravmag.F90:873-879). The stored weight
            # already contains the column-weight multiplier and local
            # weighting, so neither is re-applied. The kernel itself is
            # re-read for read = 1 and built again for read = 2 (F90:195-202)
            # below.
            cache_dir = os.path.join(base_dir, par.sensit_path)
            ctx.column_weight = _read_depth_weight_file(cache_dir, i)
        add_time("depth_weight_s", t0)

        fmt = par.kernel_format
        build_dtype = torch.float32 if near_field_f64 > 0 else compute_dtype
        bf16 = par.kernel_store == "bfloat16"
        nrows_tot = par.ndata * par.ndata_components
        ncols_tot = ctx.model.grid.nelements_total * par.nmodel_components
        if fmt == "auto" and par.compression_type == 0:
            # Capacity-aware auto (uncompressed): a dense kernel that cannot
            # share the device with the solver's working set falls back to
            # the matrix-free operators (BTTB on gridded surveys, the corner
            # lattice or per-cell rows otherwise).
            dense_bytes = nrows_tot * ncols_tot * 4
            total = _device_memory_bytes(device)
            if dense_bytes > 0.55 * total:
                log(f"  {PROBLEM_PREFIX[i]} kernel format auto: dense would be {dense_bytes / 1e9:.1f} GB "
                    f"(> 55% of {total / 1e9:.0f} GB of device memory) -> matrix-free")
                fmt = "matrixfree"

        if fmt == "matrixfree":
            # No stored kernel: the operator regenerates its rows in every
            # product (ops/matrixfree.py), on the home device; a mesh cuts
            # it below. Nothing is written to the cache.
            ctx.kernel = None
            ctx.operator = make_matrixfree_kernel(
                par, ctx.model.grid, ctx.data, ctx.column_weight, ipar.problem_weight[i], ctx.data.weight,
                solve_dtype, pad_cells_to=len(mesh.slots) if mesh is not None else 1, device=device,
            )
            # The per-cell and lattice operators name what computes their
            # products: kernel B2 or B3 on the card, the plain chunk loop on
            # the CPU; on the card, also the float64 partial sums one product
            # allocates beside what the operator holds; the per-cell blend's
            # near lists, K candidate cells a row; and either blend's stored
            # near rows (counted in the bytes it holds).
            route = getattr(ctx.operator, "products_by", None)
            partial = getattr(ctx.operator, "partial_nbytes", None) if device.type == "cuda" else None
            near = getattr(ctx.operator, "near_idx", None)
            rows = getattr(ctx.operator, "near_rval", None)
            log(f"  {PROBLEM_PREFIX[i]} kernel: matrix-free ({type(ctx.operator).__name__}, no row storage; "
                f"{ctx.operator.nbytes / 1e6:.1f} MB on {device}"
                + (f", {partial / 1e6:.1f} MB of float64 partial sums a product" if partial is not None else "")
                + (f", near lists K = {near.shape[1]}, {near.numel():,} candidate pairs" if near is not None else "")
                + (f", near rows of {rows.shape[0]:,} pairs stored ({ctx.operator.near_rows_nbytes / 1e6:.1f} MB)"
                   if rows is not None else "")
                + (f"; products by {route})" if route else ")"))
            continue
        if fmt == "auto":
            fmt = "packed" if par.compression_type > 0 else "dense"

        if fmt in ("packed", "tiled") and par.compression_type > 0:
            # Capacity modes: the dense (nd, N) array is never materialized.
            # The build streams row chunks straight to the reference-format
            # cache (sensitivity_gravmag.F90:306-309) and the cache streams
            # back into the packed top-k layout or the tile-union block
            # layout (ibid. 723-862 semantics).
            layout = "tiles" if fmt == "tiled" else "the packed layout"

            def read_capacity(cache_dir):
                if fmt == "tiled":
                    return tile_kernel_from_cache(cache_dir, par, ctx.model.grid, build_device)
                return read_kernel_cache_packed(cache_dir, par, ctx.model.grid, device=build_device)

            pk = meta = None
            if par.sensit_read == 1:
                t0 = time.time()
                pk, meta = read_capacity(os.path.join(base_dir, par.sensit_path))
                if pk is None:
                    log(f"WARNING: no readable sensitivity cache for {PROBLEM_PREFIX[i]}; recomputing.")
                else:
                    pack_s = add_time("pack_s", t0)
            if pk is None:
                log(f"Calculating {PROBLEM_PREFIX[i].upper()} sensitivity kernel (streamed/{fmt})...")
                # Predicted allocation print before the big build
                # (reference: sparse_matrix.f90:508-515).
                kept = int(np.ceil(par.compression_rate * ncols_tot))
                log(f"  predicted kept entries ~ {nrows_tot * kept:,} "
                    f"({nrows_tot * kept * 8 / 1024**3:.3f} GB in the cache)")
                t0 = time.time()
                writer = SensitStreamWriter(
                    sensit_dir, par, ctx.model.grid, ctx.column_weight, par.compression_type,
                )
                try:
                    kmeta = sens.compute_sensitivity(
                        par, ctx.model.grid, ctx.data, ctx.column_weight,
                        compute_dtype=build_dtype, store_dtype=torch.float32,
                        row_sink=writer.write_chunk, device=build_device, mesh=mesh,
                        near_field_f64=near_field_f64,
                    )
                finally:
                    writer.close()
                writer.finalize(kmeta.comp_error)
                build_s = add_time("build_s", t0)
                log(f"  kernel built+cached in {build_s:.2f}s "
                    f"({nrows_tot / max(build_s, 1e-9):.1f} rows/s); "
                    f"COMPRESSION ERROR, r = {kmeta.comp_error:.6e}")
                t0 = time.time()
                pk, meta = read_capacity(sensit_dir)
                pack_s = add_time("pack_s", t0)
            log(f"  cache packed into {layout} in {pack_s:.2f}s (nnz = {meta['nnz']:,})")

            # Bake in problem weight x data weights (sensitivity_gravmag.F90:836-843).
            t0 = time.time()
            wrow = (ipar.problem_weight[i] * np.asarray(ctx.data.weight)).reshape(-1)
            if fmt == "tiled":
                ctx.operator = apply_row_weights_tiled(pk, wrow)
                shapes = (f"forward {tuple(ctx.operator.uvals.shape)}, "
                          f"adjoint {tuple(ctx.operator.uvalsT.shape)}; ")
            else:
                ctx.operator = apply_row_weights_packed(pk, wrow)
                shapes = (f"rows {tuple(ctx.operator.row_vals.shape)}, "
                          f"heavy columns {tuple(ctx.operator.dense_block.shape)}, "
                          f"light columns {tuple(ctx.operator.light_vals.shape)}; ")
            log(f"  row weights applied on {build_device} in {add_time('row_weights_s', t0):.2f}s")
            log(
                f"  {PROBLEM_PREFIX[i]} kernel: {fmt} {ctx.operator.nbytes / 1e6:.1f} MB "
                f"({shapes}dense would be {nrows_tot * ncols_tot * 4 / 1e6:.1f} MB)"
            )
            continue

        # The dense format (and any format on an uncompressed kernel, whose
        # rows have no zeros to leave out).
        kernel = None
        if par.sensit_read == 1:
            t0 = time.time()
            kernel = try_read_kernel_cache(
                os.path.join(base_dir, par.sensit_path), par, ctx.model.grid, build_device
            )
            if kernel is None:
                log(f"WARNING: no readable sensitivity cache for {PROBLEM_PREFIX[i]}; recomputing.")
            else:
                cache_read_s = add_time("cache_read_s", t0)
                log(f"  cache read into the dense kernel in {cache_read_s:.2f}s (nnz = {kernel.nnz:,})")
        if kernel is None:
            log(f"Calculating {PROBLEM_PREFIX[i].upper()} sensitivity kernel...")
            t0 = time.time()
            # Predicted allocation print (reference: sparse_matrix.f90:508-515).
            log(f"  predicted kernel size = {nrows_tot * ncols_tot * 4 / 1024**3:.3f} GB (float32)")

            # 10% progress ticker (reference: sensitivity_gravmag.F90:313-316).
            last_decile = [0]

            def ticker(done, total):
                decile = 10 * done // total
                if decile > last_decile[0]:
                    last_decile[0] = decile
                    rate = done / max(time.time() - t0, 1e-9)
                    log(f"  sensitivity rows: {10 * decile}% ({done}/{total}, {rate:.1f} rows/s)")

            # bfloat16 storage is built straight into bfloat16: a float32
            # kernel beside it would double the build's memory.
            kernel = sens.compute_sensitivity(
                par, ctx.model.grid, ctx.data, ctx.column_weight,
                compute_dtype=build_dtype, store_dtype=torch.bfloat16 if bf16 else torch.float32,
                progress=ticker, device=build_device, mesh=mesh, near_field_f64=near_field_f64,
            )
            build_s = add_time("build_s", t0)
            log(f"  kernel built in {build_s:.2f}s "
                f"({nrows_tot / max(build_s, 1e-9):.1f} rows/s); "
                f"COMPRESSION RATE = {kernel.nnz / max(kernel.S.numel(), 1):.6f}; "
                f"COMPRESSION ERROR, r = {kernel.comp_error:.6e}")
            # The reference always persists the kernel
            # (sensitivity_gravmag.F90:141-153); opt out with
            # tpu.sensitWriteCache = 0 for one-shot runs.
            if par.sensit_write:
                if kernel.S.dtype == torch.bfloat16:
                    # The cache is a float32 format; bfloat16-rounded values
                    # would pass for float32 ones in a later run.
                    log("  NOT writing the sensit cache: the kernel is "
                        "stored bfloat16 and the cache format is float32 "
                        "(set tpu.kernelStoreDtype = float32 to persist).")
                else:
                    t0 = time.time()
                    write_kernel_cache(sensit_dir, par, kernel, ctx.column_weight)
                    log(f"  kernel cached in {add_time('cache_write_s', t0):.2f}s")

        # Bake in problem weight x data weights (sensitivity_gravmag.F90:836-843),
        # in place and in storage precision.
        t0 = time.time()
        ctx.kernel = sens.apply_row_weights(kernel, ipar.problem_weight[i], ctx.data.weight)
        # Cast once to the dtype of the LSQR products: the solve's, or
        # bfloat16 (half the kernel's memory; its products sum in the solve's
        # dtype). A kernel already in it comes back as the same tensor.
        ctx.kernel.S = ctx.kernel.S.to(torch.bfloat16 if bf16 else solve_dtype)
        log(f"  row weights applied on {build_device} in {add_time('row_weights_s', t0):.2f}s")
        log(f"  {PROBLEM_PREFIX[i]} kernel: dense {tuple(ctx.kernel.S.shape)} {ctx.kernel.S.dtype}, "
            f"{ctx.kernel.S.numel() * ctx.kernel.S.element_size() / 1e6:.1f} MB")

    for ctx in ctxs.values():
        ctx.operator = _kernel_operator(ctx, device)

    _refinement_forward(ctxs, active, ipar, solve_dtype, mesh, device, log)

    if mesh is not None:
        # Shard each operator once, the refinement forward with them; the
        # unsharded one (and the dense kernel it was made from) is dropped.
        t0 = time.time()
        for i, ctx in ctxs.items():
            reuse = ctx.forward_op is ctx.operator
            ctx.operator = shard_kernel(ctx.operator, mesh)
            ctx.kernel = None
            if ctx.forward_op is not None:
                ctx.forward_op = ctx.operator if reuse else shard_kernel(ctx.forward_op, mesh)
        add_time("shard_s", t0)
        shape = "x".join(str(v) for v in mesh.devices.shape)
        for i, ctx in ctxs.items():
            log(f"  {PROBLEM_PREFIX[i]} kernel sharded over a {shape} mesh {mesh.axis_names} in "
                f"{timings['shard_s']:.2f}s: {slot_bytes_line(ctx.operator)}")

    # Memory checkpoint 2/4: after the forward phase (reference prints Pss
    # here, sensitivity_gravmag.F90:394-398).
    log(memory_report("(forward) ", device))
    log(f"  forward phase done at t+{time.time() - t_start:.2f}s")

    # ---- ADMM bounds ----
    if ipar.admm_type > 0:
        for i, ctx in ctxs.items():
            model_io.set_model_bounds(_with_paths(ipar, base_dir), ctx.model, i)

    # ---- damping-gradient and damping local weights ----
    for i, ctx in ctxs.items():
        if ipar.beta[i] != 0.0:
            ctx.model.allocate_damping_gradient_arrays()
            if ipar.damp_grad_weight_type > 1:
                model_io.read_damping_gradient_weights(
                    ctx.model, os.path.join(base_dir, ipar.damping_gradient_file[i])
                )
        if ipar.apply_local_damping_weight > 0:
            model_io.read_damping_weights(
                ctx.model, os.path.join(base_dir, ipar.damping_weight_file[i])
            )

    # ---- cross-gradient vector field / clustering mixtures ----
    vec_field = None
    if ipar.cross_grad_weight != 0.0 and ipar.vec_field_type > 0:
        vec_field = model_io.read_vector_field(
            os.path.join(base_dir, ipar.vec_field_file), ipar.nelements_total
        )

    mixture = None
    if ipar.clustering_weight_glob[0] != 0.0 or ipar.clustering_weight_glob[1] != 0.0:
        mixture = _read_mixtures(cfg, base_dir)

    # ---- synthetic data (problem_joint_gravmag.F90:277-362) ----
    for i, ctx in ctxs.items():
        par = ctx.par
        if par.use_synthetic_model:
            model_io.set_model(
                ctx.model, 2, 0.0, os.path.join(base_dir, par.synthetic_model_file)
            )
            _model_write(ctx, out_dir, f"{PROBLEM_PREFIX[i]}_synth_")
            _calculate_data(ctx, cfg, solve_dtype, device)
            _data_write(ctx, out_dir, f"{PROBLEM_PREFIX[i]}_synthetic", 2)
            # The reference re-reads the just-written synthetic file as the
            # observed data; writing divides by units_mult and reading
            # multiplies, so this is val_meas = val_calc.
            ctx.data.val_meas = ctx.data.val_calc.copy()
        else:
            data_io.read_data_values(ctx.data, os.path.join(base_dir, par.data_grid_file))
        _data_write(ctx, out_dir, f"{PROBLEM_PREFIX[i]}_observed", 1)

    log(f"  data/synthetic phase done at t+{time.time() - t_start:.2f}s")

    # ---- build the solver ----
    g0 = ctxs[active[0]].model.grid
    for i in active:
        # The parfile parser keeps these in lockstep; programmatic configs
        # can drift them apart, which silently mismatches the kernel's
        # column domain against the solver's wavelet conversions — fail
        # fast instead (sensitivity_gravmag.F90:1016-1030).
        if ctxs[i].par.compression_type != ipar.compression_type:
            raise ValueError(
                f"compression_type mismatch: problem {PROBLEM_PREFIX[i]} has "
                f"{ctxs[i].par.compression_type} but inversion params have "
                f"{ipar.compression_type}; set both (the Parfile key "
                "forward.matrixCompression.type sets them together)."
            )
    wavelet_domain = decide_wavelet_domain(ipar) if ipar.compression_type > 0 else False
    spec = SystemSpec(
        active=tuple(active),
        ncomp=ipar.nmodel_components,
        nx=g0.nx, ny=g0.ny, nz=g0.nz,
        ndata_rows=tuple(ipar.ndata[i] * ipar.ndata_components[i] for i in active),
        compression_type=ipar.compression_type,
        wavelet_domain=wavelet_domain,
        problem_weight=ipar.problem_weight,
        alpha=ipar.alpha,
        norm_power=ipar.norm_power,
        add_damping=tuple(
            ipar.alpha[i] != 0.0 and ipar.problem_weight[i] != 0.0 for i in (0, 1)
        ),
        beta=ipar.beta,
        add_damping_gradient=tuple(
            ipar.beta[i] != 0.0 and ipar.problem_weight[i] != 0.0 for i in (0, 1)
        ),
        admm_enabled=tuple(
            ipar.admm_type > 0 and ipar.problem_weight[i] != 0.0 for i in (0, 1)
        ),
        nlithos=ipar.nlithos,
        cross_grad=ipar.cross_grad_weight != 0.0,
        cross_grad_weight=ipar.cross_grad_weight,
        der_type=ipar.derivative_type,
        keep_model_constant=ipar.keep_model_constant,
        vec_field_type=ipar.vec_field_type,
        clustering=(ipar.clustering_weight_glob[0] != 0.0 or ipar.clustering_weight_glob[1] != 0.0),
        clustering_weight_glob=ipar.clustering_weight_glob,
        clustering_opt_type=ipar.clustering_opt_type,
        apply_local_damping_weight=ipar.apply_local_damping_weight > 0,
        niter=ipar.niter,
        rmin=ipar.rmin,
        gamma=ipar.gamma,
        target_misfit=ipar.target_misfit,
        admm_cost_threshold=ipar.data_cost_threshold_ADMM,
        admm_weight_multiplier=ipar.weight_multiplier_ADMM,
        admm_max_weight=ipar.max_weight_ADMM,
        refine_forward=all(ctxs[i].forward_op is not None for i in active),
    )
    if (spec.cross_grad or spec.clustering) and len(active) < 2:
        raise ValueError(
            "Cross-gradient and clustering constraints require BOTH problems "
            "active (nonzero inversion.joint.*.problemWeight); the reference "
            "would dereference an unallocated second model here."
        )
    log(f"WAVELET_DOMAIN = {spec.wavelet_domain}")
    solver = make_solver(spec)

    # Static per-run tensors. Those of disabled features are left out (the
    # solve only reads them under the corresponding spec flag), and so is a
    # disabled problem's entry of a per-problem tuple (None). With a mesh
    # they stay on the home device with the vectors: only the operators are
    # sharded.
    static_arrays = {
        "S": tuple(ctxs[i].operator for i in active),
        "cw": tuple(on_device(ctxs[i].column_weight) for i in active),
        "dX": on_device(g0.dX()),
        "dY": on_device(g0.dY()),
        "dZ": on_device(g0.dZ()),
    }
    if any(spec.add_damping_gradient[i] for i in active):
        static_arrays["damping_grad_weight"] = tuple(
            on_device(ctxs[i].model.damping_grad_weight) if spec.add_damping_gradient[i] else None
            for i in active
        )
    if vec_field is not None:
        static_arrays["vec_field"] = on_device(vec_field)
    if mixture is not None:
        static_arrays.update({k: on_device(v) for k, v in mixture.items()})
    if spec.apply_local_damping_weight:
        static_arrays["damping_weight"] = tuple(
            on_device(ctxs[i].model.damping_weight) for i in active
        )
    if any(spec.admm_enabled[i] for i in active):
        static_arrays["min_bound"] = tuple(on_device(ctxs[i].model.min_bound) for i in active)
        static_arrays["max_bound"] = tuple(on_device(ctxs[i].model.max_bound) for i in active)
        static_arrays["bound_weight"] = tuple(
            on_device(ctxs[i].model.bound_weight) for i in active
        )

    # ---- prior-models loop (problem_joint_gravmag.F90:374-598) ----
    result = WorkflowResult(models={}, data={}, cost_data=[0.0, 0.0], cost_model=[0.0, 0.0])
    number_prior_models = cfg.grav.number_prior_models
    base_out = out_dir
    rho_admm = list(ipar.rho_ADMM)

    # ADMM dual state persists across the prior-models loop (the reference
    # allocates z/u once in initialize2 and never resets them,
    # joint_inverse_problem.F90:320, 352-355).
    admm_z = [
        torch.zeros((spec.N if spec.admm_enabled[i] else 1,), dtype=solve_dtype, device=device)
        for i in active
    ]
    admm_u = [torch.zeros_like(z) for z in admm_z]
    timings["solve_s"] = []
    timings["lsqr_iters"] = []
    fused = None  # the fused loop's solver, made at its first chunk

    for m in range(1, number_prior_models + 1):
        if m > 1:
            out_dir = base_out.rstrip("/") + f"_{m}/"
            os.makedirs(out_dir, exist_ok=True)

        log(f"=== Solve problem for prior model #{m}, output folder = {out_dir}")

        # Prior model.
        for i, ctx in ctxs.items():
            par = ctx.par
            prior_file = par.prior_model_file
            if m > 1:
                prior_file = f"{prior_file}_{m}"
            model_io.set_model(
                ctx.model, par.prior_model_type, par.prior_model_val,
                os.path.join(base_dir, prior_file),
            )
            ctx.model.val_prior = ctx.model.val.copy()
            if par.prior_model_type > 1:
                _model_write(ctx, out_dir, f"{PROBLEM_PREFIX[i]}_prior_")
            _calculate_data(ctx, cfg, solve_dtype, device)
            _data_write(ctx, out_dir, f"{PROBLEM_PREFIX[i]}_prior", 2)

        # Starting model.
        for i, ctx in ctxs.items():
            par = ctx.par
            model_io.set_model(
                ctx.model, par.start_model_type, par.start_model_val,
                os.path.join(base_dir, par.start_model_file),
            )
            if par.start_model_type > 1:
                _model_write(ctx, out_dir, f"{PROBLEM_PREFIX[i]}_starting_")
            _calculate_data(ctx, cfg, solve_dtype, device)
            _data_write(ctx, out_dir, f"{PROBLEM_PREFIX[i]}_starting", 2)

        # Initial costs.
        cost_model = [0.0, 0.0]
        cost_data = [0.0, 0.0]
        for i, ctx in ctxs.items():
            cost_model[i] = _calculate_model_cost(ctx, ipar.norm_power)
            cost_data[i] = ctx.data.get_cost()
            log(f"data cost (initial) [{PROBLEM_PREFIX[i]}] = {cost_data[i]}")
        log(f"  entering the major loop at t+{time.time() - t_start:.2f}s")

        it_start = 1
        ckpt_path = os.path.join(out_dir, "checkpoint.npz")
        if resume and os.path.exists(ckpt_path):
            ck = load_checkpoint(ckpt_path)
            if int(ck["m"]) == m:
                it_start = int(ck["it"]) + 1
                rho_admm = [float(v) for v in ck["rho_admm"]]
                for a, i in enumerate(active):
                    ctxs[i].model.val = ck[f"model_{i}"]
                    ctxs[i].model.val_prior = ck[f"prior_{i}"]
                    admm_z[a] = on_device(ck[f"admm_z_{i}"])
                    admm_u[a] = on_device(ck[f"admm_u_{i}"])
                    _calculate_data(ctxs[i], cfg, solve_dtype, device)
                    cost_data[i] = ctxs[i].data.get_cost()
                    cost_model[i] = _calculate_model_cost(ctxs[i], ipar.norm_power)
                log(f"Resumed from checkpoint at iteration {it_start - 1}.")

        extras_np = {}
        with open(os.path.join(out_dir, "costs.txt"), "a" if it_start > 1 else "w") as costs_f:
            if it_start == 1:
                costs_f.write(COSTS_HEADER + "\n")

            def end_major(it, pre_data, pre_model, costs, rho_row, post_data, post_model):
                """A major's records, in both loops: its costs.txt row from
                the pre-update costs (problem_joint_gravmag.F90:519-528),
                its history entry from the post-update ones."""
                costs_f.write(_costs_row(it - 1, pre_data, pre_model, costs, rho_row) + "\n")
                costs_f.flush()
                result.costs_history.append(
                    {"iteration": it, "cost_data": list(post_data), "cost_model": list(post_model)})

            def snapshot(it, admm_z, admm_u, rho_admm):
                """The models and the checkpoint after major `it`, every
                writeModelEveryNiter majors. The checkpoint follows the rho
                adjustment: it belongs to the completed major, so a resumed
                run starts it+1 with the adjusted weight."""
                if ipar.write_model_niter > 0 and it % ipar.write_model_niter == 0:
                    for i, ctx in ctxs.items():
                        _model_write(ctx, out_dir, f"{PROBLEM_PREFIX[i]}_inter_{it}_")
                    save_checkpoint(ckpt_path, active, ctxs, admm_z, admm_u, rho_admm, m, it)

            # ---- major inversion loop (fused: no read of the device inside a chunk) ----
            if fused_chunk > 0:
                static_arrays["val_meas"] = tuple(on_device(ctxs[i].data.val_meas) for i in active)
                static_arrays["data_weight"] = tuple(on_device(ctxs[i].data.weight) for i in active)
                if spec.refine_forward:
                    static_arrays["S_fwd"] = tuple(ctxs[i].forward_op for i in active)
                if fused is None:
                    # One solver a run: its length is fixed at prog_steps, and
                    # a shorter chunk (writeModelEveryNiter, the last majors,
                    # a resume) masks its tail with active_steps, so one
                    # captured graph serves every chunk.
                    prog_steps = min(fused_chunk, ipar.ninversions)
                    fused = make_fused_solver(spec, prog_steps)
                    log(f"fused major loop: chunks of up to {prog_steps} majors, {capture_unit(static_arrays)[1]}")
                it = it_start
                while it <= ipar.ninversions:
                    if os.path.exists("stop") or os.path.exists(os.path.join(out_dir, "stop")):
                        log("Stop file found! Exiting the loop.")
                        break
                    steps = min(prog_steps, ipar.ninversions - it + 1)
                    if ipar.write_model_niter > 0:
                        wmn = ipar.write_model_niter
                        steps = min(steps, ((it + wmn - 1) // wmn) * wmn - it + 1)
                    sync()
                    t_it, captures = time.time(), (fused.captures, fused.capture_s)
                    arrays = dict(static_arrays)
                    arrays.update(
                        model=tuple(on_device(ctxs[i].model.val) for i in active),
                        prior=tuple(on_device(ctxs[i].model.val_prior) for i in active),
                        admm_z=tuple(admm_z),
                        admm_u=tuple(admm_u),
                        rho_admm=on_device(rho_admm),
                        active_steps=steps,
                    )
                    out_dev = fused(arrays)
                    # The chunk's one wait for the device, the WHILE node's runs of LSQR's body
                    # (on a card) with it.
                    out, body_runs = _to_host((out_dev, fused.body_runs))
                    timings["solve_s"].append(time.time() - t_it)
                    if fused.captures != captures[0]:
                        timings["capture_s"] = fused.capture_s
                        log(f"  fused major captured as a CUDA graph in {fused.capture_s - captures[1]:.2f}s "
                            "(warm-up step included)")
                    if m == 1 and it == it_start:
                        # Memory checkpoint 3/4: after the first LSQR solve
                        # (lsqr_solver2.F90:293-299).
                        log(memory_report("(first solve) ", device))
                    per = out["per_iteration"]
                    iters = [int(v) for v in per["lsqr_iters"][:steps]]
                    timings["lsqr_iters"] += iters
                    # The body's runs a major: the iterations, and one more where a stop test
                    # froze the last run.
                    runs = [] if body_runs is None else body_runs[:steps].tolist()
                    timings.setdefault("lsqr_body_runs", []).extend(runs)
                    if debug_nans:
                        _require_finite_chunk(out, active, it, steps)

                    for a, i in enumerate(active):
                        ctxs[i].model.val = out["model"][a].double().numpy()
                        ctxs[i].data.val_calc = out["final_d_calc"][a].double().numpy().reshape(
                            ctxs[i].data.val_meas.shape)
                        cost_data[i] = float(out["final_cost_data"][a])
                        cost_model[i] = float(out["final_cost_model"][a])
                    admm_z, admm_u = list(out_dev["admm_z"]), list(out_dev["admm_u"])
                    rho_admm = out["rho_admm"].tolist()
                    # The history's model costs are the chunk's last, as the
                    # JAX package's are.
                    for s in range(steps):
                        by_problem = {k: [0.0, 0.0] for k in ("pre_cost_data", "pre_cost_model", "post_cost_data")}
                        for k, v in by_problem.items():
                            for a, i in enumerate(active):
                                v[i] = float(per[k][s, a])
                        costs_s = {k: v[s].numpy() if v[s].ndim else float(v[s]) for k, v in per["costs"].items()}
                        end_major(it + s, by_problem["pre_cost_data"], by_problem["pre_cost_model"], costs_s,
                                  per["rho"][s].tolist(), by_problem["post_cost_data"], cost_model)
                    extras_np = {k: v.numpy() for k, v in out["extras"].items()}
                    log(f"  fused {steps} iterations in {time.time() - t_it:.2f}s, lsqr iters = {iters}, "
                        + ", ".join(f"{PROBLEM_PREFIX[i]} cost = {cost_data[i]:.6e}" for i in active)
                        + (f"; LSQR body runs = {runs}" if runs else ""))
                    it += steps
                    snapshot(it - 1, admm_z, admm_u, rho_admm)

            # ---- major inversion loop (host-driven) ----
            for it in ([] if fused_chunk > 0 else range(it_start, ipar.ninversions + 1)):
                # The reference polls ./stop in the cwd
                # (problem_joint_gravmag.F90:688); the output dir is also
                # accepted because base_dir/input trees may be read-only.
                if os.path.exists("stop") or os.path.exists(os.path.join(out_dir, "stop")):
                    log("Stop file found! Exiting the loop.")
                    break

                log(f"=== Iteration {it} / prior model {m} ===")
                sync()
                t_it = time.time()

                # Residuals (problem_joint_gravmag.F90:666-675).
                for i, ctx in ctxs.items():
                    ctx.residuals = ctx.data.weight * (ctx.data.val_meas - ctx.data.val_calc)

                arrays = dict(static_arrays)
                arrays.update(
                    model=tuple(on_device(ctxs[i].model.val) for i in active),
                    prior=tuple(on_device(ctxs[i].model.val_prior) for i in active),
                    residuals=tuple(on_device(ctxs[i].residuals) for i in active),
                    admm_z=tuple(admm_z),
                    admm_u=tuple(admm_u),
                    rho_admm=on_device(rho_admm),
                )

                out = solver(arrays)
                if debug_nans:
                    _require_finite(out, active, it)
                sync()
                timings["solve_s"].append(time.time() - t_it)
                timings["lsqr_iters"].append(int(out["lsqr_iters"]))
                if m == 1 and it == it_start:
                    # Memory checkpoint 3/4: after the first LSQR solve
                    # (lsqr_solver2.F90:293-299).
                    log(memory_report("(first solve) ", device))

                admm_z = list(out["admm_z"])
                admm_u = list(out["admm_u"])
                last_costs = {k: float(v) if v.ndim == 0 else v.cpu().numpy() for k, v in out["costs"].items()}
                extras_np = {k: v.cpu().numpy() for k, v in out["extras"].items()}

                # Update models + new data.
                for a, i in enumerate(active):
                    ctxs[i].model.update(out["delta"][a].cpu().numpy())
                    _calculate_data(ctxs[i], cfg, solve_dtype, device)

                # New costs.
                pre_data, pre_model = list(cost_data), list(cost_model)
                for i, ctx in ctxs.items():
                    cost_model[i] = _calculate_model_cost(ctx, ipar.norm_power)
                    cost_data[i] = ctx.data.get_cost()
                end_major(it, pre_data, pre_model, last_costs, rho_admm, cost_data, cost_model)

                log(
                    f"  iter done in {time.time() - t_it:.2f}s, lsqr iters = {int(out['lsqr_iters'])}, "
                    + ", ".join(
                        f"{PROBLEM_PREFIX[i]} cost = {cost_data[i]:.6e}" for i in active
                    )
                )

                # Dynamic ADMM weight adjustment, decided where the fused
                # loop's is (joint.next_admm_weight), on float64 host tensors.
                rho_new = next_admm_weight(spec, torch.tensor(rho_admm, dtype=torch.float64),
                                           [torch.tensor(cost_data[i], dtype=torch.float64) for i in active]).tolist()
                for i in active:
                    if rho_new[i] != rho_admm[i]:
                        log(f"Increased the ADMM weight to: {rho_new[i]}")
                rho_admm = rho_new
                snapshot(it, admm_z, admm_u, rho_admm)

            # Final costs row (problem_joint_gravmag.F90:550).
            costs_f.write(
                f" {ipar.ninversions} {cost_data[0]:.9E} {cost_data[1]:.9E}"
                f" {cost_model[0]:.9E} {cost_model[1]:.9E}\n"
            )

        # ---- final outputs ----
        for i, ctx in ctxs.items():
            _model_write(ctx, out_dir, f"{PROBLEM_PREFIX[i]}_final_", write_ascii=True)
            log(
                f"Model {i + 1} min/max values = {ctx.model.val.min()}, {ctx.model.val.max()}"
            )
            _data_write(ctx, out_dir, f"{PROBLEM_PREFIX[i]}_final", 2)
            # Final data residual written over val_calc (F90:569-578).
            saved = ctx.data.val_calc.copy()
            ctx.data.val_calc = ctx.data.val_meas - ctx.data.val_calc
            _data_write(ctx, out_dir, f"{PROBLEM_PREFIX[i]}_misfit", 2)
            ctx.data.val_calc = saved

        # The coupling fields of the last major (F90 output of the joint run).
        ctx0 = ctxs[active[0]]
        g = ctx0.model.grid
        for key, name in (("cross_grad_magnitude", "cross_grad"), ("clustering_probabilities", "clustering")):
            if key in extras_np:
                vtk.write_struct_grid(
                    os.path.join(out_dir, "Paraview", f"{name}_final_model3D_full.vtk"),
                    extras_np[key][:, None],
                    g.X1, g.Y1, g.Z1, g.X2, g.Y2, g.Z2, g.nx, g.ny, g.nz,
                    invert_z=True, units_mult=ctx0.model.units_mult, label=ctx0.model.vtk_label,
                )

    result.models = {i: ctxs[i].model for i in active}
    result.data = {i: ctxs[i].data for i in active}
    result.cost_data = cost_data
    result.cost_model = cost_model
    timings["total_s"] = time.time() - t_start
    result.timings = timings
    log(memory_report("(end) ", device))
    log(f"THE END. total time = {timings['total_s']:.2f}s")
    return result


def _costs_row(it, cost_data, cost_model, costs, rho_admm) -> str:
    """One costs.txt row in the reference's 20-column layout
    (problem_joint_gravmag.F90:519-528)."""

    def get(key):
        return float(costs.get(key, 0.0))

    xg = costs.get("cross_grad_cost", np.zeros(3))
    xg = np.asarray(xg) if np.ndim(xg) else np.array([xg, 0, 0])
    vals = [
        cost_data[0], cost_data[1], cost_model[0], cost_model[1],
        get("admm_cost_0"), get("admm_cost_1"),
        rho_admm[0], rho_admm[1],
        get("damping_gradient_cost_x_0"), get("damping_gradient_cost_y_0"), get("damping_gradient_cost_z_0"),
        get("damping_gradient_cost_x_1"), get("damping_gradient_cost_y_1"), get("damping_gradient_cost_z_1"),
        float(xg[0]), float(xg[1]), float(xg[2]),
        get("clustering_cost_0"), get("clustering_cost_1"),
    ]
    return f" {it} " + " ".join(f"{v:.9E}" for v in vals)


def _require_finite(out, active, it):
    """Raise FloatingPointError naming the first of a major's costs, LSQR
    residual and model updates (in that order) that is not finite. PyTorch
    has no trap on the operation that makes a NaN, as jax_debug_nans is, so
    the check comes at the end of the major's solve."""
    named = [(f"cost {k}", v) for k, v in out["costs"].items()]
    named.append(("LSQR relative residual", out["lsqr_r"]))
    named += [(f"{PROBLEM_PREFIX[i]} model update", d) for i, d in zip(active, out["delta"])]
    for name, t in named:
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in the {name} of major iteration {it}")


def _require_finite_chunk(out, active, it, steps):
    """_require_finite for a fused chunk (host copies): each major's costs,
    in order, then the models at the chunk's end."""
    per = out["per_iteration"]
    for s in range(steps):
        named = [(f"cost {k}", v[s]) for k, v in per["costs"].items()]
        named += [("data costs", per["post_cost_data"][s]), ("model costs", per["pre_cost_model"][s])]
        for name, t in named:
            if not bool(torch.isfinite(t).all()):
                raise FloatingPointError(f"non-finite values in the {name} of major iteration {it + s}")
    for i, mdl in zip(active, out["model"]):
        if not bool(torch.isfinite(mdl).all()):
            raise FloatingPointError(
                f"non-finite values in the {PROBLEM_PREFIX[i]} model after major iteration {it + steps - 1}")


def _to_host(tree):
    """Every tensor of a nested dict/tuple copied to the host behind one wait
    for the device (a non-blocking copy from a CUDA device lands in pinned
    memory)."""
    cards = set()

    def copy(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.device.type == "cuda":
            cards.add(t.device)
        return t.to("cpu", non_blocking=True)

    host = tree_map(copy, tree)
    for d in cards:
        torch.cuda.synchronize(d)
    return host


def save_checkpoint(path, active, ctxs, admm_z, admm_u, rho_admm, m, it):
    """Mid-run state checkpoint (beyond the reference, which only snapshots
    models and loses the ADMM dual state on restart). The file name and keys
    are those of the JAX package, so either package resumes from the
    other's checkpoint."""
    payload = {"m": m, "it": it, "rho_admm": np.asarray(rho_admm), "active": np.asarray(active)}
    for a, i in enumerate(active):
        payload[f"model_{i}"] = np.asarray(ctxs[i].model.val)
        payload[f"prior_{i}"] = np.asarray(ctxs[i].model.val_prior)
        payload[f"admm_z_{i}"] = admm_z[a].cpu().numpy()
        payload[f"admm_u_{i}"] = admm_u[a].cpu().numpy()
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_checkpoint(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _with_paths(ipar, base_dir):
    """Shallow copy of InversionParams with bounds-file paths resolved."""
    import copy

    out = copy.copy(ipar)
    out.bounds_ADMM_file = tuple(
        os.path.join(base_dir, p) if p != "None" else p for p in ipar.bounds_ADMM_file
    )
    return out


def _read_depth_weight_file(cache_dir: str, problem_index: int) -> np.ndarray:
    """Binary depth-weight file (reference format: int32 N then float64 N,
    sensitivity_gravmag.F90:446-460)."""
    suffix = ("grav", "magn")[problem_index]
    path = os.path.join(cache_dir, f"sensit_{suffix}_weight")
    with open(path, "rb") as f:
        n = int(np.fromfile(f, np.int32, 1)[0])
        w = np.fromfile(f, np.float64, n)
    return w


def _read_mixtures(cfg: Config, base_dir: str) -> dict:
    """Clustering mixture + cell weights (reference:
    clustering_read_mixtures, clustering.F90:163-278), as float64 arrays."""
    ipar = cfg.inversion
    C = ipar.nclusters
    N = ipar.nelements_total
    with open(os.path.join(base_dir, ipar.mixture_file)) as f:
        nclusters_read = int(f.readline().split()[0])
        if nclusters_read != C:
            raise ValueError("The number of clusters is inconsistent!")
    table = load_table(os.path.join(base_dir, ipar.mixture_file), skiprows=1)
    cluster_weight = table[:, 0]
    mu = np.stack([table[:, 1], table[:, 3]])  # (2, C)
    sigma = np.stack([table[:, 2], table[:, 4], table[:, 5]])  # (3, C): s11, s22, s12

    if ipar.clustering_constraints_type != 1:
        with open(os.path.join(base_dir, ipar.cell_weights_file)) as f:
            n_read, c_read = (int(t) for t in f.readline().split()[:2])
            if n_read != N or c_read != C:
                raise ValueError("The clustering cell weights are inconsistent!")
        cell_weight = load_table(os.path.join(base_dir, ipar.cell_weights_file), skiprows=1)[:, :C]
    else:
        cw = cluster_weight / cluster_weight.sum()
        cell_weight = np.repeat(cw[None, :], N, axis=0)

    # Maximum of the mixture, assumed at one of the cluster centers
    # (clustering.F90:654-678), in float64 on the host.
    weight_loc = tuple(1.0 if w != 0.0 else 0.0 for w in ipar.clustering_weight_glob)
    mu_t, sigma_t, cell_t = (torch.as_tensor(a, dtype=torch.float64) for a in (mu, sigma, cell_weight))
    maxima = []
    for c in range(C):
        v1 = torch.full((N,), float(mu[0, c]), dtype=torch.float64)
        v2 = torch.full((N,), float(mu[1, c]), dtype=torch.float64)
        g, _ = gaussian_mixture(v1, v2, mu_t, sigma_t, cell_t, weight_loc)
        maxima.append(g.numpy())
    mixture_max = np.max(np.stack(maxima), axis=0)

    return dict(
        mixture_mu=mu, mixture_sigma=sigma, cell_weight=cell_weight, mixture_max=mixture_max
    )
