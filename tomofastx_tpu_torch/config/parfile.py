"""Parfile configuration system.

Drop-in compatible with the reference Tomofast-x Parfile dialect
(reference: parameters_init.f90:412-966; all keys and defaults enumerated in
Parameters_all.txt:1-217): line-oriented ``key = value`` pairs, ``#`` comments,
dotted hierarchical key names, any order, unknown keys warn.  Fortran-style
double literals (``1.d-5``) are accepted.

The parsed result is a typed, immutable-ish dataclass tree instead of the
reference's trio of Fortran derived types (t_parameters_grav / t_parameters_mag
/ t_parameters_inversion, parameters_gravmag.f90:29-110,
parameters_inversion.f90:45-136).  There is no broadcast step: the program is one
process (the reference broadcasts because only rank 0 reads,
parameters_init.f90:164-171).
"""

from __future__ import annotations

import dataclasses
import re
import sys
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# Problem indices (match the reference convention 1=grav, 2=magn; here 0-based).
GRAV = 0
MAGN = 1
PROBLEM_NAMES = ("grav", "magn")


def _fortran_float(tok: str) -> float:
    """Parse a number accepting Fortran double-precision exponents (1.d0, 2.D-5)."""
    return float(re.sub(r"[dD]", "e", tok))


@dataclass
class GravParams:
    """Gravity forward-problem parameters (reference: parameters_grav.f90:30,
    t_parameters_base in parameters_gravmag.f90:29-110)."""

    # Grid dims (shared by both problems).
    nx: int = 0
    ny: int = 0
    nz: int = 0
    model_grid_file: str = "None"
    # Data.
    ndata: int = 0
    ndata_components: int = 1
    nmodel_components: int = 1
    data_grid_file: str = "None"
    data_type: int = 1  # 1 = gravity, 2 = gradiometry (FTG)
    use_data_error: int = 0
    data_error_file: str = "None"
    use_synthetic_model: int = 0
    synthetic_model_file: str = "None"
    # Depth weighting.
    depth_weighting_type: int = 2
    depth_weighting_power: float = 2.0
    depth_weighting_beta: float = 1.0
    Z0: float = 0.0
    apply_local_weight: int = 0
    local_weight_file: str = "None"
    # Sensitivity kernel cache.
    sensit_read: int = 0
    sensit_path: str = "SENSIT/"
    # Compression.
    compression_type: int = 0
    compression_rate: float = 0.1
    # Units / axes.
    data_units_mult: float = 1.0
    model_units_mult: float = 1.0
    z_axis_dir: int = 1
    # Prior / starting models.
    prior_model_type: int = 1
    number_prior_models: int = 1
    prior_model_val: float = 0.0
    prior_model_file: str = "None"
    start_model_type: int = 1
    start_model_val: float = 0.0
    start_model_file: str = "None"
    # Output.
    vtk_model_label: str = "rho"
    # The ``tpu.*`` keys keep their names so one Parfile drives both
    # packages. Solver-side kernel representation: "dense", "packed"
    # (top-k gather layout), "tiled" (tile-union block layout), "auto".
    kernel_format: str = "dense"
    # Kernel storage dtype on device: "float32" (default) or "bfloat16".
    kernel_store: str = "float32"
    # 1 = compute forward predictions (and so residuals) through the
    # exact-physics matrix-free operator instead of the stored kernel, so
    # the major loop becomes iterative refinement over the stored kernel's
    # compression error.
    refine_forward: int = 0
    # Precision of the tpu.refineForward operator: "" = the solve dtype,
    # "single" or "double".
    refine_forward_precision: str = ""
    # 1 = write the sensitivity kernel disk cache after a dense build
    # (reference behavior, sensitivity_gravmag.F90:141-153); 0 skips it.
    sensit_write: int = 1
    # 1 = corner-lattice kernel build on tensor-product grids: evaluate the
    # prism corner antiderivatives once per lattice node per observation
    # and difference into rows. Values agree with the per-cell build to
    # summation-order rounding. 0 forces the per-cell build.
    lattice_build: int = 1
    # 1 = for float64 builds stored in <= 32 bits, round rows to float32
    # after the physics and depth weighting and compress in float32.
    # 0 keeps the reference's double-precision pipeline
    # (sensitivity_gravmag.F90:237-272).
    f64_build_f32_compress: int = 0
    # 1 = when the physics runs in float32, evaluate far cells by Gauss
    # quadrature instead of the closed form (whose alternating corner sums
    # cancel in float32). Ignored for float64 builds.
    far_field_quad: int = 1

    @property
    def nelements_total(self) -> int:
        return self.nx * self.ny * self.nz


@dataclass
class MagParams(GravParams):
    """Magnetic forward-problem parameters (reference: parameters_mag.f90:30-48).

    Adds the ambient-field description on top of the shared base."""

    mi: float = 90.0  # inclination (deg, positive below horizontal)
    md: float = 0.0  # declination (deg, positive east of true north)
    theta: float = 0.0  # azimuth of X axis (deg east of north)
    intensity: float = 50000.0  # ambient field intensity (nT)
    depth_weighting_power: float = 3.0
    vtk_model_label: str = "k"


@dataclass
class InversionParams:
    """Inversion parameters (reference: parameters_inversion.f90:45-136)."""

    nx: int = 0
    ny: int = 0
    nz: int = 0
    ndata: Tuple[int, int] = (0, 0)
    ndata_components: Tuple[int, int] = (1, 1)
    nmodel_components: int = 1

    ninversions: int = 10  # major iterations
    niter: int = 100  # minor (LSQR) iterations
    target_misfit: float = 0.0
    write_model_niter: int = 0
    rmin: float = 1.0e-13
    method: int = 1  # 1 = LSQR
    gamma: float = 0.0  # soft-threshold (ISTA ~L1); 0 = pure L2

    # Model damping (m - m_prior).
    alpha: Tuple[float, float] = (1.0e-11, 1.0e-8)
    norm_power: float = 2.0
    apply_local_damping_weight: int = 0
    damping_weight_file: Tuple[str, str] = ("None", "None")

    # Damping gradient (smoothing).
    beta: Tuple[float, float] = (0.0, 0.0)
    damp_grad_weight_type: int = 1
    damping_gradient_file: Tuple[str, str] = ("None", "None")

    # Joint inversion.
    problem_weight: Tuple[float, float] = (1.0, 0.0)
    column_weight_multiplier: Tuple[float, float] = (4.0e3, 1.0)

    # ADMM disjoint-interval bounds.
    admm_type: int = 0  # 0 = off, 1 = on
    admm_bound_type: int = 1  # 1 = global, 2 = local from file
    nlithos: int = 1
    admm_bounds: Tuple[Optional[List[float]], Optional[List[float]]] = (None, None)
    bounds_ADMM_file: Tuple[str, str] = ("None", "None")
    rho_ADMM: Tuple[float, float] = (1.0e-7, 1.0e5)
    data_cost_threshold_ADMM: float = 1.0e-4
    weight_multiplier_ADMM: float = 1.0
    max_weight_ADMM: float = 1.0e10

    # Cross-gradient.
    cross_grad_weight: float = 0.0
    derivative_type: int = 1
    keep_model_constant: Tuple[int, int] = (0, 0)
    vec_field_type: int = 0
    vec_field_file: str = "None"

    # Clustering.
    clustering_weight_glob: Tuple[float, float] = (0.0, 0.0)
    nclusters: int = 4
    mixture_file: str = "None"
    cell_weights_file: str = "None"
    clustering_opt_type: int = 2  # 1 = normal, 2 = log
    clustering_constraints_type: int = 2  # 1 = global, 2 = local

    # Compression (duplicated from forward params for the solver).
    compression_type: int = 0

    @property
    def nelements_total(self) -> int:
        return self.nx * self.ny * self.nz


@dataclass
class Config:
    """Root configuration: output paths + the three parameter groups
    (mirrors the triple (gpar, mpar, ipar) handed around by the reference)."""

    path_output: str = "output/test/"
    description: str = ""
    grav: GravParams = field(default_factory=GravParams)
    magn: MagParams = field(default_factory=MagParams)
    inversion: InversionParams = field(default_factory=InversionParams)

    def problem_params(self, i: int):
        return self.grav if i == GRAV else self.magn

    def solve_problem(self, i: int) -> bool:
        """Which problems participate (reference: problem_joint_gravmag.F90:113-116)."""
        return self.inversion.problem_weight[i] != 0.0


def _set_tuple(t, i, v):
    lst = list(t)
    lst[i] = v
    return tuple(lst)


def parse_parfile_lines(lines, warn_unknown: bool = True) -> Config:
    """Parse Parfile content into a :class:`Config`.

    Mirrors read_parfile (parameters_init.f90:412-966): ``key = value`` with
    ``#`` comments; unknown keys produce a warning, not an error."""
    cfg = Config()
    g, m, inv = cfg.grav, cfg.magn, cfg.inversion

    def fval(v):
        return _fortran_float(v.split()[0])

    def ival(v):
        return int(v.split()[0])

    def sval(v):
        return v.strip()

    for raw in lines:
        line = raw.split("#", 1)[0].strip()
        if not line or line.startswith(("*", "=")) or "=" not in line:
            continue
        key, _, val = line.partition("=")
        key = key.strip()
        val = val.strip()
        if not key or not val:
            continue

        try:
            handled = _apply_key(cfg, key, val, fval, ival, sval)
        except (ValueError, IndexError) as e:
            raise ValueError(f"Bad value for Parfile key '{key}': {val!r} ({e})") from e

        if not handled and warn_unknown:
            print(f"WARNING: unknown Parfile key '{key}' (ignored)", file=sys.stderr)

    # Propagate shared fields (the reference copies these between structs,
    # parameters_init.f90:204-208 and initialize_parameters).
    inv.nx, inv.ny, inv.nz = g.nx, g.ny, g.nz
    m.nx, m.ny, m.nz = g.nx, g.ny, g.nz
    inv.ndata = (g.ndata, m.ndata)
    inv.ndata_components = (g.ndata_components, m.ndata_components)
    inv.nmodel_components = m.nmodel_components
    inv.compression_type = g.compression_type
    m.compression_type = g.compression_type
    m.compression_rate = g.compression_rate
    m.sensit_read = g.sensit_read
    m.sensit_path = g.sensit_path
    m.number_prior_models = g.number_prior_models
    m.prior_model_type = g.prior_model_type
    m.start_model_type = g.start_model_type
    g.nmodel_components = 1  # gravity model is always scalar density

    # Sanity checks (reference: parameters_init.f90:952-962).
    if m.nmodel_components > 1 and inv.problem_weight[GRAV] != 0.0:
        raise ValueError(
            "For the magnetisation inversion the gravity problem should be disabled! "
            "(set inversion.joint.grav.problemWeight = 0)"
        )
    if inv.admm_type > 0 and inv.admm_bound_type == 1:
        for i in (GRAV, MAGN):
            if cfg.solve_problem(i) and inv.admm_bounds[i] is not None:
                b = inv.admm_bounds[i]
                if len(b) != 2 * inv.nlithos:
                    raise ValueError(
                        f"ADMM bounds for {PROBLEM_NAMES[i]} must have "
                        f"2*nLithologies={2 * inv.nlithos} values, got {len(b)}"
                    )
    return cfg


def _apply_key(cfg: Config, key: str, val: str, fval, ival, sval) -> bool:
    """Apply one key=value. Returns False for unknown keys."""
    g, m, inv = cfg.grav, cfg.magn, cfg.inversion

    K = key
    if K == "global.outputFolderPath":
        cfg.path_output = sval(val)
    elif K == "global.description":
        cfg.description = sval(val)
    elif K == "global.grav.dataUnitsMultiplier":
        g.data_units_mult = fval(val)
    elif K == "global.magn.dataUnitsMultiplier":
        m.data_units_mult = fval(val)
    elif K == "global.grav.modelUnitsMultiplier":
        g.model_units_mult = fval(val)
    elif K == "global.magn.modelUnitsMultiplier":
        m.model_units_mult = fval(val)
    elif K == "global.zAxisDirection":
        g.z_axis_dir = m.z_axis_dir = ival(val)
    elif K == "modelGrid.size":
        toks = val.split()
        g.nx, g.ny, g.nz = int(toks[0]), int(toks[1]), int(toks[2])
    elif K == "modelGrid.grav.file":
        g.model_grid_file = sval(val)
    elif K == "modelGrid.magn.file":
        m.model_grid_file = sval(val)
    elif K == "modelGrid.magn.nModelComponents":
        m.nmodel_components = ival(val)
    elif K == "forward.data.grav.nData":
        g.ndata = ival(val)
    elif K == "forward.data.magn.nData":
        m.ndata = ival(val)
    elif K == "forward.data.grav.dataGridFile":
        g.data_grid_file = sval(val)
    elif K == "forward.data.magn.dataGridFile":
        m.data_grid_file = sval(val)
    elif K == "forward.data.grav.nDataComponents":
        g.ndata_components = ival(val)
    elif K == "forward.data.magn.nDataComponents":
        m.ndata_components = ival(val)
    elif K == "forward.data.grav.type":
        g.data_type = ival(val)
    elif K == "forward.data.grav.useError":
        g.use_data_error = ival(val)
    elif K == "forward.data.magn.useError":
        m.use_data_error = ival(val)
    elif K == "forward.data.grav.errorFile":
        g.data_error_file = sval(val)
    elif K == "forward.data.magn.errorFile":
        m.data_error_file = sval(val)
    elif K == "forward.data.grav.useSyntheticModelForDataValues":
        g.use_synthetic_model = ival(val)
    elif K == "forward.data.magn.useSyntheticModelForDataValues":
        m.use_synthetic_model = ival(val)
    elif K == "forward.data.grav.syntheticModelFile":
        g.synthetic_model_file = sval(val)
    elif K == "forward.data.magn.syntheticModelFile":
        m.synthetic_model_file = sval(val)
    elif K == "forward.magneticField.inclination":
        m.mi = fval(val)
    elif K == "forward.magneticField.declination":
        m.md = fval(val)
    elif K == "forward.magneticField.intensity_nT":
        m.intensity = fval(val)
    elif K == "forward.magneticField.XaxisDeclination":
        m.theta = fval(val)
    elif K == "forward.depthWeighting.type":
        g.depth_weighting_type = m.depth_weighting_type = ival(val)
    elif K == "forward.depthWeighting.grav.power":
        g.depth_weighting_power = fval(val)
    elif K == "forward.depthWeighting.grav.beta":
        g.depth_weighting_beta = fval(val)
    elif K == "forward.depthWeighting.grav.Z0":
        g.Z0 = fval(val)
    elif K == "forward.depthWeighting.magn.power":
        m.depth_weighting_power = fval(val)
    elif K == "forward.depthWeighting.magn.beta":
        m.depth_weighting_beta = fval(val)
    elif K == "forward.depthWeighting.magn.Z0":
        m.Z0 = fval(val)
    elif K == "forward.depthWeighting.applyLocalWeight":
        g.apply_local_weight = m.apply_local_weight = ival(val)
    elif K == "forward.depthWeighting.grav.file":
        g.local_weight_file = sval(val)
    elif K == "forward.depthWeighting.magn.file":
        m.local_weight_file = sval(val)
    elif K == "sensit.readFromFiles":
        g.sensit_read = m.sensit_read = ival(val)
    elif K == "sensit.folderPath":
        g.sensit_path = m.sensit_path = sval(val)
    elif K == "forward.matrixCompression.type":
        g.compression_type = m.compression_type = ival(val)
    elif K == "forward.matrixCompression.rate":
        g.compression_rate = m.compression_rate = fval(val)
    elif K == "inversion.priorModel.type":
        g.prior_model_type = m.prior_model_type = ival(val)
    elif K == "inversion.priorModel.nModels":
        g.number_prior_models = m.number_prior_models = ival(val)
    elif K == "inversion.priorModel.grav.value":
        g.prior_model_val = fval(val)
    elif K == "inversion.priorModel.magn.value":
        m.prior_model_val = fval(val)
    elif K == "inversion.priorModel.grav.file":
        g.prior_model_file = sval(val)
    elif K == "inversion.priorModel.magn.file":
        m.prior_model_file = sval(val)
    elif K == "inversion.startingModel.type":
        g.start_model_type = m.start_model_type = ival(val)
    elif K == "inversion.startingModel.grav.value":
        g.start_model_val = fval(val)
    elif K == "inversion.startingModel.magn.value":
        m.start_model_val = fval(val)
    elif K == "inversion.startingModel.grav.file":
        g.start_model_file = sval(val)
    elif K == "inversion.startingModel.magn.file":
        m.start_model_file = sval(val)
    elif K == "inversion.nMajorIterations":
        inv.ninversions = ival(val)
    elif K == "inversion.nMinorIterations":
        inv.niter = ival(val)
    elif K == "inversion.targetMisfit":
        inv.target_misfit = fval(val)
    elif K == "inversion.writeModelEveryNiter":
        inv.write_model_niter = ival(val)
    elif K == "inversion.minResidual":
        inv.rmin = fval(val)
    elif K == "inversion.solver":
        inv.method = ival(val)
    elif K == "inversion.softThresholdL1":
        inv.gamma = fval(val)
    elif K == "inversion.modelDamping.grav.weight":
        inv.alpha = _set_tuple(inv.alpha, GRAV, fval(val))
    elif K == "inversion.modelDamping.magn.weight":
        inv.alpha = _set_tuple(inv.alpha, MAGN, fval(val))
    elif K == "inversion.modelDamping.normPower":
        inv.norm_power = fval(val)
    elif K == "inversion.modelDamping.applyLocalWeight":
        inv.apply_local_damping_weight = ival(val)
    elif K == "inversion.modelDamping.grav.file":
        inv.damping_weight_file = _set_tuple(inv.damping_weight_file, GRAV, sval(val))
    elif K == "inversion.modelDamping.magn.file":
        inv.damping_weight_file = _set_tuple(inv.damping_weight_file, MAGN, sval(val))
    elif K == "inversion.joint.grav.problemWeight":
        inv.problem_weight = _set_tuple(inv.problem_weight, GRAV, fval(val))
    elif K == "inversion.joint.magn.problemWeight":
        inv.problem_weight = _set_tuple(inv.problem_weight, MAGN, fval(val))
    elif K == "inversion.joint.grav.columnWeightMultiplier":
        inv.column_weight_multiplier = _set_tuple(inv.column_weight_multiplier, GRAV, fval(val))
    elif K == "inversion.joint.magn.columnWeightMultiplier":
        inv.column_weight_multiplier = _set_tuple(inv.column_weight_multiplier, MAGN, fval(val))
    elif K == "inversion.admm.enableADMM":
        inv.admm_type = ival(val)
    elif K == "inversion.admm.boundType":
        inv.admm_bound_type = ival(val)
    elif K == "inversion.admm.nLithologies":
        inv.nlithos = ival(val)
    elif K == "inversion.admm.grav.bounds":
        inv.admm_bounds = _set_tuple(
            inv.admm_bounds, GRAV, [_fortran_float(t) for t in val.split()]
        )
    elif K == "inversion.admm.magn.bounds":
        inv.admm_bounds = _set_tuple(
            inv.admm_bounds, MAGN, [_fortran_float(t) for t in val.split()]
        )
    elif K == "inversion.admm.grav.boundsFile":
        inv.bounds_ADMM_file = _set_tuple(inv.bounds_ADMM_file, GRAV, sval(val))
    elif K == "inversion.admm.magn.boundsFile":
        inv.bounds_ADMM_file = _set_tuple(inv.bounds_ADMM_file, MAGN, sval(val))
    elif K == "inversion.admm.grav.weight":
        inv.rho_ADMM = _set_tuple(inv.rho_ADMM, GRAV, fval(val))
    elif K == "inversion.admm.magn.weight":
        inv.rho_ADMM = _set_tuple(inv.rho_ADMM, MAGN, fval(val))
    elif K == "inversion.admm.dataCostThreshold":
        inv.data_cost_threshold_ADMM = fval(val)
    elif K == "inversion.admm.weightMultiplier":
        inv.weight_multiplier_ADMM = fval(val)
    elif K == "inversion.admm.maxWeight":
        inv.max_weight_ADMM = fval(val)
    elif K == "inversion.dampingGradient.weightType":
        inv.damp_grad_weight_type = ival(val)
    elif K == "inversion.dampingGradient.grav.weight":
        inv.beta = _set_tuple(inv.beta, GRAV, fval(val))
    elif K == "inversion.dampingGradient.magn.weight":
        inv.beta = _set_tuple(inv.beta, MAGN, fval(val))
    elif K == "inversion.dampingGradient.grav.weightsFile":
        inv.damping_gradient_file = _set_tuple(inv.damping_gradient_file, GRAV, sval(val))
    elif K == "inversion.dampingGradient.magn.weightsFile":
        inv.damping_gradient_file = _set_tuple(inv.damping_gradient_file, MAGN, sval(val))
    elif K == "inversion.crossGradient.weight":
        inv.cross_grad_weight = fval(val)
    elif K == "inversion.crossGradient.derivativeType":
        inv.derivative_type = ival(val)
    elif K == "inversion.crossGradient.grav.keepModelConstant":
        inv.keep_model_constant = _set_tuple(inv.keep_model_constant, GRAV, ival(val))
    elif K == "inversion.crossGradient.magn.keepModelConstant":
        inv.keep_model_constant = _set_tuple(inv.keep_model_constant, MAGN, ival(val))
    elif K == "inversion.crossGradient.vectorFieldType":
        inv.vec_field_type = ival(val)
    elif K == "inversion.crossGradient.vectorFieldFile":
        inv.vec_field_file = sval(val)
    elif K == "inversion.clustering.grav.weight":
        inv.clustering_weight_glob = _set_tuple(inv.clustering_weight_glob, GRAV, fval(val))
    elif K == "inversion.clustering.magn.weight":
        inv.clustering_weight_glob = _set_tuple(inv.clustering_weight_glob, MAGN, fval(val))
    elif K == "inversion.clustering.nClusters":
        inv.nclusters = ival(val)
    elif K == "inversion.clustering.mixtureFile":
        inv.mixture_file = sval(val)
    elif K == "inversion.clustering.cellWeightsFile":
        inv.cell_weights_file = sval(val)
    elif K == "inversion.clustering.optimizationType":
        inv.clustering_opt_type = ival(val)
    elif K == "inversion.clustering.constraintsType":
        inv.clustering_constraints_type = ival(val)
    elif K == "tpu.kernelFormat":
        g.kernel_format = m.kernel_format = sval(val)
    elif K == "tpu.sensitWriteCache":
        g.sensit_write = m.sensit_write = ival(val)
    elif K == "tpu.refineForward":
        g.refine_forward = m.refine_forward = ival(val)
    elif K == "tpu.refineForwardPrecision":
        v = sval(val)
        if v not in ("", "single", "double"):
            raise ValueError(f"tpu.refineForwardPrecision must be single|double, got {v}")
        g.refine_forward_precision = m.refine_forward_precision = v
    elif K == "tpu.latticeBuild":
        g.lattice_build = m.lattice_build = ival(val)
    elif K == "tpu.f64BuildF32Compress":
        g.f64_build_f32_compress = m.f64_build_f32_compress = ival(val)
    elif K == "tpu.farFieldQuad":
        g.far_field_quad = m.far_field_quad = ival(val)
    elif K == "tpu.kernelStoreDtype":
        v = sval(val)
        if v not in ("float32", "bfloat16"):
            raise ValueError(f"tpu.kernelStoreDtype must be float32 or bfloat16, got {v}")
        g.kernel_store = m.kernel_store = v
    elif K == "output.paraview.grav.modelLabel":
        g.vtk_model_label = sval(val)
    elif K == "output.paraview.magn.modelLabel":
        m.vtk_model_label = sval(val)
    else:
        return False
    return True


def read_parfile(path: str, warn_unknown: bool = True) -> Config:
    """Read and parse a Parfile from disk."""
    with open(path, "r", errors="replace") as f:
        return parse_parfile_lines(f.readlines(), warn_unknown=warn_unknown)


def config_summary(cfg: Config) -> str:
    """Human-readable dump of all parameters (mirrors the reference's rank-0
    parameter echo, parameters_init.f90:58-88)."""
    out = []
    for name, obj in (("grav", cfg.grav), ("magn", cfg.magn), ("inversion", cfg.inversion)):
        out.append(f"[{name}]")
        for f_ in dataclasses.fields(obj):
            out.append(f"  {f_.name} = {getattr(obj, f_.name)}")
    return "\n".join(out)
