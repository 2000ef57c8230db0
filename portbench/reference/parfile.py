"""The Parfile keys the reference follows, with Tomofast-x's defaults
(Parameters_all.txt of Tomofast-x v2.0), and nothing more.

A Parfile is `key = value` lines, `#` comments, Fortran doubles (`1.d-5`)
allowed, a later line setting its key anew. A key that only names a file
the benchmark's generator hands the reference directly, or one of the
program's own `tpu.*` options, is passed over; any other key this reader
does not know is an error, so that a configuration the reference would not
follow fails loudly instead of being compared with something else.
"""

from __future__ import annotations

import re
from types import SimpleNamespace

GRAV, MAGN = 0, 1
BOTH = "both"


def _number(value):
    return float(re.sub(r"[dD]", "e", value.split()[0]))


def _int(value):
    return int(value.split()[0])


def _text(value):
    return value.strip()


def _numbers(value):
    return [_number(t) for t in value.split()]


def _size(value):
    return tuple(int(t) for t in value.split()[:3])


# key -> (attribute, parser, where): where is GRAV or MAGN for one problem's
# parameter, BOTH for a value both problems take, or ("pair", i) for entry i
# of an inversion parameter held per problem, or None for an inversion one.
KEYS = {
    "modelGrid.size": ("size", _size, None),
    "modelGrid.magn.nModelComponents": ("nmodel_components", _int, MAGN),
    "global.grav.modelUnitsMultiplier": ("model_units_mult", _number, GRAV),
    "global.magn.modelUnitsMultiplier": ("model_units_mult", _number, MAGN),
    "forward.data.grav.type": ("data_type", _int, GRAV),
    "forward.magneticField.inclination": ("mi", _number, MAGN),
    "forward.magneticField.declination": ("md", _number, MAGN),
    "forward.magneticField.intensity_nT": ("intensity", _number, MAGN),
    "forward.magneticField.XaxisDeclination": ("theta", _number, MAGN),
    "forward.depthWeighting.type": ("depth_weighting_type", _int, BOTH),
    "forward.matrixCompression.type": ("compression_type", _int, BOTH),
    "forward.matrixCompression.rate": ("compression_rate", _number, BOTH),
    "tpu.kernelFormat": ("kernel_format", _text, BOTH),
    "inversion.nMajorIterations": ("ninversions", _int, None),
    "inversion.nMinorIterations": ("niter", _int, None),
    "inversion.targetMisfit": ("target_misfit", _number, None),
    "inversion.minResidual": ("rmin", _number, None),
    "inversion.softThresholdL1": ("gamma", _number, None),
    "inversion.modelDamping.normPower": ("norm_power", _number, None),
    "inversion.modelDamping.applyLocalWeight": ("apply_local_damping_weight", _int, None),
    "inversion.admm.enableADMM": ("admm_type", _int, None),
    "inversion.admm.boundType": ("admm_bound_type", _int, None),
    "inversion.admm.nLithologies": ("nlithos", _int, None),
    "inversion.admm.dataCostThreshold": ("data_cost_threshold_ADMM", _number, None),
    "inversion.admm.weightMultiplier": ("weight_multiplier_ADMM", _number, None),
    "inversion.admm.maxWeight": ("max_weight_ADMM", _number, None),
    "inversion.dampingGradient.weightType": ("damp_grad_weight_type", _int, None),
    "inversion.crossGradient.weight": ("cross_grad_weight", _number, None),
    "inversion.crossGradient.derivativeType": ("derivative_type", _int, None),
    "inversion.crossGradient.vectorFieldType": ("vec_field_type", _int, None),
    "inversion.clustering.nClusters": ("nclusters", _int, None),
    "inversion.clustering.optimizationType": ("clustering_opt_type", _int, None),
    "inversion.clustering.constraintsType": ("clustering_constraints_type", _int, None),
}
for _i, _name in ((GRAV, "grav"), (MAGN, "magn")):
    KEYS.update({
        f"forward.data.{_name}.nData": ("ndata", _int, _i),
        f"forward.data.{_name}.nDataComponents": ("ndata_components", _int, _i),
        f"forward.data.{_name}.useError": ("use_data_error", _int, _i),
        f"forward.data.{_name}.useSyntheticModelForDataValues": ("use_synthetic_model", _int, _i),
        f"forward.depthWeighting.{_name}.power": ("depth_weighting_power", _number, _i),
        f"forward.depthWeighting.{_name}.beta": ("depth_weighting_beta", _number, _i),
        f"inversion.priorModel.{_name}.value": ("prior_model_val", _number, _i),
        f"inversion.startingModel.{_name}.value": ("start_model_val", _number, _i),
        f"inversion.modelDamping.{_name}.weight": ("alpha", _number, ("pair", _i)),
        f"inversion.joint.{_name}.problemWeight": ("problem_weight", _number, ("pair", _i)),
        f"inversion.joint.{_name}.columnWeightMultiplier": ("column_weight_multiplier", _number, ("pair", _i)),
        f"inversion.admm.{_name}.bounds": ("admm_bounds", _numbers, ("pair", _i)),
        f"inversion.admm.{_name}.weight": ("rho_ADMM", _number, ("pair", _i)),
        f"inversion.dampingGradient.{_name}.weight": ("beta", _number, ("pair", _i)),
        f"inversion.crossGradient.{_name}.keepModelConstant": ("keep_model_constant", _int, ("pair", _i)),
        f"inversion.clustering.{_name}.weight": ("clustering_weight_glob", _number, ("pair", _i)),
    })

# Files the generator hands the reference as arrays, and the output's place.
PASSED_OVER = {
    "global.outputFolderPath", "global.description", "modelGrid.grav.file", "modelGrid.magn.file",
    "forward.data.grav.dataGridFile", "forward.data.magn.dataGridFile", "forward.data.grav.syntheticModelFile",
    "forward.data.magn.syntheticModelFile", "sensit.readFromFiles", "sensit.folderPath",
    "inversion.clustering.mixtureFile",
}

PROBLEM = dict(ndata=0, ndata_components=1, nmodel_components=1, data_type=1, use_data_error=0,
               use_synthetic_model=0, depth_weighting_type=2, depth_weighting_power=2.0, depth_weighting_beta=1.0,
               compression_type=0, compression_rate=0.1, model_units_mult=1.0, prior_model_val=0.0,
               start_model_val=0.0, kernel_format="dense")
MAGNETIC = dict(mi=90.0, md=0.0, theta=0.0, intensity=50000.0, depth_weighting_power=3.0)
INVERSION = dict(ninversions=10, niter=100, target_misfit=0.0, rmin=1.0e-13, gamma=0.0, alpha=[1.0e-11, 1.0e-8],
                 norm_power=2.0, apply_local_damping_weight=0, beta=[0.0, 0.0], damp_grad_weight_type=1,
                 problem_weight=[1.0, 0.0], column_weight_multiplier=[4.0e3, 1.0], admm_type=0, admm_bound_type=1,
                 nlithos=1, admm_bounds=[None, None], rho_ADMM=[1.0e-7, 1.0e5], data_cost_threshold_ADMM=1.0e-4,
                 weight_multiplier_ADMM=1.0, max_weight_ADMM=1.0e10, cross_grad_weight=0.0, derivative_type=1,
                 keep_model_constant=[0, 0], vec_field_type=0, clustering_weight_glob=[0.0, 0.0], nclusters=4,
                 clustering_opt_type=2, clustering_constraints_type=2)


class Config:
    """The two problems' parameters and the inversion's, as read."""

    def __init__(self, lines):
        self.grav = SimpleNamespace(is_magn=False, **PROBLEM)
        self.magn = SimpleNamespace(is_magn=True, **{**PROBLEM, **MAGNETIC})
        inv = self.inversion = SimpleNamespace(**{k: list(v) if isinstance(v, list) else v
                                                  for k, v in INVERSION.items()})
        size = (0, 0, 0)
        for raw in lines:
            line = raw.split("#", 1)[0].strip()
            key, _, value = (part.strip() for part in line.partition("="))
            if not key or not value:
                continue
            if key in PASSED_OVER or (key.startswith("tpu.") and key not in KEYS):
                continue
            if key not in KEYS:
                raise NotImplementedError(f"the reference does not follow the Parfile key {key!r}")
            attr, parse, where = KEYS[key]
            v = parse(value)
            if attr == "size":
                size = v
            elif where is None:
                setattr(inv, attr, v)
            elif where == BOTH:
                setattr(self.grav, attr, v)
                setattr(self.magn, attr, v)
            elif isinstance(where, tuple):
                getattr(inv, attr)[where[1]] = v
            else:
                setattr(self.problem_params(where), attr, v)
        self.grav.nmodel_components = 1
        inv.nx, inv.ny, inv.nz = size
        inv.ndata = (self.grav.ndata, self.magn.ndata)
        inv.ndata_components = (self.grav.ndata_components, self.magn.ndata_components)
        inv.nmodel_components = self.magn.nmodel_components
        inv.compression_type = self.grav.compression_type
        for attr in ("alpha", "problem_weight", "column_weight_multiplier", "admm_bounds", "rho_ADMM", "beta",
                     "keep_model_constant", "clustering_weight_glob"):
            setattr(inv, attr, tuple(getattr(inv, attr)))

    def problem_params(self, i):
        return self.grav if i == GRAV else self.magn

    def solve_problem(self, i):
        return self.inversion.problem_weight[i] != 0.0


def read_parfile(path):
    with open(path) as f:
        return Config(f.readlines())
