"""The full-tensor gradiometry (FTG) problem of chip_smoke.py, written by its
own input and Parfile writers at a reduced size (24 x 24 x 12 cells, 144
observations x 6 components), held against the JAX workflow on the CPU in
float64 from the cache the JAX run wrote: costs rtol 1e-8, final model 1e-8
of its range. At the 3-lithology ADMM weight of the gravity runs (1e-7) both
packages raise the data cost in the third major; at the FTG path's weight,
scaled by the FTG rows' size, it falls in every major."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tomofastx_tpu.config.parfile import read_parfile as jread
from tomofastx_tpu.inversion.workflow import solve_problem_joint_gravmag as jsolve

from tomofastx_tpu_torch.config.parfile import read_parfile as tread
from tomofastx_tpu_torch.inversion import workflow as twf
from tomofastx_tpu_torch.io import data_io, model_io
from tomofastx_tpu_torch.ops import sensitivity as tsens

SIZE, SIDE = (24, 24, 12), 12


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    cs = _smoke()
    work = str(tmp_path_factory.mktemp("smoke"))
    return cs, work, cs.write_inputs(work, *SIZE, SIDE, variants=("components",))


def _data_costs(path):
    with open(path) as f:
        return [float(ln.split()[1]) for ln in f if not ln.startswith("#")]


@pytest.mark.parametrize("weight,rises", [("1.d-7", True), (None, False)], ids=["gravity-weight", "ftg-weight"])
def test_smoke_ftg_problem_matches_jax(smoke, weight, rises):
    """Both packages from one cache. With the gravity runs' ADMM weight the
    third major's data cost lies above the second's in both packages, and
    in the port's float32 solve as well: the rise is the method's on this
    problem, not the port's or float32's."""
    cs, work, inputs = smoke
    tag = weight or "ftg"
    extra = [f"inversion.admm.grav.weight = {weight}"] if weight else []
    jout = os.path.join(work, f"jax_{tag}")
    pf = cs.write_parfile(work, f"Parfile_jax_{tag}.txt", inputs, jout, cs.N_MINOR, fmt=None, kind="ftg", extra=extra)
    rj = jsolve(jread(pf), solve_dtype=jnp.float64, compute_dtype=jnp.float64, verbose=False)
    cj = _data_costs(os.path.join(jout, "costs.txt"))
    for dt in (torch.float64, torch.float32):
        tout = os.path.join(work, f"port_{tag}_{dt}")
        pf = cs.write_parfile(work, f"Parfile_port_{tag}.txt", inputs, tout, cs.N_MINOR, fmt=None, kind="ftg",
                              extra=extra + ["sensit.readFromFiles = 1", f"sensit.folderPath = {jout}/SENSIT/"])
        rt = twf.solve_problem_joint_gravmag(tread(pf), solve_dtype=dt, verbose=False, device="cpu")
        ct = _data_costs(os.path.join(tout, "costs.txt"))
        assert len(ct) == len(cj) == cs.N_MAJOR + 1
        assert (ct[3] > ct[2]) == rises and ct[2] < ct[1] < ct[0]
        if dt == torch.float64:
            np.testing.assert_allclose(ct, cj, rtol=1e-8)
            mj, mt = rj.models[0].val, rt.models[0].val
            np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-8 * (mj.max() - mj.min()))
    assert (cj[3] > cj[2]) == rises


def test_ftg_rows_are_a_hundredth_of_the_gz_rows(smoke):
    """The FTG path's ADMM weight is the gravity runs' 1e-7 over 100: the
    root mean square of a depth-weighted FTG row is about a hundredth of a
    g_z row's on the smoke geometry."""
    cs, work, inputs = smoke
    rms = {}
    for kind in ("grav", "ftg"):
        cfg = tread(cs.write_parfile(work, f"Parfile_rows_{kind}.txt", inputs, work, 1, fmt=None, kind=kind,
                                     compression=0)).grav
        grid = model_io.read_model_grid(cfg.model_grid_file, *SIZE)
        data = data_io.read_data_points(cfg.data_grid_file, cfg.ndata, cfg.ndata_components, cfg.data_units_mult,
                                        cfg.z_axis_dir, grid_only=True)
        cw = tsens.calculate_depth_weight(cfg, grid, data, torch.float64, "cpu")
        S = tsens.compute_sensitivity(cfg, grid, data, cw, store_dtype=torch.float64, device="cpu").S
        rms[kind] = float(S.norm() / S.shape[0] ** 0.5)
    assert 1 / 200 < rms["ftg"] / rms["grav"] < 1 / 50
