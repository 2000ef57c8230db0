"""Parfile inputs of the ported workflow that change what is read, held
against the JAX workflow from one shared cache on a joint gravity + magnetic
problem: data-error weighting (forward.data.*.useError), elevation-space
inputs (global.zAxisDirection = -1), several prior models and prior and
starting models from files (inversion.priorModel.nModels / .file,
inversion.startingModel.file). CPU, float64, seeded inputs; the problem and
the comparisons are those of tests/test_torch_joint.py."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tomofastx_tpu.config.parfile import parse_parfile_lines as jparse
from tomofastx_tpu.inversion.workflow import solve_problem_joint_gravmag as jsolve

from tomofastx_tpu_torch.config.parfile import parse_parfile_lines as tparse
from tomofastx_tpu_torch.inversion import workflow as twf

from test_torch_joint import KINDS, N, ND, _compare, _costs, _lines, _same_checkpoint, _write_inputs
from util_fixtures import write_values_file


def _errors(tmp):
    """Per-datum standard deviations of both problems, from a seed, spread
    over a factor of 4 about 1 (so that the balance of the two problems that
    the problem weights set stays as it is)."""
    rng = np.random.default_rng(12)
    lines = []
    for name in ("grav", "magn"):
        path = f"{tmp}/err_{name}.txt"
        with open(path, "w") as f:
            f.write(f"{ND}\n")
            np.savetxt(f, rng.uniform(0.5, 2.0, ND)[:, None], fmt="%.9E")
        lines += [f"forward.data.{name}.useError = 1", f"forward.data.{name}.errorFile = {path}"]
    return lines


def _z_up(tmp):
    """The grid and the observation files rewritten in elevation space (z up:
    depths negated, the corners of each cell swapped)."""
    with open(f"{tmp}/grid.txt") as f:
        rows = f.read().splitlines()
    with open(f"{tmp}/grid.txt", "w") as f:
        f.write(rows[0] + "\n")
        for ln in rows[1:]:
            t = ln.split()
            f.write(" ".join(t[:4] + [f"{-float(t[5]):.3f}", f"{-float(t[4]):.3f}"] + t[6:]) + "\n")
    with open(f"{tmp}/data1.txt") as f:
        rows = f.read().splitlines()
    with open(f"{tmp}/data1.txt", "w") as f:
        f.write(rows[0] + "\n")
        for ln in rows[1:]:
            t = ln.split()
            f.write(" ".join(t[:2] + [f"{-float(t[2]):.3f}"] + t[3:]) + "\n")
    return ["global.zAxisDirection = -1"]


def _models_from_files(tmp):
    """Two prior models per problem (the second named <file>_2) and a
    starting model per problem, from files."""
    rng = np.random.default_rng(13)
    lines = ["inversion.priorModel.type = 2", "inversion.priorModel.nModels = 2", "inversion.startingModel.type = 2"]
    for name, scale in (("grav", 20.0), ("magn", 0.004)):
        prior, start = f"{tmp}/prior_{name}.txt", f"{tmp}/start_{name}.txt"
        write_values_file(prior, scale * rng.normal(size=(N, 1)))
        write_values_file(prior + "_2", scale * rng.normal(size=(N, 1)))
        write_values_file(start, scale * rng.normal(size=(N, 1)))
        lines += [f"inversion.priorModel.{name}.file = {prior}", f"inversion.startingModel.{name}.file = {start}"]
    return lines


@pytest.mark.parametrize("inputs", [_errors, _z_up, _models_from_files],
                         ids=["data-errors", "z-up", "prior-and-starting-models-from-files"])
@pytest.mark.parametrize("fmt", ["tiled", "dense"])
def test_inputs_match_jax(tmp_path, inputs, fmt):
    """Both packages from the cache the JAX run wrote, the joint problem: the
    comparisons of tests/test_torch_joint.py, for the folder of every prior
    model."""
    tmp = str(tmp_path)
    _write_inputs(tmp)
    extra = inputs(tmp)
    jout, tout = f"{tmp}/jax", f"{tmp}/torch"
    rj = jsolve(jparse(_lines(tmp, "joint", jout, fmt=fmt) + extra), solve_dtype=jnp.float64,
                compute_dtype=jnp.float64, verbose=False)
    tlines = _lines(tmp, "joint", tout, fmt=fmt) + extra + [
        "sensit.readFromFiles = 1", f"sensit.folderPath = {jout}/SENSIT/"]
    rt = twf.solve_problem_joint_gravmag(tparse(tlines), solve_dtype=torch.float64, verbose=False, device="cpu")
    priors = 2 if inputs is _models_from_files else 1
    _compare("joint", rj, jout, rt, tout, priors=priors)
    if inputs is _errors:
        for i in (0, 1):
            np.testing.assert_array_equal(rt.data[i].weight, rj.data[i].weight)
            assert not np.all(rt.data[i].weight == rt.data[i].weight[0, 0])
    if inputs is _z_up:
        np.testing.assert_array_equal(rt.models[0].grid.Z1, rj.models[0].grid.Z1)
        assert rt.models[0].grid.Z1.min() == 0.0 and rt.data[1].Z.max() < 0.0  # flipped into depth space
    if inputs is _models_from_files:
        # The second prior model's folder: every file there too, and the
        # costs of its solve.
        assert os.path.exists(f"{tout}_2/costs.txt") and os.path.exists(f"{jout}_2/costs.txt")
        assert sorted(os.listdir(f"{tout}_2")) == sorted(os.listdir(f"{jout}_2"))
        _same_checkpoint(f"{jout}_2/checkpoint.npz", f"{tout}_2/checkpoint.npz")
        for a, b in zip(_costs(f"{jout}_2/costs.txt"), _costs(f"{tout}_2/costs.txt")):
            np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-300)
        for sub in ("data/grav_prior.txt", "data/mag_starting.txt", "model/mag_final_model_full.txt"):
            a, b = (np.loadtxt(os.path.join(d, sub), skiprows=1) for d in (f"{jout}_2", f"{tout}_2"))
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-8 * np.abs(a).max())
    assert KINDS["joint"][1] == (0, 1)
