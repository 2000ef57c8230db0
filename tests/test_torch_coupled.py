"""The coupled joint inversion as a whole: the joint grav+mag problem of
tests/test_torch_joint.py with the cross-gradient, the damping gradient and
the clustering constraint (each alone and all three at once) through
solve_problem_joint_gravmag of both packages on the CPU in float64, the port
solving from the cache that the JAX run wrote, in every stored-kernel format
and over an 8-slot mesh; the variants of each constraint (forward
differences, a vector field, a model kept constant, a damping-gradient
weights file, the plain clustering objective with cell weights);
sensit.readFromFiles = 2; checkpoint and resume, within the port and across
the packages; and the command line's --resume, --profile and --debug-nans.

The weights follow one row-scale rule: each constraint's largest
coefficient lies near a hundredth of the largest column norm of the
weighted data block (1.3e-4 for both problems here), so that its cost
column is well above rounding and the data costs still fall. The damping
gradient's coefficient is problem weight x beta x column weight / cell size
(gravity: cw up to 1.8e4, cell 50 m, pw 1 -> beta 1e-9; magnetics: cw up to
12, pw 1e-8 -> beta 1e2); the cross-gradient's is weight x column weight x
the other model's gradient (1e-5); the clustering's is weight x column
weight x the mixture's derivative (1e-9 and 1e-10)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tomofastx_tpu.config.parfile import parse_parfile_lines as jparse
from tomofastx_tpu.inversion.workflow import solve_problem_joint_gravmag as jsolve

from tomofastx_tpu_torch import cli
from tomofastx_tpu_torch.config.parfile import parse_parfile_lines as tparse
from tomofastx_tpu_torch.inversion import workflow as twf
from tomofastx_tpu_torch.parallel import mesh as tmesh

from test_torch_joint import N, ND, NITER, _compare, _costs, _lines, _same_checkpoint, _tree, _write_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

XGRAD = ["inversion.crossGradient.weight = 1.e-5", "inversion.crossGradient.derivativeType = 2"]
DGRAD = ["inversion.dampingGradient.grav.weight = 1.e-9", "inversion.dampingGradient.magn.weight = 1.e2"]
CLUSTER = ["inversion.clustering.grav.weight = 1.e-9", "inversion.clustering.magn.weight = 1.e-10",
           "inversion.clustering.nClusters = 2", "inversion.clustering.mixtureFile = {tmp}/mixture.txt",
           "inversion.clustering.constraintsType = 1"]

# name: (Parfile lines, costs.txt columns (1-based) that must be > 0 after the first major)
COUPLINGS = {
    "cross-gradient": (XGRAD, (16, 17, 18)),
    "damping-gradient": (DGRAD, (10, 11, 12, 13, 14, 15)),
    "clustering": (CLUSTER, (19, 20)),
    "all-three": (XGRAD + DGRAD + CLUSTER, tuple(range(10, 21))),
}
# Each variant in one format.
VARIANTS = {
    "cross-gradient-forward": (XGRAD[:1] + ["inversion.crossGradient.derivativeType = 1"], (16, 17, 18)),
    "cross-gradient-vector-field": (XGRAD + ["inversion.crossGradient.vectorFieldType = 2",
                                             "inversion.crossGradient.vectorFieldFile = {tmp}/vector_field.txt"],
                                    (16, 17, 18)),
    "cross-gradient-grav-kept-constant": (XGRAD + ["inversion.crossGradient.grav.keepModelConstant = 1"],
                                          (16, 17, 18)),
    "damping-gradient-weights-file": (DGRAD + ["inversion.dampingGradient.weightType = 2",
                                               "inversion.dampingGradient.grav.weightsFile = {tmp}/dgw_grav.txt",
                                               "inversion.dampingGradient.magn.weightsFile = {tmp}/dgw_magn.txt"],
                                      (10, 11, 12, 13, 14, 15)),
    "clustering-normal-cell-weights": (CLUSTER[:-1] + ["inversion.clustering.constraintsType = 2",
                                                       "inversion.clustering.optimizationType = 1",
                                                       "inversion.clustering.cellWeightsFile = {tmp}/cell_weights.txt"],
                                       (19, 20)),
    "all-three-uncompressed": (XGRAD + DGRAD + CLUSTER + ["forward.matrixCompression.type = 0"],
                               tuple(range(10, 21))),
}
ALL = {**COUPLINGS, **VARIANTS}


def write_coupling_inputs(tmp):
    """The joint problem's inputs, and the files of the constraints: a
    2-cluster mixture (background and the blocks' density and
    susceptibility), per-cell cluster weights, a vector field, and
    per-direction damping-gradient weights, from a seed."""
    _write_inputs(tmp)
    rng = np.random.default_rng(21)
    with open(f"{tmp}/mixture.txt", "w") as f:
        f.write("2\n1.0 0.0 50.0 0.0 0.01 0.1\n1.0 250.0 50.0 0.05 0.01 0.1\n")
    cw = rng.uniform(0.2, 1.0, (N, 2))
    with open(f"{tmp}/cell_weights.txt", "w") as f:
        f.write(f"{N} 2\n")
        np.savetxt(f, cw / cw.sum(1, keepdims=True), fmt="%.12E")
    # The vector field stands for the magnetic model's gradient (SI per m;
    # the blocks' sharpest is 1e-3), so it takes that gradient's scale.
    for name, table in (("vector_field", 1e-4 * rng.normal(size=(N, 3))),
                        ("dgw_grav", rng.uniform(0.5, 1.5, (N, 3))),
                        ("dgw_magn", rng.uniform(0.5, 1.5, (N, 3)))):
        with open(f"{tmp}/{name}.txt", "w") as f:
            f.write(f"{N}\n")
            np.savetxt(f, table, fmt="%.12E")


def coupled_lines(tmp, name, out, fmt="tiled", majors=3):
    extra = [ln.format(tmp=tmp) for ln in ALL[name][0]]
    lines = _lines(tmp, "joint", out, fmt=fmt) + extra
    return [f"inversion.nMajorIterations = {majors}" if ln.startswith("inversion.nMajorIterations") else ln
            for ln in lines]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """One JAX run of each coupling (dense format, writing its cache), made
    the first time a test asks for it."""
    tmp = str(tmp_path_factory.mktemp("coupled"))
    write_coupling_inputs(tmp)
    runs = {}

    def get(name):
        if name not in runs:
            out = f"{tmp}/jax_{name}"
            res = jsolve(jparse(coupled_lines(tmp, name, out, fmt="dense")), solve_dtype=jnp.float64,
                         compute_dtype=jnp.float64, verbose=False)
            runs[name] = (res, out)
        return tmp, runs[name]

    return get


def _port(tmp, name, jout, out, fmt, mesh=None, majors=3, **kw):
    lines = coupled_lines(tmp, name, out, fmt=fmt, majors=majors) + [
        "sensit.readFromFiles = 1", f"sensit.folderPath = {jout}/SENSIT/"]
    return twf.solve_problem_joint_gravmag(tparse(lines), solve_dtype=torch.float64, verbose=False, device="cpu",
                                           mesh=mesh, **kw)


def _compare_coupled(name, rj, jout, rt, tout):
    """The comparisons of tests/test_torch_joint.py (costs.txt rtol 1e-8,
    models 1e-8 of their range, the same files, the checkpoints), then: the
    constraint's cost columns > 0 in every major (the others 0), and the
    coupling fields written as VTK where the coupling is on."""
    _compare("joint", rj, jout, rt, tout)
    rows = _costs(os.path.join(tout, "costs.txt"))[1:-1]
    for col in ALL[name][1]:
        assert all(row[col - 1] > 0.0 for row in rows), (col, [row[col - 1] for row in rows])
    for col in set(range(10, 21)) - set(ALL[name][1]):
        assert all(row[col - 1] == 0.0 for row in rows), col
    for field, cols in (("cross_grad", (16, 17, 18)), ("clustering", (19, 20))):
        written = os.path.exists(os.path.join(tout, "Paraview", f"{field}_final_model3D_full.vtk"))
        assert written == (cols[0] in ALL[name][1]), field


FORMATS = pytest.mark.parametrize("fmt", ["tiled", "dense", "packed", "auto"])


@FORMATS
@pytest.mark.parametrize("name", list(COUPLINGS))
def test_coupling_matches_jax(jax_runs, tmp_path, name, fmt):
    """Each coupling in each stored-kernel format, both packages from one
    cache."""
    tmp, (rj, jout) = jax_runs(name)
    rt = _port(tmp, name, jout, str(tmp_path / "out"), fmt)
    _compare_coupled(name, rj, jout, rt, str(tmp_path / "out"))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_matches_jax(jax_runs, tmp_path, name):
    tmp, (rj, jout) = jax_runs(name)
    rt = _port(tmp, name, jout, str(tmp_path / "out"), "dense")
    _compare_coupled(name, rj, jout, rt, str(tmp_path / "out"))


@pytest.mark.parametrize("fmt,operator", [("tiled", "ShardedTileKernel"), ("dense", "ShardedDenseKernel"),
                                          ("packed", "ShardedPackedKernel")])
def test_all_three_on_an_8_slot_mesh_matches_jax(jax_runs, tmp_path, monkeypatch, fmt, operator):
    """All three constraints over 8 CPU slots: only the operators are
    sharded (once each), every other tensor of the solve, the
    damping-gradient weights, the vector field and the mixture included,
    stays on the home device; the result held to the unmeshed JAX run."""
    made = []
    orig = twf.shard_kernel
    monkeypatch.setattr(twf, "shard_kernel", lambda k, m: made.append(orig(k, m)) or made[-1])
    tmp, (rj, jout) = jax_runs("all-three")
    rt = _port(tmp, "all-three", jout, str(tmp_path / "out"), fmt, mesh=tmesh.make_mesh(8, device="cpu"))
    assert [type(k).__name__ for k in made] == [operator] * 2
    _compare_coupled("all-three", rj, jout, rt, str(tmp_path / "out"))


def test_all_three_from_scratch_matches_jax(jax_runs, tmp_path):
    """The port builds its own kernels (tiled): two float64 builds differ in
    their last bits, so costs rtol 1e-6 (data costs 1e-8 absolute) and the
    models to 1e-6 of their range, as in tests/test_torch_joint.py."""
    tmp, (rj, jout) = jax_runs("all-three")
    tout = str(tmp_path / "out")
    rt = twf.solve_problem_joint_gravmag(tparse(coupled_lines(tmp, "all-three", tout)), solve_dtype=torch.float64,
                                         verbose=False, device="cpu")
    assert rt.timings["build_s"] > 0.0
    for a, b in zip(_costs(os.path.join(jout, "costs.txt")), _costs(os.path.join(tout, "costs.txt"))):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-8)
    for i in (0, 1):
        mj, mt = rj.models[i].val, rt.models[i].val
        np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-6 * (mj.max() - mj.min()))


def test_all_three_through_the_command_line_on_a_mesh(jax_runs, tmp_path, monkeypatch):
    """cli.main(["-p", Parfile, "--device", "cpu", "--mesh", "4"]) of the
    coupled problem from the JAX run's cache: exit code 0, costs.txt rtol
    1e-8 (as printed), the same output files."""
    tmp, (rj, jout) = jax_runs("all-three")
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "out")
    par = _parfile(tmp_path, tmp, jout, out, 3)
    assert cli.main(["-p", par, "--device", "cpu", "--mesh", "4", "-q"]) == 0
    for a, b in zip(_costs(os.path.join(jout, "costs.txt")), _costs(os.path.join(out, "costs.txt"))):
        np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-300)
    assert [f for f in _tree(out) if f != "Parfile_run.txt"] == _tree(jout)


def test_shard_system_arrays_keeps_the_constraint_tensors_home():
    """parallel.mesh.shard_system_arrays on the coupled system's tensors:
    the operators sharded, every constraint tensor (per problem or not) the
    very tensor it was, on the home device; a problem whose block is off
    (None) stays None."""
    from tomofastx_tpu_torch.ops.sparse_kernel import DenseKernel

    m = tmesh.make_mesh(4, device="cpu")
    S = torch.randn(ND, N, dtype=torch.float64)
    w = torch.ones(3, N, dtype=torch.float64)
    arrays = {"S": (DenseKernel(S),), "damping_grad_weight": (w, None), "vec_field": torch.zeros(N, 3),
              "mixture_mu": torch.zeros(2, 2), "cell_weight": torch.ones(N, 2), "mixture_max": torch.ones(N),
              "dX": torch.ones(8)}
    out = tmesh.shard_system_arrays(arrays, m)
    assert type(out["S"][0]).__name__ == "ShardedDenseKernel"
    assert out["damping_grad_weight"][1] is None
    for k in arrays:
        if k != "S":
            got, want = (out[k][0], arrays[k][0]) if isinstance(arrays[k], tuple) else (out[k], arrays[k])
            assert got is want and got.device == m.home, k


def test_read_from_files_2_matches_jax(jax_runs, tmp_path):
    """sensit.readFromFiles = 2 on the coupled problem: the depth weights
    from the JAX run's cache, the kernels built again by each package (so
    costs rtol 1e-6, data costs 1e-8 absolute, models 1e-6 of their range:
    two float64 builds); each package writes the cache weight unchanged."""
    tmp, (_, jout) = jax_runs("all-three")
    res = {}
    for pkg in ("jax", "torch"):
        out = str(tmp_path / pkg)
        lines = coupled_lines(tmp, "all-three", out, fmt="tiled") + [
            "sensit.readFromFiles = 2", f"sensit.folderPath = {jout}/SENSIT/"]
        if pkg == "jax":
            res[pkg] = jsolve(jparse(lines), solve_dtype=jnp.float64, compute_dtype=jnp.float64, verbose=False)
        else:
            res[pkg] = twf.solve_problem_joint_gravmag(tparse(lines), solve_dtype=torch.float64, verbose=False,
                                                       device="cpu")
    assert res["torch"].timings["build_s"] > 0.0
    for a, b in zip(_costs(str(tmp_path / "jax/costs.txt")), _costs(str(tmp_path / "torch/costs.txt"))):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-8)
    for i, sfx in ((0, "grav"), (1, "magn")):
        mj, mt = res["jax"].models[i].val, res["torch"].models[i].val
        np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-6 * (mj.max() - mj.min()))
        for out in ("jax", "torch"):
            with open(f"{jout}/SENSIT/sensit_{sfx}_weight", "rb") as f, \
                    open(str(tmp_path / out / "SENSIT" / f"sensit_{sfx}_weight"), "rb") as g:
                assert f.read() == g.read()


@pytest.mark.parametrize("name", ["cross-gradient", "clustering"])
def test_coupling_needs_both_problems(tmp_path, name):
    """The magnetic problem alone with a coupling constraint: ValueError in
    both packages, before any solve."""
    tmp = str(tmp_path)
    write_coupling_inputs(tmp)
    lines = coupled_lines(tmp, name, f"{tmp}/out") + ["inversion.joint.grav.problemWeight = 0"]
    for solve, parse, kw in ((jsolve, jparse, {}), (twf.solve_problem_joint_gravmag, tparse, {"device": "cpu"})):
        with pytest.raises(ValueError, match="BOTH problems"):
            solve(parse(lines), verbose=False, **kw)
    assert not os.path.exists(f"{tmp}/out/costs.txt")


# ------------------------------------------------------------ checkpoints


def test_resume_matches_uninterrupted(jax_runs, tmp_path):
    """The port run to 4 majors, checkpointed every 2; the same run stopped
    after 2 and resumed to 4: the final models equal rtol 1e-8 (the JAX
    test tests/test_e2e_synthetic.py::test_checkpoint_resume_matches_
    uninterrupted, here on the coupled problem), and costs.txt holds the
    same rows."""
    tmp, (_, jout) = jax_runs("all-three")
    full = _port(tmp, "all-three", jout, str(tmp_path / "full"), "tiled", majors=4)
    first = _port(tmp, "all-three", jout, str(tmp_path / "res"), "tiled", majors=2)
    with np.load(str(tmp_path / "res/checkpoint.npz")) as z:
        assert int(z["it"]) == 2 and int(z["m"]) == 1
    resumed = _port(tmp, "all-three", jout, str(tmp_path / "res"), "tiled", majors=4, resume=True)
    assert resumed.timings["lsqr_iters"] == [NITER] * 2 and first.timings["lsqr_iters"] == [NITER] * 2
    assert [h["iteration"] for h in resumed.costs_history] == [3, 4]
    for i in (0, 1):
        np.testing.assert_allclose(resumed.models[i].val, full.models[i].val, rtol=1e-8, atol=1e-300)
    # costs.txt: the stopped run's rows up to its last major, then the
    # resumed run's.
    cf, cr = _costs(str(tmp_path / "full/costs.txt")), _costs(str(tmp_path / "res/costs.txt"))
    assert [r[0] for r in cr] == [0, 1, 2, 2, 3, 4]
    np.testing.assert_allclose(cr[2], cf[2][:5], rtol=1e-8, atol=1e-300)
    for a, b in zip(cf, cr[:2] + cr[3:]):
        np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-300)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_resumes_in_the_other_package(jax_runs, tmp_path, writer):
    """A checkpoint written after 2 majors by one package, resumed to 4 by
    the other: the final models and the checkpoint after major 4 equal an
    uninterrupted 4-major JAX run at rtol 1e-8 (models 1e-8 of their
    range)."""
    tmp, (_, jout) = jax_runs("all-three")
    cache = ["sensit.readFromFiles = 1", f"sensit.folderPath = {jout}/SENSIT/"]

    def run(pkg, out, majors, resume=False):
        lines = coupled_lines(tmp, "all-three", out, fmt="dense", majors=majors) + cache
        if pkg == "jax":
            return jsolve(jparse(lines), solve_dtype=jnp.float64, compute_dtype=jnp.float64, verbose=False,
                          resume=resume)
        return twf.solve_problem_joint_gravmag(tparse(lines), solve_dtype=torch.float64, verbose=False,
                                               device="cpu", resume=resume)

    full = run("jax", str(tmp_path / "full"), 4)
    reader = "torch" if writer == "jax" else "jax"
    run(writer, str(tmp_path / "res"), 2)
    resumed = run(reader, str(tmp_path / "res"), 4, resume=True)
    for i in (0, 1):
        m = full.models[i].val
        np.testing.assert_allclose(resumed.models[i].val, m, rtol=0, atol=1e-8 * (m.max() - m.min()))
    _same_checkpoint(str(tmp_path / "full/checkpoint.npz"), str(tmp_path / "res/checkpoint.npz"))


# ------------------------------------------------------------ the command line


def _parfile(tmp_path, tmp, jout, out, majors, extra=()):
    par = tmp_path / f"Parfile_{os.path.basename(out)}_{majors}.txt"
    par.write_text("\n".join(coupled_lines(tmp, "all-three", out, majors=majors) + [
        "sensit.readFromFiles = 1", f"sensit.folderPath = {jout}/SENSIT/"] + list(extra)))
    return str(par)


def test_cli_resume_matches_uninterrupted(jax_runs, tmp_path, monkeypatch):
    """cli.main with --resume reaches the workflow: a run stopped at the
    checkpoint of major 2 and resumed to 4 equals the uninterrupted run
    (final models rtol 1e-8), and the checkpoint then says major 4."""
    tmp, (_, jout) = jax_runs("all-three")
    monkeypatch.chdir(tmp_path)
    full, res = str(tmp_path / "full"), str(tmp_path / "res")
    assert cli.main(["-p", _parfile(tmp_path, tmp, jout, full, 4), "--device", "cpu", "-q"]) == 0
    assert cli.main(["-p", _parfile(tmp_path, tmp, jout, res, 2), "--device", "cpu", "-q"]) == 0
    assert cli.main(["-p", _parfile(tmp_path, tmp, jout, res, 4), "--device", "cpu", "-q", "--resume"]) == 0
    with np.load(f"{res}/checkpoint.npz") as z:
        assert int(z["it"]) == 4, "the resume flag never reached the workflow"
    for p in ("grav", "mag"):
        a, b = (np.loadtxt(f"{d}/model/{p}_final_model_full.txt", skiprows=1) for d in (full, res))
        np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-300)


def test_cli_profile_writes_a_trace(jax_runs, tmp_path, monkeypatch):
    """--profile DIR: a Chrome trace of the run in DIR/trace.json, whose CPU
    events include the shifts of the cross-gradient's products."""
    tmp, (_, jout) = jax_runs("all-three")
    monkeypatch.chdir(tmp_path)
    trace_dir = tmp_path / "trace"
    rc = cli.main(["-p", _parfile(tmp_path, tmp, jout, str(tmp_path / "out"), 1), "--device", "cpu", "-q",
                   "--profile", str(trace_dir)])
    assert rc == 0
    with open(trace_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert "aten::roll" in names and len(events) > 1000, (len(events), sorted(names)[:50])


def test_debug_nans_stops_at_a_nan_datum(tmp_path):
    """A data file that holds a NaN (observed values read from the file):
    with --debug-nans the command exits with code 1 and a FloatingPointError
    traceback naming what was not finite (a subprocess, as a user runs it);
    in process, cli.main raises FloatingPointError."""
    tmp = str(tmp_path)
    write_coupling_inputs(tmp)
    with open(f"{tmp}/data1.txt") as f:
        rows = f.read().splitlines()
    t = rows[3].split()
    rows[3] = " ".join(t[:3] + ["nan"])
    with open(f"{tmp}/data_nan.txt", "w") as f:
        f.write("\n".join(rows) + "\n")
    lines = [ln.replace(f"{tmp}/data1.txt", f"{tmp}/data_nan.txt").replace(
        "forward.data.grav.useSyntheticModelForDataValues = 1", "forward.data.grav.useSyntheticModelForDataValues = 0")
        for ln in coupled_lines(tmp, "all-three", f"{tmp}/out", fmt="tiled")]
    par = tmp_path / "Parfile.txt"
    par.write_text("\n".join(lines))
    p = subprocess.run([sys.executable, "-m", "tomofastx_tpu_torch", "-p", str(par), "--device", "cpu",
                        "--debug-nans", "-q"], cwd=tmp, env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 1, p.stdout[-2000:] + p.stderr[-2000:]
    assert "Traceback" in p.stderr and "FloatingPointError: non-finite values in the" in p.stderr, p.stderr[-2000:]
    with pytest.raises(FloatingPointError, match="major iteration 1"):
        cli.main(["-p", str(par), "--device", "cpu", "-q", "--debug-nans"])
    # Without the flag the run is not stopped by the check.
    assert cli.main(["-p", str(par), "--device", "cpu", "-q"]) == 0
