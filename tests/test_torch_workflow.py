"""The ported slices as a whole: one synthetic gravity Parfile (lattice grid,
damping, 3-lithology ADMM, 3 majors) with each stored-kernel format (tiled,
dense, packed, auto; wavelet-compressed and not) through
solve_problem_joint_gravmag of both packages on the CPU in float64; the
port's CLI in a subprocess; and the port's import hygiene."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from tomofastx_tpu.config.parfile import parse_parfile_lines as jparse
from tomofastx_tpu.inversion.workflow import solve_problem_joint_gravmag as jsolve

from test_torch_joint import _same_checkpoint
from util_fixtures import surface_data_points, write_data_grid_file, write_grid_file, write_values_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_problem(tmp, nx, ny, nz, ndata, wtype=1, rate=0.15, depth_type=2, rho_mult=1.0, niter=20,
                   fmt="tiled"):
    """Grid, data positions and a synthetic block model under tmp; returns a
    function giving the Parfile lines for an output folder. fmt = None
    leaves the tpu.kernelFormat line out (the default format, dense)."""
    grid_path, data_path, synth_path = (os.path.join(tmp, f) for f in ("grid.txt", "data.txt", "synth.txt"))
    # Cells longer in x than in y: on square cells an observation above the
    # grid's diagonal sees equal coefficients in mirrored pairs, and which of
    # a pair survives the threshold would hang on the last bit.
    write_grid_file(grid_path, nx, ny, nz, h=(100.0, 80.0, 50.0))
    X, Y, Z = surface_data_points(nx, ny, h=(100.0, 80.0))
    idx = np.linspace(0, len(X) - 1, ndata).astype(int)
    write_data_grid_file(data_path, X[idx], Y[idx], Z[idx])
    rng = np.random.default_rng(5)
    m = np.zeros((nz, ny, nx))
    m[nz // 4 : nz // 2 + 1, ny // 3 : 2 * ny // 3, nx // 3 : 2 * nx // 3] = 250.0
    m += rng.normal(size=m.shape)  # seeded roughness, so no symmetry ties
    write_values_file(synth_path, m.reshape(-1)[:, None])

    def lines(out):
        return f"""
global.outputFolderPath = {out}/
modelGrid.size = {nx} {ny} {nz}
modelGrid.grav.file = {grid_path}
forward.data.grav.nData = {ndata}
forward.data.grav.dataGridFile = {data_path}
forward.data.grav.useSyntheticModelForDataValues = 1
forward.data.grav.syntheticModelFile = {synth_path}
forward.depthWeighting.type = {depth_type}
forward.matrixCompression.type = {wtype}
forward.matrixCompression.rate = {rate}
inversion.nMajorIterations = 3
inversion.nMinorIterations = {niter}
inversion.writeModelEveryNiter = 2
inversion.modelDamping.grav.weight = 1.e-9
inversion.admm.enableADMM = 1
inversion.admm.nLithologies = 3
inversion.admm.grav.bounds = -10 10 90 110 240 260
inversion.admm.grav.weight = 1.e-6
inversion.admm.weightMultiplier = {rho_mult}
inversion.admm.dataCostThreshold = 1.0
""".splitlines() + ([f"tpu.kernelFormat = {fmt}"] if fmt else [])

    return lines


def _tree(root):
    """Relative paths of all files under root."""
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, files in os.walk(root) for f in files)


def _costs(path):
    with open(path) as f:
        rows = [ln.split() for ln in f if not ln.startswith("#")]
    return [np.array(r, float) for r in rows]


# The minor iterations stay well below the number of data rows: past that LSQR
# has spent its Krylov space and only amplifies rounding, in both packages
# alike but not to the same digits.
CASES = pytest.mark.parametrize(
    "dims,ndata,wtype,depth_type,rho_mult,niter",
    [((16, 16, 8), 64, 1, 2, 1.0, 10), ((8, 8, 4), 16, 1, 1, 2.0, 6), ((12, 8, 4), 24, 2, 3, 1.0, 8)],
    ids=["haar-16x16x8", "haar-8x8x4-dynamic-rho", "d4-12x8x4"],
)


def _run_both(tmp_path, dims, ndata, wtype, depth_type, rho_mult, niter, share_cache, fmt="tiled"):
    import torch

    from tomofastx_tpu_torch.config.parfile import parse_parfile_lines as tparse
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag as tsolve

    lines = _write_problem(
        str(tmp_path), *dims, ndata, wtype=wtype, depth_type=depth_type, rho_mult=rho_mult, niter=niter, fmt=fmt
    )
    jout, tout = str(tmp_path / "jax_out"), str(tmp_path / "torch_out")
    rj = jsolve(jparse(lines(jout)), solve_dtype=jnp.float64, compute_dtype=jnp.float64, verbose=False)
    tlines = lines(tout)
    if share_cache:
        tlines += ["sensit.readFromFiles = 1", f"sensit.folderPath = {jout}/SENSIT/"]
    rt = tsolve(tparse(tlines), solve_dtype=torch.float64, verbose=False, device="cpu")
    return rj, rt, jout, tout


def _compare(rj, rt, jout, tout, rho_mult, niter, cost_tol, model_tol):
    assert rt.timings["lsqr_iters"] == [niter] * 3
    cj, ct = _costs(os.path.join(jout, "costs.txt")), _costs(os.path.join(tout, "costs.txt"))
    assert len(cj) == len(ct) == 4
    for a, b in zip(cj, ct):
        np.testing.assert_allclose(b, a, **cost_tol)
    assert ct[1][1] < ct[0][1]  # the data cost fell
    if rho_mult != 1.0:
        assert ct[2][7] == 2.0 * ct[1][7]  # the dynamic ADMM weight was raised
    mj, mt = rj.models[0].val, rt.models[0].val
    np.testing.assert_allclose(mt, mj, rtol=0, atol=model_tol * (mj.max() - mj.min()))
    np.testing.assert_allclose(rt.cost_data, rj.cost_data, **cost_tol)
    np.testing.assert_allclose(rt.cost_model, rj.cost_model, **cost_tol)
    assert [h["iteration"] for h in rt.costs_history] == [1, 2, 3]
    # writeModelEveryNiter = 2: both packages checkpoint after major 2.
    _same_checkpoint(os.path.join(jout, "checkpoint.npz"), os.path.join(tout, "checkpoint.npz"), model_tol)


@CASES
def test_slice_matches_jax(tmp_path, dims, ndata, wtype, depth_type, rho_mult, niter):
    """Both packages solve from the same stored kernel (the port packs the
    cache that the JAX run wrote, sensit.readFromFiles = 1): every costs.txt
    column rtol 1e-8, final model to 1e-8 of its range, final data rtol 1e-8,
    LSQR iterations equal, same set of output files."""
    rj, rt, jout, tout = _run_both(tmp_path, dims, ndata, wtype, depth_type, rho_mult, niter, share_cache=True)
    _compare(rj, rt, jout, tout, rho_mult, niter, dict(rtol=1e-8, atol=1e-300), 1e-8)
    np.testing.assert_allclose(rt.data[0].val_calc, rj.data[0].val_calc, rtol=1e-8)
    assert _tree(tout) == [f for f in _tree(jout) if not f.startswith("SENSIT")]
    with open(os.path.join(jout, "data/grav_observed.txt"), "rb") as a, \
            open(os.path.join(tout, "data/grav_observed.txt"), "rb") as b:
        assert a.read() == b.read()


@CASES
def test_slice_from_scratch_matches_jax(tmp_path, dims, ndata, wtype, depth_type, rho_mult, niter):
    """Each package builds its own kernel. The float64 corner sums of the two
    differ in their last bits and cancel, so some thousandths of the entries
    round to the neighbouring float32 when stored. The data cost is a
    relative residual whose scale is 1, so its columns are held to 1e-8
    absolute and the others to rtol 1e-6; the model to 1e-6 of its range.
    Same set of output files, SENSIT included; the nnz histogram byte-equal."""
    rj, rt, jout, tout = _run_both(tmp_path, dims, ndata, wtype, depth_type, rho_mult, niter, share_cache=False)
    _compare(rj, rt, jout, tout, rho_mult, niter, dict(rtol=1e-6, atol=1e-8), 1e-6)
    assert _tree(tout) == _tree(jout)
    with open(os.path.join(jout, "SENSIT/sensit_grav_nnz"), "rb") as a, \
            open(os.path.join(tout, "SENSIT/sensit_grav_nnz"), "rb") as b:
        assert a.read() == b.read()


# What each Parfile asks for and the operator the port has to end up with.
FORMATS = pytest.mark.parametrize(
    "fmt,wtype,operator",
    [
        ("dense", 1, "DenseKernel"), (None, 1, "DenseKernel"), ("dense", 0, "DenseKernel"),
        ("packed", 1, "PackedKernel"), ("auto", 1, "PackedKernel"), ("auto", 0, "DenseKernel"),
        ("packed", 0, "DenseKernel"), ("tiled", 0, "DenseKernel"), ("dense", 2, "DenseKernel"),
    ],
    ids=["dense-haar", "default-haar", "dense-uncompressed", "packed-haar", "auto-compressed", "auto-uncompressed",
         "packed-uncompressed-is-dense", "tiled-uncompressed-is-dense", "dense-d4"],
)


@FORMATS
def test_format_matches_jax(tmp_path, monkeypatch, fmt, wtype, operator):
    """Every stored-kernel format, compressed and not: both packages solve
    from the cache the JAX run wrote (sensit.readFromFiles = 1 in the port).
    Every costs.txt column rtol 1e-8, final model to 1e-8 of its range, final
    data rtol 1e-8, LSQR iterations equal, same output files."""
    from tomofastx_tpu_torch.inversion import workflow as twf

    made, orig = [], twf._kernel_operator
    monkeypatch.setattr(twf, "_kernel_operator", lambda ctx, device: made.append(orig(ctx, device)) or made[-1])
    rj, rt, jout, tout = _run_both(tmp_path, (12, 8, 4), 24, wtype, 2, 1.0, 8, share_cache=True, fmt=fmt)
    assert type(made[-1]).__name__ == operator
    _compare(rj, rt, jout, tout, 1.0, 8, dict(rtol=1e-8, atol=1e-300), 1e-8)
    np.testing.assert_allclose(rt.data[0].val_calc, rj.data[0].val_calc, rtol=1e-8)
    assert _tree(tout) == [f for f in _tree(jout) if not f.startswith("SENSIT")]


@pytest.mark.parametrize("wtype", [1, 0], ids=["haar", "uncompressed"])
def test_dense_from_scratch_matches_jax(tmp_path, wtype):
    """Each package builds its own dense kernel and writes its own cache
    (tolerances as in test_slice_from_scratch_matches_jax); same output
    files, SENSIT included, the nnz histogram byte-equal."""
    rj, rt, jout, tout = _run_both(tmp_path, (12, 8, 4), 24, wtype, 2, 1.0, 8, share_cache=False, fmt=None)
    _compare(rj, rt, jout, tout, 1.0, 8, dict(rtol=1e-6, atol=1e-8), 1e-6)
    assert _tree(tout) == _tree(jout)
    with open(os.path.join(jout, "SENSIT/sensit_grav_nnz"), "rb") as a, \
            open(os.path.join(tout, "SENSIT/sensit_grav_nnz"), "rb") as b:
        assert a.read() == b.read()


def test_formats_agree_inside_the_port(tmp_path):
    """tiled, dense and packed from scratch hold the same matrix: the dense
    run's cache files (written from the finished kernel) are byte-equal to
    the streamed ones, costs agree to rtol 1e-9 and models to 1e-9 of the
    range (float64 sums in three different orders)."""
    import torch

    from tomofastx_tpu_torch.config.parfile import parse_parfile_lines as tparse
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag as tsolve

    res = {}
    for fmt in ("tiled", "dense", "packed"):
        lines = _write_problem(str(tmp_path), 12, 8, 4, 24, niter=8, fmt=fmt)
        res[fmt] = tsolve(tparse(lines(str(tmp_path / fmt))), solve_dtype=torch.float64, verbose=False, device="cpu")
    ref = res["tiled"].models[0].val
    for fmt in ("dense", "packed"):
        np.testing.assert_allclose(res[fmt].cost_data, res["tiled"].cost_data, rtol=1e-9)
        np.testing.assert_allclose(res[fmt].models[0].val, ref, rtol=0, atol=1e-9 * (ref.max() - ref.min()))
        for f in ("sensit_grav_1_0", "sensit_grav_meta.txt", "sensit_grav_nnz", "sensit_grav_weight"):
            with open(tmp_path / "tiled" / "SENSIT" / f, "rb") as a, open(tmp_path / fmt / "SENSIT" / f, "rb") as b:
                assert a.read() == b.read(), (fmt, f)


def test_dense_run_without_cache_write(tmp_path):
    """tpu.sensitWriteCache = 0 keeps the dense kernel off the disk."""
    from tomofastx_tpu_torch.config.parfile import parse_parfile_lines as tparse
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag as tsolve

    lines = _write_problem(str(tmp_path), 8, 8, 4, 16, niter=6, fmt="dense")
    r = tsolve(tparse(lines(str(tmp_path / "a")) + ["tpu.sensitWriteCache = 0"]), verbose=False, device="cpu")
    assert not (tmp_path / "a" / "SENSIT").exists()
    assert "cache_write_s" not in r.timings and r.costs_history[-1]["cost_data"][0] < 1.0


def test_auto_refuses_an_uncompressed_kernel_too_large_for_the_device(tmp_path, monkeypatch, capsys):
    """Uncompressed auto: a dense kernel above 55 % of the device's memory
    is refused a stored kernel and goes matrix-free, as in the JAX package
    (the operators against JAX: tests/test_torch_matrixfree.py); below it
    the kernel is dense and cached."""
    from tomofastx_tpu_torch.config.parfile import parse_parfile_lines as tparse
    from tomofastx_tpu_torch.inversion import workflow as twf

    lines = _write_problem(str(tmp_path), 8, 8, 4, 16, wtype=0, fmt="auto")
    dense_bytes = 16 * 256 * 4
    assert twf._device_memory_bytes(__import__("torch").device("cpu")) > dense_bytes
    monkeypatch.setattr(twf, "_device_memory_bytes", lambda device: int(dense_bytes / 0.56))
    twf.solve_problem_joint_gravmag(tparse(lines(str(tmp_path / "a"))), device="cpu")
    said = capsys.readouterr().out
    assert "-> matrix-free" in said and "grav kernel: matrix-free (LatticeMatrixFreeKernel" in said
    assert not (tmp_path / "a" / "SENSIT").exists()
    monkeypatch.setattr(twf, "_device_memory_bytes", lambda device: int(dense_bytes / 0.54))
    twf.solve_problem_joint_gravmag(tparse(lines(str(tmp_path / "b"))), verbose=False, device="cpu")
    assert (tmp_path / "b" / "SENSIT").exists()


def test_float32_solve_on_cpu_close_to_float64(tmp_path):
    """The solve dtype the card uses, on the CPU: data cost within 1% of the
    float64 run's (float32 LSQR over 60 iterations in all)."""
    import torch

    from tomofastx_tpu_torch.config.parfile import parse_parfile_lines as tparse
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag as tsolve

    lines = _write_problem(str(tmp_path), 8, 8, 4, 16)
    r64 = tsolve(tparse(lines(str(tmp_path / "a"))), solve_dtype=torch.float64, verbose=False, device="cpu")
    r32 = tsolve(tparse(lines(str(tmp_path / "b"))), solve_dtype=torch.float32, verbose=False, device="cpu")
    np.testing.assert_allclose(r32.cost_data[0], r64.cost_data[0], rtol=1e-2)
    assert r32.models[0].val.dtype == np.float64


@pytest.mark.parametrize("fmt", ["tiled", "dense", "packed", "auto"])
def test_sensit_cache_reread(tmp_path, fmt):
    """sensit.readFromFiles = 1 takes the cache a first run wrote, in every
    format: same result."""
    import torch

    from tomofastx_tpu_torch.config.parfile import parse_parfile_lines as tparse
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag as tsolve

    lines = _write_problem(str(tmp_path), 8, 8, 4, 16, fmt=fmt)
    first = tsolve(tparse(lines(str(tmp_path / "a"))), verbose=False, device="cpu")
    again = lines(str(tmp_path / "b")) + [
        "sensit.readFromFiles = 1", f"sensit.folderPath = {tmp_path}/a/SENSIT/",
    ]
    second = tsolve(tparse(again), verbose=False, device="cpu")
    np.testing.assert_array_equal(second.models[0].val, first.models[0].val)
    assert "build_s" not in second.timings


def test_stop_file_ends_the_loop(tmp_path):
    from tomofastx_tpu_torch.config.parfile import parse_parfile_lines as tparse
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag as tsolve

    lines = _write_problem(str(tmp_path), 8, 8, 4, 16)
    out = tmp_path / "a"
    out.mkdir()
    (out / "stop").write_text("")
    r = tsolve(tparse(lines(str(out))), verbose=False, device="cpu")
    assert r.costs_history == [] and r.cost_data[0] == 1.0


@pytest.mark.parametrize(
    "extra",
    ["sensit.readFromFiles = 2", "inversion.dampingGradient.grav.weight = 1.e-9",
     "inversion.dampingGradient.magn.weight = 1.0", "inversion.crossGradient.weight = 1.0",
     "inversion.clustering.grav.weight = 1.0"],
)
def test_formerly_refused_parfile_features_match_jax(tmp_path, extra):
    """The Parfile lines the port refused until the constraints were ported,
    on the gravity-only problem, through both packages. The damping gradient
    (of the active problem or of the inactive one) and sensit.readFromFiles =
    2 (the depth weight from the cache of a first JAX run, the kernel built
    again by each package) run in both: costs rtol 1e-6, the model to 1e-6 of
    its range, the tolerances of two builds (test_slice_from_scratch). The
    cross-gradient and clustering need both problems: ValueError in both,
    with no data written."""
    import torch

    from tomofastx_tpu_torch.config.parfile import parse_parfile_lines as tparse
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag as tsolve

    lines = _write_problem(str(tmp_path), 8, 8, 4, 16, niter=8)
    extra_lines = [extra]
    if extra.startswith("sensit"):
        jsolve(jparse(lines(str(tmp_path / "cache"))), solve_dtype=jnp.float64, compute_dtype=jnp.float64,
               verbose=False)
        extra_lines.append(f"sensit.folderPath = {tmp_path}/cache/SENSIT/")
    if "clustering" in extra:
        # The mixture is read before the problems are counted, in both packages.
        (tmp_path / "mixture.txt").write_text("2\n1.0 0.0 50.0 0.0 0.01 0.1\n1.0 250.0 50.0 0.05 0.01 0.1\n")
        extra_lines += ["inversion.clustering.nClusters = 2", "inversion.clustering.constraintsType = 1",
                        f"inversion.clustering.mixtureFile = {tmp_path}/mixture.txt"]
    jout, tout = str(tmp_path / "jax_out"), str(tmp_path / "torch_out")
    if "crossGradient" in extra or "clustering" in extra:
        for solve, parse, kw in ((jsolve, jparse, {}), (tsolve, tparse, {"device": "cpu"})):
            with pytest.raises(ValueError, match="BOTH problems"):
                solve(parse(lines(jout) + extra_lines), verbose=False, **kw)
        return
    rj = jsolve(jparse(lines(jout) + extra_lines), solve_dtype=jnp.float64, compute_dtype=jnp.float64, verbose=False)
    rt = tsolve(tparse(lines(tout) + extra_lines), solve_dtype=torch.float64, verbose=False, device="cpu")
    _compare(rj, rt, jout, tout, 1.0, 8, dict(rtol=1e-6, atol=1e-8), 1e-6)
    assert _tree(tout) == _tree(jout)
    if extra.startswith("sensit"):
        # The depth weight is the cache's, and each package wrote a cache of
        # its own build with that weight.
        assert "build_s" in rt.timings
        for out in (jout, tout):
            with open(f"{tmp_path}/cache/SENSIT/sensit_grav_weight", "rb") as a, \
                    open(f"{out}/SENSIT/sensit_grav_weight", "rb") as b:
                assert a.read() == b.read()
    if "dampingGradient.grav" in extra:
        assert all(c > 0.0 for row in _costs(os.path.join(tout, "costs.txt"))[1:-1] for c in row[9:12])


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_cli_runs_on_cpu_in_a_subprocess(tmp_path):
    lines = _write_problem(str(tmp_path), 8, 8, 4, 16)
    par = tmp_path / "Parfile.txt"
    par.write_text("\n".join(lines(str(tmp_path / "out"))))
    p = _run(["-m", "tomofastx_tpu_torch", "-p", str(par), "--device", "cpu"], str(tmp_path))
    assert p.returncode == 0, p.stderr
    assert "THE END." in p.stdout and "lsqr iters = 20" in p.stdout and "kernel_format = tiled" in p.stdout
    for f in ("costs.txt", "Parfile_run.txt", "model/grav_final_model_full.txt", "Paraview/grav_final_model3D_full.vtk"):
        assert (tmp_path / "out" / f).exists(), f
    q = _run(["-m", "tomofastx_tpu_torch", "-j", str(par), "--device", "cpu", "-q", "--precision", "single"], str(tmp_path))
    assert q.returncode == 0 and "lsqr iters" not in q.stdout


def test_cli_runs_a_parfile_without_a_kernel_format_line(tmp_path):
    """The default Parfile (no tpu.kernelFormat line) means dense, and runs."""
    lines = _write_problem(str(tmp_path), 8, 8, 4, 16, niter=6, fmt=None)
    par = tmp_path / "Parfile.txt"
    par.write_text("\n".join(lines(str(tmp_path / "out"))))
    assert "kernelFormat" not in par.read_text()
    p = _run(["-m", "tomofastx_tpu_torch", "-p", str(par), "--device", "cpu"], str(tmp_path))
    assert p.returncode == 0, p.stderr
    for said in ("kernel_format = dense", "predicted kernel size", "COMPRESSION RATE = 0.1", "kernel cached in",
                 "grav kernel: dense (16, 256) torch.float64", "lsqr iters = 6", "THE END."):
        assert said in p.stdout, said
    for f in ("costs.txt", "model/grav_final_model_full.txt", "SENSIT/sensit_grav_1_0", "SENSIT/sensit_grav_nnz"):
        assert (tmp_path / "out" / f).exists(), f


def test_cli_fails_cleanly(tmp_path):
    lines = _write_problem(str(tmp_path), 8, 8, 4, 16)
    par = tmp_path / "Parfile.txt"
    par.write_text("\n".join(lines(str(tmp_path / "out"))))
    # --fused M runs (chunks of on-device majors): costs.txt written, the data cost falling.
    p = _run(["-m", "tomofastx_tpu_torch", "-p", str(par), "--device", "cpu", "-q", "--fused", "2"], str(tmp_path))
    assert p.returncode == 0, p.stderr
    rows = _costs(str(tmp_path / "out" / "costs.txt"))
    assert len(rows) == 4 and rows[1][1] < rows[0][1]
    p = _run(["-m", "tomofastx_tpu_torch", "-p", str(tmp_path / "nothing.txt"), "--device", "cpu"], str(tmp_path))
    assert p.returncode == 1 and "ERROR" in p.stderr
    # The default device is the card: without one the run is refused, not moved to the CPU.
    p = _run(["-c", "import torch,sys; sys.exit(7 if torch.cuda.is_available() else 0)"], str(tmp_path))
    if p.returncode == 0:
        p = _run(["-m", "tomofastx_tpu_torch", "-p", str(par)], str(tmp_path))
        assert p.returncode == 1 and "no CUDA device" in p.stderr


# ------------------------------------------------------------ import hygiene

PORT = os.path.join(REPO, "tomofastx_tpu_torch")
_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|tomofastx_tpu)\b(?!_)", re.M)


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith((".py", ".cu", ".cuh"))]
    return sorted(out)


def test_port_sources_found():
    names = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert {"chip_smoke.py", "tomofastx_tpu_torch/ops/tile_matvec.py", "tomofastx_tpu_torch/csrc/tile_matvec.cu",
            "tomofastx_tpu_torch/inversion/workflow.py", "tomofastx_tpu_torch/cli.py",
            "tomofastx_tpu_torch/ops/blocked_matvec.py", "tomofastx_tpu_torch/csrc/blocked_matvec.cu",
            "tomofastx_tpu_torch/ops/sparse_kernel.py", "tomofastx_tpu_torch/ops/_cuda_build.py",
            "tomofastx_tpu_torch/ops/bf16_gemv.py", "tomofastx_tpu_torch/csrc/bf16_gemv.cu",
            "tomofastx_tpu_torch/ops/prism_matvec.py", "tomofastx_tpu_torch/csrc/prism_matvec_f32.cu",
            "tomofastx_tpu_torch/csrc/prism_matvec_f64.cu", "tomofastx_tpu_torch/csrc/prism_matvec.cuh"} <= names


@pytest.mark.parametrize("path", [os.path.relpath(p, REPO) for p in _port_sources()])
def test_no_file_of_the_port_imports_jax_or_the_jax_package(path):
    with open(os.path.join(REPO, path)) as f:
        src = f.read()
    assert not _IMPORT.search(src), path
    assert "import triton" not in src.split("def ")[0]  # nothing of the card at import time


@pytest.mark.parametrize("module", ["tomofastx_tpu_torch", "tomofastx_tpu_torch.cli", "tomofastx_tpu_torch.inversion.workflow",
                                    "tomofastx_tpu_torch.ops.tile_matvec", "tomofastx_tpu_torch.convert", "chip_smoke",
                                    "tomofastx_tpu_torch.ops.blocked_matvec", "tomofastx_tpu_torch.ops.sparse_kernel",
                                    "tomofastx_tpu_torch.io.sensit_cache", "tomofastx_tpu_torch.ops.prism",
                                    "tomofastx_tpu_torch.ops.matrixfree", "tomofastx_tpu_torch.ops.sensitivity",
                                    "tomofastx_tpu_torch.parallel.mesh", "tomofastx_tpu_torch.inversion.operators",
                                    "tomofastx_tpu_torch.inversion.joint", "tomofastx_tpu_torch.ops.bf16_gemv",
                                    "tomofastx_tpu_torch.ops.prism_matvec"])
def test_importing_the_port_loads_neither_jax_nor_the_jax_package(module):
    code = (
        f"import sys; import {module}; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'jaxlib' "
        "or m == 'tomofastx_tpu' or m.startswith('tomofastx_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    p = _run(["-c", code], REPO)
    assert p.returncode == 0, p.stdout + p.stderr


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without a CUDA device the script exits non-zero and prints no result
    line; with one this test has nothing to say."""
    p = _run(["-c", "import torch,sys; sys.exit(7 if torch.cuda.is_available() else 0)"], str(tmp_path))
    if p.returncode != 0:
        pytest.skip("a CUDA device is present: chip_smoke.py would run in full")
    p = _run([os.path.join(REPO, "chip_smoke.py")], str(tmp_path))
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
