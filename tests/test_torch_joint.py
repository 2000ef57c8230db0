"""The magnetic, gradiometry and joint gravity + magnetic slice as a whole:
synthetic Parfiles of every kind (TMI, three-component magnetic data,
magnetization vector, a borehole survey, FTG Gzz, the full FTG tensor, joint
grav+mag) through solve_problem_joint_gravmag and the command-line entry
point of both packages on the CPU in float64, the port solving from the
cache that the JAX run wrote; every stored-kernel format and an 8-slot
mesh; and where a kernel is assembled before a mesh of distinct cards cuts
it (parallel.mesh.assembly_device)."""

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

from util_fixtures import surface_data_points, write_data_grid_file, write_grid_file, write_values_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX, NY, NZ, ND = 8, 6, 5, 24
N = NX * NY * NZ
NITER = 8  # minor iterations, below the number of data rows of every kind

# kind: (Parfile lines beyond the common ones, active problems, data components)
KINDS = {
    "tmi": (["@mag", "inversion.joint.grav.problemWeight = 0"], (1,), 1),
    "mag-3-components": (["@mag", "inversion.joint.grav.problemWeight = 0",
                          "forward.data.magn.nDataComponents = 3"], (1,), 3),
    "magnetization-vector": (["@mag3", "inversion.joint.grav.problemWeight = 0",
                              "modelGrid.magn.nModelComponents = 3"], (1,), 1),
    "borehole": (["@borehole", "inversion.joint.grav.problemWeight = 0"], (1,), 1),
    "gzz": (["@grav", "forward.data.grav.type = 2"], (0,), 1),
    "ftg": (["@grav", "forward.data.grav.type = 2", "forward.data.grav.nDataComponents = 6"], (0,), 6),
    "joint": (["@grav", "@mag", "inversion.joint.magn.problemWeight = 1.e-8",
               "inversion.modelDamping.magn.weight = 1.e-9"], (0, 1), 1),
}


def _write_inputs(tmp):
    """Grid, observation files (above the cell centres; for the borehole
    survey every other point lies inside a cell, off every face) and
    seeded block models under tmp."""
    write_grid_file(f"{tmp}/grid.txt", NX, NY, NZ, h=(100.0, 80.0, 50.0))
    X, Y, Z = surface_data_points(NX, NY, h=(100.0, 80.0))
    idx = np.linspace(0, len(X) - 1, ND).astype(int)
    X, Y, Z = X[idx], Y[idx], Z[idx]
    for ndc in (1, 3, 6):
        write_data_grid_file(f"{tmp}/data{ndc}.txt", X, Y, Z, ncomponents=ndc)
    Zb = Z.copy()
    Zb[1::2] = 60.0 + 7.0 * np.arange(ND // 2) % 150.0
    write_data_grid_file(f"{tmp}/data_borehole.txt", X + 13.0, Y + 11.0, Zb)
    rng = np.random.default_rng(5)
    m = np.zeros((NZ, NY, NX))
    m[1:3, 2:4, 3:6] = 1.0
    m += 0.01 * rng.normal(size=m.shape)  # seeded roughness, so no symmetry ties
    write_values_file(f"{tmp}/synth_grav.txt", (250.0 * m).reshape(-1)[:, None])
    write_values_file(f"{tmp}/synth_mag.txt", (0.05 * m).reshape(-1)[:, None])
    write_values_file(f"{tmp}/synth_mag3.txt", np.stack([0.01 * m, 0.02 * m, 0.05 * m], -1).reshape(-1, 3))


def _lines(tmp, kind, out, fmt="tiled"):
    extra, _, ndc = KINDS[kind]
    lines = f"""global.outputFolderPath = {out}/
modelGrid.size = {NX} {NY} {NZ}
modelGrid.grav.file = {tmp}/grid.txt
modelGrid.magn.file = {tmp}/grid.txt
forward.depthWeighting.type = 2
forward.matrixCompression.type = 1
forward.matrixCompression.rate = 0.2
forward.magneticField.inclination = 60
forward.magneticField.declination = 10
forward.magneticField.intensity_nT = 50000
inversion.nMajorIterations = 3
inversion.nMinorIterations = {NITER}
inversion.writeModelEveryNiter = 2
inversion.modelDamping.grav.weight = 1.e-9
inversion.modelDamping.magn.weight = 1.e2
inversion.admm.enableADMM = 1
inversion.admm.nLithologies = 2
inversion.admm.grav.bounds = -10 10 240 260
inversion.admm.grav.weight = 1.e-7
inversion.admm.magn.bounds = -0.005 0.005 0.04 0.06
inversion.admm.magn.weight = 1.e-2
""".splitlines() + ([f"tpu.kernelFormat = {fmt}"] if fmt else [])
    grav = [f"forward.data.grav.nData = {ND}", f"forward.data.grav.dataGridFile = {tmp}/data{ndc}.txt",
            "forward.data.grav.useSyntheticModelForDataValues = 1",
            f"forward.data.grav.syntheticModelFile = {tmp}/synth_grav.txt"]
    mag = [f"forward.data.magn.nData = {ND}", f"forward.data.magn.dataGridFile = {tmp}/data{ndc}.txt",
           "forward.data.magn.useSyntheticModelForDataValues = 1",
           f"forward.data.magn.syntheticModelFile = {tmp}/synth_mag.txt",
           "inversion.joint.magn.problemWeight = 1.0"]
    blocks = {
        "@grav": grav, "@mag": mag,
        "@mag3": [ln.replace("synth_mag.txt", "synth_mag3.txt") for ln in mag],
        "@borehole": [ln.replace(f"data{ndc}.txt", "data_borehole.txt") for ln in mag],
    }
    for e in extra:
        lines += blocks.get(e, [e])
    return lines


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """One JAX run of each kind (dense format, writing its cache), made the
    first time a test asks for it."""
    tmp = str(tmp_path_factory.mktemp("joint"))
    _write_inputs(tmp)
    runs = {}

    def get(kind):
        if kind not in runs:
            out = f"{tmp}/jax_{kind}"
            res = jsolve(jparse(_lines(tmp, kind, out, fmt="dense")), solve_dtype=jnp.float64,
                         compute_dtype=jnp.float64, verbose=False)
            runs[kind] = (res, out)
        return tmp, runs[kind]

    return get


def _costs(path):
    with open(path) as f:
        return [np.array(ln.split(), float) for ln in f if not ln.startswith("#")]


def _tree(root):
    """Relative paths of all files under root, bar SENSIT."""
    return sorted(
        os.path.relpath(os.path.join(d, f), root)
        for d, _, files in os.walk(root) for f in files
        if not os.path.relpath(d, root).startswith("SENSIT")
    )


def _same_checkpoint(a, b, tol=1e-8):
    """Two checkpoint.npz files: the same keys; the counters and the active
    problems equal; each problem's model, prior and ADMM state (all in the
    model's units) to `tol` of the range of its model, rho rtol `tol`."""
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            va, vb = za[k], zb[k]
            assert va.shape == vb.shape, k
            if k in ("m", "it", "active"):
                np.testing.assert_array_equal(vb, va, err_msg=k)
            elif k == "rho_admm":
                np.testing.assert_allclose(vb, va, rtol=tol, atol=1e-300, err_msg=k)
            else:
                model = za["model_" + k.rsplit("_", 1)[1]]
                np.testing.assert_allclose(vb, va, rtol=0, atol=tol * (model.max() - model.min()), err_msg=k)


def _same_bytes(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


def _compare(kind, rj, jout, rt, tout, priors=1):
    """costs.txt column by column rtol 1e-8, every active problem's final
    model to 1e-8 of its range and final data rtol 1e-8, the same output
    files, the checkpoints by keys and values at the same tolerances, the
    observed data and the synthetic models' VTK byte-equal."""
    _, active, ndc = KINDS[kind]
    assert rt.timings["lsqr_iters"] == [NITER] * 3 * priors
    cj, ct = _costs(os.path.join(jout, "costs.txt")), _costs(os.path.join(tout, "costs.txt"))
    assert len(cj) == len(ct) == 4
    for a, b in zip(cj, ct):
        np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-300)
    for i in active:
        assert ct[-1][1 + i] < 0.5 * ct[0][1 + i]  # the data cost fell
        mj, mt = rj.models[i].val, rt.models[i].val
        assert mt.shape == mj.shape
        np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-8 * (mj.max() - mj.min()))
        assert rt.data[i].val_calc.shape == (ND, ndc)
        np.testing.assert_allclose(rt.data[i].val_calc, rj.data[i].val_calc, rtol=1e-8, atol=1e-300)
    np.testing.assert_allclose(rt.cost_data, rj.cost_data, rtol=1e-8, atol=1e-300)
    np.testing.assert_allclose(rt.cost_model, rj.cost_model, rtol=1e-8, atol=1e-300)
    assert _tree(tout) == _tree(jout)
    assert os.path.exists(os.path.join(jout, "checkpoint.npz"))  # writeModelEveryNiter = 2
    _same_checkpoint(os.path.join(jout, "checkpoint.npz"), os.path.join(tout, "checkpoint.npz"))
    for i in active:
        prefix = ("grav", "mag")[i]
        for f in (f"data/{prefix}_observed.txt", f"Paraview/data_{prefix}_observed.vtk",
                  f"Paraview/{prefix}_synth_model3D_full.vtk"):
            assert _same_bytes(os.path.join(jout, f), os.path.join(tout, f)), f


def _port(tmp, kind, jout, out, fmt, mesh=None, extra=()):
    lines = _lines(tmp, kind, out, fmt=fmt) + ["sensit.readFromFiles = 1", f"sensit.folderPath = {jout}/SENSIT/"]
    return twf.solve_problem_joint_gravmag(tparse(lines + list(extra)), solve_dtype=torch.float64, verbose=False,
                                           device="cpu", mesh=mesh)


FORMATS = pytest.mark.parametrize("fmt", ["dense", "packed", "tiled", "auto"])


@FORMATS
@pytest.mark.parametrize("kind", list(KINDS))
def test_kind_matches_jax(jax_runs, tmp_path, kind, fmt):
    """Each kind in each stored-kernel format, both packages from one cache
    (the port packs the cache that the JAX run wrote)."""
    tmp, (rj, jout) = jax_runs(kind)
    rt = _port(tmp, kind, jout, str(tmp_path / "out"), fmt)
    _compare(kind, rj, jout, rt, str(tmp_path / "out"))


@pytest.mark.parametrize("fmt,operator", [("tiled", "ShardedTileKernel"), ("dense", "ShardedDenseKernel"),
                                          ("packed", "ShardedPackedKernel"), ("auto", "ShardedPackedKernel")])
def test_joint_on_an_8_slot_mesh_matches_jax(jax_runs, tmp_path, monkeypatch, fmt, operator):
    """The joint run over 8 CPU slots: both problems' operators sharded once,
    the result held to the unmeshed JAX run as above."""
    made = []
    orig = twf.shard_kernel
    monkeypatch.setattr(twf, "shard_kernel", lambda k, m: made.append(orig(k, m)) or made[-1])
    tmp, (rj, jout) = jax_runs("joint")
    rt = _port(tmp, "joint", jout, str(tmp_path / "out"), fmt, mesh=tmesh.make_mesh(8, device="cpu"))
    assert [type(k).__name__ for k in made] == [operator] * 2
    _compare("joint", rj, jout, rt, str(tmp_path / "out"))


@pytest.mark.parametrize("kind", ["joint", "magnetization-vector", "ftg", "borehole"])
def test_kind_from_scratch_matches_jax(jax_runs, tmp_path, kind):
    """The port builds its own kernels: the two packages' float64 builds
    differ in their last bits, and some thousandths of the entries round to
    the neighbouring float32 when stored; so the model is held to 1e-6 of
    its range and the costs to rtol 1e-6 (data costs 1e-8 absolute). Both
    caches hold the same entries: the nnz histograms byte-equal."""
    tmp, (rj, jout) = jax_runs(kind)
    tout = str(tmp_path / "out")
    rt = twf.solve_problem_joint_gravmag(tparse(_lines(tmp, kind, tout, fmt=None)), solve_dtype=torch.float64,
                                         verbose=False, device="cpu")
    _, active, _ = KINDS[kind]
    for a, b in zip(_costs(os.path.join(jout, "costs.txt")), _costs(os.path.join(tout, "costs.txt"))):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-8)
    for i in active:
        mj, mt = rj.models[i].val, rt.models[i].val
        np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-6 * (mj.max() - mj.min()))
        sfx = ("grav", "magn")[i]
        for f in ("nnz", "meta.txt"):
            assert os.path.exists(os.path.join(tout, "SENSIT", f"sensit_{sfx}_{f}"))
        assert _same_bytes(os.path.join(jout, "SENSIT", f"sensit_{sfx}_nnz"), os.path.join(tout, "SENSIT", f"sensit_{sfx}_nnz"))
    assert rt.timings["build_s"] > 0 and rt.timings["cache_write_s"] > 0


@pytest.mark.parametrize("kind,mesh", [(kind, "0") for kind in KINDS] + [("joint", "4")])
def test_kind_through_the_command_line(jax_runs, tmp_path, monkeypatch, kind, mesh):
    """cli.main(["-p", Parfile, "--device", "cpu"]) of each kind from the JAX
    run's cache (the joint kind also with --mesh 4): exit code 0, costs.txt
    rtol 1e-8 (as printed, 10 significant digits), the same output files."""
    tmp, (rj, jout) = jax_runs(kind)
    par = tmp_path / "Parfile.txt"
    out = tmp_path / "out"
    par.write_text("\n".join(_lines(tmp, kind, str(out), fmt="tiled")
                             + ["sensit.readFromFiles = 1", f"sensit.folderPath = {jout}/SENSIT/"]))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-p", str(par), "--device", "cpu", "--mesh", mesh, "-q"]) == 0
    for a, b in zip(_costs(os.path.join(jout, "costs.txt")), _costs(str(out / "costs.txt"))):
        np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-300)
    assert [f for f in _tree(str(out)) if f != "Parfile_run.txt"] == _tree(jout)


def test_joint_cli_in_a_subprocess(tmp_path):
    """python -m tomofastx_tpu_torch -p <joint Parfile> --device cpu from
    scratch: both problems built, cached and solved."""
    tmp = str(tmp_path)
    _write_inputs(tmp)
    par = tmp_path / "Parfile.txt"
    par.write_text("\n".join(_lines(tmp, "joint", str(tmp_path / "out"), fmt="tiled")))
    p = subprocess.run([sys.executable, "-m", "tomofastx_tpu_torch", "-p", str(par), "--device", "cpu"], cwd=tmp,
                       env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    for said in ("active = ['grav', 'mag']", "grav kernel: tiled", "mag kernel: tiled",
                 f"lsqr iters = {NITER}", "THE END."):
        assert said in p.stdout, said
    for f in ("SENSIT/sensit_grav_1_0", "SENSIT/sensit_magn_1_0", "model/grav_final_model_full.txt",
              "model/mag_final_model_full.txt", "Paraview/mag_final_model3D_full.vtk"):
        assert (tmp_path / "out" / f).exists(), f


# ------------------------------------------- fault 1: where a mesh assembles


def test_assembly_device_is_the_host_for_distinct_cards():
    """Slots on distinct cards: the kernel is assembled on the host, so no
    card holds more than its own part. Slots on one card (or the CPU): the
    home device, where the parts are views of the whole. Building the mesh
    needs no card."""
    cards = tmesh.Mesh(np.array([torch.device("cuda", k) for k in range(4)], dtype=object), ("cells",))
    assert tmesh.assembly_device(cards) == torch.device("cpu")
    grid = tmesh.Mesh(np.array([[torch.device("cuda", 2 * r + c) for c in range(2)] for r in range(2)],
                               dtype=object), ("obs", "cells"))
    assert tmesh.assembly_device(grid) == torch.device("cpu")
    one_card = tmesh.Mesh(np.array([torch.device("cuda", 0)] * 4, dtype=object), ("cells",))
    assert tmesh.assembly_device(one_card) == torch.device("cuda", 0)
    assert tmesh.assembly_device(tmesh.make_mesh(8, device="cpu")) == torch.device("cpu")


@pytest.mark.parametrize("fmt,read", [("tiled", False), (None, False), (None, True), ("packed", True)],
                         ids=["tiled-build-and-pack", "dense-build", "dense-read", "packed-read"])
def test_workflow_hands_the_assembly_device_to_the_build_and_readers(jax_runs, tmp_path, monkeypatch, fmt, read):
    """Over a mesh, the build and every cache reader get
    assembly_device(mesh), and no other device: here a device object that
    compares unequal to the home device (cpu:0 against cpu) stands for the
    host. The result is that of the run without it, bit for bit."""
    tmp, (_, jout) = jax_runs("joint")
    host = torch.device("cpu", 0)
    seen = []

    def spy(fn):
        def call(*a, **k):
            seen.append((fn.__name__, k.get("device", a[-1])))
            return fn(*a, **k)
        return call

    for mod, name in ((twf.sens, "compute_sensitivity"), (twf, "tile_kernel_from_cache"),
                      (twf, "read_kernel_cache_packed"), (twf, "try_read_kernel_cache")):
        monkeypatch.setattr(mod, name, spy(getattr(mod, name)))
    lines = _lines(tmp, "joint", "", fmt=fmt)[1:]
    if read:
        lines += ["sensit.readFromFiles = 1", f"sensit.folderPath = {jout}/SENSIT/"]
    mesh = tmesh.make_mesh(4, device="cpu")
    res = {}
    for name, dev in (("home", None), ("host", host)):
        if dev is not None:
            monkeypatch.setattr(twf, "assembly_device", lambda m: host)
        seen.clear()
        res[name] = twf.solve_problem_joint_gravmag(tparse([f"global.outputFolderPath = {tmp_path}/{name}/"] + lines),
                                                    solve_dtype=torch.float64, verbose=False, device="cpu", mesh=mesh)
    assert seen and all(d is host for _, d in seen), seen
    assert len({n for n, _ in seen}) == (2 if fmt == "tiled" and not read else 1)
    for i in (0, 1):
        np.testing.assert_array_equal(res["host"].models[i].val, res["home"].models[i].val)
