"""scripts/run_capacity_torch.py on the CPU: each rung's small fixtures and
Parfile against what the JAX capacity script it ports writes at the same size
(its main() run up to its solve, in a temporary directory, the solve stopped
there), and each kind of rung through the port (float64) against the JAX
package's solve_problem_joint_gravmag on those fixtures."""

import contextlib
import importlib.util
import json
import os
import re
import shutil
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tomofastx_tpu.config.parfile as jparfile
import tomofastx_tpu.inversion.workflow as jworkflow
import tomofastx_tpu.ops.sensitivity as jsens
import tomofastx_tpu.utils.compile_cache as jcompile_cache
import tomofastx_tpu_torch.ops.sensitivity as tsens

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "run_capacity_torch.py")
_spec = importlib.util.spec_from_file_location("run_capacity_torch", SCRIPT)
cap = sys.modules[_spec.name] = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cap)

# Each JAX script's switch to its small sizes.
SMALL_ENV = {"scripts/run_2m_cell.py": "MC_SMALL", "scripts/run_4m_matrixfree.py": "MC_SMALL",
             "scripts/run_million_joint.py": "MJ_SMALL", "scripts/run_bttb_giant.py": "BG_SMALL",
             "scripts/run_million_cell.py": "MC_SMALL", "scripts/probe_generic_4m.py": "GP_SMALL"}
# The environment that picks a script's other settings: run_million_cell.py's
# build (MC_BUILD, its legacy alias MC_F64_BUILD), probe_generic_4m.py's
# far-field quadrature (GP_FARQ, default 1) and platform (GP_CPU), and
# run_bttb_giant.py's fused major loop (BG_FUSED).
OTHER_ENV = ("MC_BUILD", "MC_F64_BUILD", "GP_FARQ", "GP_CPU", "BG_FUSED")
# Each JAX script's switch to its fused major loop, where it has one.
FUSED_ENV = {"scripts/run_bttb_giant.py": "BG_FUSED"}
# One rung of each kind: the four matrix-free rungs share one small size.
KINDS = {"bf16": "2m", "matrixfree": "4m", "joint": "joint1m", "bttb": "bttb134m"}


class _Stopped(BaseException):
    """Raised by the stand-in solve: passes the joint script's `except
    Exception` around its fused solve."""


def jax_script_fixture(script, work, monkeypatch, build="", fused=False):
    """What the JAX capacity script `script` writes under its small switch
    (and MC_BUILD = build, if given; its fused switch set to 1 if fused):
    its main() run with its work directory
    swapped for `work`, its compile-cache set-up a no-op, and its solve
    stopped where it is called. Returns (its Parfile lines, its solve's
    keyword arguments, the directory it wrote into: run_million_cell.py
    appends the build's suffix to `work`)."""
    seen = {}
    real_parse = jparfile.parse_parfile_lines

    def parse(lines):
        seen["lines"] = list(lines)
        return real_parse(lines)

    def stop(cfg, **kw):
        seen["kw"] = kw
        raise _Stopped

    for name in OTHER_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(SMALL_ENV[script], "1")
    if build:
        monkeypatch.setenv("MC_BUILD", build)
    if fused:
        monkeypatch.setenv(FUSED_ENV[script], "1")
    monkeypatch.setattr(jcompile_cache, "enable", lambda *a, **k: None)
    monkeypatch.setattr(jparfile, "parse_parfile_lines", parse)
    monkeypatch.setattr(jworkflow, "solve_problem_joint_gravmag", stop)
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    path = os.path.join(REPO, script)
    with open(path) as f:
        src = f.read()
    src, n = re.subn(r'work = f"/tmp/[^"]*"', f"work = {work!r}", src)
    assert n == 1, script
    space = {"__name__": "jax_capacity_script", "__file__": path}
    exec(compile(src, path, "exec"), space)
    with pytest.raises(_Stopped):
        space["main"]()
    out = next(ln.partition("=")[2].strip() for ln in seen["lines"] if ln.startswith("global.outputFolderPath"))
    assert out.startswith(work) and out.endswith("/out/"), out
    return seen["lines"], seen["kw"], out[: -len("/out/")]


def _keys(lines, work):
    """{key: value} of Parfile lines, the work directory written as WORK."""
    out = {}
    for ln in lines:
        key, _, value = ln.partition("=")
        out[key.strip()] = value.strip().replace(work, "WORK")
    return out


def _files(work):
    return sorted(f for f in os.listdir(work) if f.endswith(".txt"))


@pytest.mark.parametrize("rung", list(cap.RUNGS))
def test_small_fixture_is_what_the_jax_script_writes(tmp_path, monkeypatch, rung):
    """The rung's small fixture files byte for byte, its Parfile key for key
    and its solve's arguments (the fused rung's fused_chunk among them),
    against the JAX script's."""
    spec = cap.RUNGS[rung]
    jwork, twork = str(tmp_path / "jax"), str(tmp_path / "torch")
    os.makedirs(jwork)
    jlines, jkw, jwork = jax_script_fixture(spec.source, jwork, monkeypatch, spec.build, spec.fused)
    fx = cap.write_fixture(rung, twork, small=True)
    assert _keys(fx.lines, twork) == _keys(jlines, jwork)
    assert _files(twork) == _files(jwork)
    for name in _files(jwork):
        with open(os.path.join(jwork, name), "rb") as a, open(os.path.join(twork, name), "rb") as b:
            assert a.read() == b.read(), name
    dtypes = {jnp.float32: torch.float32, jnp.float64: torch.float64}
    want = {k: dtypes.get(v, v) for k, v in jkw.items() if k not in ("base_dir", "verbose")}
    got = dict(fx.solve_kw, solve_dtype=torch.float32)
    if not want.get("fused_chunk"):
        want.pop("fused_chunk", None)
    assert got == want
    assert fx.ncells == int(np.prod(spec.small[0])) and fx.depth == spec.small[2]


def test_rungs_at_full_width_are_the_jax_scripts():
    """Each rung's full size and depth are its JAX script's (as the script's
    JSON record states them, where the repository holds it)."""
    records = {"2m": "CAPACITY_2M.json", "4m": "CAPACITY_4M_MATRIXFREE.json", "8m": "CAPACITY_8M_MATRIXFREE.json",
               "16m": "CAPACITY_16M_MATRIXFREE.json", "32m": "CAPACITY_32M_MATRIXFREE.json",
               "joint1m": "MILLION_JOINT.json", "bttb134m": "BTTB_GIANT_134M.json",
               "bttb134m_fused": "BTTB_GIANT_134M.json",
               "1m_f64": "MILLION_CELL_F64.json", "1m_f32quad": "MILLION_CELL_F32QUAD.json",
               "generic4m": "GENERIC_4M_PROBE.json"}
    for rung, name in records.items():
        with open(os.path.join(REPO, name)) as f:
            rec = json.load(f)
        size, side, (majors, minors) = cap.RUNGS[rung].full
        assert (int(np.prod(size)), side * side, majors, minors) == (
            rec["ncells"], rec["ndata"], rec["majors"], rec["minors"]), rung
        if cap.RUNGS[rung].build:
            assert cap.MC_BUILDS[cap.RUNGS[rung].build][0] == rec["build"], rung
    # MILLION_CELL.json holds the mixed build's run at the script's small size.
    with open(os.path.join(REPO, "MILLION_CELL.json")) as f:
        rec = json.load(f)
    size, side, (majors, minors) = cap.RUNGS["1m"].small
    assert (int(np.prod(size)), side * side, majors, minors) == (rec["ncells"], rec["ndata"], rec["majors"],
                                                                  rec["minors"])


# LSQR minor iterations of the parity runs. The small fixtures sit where
# LSQR amplifies rounding: on the BTTB rung's, the two packages' costs after
# one major of 10 iterations agree to 5.4e-13 and after the second to 1.0e-2,
# and the JAX package's own BTTB and dense (float32-stored) operators part by
# 2 % there; on the 2m rung's, the two packages on one bfloat16 kernel agree
# to 1e-15 after 2 iterations and part by 2.5e-3 after 14. With 2 iterations
# a major, every major of each Parfile runs (its build, storage, refinement
# forward, fused chunks, constraints) and the sums the packages order
# differently stay rounding.
PARITY_MINORS = 2


def _with_minors(lines, n):
    return [f"inversion.nMinorIterations = {n}\n" if ln.startswith("inversion.nMinorIterations") else ln
            for ln in lines]


@contextlib.contextmanager
def port_kernels_in_jax():
    """The port's kernel builds recorded, and the JAX package's build handing
    them back in the same order, as they are (bfloat16 or float32): the two
    bfloat16 rungs, and the mixed and compensated million-cell builds, build
    in float32, whose rows the packages round differently (held by
    tests/test_torch_build_variants.py), so that here both solve one kernel;
    and the JAX package's float32 builds take most of this file's time."""
    built = []
    port_build = tsens.compute_sensitivity

    def record(*a, **k):
        K = port_build(*a, **k)
        built.append((K, K.S.clone()))  # the workflow lets go of K.S once it is weighted
        return K

    def hand_back(*a, **k):
        K, S = built.pop(0)
        S = S.view(torch.int16).numpy().view(ml_dtypes.bfloat16) if S.dtype == torch.bfloat16 else S.numpy()
        return jsens.SensitKernel(S=jnp.asarray(S), ndata=K.ndata, ndata_components=K.ndata_components,
                                  nmodel_components=K.nmodel_components, nx=K.nx, ny=K.ny, nz=K.nz,
                                  compression_type=K.compression_type, comp_error=K.comp_error, nnz=K.nnz)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsens, "compute_sensitivity", record)
        mp.setattr(jsens, "compute_sensitivity", hand_back)
        yield built


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Each kind's small rung solved by both packages in float64 on the
    fixtures the JAX script writes (the port's own are held to them above),
    PARITY_MINORS LSQR iterations a major, the bfloat16 rungs on the port's
    kernels (port_kernels_in_jax): {kind: (JAX result, port result, port
    record, fixture)}."""
    runs = {}
    for kind, rung in KINDS.items():
        work = str(tmp_path_factory.mktemp(kind))
        fx = cap.write_fixture(rung, work, small=True)
        fx.lines = _with_minors(fx.lines, PARITY_MINORS)
        jkw = {k: {torch.float32: jnp.float32}.get(v, v) for k, v in fx.solve_kw.items()}
        with port_kernels_in_jax() if kind in ("bf16", "joint") else contextlib.nullcontext() as built:
            tres, log, wall, peak = cap.solve(fx, device="cpu", solve_dtype=torch.float64, verbose=False)
            jres = jworkflow.solve_problem_joint_gravmag(
                jparfile.parse_parfile_lines([ln.replace(f"{work}/out/", f"{work}/jax_out/") for ln in fx.lines]),
                base_dir=work, verbose=False, solve_dtype=jnp.float64, **jkw)
            assert not built
        runs[kind] = (jres, tres, cap.record(fx, tres, log, wall, peak, "cpu"), fx)
    return runs


# Costs rtol 1e-8 and every model to 1e-8 of its range, as
# tests/test_torch_workflow.py holds a run.
COST_RTOL, MODEL_TOL = 1e-8, 1e-8


@pytest.mark.parametrize("kind", list(KINDS))
def test_small_rung_matches_jax(both, kind):
    """Every major's data cost, the final costs and every final model, at
    COST_RTOL and MODEL_TOL; the record's costs are the run's and fall."""
    jres, tres, rec, fx = both[kind]
    cost_rtol, model_tol = COST_RTOL, MODEL_TOL
    problems = range(len(fx.truth))
    assert tres.timings["lsqr_iters"] == [PARITY_MINORS] * fx.depth[0]
    assert len(tres.costs_history) == len(jres.costs_history) == fx.depth[0]
    for hj, ht in zip(jres.costs_history, tres.costs_history):
        np.testing.assert_allclose([ht["cost_data"][i] for i in problems], [hj["cost_data"][i] for i in problems],
                                   rtol=cost_rtol)
    np.testing.assert_allclose(tres.cost_data, jres.cost_data, rtol=cost_rtol, atol=1e-300)
    for i in problems:
        mj, mt = np.asarray(jres.models[i].val), tres.models[i].val
        np.testing.assert_allclose(mt, mj, rtol=0, atol=model_tol * (mj.max() - mj.min()))
    assert rec["cost_falls"] and rec["majors"] == fx.depth[0] and rec["ncells"] == fx.ncells
    assert rec["peak_device_bytes"] is None and rec["host_peak_rss_bytes"] > 0
    assert rec["cost_history_grav"] == [h["cost_data"][0] for h in tres.costs_history]


def test_record_names_the_operator_and_loop(both):
    """The records say what ran: bfloat16 dense kernels (and the refinement
    forward of the 2m rung) in the fused loop, BTTB on the gridded surveys
    (at the small size the 4m rung's survey lies on the cell lattice too)."""
    assert "torch.bfloat16" in both["bf16"][2]["operator"][0]
    assert both["bf16"][2]["refinement_forward"] and both["bf16"][2]["loop"][0].startswith("fused major loop")
    assert len(both["joint"][2]["operator"]) == 2 and both["joint"][2]["loop"][0].startswith("fused major loop")
    assert "chi_in_shared_body" in both["joint"][2]
    for kind in ("matrixfree", "bttb"):
        assert "BTTBKernel" in both[kind][2]["operator"][0] and both[kind][2]["loop"] == ["host-driven"]


def test_fused_bttb_rung_is_held_to_the_host_driven_one(both, tmp_path):
    """The bttb134m_fused rung (BG_FUSED = 1): its small fixture solved
    through the port's fused major loop, in one chunk of both majors, at
    PARITY_MINORS, its record naming that loop; its final costs and model
    held to the host-driven bttb134m run's through held_to (the --hold-to
    comparison, the host run's models saved as --save-model saves them),
    and to the JAX package's host-driven run, at COST_RTOL and MODEL_TOL."""
    jres, hres, hrec, hfx = both["bttb"]
    fx = cap.write_fixture("bttb134m_fused", str(tmp_path / "work"), small=True)
    fx.lines = _with_minors(fx.lines, PARITY_MINORS)
    assert fx.solve_kw == {"fused_chunk": fx.depth[0]} and not hfx.solve_kw
    res, log, wall, peak = cap.solve(fx, device="cpu", solve_dtype=torch.float64, verbose=False)
    rec = cap.record(fx, res, log, wall, peak, "cpu")
    assert rec["loop"] == [f"fused major loop: chunks of up to {fx.depth[0]} majors, eager steps on the CPU"]
    assert res.timings["lsqr_iters"] == [PARITY_MINORS] * fx.depth[0] and rec["cost_falls"]
    saved = str(tmp_path / "host.npy")
    np.save(saved, cap.final_models(hfx, hres))
    with open(tmp_path / "host.json", "w") as f:
        json.dump(dict(hrec, saved_model=saved), f)
    held = cap.held_to(rec, cap.final_models(fx, res), str(tmp_path / "host.json"))
    assert held["within"] and held["same_sizes"] and held["loop"] == ["host-driven"]
    assert held["model_apart_of_range_grav"] <= MODEL_TOL and held["cost_apart_grav"] <= COST_RTOL
    np.testing.assert_allclose(rec["cost_history_grav"], [h["cost_data"][0] for h in jres.costs_history],
                               rtol=COST_RTOL)
    mj = np.asarray(jres.models[0].val)
    np.testing.assert_allclose(res.models[0].val, mj, rtol=0, atol=MODEL_TOL * (mj.max() - mj.min()))


@pytest.mark.parametrize("case", ["same", "model apart", "cost apart", "other sizes"])
def test_hold_to_holds_the_formats_tolerance(tmp_path, case):
    """held_to against a saved run: within FORMATS_TOL where the models and
    costs agree; outside it where a model moves by 1e-2 of its range, a cost
    by 30 %, or the other run solved other sizes."""
    rng = np.random.default_rng(5)
    models = rng.normal(size=(1, 64))
    other = {"rung": "bttb134m", "loop": ["host-driven"], "ncells": 64, "ndata": 16, "majors": 2, "minors": 10,
             "final_cost_grav": 1e-3, "cost_history_grav": [1e-2, 1e-3], "truth_correlation_grav": 0.4,
             "timings": {"solve_s": [0.1, 0.1]}, "saved_model": str(tmp_path / "other.npy")}
    np.save(other["saved_model"], models)
    with open(tmp_path / "other.json", "w") as f:
        json.dump(other, f)
    rec = {k: other[k] for k in ("ncells", "ndata", "majors", "minors", "final_cost_grav")}
    mine = models.copy()
    if case == "model apart":
        mine[0, 3] += 1e-2 * (models.max() - models.min())
    elif case == "cost apart":
        rec["final_cost_grav"] *= 1.3
    elif case == "other sizes":
        rec["minors"] = 20
    held = cap.held_to(rec, mine, str(tmp_path / "other.json"))
    assert held["within"] == (case == "same")
    assert held["same_sizes"] == (case != "other sizes")


def test_script_imports_nothing_of_jax():
    """The script's source imports neither JAX, the JAX package nor a JAX
    capacity script (the port's modules it calls are held by
    tests/test_torch_workflow.py)."""
    with open(SCRIPT) as f:
        src = f.read()
    assert not re.search(r"^\s*(?:import|from)\s+(jax|tomofastx_tpu)\b(?!_)", src, re.M)
    imports = [ln for ln in src.splitlines() if ln.lstrip().startswith(("import ", "from "))]
    assert not any(re.search(r"\b(run_(2m_cell|4m_matrixfree|million_\w+|bttb_giant)|probe_generic_4m)\b", ln)
                   for ln in imports)


@pytest.mark.parametrize("rung", [r for r, spec in cap.RUNGS.items() if spec.kind == "dense"])
def test_script_refuses_a_cache_the_disk_cannot_hold(tmp_path, monkeypatch, capsys, rung):
    """A 1m rung whose temporary directory has fewer free bytes than its
    sensitivity cache needs (16.99 GB) returns 3, names the bytes and writes
    nothing: no fixture, no record."""
    need = cap.sensit_cache_bytes(rung)
    assert need == 20 + 2025 * (16 + 8 * 1048576) + 12 * 1048576 + 8
    asked = []

    def usage(path):
        asked.append(path)
        return shutil._ntuple_diskusage(need, need - 1, need - 1)

    monkeypatch.setattr(cap.shutil, "disk_usage", usage)
    monkeypatch.setattr(cap.tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(cap, "write_fixture", lambda *a, **k: pytest.fail("fixtures written"))
    assert cap.main(["--rung", rung, "--device", "cpu", "--out-dir", str(tmp_path / "out")]) == 3
    assert f"{need:,} bytes" in capsys.readouterr().err
    assert len(asked) == 1 and asked[0].startswith(str(tmp_path)) and os.listdir(tmp_path) == []


def test_script_refuses_to_run_without_a_card(tmp_path, monkeypatch):
    """Without a CUDA device a run on the card (the default) returns 2 and
    writes no record."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cap.main(["--rung", "4m", "--out-dir", str(tmp_path)]) == 2
    assert not os.listdir(tmp_path)
