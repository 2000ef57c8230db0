"""The fused major loop of the port against the JAX package's, on the CPU in
float64: the device-resident LSQR against the host-exit one; make_fused_solver
on the tiny fully-coupled joint system of tests/test_fused.py (carried across
with convert.py); and solve_problem_joint_gravmag with fused_chunk = 3 over
5 majors written every 2 (chunks of 2, 2 and 1), the port solving from the
cache that the JAX run wrote, in the stored formats, BTTB matrix-free, the
coupled joint problem, refineForward and over 4 CPU slots; then the stop file,
a resume from a fused checkpoint, and the warm-up step that goes before a
capture (one LSQR iteration)."""

import collections
import contextlib
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tomofastx_tpu.config.parfile import parse_parfile_lines as jparse
from tomofastx_tpu.inversion import joint as jjoint
from tomofastx_tpu.inversion.workflow import solve_problem_joint_gravmag as jsolve

from tomofastx_tpu_torch import convert
from tomofastx_tpu_torch.config.parfile import parse_parfile_lines as tparse
from tomofastx_tpu_torch.inversion import joint as tjoint
from tomofastx_tpu_torch.inversion import workflow as twf
from tomofastx_tpu_torch.ops.lsqr import CARRY, lsqr_solve, while_on_the_host
from tomofastx_tpu_torch.parallel import mesh as tmesh
from tomofastx_tpu_torch.utils import trace

from test_torch_coupled import CLUSTER, XGRAD, write_coupling_inputs
from test_torch_joint import _lines as joint_lines
from test_torch_joint import _same_checkpoint
from test_torch_workflow import _costs, _write_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

MAJORS, CHUNK = 5, 3  # written every 2 majors: chunks of 2, 2 and 1


# ------------------------------------------------------ device-resident LSQR


def _well_conditioned(m, n, seed):
    rng = np.random.default_rng(seed)
    k = min(m, n)
    U, _ = np.linalg.qr(rng.normal(size=(m, k)))
    V, _ = np.linalg.qr(rng.normal(size=(n, k)))
    A = (U * rng.uniform(1.0, 4.0, k)) @ V.T
    return A, A @ rng.normal(size=n) + 1e-2 * rng.normal(size=m)


def _lsqr_case(case):
    """(A, b, niter, rmin, gamma, target) of the cases of
    tests/test_torch_solver.py."""
    if case.startswith("well"):
        m, n, niter, rmin, gamma = {
            "well-capped": (30, 20, 12, 1e-13, 0.0), "well-rmin": (25, 25, 200, 1e-3, 0.0),
            "well-rmin-early": (40, 10, 200, 5e-2, 0.0), "well-soft-threshold": (30, 20, 30, 1e-13, 0.05),
            "well-none": (12, 12, 0, 1e-13, 0.0),
        }[case]
        A, b = _well_conditioned(m, n, 100 + m + n)
        return A, b, niter, rmin, gamma, 0.0
    rng = np.random.default_rng({"consistent": 7, "zero-rhs": 0, "target-misfit": 9}[case])
    if case == "consistent":
        A = rng.normal(size=(10, 3)) @ rng.normal(size=(3, 8))
        return A, A @ rng.normal(size=8), 50, 1e-13, 0.0, 0.0
    if case == "zero-rhs":
        return np.eye(4), np.zeros(4), 10, 1e-13, 0.0, 0.0
    A = rng.normal(size=(30, 10))
    return A, A @ rng.normal(size=10), 100, 1e-13, 0.0, 1e-3


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["well-capped", "well-rmin", "well-rmin-early", "well-soft-threshold", "well-none",
                                  "consistent", "zero-rhs", "target-misfit"])
def test_resident_lsqr_equals_the_host_exit_one(case, dtype):
    """x, the iteration count, r and the misfit of lsqr_solve with a 0-dim
    tensor bound (the device-resident form) equal to the last bit to those
    with an int bound (the host-exit form); the tensor bound unrolled to its
    own length and to a larger one, and in the split form (the first
    products and the carry's buffers, then one iteration on them at a time,
    driven by while_on_the_host on the flag as the card's WHILE node drives
    it, capped at max_iter, then the result); capped to 0 the solve is
    x = 0 after 0 iterations in both forms, the split one running no
    iteration."""
    A, b, niter, rmin, gamma, target = _lsqr_case(case)
    At, bt = torch.as_tensor(A, dtype=dtype), torch.as_tensor(b, dtype=dtype)
    args = (lambda x: At @ x, lambda u: At.T @ u, bt, A.shape[1])
    misfit = (lambda x: torch.sqrt(torch.sum((At @ x - bt) ** 2) / b.size)) if target else None
    kw = dict(rmin=rmin, gamma=gamma, target_misfit=target, misfit_fn=misfit)
    host = lsqr_solve(*args, niter, **kw)
    runs = []

    def driven(loop):
        runs.append(while_on_the_host(loop))

    for res in (lsqr_solve(*args, torch.tensor(niter), max_iter=niter, **kw),
                lsqr_solve(*args, torch.tensor(niter), max_iter=niter + 3, **kw),
                lsqr_solve(*args, torch.tensor(niter), max_iter=niter, loop=driven, **kw),
                lsqr_solve(*args, torch.tensor(niter), max_iter=niter + 3, loop=driven, **kw)):
        assert int(res.iters) == host.iters
        assert res.x.dtype == dtype and torch.equal(res.x, host.x)
        assert torch.equal(res.r, host.r) and torch.equal(res.misfit, host.misfit)
    # The body runs once an iteration, and once more where a stop test
    # froze its last run (the target misfit; rho = 0 on a zero right-hand side).
    froze = case in ("target-misfit", "zero-rhs")
    assert runs == [host.iters + froze] * 2
    if case == "target-misfit":
        assert 0 < host.iters < niter
    for loop in (None, driven):
        capped = lsqr_solve(*args, torch.tensor(0), max_iter=max(niter, 1), loop=loop, **kw)
        assert int(capped.iters) == 0 and not capped.x.any()
    assert runs[2:] == [0]


def test_resident_lsqr_needs_an_unroll_for_a_tensor_bound():
    with pytest.raises(ValueError, match="max_iter"):
        lsqr_solve(lambda x: x, lambda u: u, torch.ones(3), 3, torch.tensor(2), 1e-13)
    with pytest.raises(ValueError, match="tensor bound"):
        lsqr_solve(lambda x: x, lambda u: u, torch.ones(3), 3, 2, 1e-13, loop=while_on_the_host)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["well-capped", "well-rmin-early", "target-misfit"])
def test_split_lsqr_keeps_its_buffers(case, dtype):
    """The split form writes every iteration into the buffers its first
    step made: each carry value and the flag keep their storage (data_ptr)
    across the iterations, each buffer is its own, and the runner sees the
    loop's cap."""
    A, b, niter, rmin, gamma, target = _lsqr_case(case)
    At, bt = torch.as_tensor(A, dtype=dtype), torch.as_tensor(b, dtype=dtype)
    misfit = (lambda x: torch.sqrt(torch.sum((At @ x - bt) ** 2) / b.size)) if target else None
    seen = []

    def watched(loop):
        ptrs = {k: loop.carry[k].data_ptr() for k in CARRY}, loop.go.data_ptr()
        assert set(loop.carry) == set(CARRY) and len(set(ptrs[0].values())) == len(CARRY)
        assert loop.max_iter == niter + 2
        while len(seen) < loop.max_iter and bool(loop.go):
            loop.iterate()
            seen.append(({k: loop.carry[k].data_ptr() for k in CARRY}, loop.go.data_ptr()) == ptrs)

    res = lsqr_solve(lambda x: At @ x, lambda u: At.T @ u, bt, A.shape[1], torch.tensor(niter), rmin=rmin, gamma=gamma,
                     target_misfit=target, misfit_fn=misfit, max_iter=niter + 2, loop=watched)
    assert seen and all(seen) and int(res.iters) == len(seen) - (case == "target-misfit")


@pytest.mark.parametrize("bad", ["go on the CPU", "go not bool", "runs not int32"])
def test_while_graph_takes_its_flag_and_counter_on_the_card(bad):
    """ops/graph_while.py's WhileGraph (the fused major's graph, LSQR as a
    WHILE node) refuses a flag or a body counter it cannot hand to the
    card's set_condition kernel, before it builds anything: it needs no
    card to refuse them."""
    from tomofastx_tpu_torch.ops.graph_while import WhileGraph

    go = torch.zeros((), dtype=torch.float32 if bad == "go not bool" else torch.bool)
    runs = torch.zeros((), dtype=torch.int64 if bad == "runs not int32" else torch.int32)
    with pytest.raises(ValueError, match="one CUDA device" if bad == "go on the CPU" else "0-dim bool tensor and"):
        WhileGraph(None, None, None, go, runs, 4)


# ------------------------------------------------------- make_fused_solver


def _jax_system(**spec_kw):
    """The JAX fixture of tests/test_fused.py:11-25."""
    import __graft_entry__ as ge

    spec, arrays = ge._tiny_joint_system(jnp.float64)
    rng = np.random.default_rng(7)
    arrays["val_meas"] = tuple(jnp.asarray(rng.normal(size=(nd, 1)), jnp.float64) for nd in spec.ndata_rows)
    arrays["data_weight"] = tuple(jnp.asarray(1.0 + rng.random((nd, 1)), jnp.float64) for nd in spec.ndata_rows)
    return dataclasses.replace(spec, **spec_kw), arrays


def _port_system(spec, arrays):
    """The same spec and tensors for the port (dense operators by
    convert.py, the rest as float64 tensors)."""
    names = {f.name for f in dataclasses.fields(tjoint.SystemSpec)}
    tspec = tjoint.SystemSpec(**{k: v for k, v in dataclasses.asdict(spec).items() if k in names})
    out = {}
    for k, v in arrays.items():
        if k in ("S", "S_fwd"):
            out[k] = tuple(convert.dense_kernel_from_numpy(np.asarray(op.S), device="cpu") for op in v)
        elif isinstance(v, tuple):
            out[k] = tuple(torch.tensor(np.asarray(a)) for a in v)
        else:
            out[k] = torch.tensor(np.asarray(v))
    return tspec, out


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-9, atol=1e-11, err_msg=what)


def _hold_fused(tout, jout, n):
    """Every output of the two fused solvers, rtol 1e-9 / atol 1e-11 (the
    bounds of tests/test_fused.py::test_fused_matches_host_loop)."""
    for a in range(2):
        for key in ("model", "admm_z", "admm_u", "final_d_calc"):
            _close(tout[key][a], jout[key][a], key)
    for key in ("rho_admm", "final_cost_data", "final_cost_model"):
        _close(tout[key], jout[key], key)
    assert set(tout["extras"]) == set(jout["extras"])
    for key, v in tout["extras"].items():
        _close(v, jout["extras"][key], key)
    tp, jp = tout["per_iteration"], jout["per_iteration"]
    for key in ("pre_cost_data", "pre_cost_model", "post_cost_data", "rho"):
        assert tuple(tp[key].shape) == np.asarray(jp[key]).shape == (n, 2)
        _close(tp[key], jp[key], key)
    np.testing.assert_array_equal(tp["lsqr_iters"].numpy(), np.asarray(jp["lsqr_iters"]))
    assert set(tp["costs"]) == set(jp["costs"])
    for key, v in tp["costs"].items():
        _close(v, jp["costs"][key], key)


def test_fused_solver_matches_jax():
    """3 majors of the fully coupled tiny system (cross-gradient,
    clustering, damping gradient, ADMM, wavelet): models, ADMM state, rho,
    every per-major row and the final costs."""
    spec, arrays = _jax_system()
    tspec, tarr = _port_system(spec, arrays)
    tout = tjoint.make_fused_solver(tspec, 3)(tarr)
    _hold_fused(tout, jjoint.make_fused_solver(spec, 3)(arrays), 3)
    assert tout["per_iteration"]["lsqr_iters"].tolist() == [spec.niter] * 3
    np.testing.assert_array_equal(tout["final_cost_data"].numpy(), tout["per_iteration"]["post_cost_data"][-1].numpy())


def test_fused_solver_masks_like_jax():
    """The masking test of tests/test_fused.py:99-140 in the port: 5 steps
    with active_steps = 2 equal 2 steps exactly (models, ADMM z and u, rho
    under a live adjustment, the final costs, the first two rows), and the
    masked rows ran 0 LSQR iterations."""
    spec, arrays = _jax_system(admm_weight_multiplier=10.0, admm_cost_threshold=1e6)
    tspec, tarr = _port_system(spec, arrays)
    out5 = tjoint.make_fused_solver(tspec, 5)(dict(tarr, active_steps=2))
    out2 = tjoint.make_fused_solver(tspec, 2)(tarr)
    for key in ("model", "admm_z", "admm_u"):
        for a in range(2):
            assert torch.equal(out5[key][a], out2[key][a]), key
    for key in ("rho_admm", "final_cost_data", "final_cost_model"):
        assert torch.equal(out5[key], out2[key]), key
    for key in ("pre_cost_data", "post_cost_data", "pre_cost_model", "rho", "lsqr_iters"):
        assert torch.equal(out5["per_iteration"][key][:2], out2["per_iteration"][key]), key
    assert out5["per_iteration"]["lsqr_iters"][2:].tolist() == [0, 0, 0]


def test_fused_solver_grows_rho():
    """The dynamic ADMM weight on the device: x10 a major when the data
    cost is under the threshold, so x100 over 2 majors."""
    spec, arrays = _jax_system(admm_weight_multiplier=10.0, admm_cost_threshold=1e6)
    tspec, tarr = _port_system(spec, arrays)
    out = tjoint.make_fused_solver(tspec, 2)(tarr)
    np.testing.assert_allclose(out["rho_admm"].numpy(), tarr["rho_admm"].numpy() * 100.0, rtol=1e-15)
    np.testing.assert_allclose(out["per_iteration"]["rho"][1].numpy(), tarr["rho_admm"].numpy() * 10.0, rtol=1e-15)


def test_fused_solver_with_a_refinement_forward_matches_jax():
    """refine_forward: the predicted data through S_fwd (a model-domain
    operator other than the solve's wavelet-domain S), against the JAX
    package's; the system without the two couplings, whose program JAX
    compiles faster."""
    spec, arrays = _jax_system(refine_forward=True, cross_grad=False, clustering=False)
    from tomofastx_tpu.ops.sparse_kernel import DenseKernel

    rng = np.random.default_rng(11)
    arrays["S_fwd"] = tuple(DenseKernel(jnp.asarray(rng.normal(size=(nd, spec.seg_size)))) for nd in spec.ndata_rows)
    tspec, tarr = _port_system(spec, arrays)
    tout = tjoint.make_fused_solver(tspec, 3)(tarr)
    _hold_fused(tout, jjoint.make_fused_solver(spec, 3)(arrays), 3)
    # The predicted data are S_fwd's, not S's.
    x = tout["model"][0] / tarr["cw"][0][None, :]
    d = tarr["S_fwd"][0].matvec(x.reshape(-1)).reshape(-1, 1) / spec.problem_weight[0] / tarr["data_weight"][0]
    torch.testing.assert_close(tout["final_d_calc"][0], d, rtol=1e-12, atol=1e-12)


def test_capture_unit_by_operator_and_device():
    """The CPU runs eager steps; a CUDA run captures a major unless an
    operator (of the solve or of the refinement forward) is a per-cell or
    lattice matrix-free one (sharded or not) whose tensors are not on the
    card (on the card their products are kernels B2 and B3), or spreads over
    several devices. Decided from the tensors' device and what the
    operators say of themselves (graph_capturable, mesh) alone (stand-ins
    here: no card is needed to decide)."""
    from types import SimpleNamespace

    from tomofastx_tpu_torch.ops import matrixfree as tmf

    spec, arrays = _jax_system()
    _, tarr = _port_system(spec, arrays)
    assert tjoint.capture_unit(tarr)[0] == "cpu"
    on_card = {"cw": (SimpleNamespace(device=torch.device("cuda")),)}
    one_card = SimpleNamespace(mesh=tmesh.Mesh(np.array([torch.device("cuda:0")] * 4, dtype=object), ("cells",)))
    two_cards = SimpleNamespace(mesh=tmesh.Mesh(np.array([torch.device("cuda:0"), torch.device("cuda:1")],
                                                         dtype=object), ("cells",)))

    def on(cls, device):
        op = object.__new__(cls)
        op.cw = SimpleNamespace(device=torch.device(device))
        return op

    def per_cell(device):
        return on(tmf.MatrixFreeKernel, device)

    def lattice(device):
        return on(tmf.LatticeMatrixFreeKernel, device)

    def sharded(cls, part, *devices):
        op = object.__new__(cls)
        op.parts, op.mesh = [part(d) for d in devices], one_card.mesh
        return op

    for ops, unit, said in (
        ({"S": (tarr["S"][0], one_card)}, "graph", "one CUDA graph a major"),
        ({"S": (lattice("cuda:0"),)}, "graph", "one CUDA graph a major"),
        ({"S": (lattice("cpu"),)}, "step", "LatticeMatrixFreeKernel"),
        ({"S": (tarr["S"][0],), "S_fwd": (per_cell("cuda:0"),)}, "graph", "one CUDA graph a major"),
        ({"S": (tarr["S"][0],), "S_fwd": (per_cell("cpu"),)}, "step", "MatrixFreeKernel"),
        ({"S": (sharded(tmf.ShardedLatticeMatrixFreeKernel, lattice, "cuda:0", "cuda:0"),)}, "graph",
         "one CUDA graph a major"),
        ({"S": (sharded(tmf.ShardedLatticeMatrixFreeKernel, lattice, "cuda:0", "cuda:1"),)}, "step",
         "ShardedLatticeMatrixFreeKernel"),
        ({"S": (sharded(tmf.ShardedMatrixFreeKernel, per_cell, "cuda:0", "cuda:0", "cuda:0", "cuda:0"),)}, "graph",
         "one CUDA graph a major"),
        ({"S": (sharded(tmf.ShardedMatrixFreeKernel, per_cell, "cuda:0", "cuda:1"),)}, "step",
         "ShardedMatrixFreeKernel"),
        ({"S": (two_cards,)}, "step", "over 2 devices"),
    ):
        got = tjoint.capture_unit({**on_card, **ops})
        assert got[0] == unit and said in got[1], got


# ------------------------------------------------------------ the workflow


def _majors(lines):
    return [f"inversion.nMajorIterations = {MAJORS}" if ln.startswith("inversion.nMajorIterations") else ln
            for ln in lines]


@pytest.fixture(scope="module")
def jax_fused(tmp_path_factory):
    """One JAX run with fused_chunk = 3 of each problem, writing its cache,
    made the first time a test asks for it: (tmp, its lines, the result,
    its output folder)."""
    runs = {}

    def get(name):
        if name not in runs:
            tmp = str(tmp_path_factory.mktemp(name))
            if name == "coupled":
                write_coupling_inputs(tmp)

                def lines(out, fmt="dense", tmp=tmp):
                    return _majors(joint_lines(tmp, "joint", out, fmt=fmt) + XGRAD + [ln.format(tmp=tmp) for ln in CLUSTER])
            else:
                make = {"grav": dict(nx=8, ny=8, nz=4, ndata=16, rho_mult=2.0, niter=6, fmt="dense"),
                        "bttb": dict(nx=8, ny=8, nz=4, ndata=64, wtype=0, niter=6, fmt="matrixfree"),
                        "refine": dict(nx=12, ny=8, nz=4, ndata=24, niter=8, fmt="tiled")}[name]
                base = _write_problem(tmp, make.pop("nx"), make.pop("ny"), make.pop("nz"), make.pop("ndata"), **make)
                extra = ["tpu.refineForward = 1"] if name == "refine" else []

                def lines(out, fmt=None, base=base, extra=extra):
                    got = _majors(base(out)) + extra
                    return [f"tpu.kernelFormat = {fmt}" if fmt and ln.startswith("tpu.kernelFormat") else ln
                            for ln in got]
            jout = f"{tmp}/jax"
            res = jsolve(jparse(lines(jout)), solve_dtype=jnp.float64, compute_dtype=jnp.float64, verbose=False,
                         fused_chunk=CHUNK)
            runs[name] = (tmp, lines, res, jout)
        return runs[name]

    return get


def _port_fused(lines, jout, out, fmt=None, mesh=None, cached=True, **kw):
    extra = ["sensit.readFromFiles = 1", f"sensit.folderPath = {jout}/SENSIT/"] if cached else []
    return twf.solve_problem_joint_gravmag(tparse(lines(out, fmt) + extra), solve_dtype=torch.float64,
                                           verbose=False, device="cpu", mesh=mesh, fused_chunk=CHUNK, **kw)


def _hold_workflows(rj, jout, rt, tout, niter, active=(0,)):
    """costs.txt rows rtol 1e-8 (pre-update costs, one row a major, then the
    final row), the final models to 1e-8 of their range, the post-update
    cost history, the checkpoint of major 4 and the chunks' LSQR
    iterations."""
    assert rt.timings["lsqr_iters"] == [niter] * MAJORS and len(rt.timings["solve_s"]) == 3
    cj, ct = _costs(os.path.join(jout, "costs.txt")), _costs(os.path.join(tout, "costs.txt"))
    assert len(cj) == len(ct) == MAJORS + 1
    for a, b in zip(cj, ct):
        np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-300)
    for i in active:
        mj, mt = rj.models[i].val, rt.models[i].val
        np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-8 * (mj.max() - mj.min()))
    np.testing.assert_allclose(rt.cost_data, rj.cost_data, rtol=1e-8, atol=1e-300)
    assert [h["iteration"] for h in rt.costs_history] == [h["iteration"] for h in rj.costs_history] == [1, 2, 3, 4, 5]
    for hj, ht in zip(rj.costs_history, rt.costs_history):
        np.testing.assert_allclose(ht["cost_data"], hj["cost_data"], rtol=1e-8, atol=1e-300)
    _same_checkpoint(os.path.join(jout, "checkpoint.npz"), os.path.join(tout, "checkpoint.npz"))
    with np.load(os.path.join(tout, "checkpoint.npz")) as z:
        assert int(z["it"]) == 4
    for it in (2, 4):
        assert os.path.exists(os.path.join(tout, "Paraview", f"grav_inter_{it}_model3D_full.vtk"))


@pytest.mark.parametrize("fmt", ["dense", "tiled", "packed", "tiled-4-slots"])
def test_fused_workflow_matches_jax(jax_fused, tmp_path, fmt):
    """The gravity problem (damping, 3-lithology ADMM with a rising weight)
    in each stored format and over 4 CPU slots, from the JAX run's cache."""
    tmp, lines, rj, jout = jax_fused("grav")
    mesh = tmesh.make_mesh(4, device="cpu") if fmt.endswith("slots") else None
    rt = _port_fused(lines, jout, str(tmp_path / "out"), fmt.split("-")[0], mesh=mesh)
    _hold_workflows(rj, jout, rt, str(tmp_path / "out"), 6)
    rows = _costs(str(tmp_path / "out" / "costs.txt"))
    assert rows[2][7] == 2.0 * rows[1][7]  # the ADMM weight rose on the device


def test_fused_bttb_workflow_matches_jax(jax_fused, tmp_path, capsys):
    """tpu.kernelFormat = matrixfree on a gridded survey: the BTTB operator
    inside the fused loop of both packages."""
    tmp, lines, rj, jout = jax_fused("bttb")
    capsys.readouterr()
    out = str(tmp_path / "out")
    rt = twf.solve_problem_joint_gravmag(tparse(lines(out)), solve_dtype=torch.float64, device="cpu",
                                         fused_chunk=CHUNK)
    said = capsys.readouterr().out
    assert "grav kernel: matrix-free (BTTBKernel" in said and "fused major loop: chunks of up to 3 majors" in said
    _hold_workflows(rj, jout, rt, out, 6)


def test_fused_coupled_workflow_matches_jax(jax_fused, tmp_path):
    """The joint problem coupled by the cross-gradient and the clustering
    (tests/test_torch_coupled.py), tiled from the JAX run's cache, with the
    coupling fields written."""
    tmp, lines, rj, jout = jax_fused("coupled")
    out = str(tmp_path / "out")
    rt = _port_fused(lines, jout, out, "tiled")
    _hold_workflows(rj, jout, rt, out, 8, active=(0, 1))
    rows = _costs(os.path.join(out, "costs.txt"))[1:-1]
    assert all(row[c - 1] > 0.0 for row in rows for c in (16, 17, 18, 19, 20))
    for field in ("cross_grad", "clustering"):
        assert os.path.exists(os.path.join(out, "Paraview", f"{field}_final_model3D_full.vtk"))


def test_fused_refinement_workflow_matches_jax(jax_fused, tmp_path):
    """tpu.refineForward: the tiled kernel under LSQR, the predicted data of
    every major by the exact-physics operator, inside the fused loop."""
    tmp, lines, rj, jout = jax_fused("refine")
    out = str(tmp_path / "out")
    rt = _port_fused(lines, jout, out)
    _hold_workflows(rj, jout, rt, out, 8)
    np.testing.assert_allclose(rt.data[0].val_calc, rj.data[0].val_calc, rtol=1e-8)


def test_fused_workflow_stops_at_a_chunk_end(jax_fused, tmp_path, monkeypatch):
    """A stop file that appears during the first chunk is seen at its end:
    2 majors run, their rows and the checkpoint of major 2 are written, and
    the models are those of the uninterrupted run's first chunk."""
    tmp, lines, _, jout = jax_fused("grav")
    out = str(tmp_path / "out")
    call = tjoint.FusedSolver.__call__

    def call_then_stop(self, arrays):
        res = call(self, arrays)
        open(os.path.join(out, "stop"), "w").close()
        return res

    monkeypatch.setattr(tjoint.FusedSolver, "__call__", call_then_stop)
    rt = _port_fused(lines, jout, out, "tiled")
    assert rt.timings["lsqr_iters"] == [6, 6] and [h["iteration"] for h in rt.costs_history] == [1, 2]
    assert [r[0] for r in _costs(os.path.join(out, "costs.txt"))] == [0, 1, MAJORS]
    with np.load(os.path.join(out, "checkpoint.npz")) as z:
        assert int(z["it"]) == 2


def test_fused_resume_equals_the_uninterrupted_run(jax_fused, tmp_path):
    """A fused run of 2 majors (its checkpoint after major 2), resumed to 5
    with --fused: the final model, the checkpoint of major 4 and costs.txt's
    rows equal the uninterrupted fused run's to the last bit."""
    tmp, lines, _, jout = jax_fused("grav")
    full, res = str(tmp_path / "full"), str(tmp_path / "res")
    ref = _port_fused(lines, jout, full, "tiled")

    def two(out, fmt=None):
        return [ln.replace(f"nMajorIterations = {MAJORS}", "nMajorIterations = 2") for ln in lines(out, fmt)]

    _port_fused(two, jout, res, "tiled")
    resumed = _port_fused(lines, jout, res, "tiled", resume=True)
    assert resumed.timings["lsqr_iters"] == [6] * 3 and [h["iteration"] for h in resumed.costs_history] == [3, 4, 5]
    assert np.array_equal(resumed.models[0].val, ref.models[0].val)
    _same_checkpoint(os.path.join(full, "checkpoint.npz"), os.path.join(res, "checkpoint.npz"), tol=0.0)
    cf, cr = _costs(os.path.join(full, "costs.txt")), _costs(os.path.join(res, "costs.txt"))
    assert [r[0] for r in cr] == [0, 1, 2, 2, 3, 4, 5]
    for a, b in zip(cf, cr[:2] + cr[3:]):
        np.testing.assert_array_equal(b, a)


class _FirstCall(Exception):
    """Carries a fused solver and the tensors of its first call out of a
    workflow, which it ends there."""


class _Counted:
    """An operator whose products add to calls[<name>.matvec] and
    calls[<name>.rmatvec]; anything else it is asked for is the operator's."""

    def __init__(self, op, name, calls):
        self._op, self._name, self._calls = op, name, calls

    def __getattr__(self, attr):
        return getattr(self._op, attr)

    def matvec(self, x):
        self._calls[f"{self._name}.matvec"] += 1
        return self._op.matvec(x)

    def rmatvec(self, u):
        self._calls[f"{self._name}.rmatvec"] += 1
        return self._op.rmatvec(u)


@pytest.mark.parametrize("name", ["grav", "coupled", "refine64"])
def test_capture_warm_up_runs_one_lsqr_iteration(jax_fused, tmp_path, monkeypatch, name):
    """FusedSolver._warm_up, the eager step before a capture, on the
    tensors of a workflow's first fused call (the gravity problem tiled,
    the coupled joint problem tiled, refineForward with a float64 forward):
    it runs its LSQR for exactly one iteration (capture_warmup_iters), so
    each product, constraint block and wavelet transform runs its head's,
    one body iteration's and its tail's times, the split form's parts; the
    unrolled step runs the same parts with niter body iterations, so the
    warm-up touches every product, block and transform that it does; the
    solver's carry and input tensors are left as they were to the last bit."""
    tmp, lines, _, jout = jax_fused("refine" if name == "refine64" else name)
    fmt = {"grav": "tiled", "coupled": "tiled", "refine64": None}[name]
    extra = ["tpu.refineForwardPrecision = double"] if name == "refine64" else []

    def first_call(self, arrays):
        raise _FirstCall(self, dict(arrays))

    with monkeypatch.context() as m:
        m.setattr(tjoint.FusedSolver, "__call__", first_call)
        with pytest.raises(_FirstCall) as got:
            _port_fused(lambda out, fmt=None: lines(out, fmt) + extra, jout, str(tmp_path / "out"), fmt)
    solver, arrays = got.value.args
    spec = solver.spec

    calls = collections.Counter()
    arrays.pop("active_steps")
    for key in ("S", "S_fwd"):
        if key in arrays:
            arrays[key] = tuple(_Counted(op, f"{key}{a}", calls) for a, op in enumerate(arrays[key]))
    static = {k: v for k, v in arrays.items() if k not in tjoint.CARRY_KEYS}
    carry = solver._init_carry({**static, **{k: arrays[k] for k in tjoint.CARRY_KEYS}})
    before = [t.clone() for t in tjoint._leaves((static, carry)) if isinstance(t, torch.Tensor)]

    def counted(mark):
        calls[mark] += 1
        return contextlib.nullcontext()

    monkeypatch.setattr(tjoint, "fine", counted)
    s, n_active = torch.tensor(0), torch.tensor(solver.n_steps)

    def step(loop=None):
        calls.clear()
        solver._step(static, tjoint.tree_map(torch.clone, carry), s, n_active, lsqr_loop=loop)
        return collections.Counter(calls)

    # The split form's parts: the calls before its loop, in one iteration, after it.
    marks = []

    def parts(loop):
        marks.append(collections.Counter(calls))
        loop.iterate()
        marks.append(collections.Counter(calls))

    total = step(parts)
    head, body, tail = marks[0], marks[1] - marks[0], total - marks[1]
    unrolled = step()
    assert unrolled == head + collections.Counter({k: spec.niter * v for k, v in body.items()}) + tail

    trace.counters.clear()
    calls.clear()
    solver._warm_up(static, carry)
    assert trace.counters == {"capture_warmup_iters": 1}
    assert calls == head + body + tail
    assert set(calls) == set(unrolled)
    assert body["S0.matvec"] == body["S0.rmatvec"] == head["S0.rmatvec"] == 1
    if name == "coupled":
        assert {"block.cross_gradient.matvec", "block.clustering.rmatvec", "S1.matvec"} <= set(body)
    if name == "refine64":
        assert tail["S_fwd0.matvec"] == 1 and "S_fwd0.matvec" not in body
    after = [t for t in tjoint._leaves((static, carry)) if isinstance(t, torch.Tensor)]
    assert len(after) == len(before) and all(torch.equal(a, b) for a, b in zip(after, before))


def test_fused_debug_nans_stops_at_the_chunk_end(tmp_path):
    """--debug-nans with --fused: observed data that hold a NaN (read from
    the file) make the first chunk's costs non-finite, and the run stops
    with FloatingPointError at that chunk's end, before writing its rows."""
    tmp = str(tmp_path)
    lines = _write_problem(tmp, 8, 8, 4, 16, niter=6)
    with open(f"{tmp}/data.txt") as f:
        rows = f.read().splitlines()
    rows[3] = " ".join(rows[3].split()[:3] + ["nan"])
    with open(f"{tmp}/data_nan.txt", "w") as f:
        f.write("\n".join(rows) + "\n")
    cfg = tparse([ln.replace(f"{tmp}/data.txt", f"{tmp}/data_nan.txt").replace(
        "useSyntheticModelForDataValues = 1", "useSyntheticModelForDataValues = 0") for ln in _majors(lines(f"{tmp}/out"))])
    with pytest.raises(FloatingPointError, match="non-finite values in the .* of major iteration 1"):
        twf.solve_problem_joint_gravmag(cfg, solve_dtype=torch.float64, verbose=False, device="cpu",
                                        fused_chunk=CHUNK, debug_nans=True)
    assert _costs(f"{tmp}/out/costs.txt") == []


def test_fused_workflow_equals_the_host_driven_loop(jax_fused, tmp_path):
    """In float64 on the CPU the fused chunks and the host-driven loop do the
    same operations in the same order: the port's two runs of one Parfile
    (ADMM weight rising) give the same costs.txt and final model to the last
    bit."""
    tmp, lines, _, jout = jax_fused("grav")
    extra = ["sensit.readFromFiles = 1", f"sensit.folderPath = {jout}/SENSIT/"]
    host = twf.solve_problem_joint_gravmag(tparse(lines(str(tmp_path / "host"), "tiled") + extra),
                                           solve_dtype=torch.float64, verbose=False, device="cpu")
    fused = _port_fused(lines, jout, str(tmp_path / "fused"), "tiled")
    assert np.array_equal(fused.models[0].val, host.models[0].val)
    with open(tmp_path / "host" / "costs.txt", "rb") as a, open(tmp_path / "fused" / "costs.txt", "rb") as b:
        assert a.read() == b.read()
