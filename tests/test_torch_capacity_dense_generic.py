"""The million-cell rungs (1m, 1m_f64, 1m_f32quad: scripts/run_million_cell.py
under its three builds) and the generic 4M rung (scripts/probe_generic_4m.py)
of scripts/run_capacity_torch.py on the CPU: each small rung solved by the
port (float64) and by the JAX package's solve_problem_joint_gravmag on the
same fixtures, and what the rung's record says. The fixtures themselves are
held byte for byte against the JAX scripts' by tests/test_torch_capacity.py,
whose helpers this file shares; it is a file of its own so that its solves
get a worker of their own."""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tomofastx_tpu.config.parfile as jparfile
import tomofastx_tpu.inversion.workflow as jworkflow
from test_torch_capacity import COST_RTOL, MODEL_TOL, PARITY_MINORS, _with_minors, cap, port_kernels_in_jax

RUNGS = ("1m", "1m_f64", "1m_f32quad", "generic4m")
# The float32 builds (mixed, compensated): the JAX solve takes the port's
# kernel (port_kernels_in_jax). The float64 build and the matrix-free rung
# are each package's own.
HANDED = ("1m", "1m_f32quad")
JAX_DTYPES = {torch.float32: jnp.float32, torch.float64: jnp.float64}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Each rung's small fixture solved by both packages in float64,
    PARITY_MINORS LSQR iterations a major, and the port's record (the 1m
    rung's with the script's matrix-free section, which reads only the grid
    and survey the three builds share): {rung: (JAX result, port result, port
    record, fixture)}. The port's solves run on one CPU thread: their
    per-cell float64 products are a long run of large elementwise
    operations, and with a thread a core they crowd the other test workers
    out (six heavy test files side by side: 768 s on a thread a core, 533 s
    on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {rung: _both_packages(tmp_path_factory, rung) for rung in RUNGS}
    finally:
        torch.set_num_threads(threads)


def _both_packages(tmp_path_factory, rung):
    """One rung of the `both` fixture."""
    work = str(tmp_path_factory.mktemp(rung))
    fx = cap.write_fixture(rung, work, small=True)
    fx.lines = _with_minors(fx.lines, PARITY_MINORS)
    jkw = {k: JAX_DTYPES.get(v, v) for k, v in fx.solve_kw.items()}
    with port_kernels_in_jax() if rung in HANDED else contextlib.nullcontext() as built:
        tres, log, wall, peak = cap.solve(fx, device="cpu", solve_dtype=torch.float64, verbose=False)
        jres = jworkflow.solve_problem_joint_gravmag(
            jparfile.parse_parfile_lines([ln.replace(f"{work}/out/", f"{work}/jax_out/") for ln in fx.lines]),
            base_dir=work, verbose=False, solve_dtype=jnp.float64, **jkw)
        assert not built
    rec = cap.record(fx, tres, log, wall, peak, "cpu")
    if rung == "1m":
        rec.update(cap.matrixfree_per_iteration(fx, "cpu"))
    return jres, tres, rec, fx


@pytest.mark.parametrize("rung", RUNGS)
def test_small_rung_matches_jax(both, rung):
    """Every major's data cost, the final costs and the final model at
    COST_RTOL and MODEL_TOL of its range; the record's costs are the run's
    and fall."""
    jres, tres, rec, fx = both[rung]
    assert tres.timings["lsqr_iters"] == [PARITY_MINORS] * fx.depth[0]
    assert len(tres.costs_history) == len(jres.costs_history) == fx.depth[0]
    for hj, ht in zip(jres.costs_history, tres.costs_history):
        np.testing.assert_allclose(ht["cost_data"][0], hj["cost_data"][0], rtol=COST_RTOL)
    np.testing.assert_allclose(tres.cost_data, jres.cost_data, rtol=COST_RTOL, atol=1e-300)
    mj, mt = np.asarray(jres.models[0].val), tres.models[0].val
    np.testing.assert_allclose(mt, mj, rtol=0, atol=MODEL_TOL * (mj.max() - mj.min()))
    assert rec["cost_falls"] and rec["majors"] == fx.depth[0] and rec["ncells"] == fx.ncells
    assert rec["cost_history_grav"] == [h["cost_data"][0] for h in tres.costs_history]


def test_record_names_the_operator_and_loop(both):
    """The 1m records: the dense kernel in the fused loop, the build by the
    JAX script's name, the cache's seconds and its bytes on disk (the
    predicted ones and the meta text file), and the matrix-free section
    through the lattice operator; the generic4m record: the per-cell
    operator, host-driven, its blend off in float64 (so no near lists) and
    the note on the JAX record."""
    for rung in HANDED + ("1m_f64",):
        rec = both[rung][2]
        assert rec["operator"] == ["grav kernel: dense (400, 16384) torch.float64, 52.4 MB"], rung
        assert rec["loop"][0].startswith("fused major loop"), rung
        assert rec["build"] == cap.MC_BUILDS[cap.RUNGS[rung].build][0]
        assert rec["cache_write_s"] > 0
        meta = len(" 32 32 16 400\n 1 4 1\n 0 0.000000000E+00\n 1 1\n 6553600\n")
        assert rec["cache_bytes"] == cap.sensit_cache_bytes(rung, small=True) + meta, rung
    rec = both["1m"][2]
    assert rec["matrixfree_operator"] == "LatticeMatrixFreeKernel" and rec["matrixfree_lsqr_iters"] == 3
    assert rec["matrixfree_s_per_iter"] > 0 and rec["matrixfree_matvec_s"] > 0 and rec["matrixfree_rmatvec_s"] > 0
    rec = both["generic4m"][2]
    assert rec["operator"][0].startswith("grav kernel: matrix-free (MatrixFreeKernel, no row storage")
    assert rec["loop"] == ["host-driven"] and rec["far_field_blend"] is False and rec["near_lists"] is None
    assert rec["partial_nbytes"] is None and "GENERIC_4M_PROBE.json" in rec["jax_record"]
