#!/usr/bin/env python3
"""Kernel B2's near passes (csrc/prism_matvec_f32.cu) against an earlier
source's, in turns on one card: what storing the near rows buys.

    python3 scripts/probe_torch_prism_matvec.py --parent-dir DIR [--shape smoke|generic4m]

DIR holds an earlier prism_matvec_f32.cu, prism_matvec.cuh and
prism_common.cuh (for instance from `git show <commit>:tomofastx_tpu_torch/
csrc/...`) whose near passes evaluate every near pair's closed forms in each
call over the operator's near candidates (near_idx by observation; near_tptr,
near_obs by cell), with that source's entry points: prism_near_matvec(family,
nmc, ndc, handle_inside, X1, X2, Y1, Y2, Z1, Z2, xd, yd, zd, idx, obs, vin,
out, N, nrows, K, cell_lo, m0, m1, m2, s4pi, stream) and prism_near_rmatvec
alike. Both sources are built with nvcc -Xptxas -v into build/, at once.

--shape smoke: the float32 blend of chip_smoke.py's topography grid at 4096 x
262144 (g_z) and on its first 512 observations (FTG-6, TMI); --shape
generic4m: the generic4m rung of scripts/run_capacity_torch.py (2032 x
4,000,000 cells whose x edges grow and shear, g_z), its fixtures written into
a temporary folder.

For each operator, as scripts/probe_torch_lattice_matvec.py: its stored near
rows and their build's milliseconds, then each near pass of the parent and of
this source timed in the order parent, as is, as is, parent, on the card
alone and one call a pair of events, each output against this source's.
Needs one CUDA device and nvcc."""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import chip_smoke as smoke  # noqa: E402
from probe_torch_lattice_matvec import (  # noqa: E402
    build, capacity_operator, read_sources, registers, time_near_passes, vectors)
from tomofastx_tpu_torch.ops import _cuda_build  # noqa: E402
from tomofastx_tpu_torch.ops import prism_matvec as pm  # noqa: E402

# The earlier near passes' entry points: family, nmc, ndc, handle_inside; the
# six bounds, three coordinates, the candidates (near_idx, or the transposed
# offsets and observations), the input, the output; N, nrows, K, cell_lo;
# the field; the stream.
PARENT_NEAR_ARGTYPES = (ctypes.c_int,) * 4 + (ctypes.c_void_p,) * 13 + (ctypes.c_int,) * 4 + (
    ctypes.c_double,) * 4 + (ctypes.c_void_p,)


def parent_passes(lib):
    """The parent library's near passes as fn(op, v) over op's candidates."""

    def call(entry, lists, shape):
        def fn(op, v):
            plan = pm.launch_plan(op)
            out = torch.empty(shape(op), dtype=torch.float64, device=v.device)
            idx, obs = lists(op)
            _cuda_build.check(entry, getattr(lib, entry)(
                plan["family"], plan["nmc"], plan["ndc"], plan["handle_inside"],
                *(a.data_ptr() for a in (*op.grid6, op.xd, op.yd, op.zd, idx)),
                None if obs is None else obs.data_ptr(), v.data_ptr(), out.data_ptr(), op.N, op.xd.shape[0],
                op.near_idx.shape[1], op.cell_lo, *plan["magv"], plan["s4pi"],
                torch.cuda.current_stream().cuda_stream))
            return out
        return fn

    return {"matvec": call("prism_near_matvec", lambda op: (op.near_idx, None),
                           lambda op: (op.xd.shape[0], op.phys.ndc)),
            "rmatvec": call("prism_near_rmatvec", lambda op: (op.near_tptr, op.near_obs),
                            lambda op: (op.phys.nmc, op.N))}


def operators(work, shape):
    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.io import data_io, model_io
    from tomofastx_tpu_torch.ops.matrixfree import MatrixFreeKernel, make_matrixfree_kernel

    if shape != "smoke":
        return {f"g_z, capacity {shape}": capacity_operator(shape, work)}
    inputs = smoke.write_inputs(work, smoke.NX, smoke.NY, smoke.NZ, smoke.SIDE, variants=("topography",))
    topo = dict(inputs, grid=inputs["grid_topo"])
    pf = smoke.write_parfile(work, "Parfile.txt", topo, os.path.join(work, "out"), smoke.N_MINOR, fmt="matrixfree",
                             compression=0)
    par = read_parfile(pf).grav
    grid = model_io.read_model_grid(topo["grid"], smoke.NX, smoke.NY, smoke.NZ)
    data = data_io.read_data_points(topo["data"], smoke.NDATA, 1, grid_only=True)
    ops = {"g_z": make_matrixfree_kernel(par, grid, data, np.ones(grid.nelements_total), 1.0,
                                         np.ones((smoke.NDATA, 1)), torch.float32)}
    if not isinstance(ops["g_z"], MatrixFreeKernel):
        raise SystemExit(f"{type(ops['g_z']).__name__} built, not the per-cell operator")
    cut = slice(0, smoke.B2_ROW_CUT)
    for case in ("FTG-6", "TMI"):
        ops[case] = smoke.b2_operator(case, grid, data.X[cut], data.Y[cut], data.Z[cut], torch.float32)
    return ops


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-dir", required=True, help="a directory holding an earlier prism_matvec_f32.cu, "
                    "prism_matvec.cuh and prism_common.cuh")
    ap.add_argument("--shape", default="smoke", choices=("smoke", "generic4m"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(smoke.nvidia_smi_line(), flush=True)
    out_dir = os.path.join(REPO, "build", "prism_variants")
    os.makedirs(out_dir, exist_ok=True)
    names = ("prism_matvec_f32.cu", "prism_matvec.cuh", "prism_common.cuh")
    parent_entries = {"prism_near_matvec": PARENT_NEAR_ARGTYPES, "prism_near_rmatvec": PARENT_NEAR_ARGTYPES}
    with ThreadPoolExecutor(2) as pool:
        parent_job = pool.submit(build, read_sources(args.parent_dir, names), names[0], out_dir, parent_entries)
        as_is = pool.submit(pm.build_library, pm.SOURCES[0])
        parent, log = parent_job.result()
        as_is.result()
    print("parent registers: " + "; ".join(f"{k} " + ", ".join(f"{fam} {r}" for fam, r in v.items()) for k, v in
                                          registers(log, [("prism_near_matvec_kernel", False),
                                                          ("prism_near_rmatvec_kernel", False)]).items()), flush=True)
    passes = {"parent": parent_passes(parent),
              "as is": {"matvec": pm.prism_near_matvec, "rmatvec": pm.prism_near_rmatvec}}
    work = tempfile.mkdtemp()
    try:
        g = torch.Generator(device="cpu").manual_seed(37)
        for name, op in operators(work, args.shape).items():
            time_near_passes(name, op, passes, vectors(op, op.phys.nmc, op.phys.ndc, g))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
