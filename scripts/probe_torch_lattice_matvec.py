#!/usr/bin/env python3
"""Kernel B3's near passes (csrc/lattice_matvec.cu) against an earlier
source's, in turns on one card: what storing the near rows buys.

    python3 scripts/probe_torch_lattice_matvec.py --parent-dir DIR [--shape smoke|4m]

DIR holds an earlier lattice_matvec.cu and prism_common.cuh (for instance
from `git show <commit>:tomofastx_tpu_torch/csrc/...`) whose near passes
evaluate every near cell's closed forms in each call over the operator's
near lists (near_ptr, near_cells by observation; near_tptr, near_obs by
cell), with that source's entry points: lattice_near_matvec(family, nmc,
ndc, xe, ye, ze, xd, yd, zd, ptr, idx, vin, out, nx, ny, nz, nrows, m0, m1,
m2, s4pi, stream) and lattice_near_rmatvec alike. Both sources are built
with nvcc -Xptxas -v into build/, at once.

--shape smoke: the float32 blend of chip_smoke.py's draped survey at 4096 x
262144 (g_z) and on its first 512 observations (FTG-6, TMI); --shape 4m:
the 4m rung of scripts/run_capacity_torch.py (2032 x 4,000,000 cells, g_z),
its fixtures written into a temporary folder.

For each operator: its stored near rows (pairs, bytes, the lanes of a
segment) and their build's milliseconds (CUDA events, median of 3); then
each near pass of the parent and of this source timed in the order parent,
as is, as is, parent: on the card alone (a CUDA graph of 20 calls, median
of 5 replays) and one call a pair of events (median of 10, the wrapper's
host time in); each output against this source's, as the largest
difference of max|y|. Needs one CUDA device and nvcc."""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402
from tomofastx_tpu_torch.ops import _cuda_build  # noqa: E402
from tomofastx_tpu_torch.ops import lattice_matvec as lm  # noqa: E402

CSRC = os.path.join(REPO, "tomofastx_tpu_torch", "csrc")
# The earlier near passes' entry points: family, nmc, ndc; the three edges,
# three coordinates, the list's offsets and entries, the input, the output;
# nx, ny, nz, nrows; the field; the stream.
PARENT_NEAR_ARGTYPES = (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 4 + (
    ctypes.c_double,) * 4 + (ctypes.c_void_p,)


def read_sources(directory, names):
    """{name: text} of the files `names` in `directory`."""
    out = {}
    for name in names:
        with open(os.path.join(directory, name)) as f:
            out[name] = f.read()
    return out


def registers(log, kernels):
    """{kernel: {family: registers}} (chip_smoke.kernel_registers) from
    ptxas' log."""
    return smoke.kernel_registers(kernels, smoke.ptxas_registers(log))


def build(files, main, out_dir, entries):
    """nvcc `main` of `files` ({name: text}) in a directory of its own with
    -Xptxas -v; (ctypes handle with `entries` declared as {name: argtypes},
    the compiler's log)."""
    d = tempfile.mkdtemp(dir=out_dir)
    for fname, text in files.items():
        with open(os.path.join(d, fname), "w") as f:
            f.write(text)
    lib = os.path.join(d, "libvariant.so")
    proc = subprocess.run([_cuda_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", lib, os.path.join(d, main)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {d}:\n{proc.stderr[-3000:]}")
    handle = ctypes.CDLL(lib)
    for fn, argtypes in entries.items():
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = ctypes.c_int
    return handle, proc.stdout + proc.stderr


def time_near_passes(name, op, passes, vecs):
    """The operator's stored rows and build, then each near pass of
    `passes` ({variant: {f: fn(op, v)}}, "parent" and "as is") timed in
    turns; printed."""
    pairs = op.near_rval.shape[0]
    build_ms = smoke.time_cuda(op.with_near_rows, warm=1, reps=3)
    print(f"{name}: {pairs:,} near pairs stored in {op.near_rows_nbytes / 1e6:.2f} MB, lanes {op.near_lanes}; "
          f"build {build_ms:.3f} ms (median of 3)", flush=True)
    order = ["parent", "as is", "as is", "parent"]
    for f in ("matvec", "rmatvec"):
        v = vecs[f]
        ref = passes["as is"][f](op, v)
        graph, eager, apart = {}, {}, {}
        for variant in order:
            fn = passes[variant][f]
            got = fn(op, v)
            apart[variant] = float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300))
            graph.setdefault(variant, []).append(smoke.time_graph(lambda: fn(op, v), calls=20, reps=5))
            eager.setdefault(variant, []).append(smoke.time_cuda(lambda: fn(op, v), warm=2, reps=10))
        for variant in ("parent", "as is"):
            print(f"  {name} near {f} {variant}: on the card {', '.join(f'{t:.4f}' for t in graph[variant])} ms, "
                  f"one call a pair {', '.join(f'{t:.4f}' for t in eager[variant])} ms; against as is "
                  f"{apart[variant]:.2e} of max|y|", flush=True)


def parent_passes(lib):
    """The parent library's near passes as fn(op, v) over op's near lists."""

    def call(entry, lists, shape):
        def fn(op, v):
            plan = lm.launch_plan(op)
            out = torch.empty(shape(op), dtype=torch.float64, device=v.device)
            _cuda_build.check(entry, getattr(lib, entry)(
                plan["family"], plan["nmc"], plan["ndc"],
                *(a.data_ptr() for a in (op.xe, op.ye, op.ze, op.xd, op.yd, op.zd, *lists(op), v, out)),
                op.nx, op.ny, op.nz, op.xd.shape[0], *plan["magv"], plan["s4pi"],
                torch.cuda.current_stream().cuda_stream))
            return out
        return fn

    return {"matvec": call("lattice_near_matvec", lambda op: (op.near_ptr, op.near_cells),
                           lambda op: (op.xd.shape[0], op.ndc)),
            "rmatvec": call("lattice_near_rmatvec", lambda op: (op.near_tptr, op.near_obs),
                            lambda op: (op.nmc, op.N))}


def capacity_operator(rung, work):
    """The float32 matrix-free operator of scripts/run_capacity_torch.py's
    rung `rung` on the card, its fixtures written into `work` (as that
    script's matrixfree_per_iteration builds it)."""
    from tomofastx_tpu_torch.config.parfile import parse_parfile_lines
    from tomofastx_tpu_torch.io import data_io, model_io
    from tomofastx_tpu_torch.ops import sensitivity as sens
    from tomofastx_tpu_torch.ops.matrixfree import make_matrixfree_kernel

    fx = smoke.capacity_script().write_fixture(rung, work)
    par = parse_parfile_lines(fx.lines).grav
    grid = model_io.read_model_grid(f"{fx.work}/grid.txt", *fx.size)
    data = data_io.read_data_points(f"{fx.work}/data.txt", fx.ndata, 1, grid_only=True)
    cw = sens.calculate_depth_weight(par, grid, data, torch.float32, "cuda")
    return make_matrixfree_kernel(par, grid, data, cw, 1.0, data.weight, torch.float32, validate=False, device="cuda")


def vectors(op, nmc, ndc, g):
    return {"matvec": torch.randn((nmc, op.N), generator=g, dtype=torch.float64).to("cuda", torch.float32),
            "rmatvec": torch.randn((op.xd.shape[0], ndc), generator=g, dtype=torch.float64).to("cuda", torch.float32)}


def lattice_operators(work, shape):
    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.io import data_io, model_io
    from tomofastx_tpu_torch.ops.matrixfree import make_matrixfree_kernel

    if shape != "smoke":
        return {f"g_z, capacity {shape}": capacity_operator(shape, work)}
    inputs = smoke.write_inputs(work, smoke.NX, smoke.NY, smoke.NZ, smoke.SIDE, variants=("draped",))
    draped = dict(inputs, data=inputs["data_draped"])
    pf = smoke.write_parfile(work, "Parfile.txt", draped, os.path.join(work, "out"), smoke.N_MINOR, fmt="matrixfree",
                             compression=0)
    par = read_parfile(pf).grav
    grid = model_io.read_model_grid(draped["grid"], smoke.NX, smoke.NY, smoke.NZ)
    data = data_io.read_data_points(draped["data"], smoke.NDATA, 1, grid_only=True)
    ops = {"g_z": make_matrixfree_kernel(par, grid, data, np.ones(grid.nelements_total), 1.0,
                                         np.ones((smoke.NDATA, 1)), torch.float32)}
    cut = slice(0, smoke.B2_ROW_CUT)
    for case in ("FTG-6", "TMI"):
        ops[case] = smoke.b3_operator(case, grid, data.X[cut], data.Y[cut], data.Z[cut], torch.float32)
    return ops


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-dir", required=True, help="a directory holding an earlier lattice_matvec.cu and "
                    "prism_common.cuh")
    ap.add_argument("--shape", default="smoke", choices=("smoke", "4m"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(smoke.nvidia_smi_line(), flush=True)
    out_dir = os.path.join(REPO, "build", "lattice_variants")
    os.makedirs(out_dir, exist_ok=True)
    names = ("lattice_matvec.cu", "prism_common.cuh")
    parent_entries = {"lattice_near_matvec": PARENT_NEAR_ARGTYPES, "lattice_near_rmatvec": PARENT_NEAR_ARGTYPES}
    with ThreadPoolExecutor(2) as pool:
        parent_job = pool.submit(build, read_sources(args.parent_dir, names), names[0], out_dir, parent_entries)
        as_is = pool.submit(lm.build_library)
        parent, log = parent_job.result()
        as_is.result()
    print("parent registers: " + "; ".join(f"{k} " + ", ".join(f"{fam} {r}" for fam, r in v.items()) for k, v in
                                          registers(log, [("lattice_near_matvec_kernel", False),
                                                          ("lattice_near_rmatvec_kernel", False)]).items()), flush=True)
    passes = {"parent": parent_passes(parent),
              "as is": {"matvec": lm.lattice_near_matvec, "rmatvec": lm.lattice_near_rmatvec}}
    work = tempfile.mkdtemp()
    try:
        g = torch.Generator(device="cpu").manual_seed(37)
        for name, op in lattice_operators(work, args.shape).items():
            time_near_passes(name, op, passes, vectors(op, op.nmc, op.ndc, g))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
