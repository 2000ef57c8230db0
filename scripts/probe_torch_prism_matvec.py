#!/usr/bin/env python3
"""Kernel B2 (csrc/prism_matvec.cuh, its float32 source prism_matvec_f32.cu)
at the smoke shape of chip_smoke.py against variants of its own source, in
turns on one card: what its blend's time is made of.

    python3 scripts/probe_torch_prism_matvec.py [--parent-dir DIR]

Variants, each built with nvcc -Xptxas -v into build/, all at once:
- "as is";
- "no near pass": the near-pass entry points return without launching (the
  matvec's near split is never written, the rmatvec's sums start from
  whatever its buffer holds). A timing of the main loops alone: their
  products are not the operator's;
- "far test first": the matvec's main loop, too, tests a pair with is_far
  before its 27-point rule and skips the rule where near (a branch in place
  of its select; the rmatvec's main loop takes the branch as is);
- with --parent-dir, an earlier prism_matvec.cu and prism_common.cuh copied
  into DIR, whose blend evaluates the near pairs in its main loop (the
  wrappers skip the near pass for it): "parent", and "parent, no near
  branch", where every pair takes the 27-point rule (a timing of that main
  loop alone).

For each: ptxas' registers of the float32 blend's kernels of g_z, FTG-6 and
TMI (and of the near passes where the source has them), and the
milliseconds (CUDA events, median of 10) of the float32 blend's matvec and
rmatvec at 4096 x 262144 (g_z, the topography grid of chip_smoke.py's phase
21) and on its first 512 observations (FTG-6, TMI), every variant timed
twice in the order v1 .. vn, vn .. v1; its outputs against "as is", with the
largest difference in float32 units in the last place. Needs one CUDA device
and nvcc."""

from __future__ import annotations

import argparse
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
from probe_torch_lattice_matvec import CSRC, build, registers, time_variants  # noqa: E402
from tomofastx_tpu_torch.ops import prism_matvec as pm  # noqa: E402

NEAR_ENTRIES = ('extern "C" int prism_near_matvec(PRISM_NEAR_ARGS) {',
                'extern "C" int prism_near_rmatvec(PRISM_NEAR_ARGS) {')
PARENT_NEAR_BRANCH = "        if (is_far(c, xo, yo, zo)) {"
# pair_row's 27-point rule and select (the matvec's), and the same with the far test first.
SELECT = """        quad_row<FAM, NMC, NDC>(c, xo, yo, zo, f, row);
        const bool far = is_far(c, xo, yo, zo);
#pragma unroll
        for (int k = 0; k < NMC; ++k)
#pragma unroll
            for (int j = 0; j < NDC; ++j) row[k][j] = far ? row[k][j] : T(0);"""
FAR_FIRST = """        if (is_far(c, xo, yo, zo)) {
            quad_row<FAM, NMC, NDC>(c, xo, yo, zo, f, row);
        } else {
#pragma unroll
            for (int k = 0; k < NMC; ++k)
#pragma unroll
                for (int j = 0; j < NDC; ++j) row[k][j] = T(0);
        }"""


def variant_sources(parent_dir):
    """{name: ({file name: text}, the source nvcc compiles)}."""
    files = {}
    for name in ("prism_matvec_f32.cu", "prism_matvec.cuh", "prism_common.cuh"):
        with open(os.path.join(CSRC, name)) as f:
            files[name] = f.read()
    src = files["prism_matvec_f32.cu"]
    no_near = src
    for entry in NEAR_ENTRIES:
        no_near = no_near.replace(entry, entry + "\n    return 0;")
    far_first = files["prism_matvec.cuh"].replace(SELECT, FAR_FIRST)
    if no_near.count("return 0;") != src.count("return 0;") + 2 or far_first == files["prism_matvec.cuh"]:
        raise SystemExit("the source no longer has the lines the variants edit")
    out = {"as is": (files, "prism_matvec_f32.cu"),
           "no near pass": (dict(files, **{"prism_matvec_f32.cu": no_near}), "prism_matvec_f32.cu"),
           "far test first": (dict(files, **{"prism_matvec.cuh": far_first}), "prism_matvec_f32.cu")}
    if parent_dir:
        parent = {}
        for name in ("prism_matvec.cu", "prism_common.cuh"):
            with open(os.path.join(parent_dir, name)) as f:
                parent[name] = f.read()
        no_branch = parent["prism_matvec.cu"].replace(PARENT_NEAR_BRANCH, "        if (true) {")
        if no_branch == parent["prism_matvec.cu"]:
            raise SystemExit("the parent source has not the near branch the variant edits")
        out["parent"] = (parent, "prism_matvec.cu")
        out["parent, no near branch"] = (dict(parent, **{"prism_matvec.cu": no_branch}), "prism_matvec.cu")
    return out


def operators(work):
    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.io import data_io, model_io
    from tomofastx_tpu_torch.ops.matrixfree import MatrixFreeKernel, make_matrixfree_kernel

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
    ap.add_argument("--parent-dir", default=None, help="a directory holding an earlier prism_matvec.cu and "
                    "prism_common.cuh")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(smoke.nvidia_smi_line(), flush=True)
    out_dir = os.path.join(REPO, "build", "prism_variants")
    os.makedirs(out_dir, exist_ok=True)
    entries = {"prism_matvec": pm.ARGTYPES, "prism_rmatvec": pm.ARGTYPES, "prism_near_matvec": pm.NEAR_ARGTYPES,
               "prism_near_rmatvec": pm.NEAR_ARGTYPES}
    sources = variant_sources(args.parent_dir)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = {name: pool.submit(build, files, main_source, out_dir, entries)
                 for name, (files, main_source) in sources.items()}
    libs = {}
    for name, job in built.items():
        libs[name], log = job.result()
        regs = registers(log, [("prism_matvec_partials", True), ("prism_rmatvec_kernel", True),
                               ("prism_near_matvec_kernel", False), ("prism_near_rmatvec_kernel", False)])
        print(f"{name}: registers " + "; ".join(f"{k} " + ", ".join(f"{fam} {r}" for fam, r in v.items())
                                                for k, v in regs.items()), flush=True)
    launch = pm._near_launch

    def set_library(name):
        pm._library = (lambda h: (lambda is_double: h))(libs[name])
        pm._near_library = (lambda h: (lambda: h))(libs[name])
        # The parent has no near pass: its main loop evaluates the near pairs.
        pm._near_launch = (lambda *a: None) if name.startswith("parent") else launch

    work = tempfile.mkdtemp()
    try:
        time_variants(operators(work), libs, set_library,
                      {"matvec": pm.prism_matvec, "rmatvec": pm.prism_rmatvec,
                       "shape": lambda op: (op.phys.nmc, op.phys.ndc, op.xd.shape[0])},
                      torch.Generator(device="cpu").manual_seed(37))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
