#!/usr/bin/env python3
"""Kernel B3 (csrc/lattice_matvec.cu) at the smoke shape of chip_smoke.py
against variants of its own source, in turns on one card: what its blend's
time is made of.

    python3 scripts/probe_torch_lattice_matvec.py [--parent-dir DIR]

Variants, each the source (and csrc/prism_common.cuh) with one textual
edit, built with nvcc -Xptxas -v into build/, all at once:
- "as is";
- "rsqrtf": the reciprocal square root with its fix-up for a denormal
  argument (what the first version of the kernel called);
- "no near pass": the near-pass entry points return without launching, so
  the near cells' slot of the partial sums is never written (it holds
  whatever the caching allocator's block held). A timing of the main loop
  alone: its products are not the operator's;
- "near test first": the main loop tests a window cell for nearness before
  its 27-point rule and skips the rule where near (a branch in place of the
  select);
- "parent", with --parent-dir: an earlier lattice_matvec.cu and
  prism_common.cuh copied into DIR, whose blend evaluates the near cells in
  its main loop (no near pass: the wrappers skip it for this variant).

For each: ptxas' registers of the blend kernels of g_z, FTG-6 and TMI (and
of the near passes where the source has them), and the milliseconds (CUDA
events, median of 10) of the float32 blend's matvec and rmatvec at 4096 x
262144 (g_z, the draped survey of chip_smoke.py) and on its first 512
observations (FTG-6, TMI), every variant timed twice in the order v1 .. vn,
vn .. v1; its outputs against "as is", with the largest difference in
float32 units in the last place. Needs one CUDA device and nvcc."""

from __future__ import annotations

import argparse
import ctypes
import os
import re
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
NEAR_ENTRIES = ('extern "C" int lattice_near_matvec(NEAR_ARGS) {', 'extern "C" int lattice_near_rmatvec(NEAR_ARGS) {')
# blend_row's 27-point rule and select, and the same with the near test first.
SELECT = """    const float pz[3] = {__fsub_rn(ax[0].p3[lz][0], zo), __fsub_rn(ax[0].p3[lz][1], zo),
                         __fsub_rn(ax[0].p3[lz][2], zo)};
    const double w[3] = {GL3_W_OUT, GL3_W_MID, GL3_W_OUT};
    quad_points<FAM, NMC, NDC, 3>(col.px3, col.py3, pz, col.xy3, w, vol8, f, row);
    const bool near = is_near(col.dxy, hxy, __fsub_rn(ax[0].c[lz], zo), ax[0].h[lz]);
#pragma unroll
    for (int k = 0; k < NMC; ++k)
#pragma unroll
        for (int j = 0; j < NDC; ++j) row[k][j] = near ? 0.0f : row[k][j];"""
NEAR_FIRST = """    if (is_near(col.dxy, hxy, __fsub_rn(ax[0].c[lz], zo), ax[0].h[lz])) {
#pragma unroll
        for (int k = 0; k < NMC; ++k)
#pragma unroll
            for (int j = 0; j < NDC; ++j) row[k][j] = 0.0f;
        return;
    }
    const float pz[3] = {__fsub_rn(ax[0].p3[lz][0], zo), __fsub_rn(ax[0].p3[lz][1], zo),
                         __fsub_rn(ax[0].p3[lz][2], zo)};
    const double w[3] = {GL3_W_OUT, GL3_W_MID, GL3_W_OUT};
    quad_points<FAM, NMC, NDC, 3>(col.px3, col.py3, pz, col.xy3, w, vol8, f, row);"""


def variant_sources(parent_dir):
    """{name: {file name: text}}."""
    with open(os.path.join(CSRC, "lattice_matvec.cu")) as f:
        src = f.read()
    with open(os.path.join(CSRC, "prism_common.cuh")) as f:
        hdr = f.read()
    rsqrtf = hdr.replace("const float ir = rsqrt_ftz(r2);", "const float ir = rsqrtf(r2);")
    no_near = src
    for entry in NEAR_ENTRIES:
        no_near = no_near.replace(entry, entry + "\n    return 0;")
    near_first = src.replace(SELECT, NEAR_FIRST)
    if rsqrtf == hdr or no_near.count("return 0;") != src.count("return 0;") + 2 or near_first == src:
        raise SystemExit("the source no longer has the lines the variants edit")
    out = {"as is": {"lattice_matvec.cu": src, "prism_common.cuh": hdr},
           "rsqrtf": {"lattice_matvec.cu": src, "prism_common.cuh": rsqrtf},
           "no near pass": {"lattice_matvec.cu": no_near, "prism_common.cuh": hdr},
           "near test first": {"lattice_matvec.cu": near_first, "prism_common.cuh": hdr}}
    if parent_dir:
        out["parent"] = {}
        for name in ("lattice_matvec.cu", "prism_common.cuh"):
            with open(os.path.join(parent_dir, name)) as f:
                out["parent"][name] = f.read()
    return out


def registers(log, kernels):
    """{kernel: {family: registers}} of the float32 blend's kernels and the
    near passes' (chip_smoke.kernel_registers) from ptxas' log."""
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
        if hasattr(handle, fn):
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
    return handle, proc.stdout + proc.stderr


def ulps(a, b):
    """The largest |a - b| in float32 units in the last place of b."""
    a, b = a.float(), b.float()
    spacing = torch.nextafter(b.abs(), torch.full_like(b, float("inf"))) - b.abs()
    return float(((a.double() - b.double()).abs() / spacing.double()).max())


def time_variants(ops, libs, set_library, kernels, g):
    """Every operator's products through each variant (set_library(name)
    installs it), timed in turns; printed against "as is"."""
    for oname, op in ops.items():
        nmc, ndc, nrows = kernels["shape"](op)
        xw = torch.randn((nmc, op.N), generator=g, dtype=torch.float64).to("cuda", torch.float32)
        u = torch.randn((nrows, ndc), generator=g, dtype=torch.float64).to("cuda", torch.float32)
        times, outs = {}, {}
        for name in list(libs) + list(libs)[::-1]:
            set_library(name)
            for f, kernel, v in (("matvec", kernels["matvec"], xw), ("rmatvec", kernels["rmatvec"], u)):
                outs[(name, f)] = kernel(op, v)
                times.setdefault((name, f), []).append(smoke.time_cuda(lambda: kernel(op, v), warm=2, reps=10))
        for (name, f), t in times.items():
            a, b = outs[(name, f)], outs[("as is", f)]
            if name.startswith("no near"):
                same = "not compared (the near terms are left out)"
            elif torch.equal(a, b):
                same = "equal"
            else:
                rel = float((a.double() - b.double()).abs().max() / b.double().abs().max())
                same = f"{rel:.2e} of max|y| apart, at most {ulps(a, b):.3g} float32 ulps"
            print(f"{oname} {f} {name}: {', '.join(f'{v:.4f}' for v in t)} ms; against as is: {same}", flush=True)


def lattice_operators(work):
    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.io import data_io, model_io
    from tomofastx_tpu_torch.ops.matrixfree import make_matrixfree_kernel

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
    ap.add_argument("--parent-dir", default=None, help="a directory holding an earlier lattice_matvec.cu and "
                    "prism_common.cuh")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(smoke.nvidia_smi_line(), flush=True)
    out_dir = os.path.join(REPO, "build", "lattice_variants")
    os.makedirs(out_dir, exist_ok=True)
    entries = {"lattice_matvec": lm.ARGTYPES, "lattice_rmatvec": lm.ARGTYPES,
               "lattice_near_matvec": lm.NEAR_ARGTYPES, "lattice_near_rmatvec": lm.NEAR_ARGTYPES}
    sources = variant_sources(args.parent_dir)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = {name: pool.submit(build, files, "lattice_matvec.cu", out_dir, entries)
                 for name, files in sources.items()}
    libs = {}
    for name, job in built.items():
        libs[name], log = job.result()
        regs = registers(log, [("lattice_matvec_partials", True), ("lattice_rmatvec_partials", True),
                               ("lattice_near_matvec_kernel", False), ("lattice_near_rmatvec_kernel", False)])
        print(f"{name}: registers " + "; ".join(f"{k} " + ", ".join(f"{fam} {r}" for fam, r in v.items())
                                                for k, v in regs.items()), flush=True)
    launch = lm._near_launch

    def set_library(name):
        lm._library = lm._near_library = (lambda h: (lambda: h))(libs[name])
        # The parent has no near pass: its main loop evaluates the near cells.
        lm._near_launch = (lambda *a: None) if name == "parent" else launch

    work = tempfile.mkdtemp()
    try:
        time_variants(lattice_operators(work), libs, set_library,
                      {"matvec": lm.lattice_matvec, "rmatvec": lm.lattice_rmatvec,
                       "shape": lambda op: (op.nmc, op.ndc, op.xd.shape[0])},
                      torch.Generator(device="cpu").manual_seed(37))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
