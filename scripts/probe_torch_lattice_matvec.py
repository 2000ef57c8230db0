#!/usr/bin/env python3
"""Kernel B3 (csrc/lattice_matvec.cu) at the smoke shape of chip_smoke.py
against variants of its own source, in turns on one card: what its blend's
time is made of.

    python3 scripts/probe_torch_lattice_matvec.py [--parent-dir DIR]

Variants, each the source (and csrc/prism_common.cuh) with one textual
edit, built with nvcc -Xptxas -v into build/:
- "as is";
- "rsqrtf": the reciprocal square root with its fix-up for a denormal
  argument (what the first version of the kernel called);
- "no near branch": near cells take the 27-point rule instead of the float64
  closed forms. A timing of the main loop alone: its products are not the
  operator's (the distance is printed);
- "parent", with --parent-dir: an earlier lattice_matvec.cu and
  prism_common.cuh copied into DIR.

For each: ptxas' registers of the blend kernels of g_z, FTG-6 and TMI, and
the milliseconds (CUDA events, median of 10) of the float32 blend's matvec
and rmatvec at 4096 x 262144 (g_z, the draped survey of chip_smoke.py) and
on its first 512 observations (FTG-6, TMI), every variant timed twice in
the order v1 .. vn, vn .. v1; its outputs against "as is". Needs one CUDA
device and nvcc."""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402
from tomofastx_tpu_torch.ops import _cuda_build  # noqa: E402
from tomofastx_tpu_torch.ops import lattice_matvec as lm  # noqa: E402

CSRC = os.path.join(REPO, "tomofastx_tpu_torch", "csrc")
FAMILIES = {"g_z": "Li0ELi1ELi1ELi1", "FTG-6": "Li2ELi1ELi6ELi1", "TMI": "Li3ELi1ELi1ELi1"}


def variant_sources(parent_dir):
    """{name: (lattice_matvec.cu text, prism_common.cuh text)}."""
    with open(os.path.join(CSRC, "lattice_matvec.cu")) as f:
        src = f.read()
    with open(os.path.join(CSRC, "prism_common.cuh")) as f:
        hdr = f.read()
    rsqrtf = hdr.replace("const float ir = rsqrt_ftz(r2);", "const float ir = rsqrtf(r2);")
    no_near = src.replace("if (r2 <= __fmul_rn(FAR2, __fadd_rn(hxy, __fmul_rn(hz, hz)))) {", "if (false) {")
    if rsqrtf == hdr or no_near == src:
        raise SystemExit("the source no longer has the lines the variants edit")
    out = {"as is": (src, hdr), "rsqrtf": (src, rsqrtf), "no near branch": (no_near, hdr)}
    if parent_dir:
        with open(os.path.join(parent_dir, "lattice_matvec.cu")) as f, \
                open(os.path.join(parent_dir, "prism_common.cuh")) as g:
            out["parent"] = (f.read(), g.read())
    return out


def build(name, src, hdr, out_dir):
    """nvcc the variant in a directory of its own; (library, registers of
    each family's blend kernels)."""
    d = tempfile.mkdtemp(dir=out_dir)
    for fname, text in (("lattice_matvec.cu", src), ("prism_common.cuh", hdr)):
        with open(os.path.join(d, fname), "w") as f:
            f.write(text)
    lib = os.path.join(d, "liblattice_variant.so")
    proc = subprocess.run([_cuda_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", lib,
                           os.path.join(d, "lattice_matvec.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    log = proc.stdout + proc.stderr
    regs = {fam: dict(re.findall(r"Compiling entry function '\S*lattice_(r?matvec)_partialsIf" + key
                                 + r"EE\S*' for 'sm_90a'\n(?:.*\n)*?ptxas info\s*: Used (\d+) registers", log))
            for fam, key in FAMILIES.items()}
    handle = ctypes.CDLL(lib)
    for fn in ("lattice_matvec", "lattice_rmatvec"):
        getattr(handle, fn).argtypes = getattr(lm._library(), fn).argtypes
        getattr(handle, fn).restype = ctypes.c_int
    return handle, regs


def operators(work):
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
    libs = {}
    for name, (src, hdr) in variant_sources(args.parent_dir).items():
        libs[name], regs = build(name, src, hdr, out_dir)
        print(f"{name}: registers of the blend kernels (matvec, rmatvec) " + ", ".join(
            f"{fam} {r.get('matvec')}, {r.get('rmatvec')}" for fam, r in regs.items()), flush=True)
    work = tempfile.mkdtemp()
    g = torch.Generator(device="cpu").manual_seed(37)
    try:
        for oname, op in operators(work).items():
            xw = torch.randn((op.nmc, op.N), generator=g, dtype=torch.float64).to("cuda", torch.float32)
            u = torch.randn((op.xd.shape[0], op.ndc), generator=g, dtype=torch.float64).to("cuda", torch.float32)
            times, outs = {}, {}
            for name in list(libs) + list(libs)[::-1]:
                lm._library = (lambda h: (lambda: h))(libs[name])
                for f, kernel, v in (("matvec", lm.lattice_matvec, xw), ("rmatvec", lm.lattice_rmatvec, u)):
                    outs[(name, f)] = kernel(op, v)
                    times.setdefault((name, f), []).append(smoke.time_cuda(lambda: kernel(op, v), warm=2, reps=10))
            for (name, f), t in times.items():
                a, b = outs[(name, f)].double(), outs[("as is", f)].double()
                same = "equal" if torch.equal(a, b) else f"{float((a - b).abs().max() / b.abs().max()):.2e} of max|y| apart"
                print(f"{oname} {f} {name}: {', '.join(f'{v:.4f}' for v in t)} ms; against as is: {same}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
