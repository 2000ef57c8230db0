#!/usr/bin/env python3
"""Kernels 1 and 2 (csrc/tile_matvec.cu) at the smoke shape of chip_smoke.py
(4096 observations x 262144 cells, the tiled cache's packs: forward
(512, 1955, 8, 128), adjoint (32768, 32, 8, 128)), in one call on one card:

- the kernel as built for the package, against its plain version (f32 and
  f64 vectors), timed by CUDA events beside torch.mv on the pack's dense
  matrix and the bytes bound;
- kernel 2 on four slots of the card (one launch for the four parts) beside
  one kernel 1 launch on the whole pack;
- variants of the kernel's shape (short tiles a block, ring stages),
  built from the same source with -D flags;
- with --parent-source, the kernel of an earlier source (one launch a tile,
  the entry point tile_matvec_f32/f64(uvals, ubidx, x, y, ntiles, bu,
  stream)), timed in turns with the package's: parent, kernel, kernel,
  parent, and its kernel 2 (one launch a part) beside the package's.

    git show <commit>:tomofastx_tpu_torch/csrc/tile_matvec.cu > build/parent_tile_matvec.cu
    python3 scripts/probe_torch_tile_matvec.py --parent-source build/parent_tile_matvec.cu

Needs one CUDA device and nvcc; builds into build/ (ignored by git); prints
one JSON line last."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402
from tomofastx_tpu_torch.ops import _cuda_build  # noqa: E402
from tomofastx_tpu_torch.ops import tile_matvec as tmv  # noqa: E402

# (tiles a block and ring stages on short tiles, ring stages of a long
# tile's chain); the first is the package's.
VARIANTS = ((tmv.WARPS, 3, 8), (8, 4, 12), (4, 6, 6), (2, 8, 8), (2, 12, 8))


def back_to_back(fn, n=20):
    """Milliseconds a call of fn() over n calls between one pair of CUDA
    events: the host's time in the wrapper hides behind the card's work."""
    return smoke.time_cuda(fn, reps=1, calls=n)


def nvcc(source, out, defines=()):
    cmd = [_cuda_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", *(f"-D{d}" for d in defines), "-o", out, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return out, proc.stdout + proc.stderr


class Variant:
    """The package's kernel source built with another shape, launched
    through its C entry points with the plan of that shape."""

    def __init__(self, path, warps, stages, chain_stages):
        self.warps = warps
        self.name = f"short tiles {warps} a block, {stages} stages; chain {chain_stages} stages"
        self.lib = ctypes.CDLL(path)
        for fn in (self.lib.tile_matvec_f32, self.lib.tile_matvec_f64):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        vals = [ctypes.c_int() for _ in range(3)]
        if self.lib.tile_matvec_prepare(*(ctypes.byref(v) for v in vals)) != 0:
            raise RuntimeError("tile_matvec_prepare failed")

    def __call__(self, parts, x):
        chain, rows, nblocks = tmv.launch_table([ub.shape[0] for _, ub in parts], parts[0][1].shape[1],
                                                self.warps)
        # NaN first: a launch that writes nothing cannot pass for a right one.
        y = torch.full((sum(ub.shape[0] for _, ub in parts) * 8,), float("nan"), dtype=x.dtype, device=x.device)
        table = (tmv._Part * len(parts))(*(tmv._Part(uv.data_ptr(), ub.data_ptr(), t0, b0, n, 0)
                                            for (uv, ub), (t0, b0, n) in zip(parts, rows)))
        fn = self.lib.tile_matvec_f32 if x.dtype == torch.float32 else self.lib.tile_matvec_f64
        err = fn(ctypes.addressof(table), len(parts), x.data_ptr(), y.data_ptr(), parts[0][1].shape[1], chain,
                 nblocks, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return y


class Parent:
    """An earlier source's kernel: one launch a tile, one launch a part."""

    def __init__(self, path):
        self.lib = ctypes.CDLL(path)
        for fn in (self.lib.tile_matvec_f32, self.lib.tile_matvec_f64):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def __call__(self, parts, x):
        ys = []
        for uv, ub in parts:
            y = torch.empty(ub.shape[0] * 8, dtype=x.dtype, device=x.device)
            fn = self.lib.tile_matvec_f32 if x.dtype == torch.float32 else self.lib.tile_matvec_f64
            err = fn(uv.data_ptr(), ub.data_ptr(), x.data_ptr(), y.data_ptr(), ub.shape[0], ub.shape[1],
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"parent launch failed: CUDA error {err}")
            ys.append(y)
        return ys[0] if len(ys) == 1 else torch.cat(ys)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-source", help="an earlier csrc/tile_matvec.cu to time beside the package's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag
    from tomofastx_tpu_torch.io import model_io
    from tomofastx_tpu_torch.ops.tile_kernel import tile_kernel_from_cache
    from tomofastx_tpu_torch.parallel.mesh import Mesh, shard_kernel

    smi = smoke.nvidia_smi_line()
    print(smi)
    out = {"device": smi, "torch": torch.__version__}
    device = torch.device("cuda")

    # Every build at once: the package's library, the variants, the parent.
    build = os.path.join(_cuda_build.BUILD_DIR, "probe_tile_matvec")
    os.makedirs(build, exist_ok=True)
    t0 = time.time()
    with ThreadPoolExecutor(len(VARIANTS) + 2) as pool:
        pkg = pool.submit(tmv.build_library)
        var = [pool.submit(nvcc, tmv._SOURCE, os.path.join(build, f"lib_w{w}_s{s}_c{c}.so"),
                           (f"TILE_MATVEC_WARPS={w}", f"TILE_MATVEC_STAGES={s}", f"TILE_MATVEC_CHAIN_STAGES={c}"))
               for w, s, c in VARIANTS]
        par = pool.submit(nvcc, args.parent_source, os.path.join(build, "lib_parent.so")) if args.parent_source else None
        print(pkg.result()[1].strip())
        variants = [Variant(f.result()[0], *v) for f, v in zip(var, VARIANTS)]
        parent = Parent(par.result()[0]) if par else None
    print(f"built in {time.time() - t0:.1f} s")

    print("the package's kernel on the edges of its work plan:")
    smoke.tile_matvec_edges(tmv, device)
    work = tempfile.mkdtemp(prefix="probe_tile_matvec_")
    try:
        inputs = smoke.write_inputs(work, smoke.NX, smoke.NY, smoke.NZ, smoke.SIDE)
        run = os.path.join(work, "out")
        pf = smoke.write_parfile(work, "Parfile.txt", inputs, run, 1, fmt="tiled", n_major=1)
        solve_problem_joint_gravmag(read_parfile(pf), verbose=False, device="cuda")
        cfg = read_parfile(pf)
        grid = model_io.read_model_grid(cfg.grav.model_grid_file, smoke.NX, smoke.NY, smoke.NZ)
        tk, _ = tile_kernel_from_cache(os.path.join(run, "SENSIT"), cfg.grav, grid, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    tks = shard_kernel(tk, Mesh(np.array([device] * 4, dtype=object), ("cells",)))

    for name, uv, ub, n_in, seed, parts in (("forward", tk.uvals, tk.ubidx, tk.ncols, 1, tks.parts),
                                            ("adjoint", tk.uvalsT, tk.ubidxT, tk.nrows, 2, tks.partsT)):
        x64 = smoke.seeded_vector(n_in, seed, device)
        x32 = x64.float()
        dense = smoke.dense_from_pack(uv, ub, x64.shape[0])
        whole = [(uv, ub)]
        nbytes = (uv.numel() + ub.numel() + x32.numel() + ub.shape[0] * 8) * 4
        bound_ms = smoke.bound(nbytes, 2 * uv.numel())[0]
        r = {"shape": list(uv.shape), "bound_ms": bound_ms,
             "max_abs_err": smoke.compare(f"{name}, f32", tmv.tile_matvec(uv, ub, x32),
                                          tmv.tile_matvec_plain(uv, ub, x32), smoke.RTOL_F32),
             "max_abs_err_f64_vector": smoke.compare(f"{name}, f64", tmv.tile_matvec(uv, ub, x64),
                                                     tmv.tile_matvec_plain(uv, ub, x64), smoke.RTOL_F64)}
        for x in (x32, x64):
            if not torch.equal(tmv.tile_matvec_sharded(parts, x, device), tmv.tile_matvec(uv, ub, x)):
                raise SystemExit(f"FAILED {name}: kernel 2 on 4 slots differs from one kernel 1 launch ({x.dtype})")
            if not torch.equal(tmv.tile_matvec(uv, ub, x), tmv.tile_matvec(uv, ub, x)):
                raise SystemExit(f"FAILED {name}: two launches differ ({x.dtype})")
        for v in variants:
            if not torch.equal(v(whole, x32), tmv.tile_matvec(uv, ub, x32)):
                raise SystemExit(f"FAILED {name}: variant {v.name} differs from the package's kernel")
            smoke.compare(f"{name}, variant {v.name}, f32", v(whole, x32),
                          tmv.tile_matvec_plain(uv, ub, x32), smoke.RTOL_F32)
        # Each f32 product against the same product summed in f64 (x32's
        # values, exactly): the largest and the root-mean-square error over max|y|.
        exact = tmv.tile_matvec_plain(uv, ub, x32.double())
        scale = float(exact.abs().max())
        n = dense.shape[0]
        got = {"kernel": tmv.tile_matvec(uv, ub, x32), "mv": torch.mv(dense, x32)}
        if parent:
            got["parent"] = parent(whole, x32)
        r["f32_error_against_f64_sum"] = {
            k: {"max": float((v[:n].double() - exact[:n]).abs().max()) / scale,
                "rms": float((v[:n].double() - exact[:n]).pow(2).mean().sqrt()) / scale} for k, v in got.items()}
        print(f"{name}: f32 error against the f64 sum {json.dumps(r['f32_error_against_f64_sum'])}")
        del exact, got
        t = {}
        # In turns: parent, kernel, mv, kernel, parent.
        if parent:
            t["parent_ms"] = smoke.time_cuda(lambda: parent(whole, x32))
        t["kernel_ms"] = smoke.time_cuda(lambda: tmv.tile_matvec(uv, ub, x32))
        t["mv_ms"] = smoke.time_cuda(lambda: torch.mv(dense, x32))
        t["kernel_again_ms"] = smoke.time_cuda(lambda: tmv.tile_matvec(uv, ub, x32))
        if parent:
            t["parent_again_ms"] = smoke.time_cuda(lambda: parent(whole, x32))
            t["parent_f64_ms"] = smoke.time_cuda(lambda: parent(whole, x64), reps=10)
            t["parent_4_slots_ms"] = smoke.time_cuda(lambda: parent(parts, x32))
            t["parent_4_slots_f64_ms"] = smoke.time_cuda(lambda: parent(parts, x64), reps=10)
        t["kernel_f64_ms"] = smoke.time_cuda(lambda: tmv.tile_matvec(uv, ub, x64), reps=10)
        t["back_to_back"] = {"kernel_ms": back_to_back(lambda: tmv.tile_matvec(uv, ub, x32)),
                             "mv_ms": back_to_back(lambda: torch.mv(dense, x32)),
                             "kernel2_4_slots_ms": back_to_back(lambda: tmv.tile_matvec_sharded(parts, x32, device))}
        if parent:
            t["back_to_back"]["parent_ms"] = back_to_back(lambda: parent(whole, x32))
        t["kernel2_4_slots_ms"] = smoke.time_cuda(lambda: tmv.tile_matvec_sharded(parts, x32, device))
        t["kernel2_4_slots_f64_ms"] = smoke.time_cuda(lambda: tmv.tile_matvec_sharded(parts, x64, device), reps=10)
        t["kernel_third_ms"] = smoke.time_cuda(lambda: tmv.tile_matvec(uv, ub, x32))
        t["mv_again_ms"] = smoke.time_cuda(lambda: torch.mv(dense, x32))
        # Each variant back to back, three times in turns, the parent between rounds.
        rounds = []
        for _ in range(3):
            rounds.append([back_to_back(lambda: v(whole, x32)) for v in variants])
            if parent:
                t["back_to_back"].setdefault("parent_rounds_ms", []).append(back_to_back(lambda: parent(whole, x32)))
        t["variants"] = {v.name: sorted(r[i] for r in rounds)[1] for i, v in enumerate(variants)}
        t["variants_f64"] = {v.name: back_to_back(lambda: v(whole, x64), n=10) for v in variants[:2]}
        r.update(t)
        r["share_of_bound"] = bound_ms / min(t["kernel_ms"], t["kernel_again_ms"])
        print(f"{name}: {json.dumps(r)}")
        out[name] = r
        del dense
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
