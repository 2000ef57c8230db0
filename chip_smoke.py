#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

It needs one CUDA device, nvcc and nothing from the network. It

1. builds the tile_matvec kernel from tomofastx_tpu_torch/csrc/tile_matvec.cu;
2. holds the kernel against its plain PyTorch version on a random ragged pack;
3. writes a full-width synthetic gravity problem (4096 observations x 262144
   cells on a 64x64x64 lattice, Haar compression at rate 0.15, damping,
   3-lithology ADMM, 3 majors x 20 LSQR iterations, float64 build stored
   float32, float32 solve) and runs it through the command-line entry point
   on the card, counting the kernel's launches;
4. checks the outputs, and a small problem on the card against the same
   problem on the CPU;
5. packs the run's sensitivity cache again and holds the kernel against its
   plain version on the full-width forward and adjoint packs, timing the
   kernel, the plain version and torch.mv on the dense matrix (a yardstick
   only: the port never calls it) beside the least time the card could take.

Any failed phase ends the run with a non-zero exit code. Without a CUDA
device it exits with code 2 and prints no result. The last line of a good run
is {"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

# Published peaks of one H100 SXM (NVIDIA's data sheet): the bound is stated
# against these, with the card's power limit printed beside it.
MEMORY_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

NX = NY = NZ = 64
NDATA = 4096
N_MAJOR, N_MINOR = 3, 20
RTOL_F32, RTOL_F64 = 1e-5, 1e-12


class Tee(io.TextIOBase):
    """Writes through to a stream and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.kept = stream, io.StringIO()

    def write(self, s):
        self.kept.write(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_cuda(fn, warm=3, reps=20):
    """Median milliseconds of fn() by CUDA events, one pair per call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(what, got, want, rtol):
    """Fails unless got agrees with want to rtol of max|want|. Returns the
    largest absolute difference."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise SystemExit(f"FAILED {what}: {got.shape} {got.dtype} against {want.shape} {want.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise SystemExit(f"FAILED {what}: non-finite output")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    ok = err <= rtol * scale
    print(f"  {what}: max abs err = {err:.3e}, relative to max|y| = {err / max(scale, 1e-300):.3e} "
          f"(tolerance {rtol:g} x max|y|) -> {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"FAILED {what}")
    return err


def random_pack(device, seed=0, ntiles=26, bu=37, nb=50):
    """A ragged pack: tile i uses a random number of its BU slots, the rest
    are pad slots (block 0, zero values)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    uvals = torch.randn(ntiles, bu, 8, 128, generator=g)
    ubidx = torch.randint(0, nb, (ntiles, bu), generator=g, dtype=torch.int32)
    widths = torch.randint(5, bu + 1, (ntiles,), generator=g)
    pad = torch.arange(bu)[None, :] >= widths[:, None]
    uvals[pad] = 0.0
    ubidx[pad] = 0
    x = torch.randn(nb * 128, generator=g, dtype=torch.float64)
    return uvals.to(device), ubidx.to(device), x.to(device), (int(widths.min()), int(widths.max()))


def write_problem(work, nx, ny, nz, ndata_side, out_dir, n_minor):
    """Grid, observation points above the cell centers of a ndata_side^2
    sub-lattice, a three-lithology block model, and the Parfile."""
    # Cells longer in x than in y: on square cells an observation above the
    # grid's diagonal sees equal wavelet coefficients in mirrored pairs, and
    # which of a pair survives the threshold would hang on the last bit.
    h = (100.0, 80.0, 50.0)
    k, j, i = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    i, j, k = i.reshape(-1), j.reshape(-1), k.reshape(-1)
    table = np.column_stack(
        [i * h[0], (i + 1) * h[0], j * h[1], (j + 1) * h[1], k * h[2], (k + 1) * h[2], i + 1, j + 1, k + 1]
    )
    grid_path = os.path.join(work, "grid.txt")
    with open(grid_path, "w") as f:
        f.write(f"{nx * ny * nz}\n")
        np.savetxt(f, table, fmt="%.3f %.3f %.3f %.3f %.3f %.3f %d %d %d")

    step = nx // ndata_side
    jj, ii = np.meshgrid(np.arange(0, ny, step), np.arange(0, nx, step), indexing="ij")
    X = (ii.reshape(-1) + 0.5) * h[0]
    Y = (jj.reshape(-1) + 0.5) * h[1]
    data_path = os.path.join(work, "data.txt")
    with open(data_path, "w") as f:
        f.write(f"{X.size}\n")
        np.savetxt(f, np.column_stack([X, Y, np.full(X.size, -1.0), np.zeros(X.size)]), fmt="%.3f")

    m = np.zeros((nz, ny, nx))
    m[nz // 8 : nz // 2, ny // 4 : ny // 2, nx // 4 : nx // 2] = 250.0
    m[nz // 4 : 3 * nz // 4, ny // 2 : 7 * ny // 8, nx // 2 : 7 * nx // 8] = 100.0
    synth_path = os.path.join(work, "synth.txt")
    with open(synth_path, "w") as f:
        f.write(f"{m.size}\n")
        np.savetxt(f, m.reshape(-1, 1), fmt="%.9E")

    parfile = os.path.join(work, "Parfile.txt")
    with open(parfile, "w") as f:
        f.write(f"""global.outputFolderPath = {out_dir}/
global.description = synthetic gravity problem of the smoke run
modelGrid.size = {nx} {ny} {nz}
modelGrid.grav.file = {grid_path}
forward.data.grav.nData = {X.size}
forward.data.grav.dataGridFile = {data_path}
forward.data.grav.useSyntheticModelForDataValues = 1
forward.data.grav.syntheticModelFile = {synth_path}
forward.depthWeighting.type = 2
forward.matrixCompression.type = 1
forward.matrixCompression.rate = 0.15
inversion.nMajorIterations = {N_MAJOR}
inversion.nMinorIterations = {n_minor}
inversion.modelDamping.grav.weight = 1.d-11
inversion.admm.enableADMM = 1
inversion.admm.nLithologies = 3
inversion.admm.grav.bounds = -10 10 90 110 240 260
inversion.admm.grav.weight = 1.d-7
tpu.kernelFormat = tiled
""")
    return parfile


def read_costs(path):
    with open(path) as f:
        return [[float(t) for t in ln.split()] for ln in f if not ln.startswith("#")]


def dense_from_pack(uvals, ubidx, ncols_padded):
    """The dense matrix of a pack, for the torch.mv yardstick. Pad slots hold
    zeros and point at block 0, so values are added, not assigned."""
    ntiles, bu = ubidx.shape
    dense = torch.zeros(ntiles, ncols_padded // 128, 8, 128, dtype=torch.float32, device=uvals.device)
    step = max(1, (1 << 27) // (bu * 1024))
    for s in range(0, ntiles, step):
        idx = ubidx[s : s + step].long()[:, :, None, None].expand(-1, -1, 8, 128)
        dense[s : s + step].scatter_add_(1, idx, uvals[s : s + step])
    return dense.permute(0, 2, 1, 3).reshape(ntiles * 8, ncols_padded)


def measure_pack(tile_matvec, tile_matvec_plain, name, uvals, ubidx, n_in, seed):
    """Kernel against plain version on one full-width pack, both vector
    types, and the times of kernel, plain version and torch.mv."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    npad = -(-n_in // 128) * 128
    x64 = torch.zeros(npad, dtype=torch.float64)
    x64[:n_in] = torch.randn(n_in, generator=g, dtype=torch.float64)
    x64 = x64.to(uvals.device)
    x32 = x64.float()

    err32 = compare(f"full width {name} pack, f32 vector",
                    tile_matvec(uvals, ubidx, x32), tile_matvec_plain(uvals, ubidx, x32), RTOL_F32)
    err64 = compare(f"full width {name} pack, f64 vector",
                    tile_matvec(uvals, ubidx, x64), tile_matvec_plain(uvals, ubidx, x64), RTOL_F64)

    ms = time_cuda(lambda: tile_matvec(uvals, ubidx, x32))
    ms64 = time_cuda(lambda: tile_matvec(uvals, ubidx, x64), reps=10)
    plain_ms = time_cuda(lambda: tile_matvec_plain(uvals, ubidx, x32), warm=1, reps=5)

    dense = dense_from_pack(uvals, ubidx, npad)
    y_mv = dense @ x32
    mv_err = float((y_mv - tile_matvec(uvals, ubidx, x32)).abs().max())
    library_ms = time_cuda(lambda: torch.mv(dense, x32))
    dense_shape = tuple(dense.shape)
    del dense, y_mv
    torch.cuda.empty_cache()

    ntiles, bu = ubidx.shape
    nbytes = (uvals.numel() + ubidx.numel() + x32.numel() + ntiles * 8) * 4
    flops = 2 * uvals.numel()
    bound_bytes_ms = nbytes / MEMORY_BYTES_PER_S * 1e3
    bound_ops_ms = flops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    print(f"  {name} pack {tuple(uvals.shape)}: kernel {ms:.3f} ms "
          f"({nbytes / ms / 1e6:.0f} GB/s of {nbytes / 1e9:.3f} GB; f64 vector {ms64:.3f} ms), "
          f"bound {bound_ms:.3f} ms by {'bytes' if bound_bytes_ms >= bound_ops_ms else 'operations'} "
          f"(bytes {bound_bytes_ms:.3f} ms at {MEMORY_BYTES_PER_S / 1e12:.2f} TB/s, "
          f"operations {bound_ops_ms:.3f} ms at {FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s), "
          f"plain {plain_ms:.3f} ms, torch.mv on the dense {dense_shape} f32 matrix {library_ms:.3f} ms "
          f"(|kernel - mv| max {mv_err:.3e})")
    return {
        "ms": ms, "ms_f64_vector": ms64, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "max_abs_err": err32, "max_abs_err_f64_vector": err64, "bytes": nbytes, "flops": flops,
        "achieved_GB_per_s": nbytes / ms / 1e6, "shape": list(uvals.shape),
    }


def main() -> int:
    t_all = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    from tomofastx_tpu_torch import cli
    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag
    from tomofastx_tpu_torch.io import model_io
    from tomofastx_tpu_torch.ops import tile_matvec as tmv
    from tomofastx_tpu_torch.ops.tile_kernel import tile_kernel_from_cache

    tile_matvec, tile_matvec_plain = tmv.tile_matvec, tmv.tile_matvec_plain
    device = torch.device("cuda")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    smi = nvidia_smi_line()
    print(smi)

    # ---- 1. build ----
    t0 = time.time()
    lib_path, log = tmv.build_library()
    build_s = time.time() - t0
    print(log.strip())
    print(f"built {os.path.relpath(lib_path, HERE)} in {build_s:.1f} s")

    # ---- 2. kernel against plain version, random ragged pack ----
    print("kernel against plain version:")
    uvals, ubidx, x64, (wmin, wmax) = random_pack(device)
    print(f"  random pack: {tuple(uvals.shape)}, tile widths {wmin}..{wmax} of BU = {uvals.shape[1]}")
    compare("random pack, f32 vector",
            tile_matvec(uvals, ubidx, x64.float()), tile_matvec_plain(uvals, ubidx, x64.float()), RTOL_F32)
    compare("random pack, f64 vector",
            tile_matvec(uvals, ubidx, x64), tile_matvec_plain(uvals, ubidx, x64), RTOL_F64)
    torch.cuda.synchronize()
    del uvals, ubidx, x64

    work = tempfile.mkdtemp(prefix="tomofastx_smoke_")
    try:
        # ---- 3. the main path, through the command-line entry point ----
        out_dir = os.path.join(work, "out")
        t0 = time.time()
        parfile = write_problem(work, NX, NY, NZ, 64, out_dir, N_MINOR)
        fixture_s = time.time() - t0
        print(f"main path: {NDATA} observations x {NX * NY * NZ} cells, Haar rate 0.15, "
              f"{N_MAJOR} majors x {N_MINOR} minors, f32 solve on cuda (inputs written in {fixture_s:.1f} s)")
        torch.cuda.reset_peak_memory_stats()
        tee = Tee(sys.stdout)
        tmv.tile_matvec.launches = 0
        t0 = time.time()
        with contextlib.redirect_stdout(tee):
            rc = cli.main(["-p", parfile, "--device", "cuda"])
        torch.cuda.synchronize()
        main_s = time.time() - t0
        launches = tmv.tile_matvec.launches
        if rc != 0:
            raise SystemExit(f"FAILED main path: cli.main returned {rc}")
        log = tee.kept.getvalue()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        iters = [int(v) for v in re.findall(r"lsqr iters = (\d+)", log)]
        build_m = re.search(r"kernel built\+cached in ([0-9.]+)s", log)
        pack_m = re.search(r"cache packed into tiles in ([0-9.]+)s", log)
        solve_s = [float(v) for v in re.findall(r"iter done in ([0-9.]+)s", log)]
        if len(iters) != N_MAJOR or not build_m or not pack_m:
            raise SystemExit("FAILED main path: the log lacks the lines of the build, the pack or the majors")
        # Each solve calls rmatvec once before the loop and matvec + rmatvec in
        # every iteration; outside the solves the forward d = S m runs for the
        # synthetic, prior and starting models and after every major.
        expected = sum(2 * it + 1 for it in iters) + 3 + N_MAJOR
        print(f"  main path took {main_s:.1f} s: build {build_m.group(1)} s, pack {pack_m.group(1)} s, "
              f"majors {solve_s} s; peak device memory {peak_gb:.2f} GB")
        print(f"  LSQR iterations = {iters}, tile_matvec.launches = {launches} "
              f"(expected {expected} = sum of 2 x iterations + 1 per solve, + {3 + N_MAJOR} forward products)")
        if launches != expected or launches == 0:
            raise SystemExit("FAILED main path: launch count")
        if iters != [N_MINOR] * N_MAJOR:
            raise SystemExit(f"FAILED main path: LSQR iterations {iters}")

        # ---- 4. outputs ----
        costs = read_costs(os.path.join(out_dir, "costs.txt"))
        data_cost = [row[1] for row in costs]
        print(f"  data cost per major = {data_cost}")
        if len(costs) != N_MAJOR + 1 or not all(np.isfinite(v) for row in costs for v in row):
            raise SystemExit("FAILED outputs: costs.txt")
        if not all(b < a for a, b in zip(data_cost[:-1], data_cost[1:])):
            raise SystemExit("FAILED outputs: the data cost does not fall")
        for f in ("Parfile_run.txt", "model/grav_final_model_full.txt", "data/grav_final.txt",
                  "data/grav_observed.txt", "Paraview/grav_final_model3D_full.vtk",
                  "Paraview/data_grav_final.vtk", "SENSIT/sensit_grav_1_0", "SENSIT/sensit_grav_meta.txt"):
            if not os.path.getsize(os.path.join(out_dir, f)) > 0:
                raise SystemExit(f"FAILED outputs: {f}")
        model = model_io.read_model_values(os.path.join(out_dir, "model/grav_final_model_full.txt"), NX * NY * NZ)
        if model.shape != (1, NX * NY * NZ) or not np.isfinite(model).all() or not np.abs(model).max() > 1.0:
            raise SystemExit("FAILED outputs: final model")
        print(f"  final model {model.shape}: min {model.min():.3f}, max {model.max():.3f} -> ok")

        # A small problem on the card (float64 solve, so the kernel's float64
        # variant carries it) against the same problem on the CPU.
        small = os.path.join(work, "small")
        os.makedirs(small)
        res = {}
        for dev in ("cpu", "cuda"):
            pf = write_problem(small, 16, 16, 8, 8, os.path.join(small, f"out_{dev}"), 10)
            res[dev] = solve_problem_joint_gravmag(
                read_parfile(pf), solve_dtype=torch.float64, verbose=False, device=dev
            )
        a, b = res["cpu"].models[0].val, res["cuda"].models[0].val
        rel = float(np.abs(a - b).max() / (a.max() - a.min()))
        print(f"  small problem (16x16x8 cells, 64 observations, f64 solve), card against CPU: "
              f"final model differs by {rel:.3e} of its range, data cost {res['cuda'].cost_data[0]:.6e} "
              f"against {res['cpu'].cost_data[0]:.6e} (tolerance 1e-6)")
        if not rel <= 1e-6 or not abs(res["cuda"].cost_data[0] - res["cpu"].cost_data[0]) <= 1e-6:
            raise SystemExit("FAILED small problem: card against CPU")

        # ---- 5. the full-width packs ----
        print("full-width packs:")
        cfg = read_parfile(parfile)
        grid = model_io.read_model_grid(cfg.grav.model_grid_file, NX, NY, NZ)
        t0 = time.time()
        tk, meta = tile_kernel_from_cache(os.path.join(out_dir, "SENSIT"), cfg.grav, grid, device)
        torch.cuda.synchronize()
        print(f"  cache packed again in {time.time() - t0:.1f} s (nnz = {meta['nnz']:,}, "
              f"{meta['nnz'] / (tk.nrows * tk.ncols):.4f} of the dense matrix)")
        fwd = measure_pack(tile_matvec, tile_matvec_plain, "forward", tk.uvals, tk.ubidx, tk.ncols, 1)
        adj = measure_pack(tile_matvec, tile_matvec_plain, "adjoint", tk.uvalsT, tk.ubidxT, tk.nrows, 2)
        del tk
    finally:
        shutil.rmtree(work, ignore_errors=True)

    total_s = time.time() - t_all
    print(f"total {total_s:.1f} s")
    kernel = {
        "name": "tile_matvec", "route": "cuda",
        "source": "tomofastx_tpu_torch/csrc/tile_matvec.cu",
        "replaces": "tomofastx_tpu/ops/pallas_kernels.py:178",
        "launches": launches,
        "max_abs_err": max(fwd["max_abs_err"], adj["max_abs_err"]),
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound_ms"],
        "bound_by": fwd["bound_by"], "library_ms": fwd["library_ms"],
        "shape_of_these_times": "forward pack, f32 vector",
        "forward": fwd, "adjoint": adj,
        "lsqr_iterations": iters, "observations": NDATA, "cells": NX * NY * NZ,
        "main_path_s": main_s, "build_s": float(build_m.group(1)), "pack_s": float(pack_m.group(1)),
        "major_s": solve_s, "peak_device_GB": peak_gb, "kernel_build_s": build_s, "total_s": total_s,
        "memory_bytes_per_s_assumed": MEMORY_BYTES_PER_S, "fp32_flop_per_s_assumed": FP32_FLOP_PER_S,
    }
    print(smi)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
