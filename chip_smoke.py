#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

It needs one CUDA device, nvcc and nothing from the network. It

1. builds the hand-written kernels (tile_matvec, blocked_matvec, the
   bfloat16 GEMV pair of kernel B1, the per-cell matrix-free pair of kernel
   B2 from its float32 and its float64 source, and the corner-lattice pair of
   kernel B3, each blend with the build of its stored near rows and its near
   passes over them) from tomofastx_tpu_torch/csrc/,
   one compiler a source, all started together, and keeps what ptxas says
   of each kernel's registers;
2. holds each kernel against its plain PyTorch version on a random ragged
   layout (B1: on bfloat16 matrices with and without 16-byte aligned rows),
   tile_matvec also on either side of each edge of its work plan, and
   tile_matvec_sharded's one launch over parts of their own against one
   tile_matvec launch (equal to the last bit); B2 on small per-cell problems
   of every family (g_z, Gzz, FTG-6, TMI, three-component, magnetization
   vector, the borehole branch) in float64 and float32, with padding rows
   and cells, over 7 slots of the card, and on a boundary-coincident
   observation (the construction aborts); B3 on small lattice problems of
   every family but the borehole branch (float64, the float32 blend, float32
   closed forms), with partial tiles and observations on lattice planes
   (against the CPU too), and over 3 slots of the card; each float32 blend's
   products also against the plain version of its split (main loop and near
   pass, float64 sums), B2's and B3's stored near rows against their plain
   build (the same pairs, each row within RTOL_NEAR_ROWS), and their near
   passes alone against the plain product over the stored rows and the plain
   pass that evaluates the rows again;
3. writes a full-width synthetic gravity problem (4096 observations x 262144
   cells on a 64x64x64 lattice, Haar compression at rate 0.15, damping,
   3-lithology ADMM, 3 majors x 20 LSQR iterations, float64 build stored
   float32, float32 solve) and runs it through the command-line entry point
   on the card five times: with tpu.kernelFormat = tiled (the tile_matvec
   kernel under every product); the same with --mesh 1 (the row-sharded
   build, and the sharded tile contraction tile_matvec_sharded under every
   product); with no kernelFormat line (the default, a dense kernel
   accumulated on the device and written to the cache); the same with
   --mesh 1; and with tpu.kernelFormat = packed reading the dense run's
   cache; the kernels' launches are counted in each run;
4. checks the outputs of each run, each --mesh 1 run against its unmeshed
   run (equal to the last bit expected), the three formats against each
   other, and two small problems (tiled compressed, dense uncompressed) on
   the card against the same problems on the CPU;
5. packs the run's sensitivity cache again and holds tile_matvec against its
   plain version on the full-width forward and adjoint packs, timing the
   kernel, the plain version and torch.mv on the dense matrix (a yardstick
   only: the port never calls it for that layout) beside the least time the
   card could take; then shards both packs over a mesh of four slots on the
   one card (the parts are views) and holds tile_matvec_sharded against one
   tile_matvec launch on the whole pack (equal to the last bit) and against
   its plain version, timed the same way;
6. cuts two row-block layouts from the dense matrix of the run (every used
   128-block of each row; each row's 256 blocks of largest energy), holds
   blocked_matvec against its plain version on both, times it the same way,
   and drives it through the port's forward-data and LSQR entry points,
   counting its launches;
7. times matvec and rmatvec of the three operators at full width; then casts
   the dense matrix to bfloat16 and holds kernel B1 (bf16_matvec,
   bf16_rmatvec) against its plain version, timed beside its bytes bound,
   the plain version, torch.mv on the bfloat16 matrix with a bfloat16
   vector and torch.mv on the float32 matrix (yardsticks of other
   functions: no PyTorch call computes this one);
8. solves the problem again from the tiled run's cache through
   solve_problem_joint_gravmag with the same four-slot mesh, tiled (equal to
   the last bit to the unmeshed solve) and dense (four column partials,
   held at the formats' tolerance);
9. on a machine with two cards or more, the tiled solve over
   make_mesh(device_count) on distinct cards, held as in 8, with each card's
   peak memory (the kernel is assembled on the host there); on every
   machine, that host assembly (the kernel built into host memory or packed
   from the cache on the host, weighted there, and its part copied to the
   card) over a one-slot mesh of the card: the tiled solve from the cache and
   the dense main path, each timed and held equal to the last bit to its run
   assembled on the card;
10. writes a joint gravity + magnetic problem over the same grid (an airborne
   survey 80 m above the cell centres, one block model: density and
   susceptibility; TMI of a 50000 nT field at inclination 60 and declination
   10 degrees) and runs it through the command-line entry point tiled
   (tile_matvec under every product of both problems, launches counted) and
   dense, held to each other at the formats' tolerance;
11. runs the full FTG tensor (4096 observations x 6 components, a dense
   24576 x 262144 kernel, no cache written) through the command-line entry
   point;
12. six small problems of the magnetic and gradiometry kinds (TMI tiled,
   magnetization vector dense, three-component data packed, a borehole survey
   dense, Gzz tiled, joint grav+mag dense) on the card against the CPU;
13. solves the joint problem from the joint tiled run's cache unmeshed and
   over the four slots of 8 (equal to the last bit, tile_matvec_sharded under
   every product);
14. holds tile_matvec against its plain version on the magnetic problem's
   forward and adjoint packs and times it as in 5;
15. couples the joint problem of 10, read from its tiled run's cache, by
   the cross-gradient (central differences), the damping gradient of both
   problems and a 2-cluster mixture (log objective, global weights), with
   weights from the row-scale rule of coupling_weights, and runs it through
   the command-line entry point tiled (tile_matvec under every product,
   launches counted) and dense, held to each other at the formats'
   tolerance, then over the four slots of 8 (equal to the last bit); each
   run solves in the model domain (the wavelet inside every product) and
   writes the cross-gradient and clustering fields; one LSQR iteration's
   products are timed block by block;
16. seven small coupled problems (cross-gradient forward, with a vector
   field, with the density kept constant; damping gradient with a weights
   file; clustering with cell weights and the plain objective, and with the
   log objective; sensit.readFromFiles = 2), tiled and dense, on the card
   against the CPU;
17. on small problems through the command-line entry point: a run stopped
   at its checkpoint and resumed (--resume) against the uninterrupted run;
   --profile (the trace names tile_matvec's kernel once a launch); and
   --debug-nans on a NaN datum (exit code 1, FloatingPointError traceback);
18. builds the native table reader (io/_native/fasttab.cpp) from the
   checkout's source, and holds it against numpy on the smoke grid and model
   (the files byte for byte, the values to the last bit), with both readers'
   times;
19. tpu.kernelFormat = matrixfree, uncompressed, through the command-line
   entry point on the survey of 3 (BTTBKernel): against a dense uncompressed
   run of the same Parfile at the formats' tolerance, --mesh 1 to the last
   bit, and over the four slots of 8 with the layers split;
20. the same on a draped survey (heights varying from point to point:
   LatticeMatrixFreeKernel with its float32 tiered blend, its products by
   kernel B3), LATTICE_DEPTH deep, B3's launches counted (its near pass's
   too): B3 against its plain loop at full width for g_z in float32 (the
   blend) and float64 (the closed forms), and for FTG-6 and TMI on 512 rows,
   each timed beside the plain loop and its bound with the registers of its
   kernels, and each blend's stored near rows and near passes held as in 2,
   each pass timed on the card alone (a CUDA graph of calls) beside its
   plain version and its bytes bound, and the rows' build timed beside its
   plain version; the products against the dense uncompressed
   matrix (torch.mv on it timed as a yardstick); 256 float32 rows through
   the kernel against the float64 closed forms; the construction's probe
   aborting through B3; --mesh 1 to the last bit; a dense uncompressed run
   (the float32 pair's spread read); the float32 solve through kernel B3
   held to the same solve through its plain loop on the card,
   LATTICE_PLAIN_DEPTH deep, at the formats' tolerance; and both Parfiles
   again with float64 solves held to each other at the formats' tolerance;
21. a grid whose top layer follows a topography (MatrixFreeKernel, its
   products by kernel B2): B2 against its plain loop at full width for g_z
   in float32 (the blend) and float64, and for FTG-6 and TMI on 512 rows,
   each timed beside the plain loop and its bound with the registers of its
   kernels, and each blend's near rows and passes as for B3; the products against the
   dense uncompressed matrix (torch.mv on it timed as a yardstick); then a
   GENERIC_DEPTH solve through the command-line entry point, B2's launches
   counted;
22. kernelFormat = auto on 128 x 128 x 64 cells and 16384 observations
   (uncompressed; a dense kernel of 68.7 GB): the log says matrix-free and
   names BTTBKernel, the data cost falls, 64 rows of the forward data against
   closed-form rows in float64; phases 19-22 time each operator's matvec and
   rmatvec beside the bytes it holds;
23. seven small float64 matrix-free problems (BTTB g_z and FTG, lattice g_z
   and TMI through kernel B3, per-cell g_z and borehole TMI through kernel
   B2, lattice g_z over four slots of the card) on the card against the CPU,
   3 x 10; their CPU solves run in two worker processes from phase 5 on;
24. tpu.kernelStoreDtype = bfloat16 through the command-line entry point: the
   dense kernel built straight into bfloat16 (no cache written), every product
   through kernel B1 (launches counted), --mesh 1 to the last bit, against
   the float32 dense run of 3 (peak memory beside its);
25. the tiled main path built three ways, --build-precision single,
   --fast-build 64 and --f32-compress, each cache's Frobenius distance from
   the float64-built cache of 3;
26. tpu.refineForward = 1 on the tiled path (read from the cache of 3), the
   forward in the solve's precision and in float64 (tpu.refineForwardPrecision = double: the BTTB
   operator on complex128 FFTs), the latter with --mesh 1 to the last bit;
   the predicted data against a dense uncompressed forward of the final
   model;
27. five small float64 problems of these variants (bfloat16 dense, float32
   build, mixed build, float32 compression, refineForward) on the card
   against the CPU;
28. the fused major loop, --fused 3 through the command-line entry point
   (one CUDA graph a major, launched three times: head -> WHILE node over
   one LSQR iteration -> tail, csrc/graph_while.cu; the WHILE node first
   alone on three small graphs against its plain loop): tiled from the
   tiled run's cache (tile_matvec replayed inside the graph), the same with
   --mesh 1 (tile_matvec_sharded; equal to the last bit to the unmeshed
   fused run), bfloat16 dense (kernel B1), the coupled joint problem tiled,
   BTTB, refineForward with a float64 forward, the per-cell operator on
   the topography survey of 21 (kernel B2) and the lattice operator on the
   draped survey of 20 (kernel B3), each held to the
   host-driven run of its Parfile at the formats' tolerance, and each
   kernel's launches on the card read from its own run (those its wrapper
   counted outside the capture, plus, for each major, the head's and tail's
   launches and the body's times its runs, the WHILE node's counter, equal
   to the LSQR iterations; one more major profiled by torch.profiler must
   show them); a
   5-major run written every 2 (chunks of 2, 2 and 1 majors, one capture)
   and its resumption from the checkpoint of major 4, equal to the last
   bit; through the library, the tiled, per-cell and lattice runs' graphs
   launched against the same steps launched eagerly on the card (LSQR
   unrolled; equal to the last bit, with torch.profiler's count of
   tile_matvec, B2 or B3 in each major of that chunk; the per-cell and
   lattice runs count their near passes too); and four small float64 fused
   problems (tiled, coupled dense, BTTB and the lattice operator) on the
   card against the CPU; and a fused run whose LSQR stops early
   (inversion.minResidual) beside its host-driven run: LSQR iterations, the
   WHILE node's body runs (equal to them) and seconds a major of each.
   The runs of this phase that read the tiled cache share one packing of it;
29. the 4m capacity rung of scripts/run_capacity_torch.py at its full width
   (200 x 200 x 100 = 4,000,000 cells, 2025 observations, the lattice
   operator's float32 blend), its fixtures and Parfile written and solved
   by the script CAPACITY_DEPTH deep: kernel B3's launches (and its near
   passes' and near rows' build's) counted, the data cost falls, the peak
   device memory, wall and host peak printed; then one B3 pair on that run's
   operator against its plain loop, two launches equal to the last bit,
   timed beside its bound, its near rows and passes held and timed as in 20;
30. the last two JAX capacity scripts' rungs of scripts/run_capacity_torch.py
   at their full width: generic4m (200 x 200 x 100 cells whose x edges grow
   and shear, 2025 observations at jittered heights: the per-cell operator's
   float32 blend) at its own depth, 2 x 10, kernel B2's launches (and its
   near passes' and near rows' build's) counted, the data cost falls, then
   one B2 pair of that run's operator against its plain loop on
   CAPACITY_B2_ROWS observation rows, two launches equal, its near rows and
   passes there against theirs, and the pair, the near passes and the
   rows' build timed on the whole operator beside their bounds (the rows
   held against their plain build there too); and
   1m (the mixed build's dense float32 kernel of 2025 x 1,048,576) cut to
   DENSE_DEPTH with no sensitivity cache written, in one fused chunk: the
   major captured once as a CUDA graph and replayed, no hand kernel
   launched, the data cost falls; then the script's matrix-free section
   (the lattice operator on the same grid and survey, seconds an LSQR
   iteration) with kernel B3's launches counted.

The full-width kernels and their torch.mv yardstick are timed over calls back
to back between one pair of CUDA events (BACK_TO_BACK). Any failed phase ends
the run with a non-zero exit code. Without a CUDA
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
from concurrent.futures import ThreadPoolExecutor

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
SIDE = 64  # observations above the cell centres of a SIDE x SIDE sub-lattice
NDATA = SIDE * SIDE
N_MAJOR, N_MINOR = 3, 20
RTOL_F32, RTOL_F64 = 1e-5, 1e-12
# A float32 blend kernel against the plain version of its split: the same
# float32 rows, summed in float64 in another order and rounded once, so a
# few float32 roundings of max|y| apart (an H100 read at most 5e-8).
RTOL_SPLIT = 1e-6
TOP_BLOCKS = 256  # slots per row of the second row-block layout
JOINT_HEIGHT = 80.0  # m: the joint survey is airborne
DENSE_SAID = r"{p} kernel: dense \({rows}, " + str(NX * NY * NZ) + r"\) torch\.float32"
DENSE_BF16_SAID = r"grav kernel: dense \(" + str(NDATA) + ", " + str(NX * NY * NZ) + r"\) torch\.bfloat16"
# The three formats hold the same float32 matrix and differ in the order of
# their float32 sums, which 3 majors x 20 float32 LSQR iterations amplify: an
# H100 read 2.0e-4 of the model's range and 5.4e-2 of the (small) data cost
# between packed and tiled (PERF.md). In float64 on the CPU the formats agree
# to 1e-9 (tests/test_torch_workflow.py).
FORMATS_MODEL_TOL = 2e-3  # of the tiled run's model range
FORMATS_COST_RTOL = 0.25
# Two float32 products of one matrix, summed in different orders, on a vector
# whose terms cancel (a wavelet-transformed model): an H100 read 5.7e-6 of
# max|y|. And 20 float32 LSQR iterations on the two: 1.7e-3 of max|x|.
RTOL_F32_FORWARD, RTOL_F32_LSQR = 1e-4, 2e-2

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


def time_cuda(fn, warm=3, reps=20, calls=1):
    """Median milliseconds of fn() by CUDA events: `reps` pairs of events,
    each around `calls` calls back to back (with calls > 1 the wrapper's
    time on the host hides behind the card's work, as in a solve)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def timed_once(fn):
    """(fn(), its milliseconds by CUDA events): one call, no warm-up, for a
    plain version whose result is compared too."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


# Kernels of the full-width layouts and their torch.mv yardstick are timed
# over this many calls back to back between one pair of events.
BACK_TO_BACK = 10


def launched(launches, **want):
    """Whether a run's launch counts are `want`, and 0 for every other kernel."""
    return launches == {k: want.get(k, 0) for k in launches}


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


def bound(nbytes, flops):
    """Least milliseconds the card could take: (the larger, which one, by bytes, by operations)."""
    by_bytes = nbytes / MEMORY_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations", by_bytes, by_ops


def random_pack(device, seed=0, ntiles=26, bu=37, nb=50):
    """A ragged pack: tile i uses a random number of its BU slots, the rest
    are pad slots (block 0, zero values)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    uvals = torch.randn(ntiles, bu, 8, 128, generator=g)
    ubidx = torch.randint(0, nb, (ntiles, bu), generator=g, dtype=torch.int32)
    widths = torch.randint(min(5, bu), bu + 1, (ntiles,), generator=g)
    pad = torch.arange(bu)[None, :] >= widths[:, None]
    uvals[pad] = 0.0
    ubidx[pad] = 0
    x = torch.randn(nb * 128, generator=g, dtype=torch.float64)
    return uvals.to(device), ubidx.to(device), x.to(device), (int(widths.min()), int(widths.max()))


def tile_matvec_edges(tmv, device):
    """Kernel 1 against its plain version where its work plan changes
    (tmv.work_plan): BU of 1, one below, at and one above each edge (chains
    of 1 slot; a warp a tile up to SHORT slots, a cluster of CHAINS blocks
    a tile above), on ragged packs of fewer tiles than the card has SMs,
    and a long tile of the smoke's forward; and kernel 2's one launch over
    parts in memory of their own, equal to the last bit to one kernel 1
    launch on the whole pack, on either side of the edge."""
    u, c = tmv.SHORT, tmv.CHAINS
    cases = [(bu, 45) for bu in (1, c - 1, c, c + 1, u - 1, u, u + 1, 255)] + [(1955, 5)]
    for bu, ntiles in cases:
        uvals, ubidx, x64, _ = random_pack(device, seed=bu, ntiles=ntiles, bu=bu)
        blocks, tiles = tmv.work_plan(bu)
        for x, rtol in ((x64.float(), RTOL_F32), (x64, RTOL_F64)):
            compare(f"tile_matvec, BU = {bu} ({blocks} blocks a tile, {tiles} tiles a block), {ntiles} tiles, "
                    f"{x.dtype}", tmv.tile_matvec(uvals, ubidx, x), tmv.tile_matvec_plain(uvals, ubidx, x), rtol)
        if bu in (u - 1, u + 1):
            # Three parts (7, 20, 18 tiles), each copied into memory of its
            # own, the last first.
            cuts = [(0, 7), (7, 27), (27, ntiles)]
            parts = [(uvals[a:b].clone(), ubidx[a:b].clone()) for a, b in reversed(cuts)][::-1]
            for x in (x64.float(), x64):
                if not torch.equal(tmv.tile_matvec_sharded(parts, x, device), tmv.tile_matvec(uvals, ubidx, x)):
                    raise SystemExit(f"FAILED tile_matvec_sharded, BU = {bu} in 3 parts of their own: differs "
                                     f"from one tile_matvec launch ({x.dtype})")
            print(f"  tile_matvec_sharded, BU = {bu}, 3 parts of their own in one launch: equal to the last bit to "
                  "one tile_matvec launch on the whole pack, f32 and f64 vectors -> ok")


def random_row_blocks(device, seed=3, nrows=203, nslots=45, nb=50):
    """A ragged row layout: row r uses a random number of its slots, the rest
    are pad slots. 203 rows and 45 slots divide by neither the kernel's 8
    rows a thread block nor its 32 and 8 slots a step."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    bvals = torch.randn(nrows, nslots, 128, generator=g)
    bidx = torch.randint(0, nb, (nrows, nslots), generator=g, dtype=torch.int32)
    widths = torch.randint(1, nslots + 1, (nrows,), generator=g)
    pad = torch.arange(nslots)[None, :] >= widths[:, None]
    bvals[pad] = 0.0
    bidx[pad] = 0
    x = torch.randn(nb * 128, generator=g, dtype=torch.float64)
    return bvals.to(device), bidx.to(device), x.to(device), (int(widths.min()), int(widths.max()))


def block_model(nx, ny, nz):
    """Two blocks: 250 kg/m^3 (a susceptibility of 0.05 SI) and 100 kg/m^3
    (0.02 SI) in a background of 0."""
    m = np.zeros((nz, ny, nx))
    m[nz // 8 : nz // 2, ny // 4 : ny // 2, nx // 4 : nx // 2] = 250.0
    m[nz // 4 : 3 * nz // 4, ny // 2 : 7 * ny // 8, nx // 2 : 7 * nx // 8] = 100.0
    return m


def write_table(path, header, table, fmt):
    """A header line, then the table: the port's native writer, whose files
    are np.savetxt's byte for byte (phase 18 holds it to that)."""
    from tomofastx_tpu_torch.io.tableio import save_table

    save_table(path, table, fmt=fmt, header=str(header))
    return path


def write_inputs(work, nx, ny, nz, ndata_side, height=1.0, variants=()):
    """Grid, observation points `height` m above the cell centers of a
    ndata_side^2 sub-lattice and a three-lithology block model. Returns what
    the Parfile has to name. `variants` adds the inputs of other kinds:
    "mag" (susceptibility and magnetization-vector models of the same
    blocks), "components" (observation files of 3 and 6 value columns),
    "borehole" (every other observation inside a cell, off every face),
    "draped" (the same points at heights that vary from point to point:
    no BTTB geometry, data_draped), "topography" (the grid with its top
    layer's upper faces following a surface per column: no lattice,
    grid_topo)."""
    # Cells longer in x than in y: on square cells an observation above the
    # grid's diagonal sees equal wavelet coefficients in mirrored pairs, and
    # which of a pair survives the threshold would hang on the last bit.
    h = (100.0, 80.0, 50.0)
    k, j, i = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    i, j, k = i.reshape(-1), j.reshape(-1), k.reshape(-1)
    table = np.column_stack(
        [i * h[0], (i + 1) * h[0], j * h[1], (j + 1) * h[1], k * h[2], (k + 1) * h[2], i + 1, j + 1, k + 1]
    )
    grid_fmt = "%.3f %.3f %.3f %.3f %.3f %.3f %d %d %d"
    grid_path = write_table(os.path.join(work, "grid.txt"), nx * ny * nz, table, grid_fmt)
    if "topography" in variants:
        topo = table.copy()
        top = k == 0
        topo[top, 4] += 0.2 * h[2] * (1.5 + np.sin(0.7 * i[top] + 1.3 * j[top]))  # 5 to 25 m of the top layer
        write_table(os.path.join(work, "grid_topo.txt"), nx * ny * nz, topo, grid_fmt)

    step = nx // ndata_side
    jj, ii = np.meshgrid(np.arange(0, ny, step), np.arange(0, nx, step), indexing="ij")
    X = (ii.reshape(-1) + 0.5) * h[0]
    Y = (jj.reshape(-1) + 0.5) * h[1]
    Z = np.full(X.size, -height)

    def data_file(name, x, y, z, ncomp=1):
        return write_table(os.path.join(work, name), X.size, np.column_stack([x, y, z] + [np.zeros(X.size)] * ncomp),
                           "%.3f")

    m = block_model(nx, ny, nz)
    inputs = dict(size=(nx, ny, nz), ndata=X.size, grid=grid_path, data=data_file("data.txt", X, Y, Z),
                  synth=write_table(os.path.join(work, "synth.txt"), m.size, m.reshape(-1, 1), "%.9E"))
    if "mag" in variants:
        k = m.reshape(-1, 1) / 5000.0
        inputs["synth_mag"] = write_table(os.path.join(work, "synth_mag.txt"), m.size, k, "%.9E")
        inputs["synth_mag3"] = write_table(os.path.join(work, "synth_mag3.txt"), m.size,
                                           np.column_stack([0.2 * k, 0.3 * k, k]), "%.9E")
    if "components" in variants:
        for ncomp in (3, 6):
            inputs[f"data{ncomp}"] = data_file(f"data{ncomp}.txt", X, Y, Z, ncomp)
    if "draped" in variants:
        zdrape = -height - 30.0 * (0.5 + 0.5 * np.sin(0.013 * X + 0.021 * Y))
        inputs["data_draped"] = data_file("data_draped.txt", X, Y, zdrape)
    if "topography" in variants:
        inputs["grid_topo"] = os.path.join(work, "grid_topo.txt")
    if "borehole" in variants:
        zb = Z.copy()
        zb[1::2] = 60.0 + (7.3 * np.arange(X.size // 2)) % (nz * h[2] - 120.0)
        if np.any(np.isclose(zb[1::2] % h[2], 0.0)):
            raise SystemExit("FAILED inputs: a borehole observation on a cell face")
        inputs["data_borehole"] = data_file("data_borehole.txt", X + 13.0, Y + 11.0, zb)
    return inputs


# The magnetic problem of every kind: TMI of a 50000 nT field at inclination
# 60 and declination 10 degrees, depth weighting type 2 with power 3 (the
# magnetic default), and 3-lithology ADMM bounds on the susceptibility (on Mz
# for the magnetization vector). Alone it is solved with problem weight 1;
# beside gravity with 1e-8, which puts the rows of the two problems on one
# scale (tests/test_torch_joint.py).
MAG_LINES = """forward.data.magn.nData = {ndata}
forward.data.magn.dataGridFile = {data}
forward.data.magn.useSyntheticModelForDataValues = 1
forward.data.magn.syntheticModelFile = {synth}
forward.magneticField.inclination = 60
forward.magneticField.declination = 10
forward.magneticField.intensity_nT = 50000
forward.depthWeighting.magn.power = 3
inversion.admm.magn.bounds = -0.002 0.002 0.018 0.022 0.048 0.052
inversion.admm.magn.weight = 1.d-2
"""
# kind: (magnetic lines?, the magnetic problem's data and model files, lines of its own)
KIND_LINES = {
    "grav": (False, None, []),
    "gzz": (False, None, ["forward.data.grav.type = 2"]),
    # An FTG row is about a hundredth of a g_z row, so the gravity runs' ADMM
    # weight over 100 pulls as hard against the data. With 1e-7 the third
    # major's data cost rises above the second's, in the JAX package too
    # (tests/test_torch_smoke_problems.py).
    "ftg": (False, None, ["forward.data.grav.type = 2", "forward.data.grav.nDataComponents = 6",
                          "inversion.admm.grav.weight = 1.d-9"]),
    "tmi": (True, ("data", "synth_mag"), ["inversion.joint.grav.problemWeight = 0",
                                          "inversion.joint.magn.problemWeight = 1", "inversion.modelDamping.magn.weight = 1.d2"]),
    "mag3": (True, ("data3", "synth_mag"), ["inversion.joint.grav.problemWeight = 0",
                                            "inversion.joint.magn.problemWeight = 1", "forward.data.magn.nDataComponents = 3",
                                            "inversion.modelDamping.magn.weight = 1.d2"]),
    "mvi": (True, ("data", "synth_mag3"), ["inversion.joint.grav.problemWeight = 0",
                                           "inversion.joint.magn.problemWeight = 1", "modelGrid.magn.nModelComponents = 3",
                                           "inversion.modelDamping.magn.weight = 1.d2"]),
    "borehole": (True, ("data_borehole", "synth_mag"), ["inversion.joint.grav.problemWeight = 0",
                                                        "inversion.joint.magn.problemWeight = 1",
                                                        "inversion.modelDamping.magn.weight = 1.d2"]),
    "joint": (True, ("data", "synth_mag"), ["inversion.joint.magn.problemWeight = 1.d-8",
                                            "inversion.modelDamping.magn.weight = 1.d-11"]),
}
# The output prefix and the costs.txt data-cost column of each problem.
PROBLEMS = {"grav": ("grav", 1), "mag": ("mag", 2)}


def kind_problems(kind):
    return ["mag"] if kind in ("tmi", "mag3", "mvi", "borehole") else ["grav", "mag"] if kind == "joint" else ["grav"]


def write_parfile(work, name, inputs, out_dir, n_minor, fmt="tiled", compression=1, extra=(), kind="grav",
                  n_major=N_MAJOR):
    """The Parfile of one run of `kind` (KIND_LINES) on `inputs`. fmt = None
    leaves the tpu.kernelFormat line out, which means the default format."""
    nx, ny, nz = inputs["size"]
    mag, files, own = KIND_LINES[kind]
    data_grav = inputs["data6"] if kind == "ftg" else inputs["data"]
    parfile = os.path.join(work, name)
    with open(parfile, "w") as f:
        f.write(f"""global.outputFolderPath = {out_dir}/
global.description = synthetic {kind} problem of the smoke run
modelGrid.size = {nx} {ny} {nz}
modelGrid.grav.file = {inputs["grid"]}
modelGrid.magn.file = {inputs["grid"]}
forward.data.grav.nData = {inputs["ndata"]}
forward.data.grav.dataGridFile = {data_grav}
forward.data.grav.useSyntheticModelForDataValues = 1
forward.data.grav.syntheticModelFile = {inputs["synth"]}
forward.depthWeighting.type = 2
forward.matrixCompression.type = {compression}
forward.matrixCompression.rate = 0.15
inversion.nMajorIterations = {n_major}
inversion.nMinorIterations = {n_minor}
inversion.modelDamping.grav.weight = 1.d-11
inversion.admm.enableADMM = 1
inversion.admm.nLithologies = 3
inversion.admm.grav.bounds = -10 10 90 110 240 260
inversion.admm.grav.weight = 1.d-7
""")
        if mag:
            f.write(MAG_LINES.format(ndata=inputs["ndata"], data=inputs[files[0]], synth=inputs[files[1]]))
        for line in own + ([f"tpu.kernelFormat = {fmt}"] if fmt else []) + list(extra):
            f.write(line + "\n")
    return parfile


def read_costs(path):
    with open(path) as f:
        return [[float(t) for t in ln.split()] for ln in f if not ln.startswith("#")]


def run_main_path(cli, counters, name, parfile, out_dir, must_say, sensit_written=True, mesh=None, kind="grav",
                  what=f"{NDATA} observations", depth=(N_MAJOR, N_MINOR), ncells=NX * NY * NZ,
                  compression="Haar rate 0.15", args=()):
    """One run of the command-line entry point on the card (with --mesh
    `mesh` when given, and the further command-line `args`), with every
    kernel's count set to 0 just before and read just after; then the checks
    of its log and its outputs, for every problem of `kind`. depth: the
    Parfile's (majors, minors). Returns what the run left to report."""
    n_major, n_minor = depth
    print(f"{name} main path: {what} x {ncells} cells, {compression}, "
          f"{n_major} majors x {n_minor} minors, f32 solve on cuda" + (f", --mesh {mesh}" if mesh else "")
          + (f", {' '.join(args)}" if args else ""))
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated() / 1e9
    tee = Tee(sys.stdout)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    with contextlib.redirect_stdout(tee):
        rc = cli.main(["-p", parfile, "--device", "cuda"] + (["--mesh", mesh] if mesh else []) + list(args))
    torch.cuda.synchronize()
    run = {"main_path_s": time.time() - t0, "launches": {k: fn.launches for k, fn in counters.items()}}
    if rc != 0:
        raise SystemExit(f"FAILED {name} main path: cli.main returned {rc}")
    log = tee.kept.getvalue()
    run["peak_device_GB"] = torch.cuda.max_memory_allocated() / 1e9
    run["held_before_GB"] = held_before

    run["lsqr_iterations"] = [int(v) for v in re.findall(r"lsqr iters = (\d+)", log)]
    run["major_s"] = [float(v) for v in re.findall(r"iter done in ([0-9.]+)s", log)]
    # --fused M: a line a chunk, and one a capture of the major's CUDA graph.
    run["chunks"] = [(int(n), float(s)) for n, s, its in re.findall(
        r"fused (\d+) iterations in ([0-9.]+)s, lsqr iters = \[([0-9, ]+)\]", log)]
    run["lsqr_iterations"] += [int(v) for its in re.findall(r"fused \d+ iterations in [0-9.]+s, lsqr iters = "
                                                           r"\[([0-9, ]+)\]", log) for v in its.split(",")]
    run["captures_s"] = [float(v) for v in re.findall(r"fused major captured as a CUDA graph in ([0-9.]+)s", log)]
    run["lsqr_body_runs"] = [int(v) for its in re.findall(r"LSQR body runs = \[([0-9, ]+)\]", log)
                             for v in its.split(",")]
    run["builds_s"] = [float(v) for v in re.findall(r"kernel built(?:\+cached)? in ([0-9.]+)s", log)]
    run["packs_s"] = [float(v) for v in re.findall(r"cache packed into [a-z ]+ in ([0-9.]+)s", log)]
    run["row_weights_s"] = [float(v) for v in re.findall(r"row weights applied on \S+ in ([0-9.]+)s", log)]
    for key, pattern in must_say.items():
        m = re.search(pattern, log)
        if not m:
            raise SystemExit(f"FAILED {name} main path: the log lacks the line of {key} ({pattern})")
        if m.groups():
            run[key] = float(m.group(1))
    if run["lsqr_iterations"] != [n_minor] * n_major:
        raise SystemExit(f"FAILED {name} main path: LSQR iterations {run['lsqr_iterations']}")
    said = [f"{k} = {run[k]}" for k in must_say if k in run] + [f"builds {run['builds_s']} s", f"packs {run['packs_s']} s"]
    print(f"  {name} main path took {run['main_path_s']:.1f} s: " + ", ".join(said)
          + (f", chunks (majors, s) {run['chunks']}, captures {run['captures_s']} s" if run["chunks"] else "")
          + f", majors {run['major_s']} s; peak device memory {run['peak_device_GB']:.2f} GB "
          f"({held_before:.2f} GB held before the run); "
          f"launches {run['launches']}")

    run.update(check_outputs(name, out_dir, kind, ncells, sensit_written, n_major))
    return run


def check_outputs(name, out_dir, kind, ncells, sensit_written=True, n_major=N_MAJOR):
    """costs.txt (every active problem's data cost falls from major to
    major), the output files and each final model of a run of `kind`.
    Returns {"data_costs", "models"} by problem, and "data_cost" and "model"
    of the first problem."""
    from tomofastx_tpu_torch.io import model_io

    costs = read_costs(os.path.join(out_dir, "costs.txt"))
    if len(costs) != n_major + 1 or not all(np.isfinite(v) for row in costs for v in row):
        raise SystemExit(f"FAILED {name} outputs: costs.txt")
    out = {"data_costs": {}, "models": {}}
    for p in kind_problems(kind):
        prefix, col = PROBLEMS[p]
        cost = out["data_costs"][p] = [row[col] for row in costs]
        print(f"  {p} data cost per major = {cost}")
        if not all(b < a for a, b in zip(cost[:-1], cost[1:])):
            raise SystemExit(f"FAILED {name} outputs: the {p} data cost does not fall")
        files = ["Parfile_run.txt", f"model/{prefix}_final_model_full.txt", f"data/{prefix}_final.txt",
                 f"data/{prefix}_observed.txt", f"Paraview/{prefix}_final_model3D_full.vtk",
                 f"Paraview/data_{prefix}_final.vtk"]
        if sensit_written:
            sfx = "magn" if p == "mag" else "grav"
            files += [f"SENSIT/sensit_{sfx}_1_0", f"SENSIT/sensit_{sfx}_meta.txt"]
        for f in files:
            if not os.path.getsize(os.path.join(out_dir, f)) > 0:
                raise SystemExit(f"FAILED {name} outputs: {f}")
        ncomp = 3 if kind == "mvi" else 1
        model = model_io.read_model_values(os.path.join(out_dir, f"model/{prefix}_final_model_full.txt"), ncells, ncomp)
        least = 1.0 if p == "grav" else 1e-4  # a density in kg/m^3, a susceptibility in SI
        if model.shape != (ncomp, ncells) or not np.isfinite(model).all() or not np.abs(model).max() > least:
            raise SystemExit(f"FAILED {name} outputs: final {p} model")
        print(f"  final {p} model {model.shape}: min {model.min():.6g}, max {model.max():.6g} -> ok")
        out["models"][p] = model
    first = kind_problems(kind)[0]
    out["data_cost"], out["model"] = out["data_costs"][first], out["models"][first]
    return out


def formats_apart(name, run, ref, hold=True):
    """Two runs of one kind in two formats, problem by problem: final model
    and final data cost held to the formats' tolerance (hold=False: read
    only). Returns the spread."""
    out = {}
    for p, r in ref["models"].items():
        m = run["models"][p]
        dm = float(np.abs(m - r).max() / (r.max() - r.min()))
        c, cr = run["data_costs"][p][-1], ref["data_costs"][p][-1]
        dc = abs(c - cr) / cr
        out[p] = {"model_of_range": dm, "data_cost_rel": dc}
        print(f"  {name}, {p}: final model differs by {dm:.3e} of its range ("
              + (f"tolerance {FORMATS_MODEL_TOL:g}" if hold else "a reading, not held") + f"), final "
              f"data cost {c:.9e} against {cr:.9e}, relative {dc:.3e}"
              + (f" (tolerance {FORMATS_COST_RTOL:g})" if hold else ""))
        if hold and (not dm <= FORMATS_MODEL_TOL or not dc <= FORMATS_COST_RTOL):
            raise SystemExit(f"FAILED {name} ({p})")
    return out


def same_bytes(a, b) -> bool:
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


def hold_equal(name, run, out_dir, ref, ref_dir, against="the unmeshed run"):
    """A run against another of the same format whose outputs the code
    promises equal to the last bit: the same kernels on the same operands in
    the same order. If they differ, say where the two runs part (the cache
    their builds wrote, or only the solve) and hold them at the formats'
    tolerance."""
    files = ("costs.txt", "model/grav_final_model_full.txt", "data/grav_final.txt")
    equal = {f: same_bytes(os.path.join(out_dir, f), os.path.join(ref_dir, f)) for f in files}
    m, r = run["model"], ref["model"]
    out = {
        "equal_to_the_last_bit": all(equal.values()), "files_equal": equal,
        "model_of_range": float(np.abs(m - r).max() / (r.max() - r.min())),
        "data_cost_rel": abs(run["data_cost"][-1] - ref["data_cost"][-1]) / ref["data_cost"][-1],
    }
    if out["equal_to_the_last_bit"]:
        print(f"  {name} against {against}: {', '.join(files)} equal to the last bit -> ok")
        return out
    cache = [os.path.join(d, "SENSIT", "sensit_grav_1_0") for d in (out_dir, ref_dir)]
    if all(os.path.exists(c) for c in cache):
        out["caches_equal"] = same_bytes(*cache)
        where = "equal: the solves part" if out["caches_equal"] else "not equal: the builds part"
    else:
        where = "not both written (a run from a cache)"
    print(f"  {name} against {against}: NOT equal to the last bit ({equal}); the caches the two "
          f"builds wrote are {where}; "
          f"final model differs by {out['model_of_range']:.3e} of its range (tolerance {FORMATS_MODEL_TOL:g}), "
          f"final data cost by {out['data_cost_rel']:.3e} relative (tolerance {FORMATS_COST_RTOL:g})")
    if not out["model_of_range"] <= FORMATS_MODEL_TOL or not out["data_cost_rel"] <= FORMATS_COST_RTOL:
        raise SystemExit(f"FAILED {name}: against {against}")
    return out


def solve_from_cache(work, name, inputs, cache_dir, fmt, mesh, counters, kind="grav", extra=()):
    """One solve_problem_joint_gravmag of `kind` on the card from a
    sensitivity cache, over `mesh` (None: unmeshed), with every kernel's
    count set to 0 just before and read just after."""
    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag

    out_dir = os.path.join(work, f"out_{name}")
    pf = write_parfile(work, f"Parfile_{name}.txt", inputs, out_dir, N_MINOR, fmt=fmt, kind=kind,
                       extra=["sensit.readFromFiles = 1", f"sensit.folderPath = {cache_dir}/"] + list(extra))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    res = solve_problem_joint_gravmag(read_parfile(pf), verbose=False, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    run = {
        "s": time.time() - t0, "launches": {k: fn.launches for k, fn in counters.items()},
        "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9,
        "shard_s": res.timings.get("shard_s"), "solve_s": res.timings["solve_s"],
        "pack_s": res.timings.get("pack_s"), "cache_read_s": res.timings.get("cache_read_s"),
        "row_weights_s": res.timings["row_weights_s"],
        "lsqr_iterations": res.timings["lsqr_iters"],
        "data_cost": [row[1] for row in read_costs(os.path.join(out_dir, "costs.txt"))],
        "model": np.asarray(res.models[min(res.models)].val), "out_dir": out_dir,
        "models": {i: np.asarray(m.val) for i, m in res.models.items()},
    }
    if run["lsqr_iterations"] != [N_MINOR] * N_MAJOR or not all(np.isfinite(m).all() for m in run["models"].values()):
        raise SystemExit(f"FAILED {name}: LSQR iterations {run['lsqr_iterations']} or a non-finite model")
    where = "unmeshed" if mesh is None else f"over {mesh}"
    print(f"  {name} ({fmt or 'dense'}, {where}): {run['s']:.1f} s, pack_s {run['pack_s']}, cache_read_s "
          f"{run['cache_read_s']}, row_weights_s {run['row_weights_s']}, shard_s {run['shard_s']}, majors' solves "
          f"{[round(v, 3) for v in run['solve_s']]} s, data cost per major {run['data_cost']}, peak device "
          f"memory {run['peak_device_GB']:.2f} GB, launches {run['launches']}")
    return run


def solve_small(pf, dev, mesh=None, solve_kw=None):
    """One float64 solve of a small problem's Parfile `pf` on `dev` (over
    `mesh` when given): {"models": {problem: final model}, "cost_data":
    {problem: data cost}, "s": seconds, "log": what it printed}. A worker of
    start_cpu_pool runs it too."""
    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag

    log = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(log):
        res = solve_problem_joint_gravmag(read_parfile(pf), solve_dtype=torch.float64, device=dev, mesh=mesh,
                                          **(solve_kw or {}))
    return {"models": {i: np.asarray(m.val) for i, m in res.models.items()},
            "cost_data": {i: float(res.cost_data[i]) for i in res.models}, "s": time.time() - t0,
            "log": log.getvalue()}


# Phase 23's CPU solves run in CPU_POOL_WORKERS processes of CPU_POOL_THREADS
# threads each, from phase 5 on, beside the card's phases: on an H100 machine's
# host the per-cell borehole problem's CPU solve alone took 8.6-23.5 s for 10
# LSQR iterations (PERF.md).
CPU_POOL_WORKERS, CPU_POOL_THREADS = 2, 2


def _cpu_worker(threads):
    torch.set_num_threads(threads)


def start_cpu_pool():
    """The worker processes of the CPU solves (spawned: this process holds a
    CUDA context); main() terminates them on its way out."""
    import multiprocessing

    return multiprocessing.get_context("spawn").Pool(CPU_POOL_WORKERS, initializer=_cpu_worker,
                                                     initargs=(CPU_POOL_THREADS,))


def small_problem_card_against_cpu(work, name, what, kind="grav", coupling=None, swap=None, mesh=None,
                                   operator=None, solve_kw=None, model_tol=1e-6, n_minor=10, counted=None,
                                   cpu_pool=None, **parfile_args):
    """A small problem of `kind` on the card (float64 solve, so the float64
    variants of the kernels and products carry it) against the same problem
    on the CPU: every active problem's final model within 1e-6 of its range,
    its data cost within 1e-6. coupling(dir, inputs) adds Parfile lines (and
    the files they name) after the inputs are written; swap maps an input
    to another of write_inputs' (e.g. {"data": "data_draped"}); mesh is the
    card run's (a Mesh of the card's slots); operator, the matrix-free class
    both runs must log; solve_kw, further arguments of both solves (the
    build's precision or its float64 near field); model_tol, the model's
    tolerance (of its range) where it is not 1e-6; counted, the kernels
    (name: wrapper) that the card run must launch, counted in that run.
    With cpu_pool (start_cpu_pool) the CPU solve starts there at once and
    this returns a function that runs the card's and compares when called;
    else it does both now."""
    small = os.path.join(work, name)
    os.makedirs(small)
    inputs = write_inputs(small, 16, 16, 8, 8, variants=("mag", "components", "borehole", "draped", "topography"))
    inputs.update({k: inputs[v] for k, v in (swap or {}).items()})
    if coupling is not None:
        parfile_args["extra"] = list(parfile_args.get("extra", ())) + coupling(small, inputs)
    pfs = {dev: write_parfile(small, f"Parfile_{dev}.txt", inputs, os.path.join(small, f"out_{dev}"), n_minor,
                              kind=kind, **parfile_args) for dev in ("cpu", "cuda")}
    cpu = None if cpu_pool is None else cpu_pool.apply_async(solve_small, (pfs["cpu"], "cpu", None, solve_kw))

    def finish():
        res = {"cpu": solve_small(pfs["cpu"], "cpu", None, solve_kw) if cpu is None else cpu.get()}
        for fn in (counted or {}).values():
            fn.launches = 0
        res["cuda"] = solve_small(pfs["cuda"], "cuda", mesh, solve_kw)
        if counted:
            launches = {k: fn.launches for k, fn in counted.items()}
            print(f"  small problem ({what}): launches on the card {launches}")
            if not all(launches.values()):
                raise SystemExit(f"FAILED small problem ({what}): a kernel of its path was not launched")
        for dev, r in res.items():
            if operator is not None and f"kernel: matrix-free ({operator}," not in r["log"]:
                raise SystemExit(f"FAILED small problem ({what}): the {dev} run did not take {operator}")
        worst = 0.0
        for i in res["cpu"]["models"]:
            a, b = res["cpu"]["models"][i], res["cuda"]["models"][i]
            rel = float(np.abs(a - b).max() / (a.max() - a.min()))
            ca, cb = res["cpu"]["cost_data"][i], res["cuda"]["cost_data"][i]
            print(f"  small problem ({what}, {('grav', 'mag')[i]}; 16x16x8 cells, 64 observations, "
                  f"{parfile_args.get('n_major', N_MAJOR)} x {n_minor}, f64 solve), card "
                  f"against CPU: final model {a.shape} differs by {rel:.3e} of its range, data cost {cb:.6e} against "
                  f"{ca:.6e} (tolerance {model_tol:g} of the range for the model, 1e-6 for the cost; the CPU solve "
                  f"{res['cpu']['s']:.1f} s" + (" in a worker process" if cpu is not None else "")
                  + f", the card's {res['cuda']['s']:.1f} s)")
            if not rel <= model_tol or not abs(cb - ca) <= 1e-6 or not cb < 1.0:
                raise SystemExit(f"FAILED small problem ({what}): card against CPU")
            worst = max(worst, rel)
        return worst

    return finish() if cpu is None else finish


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


def seeded_vector(n_in, seed, device):
    """A float64 normal vector of n_in entries, zero-padded to whole 128-blocks."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.zeros(-(-n_in // 128) * 128, dtype=torch.float64)
    x[:n_in] = torch.randn(n_in, generator=g, dtype=torch.float64)
    return x.to(device)


def measure_layout(kernel, plain, name, vals, idx, nout, x64, dense):
    """One kernel against its plain version on one full-width layout (vals,
    idx), both vector types, and the times of the kernel, the plain version
    and, where `dense` holds the same matrix, torch.mv on it."""
    x32 = x64.float()
    err32 = compare(f"full width {name}, f32 vector", kernel(vals, idx, x32), plain(vals, idx, x32), RTOL_F32)
    err64 = compare(f"full width {name}, f64 vector", kernel(vals, idx, x64), plain(vals, idx, x64), RTOL_F64)

    ms = time_cuda(lambda: kernel(vals, idx, x32), calls=BACK_TO_BACK)
    ms64 = time_cuda(lambda: kernel(vals, idx, x64), reps=10, calls=BACK_TO_BACK)
    plain_ms = time_cuda(lambda: plain(vals, idx, x32), warm=1, reps=5)

    library_ms, library_said = None, "no one library call computes this layout's product"
    if dense is not None:
        mv_err = float((dense @ x32 - kernel(vals, idx, x32)[: dense.shape[0]]).abs().max())
        library_ms = time_cuda(lambda: torch.mv(dense, x32), calls=BACK_TO_BACK)
        library_said = (f"torch.mv on the dense {tuple(dense.shape)} f32 matrix {library_ms:.3f} ms "
                        f"(|kernel - mv| max {mv_err:.3e})")

    nbytes = (vals.numel() + idx.numel() + x32.numel() + nout) * 4
    flops = 2 * vals.numel()
    bound_ms, bound_by, by_bytes, by_ops = bound(nbytes, flops)
    print(f"  {name} {tuple(vals.shape)}: kernel {ms:.3f} ms "
          f"({nbytes / ms / 1e6:.0f} GB/s of {nbytes / 1e9:.3f} GB; f64 vector {ms64:.3f} ms), "
          f"bound {bound_ms:.3f} ms by {bound_by} "
          f"(bytes {by_bytes:.3f} ms at {MEMORY_BYTES_PER_S / 1e12:.2f} TB/s, "
          f"operations {by_ops:.3f} ms at {FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s), "
          f"plain {plain_ms:.3f} ms, {library_said}")
    return {
        "ms": ms, "ms_f64_vector": ms64, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "max_abs_err": err32, "max_abs_err_f64_vector": err64, "bytes": nbytes, "flops": flops,
        "achieved_GB_per_s": nbytes / ms / 1e6, "shape": list(vals.shape),
    }


def measure_pack(tmv, name, uvals, ubidx, n_in, seed, parts):
    """tile_matvec on one full-width pack, with torch.mv on the pack's dense
    matrix; then tile_matvec_sharded on `parts`, the same pack cut over the
    slots of a mesh."""
    x64 = seeded_vector(n_in, seed, uvals.device)
    dense = dense_from_pack(uvals, ubidx, x64.shape[0])
    out = measure_layout(tmv.tile_matvec, tmv.tile_matvec_plain, f"{name} pack", uvals, ubidx,
                         ubidx.shape[0] * 8, x64, dense)
    out["sharded"] = measure_sharded(tmv, f"{name} pack", uvals, ubidx, parts, x64, dense)
    del dense
    torch.cuda.empty_cache()
    return out


def measure_sharded(tmv, name, uvals, ubidx, parts, x64, dense):
    """tile_matvec_sharded on the parts of one full-width pack: equal to the
    last bit to one tile_matvec launch on the whole pack, against its plain
    version, and its time beside the whole pack's launch, the plain version
    and torch.mv on the dense matrix. The parts share the card, so one
    launch reads x where it lies and writes each part's rows into the
    output: its bound is tile_matvec's bytes."""
    sharded, plain = tmv.tile_matvec_sharded, tmv.tile_matvec_sharded_plain
    home, n, x32 = uvals.device, len(parts), x64.float()
    for x in (x32, x64):
        if not torch.equal(sharded(parts, x, home), tmv.tile_matvec(uvals, ubidx, x)):
            raise SystemExit(f"FAILED {name}, {n} slots: sharded product differs from one tile_matvec launch ({x.dtype})")
    print(f"  {name}, {n} slots: tile_matvec_sharded equal to the last bit to one tile_matvec launch on the "
          "whole pack, f32 and f64 vectors -> ok")
    err32 = compare(f"{name}, {n} slots, f32 vector, against tile_matvec_sharded_plain",
                    sharded(parts, x32, home), plain(parts, x32, home), RTOL_F32)
    err64 = compare(f"{name}, {n} slots, f64 vector, against tile_matvec_sharded_plain",
                    sharded(parts, x64, home), plain(parts, x64, home), RTOL_F64)

    # In turns, on one card: sharded, whole, sharded.
    ms = time_cuda(lambda: sharded(parts, x32, home), calls=BACK_TO_BACK)
    whole_ms = time_cuda(lambda: tmv.tile_matvec(uvals, ubidx, x32), calls=BACK_TO_BACK)
    ms_again = time_cuda(lambda: sharded(parts, x32, home), calls=BACK_TO_BACK)
    ms64 = time_cuda(lambda: sharded(parts, x64, home), reps=10, calls=BACK_TO_BACK)
    plain_ms = time_cuda(lambda: plain(parts, x32, home), warm=1, reps=5)
    library_ms = time_cuda(lambda: torch.mv(dense, x32), calls=BACK_TO_BACK)

    nout = ubidx.shape[0] * 8
    nbytes = (uvals.numel() + ubidx.numel() + x32.numel() + nout) * 4
    flops = 2 * uvals.numel()
    bound_ms, bound_by, by_bytes, by_ops = bound(nbytes, flops)
    print(f"  {name}, {n} slots: tile_matvec_sharded {ms:.3f} ms (again {ms_again:.3f}; f64 vector {ms64:.3f}), "
          f"one tile_matvec on the whole pack {whole_ms:.3f} ms, plain {plain_ms:.3f} ms, torch.mv on the dense "
          f"matrix {library_ms:.3f} ms; bytes {nbytes / 1e9:.3f} GB (tile_matvec's), bound "
          f"{bound_ms:.3f} ms by {bound_by} (bytes {by_bytes:.3f} ms at {MEMORY_BYTES_PER_S / 1e12:.2f} TB/s, "
          f"operations {by_ops:.3f} ms at {FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s)")
    return {
        "slots": n, "ms": ms, "ms_again": ms_again, "ms_f64_vector": ms64, "whole_pack_ms": whole_ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "max_abs_err": err32, "max_abs_err_f64_vector": err64, "bytes": nbytes, "flops": flops,
        "part_shapes": [list(p[0].shape) for p in parts],
    }


def row_blocks_all_used(S):
    """Row-block layout of a dense (nrows, NB * 128) matrix that keeps every
    128-block a row uses, ascending; rows with fewer blocks are padded with
    block 0 and zeros. The JAX package has no packer for this layout."""
    nrows, ncols = S.shape
    Sb = S.view(nrows, ncols // 128, 128)
    used = torch.linalg.vector_norm(Sb, ord=float("inf"), dim=2) > 0
    counts = used.sum(dim=1)
    width = max(1, int(counts.max()))
    # Stable argsort of ~used puts each row's used block ids first, ascending.
    order = torch.argsort((~used).to(torch.uint8), dim=1, stable=True)[:, :width]
    live = torch.arange(width, device=S.device)[None, :] < counts[:, None]
    bvals = torch.gather(Sb, 1, order[:, :, None].expand(-1, -1, 128)).mul_(live[:, :, None])
    bidx = torch.where(live, order, 0).to(torch.int32).contiguous()
    return bvals, bidx, int(counts.min())


def row_blocks_top_energy(S, width):
    """Row-block layout that keeps each row's `width` blocks of largest
    energy (sum of squares), ascending by block id."""
    nrows, ncols = S.shape
    Sb = S.view(nrows, ncols // 128, 128)
    energy = torch.linalg.vector_norm(Sb, dim=2)
    order = torch.sort(torch.topk(energy, width, dim=1).indices, dim=1).values
    bvals = torch.gather(Sb, 1, order[:, :, None].expand(-1, -1, 128))
    kept = float((bvals.double() ** 2).sum() / (energy.double() ** 2).sum())
    return bvals, order.to(torch.int32).contiguous(), kept


class RowBlocks:
    """A row-block layout behind the operators' `matvec` interface."""

    def __init__(self, blocked_matvec, bvals, bidx):
        self.blocked_matvec, self.bvals, self.bidx = blocked_matvec, bvals, bidx

    def matvec(self, x):
        return self.blocked_matvec(self.bvals, self.bidx, x)


# The coupled problem's mixture (inversion.clustering.mixtureFile): the
# background and the larger block, as (cluster weight, density mu1, s11,
# susceptibility mu2, s22, s12); s12^2 < s11 s22 keeps the 2-D Gaussian proper.
MIXTURE = ((1.0, 0.0, 50.0, 0.0, 0.01, 0.1), (1.0, 250.0, 50.0, 0.05, 0.01, 0.1))
# The steepest the synthetic models change over one cell: block_model's 250
# kg/m^3, and its susceptibility (a 5000th of it), over the shortest side.
SYNTH_RANGES = (250.0, 0.05)
# Each constraint row's largest coefficient against the data block's RMS
# column norm (coupling_weights).
ROW_SCALE = 0.1


def write_coupling_files(work, ncells, seed=31):
    """The coupled problem's files beside its inputs: the mixture, per-cell
    cluster weights (2 clusters), a vector field on the scale of the magnetic
    model's gradient (SI per m) and per-direction damping-gradient weights.
    Returns their paths."""
    rng = np.random.default_rng(seed)
    cw = rng.uniform(0.2, 1.0, (ncells, 2))
    files = {
        "mixture": write_table(os.path.join(work, "mixture.txt"), len(MIXTURE), np.array(MIXTURE), "%.9E"),
        "cell_weights": write_table(os.path.join(work, "cell_weights.txt"), f"{ncells} 2",
                                    cw / cw.sum(1, keepdims=True), "%.12E"),
        "vector_field": write_table(os.path.join(work, "vector_field.txt"), ncells,
                                    1e-5 * rng.normal(size=(ncells, 3)), "%.12E"),
    }
    for sfx in ("grav", "magn"):
        files[f"dgw_{sfx}"] = write_table(os.path.join(work, f"dgw_{sfx}.txt"), ncells,
                                          rng.uniform(0.5, 1.5, (ncells, 3)), "%.12E")
    return files


def coupling_weights(cache_dir, cfg):
    """The constraint weights of a joint problem by the row-scale rule, from
    its sensitivity cache: each constraint row's largest coefficient is at
    most ROW_SCALE x the RMS column norm of its problem's weighted data block
    (problem weight x ||S||_F / sqrt(N); the wavelet is orthonormal, so the
    model domain has the stored kernel's norm). The coefficients are bounded
    by the largest column weight cw and: for the damping gradient, problem
    weight x beta / the shortest cell side; for the cross-gradient, weight x
    the other model's steepest gradient (the synthetic model's range over
    the shortest side); for the clustering, weight x the mixture's largest
    derivative over the models' ranges. The data blocks then keep most of
    each column, so the data costs still fall, while every constraint's cost
    column (sums of squares of the models' own differences, of tau, and of
    the weighted mixture misfit) stays far above rounding. Returns the
    weights and the scales they came from."""
    from tomofastx_tpu_torch.io import model_io
    from tomofastx_tpu_torch.io.sensit_cache import iter_cache_rows, read_cache_meta

    pw = cfg.inversion.problem_weight
    rms, cw_max = [], []
    for i, (par, sfx) in enumerate(((cfg.grav, "grav"), (cfg.magn, "magn"))):
        grid = model_io.read_model_grid(par.model_grid_file, par.nx, par.ny, par.nz)
        meta = read_cache_meta(cache_dir, par, grid)
        ss = sum(float(np.dot(v.astype(np.float64), v)) for *_, v in iter_cache_rows(cache_dir, meta))
        rms.append(pw[i] * np.sqrt(ss / grid.nelements_total))
        cw_max.append(float(np.fromfile(os.path.join(cache_dir, f"sensit_{sfx}_weight"), np.float64, offset=4).max()))
    dmin = float(min(grid.dX().min(), grid.dY().min(), grid.dZ().min()))
    grad = [r / dmin for r in SYNTH_RANGES]
    deriv = [0.0, 0.0]
    for _, _, s11, _, s22, s12 in MIXTURE:
        det = abs(s12**4 - s11**2 * s22**2)
        deriv[0] = max(deriv[0], (s22**2 * SYNTH_RANGES[0] + s12**2 * SYNTH_RANGES[1]) / det)
        deriv[1] = max(deriv[1], (s12**2 * SYNTH_RANGES[0] + s11**2 * SYNTH_RANGES[1]) / det)
    target = [ROW_SCALE * r for r in rms]
    weights = {
        "beta": [target[i] * dmin / (pw[i] * cw_max[i]) for i in (0, 1)],
        "cross_gradient": min(target[0] / (cw_max[0] * grad[1]), target[1] / (cw_max[1] * grad[0])),
        "clustering": [target[i] / (cw_max[i] * deriv[i]) for i in (0, 1)],
    }
    scales = {"rms_column": rms, "cw_max": cw_max, "shortest_side": dmin, "gradient_bound": grad,
              "mixture_derivative_bound": deriv}
    return weights, scales


COUPLINGS = ("cross_gradient", "damping_gradient", "clustering")


def coupling_lines(weights, files, kinds=COUPLINGS, extra=()):
    """The Parfile lines of the coupled problem's constraints `kinds`, then
    `extra` (a later line of a key overrides an earlier one)."""
    lines = []
    if "cross_gradient" in kinds:
        lines += [f"inversion.crossGradient.weight = {weights['cross_gradient']:.6e}",
                  "inversion.crossGradient.derivativeType = 2"]
    if "damping_gradient" in kinds:
        lines += [f"inversion.dampingGradient.grav.weight = {weights['beta'][0]:.6e}",
                  f"inversion.dampingGradient.magn.weight = {weights['beta'][1]:.6e}"]
    if "clustering" in kinds:
        lines += [f"inversion.clustering.grav.weight = {weights['clustering'][0]:.6e}",
                  f"inversion.clustering.magn.weight = {weights['clustering'][1]:.6e}",
                  f"inversion.clustering.nClusters = {len(MIXTURE)}",
                  f"inversion.clustering.mixtureFile = {files['mixture']}",
                  "inversion.clustering.constraintsType = 1"]
    return lines + list(extra)


def check_coupled_outputs(name, out_dir, columns):
    """costs.txt columns 9-20 of every major finite, the constraint columns
    `columns` (1-based) > 0, and the coupling fields' VTK files written.
    Returns the constraint columns per major."""
    rows = read_costs(os.path.join(out_dir, "costs.txt"))[1:-1]
    got = {c: [row[c - 1] for row in rows] for c in range(9, 21)}
    if not all(np.isfinite(v) for vals in got.values() for v in vals):
        raise SystemExit(f"FAILED {name}: a non-finite cost in columns 9-20")
    if not all(v > 0.0 for c in columns for v in got[c]):
        raise SystemExit(f"FAILED {name}: a constraint cost column is not > 0: {got}")
    for field in ("cross_grad", "clustering"):
        f = os.path.join(out_dir, "Paraview", f"{field}_final_model3D_full.vtk")
        if not os.path.getsize(f) > 0:
            raise SystemExit(f"FAILED {name}: {f}")
    print(f"  {name}: costs.txt columns 9-20 finite, columns {columns[0]}-{columns[-1]} > 0 in every major "
          f"(cross-gradient x, y, z {[f'{v:.3e}' for v in got[16]]}, {[f'{v:.3e}' for v in got[17]]}, "
          f"{[f'{v:.3e}' for v in got[18]]}; clustering {[f'{v:.3e}' for v in got[19]]}, "
          f"{[f'{v:.3e}' for v in got[20]]}); both coupling VTK files written -> ok")
    return {str(c): v for c, v in got.items()}


@contextlib.contextmanager
def capturing_the_system(workflow):
    """workflow.make_solver wrapped so that the spec and the tensors of the
    last major's solve are kept, for timing its blocks after the run, and a
    host copy of every major's model updates ("deltas"), for holding two runs
    equal to the last bit. The solve itself is unchanged."""
    kept = {"deltas": []}
    orig = workflow.make_solver

    def make(spec):
        solve = orig(spec)

        def run(arrays):
            kept.update(spec=spec, arrays=arrays)
            out = solve(arrays)
            kept["deltas"].append([d.cpu() for d in out["delta"]])
            return out
        return run

    workflow.make_solver = make
    try:
        yield kept
    finally:
        workflow.make_solver = orig


# The idle seconds cuda_kernel_events leaves before and after fn() inside the
# profiler's window.
PROFILE_MARGIN_S = 0.1


def cuda_kernel_events(fn):
    """The names of the kernels fn() launches on the card, by torch.profiler
    (memory copies and sets left out), read from its raw results: making
    its FunctionEvents takes longer than the products of the lattice and
    per-cell operators themselves. A kernel run is one record: a record
    whose kernel, card, stream and start time another holds already is
    dropped, and counted in cuda_kernel_events.duplicates (one profile of a
    coupled major came back with 164 tile_matvec records for its 84 runs,
    and the next run of the same script with 84)."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        # The profiler drops the device events it places outside its
        # window, and a window that opened as fn() began to launch came back
        # short of fn's first kernels: idle margins on both sides of fn().
        time.sleep(PROFILE_MARGIN_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    runs = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.name().startswith(("Memcpy", "Memset")):
            key = (e.name(), e.device_index(), e.device_resource_id(), e.start_ns())
            cuda_kernel_events.duplicates += key in runs
            runs[key] = e.duration_ns()
    cuda_kernel_events.last = list(runs.items())  # (name, card, stream, start ns): duration ns
    return [key[0] for key in runs]


cuda_kernel_events.duplicates = 0


def time_blocks(spec, arrays):
    """Milliseconds of one LSQR iteration's products of the coupled system,
    block by block (CUDA events, median of 20), with the whole system's
    matvec and rmatvec beside them, and the kernels one iteration launches."""
    from tomofastx_tpu_torch.inversion import joint

    with torch.no_grad():
        system = joint.assemble_system(spec, arrays)
        seg, N, cube = spec.seg_size, spec.N, (spec.nz, spec.ny, spec.nx)
        dev, dt = system.b.device, system.b.dtype
        g = torch.Generator(device="cpu").manual_seed(11)
        x = torch.randn(len(spec.active) * seg, generator=g, dtype=torch.float64).to(dev, dt)
        u = torch.randn(system.b.numel(), generator=g, dtype=torch.float64).to(dev, dt)
        segs = [x[a * seg : (a + 1) * seg] for a in range(len(spec.active))]
        S, blocks = arrays["S"], system.blocks
        ms = {"system matvec": time_cuda(lambda: system.matvec(x)),
              "system rmatvec": time_cuda(lambda: system.rmatvec(u))}
        pos = 0
        for a, p in enumerate(("grav", "mag")):
            rows = spec.ndata_rows[a]
            ua, pos = u[pos : pos + rows], pos + rows
            xw, ga = joint._to_solver(spec, segs[a]), S[a].rmatvec(ua)
            ms[f"{p} operator matvec"] = time_cuda(lambda a=a, xw=xw: S[a].matvec(xw))
            ms[f"{p} operator rmatvec"] = time_cuda(lambda a=a, ua=ua: S[a].rmatvec(ua))
            ms[f"{p} _to_solver"] = time_cuda(lambda a=a: joint._to_solver(spec, segs[a]))
            ms[f"{p} _from_solver"] = time_cuda(lambda ga=ga: joint._from_solver(spec, ga))
            dg = [op for _, _, op in blocks["damping_gradient"].get(a, [])]
            if dg:
                ms[f"{p} damping gradient matvec"] = time_cuda(
                    lambda a=a, dg=dg: [op.matvec(segs[a].reshape(cube)) for op in dg])
                ms[f"{p} damping gradient rmatvec"] = time_cuda(lambda dg=dg: [op.rmatvec(u[:N]) for op in dg])
            for kind in ("damping", "admm", "clustering"):
                op = blocks[kind].get(a)
                if op is not None:
                    ms[f"{p} {kind} matvec and rmatvec"] = time_cuda(
                        lambda op=op, a=a: (op.dcoef * segs[a].reshape(op.dcoef.shape[-1:]), op.dcoef * u[:N]))
        xg = blocks["cross_gradient"]
        if xg is not None:
            ms["cross-gradient matvec"] = time_cuda(lambda: xg.matvec(segs[0].reshape(cube), segs[1].reshape(cube)))
            ms["cross-gradient rmatvec"] = time_cuda(lambda: xg.rmatvec(u[: 3 * N]))
        launches = {"system matvec + rmatvec": len(cuda_kernel_events(lambda: (system.matvec(x), system.rmatvec(u))))}
        if xg is not None:
            launches["cross-gradient matvec + rmatvec"] = len(cuda_kernel_events(
                lambda: (xg.matvec(segs[0].reshape(cube), segs[1].reshape(cube)), xg.rmatvec(u[: 3 * N]))))
    return ms, launches


def small_coupling(variant):
    """For small_problem_card_against_cpu: writes the coupled problem's files
    beside a small problem's inputs, runs the plain joint problem once on the
    CPU (0 majors: its cache only) for the weights of coupling_weights, and
    returns the Parfile lines of `variant`."""
    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag

    def lines(small, inputs):
        nx, ny, nz = inputs["size"]
        f = write_coupling_files(small, nx * ny * nz)
        probe = os.path.join(small, "out_probe")
        pf = write_parfile(small, "Parfile_probe.txt", inputs, probe, 10, kind="joint", fmt="dense",
                           extra=["inversion.nMajorIterations = 0"])
        solve_problem_joint_gravmag(read_parfile(pf), solve_dtype=torch.float64, verbose=False, device="cpu")
        weights, _ = coupling_weights(os.path.join(probe, "SENSIT"), read_parfile(pf))
        kinds, extra = {
            "cross_gradient_forward": (["cross_gradient"], ["inversion.crossGradient.derivativeType = 1"]),
            "cross_gradient_vector_field": (["cross_gradient"], [
                "inversion.crossGradient.vectorFieldType = 2",
                f"inversion.crossGradient.vectorFieldFile = {f['vector_field']}"]),
            "cross_gradient_grav_kept_constant": (["cross_gradient"],
                                                  ["inversion.crossGradient.grav.keepModelConstant = 1"]),
            "damping_gradient_weights_file": (["damping_gradient"], [
                "inversion.dampingGradient.weightType = 2",
                f"inversion.dampingGradient.grav.weightsFile = {f['dgw_grav']}",
                f"inversion.dampingGradient.magn.weightsFile = {f['dgw_magn']}"]),
            "clustering_normal_cell_weights": (["clustering"], [
                "inversion.clustering.optimizationType = 1", "inversion.clustering.constraintsType = 2",
                f"inversion.clustering.cellWeightsFile = {f['cell_weights']}"]),
            "clustering_log": (["clustering"], []),
            "read_from_files_2": (COUPLINGS, ["sensit.readFromFiles = 2", f"sensit.folderPath = {probe}/SENSIT/"]),
            "all_three": (COUPLINGS, []),
        }[variant]
        return coupling_lines(weights, f, kinds, extra)
    return lines


def jsonable(obj):
    """obj for json.dumps: runs without their models and output folders,
    numpy scalars as Python numbers."""
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items() if k not in ("model", "models", "sharded", "out_dir")}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def load_npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def phase_17(cli, counters, tmv, work):
    """Resume, --profile and --debug-nans of the command line on the card,
    on small problems (16 x 16 x 8 cells, 64 observations, f32 solve)."""
    late = os.path.join(work, "late")
    os.makedirs(late)
    inputs = write_inputs(late, 16, 16, 8, 8, variants=("mag",))
    out = {}

    # A coupled tiled problem to 4 majors, checkpointed every 2; then the
    # same problem stopped after 2 and resumed to 4.
    extra = small_coupling("all_three")(late, inputs) + ["inversion.writeModelEveryNiter = 2"]
    dirs = {k: os.path.join(late, f"out_{k}") for k in ("full", "resumed")}

    def run(name, out_dir, majors, *flags):
        pf = write_parfile(late, f"Parfile_{name}.txt", inputs, out_dir, 10, fmt="tiled", kind="joint",
                           extra=extra + [f"inversion.nMajorIterations = {majors}"])
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["-p", pf, "--device", "cuda", "-q"] + list(flags))
        if rc != 0:
            raise SystemExit(f"FAILED resume: the {name} run returned {rc}")

    run("full", dirs["full"], 4)
    run("stopped", dirs["resumed"], 2)
    run("resumed", dirs["resumed"], 4, "--resume")
    cks = [load_npz(os.path.join(dirs[k], "checkpoint.npz")) for k in ("full", "resumed")]
    if int(cks[1]["it"]) != 4:
        raise SystemExit(f"FAILED resume: the resumed run's checkpoint says major {int(cks[1]['it'])}")
    equal = {k: bool(np.array_equal(cks[0][k], cks[1][k])) for k in cks[0]}
    files = [f"model/{p}_final_model_full.txt" for p in ("grav", "mag")]
    equal.update({f: same_bytes(*(os.path.join(dirs[k], f) for k in ("full", "resumed"))) for f in files})
    worst = max(float(np.abs(cks[1][k] - cks[0][k]).max() / max(np.abs(cks[0][k]).max(), 1e-300))
                for k in cks[0] if k.startswith(("model_", "admm_")))
    out["resume"] = {"equal": equal, "worst_relative": worst}
    if all(equal.values()):
        print("resume on the card (coupled tiled, 4 majors against 2 + --resume to 4): checkpoint arrays and final "
              "models equal to the last bit to the uninterrupted run -> ok")
    else:
        print(f"resume on the card: NOT equal to the last bit ({equal}); largest difference {worst:.3e} relative "
              "(tolerance 1e-8)")
        if not worst <= 1e-8:
            raise SystemExit("FAILED resume: the resumed run differs from the uninterrupted one")

    # --profile: a Chrome trace that names tile_matvec's kernel once a launch.
    trace_dir = os.path.join(late, "trace")
    pf = write_parfile(late, "Parfile_profile.txt", inputs, os.path.join(late, "out_profile"), 10, fmt="tiled")
    for fn in counters.values():
        fn.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["-p", pf, "--device", "cuda", "-q", "--profile", trace_dir])
    launches = tmv.tile_matvec.launches
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    named = [e for e in events if e.get("cat") == "kernel" and "tile_matvec_kernel" in e.get("name", "")]
    out["profile"] = {"rc": rc, "trace_events": len(events), "tile_matvec_kernel_events": len(named),
                      "tile_matvec_launches": launches,
                      "kernel_name": named[0]["name"] if named else None}
    print(f"--profile: {len(events)} events in trace.json, {len(named)} of the kernel "
          f"{out['profile']['kernel_name']!r} against {launches} launches counted by the wrapper")
    if rc != 0 or not named or len(named) != launches:
        raise SystemExit("FAILED --profile: the trace does not show each launch of tile_matvec's kernel")

    # --debug-nans: a NaN among the observed data stops the run with a
    # FloatingPointError traceback and exit code 1, as a user runs it.
    table = np.loadtxt(inputs["data"], skiprows=1)
    table[5, 3] = np.nan
    data_nan = write_table(os.path.join(late, "data_nan.txt"), table.shape[0], table, "%.6f")
    pf = write_parfile(late, "Parfile_nan.txt", inputs, os.path.join(late, "out_nan"), 10, fmt="tiled", extra=[
        f"forward.data.grav.dataGridFile = {data_nan}", "forward.data.grav.useSyntheticModelForDataValues = 0"])
    p = subprocess.run([sys.executable, "-m", "tomofastx_tpu_torch", "-p", pf, "--debug-nans", "-q"], cwd=late,
                       env=dict(os.environ, PYTHONPATH=HERE), capture_output=True, text=True, timeout=300)
    said = [ln for ln in p.stderr.splitlines() if ln.startswith("FloatingPointError")]
    out["debug_nans"] = {"rc": p.returncode, "said": said}
    print(f"--debug-nans with a NaN datum: exit code {p.returncode}, {said}")
    if p.returncode != 1 or "Traceback" not in p.stderr or not said:
        raise SystemExit(f"FAILED --debug-nans: {p.stdout[-2000:]}{p.stderr[-2000:]}")
    return out


# ---------------------------------------------------------------------------
# Phases 18-23: the native table reader and the matrix-free operators.
# ---------------------------------------------------------------------------

# The lattice and per-cell solves at the stored formats' depth: their products
# are kernels B3 and B2.
LATTICE_DEPTH = (N_MAJOR, N_MINOR)
GENERIC_DEPTH = (N_MAJOR, N_MINOR)
# The lattice's float32 solve through its plain chunk loop on the card (a
# product ~0.4 s: 50.4 s at LATTICE_DEPTH, 19.3 s at 1 x 20) and the same
# solve through kernel B3, held to each other at this depth: one major of
# half the LSQR depth, to leave the run room for phase 30.
LATTICE_PLAIN_DEPTH = (1, N_MINOR // 2)
# Observations of phase 21's FTG-6 and TMI operators at full width in cells.
B2_ROW_CUT = 512
# JAX's bounds for its blended float32 operators against float64: a whole
# row (tests/test_matrixfree.py:1065) and a product (:570, :999).
ROW_BLEND_RTOL, PRODUCT_BLEND_RTOL = 2e-5, 5e-5
AUTO_SIZE, AUTO_SIDE = (128, 128, 64), 128


def matrixfree_said(cls):
    return {"format": r"grav kernel: matrix-free \(" + cls + r", no row storage; ([0-9.]+) MB"}


def time_operator(name, op, reps=20, warm=3):
    """matvec and rmatvec of a full-width operator by CUDA events beside the
    bytes it holds and the kernels one product launches (torch.profiler);
    and two rmatvecs (whose scatter is the one step with an order) equal to
    the last bit."""
    g = torch.Generator(device="cpu").manual_seed(17)
    dt = op.cw.dtype if hasattr(op, "cw") else op.whole.cw.dtype
    x = torch.randn(op.ncols, generator=g, dtype=torch.float64).to("cuda", dt)
    u = torch.randn(op.nrows * (op.ndc if hasattr(op, "ndc") else op.phys.ndc), generator=g,
                    dtype=torch.float64).to("cuda", dt)
    out = {"matvec_ms": time_cuda(lambda: op.matvec(x), warm=warm, reps=reps),
           "rmatvec_ms": time_cuda(lambda: op.rmatvec(u), warm=warm, reps=reps),
           "bytes": op.nbytes}
    # A profiled short product can come back short of its kernels (a run
    # counted 0 for a BTTB matvec that launches 10, and for an 11.7 ms
    # per-cell one): the larger count of two.
    tries = 2 if out["matvec_ms"] < 100.0 else 1
    for f, v in (("matvec", x), ("rmatvec", u)):
        out[f"launches_{f}"] = max(len(cuda_kernel_events(lambda: getattr(op, f)(v))) for _ in range(tries))
    same = torch.equal(op.rmatvec(u), op.rmatvec(u))
    print(f"  {name} ({type(op).__name__}): matvec {out['matvec_ms']:.3f} ms, rmatvec {out['rmatvec_ms']:.3f} ms "
          f"(CUDA events, median of {reps}), {out['bytes'] / 1e6:.1f} MB held on the card, "
          f"{out['launches_matvec']} and {out['launches_rmatvec']} kernels a product; two rmatvecs equal to the "
          f"last bit: {same}")
    if not same:
        raise SystemExit(f"FAILED {name}: two products of the same vector differ")
    return out


def phase_18(work, inputs):
    """The native table reader: built from the checkout's source on this
    machine, written and read against numpy on the smoke grid and model."""
    import ctypes

    from tomofastx_tpu_torch.io import _native, tableio

    print("native table reader (io/_native/fasttab.cpp):")
    t0 = time.time()
    lib_path = os.path.join(work, "fasttab", "libfasttab.so")
    os.makedirs(os.path.dirname(lib_path))
    _native._build(lib_path)
    ctypes.CDLL(lib_path)
    build_s = time.time() - t0
    if tableio._native_lib() is None:
        raise SystemExit(f"FAILED native table reader: {_native.build_error()}")
    out = {"build_s": build_s, "library": os.path.relpath(_native.library_path(), HERE)}
    for name, fmt in (("grid", "%.3f %.3f %.3f %.3f %.3f %.3f %d %d %d"), ("synth", "%.9E")):
        path = inputs[name]
        with open(path) as f:
            header = f.readline().rstrip("\n")
        t0 = time.time()
        want = np.loadtxt(path, skiprows=1, ndmin=2)
        numpy_s = time.time() - t0
        t0 = time.time()
        got = tableio.load_table(path, skiprows=1)
        native_s = time.time() - t0
        mine, theirs = os.path.join(work, f"{name}_native.txt"), os.path.join(work, f"{name}_numpy.txt")
        t0 = time.time()
        tableio.save_table(mine, want, fmt=fmt, header=header)
        write_native_s = time.time() - t0
        t0 = time.time()
        with open(theirs, "w") as f:
            f.write(f"{header}\n")
            np.savetxt(f, want, fmt=fmt)
        write_numpy_s = time.time() - t0
        same_read, same_bytes_ = bool(np.array_equal(got, want)), same_bytes(mine, theirs) and same_bytes(mine, path)
        out[name] = {"rows": int(want.shape[0]), "read_native_s": native_s, "read_numpy_s": numpy_s,
                     "write_native_s": write_native_s, "write_numpy_s": write_numpy_s}
        print(f"  {name} file, {want.shape[0]} rows x {want.shape[1]}: read natively in {native_s:.3f} s against "
              f"{numpy_s:.3f} s by np.loadtxt (equal to the last bit: {same_read}); written in {write_native_s:.3f} s "
              f"against {write_numpy_s:.3f} s by np.savetxt (byte-identical: {same_bytes_})")
        if not (same_read and same_bytes_):
            raise SystemExit(f"FAILED native table reader: the {name} file")
    print(f"  built from the checkout's source in {build_s:.2f} s; the package's own copy: {out['library']} -> ok")
    return out


def closed_rows_f64(grid_path, data_path, points, size):
    """Closed-form g_z rows (float64, the corner lattice) of the given data
    rows: (len(points), N)."""
    from tomofastx_tpu_torch.io import model_io
    from tomofastx_tpu_torch.ops.matrixfree import detect_lattice, lattice_rows_for_point

    grid = model_io.read_model_grid(grid_path, *size)
    edges = [torch.as_tensor(e, dtype=torch.float64, device="cuda") for e in detect_lattice(grid)]
    table = np.loadtxt(data_path, skiprows=1, ndmin=2)[points]
    pts = [torch.as_tensor(table[:, c], dtype=torch.float64, device="cuda") for c in range(3)]
    return lattice_rows_for_point(*edges, *pts, "grav", 1, (0.0, 0.0, 1.0), 0.0, 1, 1).reshape(len(points), -1)


def phase_19(cli, counters, workflow, work, inputs, mesh4):
    """BTTB at full width through the command line: against a dense
    uncompressed run of the same Parfile, --mesh 1 to the last bit, four
    slots of the card with the layers split."""
    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag

    print("BTTB matrix-free (observations on the cell-centre lattice at one height):")
    out = {f: os.path.join(work, f"out_bttb_{f}") for f in ("run", "mesh1", "dense", "four")}
    pf = {f: write_parfile(work, f"Parfile_bttb_{f}.txt", inputs, out[f], N_MINOR, fmt="matrixfree", compression=0)
          for f in ("run", "mesh1", "four")}
    pf["dense"] = write_parfile(work, "Parfile_bttb_dense.txt", inputs, out["dense"], N_MINOR, fmt=None,
                                compression=0, extra=["tpu.sensitWriteCache = 0"])
    said = matrixfree_said("BTTBKernel")
    runs = {}
    with capturing_the_system(workflow) as cap:
        runs["run"] = run_main_path(cli, counters, "BTTB", pf["run"], out["run"], said, sensit_written=False,
                                    compression="uncompressed")
    op = cap["arrays"]["S"][0]
    del cap["arrays"]
    times = time_operator("BTTB at 4096 x 262144", op)
    del op
    runs["mesh1"] = run_main_path(cli, counters, "BTTB --mesh 1", pf["mesh1"], out["mesh1"],
                                  {**said, "slot0_MB": r"slot 0 \(cuda:0\) ([0-9.]+) MB"}, sensit_written=False,
                                  compression="uncompressed", mesh="1")
    held = hold_equal("BTTB --mesh 1", runs["mesh1"], out["mesh1"], runs["run"], out["run"])
    if not held["equal_to_the_last_bit"]:
        raise SystemExit("FAILED BTTB --mesh 1: not equal to the last bit to the unmeshed run")
    runs["dense"] = run_main_path(cli, counters, "dense uncompressed (same Parfile)", pf["dense"], out["dense"],
                                  {"format": DENSE_SAID.format(p="grav", rows=NDATA)}, sensit_written=False,
                                  compression="uncompressed")
    spread = formats_apart("BTTB against dense uncompressed", runs["run"], runs["dense"])
    t0 = time.time()
    res = solve_problem_joint_gravmag(read_parfile(pf["four"]), verbose=False, device="cuda", mesh=mesh4)
    torch.cuda.synchronize()
    four = {"s": time.time() - t0, "model": res.models[0].val,
            "data_cost": [row[1] for row in read_costs(os.path.join(out["four"], "costs.txt"))]}
    four_spread = formats_apart(f"BTTB over {mesh4} (layers split, 16 a slot) against unmeshed",
                                {"models": {"grav": four["model"]}, "data_costs": {"grav": four["data_cost"]}}, runs["run"])
    print(f"  BTTB over four slots of the card: {four['s']:.1f} s, data cost per major {four['data_cost']}")
    return {"runs": runs, "operator": times, "mesh1": held, "against_dense": spread,
            "four_slots": {"s": four["s"], "data_cost": four["data_cost"], **four_spread}}


def phase_20(cli, counters, workflow, work, inputs):
    """The corner-lattice operator on a draped survey at full width, its
    products by kernel B3: a LATTICE_DEPTH solve through the command line
    (B3's launches counted); B3 against its plain loop for g_z in float32
    (the blend) and float64 (the closed forms), and for FTG-6 and TMI on the
    first B2_ROW_CUT observations, each timed beside the plain loop and its
    bound; the float32 products against the dense uncompressed matrix of the
    same survey (torch.mv on it timed as a yardstick); 256 of the operator's
    float32 rows, through the kernel, against the float64 closed forms; the
    construction's probe aborting through B3; then --mesh 1 to the last bit,
    a dense uncompressed run (the float32 pair's spread read), the lattice's
    float32 solve through its plain loop on the card held to B3's, and both
    Parfiles solved in float64 (the lattice through B3's closed forms, its
    launches counted) held to each other, these two at the formats'
    tolerance."""
    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.io import data_io, model_io
    from tomofastx_tpu_torch.ops import sensitivity as sens
    from tomofastx_tpu_torch.ops.matrixfree import make_matrixfree_kernel

    print(f"lattice matrix-free (the same grid, a draped survey), {LATTICE_DEPTH[0]} majors x {LATTICE_DEPTH[1]} "
          "minors:")
    draped = dict(inputs, data=inputs["data_draped"])
    out = {f: os.path.join(work, f"out_lattice_{f}")
           for f in ("run", "mesh1", "dense", "short", "plain", "run_f64", "dense_f64")}
    pf = {f: write_parfile(work, f"Parfile_lattice_{f}.txt", draped, out[f], LATTICE_DEPTH[1], fmt="matrixfree",
                           compression=0, n_major=LATTICE_DEPTH[0]) for f in ("run", "mesh1", "run_f64")}
    pf.update({f: write_parfile(work, f"Parfile_lattice_{f}.txt", draped, out[f], LATTICE_PLAIN_DEPTH[1],
                                fmt="matrixfree", compression=0, n_major=LATTICE_PLAIN_DEPTH[0])
               for f in ("short", "plain")})
    for f in ("dense", "dense_f64"):
        pf[f] = write_parfile(work, f"Parfile_lattice_{f}.txt", draped, out[f], LATTICE_DEPTH[1], fmt=None,
                              compression=0, extra=["tpu.sensitWriteCache = 0"], n_major=LATTICE_DEPTH[0])
    said = matrixfree_said("LatticeMatrixFreeKernel")
    said["products_by"] = r"products by kernel B3, csrc/lattice_matvec\.cu\)"
    kw = dict(sensit_written=False, compression="uncompressed", depth=LATTICE_DEPTH, what=f"{NDATA} draped observations")
    runs = {}
    with capturing_the_system(workflow) as cap:
        runs["run"] = run_main_path(cli, counters, "lattice", pf["run"], out["run"], said, **kw)
    op = cap["arrays"]["S"][0]
    del cap["arrays"]
    want = b2_launches(runs["run"]["lsqr_iterations"], "lattice")
    print(f"  kernel B3's launches: {runs['run']['launches']['lattice_matvec']} matvec, "
          f"{runs['run']['launches']['lattice_rmatvec']} rmatvec (expected {want['lattice_matvec']} = the probe, "
          f"{3 + LATTICE_DEPTH[0]} forward products and one a LSQR iteration; {want['lattice_rmatvec']} = one a LSQR "
          f"iteration and one a solve), near passes {runs['run']['launches']['lattice_near_matvec']} and "
          f"{runs['run']['launches']['lattice_near_rmatvec']} (one a product), near rows built "
          f"{runs['run']['launches']['lattice_near_build']} (once)")
    if not launched(runs["run"]["launches"], **want):
        raise SystemExit(f"FAILED lattice main path: launches {runs['run']['launches']}")
    if not op.far_quad:
        raise SystemExit("FAILED lattice: the float32 operator does not blend")
    times = time_operator(f"lattice at 4096 x 262144, windows {op.win}", op)
    b3 = {"g_z float32": measure_b3("g_z float32 (the blend), 4096 x 262144", op, RTOL_F32)}
    par = read_parfile(pf["run"]).grav
    grid = model_io.read_model_grid(draped["grid"], NX, NY, NZ)
    data = data_io.read_data_points(draped["data"], NDATA, 1, grid_only=True)
    ones = np.ones(NX * NY * NZ)
    unweighted = make_matrixfree_kernel(par, grid, data, ones, 1.0, np.ones((NDATA, 1)), torch.float32, device="cuda")
    S = sens.compute_sensitivity(par, grid, data, ones, store_dtype=torch.float32, device="cuda").S
    g = torch.Generator(device="cpu").manual_seed(23)
    x = torch.randn(S.shape[1], generator=g, dtype=torch.float64).to("cuda", torch.float32)
    u = torch.randn(S.shape[0], generator=g, dtype=torch.float64).to("cuda", torch.float32)
    errs = {}
    for what, got, ref in (("matvec", unweighted.matvec(x), torch.mv(S, x)),
                           ("rmatvec", unweighted.rmatvec(u), torch.mv(S.T, u))):
        errs[what] = float((got.double() - ref.double()).norm() / ref.double().norm())
        print(f"  {what} against the dense uncompressed (f64-built, f32-stored) matrix: relative error "
              f"{errs[what]:.3e} (bound {PRODUCT_BLEND_RTOL:g}, the JAX package's for its blended operators)")
        if not errs[what] <= PRODUCT_BLEND_RTOL:
            raise SystemExit(f"FAILED lattice: {what} against the dense matrix")
    yardstick = {"torch_mv_f32_ms": time_cuda(lambda: torch.mv(S, x), calls=BACK_TO_BACK),
                 "torch_mv_f32_T_ms": time_cuda(lambda: torch.mv(S.T, u), calls=BACK_TO_BACK)}
    print(f"  yardstick (another function: the stored matrix the operator exists to avoid): torch.mv on the dense "
          f"float32 matrix {yardstick['torch_mv_f32_ms']:.3f} ms, on its transpose {yardstick['torch_mv_f32_T_ms']:.3f} ms")
    del S
    worst, nrows = 0.0, min(256, NDATA)
    for s in range(0, nrows, 128):
        e = min(s + 128, nrows)
        rows = kernel_rows(unweighted, s, e).double()
        ref = closed_rows_f64(inputs["grid"], inputs["data_draped"], np.arange(s, e), (NX, NY, NZ))
        rel = ((rows - ref).norm(dim=1) / ref.norm(dim=1)).max().item()
        worst = max(worst, rel)
        del rows, ref
    print(f"  {nrows} float32 rows through kernel B3 against the float64 closed forms: worst relative error "
          f"{worst:.3e} (bound {ROW_BLEND_RTOL:g}, the JAX package's at tests/test_matrixfree.py:1065)")
    if not worst < ROW_BLEND_RTOL:
        raise SystemExit("FAILED lattice: float32 rows off the float64 closed forms")
    del op, unweighted
    torch.cuda.empty_cache()
    op64 = make_matrixfree_kernel(par, grid, data, ones, 1.0, np.ones((NDATA, 1)), torch.float64, device="cuda")
    b3["g_z float64"] = measure_b3("g_z float64 (the closed forms), 4096 x 262144", op64, RTOL_F64_FULL, reps=3)
    del op64
    for case in ("FTG-6", "TMI"):
        cut = slice(0, B2_ROW_CUT)
        opc = b3_operator(case, grid, data.X[cut], data.Y[cut], data.Z[cut], torch.float32)
        b3[f"{case} float32"] = measure_b3(f"{case} float32 (the blend), {B2_ROW_CUT} x 262144", opc, RTOL_F32,
                                           reps=3)
        del opc
    torch.cuda.empty_cache()
    b3_probe()
    runs["mesh1"] = run_main_path(cli, counters, "lattice --mesh 1", pf["mesh1"], out["mesh1"], said, mesh="1", **kw)
    # The near rows are built twice: with the operator, and with its one part.
    if not launched(runs["mesh1"]["launches"], **dict(want, lattice_near_build=2)):
        raise SystemExit(f"FAILED lattice --mesh 1: launches {runs['mesh1']['launches']}")
    held = hold_equal("lattice --mesh 1", runs["mesh1"], out["mesh1"], runs["run"], out["run"])
    if not held["equal_to_the_last_bit"]:
        raise SystemExit("FAILED lattice --mesh 1: not equal to the last bit to the unmeshed run")
    runs["dense"] = run_main_path(cli, counters, "dense uncompressed (same survey)", pf["dense"], out["dense"],
                                  {"format": DENSE_SAID.format(p="grav", rows=NDATA)}, **kw)
    # At 3 x 20 float32 LSQR carries the rounding of each operator's rows
    # (the blend's ~3e-7, the stored matrix's ~6e-8) into final models ~1e-2
    # of the range from the float64 solve's, kernel B3's and its plain loop's
    # alike, and two float32 solves of different rows part by 1e-3 to 3e-3
    # (scripts/probe_torch_lattice_solves.py, PERF.md). So the float32 pair
    # of the lattice and the dense matrix is read here. Kernel B3's float32
    # solve is held to the same solve through its plain chunk loop on the card
    # (the same rows, rounded and summed in another order), and the operator
    # to the dense matrix by float64 solves of the same Parfiles (the
    # lattice's through B3's closed forms), both at the formats' tolerance.
    spread32 = formats_apart("lattice against dense uncompressed, float32 solves", runs["run"], runs["dense"],
                             hold=False)
    short = dict(kw, depth=LATTICE_PLAIN_DEPTH)
    runs["short"] = run_main_path(cli, counters, "lattice", pf["short"], out["short"], said, **short)
    if not launched(runs["short"]["launches"], **b2_launches(runs["short"]["lsqr_iterations"], "lattice")):
        raise SystemExit(f"FAILED lattice, {LATTICE_PLAIN_DEPTH}: launches {runs['short']['launches']}")
    with lattice_products_by_the_plain_loop():
        runs["plain"] = run_main_path(cli, counters, "lattice, its plain chunk loop on the card", pf["plain"],
                                      out["plain"], said, **short)
    # The construction still builds the stored near rows by its kernels; the
    # products never read them.
    if not launched(runs["plain"]["launches"], lattice_near_build=1):
        raise SystemExit(f"FAILED lattice, plain loop: kernel launches {runs['plain']['launches']}")
    held32 = formats_apart("lattice through kernel B3 against its plain loop, float32 solves", runs["short"],
                           runs["plain"])
    f64 = ("--precision", "double")
    runs["run_f64"] = run_main_path(cli, counters, "lattice, float64 solve", pf["run_f64"], out["run_f64"], said,
                                    args=f64, **kw)
    if not launched(runs["run_f64"]["launches"], **b2_launches(runs["run_f64"]["lsqr_iterations"], "lattice",
                                                               near=False)):
        raise SystemExit(f"FAILED lattice, float64 solve: launches {runs['run_f64']['launches']}")
    runs["dense_f64"] = run_main_path(cli, counters, "dense uncompressed, float64 solve", pf["dense_f64"],
                                      out["dense_f64"], {}, args=f64, **kw)
    spread = formats_apart("lattice against dense uncompressed, float64 solves", runs["run_f64"], runs["dense_f64"])
    return {"runs": runs, "operator": times, "rows_worst_relative": worst, "mesh1": held, "against_dense": spread,
            "against_dense_float32_read": spread32, "against_the_plain_loop_float32": held32, "products_against_dense": errs, "b3": b3, "yardstick": yardstick}


def phase_21(cli, counters, work, inputs):
    """The per-cell operator with its near patch on a grid that is no
    lattice, its products by kernel B2: g_z at full width in float32 (the
    blend) and in float64, and FTG-6 and TMI on the first B2_ROW_CUT
    observations, each against its plain loop and timed beside it and its
    bound; the float32 products against the dense uncompressed matrix of the
    same grid (torch.mv on it timed as a yardstick); then a GENERIC_DEPTH
    solve through the command line, B2's launches counted."""
    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.io import data_io, model_io
    from tomofastx_tpu_torch.ops import sensitivity as sens
    from tomofastx_tpu_torch.ops.matrixfree import MatrixFreeKernel, make_matrixfree_kernel

    print(f"per-cell matrix-free (the top layer follows a topography), {GENERIC_DEPTH[0]} majors x "
          f"{GENERIC_DEPTH[1]} minors:")
    topo = dict(inputs, grid=inputs["grid_topo"])
    out = os.path.join(work, "out_generic")
    pf = write_parfile(work, "Parfile_generic.txt", topo, out, GENERIC_DEPTH[1], fmt="matrixfree", compression=0,
                       n_major=GENERIC_DEPTH[0])
    par = read_parfile(pf).grav
    grid = model_io.read_model_grid(topo["grid"], NX, NY, NZ)
    data = data_io.read_data_points(topo["data"], NDATA, 1, grid_only=True)
    ones = np.ones(NX * NY * NZ)
    torch.cuda.synchronize()
    t0 = time.time()
    op = make_matrixfree_kernel(par, grid, data, ones, 1.0, np.ones((NDATA, 1)), torch.float32, device="cuda")
    torch.cuda.synchronize()
    build_s = time.time() - t0
    if not (isinstance(op, MatrixFreeKernel) and op.phys.far_quad):
        raise SystemExit(f"FAILED per-cell: {type(op).__name__} built, or no blend")
    print(f"  operator built in {build_s:.2f} s (near candidates per point K = {op.near_idx.shape[1]}, the probe "
          "matvec included)")
    times = time_operator("per-cell at 4096 x 262144", op)
    b2 = {"g_z float32": measure_b2("g_z float32 (the blend), 4096 x 262144", op, RTOL_F32)}
    S = sens.compute_sensitivity(par, grid, data, ones, store_dtype=torch.float32, device="cuda").S
    g = torch.Generator(device="cpu").manual_seed(23)
    x = torch.randn(S.shape[1], generator=g, dtype=torch.float64).to("cuda", torch.float32)
    u = torch.randn(S.shape[0], generator=g, dtype=torch.float64).to("cuda", torch.float32)
    errs = {}
    for what, got, want in (("matvec", op.matvec(x), torch.mv(S, x)), ("rmatvec", op.rmatvec(u), torch.mv(S.T, u))):
        errs[what] = float((got.double() - want.double()).norm() / want.double().norm())
        print(f"  {what} against the dense uncompressed (f64-built, f32-stored) matrix: relative error "
              f"{errs[what]:.3e} (bound {PRODUCT_BLEND_RTOL:g}, the JAX package's for its blended operators)")
        if not errs[what] <= PRODUCT_BLEND_RTOL:
            raise SystemExit(f"FAILED per-cell: {what} against the dense matrix")
    yardstick = {"torch_mv_f32_ms": time_cuda(lambda: torch.mv(S, x), calls=BACK_TO_BACK),
                 "torch_mv_f32_T_ms": time_cuda(lambda: torch.mv(S.T, u), calls=BACK_TO_BACK)}
    print(f"  yardstick (another function: the stored matrix the operator exists to avoid): torch.mv on the dense "
          f"float32 matrix {yardstick['torch_mv_f32_ms']:.3f} ms, on its transpose {yardstick['torch_mv_f32_T_ms']:.3f} ms")
    del S, op
    torch.cuda.empty_cache()
    op64 = make_matrixfree_kernel(par, grid, data, ones, 1.0, np.ones((NDATA, 1)), torch.float64, device="cuda")
    b2["g_z float64"] = measure_b2("g_z float64, 4096 x 262144", op64, RTOL_F64_FULL, reps=3)
    del op64
    for case in ("FTG-6", "TMI"):
        cut = slice(0, B2_ROW_CUT)
        opc = b2_operator(case, grid, data.X[cut], data.Y[cut], data.Z[cut], torch.float32)
        b2[f"{case} float32"] = measure_b2(f"{case} float32 (the blend), {B2_ROW_CUT} x 262144", opc, RTOL_F32,
                                           reps=3)
        del opc
    torch.cuda.empty_cache()
    run = run_main_path(cli, counters, "per-cell", pf, out, matrixfree_said("MatrixFreeKernel"), sensit_written=False,
                        compression="uncompressed", depth=GENERIC_DEPTH)
    want = b2_launches(run["lsqr_iterations"])
    print(f"  kernel B2's launches: {run['launches']['prism_matvec']} matvec, {run['launches']['prism_rmatvec']} "
          f"rmatvec (expected {want['prism_matvec']} = the probe, {3 + GENERIC_DEPTH[0]} forward products and one a "
          f"LSQR iteration; {want['prism_rmatvec']} = one a LSQR iteration and one a solve), near passes "
          f"{run['launches']['prism_near_matvec']} and {run['launches']['prism_near_rmatvec']} (one a product), near "
          f"rows built {run['launches']['prism_near_build']} (once)")
    if not launched(run["launches"], **want):
        raise SystemExit(f"FAILED per-cell main path: launches {run['launches']}")
    return {"operator": times, "build_s": build_s, "against_dense": errs, "run": run, "b2": b2,
            "yardstick": yardstick}


def b2_launches(lsqr_iterations, kernel="prism", near=True, builds=1):
    """Kernel B2's (or, kernel = "lattice", B3's) launches in a host-driven
    matrix-free run: the construction's probe matvec, the forward products
    (synthetic, prior and starting models, and one after each major), and
    each solve's LSQR (a matvec an iteration; an rmatvec an iteration and one
    before the loop); near: a float32 blend's, whose every product launches
    its near pass too, and whose construction builds its stored near rows
    (`builds` times: once, and once more for each part of a mesh)."""
    want = {f"{kernel}_matvec": 1 + 3 + len(lsqr_iterations) + sum(lsqr_iterations),
            f"{kernel}_rmatvec": sum(it + 1 for it in lsqr_iterations)}
    if near:
        want.update({f"{kernel}_near_{f}": want[f"{kernel}_{f}"] for f in ("matvec", "rmatvec")})
        want[f"{kernel}_near_build"] = builds
    return want


def phase_22(cli, counters, work):
    """kernelFormat = auto at the size it exists for: g_z on 128 x 128 x 64
    cells with 16384 observations, uncompressed; a dense float32 kernel
    would take 68.7 GB."""
    from tomofastx_tpu_torch.ops.bttb import BTTBKernel

    nx, ny, nz = AUTO_SIZE
    ncells, nd = nx * ny * nz, AUTO_SIDE * AUTO_SIDE
    print(f"kernelFormat = auto, {nd} observations x {ncells} cells, uncompressed (dense would be "
          f"{nd * ncells * 4 / 1e9:.1f} GB against 0.55 x {torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB):")
    auto_dir = os.path.join(work, "auto")
    os.makedirs(auto_dir)
    t0 = time.time()
    inputs = write_inputs(auto_dir, nx, ny, nz, AUTO_SIDE)
    print(f"  inputs written in {time.time() - t0:.1f} s")
    out = os.path.join(work, "out_auto")
    pf = write_parfile(auto_dir, "Parfile_auto.txt", inputs, out, N_MINOR, fmt="auto", compression=0,
                       extra=["forward.depthWeighting.type = 1"])
    import tomofastx_tpu_torch.inversion.workflow as workflow

    with capturing_the_system(workflow) as cap:
        run = run_main_path(cli, counters, "auto", pf, out, {
            "dense_GB": r"grav kernel format auto: dense would be ([0-9.]+) GB .*-> matrix-free",
            **matrixfree_said("BTTBKernel")}, sensit_written=False, compression="uncompressed", ncells=ncells,
            what=f"{nd} observations")
    op = cap["arrays"]["S"][0]
    del cap["arrays"]
    if not isinstance(op, BTTBKernel):
        raise SystemExit(f"FAILED auto: {type(op).__name__}")
    times = time_operator(f"BTTB at {nd} x {ncells}, table {tuple(op.Tf.shape)}", op)
    del op
    # 64 rows of the forward data (the synthetic model's data the run wrote)
    # against closed-form rows in float64.
    rows = np.arange(0, nd, nd // 64)
    table = np.loadtxt(os.path.join(out, "data", "grav_observed.txt"), skiprows=1, ndmin=2)
    want = closed_rows_f64(inputs["grid"], inputs["data"], rows, AUTO_SIZE) @ torch.as_tensor(
        block_model(nx, ny, nz).reshape(-1), dtype=torch.float64, device="cuda")
    from tomofastx_tpu_torch.config.parfile import read_parfile

    units = read_parfile(pf).grav.data_units_mult  # the file holds d / units
    got = torch.as_tensor(table[rows, 3] * units, dtype=torch.float64, device="cuda")
    err = float((got - want).abs().max() / want.abs().max())
    print(f"  64 rows of the forward data against float64 closed-form rows: max error {err:.3e} of max|d| "
          f"(tolerance {RTOL_F32_FORWARD:g})")
    if not err <= RTOL_F32_FORWARD:
        raise SystemExit("FAILED auto: forward data against the closed forms")
    return {"run": run, "operator": times, "forward_rows_max_err": err}


def start_phase_23(work, mesh4, counters, cpu_pool):
    """Small float64 matrix-free problems, card against CPU; the per-cell
    ones through kernel B2, the lattice ones through B3, counted: their CPU
    solves started in cpu_pool, {name: the function that runs the card's
    and compares} returned for phase 23."""
    b2 = {k: counters[k] for k in ("prism_matvec", "prism_rmatvec")}
    b3 = {k: counters[k] for k in ("lattice_matvec", "lattice_rmatvec")}
    # The longest CPU solve first.
    cases = [
        ("generic_borehole_tmi", "per-cell TMI, borehole", dict(operator="MatrixFreeKernel", kind="borehole",
                                                                counted=b2)),
        ("generic_gz", "per-cell g_z, topography", dict(operator="MatrixFreeKernel", swap={"grid": "grid_topo"},
                                                        counted=b2)),
        ("lattice_gz", "lattice g_z, draped", dict(operator="LatticeMatrixFreeKernel", swap={"data": "data_draped"},
                                                   counted=b3)),
        ("lattice_tmi", "lattice TMI, draped", dict(operator="LatticeMatrixFreeKernel", kind="tmi",
                                                    swap={"data": "data_draped"}, counted=b3)),
        ("bttb_gz", "BTTB g_z", dict(operator="BTTBKernel")),
        ("bttb_ftg", "BTTB FTG full tensor", dict(operator="BTTBKernel", kind="ftg")),
        ("lattice_gz_4_slots", "lattice g_z, draped, four slots of the card",
         dict(operator="LatticeMatrixFreeKernel", swap={"data": "data_draped"}, mesh=mesh4, counted=b3)),
    ]
    return {name: small_problem_card_against_cpu(work, f"small_mf_{name}", f"matrix-free {what}", fmt="matrixfree",
                                                 compression=0, cpu_pool=cpu_pool, **kw) for name, what, kw in cases}


def phase_23(started):
    """The card's solves of start_phase_23's problems, each against its CPU
    solve: {name: the model's largest difference, of its range}."""
    return {name: finish() for name, finish in started.items()}


# ---------------------------------------------------------------------------
# Kernel B2: the per-cell matrix-free operator's products (csrc/prism_matvec.cuh, built as prism_matvec_f32.cu and _f64.cu).
# ---------------------------------------------------------------------------

# The per-cell operator's families: gravity (data type, data components) or
# magnetics (model components, data components); "inside" puts the
# observations inside the grid (the borehole branch).
B2_FAMILIES = {
    "g_z": ("grav", 1, 1), "Gzz": ("grav", 2, 1), "FTG-6": ("grav", 2, 6),
    "TMI": ("magn", 1, 1), "3-component": ("magn", 1, 3), "MVI": ("magn", 3, 1),
    "MVI 3-component": ("magn", 3, 3), "borehole TMI": ("magn", 1, 1, "inside"),
}
# A float32 operator with tpu.farFieldQuad = 0 evaluates the closed forms in
# float32, whose 8-corner cancellation is the rounding noise the blend exists
# to avoid (ops/prism.py): two evaluation orders of it differ by up to ~1e-5 of
# max|y| on the small problems, so they are held at ten times that.
RTOL_F32_CLOSED = 1e-4
# The float64 closed forms at full width: a far cell's 8-corner cancellation
# grows as (distance / cell size)^3, and 262144 cells are summed; the JAX
# package holds its float64 operators to the port's at 1e-10
# (tests/test_torch_matrixfree.py::test_operator_matches_jax_f64).
RTOL_F64_FULL = 1e-10
# Kernel B2's bound is by operations, from this run's pairs (csrc/prism_matvec.cuh):
# a far pair of the float32 blend is 27 reciprocal square roots on the special
# function unit (16 a clock an SM: 132 x 16 x 1.98 GHz on an H100 SXM) and
# B2_QUAD_FLOPS float32 operations (an FMA counted as 2: the 27 points, the
# node offsets, the far mask and the scaling); a pair of the closed forms
# B2_CLOSED_FLOPS float64 operations, each square root, arc tangent and log
# counted as one (a lower bound: the card computes each with tens of
# instructions) at NVIDIA's data-sheet 34 TFLOP/s of float64.
MUFU_PER_S = 132 * 16 * 1.98e9
FP64_FLOP_PER_S = 34e12
# What ptxas said of each kernel in this run's builds: {mangled name: registers}.
REGISTERS = {}
# The template arguments of the families whose registers are reported: the
# float32 blend's kernels (type, family, nmc, ndc, mode) and the near rows'
# build (family, nmc, ndc), as mangled; the near passes over the stored rows
# are templates of (nmc, ndc, lanes) alone.
REGISTER_FAMILIES = {"g_z": "Li0ELi1ELi1E", "FTG-6": "Li2ELi1ELi6E", "TMI": "Li3ELi1ELi1E"}
REGISTER_SHAPES = {"g_z": "Li1ELi1E", "FTG-6": "Li1ELi6E", "TMI": "Li1ELi1E"}


def ptxas_registers(log):
    """{kernel's mangled name: registers} from nvcc -Xptxas -v's log."""
    return {name: int(regs) for name, regs in re.findall(
        r"Compiling entry function '(\S+)' for 'sm_90a'\n(?:.*\n)*?ptxas info\s*: Used (\d+) registers", log)}


def kernel_registers(kernels, registers=None):
    """Registers of each family of REGISTER_FAMILIES for each (kernel name,
    kind) of `kernels` (kind True: a blend kernel; False: one of the family
    alone; "stream": a near pass, the most over its lanes), from
    `registers` ({mangled name: registers}; this run's REGISTERS by
    default): {kernel: {family: registers}}."""
    registers = REGISTERS if registers is None else registers
    out = {}
    for kernel, kind in kernels:
        for fam, targs in REGISTER_FAMILIES.items():
            if kind == "stream":
                key = f"{kernel}I{REGISTER_SHAPES[fam]}"
                out.setdefault(kernel, {})[fam] = max((r for name, r in registers.items() if key in name),
                                                      default=None)
                continue
            key = f"{kernel}I" + (f"f{targs}Li1EE" if kind else f"{targs}E")
            out.setdefault(kernel, {})[fam] = next((r for name, r in registers.items() if key in name), None)
    return out


# The stored near rows against their plain build on the card: the same pairs,
# and each row the same float64 closed form rounded to float32, where a few
# land on the neighbouring float32 (the kernel's and torch's float64
# transcendentals may differ in their last bits).
RTOL_NEAR_ROWS = 1e-6


def time_graph(fn, calls=20, reps=5):
    """Median milliseconds a call of fn() on the card alone: `calls` calls
    captured as one CUDA graph, its replay timed by CUDA events (`reps`
    replays), over calls: no host time, which a near pass at the smoke's
    shape otherwise is mostly."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return float(np.median(times))


def near_rows_against_plain(tag, name, op, timed=False):
    """The operator's stored near rows (its build's, on the card) against
    their plain build on the same tensors: the same pairs in both orders,
    the rows within RTOL_NEAR_ROWS of max|row|. Returns the largest
    difference of a row (timed: and the plain build's milliseconds)."""
    from tomofastx_tpu_torch.ops._cuda_build import NEAR_ROW_FIELDS

    plain, plain_ms = timed_once(op.near_rows_plain)
    for f in NEAR_ROW_FIELDS:
        if not f.endswith("val") and not torch.equal(getattr(op, f), plain[f]):
            raise SystemExit(f"FAILED {tag} {name}: the stored near rows' {f} differ from their plain build's")
    err = max(compare(f"{tag} {name}, stored near rows ({op.near_rval.shape[0]:,} pairs, {order}) against their "
                      "plain build", getattr(op, f), plain[f], RTOL_NEAR_ROWS)
              for f, order in (("near_rval", "by observation"), ("near_cval", "by cell")))
    return (err, plain_ms) if timed else err


def near_pass(tag, name, op, kernels, vecs, rtol, reps=0):
    """A blend's near passes alone: its stored rows against their plain
    build (near_rows_against_plain); each kernel against the plain product
    over the stored rows (the same float32 rows, float64 sums in another
    order: to RTOL_F64 of max|y|) and the plain pass that evaluates every row
    again (to rtol), launched once a call, two launches equal to the last
    bit; with reps, the kernel timed one call a pair of events (`ms`, the
    wrapper's host time in, as every kernel's `ms`) and on the card alone
    (`ms_on_card`, time_graph), each plain version by the one call its
    comparison makes, and the one-off build of the rows (median of 3) beside
    its plain version's. Returns {f: {...}, "rows": {...}}."""
    err, plain_build_ms = near_rows_against_plain(tag, name, op, timed=True)
    out = {"rows": {"max_abs_err": err, "stored_nbytes": op.near_rows_nbytes, "pairs": op.near_rval.shape[0],
                    "lanes": list(op.near_lanes)}}
    plains = {"matvec": (op._stored_near_matvec, op._near_matvec), "rmatvec": (op._stored_near_rmatvec,
                                                                             op._near_rmatvec)}
    for f, kernel in kernels.items():
        v = vecs[f]
        stored, again = plains[f]
        before = kernel.launches
        got = kernel(op, v)
        if kernel.launches != before + 1:
            raise SystemExit(f"FAILED {tag} {name}: the near pass {f} did not launch once")
        want, plain_ms = timed_once(lambda: stored(v))
        want_again, again_ms = timed_once(lambda: again(v))
        row = {"max_abs_err": compare(f"{tag} {name}, near pass {f} against the plain product over the stored rows",
                                      got, want, RTOL_F64),
               "max_abs_err_against_the_recomputing_pass": compare(
                   f"{tag} {name}, near pass {f} against the plain pass that evaluates the rows again", got,
                   want_again, rtol)}
        del want, want_again
        if not torch.equal(kernel(op, v), got):
            raise SystemExit(f"FAILED {tag} {name}: two near {f} launches differ")
        if reps:
            row["ms"] = time_cuda(lambda: kernel(op, v), warm=1, reps=reps)
            row["ms_on_card"] = time_graph(lambda: kernel(op, v))
            row["plain_ms"] = plain_ms
            row["plain_ms_recomputing"] = again_ms
        out[f] = row
    if reps:
        out["rows"]["build_ms"] = time_cuda(op.with_near_rows, warm=1, reps=3)
        out["rows"]["plain_build_ms"] = plain_build_ms
        print(f"  {tag} {name} near rows: {out['rows']['pairs']:,} pairs, {op.near_rows_nbytes / 1e6:.2f} MB stored, "
              f"built in {out['rows']['build_ms']:.3f} ms (plain build {out['rows']['plain_build_ms']:.1f} ms), lanes "
              f"{op.near_lanes}")
    return out


def near_bound(op, near, corner_flops, f):
    """A near pass's least milliseconds for one call on `op` (f "matvec" or
    "rmatvec"): the bytes it must move, each once: its order of the stored
    rows (offsets, indices, float32 rows; by cell also the cells' numbers),
    the input entries they name (each distinct one once) and its float64
    output (the matvec's rows, the rmatvec's every cell). Beside it, the
    float64 operations of the near pairs' closed forms (corner_flops a pair,
    each square root, arc tangent and log one operation), which the build
    evaluates once and the earlier pass evaluated in every product."""
    nmc, ndc = (op.phys.nmc, op.phys.ndc) if hasattr(op, "phys") else (op.nmc, op.ndc)
    nv = nmc * ndc
    if f == "matvec":
        lists = op.near_rptr.numel() + op.near_rcell.numel()
        named, out = int(torch.unique(op.near_rcell).numel()) * nmc, op.xd.shape[0] * ndc
    else:
        lists = op.near_ccell.numel() + op.near_cptr.numel() + op.near_cobs.numel()
        named, out = int(torch.unique(op.near_cobs).numel()) * ndc, nmc * op.N
    times = {"bytes": (4 * lists + 4 * near * nv + 4 * named + 8 * out) / MEMORY_BYTES_PER_S * 1e3,
             "float64 operations of the closed forms (evaluated at the build)":
                 corner_flops * near / FP64_FLOP_PER_S * 1e3}
    return times["bytes"], "bytes", "bytes", times


def near_build_bound(op, near, corner_flops):
    """The near rows' build's least milliseconds on `op`: the larger of the
    near pairs' closed forms in float64 (corner_flops a pair, each
    transcendental one operation) and the bytes it must move (its candidate
    lists, read once, and the rows in both orders with their indices,
    written once). Returns (ms, bound_by, times)."""
    nv = (op.phys.nmc * op.phys.ndc) if hasattr(op, "phys") else op.nmc * op.ndc
    candidates = op.near_idx.numel() if hasattr(op, "grid6") else op.near_ptr.numel() + op.near_cells.numel()
    written = op.near_rows_nbytes
    times = {"bytes": (4 * candidates + written) / MEMORY_BYTES_PER_S * 1e3,
             "float64 operations": corner_flops * near / FP64_FLOP_PER_S * 1e3}
    which = max(times, key=times.get)
    return times[which], "bytes" if which == "bytes" else "operations", times


B2_QUAD_FLOPS = {"grav1": 309, "grav2": 417, "grav6": 1155, "magn": 1170}
B2_CLOSED_FLOPS = {"grav1": 240, "grav2": 104, "grav6": 480, "magn": 230}


def b2_family_key(phys):
    return "magn" if phys.problem == "magn" else f"grav{1 if phys.data_type == 1 else 2 if phys.ndc == 1 else 6}"


def b2_params(case, grid, n, far_field_quad=1):
    """The port's parameters of a B2 family for n observations on `grid`."""
    from tomofastx_tpu_torch.config.parfile import GravParams, MagParams

    problem, a, b = B2_FAMILIES[case][:3]
    size = dict(nx=grid.nx, ny=grid.ny, nz=grid.nz, ndata=n, far_field_quad=far_field_quad)
    if problem == "grav":
        return GravParams(data_type=a, ndata_components=b, **size)
    return MagParams(nmodel_components=a, ndata_components=b, mi=60.0, md=10.0, theta=0.0, intensity=50000.0, **size)


def topo_grid(nx, ny, nz, h=(100.0, 80.0, 50.0)):
    """A port Grid of nx x ny x nz cells whose top layer's upper faces follow
    a surface per column (write_inputs' "topography"): no lattice."""
    from tomofastx_tpu_torch.models.grid import Grid

    k, j, i = (a.reshape(-1) for a in np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij"))
    Z1 = k * h[2] + np.where(k == 0, 0.2 * h[2] * (1.5 + np.sin(0.7 * i + 1.3 * j)), 0.0)
    return Grid(nx=nx, ny=ny, nz=nz, X1=i * h[0], X2=(i + 1) * h[0], Y1=j * h[1], Y2=(j + 1) * h[1], Z1=Z1,
                Z2=(k + 1) * h[2])


def b2_operator(case, grid, X, Y, Z, dtype, far_field_quad=1, chunk=None, pad_cells_to=1, validate=False):
    """A per-cell MatrixFreeKernel of family `case` on the card (column
    weights 1 to 2, problem weight 1.7, data weights 1 to 2)."""
    from tomofastx_tpu_torch.models.data import SurveyData
    from tomofastx_tpu_torch.ops.matrixfree import make_matrixfree_kernel

    par = b2_params(case, grid, len(X), far_field_quad)
    data = SurveyData(ndata=len(X), ncomponents=par.ndata_components)
    data.X, data.Y, data.Z = (np.asarray(a, np.float64) for a in (X, Y, Z))
    rng = np.random.default_rng(0)
    return make_matrixfree_kernel(par, grid, data, 1.0 + rng.random(grid.nelements_total), 1.7,
                                  1.0 + rng.random((len(X), par.ndata_components)), dtype, chunk=chunk,
                                  pad_cells_to=pad_cells_to, validate=validate, force_generic=True, device="cuda")


def plain_products(op, x, u, split=False):
    """The per-cell operator's products through its plain loop (the
    wrappers' plain versions; split: the plain version of the blend's split,
    main loop and near pass), weighted as MatrixFreeKernel weights them."""
    mv, rmv = (op._split_matvec, op._split_rmatvec) if split else (op._partial_matvec, op._partial_rmatvec)
    y = (op.row_w * mv(op.cw[None, :] * op._padded_model(x)))[: op.nrows].reshape(-1)
    g = op.cw[None, :] * rmv(op._padded_residual(u))
    return y, g[:, : op.ncols // op.phys.nmc].reshape(-1)


def b2_small_problems():
    """Phase 2's hold of kernel B2 against its plain loop on the card, on
    small per-cell problems of every family (8 x 6 x 4 cells with a
    topography, padded to a multiple of 7; 9 observations in chunks of 4,
    so 3 padding rows): float64 to RTOL_F64, the float32 blend to RTOL_F32
    (and both it and its plain version within PRODUCT_BLEND_RTOL of the
    float64 product, and the kernel within RTOL_SPLIT of the plain version
    of its split; its near pass alone within RTOL_F64 of the plain one, on the
    product's own vectors), float32 closed forms to RTOL_F32_CLOSED; two launches
    equal to the last bit; the cells-sharded operator over 7 slots of the
    card (each slot's cells from its own cell_lo); and a boundary-coincident
    observation, whose non-finite probe product through the kernel aborts
    the construction with PROBE_ABORT."""
    from tomofastx_tpu_torch.ops import prism_matvec as pm
    from tomofastx_tpu_torch.ops.matrixfree import PROBE_ABORT
    from tomofastx_tpu_torch.parallel.mesh import Mesh, shard_kernel

    grid = topo_grid(8, 6, 4)
    rng = np.random.default_rng(41)
    n = 9
    above = (rng.uniform(0.0, 800.0, n), rng.uniform(0.0, 480.0, n), -rng.uniform(1.0, 30.0, n))
    inside = (rng.uniform(20.0, 780.0, n), rng.uniform(20.0, 460.0, n), rng.uniform(55.0, 180.0, n))
    print("kernel B2 (csrc/prism_matvec.cuh) against its plain loop, small per-cell problems (8 x 6 x 4 cells with a "
          f"topography padded to {-(-192 // 7) * 7}, {n} observations in chunks of 4):")
    out = {}
    for case, fam in B2_FAMILIES.items():
        pts = inside if "inside" in fam else above
        ops = {"float64": b2_operator(case, grid, *pts, torch.float64, chunk=4, pad_cells_to=7),
               "float32 blend": b2_operator(case, grid, *pts, torch.float32, chunk=4, pad_cells_to=7)}
        if case in ("g_z", "TMI"):
            ops["float32 closed"] = b2_operator(case, grid, *pts, torch.float32, far_field_quad=0, chunk=4,
                                                pad_cells_to=7)
        if "inside" in fam and not ops["float64"].phys.handle_inside:
            raise SystemExit(f"FAILED kernel B2, {case}: the observations are not inside the grid")
        g = torch.Generator(device="cpu").manual_seed(len(out))
        op64 = ops["float64"]
        x64 = torch.randn(op64.ncols, generator=g, dtype=torch.float64).cuda()
        u64 = torch.randn(op64.nrows * op64.phys.ndc, generator=g, dtype=torch.float64).cuda()
        ref = (op64.matvec(x64), op64.rmatvec(u64))
        for what, op in ops.items():
            rtol = {"float64": RTOL_F64, "float32 blend": RTOL_F32, "float32 closed": RTOL_F32_CLOSED}[what]
            dt = op.xd.dtype
            x, u = x64.to(dt), u64.to(dt)
            pair = (pm.prism_matvec, pm.prism_rmatvec, pm.prism_near_matvec, pm.prism_near_rmatvec)
            before = [k.launches for k in pair]
            got = (op.matvec(x), op.rmatvec(u))
            blend = int(what == "float32 blend")
            if [k.launches - b for k, b in zip(pair, before)] != [1, 1, blend, blend]:
                raise SystemExit(f"FAILED kernel B2, {case} {what}: the products did not launch it (and the blend's "
                                 "near pass) once each")
            want = plain_products(op, x, u)
            errs = [compare(f"B2 {case}, {what}, {f}", a, b, rtol) for f, a, b in zip(("matvec", "rmatvec"), got, want)]
            if not (torch.equal(op.matvec(x), got[0]) and torch.equal(op.rmatvec(u), got[1])):
                raise SystemExit(f"FAILED kernel B2, {case} {what}: two launches differ")
            row = {"max_abs_err": max(errs), "rtol": rtol}
            if what == "float32 blend":
                for who, prods in (("kernel", got), ("plain", want)):
                    rel = max(float((p.double() - r).norm() / r.norm()) for p, r in zip(prods, ref))
                    row[f"{who}_against_float64"] = rel
                    if not rel <= PRODUCT_BLEND_RTOL:
                        raise SystemExit(f"FAILED kernel B2, {case}: the float32 blend's {who} products are "
                                         f"{rel:.3e} off the float64 ones (bound {PRODUCT_BLEND_RTOL:g})")
                print(f"  B2 {case}, float32 blend against the float64 products: kernel {row['kernel_against_float64']:.3e}"
                      f", plain {row['plain_against_float64']:.3e} (bound {PRODUCT_BLEND_RTOL:g})")
                errs = [compare(f"B2 {case}, float32 blend, {f} against the plain version of its split", a, b,
                                RTOL_SPLIT)
                        for f, a, b in zip(("matvec", "rmatvec"), got, plain_products(op, x, u, split=True))]
                row["against_the_split"] = max(errs)
                row["near_pass"] = near_pass("B2", case, op, {"matvec": pm.prism_near_matvec,
                                                              "rmatvec": pm.prism_near_rmatvec},
                                             {"matvec": op.cw[None, :] * op._padded_model(x),
                                              "rmatvec": op._padded_residual(u)}, RTOL_F64)
            out[f"{case}, {what}"] = row
    # The cells-sharded operator: each of 7 slots of the card evaluates its own
    # cells, and each cell's adjoint sum runs over the same observations in the
    # same order as unsharded.
    op = b2_operator("g_z", grid, *above, torch.float32, chunk=4, pad_cells_to=7)
    mesh7 = Mesh(np.array([torch.device("cuda")] * 7, dtype=object), ("cells",))
    ks = shard_kernel(op, mesh7)
    x = torch.randn(op.ncols, generator=torch.Generator(device="cpu").manual_seed(99), dtype=torch.float64).cuda().float()
    u = torch.randn(op.nrows, generator=torch.Generator(device="cpu").manual_seed(98), dtype=torch.float64).cuda().float()
    compare("B2 g_z float32 over 7 slots of the card (cell_lo " + ", ".join(str(p.cell_lo) for p in ks.parts)
            + "), matvec against unsharded", ks.matvec(x), op.matvec(x), RTOL_F32)
    if not torch.equal(ks.rmatvec(u), op.rmatvec(u)):
        raise SystemExit("FAILED kernel B2: the 7-slot rmatvec differs from the unsharded one")
    print("  B2 g_z float32 over 7 slots of the card: rmatvec equal to the last bit to the unsharded one -> ok")
    # A boundary-coincident observation: the grid's top layer flattened to z = 0
    # and a point on a corner of it.
    flat = topo_grid(4, 3, 2)
    flat.Z1 = np.where(flat.Z1 < 50.0, 0.0, flat.Z1)
    for dt in (torch.float64, torch.float32):
        before = pm.prism_matvec.launches
        try:
            b2_operator("g_z", flat, [100.0, 150.0], [80.0, 90.0], [0.0, -10.0], dt, validate=True)
        except ValueError as e:
            if str(e) != PROBE_ABORT:
                raise
        else:
            raise SystemExit(f"FAILED kernel B2: a boundary-coincident observation did not abort ({dt})")
        if pm.prism_matvec.launches != before + 1:
            raise SystemExit("FAILED kernel B2: the construction probe did not go through the kernel")
        print(f"  B2 probe matvec on a boundary-coincident observation ({dt}): PROBE_ABORT raised -> ok")
    torch.cuda.synchronize()
    return out


def b2_pairs(op):
    """(near, far) pairs of a full-width operator: for the float32 blend by
    its far mask over this run's observations and cells, else all closed."""
    from tomofastx_tpu_torch.ops import prism

    total = op.xd.shape[0] * op.N
    if not op.phys.far_quad:
        return total, 0
    near = 0
    for s in range(0, op.xd.shape[0], 128):
        sl = slice(s, s + 128)
        near += int((~prism.far_mask(op.xd[sl, None], op.yd[sl, None], op.zd[sl, None], *op.grid6)).sum())
    return near, total - near


def b2_bound(op, nout, nin, pairs=None):
    """Kernel B2's least milliseconds for one product of `op` (module
    comment above B2_QUAD_FLOPS), from its (near, far) pairs (b2_pairs(op)
    unless given): (the largest, which, each time, near, far)."""
    near, far = pairs or b2_pairs(op)
    key, elt = b2_family_key(op.phys), op.xd.element_size()
    times = {
        "bytes": (6 * op.N + 3 * op.xd.shape[0] + nin + nout) * elt / MEMORY_BYTES_PER_S * 1e3,
        "special functions": 27 * far / MUFU_PER_S * 1e3,
        "float32 operations": B2_QUAD_FLOPS[key] * far / FP32_FLOP_PER_S * 1e3,
        "float64 operations": B2_CLOSED_FLOPS[key] * near / FP64_FLOP_PER_S * 1e3,
    }
    which = max(times, key=times.get)
    return times[which], "bytes" if which == "bytes" else "operations", which, times, near, far


def measure_b2(name, op, rtol, reps=10):
    """Kernel B2 on a full-width operator against its plain loop (the
    wrappers' plain versions, on the card): each product held to rtol of
    max|y|, two launches equal to the last bit, the kernel timed by CUDA
    events (median of `reps`), the plain loop (its one call, the one
    compared), and the bound of this run's pairs."""
    from tomofastx_tpu_torch.ops import prism_matvec as pm

    g = torch.Generator(device="cpu").manual_seed(37)
    dt, nmc, ndc, nrows = op.xd.dtype, op.phys.nmc, op.phys.ndc, op.xd.shape[0]
    xw = op.cw[None, :] * torch.randn((nmc, op.N), generator=g, dtype=torch.float64).to("cuda", dt)
    u = op.row_w * torch.randn((nrows, ndc), generator=g, dtype=torch.float64).to("cuda", dt)
    out = {"shape": [nrows, op.N, nmc, ndc], "dtype": str(dt)}
    for f, kernel, plain, v, nout in (("matvec", pm.prism_matvec, op._partial_matvec, xw, nrows * ndc),
                                      ("rmatvec", pm.prism_rmatvec, op._partial_rmatvec, u, nmc * op.N)):
        got = kernel(op, v)
        want, plain_ms = timed_once(lambda: plain(v))
        err = compare(f"B2 {name}, {f} against its plain loop", got, want, rtol)
        del want
        if not torch.equal(kernel(op, v), got):
            raise SystemExit(f"FAILED B2 {name}: two {f} launches differ")
        ms = time_cuda(lambda: kernel(op, v), warm=1, reps=reps)
        bound_ms, bound_by, which, times, near, far = b2_bound(op, nout, v.numel())
        out[f] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "bound_unit": which,
                  "bound_times_ms": times, "near_pairs": near, "far_pairs": far, "max_abs_err": err,
                  "library_ms": None}
        print(f"  B2 {name} {f}: kernel {ms:.3f} ms (median of {reps}), plain loop {plain_ms:.1f} ms, bound "
              f"{bound_ms:.3f} ms by {which} (" + ", ".join(f"{k} {t:.3f}" for k, t in times.items())
              + f" ms; {near:,} near pairs, {far:,} far)")
    if op.phys.far_quad:
        out["registers"] = kernel_registers([("prism_matvec_partials", True), ("prism_rmatvec_kernel", True),
                                             ("prism_near_rows_kernel", False), ("prism_near_matvec_kernel", "stream"),
                                             ("prism_near_rmatvec_kernel", "stream")])
        print("  B2 registers (ptxas): " + "; ".join(f"{k} " + ", ".join(f"{fam} {r}" for fam, r in v.items())
                                                   for k, v in out["registers"].items()))
        near = out["matvec"]["near_pairs"]
        out["near"] = near_pass("B2", name, op, {"matvec": pm.prism_near_matvec, "rmatvec": pm.prism_near_rmatvec},
                                {"matvec": xw, "rmatvec": u}, RTOL_F64, reps=reps)
        near_bounds(out["near"], "B2", name, op, near, B2_CLOSED_FLOPS[b2_family_key(op.phys)])
    return out


def near_bounds(near, tag, name, op, pairs, corner_flops):
    """The bounds of a blend's near passes and of its rows' build (near_pass's
    readings `near`, updated), printed beside their times."""
    for f in ("matvec", "rmatvec"):
        bound_ms, bound_by, which, times = near_bound(op, pairs, corner_flops, f)
        row = near[f]
        row.update(bound_ms=bound_ms, bound_by=bound_by, bound_unit=which, bound_times_ms=times, near_pairs=pairs,
                   library_ms=None)
        on = f" on {row['plain_on']}" if "plain_on" in row else ""
        print(f"  {tag} {name} near pass {f}: kernel {row['ms']:.3f} ms one call a pair of events "
              f"({row['ms_on_card']:.4f} ms on the card alone), plain {row['plain_ms']:.1f} ms over the stored rows{on} "
              f"({row['plain_ms_recomputing']:.1f} ms evaluating them again), bound {bound_ms:.4f} ms by bytes "
              f"({pairs:,} near pairs; their closed forms {times[list(times)[1]]:.4f} ms by float64 operations)")
    bound_ms, bound_by, times = near_build_bound(op, pairs, corner_flops)
    near["rows"].update(bound_ms=bound_ms, bound_by=bound_by, bound_times_ms=times, library_ms=None)
    print(f"  {tag} {name} near rows' build: {near['rows']['build_ms']:.3f} ms (plain build "
          f"{near['rows']['plain_build_ms']:.1f} ms" + (f" on {near['rows']['plain_on']}" if "plain_on" in near["rows"]
                                                         else "") + f"), bound {bound_ms:.4f} ms by {bound_by}")


# ---------------------------------------------------------------------------
# Kernel B3: the corner-lattice matrix-free operator's products (csrc/lattice_matvec.cu).
# ---------------------------------------------------------------------------

# The lattice families: B2_FAMILIES but the borehole branch (the per-cell
# operator's).
B3_FAMILIES = [k for k, fam in B2_FAMILIES.items() if "inside" not in fam]
# Kernel B3's bound is by operations, from this run's pairs and corners
# (csrc/lattice_matvec.cu): a pair of the blend outside its observation's
# window is 8 reciprocal square roots, in it 27 (MUFU_PER_S), with
# B2_QUAD_FLOPS / 27 float32 operations a point; a near pair's closed forms 8
# corners of B3_CORNER_FLOPS float64 operations; the closed forms
# (1 + nx)(1 + ny)(1 + nz) corners an observation, each evaluated once, and
# 8 operations a cell value to difference and sum them, in float64. Each
# square root, arc tangent and log counts as one operation: a loose lower
# bound, as for B2.
B3_CORNER_FLOPS = {"grav1": 19, "grav2": 9, "grav6": 45, "magn": 35}


@contextlib.contextmanager
def lattice_products_by_the_plain_loop():
    """The lattice operator's products through its plain chunk loop on any
    device (kernel B3's wrappers set aside, their counts untouched)."""
    from tomofastx_tpu_torch.ops import matrixfree as mf

    kept = mf.lattice_matvec, mf.lattice_rmatvec
    mf.lattice_matvec = lambda op, xw: op._partial_matvec(xw)
    mf.lattice_rmatvec = lambda op, u: op._partial_rmatvec(u)
    try:
        yield
    finally:
        mf.lattice_matvec, mf.lattice_rmatvec = kept


def lattice_grid(nx, ny, nz, h=(100.0, 80.0, 50.0)):
    """A port Grid of nx x ny x nz cells on a lattice whose top is z = 0."""
    from tomofastx_tpu_torch.models.grid import Grid

    k, j, i = (a.reshape(-1) for a in np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij"))
    return Grid(nx=nx, ny=ny, nz=nz, X1=i * h[0], X2=(i + 1) * h[0], Y1=j * h[1], Y2=(j + 1) * h[1], Z1=k * h[2],
                Z2=(k + 1) * h[2])


def b3_operator(case, grid, X, Y, Z, dtype, far_field_quad=1, chunk=None, validate=False, device="cuda"):
    """A LatticeMatrixFreeKernel of family `case` on `device` (column
    weights 1 to 2, problem weight 1.7, data weights 1 to 2)."""
    from tomofastx_tpu_torch.models.data import SurveyData
    from tomofastx_tpu_torch.ops.matrixfree import LatticeMatrixFreeKernel, make_matrixfree_kernel

    par = b2_params(case, grid, len(X), far_field_quad)
    data = SurveyData(ndata=len(X), ncomponents=par.ndata_components)
    data.X, data.Y, data.Z = (np.asarray(a, np.float64) for a in (X, Y, Z))
    rng = np.random.default_rng(0)
    op = make_matrixfree_kernel(par, grid, data, 1.0 + rng.random(grid.nelements_total), 1.7,
                                1.0 + rng.random((len(X), par.ndata_components)), dtype, chunk=chunk,
                                validate=validate, force_no_fft=True, device=device)
    if not isinstance(op, LatticeMatrixFreeKernel):
        raise SystemExit(f"FAILED kernel B3, {case}: {type(op).__name__} built")
    return op


def lattice_plain_products(op, x, u, split=False):
    """The lattice operator's products through its plain loop (the
    wrappers' plain versions; split: the plain version of the blend's split,
    main loop and near pass), weighted as LatticeMatrixFreeKernel weights
    them."""
    mv, rmv = (op._split_matvec, op._split_rmatvec) if split else (op._partial_matvec, op._partial_rmatvec)
    y = (op.row_w * mv(op.cw[None, :] * x.reshape(op.nmc, op.N)))[: op.nrows].reshape(-1)
    return y, (op.cw[None, :] * rmv(op._padded_residual(u))).reshape(-1)


def kernel_rows(op, s, e):
    """Rows [s, e) of a lattice operator (before the weights) through kernel
    B3's rmatvec, one launch a row: (e - s, nmc * N)."""
    from tomofastx_tpu_torch.ops.lattice_matvec import lattice_rmatvec

    rows = []
    for b in range(s, e):
        u = torch.zeros((op.xd.shape[0], op.ndc), dtype=op.xd.dtype, device="cuda")
        u[b, 0] = 1.0
        rows.append(lattice_rmatvec(op, u).reshape(-1))
    return torch.stack(rows)


def b3_small_problems():
    """Phase 2's hold of kernel B3 against its plain loop on the card, on
    small lattice problems of every family (12 x 10 x 9 cells: a partial
    tile on every axis; 11 observations in chunks of 4, so one padding row,
    three on lattice planes, one of them above a lattice node): float64 to
    RTOL_F64, the float32 blend to RTOL_F32 (and both it and its plain
    version within PRODUCT_BLEND_RTOL of the float64 product, the kernel
    within RTOL_SPLIT of the plain version of its split, and its near pass
    alone within RTOL_F64 of the plain one), float32
    closed forms no further from the float64 products than 1.5 x the plain
    loop (their corner differences carry float32 rounding far from a cell,
    in either); two launches equal to the last bit; the float64 products of
    the lattice-plane observations against the same operator's plain loop
    on the CPU (the magnetic and FTG sign conventions, RTOL_F64_FULL); and
    the operator sharded over 3 slots of the card (its matvec equal to the
    last bit to the unsharded one)."""
    from tomofastx_tpu_torch.ops import lattice_matvec as lm
    from tomofastx_tpu_torch.parallel.mesh import Mesh, shard_kernel

    grid = lattice_grid(12, 10, 9)
    rng = np.random.default_rng(43)
    n = 11
    X, Y, Z = rng.uniform(0.0, 1200.0, n), rng.uniform(0.0, 800.0, n), -rng.uniform(1.0, 30.0, n)
    X[:3], Y[:3] = (300.0, 555.5, 700.0), (123.4, 240.0, 560.0)  # on an x plane, a y plane, above a node
    print("kernel B3 (csrc/lattice_matvec.cu) against its plain loop, small lattice problems (12 x 10 x 9 cells, "
          f"{n} observations in chunks of 4, three on lattice planes):")
    out = {}
    for case in B3_FAMILIES:
        ops = {"float64": b3_operator(case, grid, X, Y, Z, torch.float64, chunk=4),
               "float32 blend": b3_operator(case, grid, X, Y, Z, torch.float32, chunk=4)}
        if case in ("g_z", "TMI"):
            ops["float32 closed"] = b3_operator(case, grid, X, Y, Z, torch.float32, far_field_quad=0, chunk=4)
        g = torch.Generator(device="cpu").manual_seed(len(out))
        op64 = ops["float64"]
        x64 = torch.randn(op64.ncols, generator=g, dtype=torch.float64).cuda()
        u64 = torch.randn(op64.nrows * op64.ndc, generator=g, dtype=torch.float64).cuda()
        ref = (op64.matvec(x64), op64.rmatvec(u64))
        for what, op in ops.items():
            dt = op.xd.dtype
            x, u = x64.to(dt), u64.to(dt)
            pair = (lm.lattice_matvec, lm.lattice_rmatvec, lm.lattice_near_matvec, lm.lattice_near_rmatvec)
            before = [k.launches for k in pair]
            got = (op.matvec(x), op.rmatvec(u))
            blend = int(what == "float32 blend")
            if [k.launches - b for k, b in zip(pair, before)] != [1, 1, blend, blend]:
                raise SystemExit(f"FAILED kernel B3, {case} {what}: the products did not launch it (and the blend's "
                                 "near pass) once each")
            want = lattice_plain_products(op, x, u)
            if not (torch.equal(op.matvec(x), got[0]) and torch.equal(op.rmatvec(u), got[1])):
                raise SystemExit(f"FAILED kernel B3, {case} {what}: two launches differ")
            if what == "float32 closed":
                row = {}
                for who, prods in (("kernel", got), ("plain", want)):
                    row[f"{who}_against_float64"] = max(float((p.double() - r).abs().max() / r.abs().max())
                                                        for p, r in zip(prods, ref))
                ok = row["kernel_against_float64"] <= 1.5 * row["plain_against_float64"]
                print(f"  B3 {case}, float32 closed forms against the float64 products: kernel "
                      f"{row['kernel_against_float64']:.3e}, plain {row['plain_against_float64']:.3e} of max|y| "
                      f"(the kernel within 1.5 x the plain loop) -> {'ok' if ok else 'FAILED'}")
                if not ok:
                    raise SystemExit(f"FAILED kernel B3, {case}: float32 closed forms")
                out[f"{case}, {what}"] = row
                continue
            rtol = RTOL_F64 if what == "float64" else RTOL_F32
            errs = [compare(f"B3 {case}, {what}, {f}", a, b, rtol) for f, a, b in zip(("matvec", "rmatvec"), got, want)]
            row = {"max_abs_err": max(errs), "rtol": rtol}
            if what == "float32 blend":
                for who, prods in (("kernel", got), ("plain", want)):
                    rel = max(float((p.double() - r).norm() / r.norm()) for p, r in zip(prods, ref))
                    row[f"{who}_against_float64"] = rel
                    if not rel <= PRODUCT_BLEND_RTOL:
                        raise SystemExit(f"FAILED kernel B3, {case}: the float32 blend's {who} products are "
                                         f"{rel:.3e} off the float64 ones (bound {PRODUCT_BLEND_RTOL:g})")
                print(f"  B3 {case}, float32 blend against the float64 products: kernel {row['kernel_against_float64']:.3e}"
                      f", plain {row['plain_against_float64']:.3e} (bound {PRODUCT_BLEND_RTOL:g})")
                errs = [compare(f"B3 {case}, float32 blend, {f} against the plain version of its split", a, b,
                                RTOL_SPLIT)
                        for f, a, b in zip(("matvec", "rmatvec"), got, lattice_plain_products(op, x, u, split=True))]
                row["against_the_split"] = max(errs)
                row["near_pass"] = near_pass("B3", case, op, {"matvec": lm.lattice_near_matvec,
                                                              "rmatvec": lm.lattice_near_rmatvec},
                                             {"matvec": op.cw[None, :] * x.reshape(op.nmc, op.N),
                                              "rmatvec": op._padded_residual(u)}, RTOL_F64)
            out[f"{case}, {what}"] = row
        if case in ("FTG-6", "TMI", "MVI 3-component"):
            cpu = b3_operator(case, grid, X, Y, Z, torch.float64, chunk=4, device="cpu")
            for f, a, v in (("matvec", ref[0], x64), ("rmatvec", ref[1], u64)):
                compare(f"B3 {case}, float64 on the card against the CPU's plain loop, lattice-plane observations, {f}",
                        a.cpu(), getattr(cpu, f)(v.cpu()), RTOL_F64_FULL)
    # Sharded over the observations on 3 slots of the card: each observation's
    # matvec row is summed as unsharded.
    op = b3_operator("g_z", grid, X, Y, Z, torch.float32, chunk=4)
    mesh3 = Mesh(np.array([torch.device("cuda")] * 3, dtype=object), ("cells",))
    ks = shard_kernel(op, mesh3)
    x = torch.randn(op.ncols, generator=torch.Generator(device="cpu").manual_seed(99), dtype=torch.float64).cuda().float()
    u = torch.randn(op.nrows, generator=torch.Generator(device="cpu").manual_seed(98), dtype=torch.float64).cuda().float()
    if not torch.equal(ks.matvec(x), op.matvec(x)):
        raise SystemExit("FAILED kernel B3: the 3-slot matvec differs from the unsharded one")
    compare("B3 g_z float32 over 3 slots of the card, rmatvec against unsharded", ks.rmatvec(u), op.rmatvec(u),
            RTOL_F32)
    print("  B3 g_z float32 over 3 slots of the card: matvec equal to the last bit to the unsharded one -> ok")
    torch.cuda.synchronize()
    return out


def b3_probe():
    """The construction's probe on a boundary-coincident observation (on a
    corner of the lattice's top face): its non-finite product through kernel
    B3 aborts the construction with PROBE_ABORT, float64 and float32."""
    from tomofastx_tpu_torch.ops import lattice_matvec as lm
    from tomofastx_tpu_torch.ops.matrixfree import PROBE_ABORT

    grid = lattice_grid(4, 3, 2)
    for dt in (torch.float64, torch.float32):
        before = lm.lattice_matvec.launches
        try:
            b3_operator("g_z", grid, [100.0, 150.0], [80.0, 90.0], [0.0, -10.0], dt, validate=True)
        except ValueError as e:
            if str(e) != PROBE_ABORT:
                raise
        else:
            raise SystemExit(f"FAILED kernel B3: a boundary-coincident observation did not abort ({dt})")
        if lm.lattice_matvec.launches != before + 1:
            raise SystemExit("FAILED kernel B3: the construction probe did not go through the kernel")
        print(f"  B3 probe matvec on a boundary-coincident observation ({dt}): PROBE_ABORT raised -> ok")


def b3_pairs(op):
    """(near, window, far) pairs of a full-width blended lattice operator
    over this run's observations (near: the window's cells within the near
    radius, by the plain version's mask; window: the others of the window;
    far: the cells outside it); of a closed-form one (0, 0, all)."""
    from tomofastx_tpu_torch.ops import prism
    from tomofastx_tpu_torch.ops.matrixfree import _lattice_bounds

    nrows = op.xd.shape[0]
    if not op.far_quad:
        return 0, 0, nrows * op.N
    wz, wy, wx = op.win
    near = 0
    for s in range(0, nrows, 128):
        sl = slice(s, s + 128)
        iz, iy, ix = (op.wi0[sl, a, None].long() + torch.arange(w + 1, device="cuda") for a, w in enumerate(op.win))
        bounds = _lattice_bounds(op.xe[ix], op.ye[iy], op.ze[iz])
        xs, ys, zs = (a[sl][:, None, None, None] for a in (op.xd, op.yd, op.zd))
        near += int((~prism.far_mask(xs, ys, zs, *bounds)).sum())
    return near, nrows * wz * wy * wx - near, nrows * (op.N - wz * wy * wx)


def b3_bound(op, nout, nin):
    """Kernel B3's least milliseconds for one product of `op` (module
    comment above B3_CORNER_FLOPS): (the largest, which, and each time)."""
    near, window, far = b3_pairs(op)
    key = "magn" if op.problem == "magn" else f"grav{1 if op.data_type == 1 else 2 if op.ndc == 1 else 6}"
    elt, nrows = op.xd.element_size(), op.xd.shape[0]
    nbytes = (op.nx + op.ny + op.nz + 3 + 3 * nrows + nin + nout) * elt + (nrows * 3 * 4 if op.far_quad else 0)
    times = {"bytes": nbytes / MEMORY_BYTES_PER_S * 1e3}
    if op.far_quad:
        points = 8 * far + 27 * window
        times["special functions"] = points / MUFU_PER_S * 1e3
        times["float32 operations"] = B2_QUAD_FLOPS[key] / 27 * points / FP32_FLOP_PER_S * 1e3
        times["float64 operations"] = B3_CORNER_FLOPS[key] * 8 * near / FP64_FLOP_PER_S * 1e3
    else:
        flops = B3_CORNER_FLOPS[key] * nrows * (op.nx + 1) * (op.ny + 1) * (op.nz + 1) + 8 * op.nmc * op.ndc * far
        if elt == 8:
            times["float64 operations"] = flops / FP64_FLOP_PER_S * 1e3
        else:
            times["float32 operations"] = flops / FP32_FLOP_PER_S * 1e3
    which = max(times, key=times.get)
    return times[which], "bytes" if which == "bytes" else "operations", which, times, (near, window, far)


def measure_b3(name, op, rtol, reps=10):
    """Kernel B3 on a full-width lattice operator against its plain loop
    (the wrappers' plain versions, on the card): each product held to rtol
    of max|y|, two launches equal to the last bit, the kernel timed by CUDA
    events (median of `reps`), the plain loop (its one call, the one
    compared), and the bound of this run's pairs and corners."""
    from tomofastx_tpu_torch.ops import lattice_matvec as lm

    g = torch.Generator(device="cpu").manual_seed(37)
    dt, nmc, ndc, nrows = op.xd.dtype, op.nmc, op.ndc, op.xd.shape[0]
    xw = op.cw[None, :] * torch.randn((nmc, op.N), generator=g, dtype=torch.float64).to("cuda", dt)
    u = op.row_w * torch.randn((nrows, ndc), generator=g, dtype=torch.float64).to("cuda", dt)
    out = {"shape": [nrows, op.N, nmc, ndc], "dtype": str(dt), "mode": "blend" if op.far_quad else "closed"}
    for f, kernel, plain, v, nout in (("matvec", lm.lattice_matvec, op._partial_matvec, xw, nrows * ndc),
                                      ("rmatvec", lm.lattice_rmatvec, op._partial_rmatvec, u, nmc * op.N)):
        got = kernel(op, v)
        want, plain_ms = timed_once(lambda: plain(v))
        err = compare(f"B3 {name}, {f} against its plain loop", got, want, rtol)
        del want
        if not torch.equal(kernel(op, v), got):
            raise SystemExit(f"FAILED B3 {name}: two {f} launches differ")
        ms = time_cuda(lambda: kernel(op, v), warm=1, reps=reps)
        bound_ms, bound_by, which, times, pairs = b3_bound(op, nout, v.numel())
        out[f] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "bound_unit": which,
                  "bound_times_ms": times, "near_window_far_pairs": pairs, "max_abs_err": err, "library_ms": None}
        print(f"  B3 {name} {f}: kernel {ms:.3f} ms (median of {reps}), plain loop {plain_ms:.1f} ms, bound "
              f"{bound_ms:.3f} ms by {which} (" + ", ".join(f"{k} {t:.3f}" for k, t in times.items())
              + f" ms; pairs near {pairs[0]:,}, window {pairs[1]:,}, outside {pairs[2]:,})")
    if op.far_quad:
        out["registers"] = kernel_registers([("lattice_matvec_partials", True), ("lattice_rmatvec_partials", True),
                                             ("lattice_near_rows_kernel", False),
                                             ("lattice_near_matvec_kernel", "stream"),
                                             ("lattice_near_rmatvec_kernel", "stream")])
        print("  B3 registers (ptxas): " + "; ".join(f"{k} " + ", ".join(f"{fam} {r}" for fam, r in v.items())
                                                   for k, v in out["registers"].items()))
        near = out["matvec"]["near_window_far_pairs"][0]
        key = "magn" if op.problem == "magn" else f"grav{1 if op.data_type == 1 else 2 if op.ndc == 1 else 6}"
        out["near"] = near_pass("B3", name, op, {"matvec": lm.lattice_near_matvec,
                                                 "rmatvec": lm.lattice_near_rmatvec},
                                {"matvec": xw, "rmatvec": u}, RTOL_F64, reps=reps)
        near_bounds(out["near"], "B3", f"{name} ({op.near_cells.numel():,} candidates)", op, near,
                    8 * B3_CORNER_FLOPS[key])
    return out


# ---------------------------------------------------------------------------
# Kernel B1 and phases 24-27: the build and storage variants, refineForward.
# ---------------------------------------------------------------------------

# A bfloat16 kernel holds 8 bits of each entry (2^-9 relative rounding),
# which the 3 majors x 20 float32 LSQR iterations carry into the model: the
# bfloat16 main path is held to the formats' tolerance against the float32
# dense run where it meets it, and otherwise to BF16_MODEL_TOL of the range
# (five times the formats', for entries 2^15 times coarser than float32's),
# with the reading printed either way.
BF16_MODEL_TOL = 1e-2
# The kernels of the three builds against the float64-built cache: the
# bound of tests/test_matrixfree.py:156-183 (Frobenius, of the norm).
BUILD_FROBENIUS_RTOL = 1e-3
FAST_BUILD_K = 64


def frobenius(a, b=None, rows=256):
    """||a - b||_F (or ||a||_F) of two float32 or bfloat16 matrices on the
    card, summed in float64 a block of rows at a time."""
    total = 0.0
    for s in range(0, a.shape[0], rows):
        blk = a[s : s + rows].double()
        if b is not None:
            blk -= b[s : s + rows].double()
        total += float((blk * blk).sum())
    return total ** 0.5


def measure_bf16_gemv(S32):
    """Kernel B1 (csrc/bf16_gemv.cu) on the full-width matrix cast to
    bfloat16: each product against its plain version (f32 and f64 vectors),
    two launches equal to the last bit, and its time beside the bytes bound,
    the plain version and two torch.mv yardsticks that compute other
    functions: torch.mv on the bfloat16 S with the vector cast to bfloat16
    (the same bytes; a rounded vector and bfloat16 sums), and torch.mv on
    the float32 matrix (twice the bytes). No PyTorch call computes this
    function, so library_ms is null."""
    from tomofastx_tpu_torch.ops import bf16_gemv as bg

    S = S32.to(torch.bfloat16)
    nrows, ncols = S.shape
    print(f"kernel B1, the bfloat16 GEMV pair, on the dense matrix cast to bfloat16 {tuple(S.shape)} "
          f"({S.numel() * 2:,} bytes):")
    x64, u64 = seeded_vector(ncols, 10, "cuda")[:ncols], seeded_vector(nrows, 11, "cuda")[:nrows]
    out = {}
    for name, kernel, plain, v64, nout, yard_bf16, yard_f32 in (
            ("bf16_matvec", bg.bf16_matvec, bg.bf16_matvec_plain, x64, nrows,
             lambda v: torch.mv(S, v.bfloat16()), lambda v: torch.mv(S32, v)),
            ("bf16_rmatvec", bg.bf16_rmatvec, bg.bf16_rmatvec_plain, u64, ncols,
             lambda v: torch.mv(S.T, v.bfloat16()), lambda v: torch.mv(S32.T, v))):
        v32 = v64.float()
        y = kernel(S, v32)
        err32 = compare(f"{name}, full width, f32 vector", y, plain(S, v32), RTOL_F32)
        err64 = compare(f"{name}, full width, f64 vector", kernel(S, v64), plain(S, v64), RTOL_F64)
        same = torch.equal(kernel(S, v32), y)
        if not same:
            raise SystemExit(f"FAILED {name}: two launches on the same vector differ")
        ms = time_cuda(lambda: kernel(S, v32))
        ms64 = time_cuda(lambda: kernel(S, v64), reps=10)
        plain_ms = time_cuda(lambda: plain(S, v32), warm=1, reps=5)
        bf16_ms = time_cuda(lambda: yard_bf16(v32))
        f32_ms = time_cuda(lambda: yard_f32(v32))
        scale = float(y.abs().max())
        bf16_err = float((yard_bf16(v32).float() - y).abs().max()) / scale
        f32_err = float((yard_f32(v32) - y).abs().max()) / scale
        nbytes = S.numel() * 2 + v32.numel() * 4 + nout * 4
        bound_ms, bound_by, by_bytes, by_ops = bound(nbytes, 2 * S.numel())
        print(f"  {name}: kernel {ms:.3f} ms ({nbytes / ms / 1e6:.0f} GB/s of {nbytes:,} bytes; f64 vector "
              f"{ms64:.3f} ms), bound {bound_ms:.3f} ms by {bound_by} (bytes {by_bytes:.3f} ms at "
              f"{MEMORY_BYTES_PER_S / 1e12:.2f} TB/s, operations {by_ops:.3f} ms), plain {plain_ms:.3f} ms; "
              f"yardsticks: torch.mv on the bfloat16 S with a bfloat16 vector {bf16_ms:.3f} ms (off the kernel by "
              f"{bf16_err:.2e} of max|y|), torch.mv on the float32 matrix {f32_ms:.3f} ms (off by {f32_err:.2e}); "
              "two launches equal to the last bit")
        out[name] = {"ms": ms, "ms_f64_vector": ms64, "plain_ms": plain_ms, "library_ms": None,
                     "torch_mv_bf16_ms": bf16_ms, "torch_mv_f32_ms": f32_ms,
                     "torch_mv_bf16_off_by": bf16_err, "torch_mv_f32_off_by": f32_err,
                     "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                     "max_abs_err": err32, "max_abs_err_f64_vector": err64,
                     "achieved_GB_per_s": nbytes / ms / 1e6, "shape": list(S.shape)}
    del S
    torch.cuda.empty_cache()
    return out


def phase_24(cli, counters, work, inputs, dense, dense_dir):
    """tpu.kernelStoreDtype = bfloat16 at full width through the command
    line: the dense kernel built straight into bfloat16, every product
    through kernel B1; --mesh 1 to the last bit; against the float32 dense
    run."""
    print("bfloat16 kernel storage (tpu.kernelStoreDtype = bfloat16), dense:")
    extra = ["tpu.kernelStoreDtype = bfloat16"]
    out = {f: os.path.join(work, f"out_bf16_{f}") for f in ("run", "mesh1")}
    said = {"build_s": r"kernel built in ([0-9.]+)s", "format": DENSE_BF16_SAID,
            "no_cache": r"NOT writing the sensit cache: the kernel is stored bfloat16"}
    runs = {"run": run_main_path(cli, counters, "bfloat16 dense", write_parfile(
        work, "Parfile_bf16.txt", inputs, out["run"], N_MINOR, fmt=None, extra=extra), out["run"], said,
        sensit_written=False)}
    runs["mesh1"] = run_main_path(cli, counters, "bfloat16 dense --mesh 1", write_parfile(
        work, "Parfile_bf16_mesh1.txt", inputs, out["mesh1"], N_MINOR, fmt=None, extra=extra), out["mesh1"],
        {**said, "slot0_MB": r"slot 0 \(cuda:0\) ([0-9.]+) MB"}, sensit_written=False, mesh="1")
    for name, run in runs.items():
        iters = run["lsqr_iterations"]
        # matvec: one per LSQR iteration and the 3 + N_MAJOR forward products;
        # rmatvec: one per iteration and one before each solve.
        want = {"bf16_matvec": sum(iters) + 3 + N_MAJOR, "bf16_rmatvec": sum(iters) + len(iters)}
        print(f"  {name}: launches {run['launches']} (expected {want})")
        if not launched(run["launches"], **want):
            raise SystemExit(f"FAILED bfloat16 dense {name}: launch count")
    held = hold_equal("bfloat16 dense --mesh 1", runs["mesh1"], out["mesh1"], runs["run"], out["run"])
    if not held["equal_to_the_last_bit"]:
        raise SystemExit("FAILED bfloat16 dense --mesh 1: not equal to the last bit to the unmeshed run")
    r, ref = runs["run"], dense
    dm = float(np.abs(r["model"] - ref["model"]).max() / (ref["model"].max() - ref["model"].min()))
    dc = abs(r["data_cost"][-1] - ref["data_cost"][-1]) / ref["data_cost"][-1]
    tol = FORMATS_MODEL_TOL if dm <= FORMATS_MODEL_TOL else BF16_MODEL_TOL
    print(f"  bfloat16 against the float32 dense run: final model differs by {dm:.3e} of its range (tolerance "
          f"{tol:g}{'' if tol == FORMATS_MODEL_TOL else ', the bfloat16 bound: the formats tolerance ' + str(FORMATS_MODEL_TOL) + ' is not met'}), "
          f"final data cost {r['data_cost'][-1]:.9e} against {ref['data_cost'][-1]:.9e}, relative {dc:.3e} "
          f"(tolerance {FORMATS_COST_RTOL:g}); peak device memory {r['peak_device_GB']:.2f} GB, "
          f"{r['peak_device_GB'] - r['held_before_GB']:.2f} GB over what was held before the run, against "
          f"{ref['peak_device_GB']:.2f} and {ref['peak_device_GB'] - ref['held_before_GB']:.2f} GB for float32")
    if not dm <= tol or not dc <= FORMATS_COST_RTOL:
        raise SystemExit("FAILED bfloat16 dense against float32 dense")
    return {"runs": runs, "mesh1": held, "against_float32_dense": {
        "model_of_range": dm, "data_cost_rel": dc, "model_tolerance": tol,
        "peak_device_GB": r["peak_device_GB"], "float32_peak_device_GB": ref["peak_device_GB"],
        "peak_over_held_GB": r["peak_device_GB"] - r["held_before_GB"],
        "float32_peak_over_held_GB": ref["peak_device_GB"] - ref["held_before_GB"]}}


def phase_25(cli, counters, work, inputs, ref_dir, par, grid, products):
    """The tiled main path built three ways through the command line: the
    compensated float32 build, the mixed build and the float32-compressed
    float64 build; each stored kernel (its cache) against the float64-built
    cache of phase 3."""
    from tomofastx_tpu_torch.io.sensit_cache import try_read_kernel_cache

    print("the tiled main path built three ways:")
    out = {}
    for name, args in (("single", ["--build-precision", "single"]), ("fast_build", ["--fast-build", str(FAST_BUILD_K)]),
                       ("f32_compress", ["--f32-compress"])):
        out_dir = os.path.join(work, f"out_tiled_{name}")
        run = run_main_path(cli, counters, f"tiled, {' '.join(args)}", write_parfile(
            work, f"Parfile_tiled_{name}.txt", inputs, out_dir, N_MINOR, fmt="tiled"), out_dir, {
                "build_s": r"kernel built\+cached in ([0-9.]+)s", "pack_s": r"cache packed into tiles in ([0-9.]+)s",
                "format": r"grav kernel: tiled"}, args=args)
        if not launched(run["launches"], tile_matvec=products):
            raise SystemExit(f"FAILED tiled {name}: launch count")
        run["out_dir"], run["args"] = out_dir, args
        out[name] = run
    ref = try_read_kernel_cache(os.path.join(ref_dir, "SENSIT"), par, grid, "cuda").S
    ref_norm = frobenius(ref)
    for name, run in out.items():
        S = try_read_kernel_cache(os.path.join(run["out_dir"], "SENSIT"), par, grid, "cuda").S
        dist = run["frobenius_from_f64_build"] = frobenius(S, ref) / ref_norm
        del S
        print(f"  tiled {' '.join(run['args'])}: build_s {run['build_s']}, its cache's Frobenius distance from the "
              f"float64-built cache {dist:.3e} of its norm (bound {BUILD_FROBENIUS_RTOL:g}, "
              "tests/test_matrixfree.py:156-183)")
        if not dist < BUILD_FROBENIUS_RTOL:
            raise SystemExit(f"FAILED tiled {name}: the kernel is too far from the float64 build")
    del ref
    torch.cuda.empty_cache()
    return out


def phase_26(cli, counters, work, inputs, products, cache_dir):
    """tpu.refineForward = 1 on the tiled path, read from the tiled main
    path's cache (cache_dir), the forward in the solve's precision and in
    float64 (the BTTB operator on complex128 FFTs), the latter with --mesh 1
    to the last bit; the predicted data against a dense uncompressed forward
    of the final model."""
    import dataclasses

    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.io import data_io, model_io
    from tomofastx_tpu_torch.ops import sensitivity as sens

    print("tpu.refineForward = 1 on the tiled path:")
    cached = ["sensit.readFromFiles = 1", f"sensit.folderPath = {cache_dir}/"]
    cases = (("single", ["tpu.refineForward = 1"], None, "float32"),
             ("double", ["tpu.refineForward = 1", "tpu.refineForwardPrecision = double"], None, "float64"),
             ("double_mesh1", ["tpu.refineForward = 1", "tpu.refineForwardPrecision = double"], "1", "float64"))
    runs, pf = {}, {}
    for name, extra, mesh, dt in cases:
        out_dir = os.path.join(work, f"out_refine_{name}")
        pf[name] = write_parfile(work, f"Parfile_refine_{name}.txt", inputs, out_dir, N_MINOR, fmt="tiled",
                                 extra=extra + cached)
        said = {"pack_s": r"cache packed into tiles in ([0-9.]+)s", "format": r"grav kernel: tiled",
                "forward": r"grav refinement forward: BTTBKernel \(" + dt}
        run = runs[name] = run_main_path(cli, counters, f"tiled, refineForward ({dt} forward)", pf[name], out_dir, said,
                                         mesh=mesh, sensit_written=False)
        run["out_dir"] = out_dir
        # The stored kernel only under the solves; every forward product on the BTTB operator.
        solve_products = products - (3 + N_MAJOR)
        want = {"tile_matvec_sharded" if mesh else "tile_matvec": solve_products}
        print(f"  launches {run['launches']} (expected {want}: the solves' products; the {3 + N_MAJOR} forward "
              "products go through the BTTB operator)")
        if not launched(run["launches"], **want):
            raise SystemExit(f"FAILED refine {name}: launch count")
    held = hold_equal("refine double --mesh 1", runs["double_mesh1"], runs["double_mesh1"]["out_dir"], runs["double"],
                      runs["double"]["out_dir"])
    if not held["equal_to_the_last_bit"]:
        raise SystemExit("FAILED refine double --mesh 1: not equal to the last bit to the unmeshed run")
    cfg = read_parfile(pf["double"])
    grid = model_io.read_model_grid(inputs["grid"], NX, NY, NZ)
    data = data_io.read_data_points(inputs["data"], NDATA, 1, grid_only=True)
    t0 = time.time()
    S = sens.compute_sensitivity(dataclasses.replace(cfg.grav, compression_type=0), grid, data, np.ones(NX * NY * NZ),
                                 store_dtype=torch.float32, device="cuda").S
    torch.cuda.synchronize()
    build_s = time.time() - t0
    agree = {}
    for name in ("single", "double"):
        out_dir = runs[name]["out_dir"]
        m = torch.as_tensor(runs[name]["model"].reshape(-1) * cfg.grav.model_units_mult, dtype=torch.float64,
                            device="cuda")
        want = torch.cat([S[s : s + 256].double() @ m for s in range(0, S.shape[0], 256)])
        table = np.loadtxt(os.path.join(out_dir, "data", "grav_final.txt"), skiprows=1, ndmin=2)
        got = torch.as_tensor(table[:, 3] * cfg.grav.data_units_mult, dtype=torch.float64, device="cuda")
        agree[name] = float((got - want).abs().max() / want.abs().max())
        print(f"  {name}: the final predicted data against the dense uncompressed forward (float64-built, "
              f"float32-stored, built in {build_s:.2f} s) of the final model: max error {agree[name]:.3e} of max|d| "
              f"(tolerance {RTOL_F32_FORWARD:g})")
        if not agree[name] <= RTOL_F32_FORWARD:
            raise SystemExit(f"FAILED refine {name}: predicted data against the dense forward")
    del S
    torch.cuda.empty_cache()
    return {"runs": runs, "mesh1": held, "predicted_against_dense_forward": agree}


# The float32 and mixed builds' closed forms in float32, on the card and on
# the CPU: their logarithms and arctangents round differently, by an ulp,
# and the closed forms' cancellation carries that into the kernel, so the
# two solves part by more than float64 sums do (a card read 1.3e-5 of the
# range). The bound is that of the float32 builds of the two packages,
# tests/test_torch_build_variants.py (5e-5 of the range), times two.
F32_PHYSICS_MODEL_TOL = 1e-4


def phase_27(work):
    """Small float64 problems of each variant, card against CPU."""
    f32 = {"model_tol": F32_PHYSICS_MODEL_TOL}
    cases = [
        ("bf16_dense", "bfloat16 storage, dense", dict(fmt=None, extra=["tpu.kernelStoreDtype = bfloat16"])),
        ("float32_build_tiled", "--build-precision single, tiled",
         dict(fmt="tiled", solve_kw={"compute_dtype": torch.float32}, **f32)),
        ("mixed_build_tiled", "--fast-build 16, tiled", dict(fmt="tiled", solve_kw={"near_field_f64": 16}, **f32)),
        ("f32_compress_dense", "tpu.f64BuildF32Compress, dense", dict(fmt=None, extra=["tpu.f64BuildF32Compress = 1"])),
        ("refine_tiled", "tpu.refineForward, tiled", dict(fmt="tiled", extra=["tpu.refineForward = 1"])),
    ]
    return {name: small_problem_card_against_cpu(work, f"small_variant_{name}", what, **kw)
            for name, what, kw in cases}


# ---------------------------------------------------------------------------
# Phase 28: the fused major loop (--fused M), one CUDA graph a major whose
# LSQR loop is a WHILE node.
# ---------------------------------------------------------------------------

FUSED_M = N_MAJOR  # --fused 3: a run's three majors in one chunk, three launches


# The symbol torch.profiler names for each counter's kernel: A2 launches A1's
# kernel once a part; one launch of the bf16 rmatvec pair, of B2's matvec pair
# and of each of B3's pairs ends in its reduce; each near pass is one kernel;
# the WHILE node's graph runs set_condition once after its head and once after
# each run of its body. No symbol holds another.
KERNEL_SYMBOL = {"tile_matvec": "tile_matvec_kernel", "tile_matvec_sharded": "tile_matvec_kernel",
                 "bf16_matvec": "bf16_matvec_kernel", "bf16_rmatvec": "bf16_rmatvec_reduce",
                 "prism_matvec": "prism_matvec_reduce", "prism_rmatvec": "prism_rmatvec_kernel",
                 "lattice_matvec": "lattice_matvec_reduce", "lattice_rmatvec": "lattice_rmatvec_reduce",
                 "prism_near_matvec": "prism_near_matvec_kernel", "prism_near_rmatvec": "prism_near_rmatvec_kernel",
                 "lattice_near_matvec": "lattice_near_matvec_kernel",
                 "lattice_near_rmatvec": "lattice_near_rmatvec_kernel",
                 "prism_near_build": "prism_near_rows_kernel", "lattice_near_build": "lattice_near_rows_kernel",
                 "graph_while": "set_condition"}


class KeptFusedSolver:
    """A fused solver whose calls go through unchanged; `kept` holds the
    solver, the tensors of its last call and, per kernel, the launches its
    wrapper counted while the major was captured ("captured": head, LSQR
    body and tail) and while its LSQR body was ("captured_body")."""

    def __init__(self, solver, kept, counters):
        self.solver, self.kept = solver, kept
        capture, capture_body = solver._capture_graph, solver._capture_body

        def counted(key, fn, *args):
            before = {k: c.launches for k, c in counters.items()}
            out = fn(*args)
            kept[key] = {k: c.launches - before[k] for k, c in counters.items()}
            return out

        solver._capture_graph = lambda stream: counted("captured", capture, stream)
        solver._capture_body = lambda body, pool, loop: counted("captured_body", capture_body, body, pool, loop)

    def __call__(self, arrays):
        """The call, timed to the end of its work on the card: a chunk's
        seconds and its capture's at full precision (the log rounds them to
        10 ms)."""
        self.kept.update(solver=self.solver, arrays=arrays)
        capture_s = self.solver.timings.get("capture_s", 0.0)
        t0 = time.time()
        out = self.solver(arrays)
        torch.cuda.synchronize()
        self.kept.setdefault("calls", []).append((time.time() - t0, self.solver.timings.get("capture_s", 0.0) - capture_s))
        return out

    def __getattr__(self, name):
        return getattr(self.solver, name)


@contextlib.contextmanager
def keeping_the_fused_solver(workflow, counters):
    kept = {}
    orig = workflow.make_fused_solver
    workflow.make_fused_solver = lambda spec, n_steps: KeptFusedSolver(orig(spec, n_steps), kept, counters)
    try:
        yield kept
    finally:
        workflow.make_fused_solver = orig


def launches_a_major(kept, k, runs):
    """Kernel k's launches in one major of the captured graph whose LSQR
    body ran `runs` times: the head's and the tail's once, the body's once a
    run (each counted once at the capture)."""
    body = kept["captured_body"][k]
    return kept["captured"][k] - body + body * runs


def launches_on_the_card(name, run, kept, kernels):
    """What each kernel launched on the card in a --fused run, from that
    run's own counts: its wrapper's launches (counted once at the capture)
    less those counted inside the capture, plus, for each major the run's
    graph ran, its head's and tail's launches and its body's times the
    body's runs in that major (the WHILE node's counter, logged). One more
    major launched under torch.profiler must show what the capture counted
    for its body's runs (torch.profiler sees the kernels inside a WHILE
    body: while_node); fails unless it does."""
    solver, captured, body = kept["solver"], kept["captured"], kept["captured_body"]
    runs = run["lsqr_body_runs"]
    duplicates = cuda_kernel_events.duplicates
    for attempt in range(2):  # a profile can come back short of its kernels (time_operator)
        solver._s.zero_()  # an active major (the run left the step index past its last)
        events = cuda_kernel_events(solver._launch)
        runs_profiled = int(solver._runs)
        want = {k: launches_a_major(kept, k, runs_profiled) for k in kernels}
        got = {k: sum(1 for e in events if KERNEL_SYMBOL[k] in e) for k in kernels}
        if all(got[k] >= want[k] for k in kernels):
            break
    out = {k: {"counted": run["launches"][k], "captured": captured[k], "captured_body": body[k],
               "lsqr_body_runs": runs, "replays": solver.replays, "profiled_major": got[k],
               "profiled_major_expected": want[k], "profiled_major_body_runs": runs_profiled,
               "profiled_records_dropped": cuda_kernel_events.duplicates - duplicates,
               "on_the_card": run["launches"][k] - captured[k] + sum(launches_a_major(kept, k, r) for r in runs)}
           for k in kernels}
    print(f"  fused {name}: LSQR body runs {runs}; " + "; ".join(
        f"{k} counted {v['counted']} ({v['captured']} inside the capture, {v['captured_body']} of them in the "
        f"body), torch.profiler saw {v['profiled_major']} in one more major of {len(events)} kernels (expected "
        f"{v['profiled_major_expected']}, its body run {runs_profiled} times; {v['profiled_records_dropped']} "
        f"second records of a kernel run dropped), {v['replays']} majors: "
        f"{v['on_the_card']} launched on the card" for k, v in out.items()))
    if any(got[k] != want[k] or not captured[k] or not body[k] for k in kernels):
        for k in kernels:  # what the profile held of each kernel: streams, starts and durations
            seen = sorted((key[2], key[3], d) for key, d in cuda_kernel_events.last if KERNEL_SYMBOL[k] in key[0])
            print(f"  {k}: {len(seen)} runs on streams {sorted({v[0] for v in seen})}, the first (stream, start ns "
                  f"from the first, ns): {[(v[0], v[1] - seen[0][1], v[2]) for v in seen[:12]]}")
        raise SystemExit(f"FAILED fused {name}: a major does not launch what its capture counted")
    return out


def tree_equal(a, b):
    """Whether two nested dicts/tuples of tensors are equal to the last bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(tree_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


class ProfiledLaunches:
    """Stands in for a fused solver's launch for one call: each major's
    launch profiled in a window of its own (torch.profiler), the kernels of
    `symbol` and all kernels counted a major."""

    def __init__(self, launch, symbol):
        self.launch_graph, self.symbol, self.counts, self.kernels = launch, symbol, [], []

    def launch(self):
        events = cuda_kernel_events(self.launch_graph)
        self.counts.append(sum(1 for e in events if self.symbol in e))
        self.kernels.append(len(events))


def graph_replay_against_eager(solver, arrays, counter, kept):
    """The fused solver's graph launched over one chunk against the same
    steps launched eagerly on the card (their LSQR unrolled): every output
    equal to the last bit. The eager steps' launches of the counter's kernel
    a step, and in the graph's chunk (the call whose outputs are compared)
    its incoming forwards, counted by the wrapper (every launch outside a
    graph is one), and in each major by torch.profiler (each major's launch
    profiled in a window of its own: a window around the whole chunk came
    back ~10 kernels short of its ~5000 in some runs, PERF.md), held to the
    capture's counts for that major's body runs (launches_a_major)."""
    arr = {k: v for k, v in arrays.items() if k != "active_steps"}
    n_active = int(arrays["active_steps"])
    name = counter.__name__
    counter.launches = 0
    eager = solver._run_eager(arr, n_active, all_steps=False)
    torch.cuda.synchronize()
    # The eager chunk: each problem's incoming forward, then n_active steps.
    problems = len(arrays["S"])
    per_step = (counter.launches - problems) // n_active
    captures = solver.captures
    profiled = ProfiledLaunches(solver._launch, KERNEL_SYMBOL[name])
    counter.launches = 0
    solver._launch = profiled.launch
    try:
        got = solver(arrays)
    finally:
        del solver._launch
    torch.cuda.synchronize()
    if solver.captures != captures:
        raise SystemExit("FAILED fused graph: the solver captured again on the same tensors")
    runs = solver.body_runs[:n_active].tolist()
    a_major = [launches_a_major(kept, name, r) for r in runs]
    out = {"equal_to_the_last_bit": tree_equal(got, eager), "per_step_eagerly": per_step,
           "counted_in_the_graph_call": counter.launches, "lsqr_body_runs": runs, "launches_a_major": a_major,
           f"profiled_{name}_a_major": profiled.counts, "kernels_a_major": profiled.kernels, "replays": n_active}
    print(f"  the graph launched over a chunk of {n_active} majors against the same steps launched eagerly on the "
          f"card: every output equal to the last bit: {out['equal_to_the_last_bit']}; {name}: {per_step} launches a "
          f"step eagerly, {counter.launches} counted in the graph's call (the incoming forwards, expected "
          f"{problems}), LSQR body runs {runs}, so {a_major} a major; torch.profiler saw {profiled.counts} in its "
          f"majors of {profiled.kernels} kernels")
    if not out["equal_to_the_last_bit"]:
        raise SystemExit("FAILED fused graph: the graph's majors differ from the eager steps")
    if any(a != per_step for a in a_major) or counter.launches != problems or profiled.counts != a_major:
        raise SystemExit(f"FAILED fused graph: {name} launches inside the graph")
    return out


def while_node(k=5, max_iter=8, long=1000, plain_long=100):
    """The WHILE node of ops/graph_while.py on three small torch graphs of
    its own: the head zeroes a count and sets the flag go = count < limit,
    the body adds one to the count and sets the flag again, the tail writes
    2 count + 1. Launched with limit k (k body runs), 0 (the flag false at
    once: none) and a limit the count never reaches (max_iter runs: the
    cap), each against its plain version (the head's and tail's graphs
    replayed around while_on_the_host over the body's graph, which reads
    the flag on the host before each run); what torch.profiler sees of a
    launch of k runs (it must see the body's kernels, as the launch counts
    of phase 28 need); and
    a WHILE iteration's milliseconds (a launch of `long` runs less a launch
    of none, over `long`, CUDA events) against the plain loop's (host clock
    over `plain_long` runs), beside the bytes bound of one iteration."""
    from tomofastx_tpu_torch.ops import graph_while as gw
    from tomofastx_tpu_torch.ops.lsqr import LSQRLoop, while_on_the_host

    dev = torch.device("cuda")
    count, limit, out = (torch.zeros((), dtype=torch.int64, device=dev) for _ in range(3))
    go = torch.zeros((), dtype=torch.bool, device=dev)
    runs = torch.zeros((), dtype=torch.int32, device=dev)
    pool = torch.cuda.graph_pool_handle()
    head, body, tail = (torch.cuda.CUDAGraph(keep_graph=True) for _ in range(3))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        head.capture_begin(pool=pool)
        count.zero_()
        runs.zero_()
        go.copy_(count < limit)
        head.capture_end()
        body.capture_begin(pool=pool)
        count.add_(1)
        go.copy_(count < limit)
        body.capture_end()
        tail.capture_begin(pool=pool)
        torch.add(2 * count, 1, out=out)
        tail.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    # The profiler saw 2 of a launch's 6 set_condition runs where its first
    # window in the process opened after the graph was instantiated.
    cuda_kernel_events(torch.cuda.synchronize)

    def plain(cap):
        head.replay()
        n = while_on_the_host(LSQRLoop(go=go, carry={}, iterate=body.replay, max_iter=cap))
        tail.replay()
        return n

    graph = gw.WhileGraph(head, body, tail, go, runs, max_iter)
    cases = {}
    for name, lim in (("limit k", k), ("flag false at once", 0), ("flag never falls", 1 << 40)):
        limit.fill_(lim)
        gw.while_graph_launch(graph)
        torch.cuda.synchronize()
        on_card = [int(count), int(runs), int(out)]
        limit.fill_(lim)
        n = plain(max_iter)
        torch.cuda.synchronize()
        host = [int(count), n, int(out)]
        want = min(lim, max_iter)
        cases[name] = {"limit": lim, "graph": on_card, "plain": host, "expected": [want, want, 2 * want + 1]}
        if not on_card == host == cases[name]["expected"]:
            raise SystemExit(f"FAILED the WHILE node, {name}: count, runs, out {on_card} on the card, {host} by the "
                             f"plain loop, expected {cases[name]['expected']}")
    limit.fill_(k)
    conditions = 0
    for attempt in range(2):  # the first profile of a process came back short (2 of 6)
        events = cuda_kernel_events(lambda: gw.while_graph_launch(graph))
        conditions = max(conditions, sum(1 for e in events if KERNEL_SYMBOL["graph_while"] in e))
        if conditions == 1 + k:
            break
    if conditions != 1 + k:
        raise SystemExit(f"FAILED the WHILE node: torch.profiler saw {conditions} set_condition kernels in a launch "
                         f"of {k} runs, not {1 + k}")
    graph.close()
    longer = gw.WhileGraph(head, body, tail, go, runs, long)
    limit.fill_(0)
    zero_ms = time_cuda(lambda: gw.while_graph_launch(longer), warm=1, reps=5)
    limit.fill_(long)
    long_ms = time_cuda(lambda: gw.while_graph_launch(longer), warm=1, reps=5)
    longer.close()
    limit.fill_(plain_long)
    plain(plain_long)  # the graphs instantiated
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain(plain_long)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / plain_long
    # One iteration reads the count, the limit, the flag and the counter once
    # and writes the count, the flag and the counter.
    nbytes = 8 + 8 + 1 + 4 + 8 + 1 + 4
    res = {"cases": cases, "profiled_kernels_a_launch_of_k": len(events), "profiled_set_condition": conditions,
           "k": k, "max_iter": max_iter, "launch_of_none_ms": zero_ms,
           f"launch_of_{long}_ms": long_ms, "ms": (long_ms - zero_ms) / long, "plain_ms": plain_ms,
           "bound_ms": nbytes / MEMORY_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
           "max_abs_err": max(abs(a - b) for v in cases.values() for a, b in zip(v["graph"], v["plain"]))}
    print(f"  the WHILE node (csrc/graph_while.cu) on three small graphs: " + "; ".join(
        f"{n}: count, runs, out {v['graph']} on the card, {v['plain']} by the plain loop" for n, v in cases.items())
          + f"; torch.profiler saw {conditions} set_condition kernels of {len(events)} in a launch of {k} runs; a "
          f"WHILE iteration {res['ms'] * 1e3:.2f} us on the card ({long} "
          f"runs in {long_ms:.3f} ms, none in {zero_ms:.3f} ms) against {plain_ms * 1e3:.1f} us by the plain loop")
    return res


def graph_of_one_lsqr_iteration(name, op, reps=2):
    """The capture and the instantiation of one LSQR iteration's products
    (matvec + rmatvec) of an operator as a CUDA graph, timed apart, its
    kernel count, a replay's and the eager products' milliseconds (median of
    `reps`), and one replay against the eager products."""
    g = torch.Generator(device="cpu").manual_seed(29)
    x = torch.randn(op.ncols, generator=g, dtype=torch.float64).to("cuda", torch.float32)
    u = torch.randn(op.nrows * getattr(op, "ndc", 1), generator=g, dtype=torch.float64).to("cuda", torch.float32)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        want = (op.matvec(x), op.rmatvec(u))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        t0 = time.time()
        graph.capture_begin()
        got = (op.matvec(x), op.rmatvec(u))
        t1 = time.time()
        graph.capture_end()  # ends the capture and instantiates the graph
        torch.cuda.synchronize()
        t2 = time.time()
    out = {"capture_s": t1 - t0, "end_and_instantiate_s": t2 - t1,
           "replay_ms": time_cuda(graph.replay, warm=1, reps=reps),
           "eager_ms": time_cuda(lambda: (op.matvec(x), op.rmatvec(u)), warm=0, reps=reps),
           "kernels": len(cuda_kernel_events(graph.replay))}
    graph.replay()
    torch.cuda.synchronize()
    out["replay_equals_eager"] = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"  {name}: one LSQR iteration's products (matvec + rmatvec) as a CUDA graph of {out['kernels']} kernels: "
          f"captured in {out['capture_s']:.2f} s, ended and instantiated in {out['end_and_instantiate_s']:.2f} s; a "
          f"replay {out['replay_ms']:.1f} ms against {out['eager_ms']:.1f} ms launched eagerly; the replay equals "
          f"the eager products to the last bit: {out['replay_equals_eager']}")
    del graph
    return out


# An inversion.minResidual that the host-driven LSQR of the smoke's tiled
# problem reaches early in every major: at 2, 5 and 7 of its 20 iterations
# on an H100 (scripts/probe_torch_early_exit.py, PERF.md).
EARLY_EXIT_MIN_RESIDUAL = 0.2


@contextlib.contextmanager
def packing_once(workflow, cache_dir):
    """The runs inside read the tiled cache of `cache_dir` packed once: the
    first call of the workflow's tile_kernel_from_cache on it packs, each
    later one gets a copy of that pack on the card (the workflow scales its
    pack in place by the row weights). The same cache gives the same pack,
    so the runs' results do not change; their pack_s does. Other caches
    pack as they did. Yields how many runs took a copy."""
    from tomofastx_tpu_torch.ops.tile_kernel import TileKernel

    orig, kept = workflow.tile_kernel_from_cache, {"copies": 0}

    def packed(d, par, grid, device="cuda"):
        if os.path.realpath(d) != os.path.realpath(cache_dir):
            return orig(d, par, grid, device)
        if "pack" not in kept:
            kept["pack"] = orig(d, par, grid, device)
        (tk, meta), kept["copies"] = kept["pack"], kept["copies"] + 1
        return TileKernel(uvals=tk.uvals.clone(), ubidx=tk.ubidx.clone(), uvalsT=tk.uvalsT.clone(),
                          ubidxT=tk.ubidxT.clone(), nrows=tk.nrows, ncols=tk.ncols), dict(meta)

    workflow.tile_kernel_from_cache = packed
    try:
        yield kept
    finally:
        workflow.tile_kernel_from_cache = orig
        kept.pop("pack", None)


def early_exit_pair(work, inputs, cache_dir):
    """A fused run whose LSQR exits early, beside its host-driven run:
    the tiled problem from the tiled cache with inversion.minResidual =
    EARLY_EXIT_MIN_RESIDUAL, solved host-driven and with fused_chunk = 3
    through the library (seconds at full precision). Each run's LSQR
    iterations a major and seconds a major (fused: the chunk less its
    capture, over the majors); the fused model held to the host-driven one
    at the formats' tolerance. A fused major's LSQR is a WHILE node that
    stops where the host-driven loop stops: its body's runs a major (the
    node's counter) must equal the fused run's LSQR iterations and the
    host-driven run's."""
    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag

    extra = ["sensit.readFromFiles = 1", f"sensit.folderPath = {cache_dir}/",
             f"inversion.minResidual = {EARLY_EXIT_MIN_RESIDUAL}"]
    out = {"min_residual": EARLY_EXIT_MIN_RESIDUAL}
    for name, chunk in (("host-driven", 0), ("fused", FUSED_M)):
        d = os.path.join(work, f"out_early_exit_{chunk}")
        pf = write_parfile(work, f"Parfile_early_exit_{chunk}.txt", inputs, d, N_MINOR, fmt="tiled", extra=extra)
        torch.cuda.synchronize()
        res = solve_problem_joint_gravmag(read_parfile(pf), verbose=False, device="cuda", fused_chunk=chunk)
        torch.cuda.synchronize()
        t = res.timings
        run = {"lsqr_iterations": [int(v) for v in t["lsqr_iters"]], "solve_s": list(t["solve_s"])}
        if chunk:
            run["capture_s"] = t["capture_s"]
            run["major_s"] = (sum(t["solve_s"]) - run["capture_s"]) / N_MAJOR
            run["lsqr_body_runs"] = list(t["lsqr_body_runs"])
        else:
            run["major_s"] = sum(t["solve_s"]) / N_MAJOR
        cost = [row[1] for row in read_costs(os.path.join(d, "costs.txt"))]
        model = np.asarray(res.models[0].val)
        if not (all(b < a for a, b in zip(cost[:-1], cost[1:])) and np.isfinite(model).all()):
            raise SystemExit(f"FAILED early exit, {name}: the data cost does not fall or the model is not finite")
        run.update(data_costs={"grav": cost}, models={"grav": model})
        out[name] = run
    host, fused = out["host-driven"], out["fused"]
    print(f"  early exit (inversion.minResidual = {EARLY_EXIT_MIN_RESIDUAL}): host-driven LSQR iterations a major "
          f"{host['lsqr_iterations']}, {host['major_s']:.4f} s a major (majors {[round(v, 4) for v in host['solve_s']]}"
          f" s); fused {fused['lsqr_iterations']}, the WHILE node's body runs {fused['lsqr_body_runs']}, "
          f"{fused['major_s']:.4f} s a major (chunk {fused['solve_s'][0]:.3f} s less its capture "
          f"{fused['capture_s']:.3f} s)")
    if not sum(host["lsqr_iterations"]) < N_MAJOR * N_MINOR:
        raise SystemExit("FAILED early exit: the host-driven LSQR did not stop early")
    if not fused["lsqr_body_runs"] == fused["lsqr_iterations"] == host["lsqr_iterations"]:
        raise SystemExit("FAILED early exit: the WHILE node's body runs, the fused LSQR iterations and the "
                         "host-driven ones differ")
    out["against_host"] = formats_apart("early exit, fused against host-driven", fused, host)
    for run in (host, fused):
        del run["models"]
    return out


def phase_28(cli, counters, workflow, work, inputs, refs):
    """The fused major loop through the command line (--fused 3) at full
    width, each run held to the host-driven run of its Parfile (refs):
    tiled (kernel A1 replayed inside the graph), tiled --mesh 1 (A2, equal
    to the unmeshed fused run to the last bit), bfloat16 dense (B1), the
    coupled joint problem tiled, BTTB, refineForward with a float64
    forward, the per-cell operator (B2) and the lattice operator (B3); a
    5-major run written every 2
    (chunks 2, 2, 1 of one graph) resumed from its checkpoint to the last
    bit; through the library, the tiled, per-cell and lattice runs' graphs
    against the same steps launched eagerly, and a fused
    run whose LSQR exits early beside its host-driven run (early_exit_pair);
    four small float64 fused problems, card against CPU. The runs from the
    tiled cache share one packing of it (packing_once)."""
    with packing_once(workflow, os.path.join(refs["tiled"][1], "SENSIT")) as packs:
        out = fused_runs(cli, counters, workflow, work, inputs, refs)
    out["tiled_cache_copies"] = packs["copies"]
    print(f"  runs that took a copy of the tiled cache's one pack: {packs['copies']}")
    return out


def fused_runs(cli, counters, workflow, work, inputs, refs):
    """phase_28's runs."""
    print(f"the fused major loop (--fused {FUSED_M}): one CUDA graph a major, LSQR as a WHILE node:")
    graph_said = {"unit": rf"fused major loop: chunks of up to {FUSED_M} majors, one CUDA graph a major, LSQR as a "
                          r"WHILE node",
                  "capture": r"fused major captured as a CUDA graph in ([0-9.]+)s"}
    args = ("--fused", str(FUSED_M))
    tiled_cache = ["sensit.readFromFiles = 1", f"sensit.folderPath = {refs['tiled'][1]}/SENSIT/"]
    runs, spread = {}, {}

    t_phase = time.time()
    seconds = {}
    # The WHILE node alone first (torch.profiler must see its body's kernels).
    while_alone = while_node()
    seconds["the WHILE node alone"] = time.time() - t_phase

    def fused(name, pf, out_dir, said, ref, kind="grav", mesh=None, kernels=None, builds=None, **kw):
        """A --fused run through the command line, held to its host-driven
        run. kernels: {kernel: (its launches a step, its eager forwards)};
        builds: {kernel: its launches, all outside the graph} (the stored
        near rows' build, once with the operator);
        the step's launches are counted once inside the capture (its LSQR
        body's once) and, outside the graph, once in the warm-up step (its
        LSQR one iteration: head, one body run, tail), beside the forwards
        (of the synthetic, prior, starting and incoming models); each
        kernel's launches on the card are read from
        the run; the WHILE node's graph is launched once a major, and its
        body runs once an LSQR iteration. No other kernel may launch."""
        kernels = kernels or {}
        t0 = time.time()
        with keeping_the_fused_solver(workflow, counters) as kept:
            run = run_main_path(cli, counters, f"fused {name}", pf, out_dir, {**graph_said, **said}, kind=kind,
                                mesh=mesh, args=args, **kw)
        if len(run["captures_s"]) != 1 or [n for n, _ in run["chunks"]] != [N_MAJOR]:
            raise SystemExit(f"FAILED fused {name}: chunks {run['chunks']}, captures {run['captures_s']}")
        if kept["solver"].replays != N_MAJOR or run["lsqr_body_runs"] != run["lsqr_iterations"]:
            raise SystemExit(f"FAILED fused {name}: {kept['solver'].replays} launches (not {N_MAJOR}), LSQR body runs "
                             f"{run['lsqr_body_runs']} against the iterations {run['lsqr_iterations']}")
        # The chunk's seconds less its capture (the warm-up step included), at
        # full precision.
        call_s, capture_s = kept["calls"][0]
        run["major_s_fused"] = (call_s - capture_s) / N_MAJOR
        run["chunk_s"], run["capture_s"] = call_s, capture_s
        run["per_lsqr_iteration_ms"] = run["major_s_fused"] / N_MINOR * 1e3
        print(f"  fused {name}: {run['major_s_fused']:.4f} s a major (the chunk {call_s:.4f} s less its capture "
              f"{capture_s:.4f} s, over {N_MAJOR})")
        if ref is not None:
            spread[name] = formats_apart(f"fused {name} against the host-driven run", run, ref)
        if kernels:
            run["launches_fused"] = launches_on_the_card(name, run, kept, kernels)
            for k, v in run["launches_fused"].items():
                per_step, forwards = kernels[k]
                eager = forwards + launches_a_major(kept, k, 1)  # the warm-up step ran one LSQR iteration
                on_card = eager + N_MAJOR * per_step  # the warm-up step's launches run on the card too
                if launches_a_major(kept, k, N_MINOR) != per_step or v["counted"] - v["captured"] != eager or (
                        v["on_the_card"] != on_card):
                    raise SystemExit(f"FAILED fused {name}: {k} counted {v['counted']}, {v['captured']} inside the "
                                     f"capture ({v['captured_body']} in the body), {v['on_the_card']} on the card "
                                     f"(expected {eager} outside it, {per_step} a major, {on_card} on the card)")
        if not launched(run["launches"], **{k: run["launches"][k] for k in kernels}, **(builds or {}),
                        graph_while=N_MAJOR):
            raise SystemExit(f"FAILED fused {name}: a kernel off its path was launched: {run['launches']}")
        runs[name] = run
        seconds[name] = time.time() - t0
        return kept

    # Tiled from the tiled main path's cache: A1 under every product, replayed.
    out = {k: os.path.join(work, f"out_fused_{k}") for k in ("tiled", "tiled_mesh1", "bf16", "bttb", "refine64",
                                                             "five", "resumed", "coupled", "per_cell", "lattice")}
    pf = write_parfile(work, "Parfile_fused_tiled.txt", inputs, out["tiled"], N_MINOR, fmt="tiled", extra=tiled_cache)
    kept = fused("tiled", pf, out["tiled"], {"format": r"grav kernel: tiled"}, refs["tiled"][0],
                 sensit_written=False, kernels={"tile_matvec": (2 * N_MINOR + 2, 4)})
    t0 = time.time()
    library = graph_replay_against_eager(kept["solver"], kept["arrays"], counters["tile_matvec"], kept)
    seconds["graph against eager"] = time.time() - t0
    del kept
    torch.cuda.empty_cache()

    # Fault 11: a fused run whose LSQR exits early, beside its host-driven run.
    t0 = time.time()
    early = early_exit_pair(work, inputs, os.path.join(refs["tiled"][1], "SENSIT"))
    seconds["early exit pair"] = time.time() - t0

    # --mesh 1: A2 (one launch a card) replayed; equal to the unmeshed fused run.
    pf = write_parfile(work, "Parfile_fused_tiled_mesh1.txt", inputs, out["tiled_mesh1"], N_MINOR, fmt="tiled",
                       extra=tiled_cache)
    fused("tiled --mesh 1", pf, out["tiled_mesh1"], {"format": r"grav kernel: tiled"}, None, mesh="1",
          sensit_written=False, kernels={"tile_matvec_sharded": (2 * N_MINOR + 2, 4)})
    mesh1 = hold_equal("fused tiled --mesh 1", runs["tiled --mesh 1"], out["tiled_mesh1"], runs["tiled"], out["tiled"],
                       against="the unmeshed fused run")
    if not mesh1["equal_to_the_last_bit"]:
        raise SystemExit("FAILED fused tiled --mesh 1: not equal to the last bit to the unmeshed fused run")

    # bfloat16 dense, built straight into bfloat16 (0.5 s): B1 replayed.
    pf = write_parfile(work, "Parfile_fused_bf16.txt", inputs, out["bf16"], N_MINOR, fmt=None,
                       extra=["tpu.kernelStoreDtype = bfloat16"])
    fused("bfloat16 dense", pf, out["bf16"], {"format": DENSE_BF16_SAID}, refs["bf16"][0], sensit_written=False,
          kernels={"bf16_matvec": (N_MINOR + 1, 4), "bf16_rmatvec": (N_MINOR + 1, 0)})

    # The coupled joint problem, tiled from the joint cache: 2 problems' A1.
    joint_dir, joint_inputs, coupled_extra = refs["coupled"][2:]
    pf = write_parfile(joint_dir, "Parfile_fused_coupled.txt", joint_inputs, out["coupled"], N_MINOR, fmt="tiled",
                       kind="joint", extra=coupled_extra)
    fused("coupled joint tiled", pf, out["coupled"], {"wavelet_domain": r"WAVELET_DOMAIN = False"},
          refs["coupled"][0], kind="joint", sensit_written=False, kernels={"tile_matvec": (4 * N_MINOR + 4, 8)})
    check_coupled_outputs("fused coupled joint tiled", out["coupled"], list(range(10, 21)))

    # BTTB (torch.fft inside the graph) and refineForward with a float64 BTTB forward.
    pf = write_parfile(work, "Parfile_fused_bttb.txt", inputs, out["bttb"], N_MINOR, fmt="matrixfree", compression=0)
    fused("BTTB", pf, out["bttb"], matrixfree_said("BTTBKernel"), refs["bttb"][0], sensit_written=False,
          compression="uncompressed")
    pf = write_parfile(work, "Parfile_fused_refine64.txt", inputs, out["refine64"], N_MINOR, fmt="tiled",
                       extra=["tpu.refineForward = 1", "tpu.refineForwardPrecision = double"] + tiled_cache)
    fused("tiled, refineForward float64", pf, out["refine64"], {
        "forward": r"grav refinement forward: BTTBKernel \(float64"}, refs["refine64"][0], sensit_written=False,
          kernels={"tile_matvec": (2 * N_MINOR + 1, 0)})

    # The per-cell operator (kernel B2 replayed inside the graph) on phase 21's
    # topography survey, held to its host-driven run; then the graph against the
    # same steps launched eagerly. Outside the graph the matvec runs the
    # construction's probe and the 4 forwards.
    t0 = time.time()
    pf = write_parfile(work, "Parfile_fused_per_cell.txt", dict(inputs, grid=inputs["grid_topo"]), out["per_cell"],
                       N_MINOR, fmt="matrixfree", compression=0)
    kept = fused("per-cell", pf, out["per_cell"], matrixfree_said("MatrixFreeKernel"), refs["per_cell"][0],
                 sensit_written=False, compression="uncompressed",
                 kernels={"prism_matvec": (N_MINOR + 1, 5), "prism_rmatvec": (N_MINOR + 1, 0),
                          "prism_near_matvec": (N_MINOR + 1, 5), "prism_near_rmatvec": (N_MINOR + 1, 0)},
                 builds={"prism_near_build": 1})
    per_cell_graph = graph_replay_against_eager(kept["solver"], kept["arrays"], counters["prism_matvec"], kept)
    del kept
    torch.cuda.empty_cache()
    seconds["per-cell"] = time.time() - t0

    # The lattice operator (kernel B3 replayed inside the graph) on phase 20's
    # draped survey, held to its host-driven run; then the graph against the
    # same steps launched eagerly.
    t0 = time.time()
    pf = write_parfile(work, "Parfile_fused_lattice.txt", dict(inputs, data=inputs["data_draped"]), out["lattice"],
                       N_MINOR, fmt="matrixfree", compression=0)
    kept = fused("lattice", pf, out["lattice"], matrixfree_said("LatticeMatrixFreeKernel"), refs["lattice"][0],
                 sensit_written=False, compression="uncompressed", what=f"{NDATA} draped observations",
                 kernels={"lattice_matvec": (N_MINOR + 1, 5), "lattice_rmatvec": (N_MINOR + 1, 0),
                          "lattice_near_matvec": (N_MINOR + 1, 5), "lattice_near_rmatvec": (N_MINOR + 1, 0)},
                 builds={"lattice_near_build": 1})
    lattice_graph = graph_replay_against_eager(kept["solver"], kept["arrays"], counters["lattice_matvec"], kept)
    del kept
    torch.cuda.empty_cache()
    seconds["lattice"] = time.time() - t0

    # 5 majors written every 2 with --fused 3: chunks 2, 2, 1 of one graph;
    # then the run resumed from its checkpoint of major 4.
    t0 = time.time()
    five = write_parfile(work, "Parfile_fused_five.txt", inputs, out["five"], N_MINOR, fmt="tiled", n_major=5,
                         extra=tiled_cache + ["inversion.writeModelEveryNiter = 2"])
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = cli.main(["-p", five, "--device", "cuda", *args])
    log = tee.kept.getvalue()
    chunks = [int(v) for v in re.findall(r"fused (\d+) iterations in", log)]
    captures = len(re.findall(r"fused major captured as a CUDA graph", log))
    ck = load_npz(os.path.join(out["five"], "checkpoint.npz"))
    print(f"  fused, 5 majors written every 2: chunks {chunks}, {captures} capture(s), checkpoint of major "
          f"{int(ck['it'])}")
    if rc != 0 or chunks != [2, 2, 1] or captures != 1 or int(ck["it"]) != 4:
        raise SystemExit("FAILED fused 5 majors: chunks, captures or checkpoint")
    os.makedirs(out["resumed"])
    shutil.copy(os.path.join(out["five"], "checkpoint.npz"), out["resumed"])
    resumed = write_parfile(work, "Parfile_fused_resumed.txt", inputs, out["resumed"], N_MINOR, fmt="tiled",
                            n_major=5, extra=tiled_cache + ["inversion.writeModelEveryNiter = 2"])
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["-p", resumed, "--device", "cuda", "--resume", *args])
    rows = {k: open(os.path.join(out[k], "costs.txt")).read().splitlines() for k in ("five", "resumed")}
    equal = rc == 0 and same_bytes(*(os.path.join(out[k], "model/grav_final_model_full.txt")
                                     for k in ("five", "resumed"))) and rows["resumed"] == rows["five"][-2:]
    print(f"  resumed from the checkpoint of major 4 to 5: final model and the last two costs.txt rows equal to the "
          f"uninterrupted run's to the last bit: {equal}")
    if not equal:
        raise SystemExit("FAILED fused resume: not equal to the uninterrupted fused run")
    seconds["5 majors and the resume"] = time.time() - t0

    # Small float64 fused problems, card against CPU.
    t0 = time.time()
    small = {
        "tiled": small_problem_card_against_cpu(work, "small_fused_tiled", "tiled, --fused 3", fmt="tiled",
                                                solve_kw={"fused_chunk": FUSED_M}),
        "coupled_dense": small_problem_card_against_cpu(
            work, "small_fused_coupled", "joint grav+mag, all three couplings, dense, --fused 3", kind="joint",
            fmt=None, coupling=small_coupling("all_three"), solve_kw={"fused_chunk": FUSED_M}),
        "bttb": small_problem_card_against_cpu(work, "small_fused_bttb", "matrix-free BTTB g_z, --fused 3",
                                               fmt="matrixfree", compression=0, operator="BTTBKernel",
                                               solve_kw={"fused_chunk": FUSED_M}),
        "lattice": small_problem_card_against_cpu(
            work, "small_fused_lattice", "matrix-free lattice g_z, draped, --fused 3", fmt="matrixfree",
            compression=0, operator="LatticeMatrixFreeKernel", swap={"data": "data_draped"},
            solve_kw={"fused_chunk": FUSED_M},
            counted={k: counters[k] for k in ("lattice_matvec", "lattice_rmatvec")}),
    }
    seconds["small problems"] = time.time() - t0
    seconds["phase"] = time.time() - t_phase
    print("  phase 28's seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return {"while_node": while_alone, "runs": runs, "against_host": spread, "mesh1": mesh1,
            "graph_against_eager": library,
            "per_cell_graph_against_eager": per_cell_graph, "lattice_graph_against_eager": lattice_graph,
            "early_exit": early,
            "five_majors": {"chunks": chunks, "captures": captures, "resumed_equal": equal}, "small": small,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# Phase 29: a capacity rung at its full width.
# ---------------------------------------------------------------------------

# The 4m rung of scripts/run_capacity_torch.py (200 x 200 x 100 cells, 2025
# observations 0.1 m above the top, the lattice operator's float32 blend),
# cut to this depth: the full run is 3 x 20.
CAPACITY_RUNG, CAPACITY_DEPTH = "4m", (1, 10)


def capacity_script():
    """scripts/run_capacity_torch.py, loaded as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("run_capacity_torch",
                                                  os.path.join(HERE, "scripts", "run_capacity_torch.py"))
    module = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_29(counters, workflow, work):
    """The CAPACITY_RUNG rung's fixtures and Parfile written by
    scripts/run_capacity_torch.py and solved through it CAPACITY_DEPTH deep,
    with every kernel's count set to 0 just before and read just after:
    kernel B3 and its near pass once a product; the data cost falls; then one
    B3 pair on that run's operator against its plain loop at f32 1e-5 of
    max|y|, two launches equal to the last bit."""
    from tomofastx_tpu_torch.ops.matrixfree import LatticeMatrixFreeKernel

    cap = capacity_script()
    t0 = time.time()
    fx = cap.write_fixture(CAPACITY_RUNG, os.path.join(work, "capacity"), depth=CAPACITY_DEPTH)
    print(f"capacity rung {CAPACITY_RUNG} ({fx.ncells:,} cells x {fx.ndata:,} observations, {fx.depth[0]} major x "
          f"{fx.depth[1]} minors; fixtures written in {fx.fixtures_s:.1f} s):")
    for fn in counters.values():
        fn.launches = 0
    with capturing_the_system(workflow) as kept:
        res, log, wall, peak = cap.solve(fx, device="cuda", verbose=False)
    launches = {k: fn.launches for k, fn in counters.items()}
    rec = cap.record(fx, res, log, wall, peak, "cuda")
    op = kept["arrays"]["S"][0]
    del kept["arrays"]
    if not (isinstance(op, LatticeMatrixFreeKernel) and op.far_quad
            and re.search(r"products by kernel B3, csrc/lattice_matvec\.cu\)", log)):
        raise SystemExit(f"FAILED capacity {CAPACITY_RUNG}: not the lattice operator's blend through kernel B3 "
                         f"({type(op).__name__}; {rec['operator']})")
    want = b2_launches(res.timings["lsqr_iters"], "lattice")
    print(f"  kernel B3's launches {launches['lattice_matvec']} matvec, {launches['lattice_rmatvec']} rmatvec, near "
          f"passes {launches['lattice_near_matvec']} and {launches['lattice_near_rmatvec']} (expected "
          f"{want['lattice_matvec']} and {want['lattice_rmatvec']}, one each a product)")
    if not launched(launches, **want) or res.timings["lsqr_iters"] != [CAPACITY_DEPTH[1]] * CAPACITY_DEPTH[0]:
        raise SystemExit(f"FAILED capacity {CAPACITY_RUNG}: launches {launches}, LSQR {res.timings['lsqr_iters']}")
    initial = float(re.search(r"data cost \(initial\) \[grav\] = (\S+)", log).group(1))
    final = rec["cost_history_grav"][-1]
    print(f"  data cost {initial:.6e} -> {final:.6e}; wall_s {wall:.1f} (forward phase {rec['forward_phase_s']:.1f} s), "
          f"peak device memory {peak / 1e9:.2f} GB, host peak RSS {rec['host_peak_rss_bytes'] / 1e9:.2f} GB; the "
          f"operator holds {op.nbytes / 1e6:.1f} MB, a product's float64 partial sums {op.partial_nbytes / 1e6:.1f} MB")
    if not (np.isfinite(res.models[0].val).all() and final < initial):
        raise SystemExit(f"FAILED capacity {CAPACITY_RUNG}: the data cost does not fall, or the model is not finite")
    b3 = measure_b3(f"g_z float32 (the blend), {op.xd.shape[0]} x {op.N} (capacity {CAPACITY_RUNG})", op, RTOL_F32,
                    reps=3)
    del op
    torch.cuda.empty_cache()
    rec.update(launches=launches, data_cost_initial=initial, b3=b3, phase_s=time.time() - t0)
    return rec


# ---------------------------------------------------------------------------
# Phase 30: the last two JAX capacity scripts' rungs at their full width.
# ---------------------------------------------------------------------------

# generic4m (scripts/probe_generic_4m.py: 200 x 200 x 100 cells whose x edges
# grow 2 % a cell and shear 3 m a layer, 2025 observations at jittered
# heights, the per-cell operator's float32 blend through kernel B2) at its
# own depth, 2 x 10; and 1m (scripts/run_million_cell.py, the mixed build: a
# dense float32 kernel of 2025 x 1,048,576) cut to 2 majors x 10 LSQR in one
# fused chunk, with no sensitivity cache written: the full run is 30 x 100
# and writes a 17 GB cache, which is the capacity script's to measure.
GENERIC_RUNG = "generic4m"
DENSE_RUNG, DENSE_DEPTH = "1m", (2, 10)
DENSE_CUT_LINES = ("tpu.sensitWriteCache = 0\n",)
# Kernel B2 at capacity is held against its plain loop on this many
# observation rows spread over the survey (the matvec on them, the rmatvec
# from them): over all 2032 x 4M pairs the plain loop would take ~20 s.
CAPACITY_B2_ROWS = 128
# B2's near passes on those rows against their plain versions. Each pass
# rounds a near pair's float64 closed form to float32 before its float64 sum,
# and the kernel's and the plain version's float64 closed forms may differ in
# their last bits, so a pair can round to the neighbouring float32. On the
# smoke's topography a row has ~100 near pairs and none did (RTOL_F64 holds);
# on generic4m's growing cells a row has ~21,000 (43M near pairs), and an
# H100 read 1.1e-9 of max|y|: a few such roundings, as RTOL_SPLIT allows.
RTOL_NEAR_CAPACITY = RTOL_SPLIT


def b2_row_subset(op, rows):
    """The per-cell operator `op` cut to the observation rows `rows` (their
    count a multiple of its chunk): their geometry, row weights, near
    candidates, the candidates' transpose and the stored near rows built
    from them."""
    import dataclasses

    from tomofastx_tpu_torch.ops.matrixfree import near_idx_transpose

    idx = torch.as_tensor(rows, dtype=torch.int64, device=op.xd.device)
    near_idx = op.near_idx[idx]
    near_tptr, near_obs = near_idx_transpose(near_idx, op.cell_lo, op.N)
    return dataclasses.replace(op, xd=op.xd[idx], yd=op.yd[idx], zd=op.zd[idx], row_w=op.row_w[idx],
                               nrows=len(rows), near_idx=near_idx, near_tptr=near_tptr,
                               near_obs=near_obs).with_near_rows()


def measure_b2_capacity(name, op, reps=3):
    """Kernel B2 on a capacity operator: its pair on CAPACITY_B2_ROWS rows
    against the plain loop at f32 1e-5 of max|y|, two launches equal, and
    its near passes there against their plain versions (to
    RTOL_NEAR_CAPACITY); then the pair and the near passes timed on the
    whole operator (median of `reps`) beside the bounds of this run's
    pairs."""
    from tomofastx_tpu_torch.ops import prism_matvec as pm

    rows = np.linspace(0, op.nrows - 1, CAPACITY_B2_ROWS).round().astype(np.int64)
    sub = b2_row_subset(op, rows)
    g = torch.Generator(device="cpu").manual_seed(37)
    xw = op.cw[None, :] * torch.randn((1, op.N), generator=g, dtype=torch.float64).to("cuda", torch.float32)
    u_sub = sub.row_w * torch.randn((len(rows), 1), generator=g, dtype=torch.float64).to("cuda", torch.float32)
    u = op.row_w * torch.randn((op.xd.shape[0], 1), generator=g, dtype=torch.float64).to("cuda", torch.float32)
    out = {"shape": [op.xd.shape[0], op.N, 1, 1], "rows_against_the_plain_loop": len(rows)}
    near, far = b2_pairs(op)
    for f, kernel, plain, v_sub, v, nout in (
            ("matvec", pm.prism_matvec, sub._partial_matvec, xw, xw, op.xd.shape[0]),
            ("rmatvec", pm.prism_rmatvec, sub._partial_rmatvec, u_sub, u, op.N)):
        got = kernel(sub, v_sub)
        want, plain_ms = timed_once(lambda: plain(v_sub))
        err = compare(f"B2 {name}, {f} on {len(rows)} rows against its plain loop", got, want, RTOL_F32)
        del want
        if not torch.equal(kernel(sub, v_sub), got):
            raise SystemExit(f"FAILED B2 {name}: two {f} launches differ")
        ms = time_cuda(lambda: kernel(op, v), warm=1, reps=reps)
        bound_ms, bound_by, which, times, _, _ = b2_bound(op, nout, v.numel(), (near, far))
        out[f] = {"ms": ms, "plain_ms_on_the_rows": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                  "bound_unit": which, "bound_times_ms": times, "near_pairs": near, "far_pairs": far,
                  "max_abs_err": err, "library_ms": None}
        print(f"  B2 {name} {f}: kernel {ms:.3f} ms (median of {reps}, the whole operator), plain loop "
              f"{plain_ms:.1f} ms on {len(rows)} rows, bound {bound_ms:.3f} ms by {which} ("
              + ", ".join(f"{k} {t:.3f}" for k, t in times.items()) + f" ms; {near:,} near pairs, {far:,} far)")
    out["near"] = near_pass("B2", f"{name} on {len(rows)} rows", sub,
                            {"matvec": pm.prism_near_matvec, "rmatvec": pm.prism_near_rmatvec},
                            {"matvec": xw, "rmatvec": u_sub}, RTOL_NEAR_CAPACITY, reps=reps)
    del sub
    # The passes and the build timed again on the whole operator; their plain
    # versions stay those on the rows (over the whole operator the plain
    # build alone takes ~3 s).
    built = out["near"]["rows"]
    built.update(stored_nbytes=op.near_rows_nbytes, pairs=op.near_rval.shape[0], lanes=list(op.near_lanes),
                 build_ms=time_cuda(op.with_near_rows, warm=1, reps=reps), plain_on=f"{len(rows)} rows")
    print(f"  B2 {name} near rows: {near:,} pairs, {op.near_rows_nbytes / 1e6:.1f} MB stored, built in "
          f"{built['build_ms']:.1f} ms, lanes {op.near_lanes}")
    for f, kernel, v in (("matvec", pm.prism_near_matvec, xw), ("rmatvec", pm.prism_near_rmatvec, u)):
        out["near"][f].update(ms=time_cuda(lambda: kernel(op, v), warm=1, reps=reps),
                              ms_on_card=time_graph(lambda: kernel(op, v), calls=10, reps=reps),
                              candidates=op.near_idx.numel(), plain_on=f"{len(rows)} rows")
    near_bounds(out["near"], "B2", f"{name} ({op.near_idx.numel():,} candidates; the whole operator)", op, near,
                B2_CLOSED_FLOPS[b2_family_key(op.phys)])
    return out


def phase_30(counters, workflow, work):
    """The GENERIC_RUNG rung written by scripts/run_capacity_torch.py and
    solved through it at its own depth, every kernel's count set to 0 just
    before and read just after: the per-cell operator's blend through kernel
    B2, B2 and its near pass once a product, the data cost falls; then one B2
    pair of that run's operator against its plain loop on
    CAPACITY_B2_ROWS rows, timed on the whole operator. Then the DENSE_RUNG
    rung at DENSE_DEPTH with DENSE_CUT_LINES: the dense float32 kernel in a
    captured and replayed fused loop, no hand kernel launched, the data cost
    falls; and the script's matrix-free section with kernel B3's launches
    counted."""
    from tomofastx_tpu_torch.ops.matrixfree import MatrixFreeKernel

    cap = capacity_script()
    out = {}
    t0 = time.time()
    fx = cap.write_fixture(GENERIC_RUNG, os.path.join(work, "capacity_generic"))
    print(f"capacity rung {GENERIC_RUNG} ({fx.ncells:,} cells x {fx.ndata:,} observations, {fx.depth[0]} majors x "
          f"{fx.depth[1]} minors, its own depth; fixtures written in {fx.fixtures_s:.1f} s):")
    for fn in counters.values():
        fn.launches = 0
    with capturing_the_system(workflow) as kept:
        res, log, wall, peak = cap.solve(fx, device="cuda", verbose=False)
    launches = {k: fn.launches for k, fn in counters.items()}
    rec = cap.record(fx, res, log, wall, peak, "cuda")
    op = kept["arrays"]["S"][0]
    del kept["arrays"]
    if not (isinstance(op, MatrixFreeKernel) and op.phys.far_quad and rec["far_field_blend"]
            and re.search(r"products by kernel B2, csrc/prism_matvec_f32\.cu\)", log)):
        raise SystemExit(f"FAILED capacity {GENERIC_RUNG}: not the per-cell operator's blend through kernel B2 "
                         f"({type(op).__name__}; {rec['operator']})")
    want = b2_launches(res.timings["lsqr_iters"])
    print(f"  {rec['operator'][0]}")
    print(f"  kernel B2's launches {launches['prism_matvec']} matvec, {launches['prism_rmatvec']} rmatvec, near "
          f"passes {launches['prism_near_matvec']} and {launches['prism_near_rmatvec']} (expected "
          f"{want['prism_matvec']} and {want['prism_rmatvec']}, one each a product)")
    if not launched(launches, **want) or res.timings["lsqr_iters"] != [fx.depth[1]] * fx.depth[0]:
        raise SystemExit(f"FAILED capacity {GENERIC_RUNG}: launches {launches}, LSQR {res.timings['lsqr_iters']}")
    initial = float(re.search(r"data cost \(initial\) \[grav\] = (\S+)", log).group(1))
    costs = rec["cost_history_grav"]
    print(f"  data cost {initial:.6e} -> {', '.join(f'{c:.6e}' for c in costs)}; wall_s {wall:.1f} (forward phase "
          f"{rec['forward_phase_s']:.1f} s), peak device memory {peak / 1e9:.2f} GB, host peak RSS "
          f"{rec['host_peak_rss_bytes'] / 1e9:.2f} GB; near lists K = {op.near_idx.shape[1]}, the operator holds "
          f"{op.nbytes / 1e6:.1f} MB, a product's float64 partial sums {op.partial_nbytes / 1e6:.1f} MB")
    if not (np.isfinite(res.models[0].val).all() and costs[-1] < costs[0] < initial):
        raise SystemExit(f"FAILED capacity {GENERIC_RUNG}: the data cost does not fall, or the model is not finite")
    del res
    b2 = measure_b2_capacity(f"g_z float32 (the blend), {op.xd.shape[0]} x {op.N} (capacity {GENERIC_RUNG})", op)
    del op
    torch.cuda.empty_cache()
    rec.update(launches=launches, data_cost_initial=initial, b2=b2, phase_s=time.time() - t0)
    print(f"  {GENERIC_RUNG} took {rec['phase_s']:.1f} s of phase 30")
    out[GENERIC_RUNG] = rec

    t0 = time.time()
    fx = cap.write_fixture(DENSE_RUNG, os.path.join(work, "capacity_dense"), depth=DENSE_DEPTH)
    fx.lines += list(DENSE_CUT_LINES)
    print(f"capacity rung {DENSE_RUNG} ({fx.ncells:,} cells x {fx.ndata:,} observations, the build "
          f"{cap.MC_BUILDS[cap.RUNGS[DENSE_RUNG].build][0]}; cut to {fx.depth[0]} majors x {fx.depth[1]} minors "
          f"(30 x 100 in full) and {', '.join(ln.strip() for ln in DENSE_CUT_LINES)}; fixtures written in "
          f"{fx.fixtures_s:.1f} s):")
    for fn in counters.values():
        fn.launches = 0
    with keeping_the_fused_solver(workflow, counters) as kept:
        res, log, wall, peak = cap.solve(fx, device="cuda", verbose=False)
    launches = {k: fn.launches for k, fn in counters.items()}
    rec = cap.record(fx, res, log, wall, peak, "cuda")
    solver = kept["solver"]
    said = rf"grav kernel: dense \({fx.ndata}, {fx.ncells}\) torch\.float32"
    captured = re.search(r"fused major captured as a CUDA graph in ([0-9.]+)s", log)
    print(f"  {rec['operator'][0]}; {rec['loop'][0]}")
    products = {k: v for k, v in launches.items() if k != "graph_while"}
    print(f"  captures {solver.captures}, launches of the major's graph {launches['graph_while']} (LSQR body runs "
          f"{rec['timings']['lsqr_body_runs']}), product kernels launched {sum(products.values())} (inside the "
          f"capture {sum(kept['captured'].values())})")
    if not (re.search(said, log) and captured and solver.captures == 1 and solver.replays == fx.depth[0]
            == launches["graph_while"] and rec["timings"]["lsqr_body_runs"] == res.timings["lsqr_iters"]):
        raise SystemExit(f"FAILED capacity {DENSE_RUNG}: not the dense float32 kernel in a captured fused loop "
                         f"launched once a major, LSQR as a WHILE node ({rec['operator']}; {rec['loop']})")
    if any(products.values()) or any(kept["captured"].values()):
        raise SystemExit(f"FAILED capacity {DENSE_RUNG}: a hand kernel was launched in the dense solve: {launches}")
    initial = float(re.search(r"data cost \(initial\) \[grav\] = (\S+)", log).group(1))
    costs = rec["cost_history_grav"]
    print(f"  data cost {initial:.6e} -> {', '.join(f'{c:.6e}' for c in costs)}; wall_s {wall:.1f} (forward phase "
          f"{rec['forward_phase_s']:.1f} s, build {rec['timings'].get('build_s', 0.0):.1f} s, capture "
          f"{float(captured.group(1)):.2f} s), peak device memory {peak / 1e9:.2f} GB, host peak RSS "
          f"{rec['host_peak_rss_bytes'] / 1e9:.2f} GB")
    if not (np.isfinite(res.models[0].val).all() and costs[-1] < costs[0] < initial):
        raise SystemExit(f"FAILED capacity {DENSE_RUNG}: the data cost does not fall, or the model is not finite")
    del res, kept
    torch.cuda.empty_cache()
    for fn in counters.values():
        fn.launches = 0
    mf = cap.matrixfree_per_iteration(fx, "cuda")
    mf_launches = {k: fn.launches for k, fn in counters.items()}
    iters = mf["matrixfree_lsqr_iters"]
    want = {f"lattice_{near}{f}": 2 * (iters + (f == "rmatvec")) + 2 for near in ("", "near_")
            for f in ("matvec", "rmatvec")}
    want["lattice_near_build"] = 1  # the operator's stored near rows, built once
    print(f"  matrix-free section: {mf['matrixfree_operator']} ({mf['matrixfree_products_by']}), "
          f"{mf['matrixfree_s_per_iter'] * 1e3:.2f} ms an LSQR iteration of {iters} (a matvec "
          f"{mf['matrixfree_matvec_s'] * 1e3:.2f} ms, an rmatvec {mf['matrixfree_rmatvec_s'] * 1e3:.2f} ms); kernel "
          "B3's launches " + ", ".join(f"{k} {mf_launches[k]}" for k in want) + " (two LSQR runs: a matvec an "
          "iteration, an rmatvec an iteration and one before; then each product twice, timed)")
    if mf["matrixfree_operator"] != "LatticeMatrixFreeKernel" or not launched(mf_launches, **want):
        raise SystemExit(f"FAILED capacity {DENSE_RUNG}: the matrix-free section, {mf}, launches {mf_launches}")
    rec.update(launches=launches, data_cost_initial=initial, captures=solver.captures, replays=solver.replays,
               capture_s=float(captured.group(1)), matrixfree=dict(mf, launches=mf_launches),
               cut={"depth": list(DENSE_DEPTH), "lines": list(DENSE_CUT_LINES)}, phase_s=time.time() - t0)
    print(f"  {DENSE_RUNG} took {rec['phase_s']:.1f} s of phase 30")
    out[DENSE_RUNG] = rec
    return out


def main() -> int:
    t_all = time.time()

    def clock(phase):
        """Where the script's time goes: its seconds so far at each phase."""
        print(f"[t+{time.time() - t_all:.1f} s] phase {phase}", flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    from tomofastx_tpu_torch import cli
    from tomofastx_tpu_torch.config.parfile import read_parfile
    from tomofastx_tpu_torch.inversion import workflow
    from tomofastx_tpu_torch.io import model_io
    from tomofastx_tpu_torch.io.sensit_cache import read_kernel_cache_packed, try_read_kernel_cache
    from tomofastx_tpu_torch.ops import bf16_gemv
    from tomofastx_tpu_torch.ops import blocked_matvec as bmv
    from tomofastx_tpu_torch.ops import graph_while
    from tomofastx_tpu_torch.ops import lattice_matvec as lmv
    from tomofastx_tpu_torch.ops import prism_matvec as pmv
    from tomofastx_tpu_torch.ops import sensitivity as sens
    from tomofastx_tpu_torch.ops import tile_matvec as tmv
    from tomofastx_tpu_torch.ops.lsqr import lsqr_solve
    from tomofastx_tpu_torch.ops.sparse_kernel import DenseKernel
    from tomofastx_tpu_torch.ops.tile_kernel import tile_kernel_from_cache
    from tomofastx_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_kernel

    tile_matvec, tile_matvec_plain = tmv.tile_matvec, tmv.tile_matvec_plain
    blocked_matvec, blocked_matvec_plain = bmv.blocked_matvec, bmv.blocked_matvec_plain
    counters = {"tile_matvec": tile_matvec, "tile_matvec_sharded": tmv.tile_matvec_sharded,
                "blocked_matvec": blocked_matvec, "bf16_matvec": bf16_gemv.bf16_matvec,
                "bf16_rmatvec": bf16_gemv.bf16_rmatvec, "prism_matvec": pmv.prism_matvec,
                "prism_rmatvec": pmv.prism_rmatvec, "lattice_matvec": lmv.lattice_matvec,
                "lattice_rmatvec": lmv.lattice_rmatvec, "prism_near_matvec": pmv.prism_near_matvec,
                "prism_near_rmatvec": pmv.prism_near_rmatvec, "lattice_near_matvec": lmv.lattice_near_matvec,
                "lattice_near_rmatvec": lmv.lattice_near_rmatvec, "prism_near_build": pmv.prism_near_build,
                "lattice_near_build": lmv.lattice_near_build, "graph_while": graph_while.while_graph_launch}
    device = torch.device("cuda")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    smi = nvidia_smi_line()
    print(smi)

    # ---- 1. build, one compiler per source, started together ----
    t0 = time.time()
    jobs = [(m.build_library, ()) for m in (tmv, bmv, bf16_gemv, lmv, graph_while)] + [
        (pmv.build_library, (n,)) for n in pmv.SOURCES]
    with ThreadPoolExecutor(len(jobs)) as pool:
        builds = [pool.submit(fn, *a) for fn, a in jobs]
        for b in builds:
            lib_path, log = b.result()
            print(log.strip())
            print(f"built {os.path.relpath(lib_path, HERE)}")
            REGISTERS.update(ptxas_registers(log))
    build_s = time.time() - t0
    print(f"the {len(jobs)} kernel sources built in {build_s:.1f} s")

    # ---- 2. kernels against plain versions, random ragged layouts ----
    print("kernels against plain versions:")
    tile_matvec_edges(tmv, device)
    uvals, ubidx, x64, (wmin, wmax) = random_pack(device)
    print(f"  random pack: {tuple(uvals.shape)}, tile widths {wmin}..{wmax} of BU = {uvals.shape[1]}")
    compare("tile_matvec, random pack, f32 vector",
            tile_matvec(uvals, ubidx, x64.float()), tile_matvec_plain(uvals, ubidx, x64.float()), RTOL_F32)
    compare("tile_matvec, random pack, f64 vector",
            tile_matvec(uvals, ubidx, x64), tile_matvec_plain(uvals, ubidx, x64), RTOL_F64)
    # Ragged parts (9, 9, 8 tiles of BU = 37: the block ids of a part start
    # off 16-byte alignment in the pack, so each part holds its own copy).
    parts = [(uvals[s : s + 9], ubidx[s : s + 9].clone()) for s in range(0, uvals.shape[0], 9)]
    for x in (x64.float(), x64):
        if not torch.equal(tmv.tile_matvec_sharded(parts, x, device), tile_matvec(uvals, ubidx, x)):
            raise SystemExit(f"FAILED tile_matvec_sharded, random pack in 3 parts: differs from tile_matvec ({x.dtype})")
    compare("tile_matvec_sharded, random pack in 3 parts, f32 vector", tmv.tile_matvec_sharded(parts, x64.float(), device),
            tmv.tile_matvec_sharded_plain(parts, x64.float(), device), RTOL_F32)
    print("  tile_matvec_sharded, random pack in 3 parts: equal to the last bit to tile_matvec, f32 and f64 vectors -> ok")
    bvals, bidx, x64, (wmin, wmax) = random_row_blocks(device)
    print(f"  random row blocks: {tuple(bvals.shape)}, row widths {wmin}..{wmax} of B = {bvals.shape[1]}")
    compare("blocked_matvec, random row blocks, f32 vector",
            blocked_matvec(bvals, bidx, x64.float()), blocked_matvec_plain(bvals, bidx, x64.float()), RTOL_F32)
    compare("blocked_matvec, random row blocks, f64 vector",
            blocked_matvec(bvals, bidx, x64), blocked_matvec_plain(bvals, bidx, x64), RTOL_F64)
    # Kernel B1 on a bfloat16 matrix whose rows are 16-byte aligned (1000
    # columns) and on one whose rows are not (1003: the 2-byte path).
    for nrows, ncols in ((203, 1000), (77, 1003)):
        g = torch.Generator(device="cpu").manual_seed(ncols)
        S16 = torch.randn(nrows, ncols, generator=g).to(device, torch.bfloat16)
        S16[S16.abs() < 0.3] = 0.0
        for v64, kernel, plain in ((torch.randn(ncols, generator=g, dtype=torch.float64).to(device),
                                    bf16_gemv.bf16_matvec, bf16_gemv.bf16_matvec_plain),
                                   (torch.randn(nrows, generator=g, dtype=torch.float64).to(device),
                                    bf16_gemv.bf16_rmatvec, bf16_gemv.bf16_rmatvec_plain)):
            compare(f"{kernel.__name__}, bfloat16 {nrows} x {ncols}, f32 vector", kernel(S16, v64.float()),
                    plain(S16, v64.float()), RTOL_F32)
            compare(f"{kernel.__name__}, bfloat16 {nrows} x {ncols}, f64 vector", kernel(S16, v64), plain(S16, v64),
                    RTOL_F64)
    b2_small = b2_small_problems()
    b3_small = b3_small_problems()
    torch.cuda.synchronize()
    del uvals, ubidx, bvals, bidx, x64, parts, S16

    work = tempfile.mkdtemp(prefix="tomofastx_smoke_")
    cpu_pool = None
    try:
        # ---- 3. the main paths, through the command-line entry point ----
        clock(3)
        t0 = time.time()
        inputs = write_inputs(work, NX, NY, NZ, SIDE, variants=("components", "draped", "topography"))
        print(f"inputs written in {time.time() - t0:.1f} s")
        out = {run: os.path.join(work, f"out_{run}") for run in ("tiled", "tiled_mesh1", "dense", "dense_mesh1", "packed")}
        parfile = write_parfile(work, "Parfile_tiled.txt", inputs, out["tiled"], N_MINOR, fmt="tiled")
        tiled = run_main_path(cli, counters, "tiled", parfile, out["tiled"], {
            "build_s": r"kernel built\+cached in ([0-9.]+)s",
            "pack_s": r"cache packed into tiles in ([0-9.]+)s",
            "format": r"grav kernel: tiled"})
        # Each solve calls rmatvec once before the loop and matvec + rmatvec in
        # every iteration; outside the solves the forward d = S m runs for the
        # synthetic, prior and starting models and after every major.
        products = sum(2 * it + 1 for it in tiled["lsqr_iterations"]) + 3 + N_MAJOR
        print(f"  tile_matvec.launches = {tiled['launches']['tile_matvec']} (expected {products} = sum of "
              f"2 x iterations + 1 per solve, + {3 + N_MAJOR} forward products)")
        if not launched(tiled["launches"], tile_matvec=products, tile_matvec_sharded=0):
            raise SystemExit("FAILED tiled main path: launch count")

        # The same with --mesh 1: the row-sharded build, and every product
        # through tile_matvec_sharded, one launch a card.
        mesh_said = {"shard_s": r"grav kernel sharded over a 1 mesh \('cells',\) in ([0-9.]+)s",
                     "slot0_MB": r"slot 0 \(cuda:0\) ([0-9.]+) MB"}
        parfile_mesh = write_parfile(work, "Parfile_tiled_mesh1.txt", inputs, out["tiled_mesh1"], N_MINOR, fmt="tiled")
        tiled_mesh = run_main_path(cli, counters, "tiled --mesh 1", parfile_mesh, out["tiled_mesh1"], {
            "build_s": r"kernel built\+cached in ([0-9.]+)s",
            "pack_s": r"cache packed into tiles in ([0-9.]+)s",
            "format": r"grav kernel: tiled", **mesh_said}, mesh="1")
        print(f"  tile_matvec_sharded.launches = {tiled_mesh['launches']['tile_matvec_sharded']} (expected "
              f"{products} x 1 slot)")
        if not launched(tiled_mesh["launches"], tile_matvec=0, tile_matvec_sharded=products):
            raise SystemExit("FAILED tiled --mesh 1 main path: launch count")

        # The Parfile with no tpu.kernelFormat line, built from scratch: the
        # device-accumulating build and write_kernel_cache run.
        dense_parfile = write_parfile(work, "Parfile_dense.txt", inputs, out["dense"], N_MINOR, fmt=None)
        dense = run_main_path(cli, counters, "dense (default)", dense_parfile, out["dense"], {
            "predicted": r"predicted kernel size = ([0-9.]+) GB \(float32\)",
            "build_s": r"kernel built in ([0-9.]+)s",
            "compression_rate": r"COMPRESSION RATE = ([0-9.]+)",
            "cache_write_s": r"kernel cached in ([0-9.]+)s",
            "format": DENSE_SAID.format(p="grav", rows=NDATA)})
        dense_parfile_mesh = write_parfile(work, "Parfile_dense_mesh1.txt", inputs, out["dense_mesh1"], N_MINOR, fmt=None)
        dense_mesh = run_main_path(cli, counters, "dense (default) --mesh 1", dense_parfile_mesh, out["dense_mesh1"], {
            "build_s": r"kernel built in ([0-9.]+)s",
            "cache_write_s": r"kernel cached in ([0-9.]+)s",
            "format": DENSE_SAID.format(p="grav", rows=NDATA), **mesh_said}, mesh="1")
        # The packed format from the dense run's cache: read_kernel_cache_packed at full width.
        packed_parfile = write_parfile(
            work, "Parfile_packed.txt", inputs, out["packed"], N_MINOR, fmt="packed",
            extra=["sensit.readFromFiles = 1", f"sensit.folderPath = {out['dense']}/SENSIT/"])
        packed = run_main_path(cli, counters, "packed", packed_parfile, out["packed"], {
            "pack_s": r"cache packed into the packed layout in ([0-9.]+)s",
            "format": r"grav kernel: packed"}, sensit_written=False)
        for run in (dense, dense_mesh, packed):
            if any(run["launches"].values()):
                raise SystemExit("FAILED: a dense or packed run launched a kernel of another format")

        # ---- 4. --mesh 1 against unmeshed; the three formats against each other; small problems ----
        clock(4)
        print("the --mesh 1 runs against the unmeshed runs:")
        mesh_against_unmeshed = {
            "tiled": hold_equal("tiled --mesh 1", tiled_mesh, out["tiled_mesh1"], tiled, out["tiled"]),
            "dense": hold_equal("dense --mesh 1", dense_mesh, out["dense_mesh1"], dense, out["dense"]),
        }
        print("the three formats against each other:")
        ref = tiled["model"]
        spread = {}
        for name, run in (("dense", dense), ("packed", packed)):
            dm = float(np.abs(run["model"] - ref).max() / (ref.max() - ref.min()))
            dc = abs(run["data_cost"][-1] - tiled["data_cost"][-1]) / tiled["data_cost"][-1]
            spread[name] = {"model_of_range": dm, "data_cost_rel": dc}
            print(f"  {name} against tiled: final model differs by {dm:.3e} of its range (tolerance "
                  f"{FORMATS_MODEL_TOL:g}), final data cost {run['data_cost'][-1]:.9e} against "
                  f"{tiled['data_cost'][-1]:.9e}, relative {dc:.3e} (tolerance {FORMATS_COST_RTOL:g})")
            if not dm <= FORMATS_MODEL_TOL or not dc <= FORMATS_COST_RTOL:
                raise SystemExit(f"FAILED formats: {name} against tiled")
        small_rel = {
            "tiled": small_problem_card_against_cpu(work, "small_tiled", "tiled, Haar rate 0.15", fmt="tiled"),
            "dense_uncompressed": small_problem_card_against_cpu(
                work, "small_dense", "dense, uncompressed", fmt=None, compression=0),
        }

        # ---- 5. the full-width tile packs ----
        clock(5)
        print("full-width packs:")
        cfg = read_parfile(parfile)
        grid = model_io.read_model_grid(cfg.grav.model_grid_file, NX, NY, NZ)
        t0 = time.time()
        tk, meta = tile_kernel_from_cache(os.path.join(out["tiled"], "SENSIT"), cfg.grav, grid, device)
        torch.cuda.synchronize()
        print(f"  cache packed again in {time.time() - t0:.1f} s (nnz = {meta['nnz']:,}, "
              f"{meta['nnz'] / (tk.nrows * tk.ncols):.4f} of the dense matrix)")
        # Four slots on the one card: the one way to cut a pack on a machine
        # with one card. The parts' values are views of the packs.
        mesh4 = Mesh(np.array([device] * 4, dtype=object), ("cells",))
        cpu_pool = start_cpu_pool()
        phase23 = start_phase_23(work, mesh4, counters, cpu_pool)
        tks = shard_kernel(tk, mesh4)
        views = all(
            p[0].data_ptr() == whole[k * p[0].shape[0]].data_ptr()
            for parts, whole in ((tks.parts, tk.uvals), (tks.partsT, tk.uvalsT)) for k, p in enumerate(parts)
        )
        print(f"  both packs sharded over {mesh4}: forward parts {[tuple(p[0].shape) for p in tks.parts]}, "
              f"adjoint parts {[tuple(p[0].shape) for p in tks.partsT]}; values are views of the packs: {views}")
        if not views:
            raise SystemExit("FAILED sharding on one card: the parts' values are copies")
        fwd = measure_pack(tmv, "forward", tk.uvals, tk.ubidx, tk.ncols, 1, tks.parts)
        adj = measure_pack(tmv, "adjoint", tk.uvalsT, tk.ubidxT, tk.nrows, 2, tks.partsT)
        for dt in (torch.float32, torch.float64):
            xs = seeded_vector(tk.ncols, 6, device)[: tk.ncols].to(dt)
            us = seeded_vector(tk.nrows, 7, device)[: tk.nrows].to(dt)
            if not (torch.equal(tks.matvec(xs), tk.matvec(xs)) and torch.equal(tks.rmatvec(us), tk.rmatvec(us))):
                raise SystemExit(f"FAILED 4-slot operator: products differ from the unsharded operator's ({dt})")
        print("  the 4-slot operator's matvec and rmatvec equal the unsharded operator's to the last bit, "
              "f32 and f64 vectors -> ok")
        del tks

        # ---- 6. blocked_matvec on row-block layouts of the dense matrix ----
        clock(6)
        print("full-width row-block layouts:")
        t0 = time.time()
        S = try_read_kernel_cache(os.path.join(out["dense"], "SENSIT"), cfg.grav, grid, device).S
        torch.cuda.synchronize()
        print(f"  cache read into the dense {tuple(S.shape)} matrix in {time.time() - t0:.1f} s")
        x64 = seeded_vector(S.shape[1], 4, device)
        bvals, bidx, wmin = row_blocks_all_used(S)
        print(f"  every used block: {tuple(bvals.shape)}, rows use {wmin}..{bvals.shape[1]} of "
              f"{S.shape[1] // 128} blocks")
        bmv.check_block_ids(bidx, S.shape[1])
        used = measure_layout(blocked_matvec, blocked_matvec_plain, "row blocks, every used block",
                              bvals, bidx, S.shape[0], x64, S)
        tvals, tidx, kept = row_blocks_top_energy(S, TOP_BLOCKS)
        print(f"  {TOP_BLOCKS} blocks of largest energy per row: {tuple(tvals.shape)}, "
              f"{kept:.6f} of the matrix's energy")
        bmv.check_block_ids(tidx, S.shape[1])
        # The same function as a dense matrix that holds only those blocks:
        # torch.mv on it is the library call for this layout.
        dense_top = torch.zeros_like(S)
        dense_top.view(S.shape[0], -1, 128).scatter_(1, tidx.long()[:, :, None].expand(-1, -1, 128), tvals)
        top = measure_layout(blocked_matvec, blocked_matvec_plain, f"row blocks, top {TOP_BLOCKS}",
                             tvals, tidx, S.shape[0], x64, dense_top)
        del tvals, tidx, dense_top

        # The path that runs blocked_matvec: the port's forward-data and LSQR
        # entry points with the row-block layout as the forward operator, held
        # against the same calls on the dense kernel. The matrix is the cache's
        # (no row weights), so the weights handed over are ones.
        print("row-block path (calculate_data and lsqr_solve over blocked_matvec):")
        cw = np.fromfile(os.path.join(out["dense"], "SENSIT", "sensit_grav_weight"), np.float64, offset=4)
        ones = np.ones((NDATA, 1))
        rows, dk = RowBlocks(blocked_matvec, bvals, bidx), DenseKernel(S)
        blocked_matvec.launches = 0
        data = {
            name: sens.calculate_data(op, dense["model"], cw, 1.0, ones, 1, NX, NY, NZ,
                                      solve_dtype=torch.float32, device=device)
            for name, op in (("blocked", rows), ("dense", dk))
        }
        b = torch.as_tensor(data["dense"].reshape(-1), dtype=torch.float32, device=device)
        sol = {
            name: lsqr_solve(op.matvec, dk.rmatvec, b, S.shape[1], niter=N_MINOR, rmin=1e-13)
            for name, op in (("blocked", rows), ("dense", dk))
        }
        torch.cuda.synchronize()
        blocked_launches = blocked_matvec.launches
        compare("forward data of the dense run's final model, row blocks against dense kernel",
                torch.as_tensor(data["blocked"]), torch.as_tensor(data["dense"]), RTOL_F32_FORWARD)
        compare(f"LSQR solution after {sol['blocked'].iters} iterations, row blocks against dense kernel",
                sol["blocked"].x, sol["dense"].x, RTOL_F32_LSQR)
        print(f"  blocked_matvec.launches = {blocked_launches} (expected {1 + sol['blocked'].iters} = 1 forward "
              f"product + 1 per LSQR iteration); relative residual {float(sol['blocked'].r):.6e} against "
              f"{float(sol['dense'].r):.6e} over the dense kernel")
        if blocked_launches != 1 + sol["blocked"].iters or sol["blocked"].iters != N_MINOR:
            raise SystemExit("FAILED row-block path: launch count")
        del bvals, bidx, rows

        # ---- 7. the three operators at full width ----
        clock(7)
        print("operators at full width (ms by CUDA events, f32 vectors, median of 20):")
        pk, _ = read_kernel_cache_packed(os.path.join(out["dense"], "SENSIT"), cfg.grav, grid, device=device)
        xs, us = x64[: S.shape[1]].float(), seeded_vector(S.shape[0], 5, device)[: S.shape[0]].float()
        operators = {}
        y_ref, g_ref = dk.matvec(xs), dk.rmatvec(us)
        for name, op in (("tiled", tk), ("dense", dk), ("packed", pk)):
            compare(f"{name} matvec against the dense product", op.matvec(xs), y_ref, RTOL_F32)
            compare(f"{name} rmatvec against the dense product", op.rmatvec(us), g_ref, RTOL_F32)
            operators[name] = {
                "matvec_ms": time_cuda(lambda: op.matvec(xs)), "rmatvec_ms": time_cuda(lambda: op.rmatvec(us)),
                "bytes": op.nbytes,
            }
        print("  | operator | matvec ms | rmatvec ms | both ms | GB on the card |")
        for name, o in operators.items():
            print(f"  | {name} | {o['matvec_ms']:.3f} | {o['rmatvec_ms']:.3f} | "
                  f"{o['matvec_ms'] + o['rmatvec_ms']:.3f} | {o['bytes'] / 1e9:.3f} |")
        print(f"  packed: rows {tuple(pk.row_vals.shape)}, heavy columns {tuple(pk.dense_block.shape)}, "
              f"light columns {tuple(pk.light_vals.shape)}")
        del tk, dk, pk, op  # op: the loop above leaves it naming pk
        gemv = measure_bf16_gemv(S)
        del S

        # ---- 8. whole solves over the four-slot mesh, from the tiled run's cache ----
        clock(8)
        print(f"solves from the tiled run's cache through solve_problem_joint_gravmag, over {mesh4}:")
        cache = os.path.join(out["tiled"], "SENSIT")
        solves = {"tiled": solve_from_cache(work, "tiled_unmeshed", inputs, cache, "tiled", None, counters)}
        hold_equal("tiled solve from the cache", solves["tiled"], solves["tiled"]["out_dir"], tiled, out["tiled"],
                   against="the tiled main path")
        solves["tiled_4_slots"] = solve_from_cache(work, "tiled_4_slots", inputs, cache, "tiled", mesh4, counters)
        # The four slots share the card: one launch of kernel 2 a product.
        if not launched(solves["tiled_4_slots"]["launches"], tile_matvec=0, tile_matvec_sharded=products):
            raise SystemExit(f"FAILED tiled 4-slot solve: launch count (expected {products}, one a product)")
        if not (np.array_equal(solves["tiled_4_slots"]["model"], solves["tiled"]["model"])
                and same_bytes(*(os.path.join(solves[k]["out_dir"], "costs.txt") for k in ("tiled", "tiled_4_slots")))):
            raise SystemExit("FAILED tiled 4-slot solve: not equal to the last bit to the unmeshed solve")
        print(f"  tiled over 4 slots: {products} launches of tile_matvec_sharded (one a product for the four "
              "slots of the card); final model and costs.txt equal to the last bit to the unmeshed solve -> ok")
        solves["dense_4_slots"] = solve_from_cache(work, "dense_4_slots", inputs, cache, None, mesh4, counters)
        if any(solves["dense_4_slots"]["launches"].values()):
            raise SystemExit("FAILED dense 4-slot solve: a kernel of another format was launched")
        ref = dense["model"]
        dm = float(np.abs(solves["dense_4_slots"]["model"] - ref).max() / (ref.max() - ref.min()))
        dc = abs(solves["dense_4_slots"]["data_cost"][-1] - dense["data_cost"][-1]) / dense["data_cost"][-1]
        solves["dense_4_slots"].update(model_of_range=dm, data_cost_rel=dc)
        print(f"  dense over 4 slots (four column partials a product) against the dense main path: final model "
              f"differs by {dm:.3e} of its range (tolerance {FORMATS_MODEL_TOL:g}), final data cost by {dc:.3e} "
              f"relative (tolerance {FORMATS_COST_RTOL:g})")
        if not dm <= FORMATS_MODEL_TOL or not dc <= FORMATS_COST_RTOL:
            raise SystemExit("FAILED dense 4-slot solve: against the dense main path")

        # ---- 9. distinct cards, where the machine has them ----
        clock(9)
        ncards = torch.cuda.device_count()
        if ncards >= 2:
            cards = make_mesh(ncards, device="cuda")
            print(f"solve over {cards}:")
            for k in range(ncards):
                torch.cuda.reset_peak_memory_stats(k)
            solves["tiled_cards"] = solve_from_cache(work, "tiled_cards", inputs, cache, "tiled", cards, counters)
            solves["tiled_cards"]["peak_GB_per_card"] = [torch.cuda.max_memory_allocated(k) / 1e9 for k in range(ncards)]
            print(f"  peak device memory per card (the kernel assembled on the host, one part a card): "
                  f"{[round(v, 3) for v in solves['tiled_cards']['peak_GB_per_card']]} GB")
            if solves["tiled_cards"]["launches"]["tile_matvec_sharded"] != ncards * products:  # one a card
                raise SystemExit(f"FAILED tiled solve over {ncards} cards: launch count")
            if not np.array_equal(solves["tiled_cards"]["model"], solves["tiled"]["model"]):
                raise SystemExit(f"FAILED tiled solve over {ncards} cards: not equal to the unmeshed solve")
            print(f"  tiled over {ncards} cards: final model equal to the last bit to the unmeshed solve -> ok")
        else:
            print("this machine has one card: the solve over make_mesh(device_count) on distinct cards did not run, "
                  "and no peak per card was read")

        # A mesh of distinct cards assembles each kernel on the host
        # (parallel.mesh.assembly_device): built into pinned host memory, or
        # packed from the cache there; weighted there; then each card's part
        # copied to it. One card makes no such mesh, so the workflow is handed
        # the host as the assembly device over a one-slot mesh of the card:
        # the same path, whose one part is the whole kernel.
        print("the host assembly of a mesh of distinct cards, over a one-slot mesh of the card:")
        card_assembly = workflow.assembly_device
        workflow.assembly_device = lambda m: torch.device("cpu")
        try:
            solves["tiled_host_assembly"] = host = solve_from_cache(
                work, "tiled_host_assembly", inputs, cache, "tiled", make_mesh(1, device="cuda"), counters)
            if not launched(host["launches"], tile_matvec=0, tile_matvec_sharded=products):
                raise SystemExit("FAILED tiled solve assembled on the host: launch count")
            if not (np.array_equal(host["model"], solves["tiled"]["model"])
                    and same_bytes(*(os.path.join(r["out_dir"], "costs.txt") for r in (host, solves["tiled"])))):
                raise SystemExit("FAILED tiled solve assembled on the host: not equal to the unmeshed solve")
            print(f"  tiled from the cache: packed on the host in {host['pack_s']:.2f} s, weighted there in "
                  f"{host['row_weights_s']:.2f} s, copied to the card in {host['shard_s']:.2f} s; peak device memory "
                  f"{host['peak_device_GB']:.2f} GB (packed on the card: {solves['tiled']['peak_device_GB']:.2f} GB); "
                  "final model and costs.txt equal to the last bit to the unmeshed solve -> ok")
            out["dense_host"] = os.path.join(work, "out_dense_host")
            # No cache written: the writer ran in phase 3, and this run is about the host assembly.
            dense_host = run_main_path(cli, counters, "dense (default) --mesh 1, assembled on the host", write_parfile(
                work, "Parfile_dense_host.txt", inputs, out["dense_host"], N_MINOR, fmt=None,
                extra=["tpu.sensitWriteCache = 0"]), out["dense_host"], {
                    "build_s": r"kernel built in ([0-9.]+)s",
                    "row_weights_host_s": r"row weights applied on cpu in ([0-9.]+)s",
                    "format": DENSE_SAID.format(p="grav", rows=NDATA), **mesh_said}, mesh="1", sensit_written=False)
            if any(dense_host["launches"].values()):
                raise SystemExit("FAILED dense main path assembled on the host: a kernel of another format was launched")
            dense_host["against_card_assembly"] = hold_equal(
                "dense --mesh 1 assembled on the host", dense_host, out["dense_host"], dense, out["dense"])
            if not dense_host["against_card_assembly"]["equal_to_the_last_bit"]:
                raise SystemExit("FAILED dense main path assembled on the host: not equal to the last bit")
            print(f"  dense from scratch: built into pinned host memory in {dense_host['build_s']:.2f} s (on the card: "
                  f"{dense['build_s']:.2f} s), weighted there in {dense_host['row_weights_host_s']:.2f} s, copied to the "
                  f"card in {dense_host['shard_s']:.2f} s; peak device memory {dense_host['peak_device_GB']:.2f} GB "
                  f"(assembled on the card: {dense['peak_device_GB']:.2f} GB)")
        finally:
            workflow.assembly_device = card_assembly

        # ---- 10. joint gravity + magnetic main paths, tiled and dense ----
        clock(10)
        joint_dir = os.path.join(work, "joint")
        os.makedirs(joint_dir)
        joint_inputs = write_inputs(joint_dir, NX, NY, NZ, SIDE, height=JOINT_HEIGHT, variants=("mag",))
        joint_out = {f: os.path.join(work, f"out_joint_{f}") for f in ("tiled", "dense")}
        joint = {}
        joint["tiled"] = run_main_path(cli, counters, "joint grav+mag tiled", write_parfile(
            joint_dir, "Parfile_joint_tiled.txt", joint_inputs, joint_out["tiled"], N_MINOR, fmt="tiled", kind="joint"),
            joint_out["tiled"], {"format": r"grav kernel: tiled", "format_mag": r"mag kernel: tiled"}, kind="joint")
        # Both problems' products: each solve calls rmatvec once and matvec +
        # rmatvec per iteration on each operator; the forward d = S m runs for
        # the synthetic, prior and starting models and after every major.
        joint_products = 2 * (sum(2 * it + 1 for it in joint["tiled"]["lsqr_iterations"]) + 3 + N_MAJOR)
        print(f"  tile_matvec.launches = {joint['tiled']['launches']['tile_matvec']} (expected {joint_products} = "
              f"2 problems x (sum of 2 x iterations + 1 per solve, + {3 + N_MAJOR} forward products))")
        if not launched(joint["tiled"]["launches"], tile_matvec=joint_products, tile_matvec_sharded=0):
            raise SystemExit("FAILED joint tiled main path: launch count")
        joint["dense"] = run_main_path(cli, counters, "joint grav+mag dense (default)", write_parfile(
            joint_dir, "Parfile_joint_dense.txt", joint_inputs, joint_out["dense"], N_MINOR, fmt=None, kind="joint"),
            joint_out["dense"], {"format": DENSE_SAID.format(p="grav", rows=NDATA),
                                 "format_mag": DENSE_SAID.format(p="mag", rows=NDATA)}, kind="joint")
        if any(joint["dense"]["launches"].values()):
            raise SystemExit("FAILED joint dense main path: a kernel of another format was launched")
        joint_spread = formats_apart("joint dense against joint tiled", joint["dense"], joint["tiled"])

        # ---- 11. the full FTG tensor, dense, no cache written ----
        clock(11)
        ftg_out = os.path.join(work, "out_ftg")
        ftg = run_main_path(cli, counters, "FTG full tensor dense (default)", write_parfile(
            work, "Parfile_ftg.txt", inputs, ftg_out, N_MINOR, fmt=None, kind="ftg", extra=["tpu.sensitWriteCache = 0"]),
            ftg_out, {"format": DENSE_SAID.format(p="grav", rows=6 * NDATA),
                      "predicted": r"predicted kernel size = ([0-9.]+) GB \(float32\)"},
            sensit_written=False, kind="ftg", what=f"{NDATA} observations x 6 components")
        if any(ftg["launches"].values()) or os.path.exists(os.path.join(ftg_out, "SENSIT")):
            raise SystemExit("FAILED FTG main path: a kernel was launched, or a cache was written")

        # ---- 12. small problems of every kind, card against CPU ----
        clock(12)
        small_rel.update({
            "tmi_tiled": small_problem_card_against_cpu(work, "small_tmi", "TMI on susceptibility, tiled",
                                                        kind="tmi", fmt="tiled"),
            "magnetization_vector_dense": small_problem_card_against_cpu(
                work, "small_mvi", "TMI on the magnetization vector, dense", kind="mvi", fmt="dense"),
            "mag_3_components_packed": small_problem_card_against_cpu(
                work, "small_mag3", "three-component magnetic data, packed", kind="mag3", fmt="packed"),
            "borehole_dense": small_problem_card_against_cpu(
                work, "small_borehole", "TMI with observations inside the grid, dense", kind="borehole", fmt="dense"),
            "gzz_tiled": small_problem_card_against_cpu(work, "small_gzz", "FTG Gzz, tiled", kind="gzz", fmt="tiled"),
            "joint_dense": small_problem_card_against_cpu(work, "small_joint", "joint grav+mag, dense", kind="joint",
                                                          fmt="dense"),
        })

        # ---- 13. the joint solve from the joint tiled run's cache, unmeshed and over four slots ----
        clock(13)
        print(f"joint solves from the joint tiled run's cache, unmeshed and over {mesh4}:")
        joint_cache = os.path.join(joint_out["tiled"], "SENSIT")
        solves["joint_tiled"] = solve_from_cache(joint_dir, "joint_unmeshed", joint_inputs, joint_cache, "tiled",
                                                 None, counters, kind="joint")
        solves["joint_tiled_4_slots"] = solve_from_cache(joint_dir, "joint_4_slots", joint_inputs, joint_cache,
                                                         "tiled", mesh4, counters, kind="joint")
        if not launched(solves["joint_tiled_4_slots"]["launches"], tile_matvec=0, tile_matvec_sharded=joint_products):
            raise SystemExit(f"FAILED joint 4-slot solve: launch count (expected {joint_products}, one a product)")
        a, b = solves["joint_tiled"], solves["joint_tiled_4_slots"]
        if not (all(np.array_equal(a["models"][i], b["models"][i]) for i in (0, 1))
                and same_bytes(*(os.path.join(r["out_dir"], "costs.txt") for r in (a, b)))):
            raise SystemExit("FAILED joint 4-slot solve: not equal to the last bit to the unmeshed joint solve")
        print(f"  joint over 4 slots: {joint_products} x 4 launches of tile_matvec; both final models and costs.txt "
              "equal to the last bit to the unmeshed joint solve -> ok")

        # ---- 14. tile_matvec on the magnetic problem's packs ----
        clock(14)
        print("full-width magnetic packs:")
        cfgj = read_parfile(os.path.join(joint_dir, "Parfile_joint_tiled.txt"))
        t0 = time.time()
        tkm, metam = tile_kernel_from_cache(joint_cache, cfgj.magn, grid, device)
        torch.cuda.synchronize()
        print(f"  magnetic cache packed again in {time.time() - t0:.1f} s (nnz = {metam['nnz']:,}, "
              f"{metam['nnz'] / (tkm.nrows * tkm.ncols):.4f} of the dense matrix)")
        mag_packs = {}
        for pname, uv, ub, n_in, seed in (("magnetic forward", tkm.uvals, tkm.ubidx, tkm.ncols, 8),
                                          ("magnetic adjoint", tkm.uvalsT, tkm.ubidxT, tkm.nrows, 9)):
            x64 = seeded_vector(n_in, seed, device)
            dense_m = dense_from_pack(uv, ub, x64.shape[0])
            mag_packs[pname] = measure_layout(tmv.tile_matvec, tmv.tile_matvec_plain, f"{pname} pack", uv, ub,
                                              ub.shape[0] * 8, x64, dense_m)
            del dense_m
            torch.cuda.empty_cache()
        del tkm, uv, ub  # the loop's names hold the adjoint pack (4.3 GB) too

        # ---- 15. the coupled joint problem at full width: cross-gradient, damping gradient, clustering ----
        clock(15)
        print("coupled joint grav+mag (cross-gradient, damping gradient, clustering) from the joint tiled run's cache:")
        t0 = time.time()
        files = write_coupling_files(joint_dir, NX * NY * NZ)
        weights, scales = coupling_weights(joint_cache, cfgj)
        coupled_extra = coupling_lines(weights, files) + [
            "sensit.readFromFiles = 1", f"sensit.folderPath = {joint_cache}/"]
        print(f"  weights by the row-scale rule ({time.time() - t0:.1f} s): {json.dumps(weights)}; "
              f"from {json.dumps(scales)}")
        coupled_out = {f: os.path.join(work, f"out_coupled_{f}") for f in ("tiled", "dense")}
        coupled = {}
        coupled_said = {"wavelet_domain": r"WAVELET_DOMAIN = False"}
        with capturing_the_system(workflow) as captured:
            coupled["tiled"] = run_main_path(cli, counters, "coupled joint tiled", write_parfile(
                joint_dir, "Parfile_coupled_tiled.txt", joint_inputs, coupled_out["tiled"], N_MINOR, fmt="tiled",
                kind="joint", extra=coupled_extra), coupled_out["tiled"],
                {**coupled_said, "format": r"grav kernel: tiled", "format_mag": r"mag kernel: tiled"},
                sensit_written=False, kind="joint")
        print(f"  tile_matvec.launches = {coupled['tiled']['launches']['tile_matvec']} (expected {joint_products}, "
              "as in the joint run: the constraint blocks do not touch S)")
        if not launched(coupled["tiled"]["launches"], tile_matvec=joint_products, tile_matvec_sharded=0):
            raise SystemExit("FAILED coupled tiled main path: launch count")
        coupled["tiled"]["costs_9_20"] = check_coupled_outputs("coupled tiled", coupled_out["tiled"],
                                                               list(range(10, 21)))
        blocks_ms, blocks_launches = time_blocks(captured["spec"], captured["arrays"])
        per_iteration = [s / N_MINOR * 1e3 for s in coupled["tiled"]["major_s"]]
        print("  coupled system, one LSQR iteration's products by block (ms, CUDA events, f32, median of 20): "
              + json.dumps({k: round(v, 4) for k, v in blocks_ms.items()}))
        print(f"  kernels launched by one system matvec + rmatvec: {json.dumps(blocks_launches)}; whole majors "
              f"{[round(v, 3) for v in per_iteration]} ms per LSQR iteration (the joint run without the "
              f"constraints: {[round(v / N_MINOR * 1e3, 3) for v in joint['tiled']['major_s']]})")
        coupled["blocks_ms"], coupled["blocks_launches"] = blocks_ms, blocks_launches
        # The operators of the captured tensors go before the next run.
        del captured["arrays"]
        torch.cuda.empty_cache()
        coupled["dense"] = run_main_path(cli, counters, "coupled joint dense (default)", write_parfile(
            joint_dir, "Parfile_coupled_dense.txt", joint_inputs, coupled_out["dense"], N_MINOR, fmt=None,
            kind="joint", extra=coupled_extra), coupled_out["dense"],
            {**coupled_said, "format": DENSE_SAID.format(p="grav", rows=NDATA),
             "format_mag": DENSE_SAID.format(p="mag", rows=NDATA)}, sensit_written=False, kind="joint")
        if any(coupled["dense"]["launches"].values()):
            raise SystemExit("FAILED coupled dense main path: a kernel of another format was launched")
        coupled["dense"]["costs_9_20"] = check_coupled_outputs("coupled dense", coupled_out["dense"],
                                                               list(range(10, 21)))
        coupled_spread = formats_apart("coupled dense against coupled tiled", coupled["dense"], coupled["tiled"])

        # Over four slots of the card: the same start, so equal model
        # updates in every major mean equal final models.
        with capturing_the_system(workflow) as captured4:
            solves["coupled_tiled_4_slots"] = four = solve_from_cache(
                joint_dir, "coupled_4_slots", joint_inputs, joint_cache, "tiled", mesh4, counters, kind="joint",
                extra=coupling_lines(weights, files))
        if not launched(four["launches"], tile_matvec=0, tile_matvec_sharded=joint_products):
            raise SystemExit(f"FAILED coupled 4-slot solve: launch count (expected {joint_products}, one a product)")
        equal_updates = len(captured4["deltas"]) == len(captured["deltas"]) == N_MAJOR and all(
            torch.equal(a, b) for da, db in zip(captured4["deltas"], captured["deltas"]) for a, b in zip(da, db))
        if not (equal_updates and same_bytes(os.path.join(four["out_dir"], "costs.txt"),
                                             os.path.join(coupled_out["tiled"], "costs.txt"))):
            raise SystemExit("FAILED coupled 4-slot solve: not equal to the last bit to the unmeshed coupled run")
        print(f"  coupled over 4 slots: {joint_products} launches of tile_matvec_sharded; both problems' model updates "
              "in every major and costs.txt equal to the last bit to the unmeshed coupled run -> ok")
        del captured, captured4


        # ---- 16. small coupled problems, card against CPU ----
        clock(16)
        small_rel.update({
            f"coupled_{variant}_{fmt or 'dense'}": small_problem_card_against_cpu(
                work, f"small_coupled_{variant}", f"joint grav+mag, {variant.replace('_', ' ')}, {fmt or 'dense'}",
                kind="joint", fmt=fmt, coupling=small_coupling(variant))
            for variant, fmt in (("cross_gradient_forward", "tiled"), ("cross_gradient_vector_field", None),
                                 ("cross_gradient_grav_kept_constant", "tiled"),
                                 ("damping_gradient_weights_file", None),
                                 ("clustering_normal_cell_weights", "tiled"), ("clustering_log", None),
                                 ("read_from_files_2", "tiled"))
        })

        # ---- 17. resume, --profile and --debug-nans on the card ----
        clock(17)
        late = phase_17(cli, counters, tmv, work)

        # ---- 18-23. the native table reader, the matrix-free operators, auto ----
        clock(18)
        mf = {"reader": phase_18(work, inputs)}
        clock(19)
        mf["bttb"] = phase_19(cli, counters, workflow, work, inputs, mesh4)
        clock(20)
        mf["lattice"] = phase_20(cli, counters, workflow, work, inputs)
        clock(21)
        mf["generic"] = phase_21(cli, counters, work, inputs)
        clock(22)
        mf["auto"] = phase_22(cli, counters, work)
        clock(23)
        small_rel.update({f"matrixfree_{k}": v for k, v in phase_23(phase23).items()})

        # ---- 24-27. bfloat16 storage, the three builds, refineForward, small problems ----
        clock(24)
        variants = {"bf16": phase_24(cli, counters, work, inputs, dense, out["dense"])}
        clock(25)
        variants["builds"] = phase_25(cli, counters, work, inputs, out["tiled"], cfg.grav, grid, products)
        clock(26)
        variants["refine"] = phase_26(cli, counters, work, inputs, products, os.path.join(out["tiled"], "SENSIT"))
        clock(27)
        small_rel.update({f"variant_{k}": v for k, v in phase_27(work).items()})

        # ---- 28. the fused major loop: one CUDA graph a major, LSQR as a WHILE node ----
        clock(28)
        fused = phase_28(cli, counters, workflow, work, inputs, {
            "tiled": (tiled, out["tiled"]), "bf16": (variants["bf16"]["runs"]["run"],),
            "coupled": (coupled["tiled"], coupled_out["tiled"], joint_dir, joint_inputs, coupled_extra),
            "bttb": (mf["bttb"]["runs"]["run"],), "refine64": (variants["refine"]["runs"]["double"],),
            "per_cell": (mf["generic"]["run"],), "lattice": (mf["lattice"]["runs"]["run"],)})
        small_rel.update({f"fused_{k}": v for k, v in fused["small"].items()})

        # ---- 29. a capacity rung at its full width ----
        clock(29)
        capacity = phase_29(counters, workflow, work)

        # ---- 30. the million-cell dense run and the per-cell operator at 4M cells ----
        clock(30)
        slice30 = phase_30(counters, workflow, work)
        for name, run in [(f"bttb {k}", v) for k, v in mf["bttb"]["runs"].items()] + [
                ("lattice dense", mf["lattice"]["runs"]["dense"]), ("lattice dense f64", mf["lattice"]["runs"]["dense_f64"]),
                ("auto", mf["auto"]["run"])]:
            if any(run["launches"].values()):
                raise SystemExit(f"FAILED {name}: a kernel of another format was launched")
    finally:
        if cpu_pool is not None:
            cpu_pool.terminate()
            cpu_pool.join()
        shutil.rmtree(work, ignore_errors=True)

    total_s = time.time() - t_all
    print(f"total {total_s:.1f} s")
    if total_s > 600:
        raise SystemExit(f"FAILED: the whole run took {total_s:.1f} s, more than its 600 s")

    def report(run):
        return {k: v for k, v in run.items() if k not in ("model", "models", "sharded", "out_dir")}

    b2_main = mf["generic"]["b2"]["g_z float32"]
    b3_main = mf["lattice"]["b3"]["g_z float32"]

    def capacity_near(kind, what):
        """The near passes' (or, what = "rows", their build's) readings of
        the capacity rung that runs `kind`'s operator."""
        if kind == "prism":
            return {f"capacity {GENERIC_RUNG}": slice30[GENERIC_RUNG]["b2"]["near"][what]}
        return {f"capacity {CAPACITY_RUNG}": capacity["b3"]["near"][what]}
    kernels = [
        {
            "name": "tile_matvec", "route": "cuda",
            "source": "tomofastx_tpu_torch/csrc/tile_matvec.cu",
            "replaces": "tomofastx_tpu/ops/pallas_kernels.py:178",
            "launches": tiled["launches"]["tile_matvec"],
            "max_abs_err": max(fwd["max_abs_err"], adj["max_abs_err"]),
            "ms": fwd["ms"], "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound_ms"],
            "bound_by": fwd["bound_by"], "library_ms": fwd["library_ms"],
            "shape_of_these_times": "forward pack, f32 vector",
            "forward": report(fwd), "adjoint": report(adj),
            "launches_joint_tiled": joint["tiled"]["launches"]["tile_matvec"],
            "launches_coupled_tiled": coupled["tiled"]["launches"]["tile_matvec"],
            "launches_fused_tiled": fused["runs"]["tiled"]["launches_fused"]["tile_matvec"],
            "launches_fused_coupled_tiled": fused["runs"]["coupled joint tiled"]["launches_fused"]["tile_matvec"],
            "magnetic_forward": mag_packs["magnetic forward"], "magnetic_adjoint": mag_packs["magnetic adjoint"],
        },
        {
            "name": "tile_matvec_sharded", "route": "cuda",
            "source": "tomofastx_tpu_torch/csrc/tile_matvec.cu",
            "wrapper": "tomofastx_tpu_torch/ops/tile_matvec.py: tile_matvec_sharded, one launch a card",
            "replaces": "tomofastx_tpu/ops/tile_kernel.py:67",
            "launches": tiled_mesh["launches"]["tile_matvec_sharded"],
            "max_abs_err": max(fwd["sharded"]["max_abs_err"], adj["sharded"]["max_abs_err"]),
            "ms": fwd["sharded"]["ms"], "plain_ms": fwd["sharded"]["plain_ms"],
            "bound_ms": fwd["sharded"]["bound_ms"], "bound_by": fwd["sharded"]["bound_by"],
            "library_ms": fwd["sharded"]["library_ms"],
            "shape_of_these_times": "forward pack cut over 4 slots on one card, f32 vector",
            "forward": fwd["sharded"], "adjoint": adj["sharded"],
            "launches_joint_4_slots": solves["joint_tiled_4_slots"]["launches"]["tile_matvec_sharded"],
            "launches_coupled_4_slots": solves["coupled_tiled_4_slots"]["launches"]["tile_matvec_sharded"],
            "launches_fused_mesh1": fused["runs"]["tiled --mesh 1"]["launches_fused"]["tile_matvec_sharded"],
        },
        {
            "name": "blocked_matvec", "route": "cuda",
            "source": "tomofastx_tpu_torch/csrc/blocked_matvec.cu",
            "replaces": "tomofastx_tpu/ops/pallas_kernels.py:82",
            "launches": blocked_launches,
            "max_abs_err": max(used["max_abs_err"], top["max_abs_err"]),
            "ms": used["ms"], "plain_ms": used["plain_ms"], "bound_ms": used["bound_ms"],
            "bound_by": used["bound_by"], "library_ms": used["library_ms"],
            "shape_of_these_times": "every used block of each row, f32 vector",
            "every_used_block": used, f"top_{TOP_BLOCKS}_blocks": top,
        },
    ] + [
        {
            "name": name, "route": "cuda",
            "source": "tomofastx_tpu_torch/csrc/bf16_gemv.cu",
            "wrapper": f"tomofastx_tpu_torch/ops/bf16_gemv.py: {name}",
            "replaces": "tomofastx_tpu/ops/sparse_kernel.py:188 (no Pallas kernel: XLA's convert-fused GEMV on the "
                        "bfloat16 kernel)" if name == "bf16_matvec" else
                        "tomofastx_tpu/ops/sparse_kernel.py:197 (no Pallas kernel: XLA's convert-fused GEMV on the "
                        "bfloat16 kernel)",
            "launches": variants["bf16"]["runs"]["run"]["launches"][name],
            "launches_mesh1": variants["bf16"]["runs"]["mesh1"]["launches"][name],
            "launches_fused": fused["runs"]["bfloat16 dense"]["launches_fused"][name],
            **{k: gemv[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "shape_of_these_times": "the gravity kernel cast to bfloat16, f32 vector",
            "measured": gemv[name],
        }
        for name in ("bf16_matvec", "bf16_rmatvec")
    ] + [
        {
            "name": name, "route": "cuda",
            "source": "tomofastx_tpu_torch/csrc/prism_matvec_f32.cu (+ prism_matvec.cuh; float64: prism_matvec_f64.cu)",
            "wrapper": f"tomofastx_tpu_torch/ops/prism_matvec.py: {name}",
            "replaces": f"tomofastx_tpu/ops/matrixfree.py:{line} (no Pallas kernel: XLA's fusion of the per-cell rows "
                        "and their product, rows tomofastx_tpu/ops/matrixfree.py:59, :84, quadrature "
                        "tomofastx_tpu/ops/prism.py:529)",
            "launches": mf["generic"]["run"]["launches"][name],
            "launches_fused": fused["runs"]["per-cell"]["launches_fused"][name],
            f"launches_capacity_{GENERIC_RUNG}": slice30[GENERIC_RUNG]["launches"][name],
            **{k: b2_main[f][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "yardstick_torch_mv_f32_ms": mf["generic"]["yardstick"][yard],
            "shape_of_these_times": "g_z float32 blend, 4096 x 262144: the per-cell main path's operator",
            "measured": {**{k: v[f] for k, v in mf["generic"]["b2"].items()},
                         f"capacity {GENERIC_RUNG}": slice30[GENERIC_RUNG]["b2"][f]},
            "small_problems": b2_small,
            "registers": b2_main["registers"],
        }
        for name, f, line, yard in (("prism_matvec", "matvec", 244, "torch_mv_f32_ms"),
                                    ("prism_rmatvec", "rmatvec", 283, "torch_mv_f32_T_ms"))
    ] + [
        {
            "name": f"{kind}_near_{f}", "route": "cuda", "source": source,
            "wrapper": f"tomofastx_tpu_torch/ops/{kind}_matvec.py: {kind}_near_{f}",
            "replaces": replaces,
            "launches": launches[f"{kind}_near_{f}"],
            "launches_fused": fused["runs"][run]["launches_fused"][f"{kind}_near_{f}"],
            f"launches_capacity_{CAPACITY_RUNG}": capacity["launches"][f"{kind}_near_{f}"],
            f"launches_capacity_{GENERIC_RUNG}": slice30[GENERIC_RUNG]["launches"][f"{kind}_near_{f}"],
            f"launches_capacity_{DENSE_RUNG}_matrixfree": slice30[DENSE_RUNG]["matrixfree"]["launches"][
                f"{kind}_near_{f}"],
            **{k: main["near"][f][k] for k in ("max_abs_err", "ms", "ms_on_card", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms")},
            "build_ms": main["near"]["rows"]["build_ms"], "stored_nbytes": main["near"]["rows"]["stored_nbytes"],
            "shape_of_these_times": f"g_z float32 blend, 4096 x 262144: the {run} main path's operator, "
                                    f"{main['near'][f]['near_pairs']:,} near pairs; ms one call a pair of events "
                                    "(the wrapper's host time in, as every kernel's ms), ms_on_card the card alone "
                                    "(a CUDA graph of calls), plain_ms the plain product over the stored rows",
            "measured": {**{k: v["near"][f] for k, v in measured.items() if "near" in v}, **capacity_near(kind, f)},
        }
        for kind, source, replaces, launches, run, main, measured in (
            ("prism", "tomofastx_tpu_torch/csrc/prism_matvec_f32.cu (+ prism_matvec.cuh)",
             "tomofastx_tpu/ops/matrixfree.py:84 _corr_rows_for_point (no Pallas kernel: the near cells' correction "
             "on the candidates of :110 near_cell_indices, inside XLA's fusion of the per-cell products)",
             mf["generic"]["run"]["launches"], "per-cell", b2_main, mf["generic"]["b2"]),
            ("lattice", "tomofastx_tpu_torch/csrc/lattice_matvec.cu",
             "tomofastx_tpu/ops/matrixfree.py:662 _corr_window (no Pallas kernel: the near cells' closed forms on "
             "each observation's window, inside XLA's fusion of the lattice products)",
             mf["lattice"]["runs"]["run"]["launches"], "lattice", b3_main, mf["lattice"]["b3"]))
        for f in ("matvec", "rmatvec")
    ] + [
        {
            "name": f"{kind}_near_build", "route": "cuda", "source": source,
            "wrapper": f"tomofastx_tpu_torch/ops/{kind}_matvec.py: {kind}_near_build (a mark kernel and "
                       f"{kind}_near_rows_kernel)",
            "replaces": replaces,
            "launches": launches[f"{kind}_near_build"],
            "launches_fused_run": fused["runs"][run]["launches"][f"{kind}_near_build"],
            f"launches_capacity_{CAPACITY_RUNG}": capacity["launches"][f"{kind}_near_build"],
            f"launches_capacity_{GENERIC_RUNG}": slice30[GENERIC_RUNG]["launches"][f"{kind}_near_build"],
            f"launches_capacity_{DENSE_RUNG}_matrixfree": slice30[DENSE_RUNG]["matrixfree"]["launches"][
                f"{kind}_near_build"],
            "max_abs_err": main["near"]["rows"]["max_abs_err"], "ms": main["near"]["rows"]["build_ms"],
            "plain_ms": main["near"]["rows"]["plain_build_ms"], "bound_ms": main["near"]["rows"]["bound_ms"],
            "bound_by": main["near"]["rows"]["bound_by"], "library_ms": None,
            "stored_nbytes": main["near"]["rows"]["stored_nbytes"],
            "shape_of_these_times": f"g_z float32 blend, 4096 x 262144: the {run} main path's operator, "
                                    f"{main['near']['rows']['pairs']:,} near pairs stored, once with the operator",
            "measured": {**{k: v["near"]["rows"] for k, v in measured.items() if "near" in v},
                         **capacity_near(kind, "rows")},
        }
        for kind, source, replaces, launches, run, main, measured in (
            ("prism", "tomofastx_tpu_torch/csrc/prism_matvec_f32.cu (+ prism_matvec.cuh)",
             "tomofastx_tpu/ops/matrixfree.py:84 _corr_rows_for_point (no Pallas kernel: the near cells' closed forms, "
             "which the JAX package evaluates inside every product's fusion)",
             mf["generic"]["run"]["launches"], "per-cell", b2_main, mf["generic"]["b2"]),
            ("lattice", "tomofastx_tpu_torch/csrc/lattice_matvec.cu",
             "tomofastx_tpu/ops/matrixfree.py:662 _corr_window (no Pallas kernel: the near cells' closed forms, which "
             "the JAX package evaluates inside every product's fusion)",
             mf["lattice"]["runs"]["run"]["launches"], "lattice", b3_main, mf["lattice"]["b3"]))
    ] + [
        {
            "name": name, "route": "cuda",
            "source": "tomofastx_tpu_torch/csrc/lattice_matvec.cu",
            "wrapper": f"tomofastx_tpu_torch/ops/lattice_matvec.py: {name}",
            "replaces": f"tomofastx_tpu/ops/matrixfree.py:{line} (no Pallas kernel: XLA's fusion of the corner-lattice "
                        "rows and their product, rows tomofastx_tpu/ops/matrixfree.py:394, tiered blend :646)",
            "launches": mf["lattice"]["runs"]["run"]["launches"][name],
            "launches_mesh1": mf["lattice"]["runs"]["mesh1"]["launches"][name],
            "launches_fused": fused["runs"]["lattice"]["launches_fused"][name],
            f"launches_capacity_{CAPACITY_RUNG}": capacity["launches"][name],
            f"launches_capacity_{DENSE_RUNG}_matrixfree": slice30[DENSE_RUNG]["matrixfree"]["launches"][name],
            f"matrixfree_s_per_iter_{DENSE_RUNG}": slice30[DENSE_RUNG]["matrixfree"]["matrixfree_s_per_iter"],
            **{k: b3_main[f][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "yardstick_torch_mv_f32_ms": mf["lattice"]["yardstick"][yard],
            "shape_of_these_times": "g_z float32 blend, 4096 x 262144: the lattice main path's operator",
            "measured": {**{k: v[f] for k, v in mf["lattice"]["b3"].items()},
                         f"capacity {CAPACITY_RUNG}": capacity["b3"][f]},
            "small_problems": b3_small,
            "registers": b3_main["registers"],
        }
        for name, f, line, yard in (("lattice_matvec", "matvec", 724, "torch_mv_f32_ms"),
                                    ("lattice_rmatvec", "rmatvec", 762, "torch_mv_f32_T_ms"))
    ] + [
        {
            "name": "graph_while", "route": "cuda",
            "source": "tomofastx_tpu_torch/csrc/graph_while.cu",
            "wrapper": "tomofastx_tpu_torch/ops/graph_while.py: while_graph_launch (one launch of a major's graph; its "
                       "kernel set_condition runs once after the head and once after each run of the LSQR body)",
            "replaces": "tomofastx_tpu/ops/lsqr.py:161 (no Pallas kernel: the lax.while_loop of LSQR inside the JAX "
                        "package's fused program, tomofastx_tpu/inversion/joint.py:421)",
            "launches": fused["runs"]["tiled"]["launches"]["graph_while"],
            "set_condition_launches": fused["runs"]["tiled"]["launches"]["graph_while"]
            + sum(fused["runs"]["tiled"]["lsqr_body_runs"]),
            "launches_fused_runs": {k: v["launches"]["graph_while"] for k, v in fused["runs"].items()},
            **{k: fused["while_node"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms")},
            "shape_of_these_times": "one WHILE iteration of a body of two small kernels and a one-byte copy, with "
                                    "set_condition (a launch of 1000 runs less one of none, over 1000); plain_ms: "
                                    "the same body's graph replayed from the host, which reads the flag each run",
            "measured": fused["while_node"],
        }
    ]
    print(json.dumps({
        "main_paths": {"tiled": report(tiled), "tiled_mesh1": report(tiled_mesh), "dense": report(dense),
                       "dense_mesh1": report(dense_mesh), "packed": report(packed),
                       "dense_mesh1_host_assembly": report(dense_host)},
        "mesh1_against_unmeshed": mesh_against_unmeshed, "solves_from_cache": {k: report(v) for k, v in solves.items()},
        "formats_against_tiled": spread, "small_problems_card_against_cpu": small_rel,
        "joint_main_paths": {k: report(v) for k, v in joint.items()}, "joint_dense_against_tiled": joint_spread,
        "ftg_main_path": report(ftg),
        "coupled_main_paths": {k: report(v) for k, v in coupled.items() if isinstance(v, dict) and "launches" in v},
        "coupled_dense_against_tiled": coupled_spread, "coupling_weights": weights, "coupling_scales": scales,
        "coupled_blocks_ms": coupled["blocks_ms"], "coupled_blocks_launches": coupled["blocks_launches"],
        "resume_profile_debug_nans": late, "matrixfree": jsonable(mf), "build_and_storage_variants": jsonable(variants),
        "fused": jsonable(fused), f"capacity_{CAPACITY_RUNG}": jsonable(capacity),
        **{f"capacity_{k}": jsonable(v) for k, v in slice30.items()},
        "operators": operators, "observations": NDATA, "cells": NX * NY * NZ,
        "kernel_build_s": build_s, "total_s": total_s,
        "memory_bytes_per_s_assumed": MEMORY_BYTES_PER_S, "fp32_flop_per_s_assumed": FP32_FLOP_PER_S,
    }))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
