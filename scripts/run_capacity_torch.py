#!/usr/bin/env python3
"""Capacity runs of the PyTorch/CUDA port on one card: the JAX package's
capacity ladder, rung by rung, through the port's own entry point.

    python3 scripts/run_capacity_torch.py --rung 4m           # -> CAPACITY_4M_TORCH.json
    python3 scripts/run_capacity_torch.py --rung 32m --out-dir output/capacity
    python3 scripts/run_capacity_torch.py --rung 4m --small --device cpu   # the small sizes
    python3 scripts/run_capacity_torch.py --rung bttb134m --save-model /tmp/host.npy
    python3 scripts/run_capacity_torch.py --rung bttb134m_fused --hold-to CAPACITY_BTTB134M_TORCH.json

Each rung writes the synthetic fixtures (grid, true model, survey) and the
Parfile of one JAX capacity script into a temporary directory (removed at the
end), key for key and byte for byte as that script writes them, and runs
tomofastx_tpu_torch.inversion.workflow.solve_problem_joint_gravmag on it with
the script's arguments:

    2m        scripts/run_2m_cell.py       160 x 160 x 80 cells, 2025 observations:
              bfloat16 kernel storage (kernel B1) with the exact-physics
              refinement forward, the mixed build (1024 cells in float64),
              the fused major loop in chunks of 5; 20 x 100
    4m .. 32m scripts/run_4m_matrixfree.py 200 x 200 x 100 to 400 x 400 x 200 cells,
              2025 observations: the corner-lattice operator's float32 blend
              (kernel B3 and its near pass); 3 x 20, 3 x 15, 3 x 12, 3 x 10
    1m, 1m_f64, 1m_f32quad
              scripts/run_million_cell.py under MC_BUILD = mixed, f64, f32quad:
              128 x 128 x 64 cells, 2025 observations, a dense float32
              kernel (8.49 GB) built mixed (1024 cells in float64), in
              float64 or compensated float32, and written to the sensitivity
              cache (17 GB on disk), the fused major loop in chunks of 10;
              30 x 100. Then that script's matrix-free section: the operator
              the factory picks on the same grid and survey (the lattice one,
              kernel B3), seconds an LSQR iteration of 3
    generic4m scripts/probe_generic_4m.py  200 x 200 x 100 cells, 2025 observations: x
              edges growing 2 % a cell and sheared 3 m a layer, heights
              jittered, so neither BTTB nor the lattice applies: the per-cell
              operator's float32 blend (kernel B2 and its near pass); 2 x 10
    joint1m   scripts/run_million_joint.py 128 x 128 x 64 cells, 1600 observations of
              gravity and TMI: the compensated float32 build stored
              bfloat16, cross-gradient, 2-lithology ADMM and damping, fused
              in chunks of 5; 15 x 60
    bttb134m  scripts/run_bttb_giant.py    512 x 512 x 512 cells, 256 x 256 observations
              on the cell lattice at stride 2: BTTBKernel (torch.fft), the
              host-driven loop; 5 x 20
    bttb134m_fused
              scripts/run_bttb_giant.py under BG_FUSED = 1: the same, the
              fused major loop in one chunk of all 5 majors

--small takes the sizes those scripts take under MC_SMALL, MJ_SMALL, GP_SMALL
or BG_SMALL. A run writes CAPACITY_<RUNG>_TORCH.json (with --small,
CAPACITY_<RUNG>_SMALL_TORCH.json) into --out-dir (the repository's root by
default): the sizes, the operator the log names, the wall and setup seconds,
peak device memory, host peak RSS, the cost history, the truth correlation,
and the card's name and power limit; the 1m rungs add the build, the cache's
seconds and bytes and the matrix-free section, generic4m the near lists and
the partial sums of a product. --save-model PATH writes the final models to
PATH (numpy, one row a problem) and names it in the record; --hold-to RECORD
holds this run's final costs and models to those of another run of the same
fixture that saved its models (the record it wrote), at the formats'
tolerance (FORMATS_TOL), and writes the comparison into the record. It exits
non-zero when the data cost of an active problem does not fall from the
first major to the last or a held run is outside that tolerance, and 3
(before writing anything) when the temporary directory, under TMPDIR, has no
room for the rung's sensitivity cache.

Imports torch and numpy, and the port; nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

H = (100.0, 100.0, 50.0)  # cell size of every rung (m)


@dataclass(frozen=True)
class Rung:
    """One rung: the JAX script it ports, its kind, and its sizes at full
    width and under the script's small switch: ((nx, ny, nz), observations a
    side, (majors, minors)); for the dense kind, the script's MC_BUILD; fused,
    the fused major loop in one chunk of all the majors, where the script
    takes it by a switch (BG_FUSED)."""

    source: str
    kind: str  # "bf16", "matrixfree", "joint", "bttb", "dense" or "generic"
    full: tuple
    small: tuple
    build: str = ""
    fused: bool = False


RUNGS = {
    "2m": Rung("scripts/run_2m_cell.py", "bf16", ((160, 160, 80), 45, (20, 100)), ((40, 40, 20), 20, (4, 20))),
    "4m": Rung("scripts/run_4m_matrixfree.py", "matrixfree", ((200, 200, 100), 45, (3, 20)),
               ((40, 40, 20), 20, (2, 10))),
    "8m": Rung("scripts/run_4m_matrixfree.py", "matrixfree", ((256, 250, 128), 45, (3, 15)),
               ((40, 40, 20), 20, (2, 10))),
    "16m": Rung("scripts/run_4m_matrixfree.py", "matrixfree", ((320, 320, 160), 45, (3, 12)),
                ((40, 40, 20), 20, (2, 10))),
    "32m": Rung("scripts/run_4m_matrixfree.py", "matrixfree", ((400, 400, 200), 45, (3, 10)),
                ((40, 40, 20), 20, (2, 10))),
    **{rung: Rung("scripts/run_million_cell.py", "dense", ((128, 128, 64), 45, (30, 100)),
                  ((32, 32, 16), 20, (5, 20)), build)
       for rung, build in (("1m", "mixed"), ("1m_f64", "f64"), ("1m_f32quad", "f32quad"))},
    "generic4m": Rung("scripts/probe_generic_4m.py", "generic", ((200, 200, 100), 45, (2, 10)),
                      ((40, 40, 20), 20, (2, 10))),
    "joint1m": Rung("scripts/run_million_joint.py", "joint", ((128, 128, 64), 40, (15, 60)),
                    ((32, 32, 16), 20, (4, 20))),
    **{rung: Rung("scripts/run_bttb_giant.py", "bttb", ((512, 512, 512), 256, (5, 20)), ((64, 64, 32), 32, (2, 10)),
                  fused=fused)
       for rung, fused in (("bttb134m", False), ("bttb134m_fused", True))},
}
BTTB_STRIDE = 2  # the BTTB survey's spacing in cells
# scripts/run_million_cell.py's builds by MC_BUILD: the name its record gives
# the build, near_field_f64 and the build's compute dtype.
MC_BUILDS = {
    "mixed": ("mixed_f32_k1024_farquad", 1024, torch.float64),
    "f64": ("full_f64_lattice", 0, torch.float64),
    "f32quad": ("compensated_f32_quad", 0, torch.float32),
}
# The formats' tolerance of a run held to another of its fixture (--hold-to):
# each final model within 2e-3 of its range, each final data cost within 25 %.
FORMATS_TOL = {"model_of_range": 2e-3, "cost": 0.25}
# What GENERIC_4M_PROBE.json ran, beside the port's generic4m run.
GENERIC_JAX_RECORD = ("GENERIC_4M_PROBE.json is a TPU run of the JAX package, whose factory gates the per-cell "
                      "float32 blend off above 2M cells off the CPU (tomofastx_tpu/ops/matrixfree.py:39); the port "
                      "blends at every size, so that record's cost is no yardstick for this one")


@dataclass
class Fixture:
    """What a rung's writer leaves: the Parfile lines, the true models (one a
    problem), the solver's keyword arguments and the sizes."""

    rung: str
    work: str
    lines: list
    truth: list
    solve_kw: dict
    size: tuple
    ndata: int
    depth: tuple
    fixtures_s: float
    masks: dict = field(default_factory=dict)

    @property
    def ncells(self) -> int:
        return int(np.prod(self.size))


def write_grid_file(path, nx, ny, nz, hx, hy, hz):
    """The model grid file of an nx x ny x nz lattice of cells hx x hy x hz
    (9 columns, i fastest); returns the cells' (i, j, k)."""
    from tomofastx_tpu_torch.io.tableio import save_table

    i = np.tile(np.arange(nx), ny * nz)
    j = np.tile(np.repeat(np.arange(ny), nx), nz)
    k = np.repeat(np.arange(nz), nx * ny)
    cols = np.column_stack([
        i * hx, (i + 1) * hx, j * hy, (j + 1) * hy, k * hz, (k + 1) * hz, i + 1, j + 1, k + 1,
    ])
    save_table(path, cols, fmt="%.1f %.1f %.1f %.1f %.1f %.1f %d %d %d", header=f"{nx * ny * nz}")
    return i, j, k


def write_survey(path, xs, ys):
    """Observations on the x-y lattice xs x ys, 0.1 m above the grid's top."""
    from tomofastx_tpu_torch.io.tableio import save_table

    X, Y = np.meshgrid(xs, ys, indexing="ij")
    nd = X.size
    save_table(path, np.column_stack([X.ravel(), Y.ravel(), np.full(nd, -0.1), np.zeros(nd)]),
               fmt="%.2f %.2f %.2f %.1f", header=f"{nd}")


def _box(i, j, k, x0, xn, y0, yn, z0, zn):
    return (i >= x0) & (i < x0 + xn) & (j >= y0) & (j < y0 + yn) & (k >= z0) & (k < z0 + zn)


def _bodies(i, j, k, nx, ny, nz):
    """The two buried prisms of the 2M-cell and joint fixtures."""
    return (_box(i, j, k, nx // 4, nx // 8, ny // 4, ny // 8, nz // 4, nz // 4),
            _box(i, j, k, 5 * nx // 8, nx // 8, ny // 2, ny // 8, nz // 8, nz // 4))


def _gravity_lines(work, nx, ny, nz, nd, majors, minors):
    """The Parfile lines every gravity rung shares."""
    return [
        f"global.outputFolderPath = {work}/out/\n",
        f"modelGrid.size = {nx} {ny} {nz}\n",
        f"modelGrid.grav.file = {work}/grid.txt\n",
        f"forward.data.grav.nData = {nd}\n",
        f"forward.data.grav.dataGridFile = {work}/data.txt\n",
        "forward.data.grav.useSyntheticModelForDataValues = 1\n",
        f"forward.data.grav.syntheticModelFile = {work}/true_model.txt\n",
        "forward.depthWeighting.type = 1\n",
        "forward.depthWeighting.grav.power = 2.0\n",
        "forward.depthWeighting.grav.Z0 = 0.1\n",
        f"inversion.nMajorIterations = {majors}\n",
        f"inversion.nMinorIterations = {minors}\n",
        "inversion.minResidual = 1e-13\n",
        "inversion.modelDamping.grav.weight = 1e-11\n",
    ]


def _centred_survey(work, nx, ny, nside):
    xs = (np.arange(nside) + 0.5) * (nx * H[0] / nside)
    ys = (np.arange(nside) + 0.5) * (ny * H[1] / nside)
    write_survey(f"{work}/data.txt", xs, ys)


def _two_prisms(work, size, nside, depth):
    """The grid, the two prisms (+500, -300) and the centred survey of
    scripts/run_2m_cell.py and run_million_cell.py; (the gravity Parfile
    lines, the true model)."""
    from tomofastx_tpu_torch.io.tableio import save_table

    nx, ny, nz = size
    i, j, k = write_grid_file(f"{work}/grid.txt", nx, ny, nz, *H)
    body1, body2 = _bodies(i, j, k, nx, ny, nz)
    val = np.zeros(nx * ny * nz)
    val[body1] = 500.0
    val[body2] = -300.0
    save_table(f"{work}/true_model.txt", val[:, None], fmt="%.2f", header=f"{val.size}")
    _centred_survey(work, nx, ny, nside)
    return _gravity_lines(work, nx, ny, nz, nside * nside, *depth), val


def _write_bf16(work, size, nside, depth):
    """scripts/run_2m_cell.py: two prisms, bfloat16 storage, refinement."""
    lines, val = _two_prisms(work, size, nside, depth)
    lines += [
        "tpu.kernelStoreDtype = bfloat16\n",
        "tpu.refineForward = 1\n",
        "tpu.sensitWriteCache = 0\n",
    ]
    return lines, [val], {"fused_chunk": 5, "near_field_f64": 1024}, {}


def _write_dense(work, size, nside, depth, build):
    """scripts/run_million_cell.py under MC_BUILD = build: two prisms, the
    dense float32 kernel written to the sensitivity cache (the default of
    tpu.sensitWriteCache), the fused loop in chunks of 10."""
    lines, val = _two_prisms(work, size, nside, depth)
    _, near_field, compute_dtype = MC_BUILDS[build]
    return lines, [val], {"fused_chunk": 10, "near_field_f64": near_field, "compute_dtype": compute_dtype}, {}


def _write_generic(work, size, nside, depth):
    """scripts/probe_generic_4m.py: x edges growing 2 % a cell and each
    layer's shifted by 3 m a layer (no tensor-product lattice), one prism,
    observation heights jittered (no BTTB), the float32 blend."""
    from tomofastx_tpu_torch.io.tableio import save_table

    nx, ny, nz = size
    hx, hy, hz = H
    nd = nside * nside
    xe = np.concatenate([[0.0], np.cumsum(hx * 1.02 ** np.arange(nx))])
    ye = np.arange(ny + 1) * hy
    ze = np.arange(nz + 1) * hz
    i = np.tile(np.arange(nx), ny * nz)
    j = np.tile(np.repeat(np.arange(ny), nx), nz)
    k = np.repeat(np.arange(nz), nx * ny)
    shear = 3.0 * k
    cols = np.column_stack([xe[i] + shear, xe[i + 1] + shear, ye[j], ye[j + 1], ze[k], ze[k + 1], i + 1, j + 1, k + 1])
    save_table(f"{work}/grid.txt", cols, fmt="%.3f %.3f %.1f %.1f %.1f %.1f %d %d %d", header=f"{i.size}")
    del cols
    val = np.zeros(i.size)
    val[_bodies(i, j, k, nx, ny, nz)[0]] = 500.0
    save_table(f"{work}/true_model.txt", val[:, None], fmt="%.2f", header=f"{val.size}")
    xs = (np.arange(nside) + 0.5) * (xe[-1] / nside)
    ys = (np.arange(nside) + 0.5) * (ny * hy / nside)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    zs = -0.1 - 0.05 * np.random.default_rng(11).uniform(size=nd)
    save_table(f"{work}/data.txt", np.column_stack([X.ravel(), Y.ravel(), zs, np.zeros(nd)]),
               fmt="%.3f %.3f %.4f %.1f", header=f"{nd}")
    lines = _gravity_lines(work, nx, ny, nz, nd, *depth) + [
        "tpu.kernelFormat = matrixfree\n",
        "tpu.farFieldQuad = 1\n",
    ]
    return lines, [val], {}, {}


def _write_matrixfree(work, size, nside, depth):
    """scripts/run_4m_matrixfree.py: one prism, the float32 blend."""
    from tomofastx_tpu_torch.io.tableio import save_table

    nx, ny, nz = size
    i, j, k = write_grid_file(f"{work}/grid.txt", nx, ny, nz, *H)
    val = np.zeros(nx * ny * nz)
    val[_bodies(i, j, k, nx, ny, nz)[0]] = 500.0
    save_table(f"{work}/true_model.txt", val[:, None], fmt="%.2f", header=f"{val.size}")
    _centred_survey(work, nx, ny, nside)
    lines = _gravity_lines(work, nx, ny, nz, nside * nside, *depth) + [
        "tpu.kernelFormat = matrixfree\n",
        "tpu.farFieldQuad = 1\n",
    ]
    return lines, [val], {}, {}


def _write_joint(work, size, nside, depth):
    """scripts/run_million_joint.py: density in both prisms, susceptibility in
    the first only; cross-gradient, ADMM, bfloat16 storage."""
    from tomofastx_tpu_torch.io.tableio import save_table

    nx, ny, nz = size
    majors, minors = depth
    nd = nside * nside
    i, j, k = write_grid_file(f"{work}/grid.txt", nx, ny, nz, *H)
    body_a, body_b = _bodies(i, j, k, nx, ny, nz)
    rho = np.zeros(nx * ny * nz)
    rho[body_a] = 400.0
    rho[body_b] = -300.0
    chi = np.zeros(nx * ny * nz)
    chi[body_a] = 0.05
    save_table(f"{work}/true_rho.txt", rho[:, None], fmt="%.2f", header=f"{rho.size}")
    save_table(f"{work}/true_chi.txt", chi[:, None], fmt="%.5f", header=f"{chi.size}")
    _centred_survey(work, nx, ny, nside)
    lines = [
        f"global.outputFolderPath = {work}/out/\n",
        f"modelGrid.size = {nx} {ny} {nz}\n",
        f"modelGrid.grav.file = {work}/grid.txt\n",
        f"modelGrid.magn.file = {work}/grid.txt\n",
        f"forward.data.grav.nData = {nd}\n",
        f"forward.data.grav.dataGridFile = {work}/data.txt\n",
        f"forward.data.magn.nData = {nd}\n",
        f"forward.data.magn.dataGridFile = {work}/data.txt\n",
        "forward.data.grav.useSyntheticModelForDataValues = 1\n",
        f"forward.data.grav.syntheticModelFile = {work}/true_rho.txt\n",
        "forward.data.magn.useSyntheticModelForDataValues = 1\n",
        f"forward.data.magn.syntheticModelFile = {work}/true_chi.txt\n",
        "forward.magneticField.inclination = 75.0\n",
        "forward.magneticField.declination = 10.0\n",
        "forward.magneticField.intensity_nT = 50000.0\n",
        "forward.depthWeighting.type = 1\n",
        "forward.depthWeighting.grav.power = 2.0\n",
        "forward.depthWeighting.grav.Z0 = 0.1\n",
        "forward.depthWeighting.magn.power = 3.0\n",
        "forward.depthWeighting.magn.Z0 = 0.1\n",
        f"inversion.nMajorIterations = {majors}\n",
        f"inversion.nMinorIterations = {minors}\n",
        "inversion.minResidual = 1e-13\n",
        "inversion.joint.grav.problemWeight = 1.0\n",
        "inversion.joint.magn.problemWeight = 1e-8\n",
        "inversion.modelDamping.grav.weight = 1e-11\n",
        "inversion.modelDamping.magn.weight = 1e-11\n",
        "inversion.crossGradient.weight = 0.01\n",
        "inversion.crossGradient.derivativeType = 1\n",
        "inversion.admm.enableADMM = 1\n",
        "inversion.admm.nLithologies = 2\n",
        "inversion.admm.grav.bounds = -350. -250. -1. 450.\n",
        "inversion.admm.grav.weight = 1e-7\n",
        "inversion.admm.magn.bounds = -0.001 0.001 0.04 0.06\n",
        "inversion.admm.magn.weight = 1e-7\n",
        "tpu.kernelStoreDtype = bfloat16\n",
        "tpu.sensitWriteCache = 0\n",
    ]
    return lines, [rho, chi], {"fused_chunk": 5, "compute_dtype": torch.float32}, {"shared": body_a,
                                                                                   "grav_only": body_b}


def _write_bttb(work, size, nside, depth, fused=False):
    """scripts/run_bttb_giant.py: one shallow prism, the survey on the cell
    lattice at a stride of BTTB_STRIDE cells; fused, all the majors in one
    fused chunk (BG_FUSED = 1)."""
    from tomofastx_tpu_torch.io.tableio import save_table

    nx, ny, nz = size
    i, j, k = write_grid_file(f"{work}/grid.txt", nx, ny, nz, *H)
    val = np.zeros(nx * ny * nz)
    val[_box(i, j, k, nx // 4, nx // 8, ny // 4, ny // 8, nz // 8, nz // 8)] = 500.0
    del i, j, k
    save_table(f"{work}/true_model.txt", val[:, None], fmt="%.2f", header=f"{val.size}")
    xs = 0.5 * H[0] + np.arange(nside) * BTTB_STRIDE * H[0]
    ys = 0.5 * H[1] + np.arange(nside) * BTTB_STRIDE * H[1]
    write_survey(f"{work}/data.txt", xs, ys)
    lines = _gravity_lines(work, nx, ny, nz, nside * nside, *depth) + ["tpu.kernelFormat = matrixfree\n"]
    return lines, [val], {"fused_chunk": depth[0]} if fused else {}, {}


WRITERS = {"bf16": _write_bf16, "matrixfree": _write_matrixfree, "joint": _write_joint, "bttb": _write_bttb,
           "dense": _write_dense, "generic": _write_generic}


def write_fixture(rung: str, work: str, small: bool = False, depth=None) -> Fixture:
    """Write rung `rung`'s fixtures and return its Parfile lines and the
    rest; depth (majors, minors) in place of the rung's own, if given."""
    spec = RUNGS[rung]
    size, nside, own_depth = spec.small if small else spec.full
    depth = tuple(depth or own_depth)
    os.makedirs(work, exist_ok=True)
    t0 = time.time()
    lines, truth, solve_kw, masks = WRITERS[spec.kind](work, size, nside, depth, *([spec.build] if spec.build else []),
                                                       **({"fused": True} if spec.fused else {}))
    return Fixture(rung, work, lines, truth, solve_kw, size, nside * nside, depth, time.time() - t0, masks)


class _Tee(io.TextIOBase):
    """Writes through to a stream and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.kept = stream, io.StringIO()

    def write(self, s):
        self.kept.write(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


def solve(fx: Fixture, device="cuda", solve_dtype=torch.float32, verbose=True):
    """solve_problem_joint_gravmag on the fixture's Parfile on `device`, as
    the JAX script calls its own; returns (the WorkflowResult, the log, the
    wall seconds, the peak device memory in bytes or None on the CPU)."""
    from tomofastx_tpu_torch.config.parfile import parse_parfile_lines
    from tomofastx_tpu_torch.inversion.workflow import solve_problem_joint_gravmag

    cfg = parse_parfile_lines(fx.lines)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    tee = _Tee(sys.stdout if verbose else io.StringIO())
    t0 = time.time()
    with contextlib.redirect_stdout(tee):
        res = solve_problem_joint_gravmag(cfg, base_dir=fx.work, verbose=True, device=device,
                                          solve_dtype=solve_dtype, **fx.solve_kw)
    if cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else None
    return res, tee.kept.getvalue(), wall, peak


def sensit_cache_bytes(rung: str, small: bool = False) -> int:
    """Bytes of the sensitivity cache that the rung's run writes
    (io/sensit_cache.py, uncompressed: a 20-byte head, a row a record of a
    16-byte head and an int32 column and a float32 value a cell, then the
    nnz and weight files; the meta text file not counted): the dense kind's,
    0 for the others, which write none."""
    spec = RUNGS[rung]
    if spec.kind != "dense":
        return 0
    size, nside, _ = spec.small if small else spec.full
    ncells = int(np.prod(size))
    return 20 + nside * nside * (16 + 8 * ncells) + (4 + 4 * ncells) + (4 + 8 * ncells)


def matrixfree_per_iteration(fx: Fixture, device="cuda", niter=3) -> dict:
    """The second section of scripts/run_million_cell.py: the matrix-free
    operator on the rung's grid and survey (float32, not validated), LSQR of
    `niter` iterations on a seeded right-hand side, once to warm up and once
    timed between synchronisations; seconds an iteration, the operator's
    class and what computes its products; then each product's seconds (the
    second of two calls)."""
    from tomofastx_tpu_torch.config.parfile import parse_parfile_lines
    from tomofastx_tpu_torch.io import data_io, model_io
    from tomofastx_tpu_torch.ops import sensitivity as sens
    from tomofastx_tpu_torch.ops.lsqr import lsqr_solve
    from tomofastx_tpu_torch.ops.matrixfree import make_matrixfree_kernel

    cuda = torch.device(device).type == "cuda"
    par = parse_parfile_lines(fx.lines).grav
    grid = model_io.read_model_grid(f"{fx.work}/grid.txt", *fx.size)
    data = data_io.read_data_points(f"{fx.work}/data.txt", fx.ndata, 1, grid_only=True)
    cw = sens.calculate_depth_weight(par, grid, data, torch.float32, device)
    op = make_matrixfree_kernel(par, grid, data, cw, 1.0, data.weight, torch.float32, validate=False, device=device)
    b = torch.as_tensor(np.random.default_rng(0).normal(size=fx.ndata).astype(np.float32), device=device)

    def run():
        return lsqr_solve(op.matvec, op.rmatvec, b, op.ncols, niter=niter, rmin=0.0)

    def timed(fn):
        t0 = time.time()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        return out, time.time() - t0

    run()
    r, seconds = timed(run)
    out = {"matrixfree_s_per_iter": seconds / int(r.iters), "matrixfree_lsqr_iters": int(r.iters),
           "matrixfree_operator": type(op).__name__, "matrixfree_products_by": getattr(op, "products_by", None)}
    # Each product alone, once warm: what an iteration spends beside them.
    for name, fn, v in (("matvec", op.matvec, r.x), ("rmatvec", op.rmatvec, b)):
        fn(v)
        out[f"matrixfree_{name}_s"] = timed(lambda: fn(v))[1]
    return out


def nvidia_smi_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def record(fx: Fixture, res, log: str, wall: float, peak, device) -> dict:
    """The rung's record: sizes, the operator the log names, seconds, memory,
    costs and the truth correlation."""
    problems = ("grav", "magn")[: len(fx.truth)]
    setup = [float(v) for v in re.findall(r"forward phase done at t\+([0-9.]+)s", log)]
    out = {
        "rung": fx.rung, "jax_source": RUNGS[fx.rung].source, "ncells": fx.ncells, "ndata": fx.ndata,
        "majors": fx.depth[0], "minors": fx.depth[1],
        "operator": [ln.strip() for ln in re.findall(r"^ *\w+ kernel: .*$", log, re.M)],
        "refinement_forward": [ln.strip() for ln in re.findall(r"^ *\w+ refinement forward: .*$", log, re.M)],
        "loop": re.findall(r"^fused major loop: .*$", log, re.M) or ["host-driven"],
        "wall_s": wall,
        "fixtures_s": fx.fixtures_s,
        # The workflow's forward phase: reading the inputs, the depth weight,
        # the kernel build or the matrix-free operator (its near lists and
        # probe product included).
        "forward_phase_s": setup[0] if setup else None,
        "build_s": fx.fixtures_s + (setup[0] if setup else 0.0),
        "timings": {k: v for k, v in res.timings.items() if isinstance(v, (int, float, list))},
        "peak_device_bytes": peak,
        "host_peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        "device": str(device),
    }
    for i, p in enumerate(problems):
        m = np.asarray(res.models[i].val).ravel()
        out[f"cost_history_{p}"] = [float(h["cost_data"][i]) for h in res.costs_history]
        out[f"final_cost_{p}"] = float(res.cost_data[i])
        out[f"truth_correlation_{p}"] = float(np.corrcoef(m, fx.truth[i])[0, 1])
    if "shared" in fx.masks:
        chi = np.asarray(res.models[1].val).ravel()
        out["chi_in_shared_body"] = float(np.mean(np.abs(chi[fx.masks["shared"]])))
        out["chi_in_grav_only_body"] = float(np.mean(np.abs(chi[fx.masks["grav_only"]])))
    spec = RUNGS[fx.rung]
    if spec.kind == "dense":
        sensit = os.path.join(fx.work, "out", "SENSIT")
        cached = os.listdir(sensit) if os.path.isdir(sensit) else []  # none under tpu.sensitWriteCache = 0
        out.update(build=MC_BUILDS[spec.build][0], cache_write_s=res.timings.get("cache_write_s"),
                   cache_bytes=sum(os.path.getsize(os.path.join(sensit, f)) for f in cached))
    if spec.kind == "generic":
        # The operator's log line: its near lists (float32 blend only) and,
        # on the card, its partial sums (to 0.1 MB, as the log gives them).
        near = re.search(r"near lists K = (\d+), ([\d,]+) candidate pairs", log)
        partial = re.search(r"([0-9.]+) MB of float64 partial sums a product", log)
        out.update(far_field_blend=near is not None,
                   near_lists={"K": int(near[1]), "candidate_pairs": int(near[2].replace(",", ""))} if near else None,
                   partial_nbytes=round(float(partial[1]) * 1e6) if partial else None,
                   jax_record=GENERIC_JAX_RECORD)
    out["cost_falls"] = all(out[f"cost_history_{p}"][-1] < out[f"cost_history_{p}"][0] for p in problems)
    if torch.device(device).type == "cuda":
        out["card"] = nvidia_smi_line()
        out["card_name"] = torch.cuda.get_device_name(0)
    return out


def final_models(fx: Fixture, res) -> np.ndarray:
    """The run's final models, one row a problem."""
    return np.stack([np.asarray(res.models[i].val).ravel() for i in range(len(fx.truth))])


def held_to(rec: dict, models: np.ndarray, other_path: str) -> dict:
    """This run's final data costs and models (rec, models) against another
    run's of the same fixture, read from the record it wrote (other_path)
    and the models it saved (--save-model): each model's largest difference
    over its range and each cost's relative difference, beside
    FORMATS_TOL; `within` says whether both runs solved the same sizes and
    every difference is inside it. Keeps the other run's seconds, peaks,
    costs and loop beside them."""
    with open(other_path) as f:
        other = json.load(f)
    theirs = np.load(other["saved_model"])
    sizes = ("ncells", "ndata", "majors", "minors")
    out = {"record": other_path, "rung": other["rung"], "loop": other["loop"], "tolerance": FORMATS_TOL,
           "same_sizes": all(rec[k] == other[k] for k in sizes) and theirs.shape == models.shape,
           **{k: other.get(k) for k in ("wall_s", "peak_device_bytes", "host_peak_rss_bytes", "card")},
           "solve_s": other["timings"].get("solve_s")}
    within = out["same_sizes"]
    for i, p in enumerate(("grav", "magn")[: models.shape[0]]):
        if not out["same_sizes"]:
            break
        a, b = theirs[i], models[i]
        apart = float(np.abs(b - a).max() / (a.max() - a.min()))
        cost = abs(rec[f"final_cost_{p}"] - other[f"final_cost_{p}"]) / other[f"final_cost_{p}"]
        out.update({f"model_apart_of_range_{p}": apart, f"cost_apart_{p}": cost,
                    f"final_cost_{p}": other[f"final_cost_{p}"], f"cost_history_{p}": other[f"cost_history_{p}"],
                    f"truth_correlation_{p}": other[f"truth_correlation_{p}"]})
        within = within and apart <= FORMATS_TOL["model_of_range"] and cost <= FORMATS_TOL["cost"]
    out["within"] = bool(within)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rung", required=True, choices=list(RUNGS))
    parser.add_argument("--small", action="store_true", help="the JAX script's small sizes")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("--out-dir", default=REPO, help="where the record is written (default: the repository)")
    parser.add_argument("--save-model", metavar="PATH", help="write the final models to PATH (numpy)")
    parser.add_argument("--hold-to", metavar="RECORD", help="hold the final costs and models to those of the run that "
                        "wrote RECORD with --save-model, on the same fixture")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("run_capacity_torch.py: no CUDA device (pass --device cpu for the CPU)", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix=f"capacity_{args.rung}_") as work:
        need, free = sensit_cache_bytes(args.rung, args.small), shutil.disk_usage(work).free
        if need > free:
            print(f"run_capacity_torch.py: the {args.rung} rung writes a sensitivity cache of {need:,} bytes into "
                  f"{work}, where {free:,} bytes are free (set TMPDIR to a larger disk)", file=sys.stderr)
            return 3
        fx = write_fixture(args.rung, work, small=args.small)
        print(f"fixtures of {args.rung} ({fx.ncells:,} cells, {fx.ndata:,} observations) written in "
              f"{fx.fixtures_s:.1f} s", flush=True)
        res, log, wall, peak = solve(fx, device=args.device)
        out = record(fx, res, log, wall, peak, args.device)
        out["work_dir_free_bytes"] = free
        if args.save_model or args.hold_to:
            models = final_models(fx, res)
            if args.save_model:
                np.save(args.save_model, models)
                out["saved_model"] = os.path.abspath(args.save_model)
            if args.hold_to:
                out["held_to"] = held_to(out, models, args.hold_to)
            del models
        if RUNGS[args.rung].kind == "dense":
            out.update(matrixfree_per_iteration(fx, args.device))
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"CAPACITY_{args.rung.upper()}{'_SMALL' if args.small else ''}_TORCH.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    if not out["cost_falls"]:
        print(f"FAILED {args.rung}: the data cost does not fall from the first major to the last", file=sys.stderr)
        return 1
    if "held_to" in out and not out["held_to"]["within"]:
        print(f"FAILED {args.rung}: the final costs or models are outside {FORMATS_TOL} of {args.hold_to}'s",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
