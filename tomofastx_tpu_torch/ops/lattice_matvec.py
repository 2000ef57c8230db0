"""Kernel B3: the corner-lattice matrix-free operator's two products, the CUDA
kernels' wrappers, and the plain loop they stand for.

LatticeMatrixFreeKernel (ops/matrixfree.py) regenerates its rows in every
product. Before the row weights and after the column weight, its two products
are

    lattice_matvec(op, xw)   d[b, j] = sum_n sum_k R[b, n, k, j] xw[k, n]   (nrows_padded, ndc)
    lattice_rmatvec(op, u)   g[k, n] = sum_b sum_j R[b, n, k, j] u[b, j]    (nmc, N)

where R[b, n] is the response of lattice cell n at observation b: the
corner-difference closed forms (float64, or float32 without the blend), or
the float32 tiered blend (the 8-point rule, and on each observation's window
the 27-point rule or, near, the float64 closed forms). In the JAX package each
chunk of observations was one XLA fusion (tomofastx_tpu/ops/matrixfree.py:724
matvec, :762 rmatvec); PyTorch has no call for it. So on a CUDA tensor both
products launch the hand-written kernels of csrc/lattice_matvec.cu, which
evaluate every pair on the fly (the closed forms from corner potentials shared
by the cells of a tile) and store no row, or raise; a tensor that lies on the
CPU takes the plain version, the operator's chunk loop
(LatticeMatrixFreeKernel._partial_matvec and _partial_rmatvec), unchanged.
The kernels are bound by operations (the source says how); neither uses
atomics, so two runs agree to the last bit.

The blend's products are split: the main kernels give the near cells zero,
and the near pass (lattice_near_matvec, lattice_near_rmatvec) evaluates them
over the operator's near lists into one more slot of the main kernels'
float64 partial sums, launched first. Its plain versions are the operator's
_near_matvec and _near_rmatvec, and _split_matvec / _split_rmatvec are the
plain version of the whole split.

`launch_plan`, `tile_shape` and `obs_splits` are the launch's choices, in
Python so that the CPU tests hold them. The library is built with nvcc from
the .cu source and the header it includes, into ``build/`` beside the
package, the first time a CUDA tensor arrives.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tomofastx_tpu_torch.ops import _cuda_build

_NAME = "lattice_matvec"

THREADS = 128  # csrc/lattice_matvec.cu: threads a block
BATCH = 32  # observations a block stages at a time
# The grid (cell tiles x observation splits) aims at this many blocks: some
# 15 a streaming multiprocessor of an H100.
TARGET_BLOCKS = 2048

# csrc/prism_common.cuh's Family and Mode, and the (family, nmc, ndc) taken.
GZ, GZZ, FTG, MAG = 0, 1, 2, 3
CLOSED, BLEND = 0, 1
SHAPES = {(GZ, 1, 1), (GZZ, 1, 1), (FTG, 1, 6), (MAG, 1, 1), (MAG, 1, 3), (MAG, 3, 1), (MAG, 3, 3)}
MU0_T2NT = 4.0e-7 * math.pi * 1.0e9  # ops/prism.py combine_mag_tensor


def build_library() -> tuple[str, str]:
    """Compile csrc/lattice_matvec.cu (see _cuda_build.build_library)."""
    return _cuda_build.build_library(_NAME)


# One signature for both products' entry points: is_double, family, nmc,
# ndc, mode, the tile (tz, ty, tx); the three edges, three coordinates, the
# window starts, the input, the partial sums, the output; nx, ny, nz, nrows,
# the window (wz, wy, wx), splits, observations a split; the field's
# direction cosines and scale; the stream.
ARGTYPES = (ctypes.c_int,) * 8 + (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 9 + (ctypes.c_double,) * 4 + (
    ctypes.c_void_p,)
# And one for both near passes': family, nmc, ndc; the three edges, three
# coordinates, the list's offsets and entries, the input, the output; nx, ny,
# nz, nrows; the field; the stream.
NEAR_ARGTYPES = (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 4 + (ctypes.c_double,) * 4 + (
    ctypes.c_void_p,)


def _library():
    return _cuda_build.load_library(_NAME, ("lattice_matvec", "lattice_rmatvec"), ARGTYPES)


def _near_library():
    return _cuda_build.load_library(_NAME, ("lattice_near_matvec", "lattice_near_rmatvec"), NEAR_ARGTYPES)


def tile_shape(nmc: int, ndc: int) -> tuple[int, int, int]:
    """(tz, ty, tx) cells of a block's tile: 8 x 8 x 8, or 4 x 8 x 8 where a
    corner holds more than 6 values (csrc/lattice_matvec.cu tile_z: the
    corners of a tile in float64 stay within 48 KB of shared memory)."""
    return (4 if nmc * ndc > 6 else 8), 8, 8


def n_tiles(op) -> int:
    tz, ty, tx = tile_shape(op.nmc, op.ndc)
    return _cdiv(op.nz, tz) * _cdiv(op.ny, ty) * _cdiv(op.nx, tx)


def obs_splits(nrows: int, tiles: int) -> tuple[int, int]:
    """(splits, observations a split): enough splits of the observations that
    the grid of tiles x splits has about TARGET_BLOCKS blocks, each split a
    whole number of staged batches. A function of the shape alone, so the
    order of every sum is too."""
    want = max(1, min(_cdiv(nrows, BATCH), _cdiv(TARGET_BLOCKS, tiles)))
    per = _cdiv(_cdiv(nrows, want), BATCH) * BATCH
    return _cdiv(nrows, per), per


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def partial_shapes(op) -> tuple[tuple, tuple]:
    """Shapes of the float64 partial sums that one lattice_matvec and one
    lattice_rmatvec of `op` allocate on the card: a slot a cell tile (and one
    for the blend's near pass) of the padded rows, and a slot a split of the
    observations (and one) of the cells. They live for one product; the
    operator's nbytes does not count them."""
    nrows, tiles = op.xd.shape[0], n_tiles(op)
    splits, _ = obs_splits(nrows, tiles)
    blend = int(bool(op.far_quad))
    return (tiles + blend, nrows, op.ndc), (splits + blend, op.nmc, op.N)


def partial_bytes(op) -> tuple[int, int]:
    """Bytes of partial_shapes(op)."""
    return tuple(8 * math.prod(shape) for shape in partial_shapes(op))


def launch_plan(op) -> dict:
    """What the kernels are told about lattice operator `op`: its type,
    family and mode (the closed forms, or the float32 blend with its window),
    the tile, the field. Raises for what the kernels do not take: another
    type, rows of a shape no family has, a blend
    without its windows (or with windows not in int32) or its near lists
    (in int32)."""
    dtype = op.xd.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"lattice_matvec: operator of {dtype}; the kernels take float32 or float64")
    if op.problem == "magn":
        family = MAG
    elif op.data_type == 1:
        family = GZ
    else:
        family = GZZ if op.ndc == 1 else FTG
    if (family, op.nmc, op.ndc) not in SHAPES:
        raise ValueError(f"lattice_matvec: {op.problem} rows (data type {op.data_type}) of {op.nmc} model and "
                         f"{op.ndc} data components")
    mode = BLEND if op.far_quad else CLOSED
    if mode == BLEND:
        if dtype != torch.float32:
            raise ValueError("lattice_matvec: the blend is the float32 operator's")
        if op.win is None or op.wi0 is None or op.wi0.dtype != torch.int32:
            raise ValueError("lattice_matvec: a blended operator needs its windows (win, and wi0 in int32)")
        if any(a is None or a.dtype != torch.int32 for a in _near_lists(op)):
            raise ValueError("lattice_matvec: a blended operator needs its near lists (near_ptr, near_cells, "
                             "near_tptr, near_obs in int32)")
    scale = op.intensity if op.nmc == 1 else MU0_T2NT
    return {"is_double": int(dtype == torch.float64), "family": family, "nmc": op.nmc, "ndc": op.ndc,
            "mode": mode, "tile": tile_shape(op.nmc, op.ndc), "window": tuple(op.win) if mode == BLEND else (0, 0, 0),
            "magv": tuple(float(m) for m in op.magv), "s4pi": scale / (4.0 * math.pi)}


def _near_lists(op):
    return op.near_ptr, op.near_cells, op.near_tptr, op.near_obs


def _operands(op, v, shape, what):
    """The operator's tensors and v, checked for one launch."""
    geometry = (op.xe, op.ye, op.ze, op.xd, op.yd, op.zd)
    dtype = op.xd.dtype
    if tuple(v.shape) != shape:
        raise ValueError(f"{what} must be {shape}, got {tuple(v.shape)}")
    for a in geometry + (v,):
        if a.dtype != dtype:
            raise TypeError(f"lattice_matvec: tensors of {a.dtype} and {dtype}")
    for a in geometry + (v,) + ((op.wi0, *_near_lists(op)) if op.far_quad else ()):
        if a.device != v.device:
            raise ValueError(f"lattice_matvec: tensors on different devices: {a.device}, {v.device}")
        if not a.is_contiguous():
            raise ValueError("lattice_matvec: the operator's tensors and the vector must be contiguous")
    return geometry


def _call(entry, op, plan, geometry, vin, partial, out, splits, per, stream) -> int:
    """One call of the library's entry point; returns its CUDA error code."""
    fn = getattr(_library(), entry)
    wi0 = op.wi0.data_ptr() if plan["mode"] == BLEND else None
    return fn(plan["is_double"], plan["family"], plan["nmc"], plan["ndc"], plan["mode"], *plan["tile"],
              *(a.data_ptr() for a in geometry), wi0, vin.data_ptr(), partial.data_ptr(), out.data_ptr(),
              op.nx, op.ny, op.nz, op.xd.shape[0], *plan["window"], splits, per, *plan["magv"], plan["s4pi"], stream)


def _launch(entry, op, plan, geometry, vin, partial, out, splits, per):
    with torch.cuda.device(vin.device):
        err = _call(entry, op, plan, geometry, vin, partial, out, splits, per,
                    torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def _near_launch(entry, op, plan, lists, vin, out):
    """One launch of a near pass; raises on a CUDA error."""
    fn = getattr(_near_library(), entry)
    with torch.cuda.device(vin.device):
        err = fn(plan["family"], plan["nmc"], plan["ndc"],
                 *(a.data_ptr() for a in (op.xe, op.ye, op.ze, op.xd, op.yd, op.zd, *lists, vin, out)),
                 op.nx, op.ny, op.nz, op.xd.shape[0], *plan["magv"], plan["s4pi"],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def lattice_near_matvec(op, xw, out=None):
    """(nrows_padded, ndc) float64: the near cells' terms of blended
    LatticeMatrixFreeKernel `op` times xw ((nmc, N)), the first launch of
    lattice_matvec's split (into `out`, a slot of its partial sums, if
    given). CUDA tensors go through the near-pass kernel (a warp an
    observation over its candidates, each re-tested by the main loop's near
    test, the near ones' closed forms in float64 rounded to float32); CPU
    tensors through op._near_matvec. `lattice_near_matvec.launches` counts
    its launches."""
    if xw.device.type == "cpu":
        y = op._near_matvec(xw)
        return y if out is None else out.copy_(y)
    if xw.device.type != "cuda":
        raise ValueError(f"lattice_near_matvec runs on cuda or cpu tensors, got {xw.device}")
    plan = launch_plan(op)
    if plan["mode"] != BLEND:
        raise ValueError("lattice_near_matvec: the near pass is the float32 blend's")
    _operands(op, xw, (op.nmc, op.N), "xw")
    out = _cuda_build.float64_output((op.xd.shape[0], op.ndc), xw, out)
    _near_launch("lattice_near_matvec", op, plan, (op.near_ptr, op.near_cells), xw, out)
    lattice_near_matvec.launches += 1
    return out


def lattice_near_rmatvec(op, u, out=None):
    """(nmc, N) float64: the near cells' terms of blended
    LatticeMatrixFreeKernel `op` transposed times u ((nrows_padded, ndc)),
    the first launch of lattice_rmatvec's split (into `out` if given). CUDA
    tensors go through the near-pass kernel (a warp a cell over its
    candidate observations in order); CPU tensors through op._near_rmatvec.
    `lattice_near_rmatvec.launches` counts its launches."""
    if u.device.type == "cpu":
        g = op._near_rmatvec(u)
        return g if out is None else out.copy_(g)
    if u.device.type != "cuda":
        raise ValueError(f"lattice_near_rmatvec runs on cuda or cpu tensors, got {u.device}")
    plan = launch_plan(op)
    if plan["mode"] != BLEND:
        raise ValueError("lattice_near_rmatvec: the near pass is the float32 blend's")
    _operands(op, u, (op.xd.shape[0], op.ndc), "u")
    out = _cuda_build.float64_output((op.nmc, op.N), u, out)
    _near_launch("lattice_near_rmatvec", op, plan, (op.near_tptr, op.near_obs), u, out)
    lattice_near_rmatvec.launches += 1
    return out


def lattice_matvec(op, xw):
    """(nrows_padded, ndc) rows of LatticeMatrixFreeKernel `op` times xw
    ((nmc, N), the column weight applied), before the row weights. CUDA
    tensors go through the hand-written kernel pair (partial sums a cell
    tile, then their sum in tile order; the blend's near pass first, into
    the last slot), on PyTorch's current stream; CPU tensors through
    op._partial_matvec. `lattice_matvec.launches` counts the launches of
    the pair."""
    if xw.device.type == "cpu":
        return op._partial_matvec(xw)
    if xw.device.type != "cuda":
        raise ValueError(f"lattice_matvec runs on cuda or cpu tensors, got {xw.device}")
    plan = launch_plan(op)
    geometry = _operands(op, xw, (op.nmc, op.N), "xw")
    nrows = op.xd.shape[0]
    splits, per = obs_splits(nrows, n_tiles(op))
    partial = torch.empty(partial_shapes(op)[0], dtype=torch.float64, device=xw.device)
    out = torch.empty((nrows, op.ndc), dtype=xw.dtype, device=xw.device)
    if plan["mode"] == BLEND:
        lattice_near_matvec(op, xw, out=partial[-1])
    _launch("lattice_matvec", op, plan, geometry, xw, partial, out, splits, per)
    lattice_matvec.launches += 1
    return out


def lattice_rmatvec(op, u):
    """(nmc, N) rows of LatticeMatrixFreeKernel `op` transposed times u
    ((nrows_padded, ndc), the row weights applied), before the column
    weight. CUDA tensors go through the hand-written kernel pair (partial
    sums a split of the observations, then their sum in split order; the
    blend's near pass first, into the last split), on PyTorch's current
    stream; CPU tensors through op._partial_rmatvec.
    `lattice_rmatvec.launches` counts the launches of the pair."""
    if u.device.type == "cpu":
        return op._partial_rmatvec(u)
    if u.device.type != "cuda":
        raise ValueError(f"lattice_rmatvec runs on cuda or cpu tensors, got {u.device}")
    plan = launch_plan(op)
    geometry = _operands(op, u, (op.xd.shape[0], op.ndc), "u")
    splits, per = obs_splits(op.xd.shape[0], n_tiles(op))
    partial = torch.empty(partial_shapes(op)[1], dtype=torch.float64, device=u.device)
    out = torch.empty((op.nmc, op.N), dtype=u.dtype, device=u.device)
    if plan["mode"] == BLEND:
        lattice_near_rmatvec(op, u, out=partial[-1])
    _launch("lattice_rmatvec", op, plan, geometry, u, partial, out, splits, per)
    lattice_rmatvec.launches += 1
    return out


lattice_matvec.launches = 0
lattice_rmatvec.launches = 0
lattice_near_matvec.launches = 0
lattice_near_rmatvec.launches = 0
