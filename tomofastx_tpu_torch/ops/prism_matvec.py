"""Kernel B2: the per-cell matrix-free operator's two products, the CUDA
kernels' wrappers, and the plain loop they stand for.

MatrixFreeKernel (ops/matrixfree.py) regenerates its rows in every product.
Before the row weights and after the column weight, its two products are

    prism_matvec(op, xw)   d[b, j] = sum_n sum_k R[b, n, k, j] xw[k, n]   (nrows_padded, ndc)
    prism_rmatvec(op, u)   g[k, n] = sum_b sum_j R[b, n, k, j] u[b, j]    (nmc, N)

where R[b, n] is the response of the operator's cell n at observation b
(ops/sensitivity.py::forward_rows; for the float32 operator the blend of the
near cells' float64 closed forms with the 27-point rule). In the JAX package
each chunk of observations was one XLA fusion (tomofastx_tpu/ops/
matrixfree.py:244 matvec, :283 rmatvec); PyTorch has no call for it. So on a
CUDA tensor both products launch the hand-written kernels of
csrc/prism_matvec.cuh, which evaluate every pair in registers and store no
row, or raise; a tensor that lies on the CPU takes the plain version, the
operator's chunk loop (MatrixFreeKernel._partial_matvec and
_partial_rmatvec), unchanged. The kernels are bound by operations (the
source says how); neither uses atomics, so two runs agree to the last bit.

The blend's products are split: the main kernels give the near pairs zero,
and the near pass (prism_near_matvec, prism_near_rmatvec) evaluates them over
the operator's near candidates, launched first: the matvec's into one more
split of the main kernels' float64 partial sums, the rmatvec's into the
float64 sums its main kernel starts from. Its plain versions are the
operator's _near_matvec and _near_rmatvec, and _split_matvec /
_split_rmatvec are the plain version of the whole split.

`launch_plan` and `matvec_splits` are the launch's choices, in Python so
that the CPU tests hold them. Two libraries are built with nvcc, one a type
(csrc/prism_matvec_f32.cu and prism_matvec_f64.cu, each with the headers it
includes), into ``build/`` beside the package, the first time a CUDA tensor
of that type arrives.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tomofastx_tpu_torch.ops import _cuda_build

# The sources, one a type: float32 (the blend, its near pass and the float
# closed forms) and float64 (the closed forms); built in parallel.
SOURCES = ("prism_matvec_f32", "prism_matvec_f64")

THREADS = 128  # csrc/prism_matvec.cuh: threads a block, cells or observations staged at a time
# The matvec's grid aims at this many blocks (observation tiles x cell
# splits): some 15 a streaming multiprocessor of an H100.
TARGET_BLOCKS = 2048

# csrc/prism_common.cuh's Family and Mode, and the (family, nmc, ndc) taken.
GZ, GZZ, FTG, MAG = 0, 1, 2, 3
CLOSED, BLEND = 0, 1
SHAPES = {(GZ, 1, 1), (GZZ, 1, 1), (FTG, 1, 6), (MAG, 1, 1), (MAG, 1, 3), (MAG, 3, 1), (MAG, 3, 3)}
MU0_T2NT = 4.0e-7 * math.pi * 1.0e9  # ops/prism.py combine_mag_tensor


def build_library(name: str) -> tuple[str, str]:
    """Compile csrc/<name>.cu, one of SOURCES (see _cuda_build.build_library)."""
    return _cuda_build.build_library(name)


# One signature for both products' entry points: is_double, family, nmc,
# ndc, mode, handle_inside; the six bounds, three coordinates, the input, the
# partial sums, the output; N, nrows, splits, cells a split; the field's
# direction cosines and scale; the stream.
ARGTYPES = (ctypes.c_int,) * 6 + (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 4 + (ctypes.c_double,) * 4 + (
    ctypes.c_void_p,)
# And one for both near passes': family, nmc, ndc, handle_inside; the six
# bounds, three coordinates, the candidates (near_idx, or the transposed
# offsets and observations), the input, the output; N, nrows, K, cell_lo;
# the field; the stream.
NEAR_ARGTYPES = (ctypes.c_int,) * 4 + (ctypes.c_void_p,) * 13 + (ctypes.c_int,) * 4 + (ctypes.c_double,) * 4 + (
    ctypes.c_void_p,)


def _library(is_double: int):
    return _cuda_build.load_library(SOURCES[is_double], ("prism_matvec", "prism_rmatvec"), ARGTYPES)


def _near_library():
    return _cuda_build.load_library(SOURCES[0], ("prism_near_matvec", "prism_near_rmatvec"), NEAR_ARGTYPES)


def launch_plan(op) -> dict:
    """What the kernels are told about operator `op`: its type, family and
    mode (the closed forms, or the float32 blend), the field. Raises for
    what the plain loop evaluates and the kernels do not."""
    phys = op.phys
    dtype = op.xd.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"prism_matvec: operator of {dtype}; the kernels take float32 or float64")
    if phys.problem == "magn":
        family = MAG
    elif phys.data_type == 1:
        family = GZ
    else:
        family = GZZ if phys.ndc == 1 else FTG
    if (family, phys.nmc, phys.ndc) not in SHAPES:
        raise ValueError(f"prism_matvec: {phys.problem} rows (data type {phys.data_type}) of {phys.nmc} model and "
                         f"{phys.ndc} data components")
    if phys.far_quad and any(a is None or a.dtype != torch.int32 for a in _near_lists(op)):
        raise ValueError("prism_matvec: a blended operator without its near candidates (near_idx, near_tptr and "
                         "near_obs in int32)")
    mode = BLEND if phys.far_quad else CLOSED
    if mode == BLEND and dtype != torch.float32:
        raise ValueError("prism_matvec: the blend is the float32 operator's")
    scale = phys.intensity if phys.nmc == 1 else MU0_T2NT
    return {"is_double": int(dtype == torch.float64), "family": family, "nmc": phys.nmc, "ndc": phys.ndc,
            "mode": mode, "handle_inside": int(bool(phys.handle_inside)), "magv": tuple(float(m) for m in phys.magv),
            "s4pi": scale / (4.0 * math.pi)}


def matvec_splits(nrows: int, N: int) -> tuple[int, int]:
    """(splits, cells a split) of the matvec's cells: enough splits that the
    grid of observation tiles x splits has about TARGET_BLOCKS blocks, each
    split a whole number of staged tiles of THREADS cells. A function of the
    shape alone, so the order of every sum is too."""
    want = max(1, min(_cdiv(N, THREADS), _cdiv(TARGET_BLOCKS, _cdiv(nrows, THREADS))))
    per = _cdiv(_cdiv(N, want), THREADS) * THREADS
    return _cdiv(N, per), per


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def partial_shapes(op) -> tuple[tuple, tuple]:
    """Shapes of the float64 partial sums that one prism_matvec and one
    prism_rmatvec of `op` allocate on the card: a slot a split of the cells
    (and one for the blend's near pass) of the padded rows, and the blend's
    near sums of the cells that the rmatvec starts from (none without the
    blend). They live for one product; the operator's nbytes does not count
    them."""
    nrows = op.xd.shape[0]
    splits, _ = matvec_splits(nrows, op.N)
    blend = int(bool(op.phys.far_quad))
    return (splits + blend, nrows, op.phys.ndc), (blend, op.phys.nmc, op.N)


def partial_bytes(op) -> tuple[int, int]:
    """Bytes of partial_shapes(op)."""
    return tuple(8 * math.prod(shape) for shape in partial_shapes(op))


def _near_lists(op):
    return op.near_idx, op.near_tptr, op.near_obs


def _operands(op, v, shape, what):
    """The operator's tensors and v, checked for one launch."""
    geometry = (*op.grid6, op.xd, op.yd, op.zd)
    dtype = op.xd.dtype
    if tuple(v.shape) != shape:
        raise ValueError(f"{what} must be {shape}, got {tuple(v.shape)}")
    for a in geometry + (v,):
        if a.dtype != dtype:
            raise TypeError(f"prism_matvec: tensors of {a.dtype} and {dtype}")
    for a in geometry + (v,) + (_near_lists(op) if op.phys.far_quad else ()):
        if a.device != v.device:
            raise ValueError(f"prism_matvec: tensors on different devices: {a.device}, {v.device}")
        if not a.is_contiguous():
            raise ValueError("prism_matvec: the operator's tensors and the vector must be contiguous")
    return geometry


def _launch(entry, op, plan, geometry, vin, partial, out, splits, per):
    N, nrows = op.N, op.xd.shape[0]
    fn = getattr(_library(plan["is_double"]), entry)
    with torch.cuda.device(vin.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(plan["is_double"], plan["family"], plan["nmc"], plan["ndc"], plan["mode"], plan["handle_inside"],
                 *(a.data_ptr() for a in geometry), vin.data_ptr(),
                 None if partial is None else partial.data_ptr(), out.data_ptr(), N, nrows, splits, per,
                 *plan["magv"], plan["s4pi"], stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def _near_launch(entry, op, plan, lists, vin, out):
    """One launch of a near pass; raises on a CUDA error."""
    fn = getattr(_near_library(), entry)
    idx, obs = lists
    with torch.cuda.device(vin.device):
        err = fn(plan["family"], plan["nmc"], plan["ndc"], plan["handle_inside"],
                 *(a.data_ptr() for a in (*op.grid6, op.xd, op.yd, op.zd, idx)),
                 None if obs is None else obs.data_ptr(), vin.data_ptr(), out.data_ptr(), op.N, op.xd.shape[0],
                 op.near_idx.shape[1], op.cell_lo, *plan["magv"], plan["s4pi"],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def _blend_plan(op, what):
    plan = launch_plan(op)
    if plan["mode"] != BLEND:
        raise ValueError(f"{what}: the near pass is the float32 blend's")
    return plan


def prism_near_matvec(op, xw, out=None):
    """(nrows_padded, ndc) float64: the near pairs' terms of blended
    MatrixFreeKernel `op` times xw ((nmc, N)), the first launch of
    prism_matvec's split (into `out`, a split of its partial sums, if
    given). CUDA tensors go through the near-pass kernel (a warp an
    observation over its near_idx candidates among the operator's cells,
    each re-tested by the main loop's is_far, the near ones' closed forms in
    float64 rounded to float32); CPU tensors through op._near_matvec.
    `prism_near_matvec.launches` counts its launches."""
    if xw.device.type == "cpu":
        y = op._near_matvec(xw)
        return y if out is None else out.copy_(y)
    if xw.device.type != "cuda":
        raise ValueError(f"prism_near_matvec runs on cuda or cpu tensors, got {xw.device}")
    plan = _blend_plan(op, "prism_near_matvec")
    _operands(op, xw, (op.phys.nmc, op.N), "xw")
    out = _cuda_build.float64_output((op.xd.shape[0], op.phys.ndc), xw, out)
    _near_launch("prism_near_matvec", op, plan, (op.near_idx, None), xw, out)
    prism_near_matvec.launches += 1
    return out


def prism_near_rmatvec(op, u):
    """(nmc, N) float64: the near pairs' terms of blended MatrixFreeKernel
    `op` transposed times u ((nrows_padded, ndc)), the sums prism_rmatvec's
    main kernel starts from. CUDA tensors go through the near-pass kernel (a
    warp a cell over its candidate observations, near_tptr and near_obs, in
    order); CPU tensors through op._near_rmatvec.
    `prism_near_rmatvec.launches` counts its launches."""
    if u.device.type == "cpu":
        return op._near_rmatvec(u)
    if u.device.type != "cuda":
        raise ValueError(f"prism_near_rmatvec runs on cuda or cpu tensors, got {u.device}")
    plan = _blend_plan(op, "prism_near_rmatvec")
    _operands(op, u, (op.xd.shape[0], op.phys.ndc), "u")
    out = _cuda_build.float64_output((op.phys.nmc, op.N), u)
    _near_launch("prism_near_rmatvec", op, plan, (op.near_tptr, op.near_obs), u, out)
    prism_near_rmatvec.launches += 1
    return out


def prism_matvec(op, xw):
    """(nrows_padded, ndc) rows of MatrixFreeKernel `op` times xw ((nmc, N),
    the column weight applied), before the row weights. CUDA tensors go
    through the hand-written kernel pair (partial sums over splits of the
    cells, then their sum in split order; the blend's near pass first, into
    one more split), on PyTorch's current stream; CPU tensors through
    op._partial_matvec. `prism_matvec.launches` counts the launches of the
    pair."""
    if xw.device.type == "cpu":
        return op._partial_matvec(xw)
    if xw.device.type != "cuda":
        raise ValueError(f"prism_matvec runs on cuda or cpu tensors, got {xw.device}")
    plan = launch_plan(op)
    geometry = _operands(op, xw, (op.phys.nmc, op.N), "xw")
    nrows = op.xd.shape[0]
    splits, per = matvec_splits(nrows, op.N)
    partial = torch.empty(partial_shapes(op)[0], dtype=torch.float64, device=xw.device)
    out = torch.empty((nrows, op.phys.ndc), dtype=xw.dtype, device=xw.device)
    if plan["mode"] == BLEND:
        prism_near_matvec(op, xw, out=partial[-1])
    _launch("prism_matvec", op, plan, geometry, xw, partial, out, splits, per)
    prism_matvec.launches += 1
    return out


def prism_rmatvec(op, u):
    """(nmc, N) rows of MatrixFreeKernel `op` transposed times u
    ((nrows_padded, ndc), the row weights applied), before the column
    weight. CUDA tensors go through the hand-written kernel (a thread a
    cell; the blend's sums start from its near pass's, launched first), on
    PyTorch's current stream; CPU tensors through op._partial_rmatvec.
    `prism_rmatvec.launches` counts its launches."""
    if u.device.type == "cpu":
        return op._partial_rmatvec(u)
    if u.device.type != "cuda":
        raise ValueError(f"prism_rmatvec runs on cuda or cpu tensors, got {u.device}")
    plan = launch_plan(op)
    geometry = _operands(op, u, (op.xd.shape[0], op.phys.ndc), "u")
    near = prism_near_rmatvec(op, u) if plan["mode"] == BLEND else None
    out = torch.empty((op.phys.nmc, op.N), dtype=u.dtype, device=u.device)
    _launch("prism_rmatvec", op, plan, geometry, u, near, out, 0, 0)
    prism_rmatvec.launches += 1
    return out


prism_matvec.launches = 0
prism_rmatvec.launches = 0
prism_near_matvec.launches = 0
prism_near_rmatvec.launches = 0
