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
csrc/prism_matvec.cu, which evaluate every pair in registers and store no
row, or raise; a tensor that lies on the CPU takes the plain version, the
operator's chunk loop (MatrixFreeKernel._partial_matvec and
_partial_rmatvec), unchanged. The kernels are bound by operations (the
source says how); neither uses atomics, so two runs agree to the last bit.

`launch_plan` and `matvec_splits` are the launch's choices, in Python so
that the CPU tests hold them. The library is built with nvcc from the .cu
source alone, into ``build/`` beside the package, the first time a CUDA
tensor arrives.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tomofastx_tpu_torch.ops import _cuda_build

_NAME = "prism_matvec"

THREADS = 128  # csrc/prism_matvec.cu: threads a block, cells or observations staged at a time
# The matvec's grid aims at this many blocks (observation tiles x cell
# splits): some 15 a streaming multiprocessor of an H100.
TARGET_BLOCKS = 2048

# csrc/prism_matvec.cu's Family and Mode, and the (family, nmc, ndc) it takes.
GZ, GZZ, FTG, MAG = 0, 1, 2, 3
CLOSED, BLEND = 0, 1
SHAPES = {(GZ, 1, 1), (GZZ, 1, 1), (FTG, 1, 6), (MAG, 1, 1), (MAG, 1, 3), (MAG, 3, 1), (MAG, 3, 3)}
MU0_T2NT = 4.0e-7 * math.pi * 1.0e9  # ops/prism.py combine_mag_tensor


def build_library() -> tuple[str, str]:
    """Compile csrc/prism_matvec.cu (see _cuda_build.build_library)."""
    return _cuda_build.build_library(_NAME)


def _library():
    # One signature for both entry points: is_double, family, nmc, ndc, mode,
    # handle_inside; the six bounds, three coordinates, the input, the
    # partial sums, the output; N, nrows, splits, cells a split; the field's
    # direction cosines and scale; the stream.
    return _cuda_build.load_library(
        _NAME, ("prism_matvec", "prism_rmatvec"),
        (ctypes.c_int,) * 6 + (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 4 + (ctypes.c_double,) * 4
        + (ctypes.c_void_p,),
    )


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
    if phys.far_quad and op.near_idx is None:
        raise ValueError("prism_matvec: a blended operator without its near candidates (near_idx)")
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


def _operands(op, v, shape, what):
    """The operator's tensors and v, checked for one launch."""
    geometry = (*op.grid6, op.xd, op.yd, op.zd)
    dtype = op.xd.dtype
    if tuple(v.shape) != shape:
        raise ValueError(f"{what} must be {shape}, got {tuple(v.shape)}")
    for a in geometry + (v,):
        if a.dtype != dtype:
            raise TypeError(f"prism_matvec: tensors of {a.dtype} and {dtype}")
        if a.device != v.device:
            raise ValueError(f"prism_matvec: tensors on different devices: {a.device}, {v.device}")
        if not a.is_contiguous():
            raise ValueError("prism_matvec: the operator's tensors and the vector must be contiguous")
    return geometry


def _launch(entry, op, plan, geometry, vin, partial, out, splits, per):
    N, nrows = op.N, op.xd.shape[0]
    fn = getattr(_library(), entry)
    with torch.cuda.device(vin.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(plan["is_double"], plan["family"], plan["nmc"], plan["ndc"], plan["mode"], plan["handle_inside"],
                 *(a.data_ptr() for a in geometry), vin.data_ptr(),
                 None if partial is None else partial.data_ptr(), out.data_ptr(), N, nrows, splits, per,
                 *plan["magv"], plan["s4pi"], stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def prism_matvec(op, xw):
    """(nrows_padded, ndc) rows of MatrixFreeKernel `op` times xw ((nmc, N),
    the column weight applied), before the row weights. CUDA tensors go
    through the hand-written kernel pair (partial sums over splits of the
    cells, then their sum in split order), on PyTorch's current stream; CPU
    tensors through op._partial_matvec. `prism_matvec.launches` counts the
    launches of the pair."""
    if xw.device.type == "cpu":
        return op._partial_matvec(xw)
    if xw.device.type != "cuda":
        raise ValueError(f"prism_matvec runs on cuda or cpu tensors, got {xw.device}")
    plan = launch_plan(op)
    geometry = _operands(op, xw, (op.phys.nmc, op.N), "xw")
    nrows = op.xd.shape[0]
    splits, per = matvec_splits(nrows, op.N)
    partial = torch.empty((splits, nrows, op.phys.ndc), dtype=torch.float64, device=xw.device)
    out = torch.empty((nrows, op.phys.ndc), dtype=xw.dtype, device=xw.device)
    _launch("prism_matvec", op, plan, geometry, xw, partial, out, splits, per)
    prism_matvec.launches += 1
    return out


def prism_rmatvec(op, u):
    """(nmc, N) rows of MatrixFreeKernel `op` transposed times u
    ((nrows_padded, ndc), the row weights applied), before the column
    weight. CUDA tensors go through the hand-written kernel (a thread a
    cell), on PyTorch's current stream; CPU tensors through
    op._partial_rmatvec. `prism_rmatvec.launches` counts its launches."""
    if u.device.type == "cpu":
        return op._partial_rmatvec(u)
    if u.device.type != "cuda":
        raise ValueError(f"prism_rmatvec runs on cuda or cpu tensors, got {u.device}")
    plan = launch_plan(op)
    geometry = _operands(op, u, (op.xd.shape[0], op.phys.ndc), "u")
    out = torch.empty((op.phys.nmc, op.N), dtype=u.dtype, device=u.device)
    _launch("prism_rmatvec", op, plan, geometry, u, None, out, 0, 0)
    prism_rmatvec.launches += 1
    return out


prism_matvec.launches = 0
prism_rmatvec.launches = 0
