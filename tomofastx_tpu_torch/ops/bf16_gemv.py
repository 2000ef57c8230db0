"""Matrix-vector products on a bfloat16-stored dense kernel: the CUDA
kernels' wrappers and their plain PyTorch versions.

With ``tpu.kernelStoreDtype = bfloat16`` the dense kernel S (nrows, ncols)
is held in bfloat16, half the bytes of float32, and the solve's vectors stay
float32 (or float64):

    bf16_matvec(S, x)   y[r] = sum_c float(S[r, c]) * x[c]
    bf16_rmatvec(S, u)  g[c] = sum_r float(S[r, c]) * u[r]

each summed in the vector's type, both from the one row-major S (no
transpose is held). In the JAX package this is no Pallas kernel: XLA fuses
the bfloat16-to-float32 conversion into its GEMV (``S @ x`` on a bfloat16 S,
tomofastx_tpu/ops/sparse_kernel.py DenseKernel.matvec / rmatvec, with the
workflow's cast at tomofastx_tpu/inversion/workflow.py:474-488), and never
makes the float32 matrix. PyTorch has no call for it: ``torch.mv`` refuses
mixed types, a cast of S makes the float32 matrix the mode exists to avoid,
and a cast of x to bfloat16 is another function. So on a CUDA tensor both
products launch the hand-written kernels of csrc/bf16_gemv.cu, or raise;
a tensor that lies on the CPU takes the plain version. The kernels are bound
by the bytes of S, read once a product; the source says what the design
does about that. Neither uses float atomics: a product's sums come in a
fixed order, so two runs agree to the last bit.

The plain versions cast one block of rows of S at a time to the vector's
type and multiply it with torch.mv, so that the whole matrix never exists
in float32. The CPU tests use them, and the kernels are held against them on
the card.
"""

from __future__ import annotations

import ctypes

import torch

from tomofastx_tpu_torch.ops import _cuda_build

_NAME = "bf16_gemv"
_SOURCE = _cuda_build.source_path(_NAME)

# Rows of S cast to the vector's type at a time in the plain versions.
PLAIN_ROWS = 256


def build_library() -> tuple[str, str]:
    """Compile csrc/bf16_gemv.cu (see _cuda_build.build_library)."""
    return _cuda_build.build_library(_NAME)


def _library():
    # One signature for the four entry points: S, the vector, the slab
    # partials (unused by the matvec), the output, nrows, ncols, slabs, stream.
    return _cuda_build.load_library(
        _NAME, ("bf16_matvec_f32", "bf16_matvec_f64", "bf16_rmatvec_f32", "bf16_rmatvec_f64"),
        (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,),
    )


def _check(S, v, n, what):
    if S.ndim != 2 or S.dtype != torch.bfloat16:
        raise TypeError(f"S must be a 2-D bfloat16 tensor, got {tuple(S.shape)} {S.dtype}")
    if v.ndim != 1 or v.shape[0] != n:
        raise ValueError(f"{what} must be a vector of {n} entries, got {tuple(v.shape)}")
    if v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} must be float32 or float64, got {v.dtype}")
    if S.device != v.device:
        raise ValueError(f"tensors on different devices: {S.device}, {v.device}")


def slabs(nrows: int, ncols: int) -> int:
    """Slabs of rows that bf16_rmatvec splits S into: each thread block
    sums one slab over 2048 columns, and enough blocks fill the card
    (2048 or more where there are rows for them). A function of the shape
    alone, so the order of every sum is too."""
    tiles = -(-ncols // 2048)
    return max(1, min(-(-2048 // tiles), -(-nrows // 32)))


def bf16_matvec_plain(S, x):
    """y = S x in the type of x, S cast a block of rows at a time."""
    _check(S, x, S.shape[1], "x")
    y = torch.empty(S.shape[0], dtype=x.dtype, device=x.device)
    for s in range(0, S.shape[0], PLAIN_ROWS):
        y[s : s + PLAIN_ROWS] = torch.mv(S[s : s + PLAIN_ROWS].to(x.dtype), x)
    return y


def bf16_rmatvec_plain(S, u):
    """g = S^T u in the type of u, S cast a block of rows at a time and the
    blocks' partial sums added in row order."""
    _check(S, u, S.shape[0], "u")
    g = torch.zeros(S.shape[1], dtype=u.dtype, device=u.device)
    for s in range(0, S.shape[0], PLAIN_ROWS):
        g += torch.mv(S[s : s + PLAIN_ROWS].to(u.dtype).T, u[s : s + PLAIN_ROWS])
    return g


def _launchable(S, v):
    """Refuse an S the kernels cannot read (not contiguous; rows of a
    multiple of 8 values, read 16 bytes at a time, off 16-byte alignment),
    and return v aligned for the 16-byte loads (a misaligned slice of a
    vector is copied; S itself is never copied)."""
    if not S.is_contiguous():
        raise ValueError("S must be contiguous")
    if S.shape[1] % 8 == 0 and S.data_ptr() % 16:
        raise ValueError("S must be 16-byte aligned")
    if v.data_ptr() % 16 or not v.is_contiguous():
        v = v.clone(memory_format=torch.contiguous_format)
    return v


def bf16_matvec(S, x):
    """y = S x for a bfloat16 S and a float32 or float64 x, summed in the type
    of x. CUDA tensors go through the hand-written kernel, on PyTorch's
    current stream; CPU tensors through bf16_matvec_plain.
    `bf16_matvec.launches` counts the kernel's launches."""
    _check(S, x, S.shape[1], "x")
    if x.device.type == "cpu":
        return bf16_matvec_plain(S, x)
    if x.device.type != "cuda":
        raise ValueError(f"bf16_matvec runs on cuda or cpu tensors, got {x.device}")
    x = _launchable(S, x)
    nrows, ncols = S.shape
    y = torch.empty(nrows, dtype=x.dtype, device=x.device)
    lib = _library()
    fn = lib.bf16_matvec_f32 if x.dtype == torch.float32 else lib.bf16_matvec_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(S.data_ptr(), x.data_ptr(), None, y.data_ptr(), nrows, ncols, 0, stream)
    if err != 0:
        raise RuntimeError(f"bf16_matvec launch failed: CUDA error {err}")
    bf16_matvec.launches += 1
    return y


def bf16_rmatvec(S, u):
    """g = S^T u for a bfloat16 S and a float32 or float64 u, summed in the
    type of u, from the row-major S. CUDA tensors go through the
    hand-written kernel pair (slab partial sums, then their sum in slab
    order), on PyTorch's current stream; CPU tensors through
    bf16_rmatvec_plain. `bf16_rmatvec.launches` counts the launches of the
    pair."""
    _check(S, u, S.shape[0], "u")
    if u.device.type == "cpu":
        return bf16_rmatvec_plain(S, u)
    if u.device.type != "cuda":
        raise ValueError(f"bf16_rmatvec runs on cuda or cpu tensors, got {u.device}")
    u = _launchable(S, u)
    nrows, ncols = S.shape
    nslabs = slabs(nrows, ncols)
    partial = torch.empty((nslabs, ncols), dtype=u.dtype, device=u.device)
    g = torch.empty(ncols, dtype=u.dtype, device=u.device)
    lib = _library()
    fn = lib.bf16_rmatvec_f32 if u.dtype == torch.float32 else lib.bf16_rmatvec_f64
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(S.data_ptr(), u.data_ptr(), partial.data_ptr(), g.data_ptr(), nrows, ncols, nslabs, stream)
    if err != 0:
        raise RuntimeError(f"bf16_rmatvec launch failed: CUDA error {err}")
    bf16_rmatvec.launches += 1
    return g


bf16_matvec.launches = 0
bf16_rmatvec.launches = 0
