"""Row-block sparse matrix-vector product: the CUDA kernel's wrapper and its
plain PyTorch version.

The row layout keeps, for every row of a block-sparse S (nrows x ncols), a
list of B 128-column blocks:

    bvals (nrows, B, 128) float32   row r's values in its slot b
    bidx  (nrows, B)      int32     slot b of row r reads columns
                                    128*bidx[r,b] .. +127

and the product is y[r] = sum_b <bvals[r, b, :], x[128*bidx[r,b] : +128]>.
Pad slots point at any valid block and hold zeros. Where the tile-union
layout (ops/tile_matvec.py) shares one block list among 8 rows, here every
row has its own, so a row stores only the blocks it uses.

`blocked_matvec` replaces the TPU kernel of the JAX package
(tomofastx_tpu/ops/pallas_kernels.py, blocked_matvec with body
_blocked_matvec_kernel). As there, it is a public function of ops/ that no
workflow branch calls. On a CUDA tensor it launches the hand-written kernel
of csrc/blocked_matvec.cu or raises; it takes the plain version only for a
tensor that lies on the CPU. Any number of rows is taken (the TPU kernel
wants a multiple of its 8-row program). The kernel is bound by the bytes of
`bvals`, each read once for one multiply-add; its source says what the
design does about that. It trusts the block ids it is given:
`check_block_ids` holds them to the vector's length once, where a layout
enters from outside.

`blocked_matvec_plain` is the same function as a gather and an einsum (the
counterpart of blocked_matvec_xla), contracted in the type of x: the CPU
tests use it, and the kernel is held against it on the card.
"""

from __future__ import annotations

import ctypes

import torch

from tomofastx_tpu_torch.ops import _cuda_build

BLOCK = 128  # columns per block

_NAME = "blocked_matvec"
_SOURCE = _cuda_build.source_path(_NAME)


def build_library() -> tuple[str, str]:
    """Compile csrc/blocked_matvec.cu (see _cuda_build.build_library)."""
    return _cuda_build.build_library(_NAME)


def _library():
    return _cuda_build.load_library(
        _NAME, ("blocked_matvec_f32", "blocked_matvec_f64"),
        (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
    )


def _check(bvals, bidx, x):
    if bvals.ndim != 3 or bvals.shape[2] != BLOCK:
        raise ValueError(f"bvals must be (nrows, B, {BLOCK}), got {tuple(bvals.shape)}")
    if tuple(bidx.shape) != tuple(bvals.shape[:2]):
        raise ValueError(f"bidx must be {tuple(bvals.shape[:2])}, got {tuple(bidx.shape)}")
    if x.ndim != 1 or x.shape[0] % BLOCK:
        raise ValueError(f"x must be a vector of a multiple of {BLOCK} entries, got {tuple(x.shape)}")
    if bvals.dtype == torch.bfloat16:
        raise TypeError("bfloat16 values are not taken yet: bvals must be float32")
    if bvals.dtype != torch.float32 or bidx.dtype != torch.int32:
        raise TypeError(f"bvals must be float32 and bidx int32, got {bvals.dtype}, {bidx.dtype}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    if not (bvals.device == bidx.device == x.device):
        raise ValueError(f"tensors on different devices: {bvals.device}, {bidx.device}, {x.device}")


def check_block_ids(bidx, n_in: int):
    """Raise unless every block id lies inside a vector of n_in entries
    (padded to whole blocks). One reduction and one read of the device: call
    it once per layout, not per product."""
    nblocks = max(1, -(-n_in // BLOCK))
    if bidx.numel() and not (0 <= int(bidx.min()) and int(bidx.max()) < nblocks):
        raise ValueError(f"bidx holds block ids outside [0, {nblocks})")


def blocked_matvec_plain(bvals, bidx, x):
    """y = S @ x through the row layout with plain tensor operations,
    contracted in the dtype of x. Returns (nrows,). Rows go in groups so
    that the gathered intermediate stays small beside the values."""
    _check(bvals, bidx, x)
    nrows, B = bidx.shape
    xb = x.reshape(-1, BLOCK)
    y = torch.empty(nrows, dtype=x.dtype, device=x.device)
    step = max(1, (1 << 25) // max(B * BLOCK, 1))
    for s in range(0, nrows, step):
        g = xb[bidx[s : s + step].long()]  # (rows, B, 128)
        y[s : s + step] = torch.einsum("rbk,rbk->r", bvals[s : s + step].to(x.dtype), g)
    return y


def blocked_matvec(bvals, bidx, x):
    """y = S @ x through the row layout. Returns (nrows,) in the dtype of x.
    CUDA tensors go through the hand-written kernel, on PyTorch's current
    stream; CPU tensors through blocked_matvec_plain.
    `blocked_matvec.launches` counts the kernel's launches."""
    _check(bvals, bidx, x)
    if x.device.type == "cpu":
        return blocked_matvec_plain(bvals, bidx, x)
    if x.device.type != "cuda":
        raise ValueError(f"blocked_matvec runs on cuda or cpu tensors, got {x.device}")
    _cuda_build.require_launchable(bvals=bvals, bidx=bidx, x=x)
    nrows, B = bidx.shape
    lib = _library()
    y = torch.empty(nrows, dtype=x.dtype, device=x.device)
    fn = lib.blocked_matvec_f32 if x.dtype == torch.float32 else lib.blocked_matvec_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(bvals.data_ptr(), bidx.data_ptr(), x.data_ptr(), y.data_ptr(), nrows, B, stream)
    if err != 0:
        raise RuntimeError(f"blocked_matvec launch failed: CUDA error {err}")
    blocked_matvec.launches += 1
    return y


blocked_matvec.launches = 0
