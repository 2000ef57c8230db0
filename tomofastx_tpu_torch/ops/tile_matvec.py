"""Tile-union block-sparse matrix-vector product: the CUDA kernel's wrapper
and its plain PyTorch version.

The tile-union layout packs a block-sparse S (nrows x ncols) as

    uvals (ntiles, BU, 8, 128) float32   tile i = rows 8i .. 8i+7
    ubidx (ntiles, BU)         int32     slot b of tile i reads columns
                                         128*ubidx[i,b] .. +127

and the product is y[8i + m] = sum_b <uvals[i, b, m, :], x[128*ubidx[i,b] : +128]>.
Pad slots point at block 0 and hold zeros.

`tile_matvec` replaces the TPU kernel of the JAX package
(tomofastx_tpu/ops/pallas_kernels.py, tile_matvec with body
_tile_matvec_kernel). On a CUDA tensor it launches the hand-written kernel
of csrc/tile_matvec.cu or raises; it takes the plain version only for a
tensor that lies on the CPU. The kernel is bound by the bytes of `uvals`,
each read once for one multiply-add; its source says what the design does
about that.

`tile_matvec_plain` is the same function as a gather and an einsum (the
counterpart of tile_matvec_xla): the CPU tests use it, and the kernel is
held against it on the card.

The shared library is built with nvcc from the .cu source alone, into
``build/`` beside the package, the first time a CUDA tensor arrives.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import torch

TM = 8  # rows per tile
BLOCK = 128  # columns per block

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "csrc", "tile_matvec.cu")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "build"
)


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the tile_matvec kernel cannot be built")


def build_library() -> tuple[str, str]:
    """Compile csrc/tile_matvec.cu for sm_90a into build/ unless a library of
    this very source is there already. Returns (path of the library, what
    the compiler printed, empty if nothing was compiled)."""
    with open(_SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(_BUILD_DIR, f"libtile_matvec_{tag}.so")
    if os.path.exists(path):
        return path, ""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [
        _find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, _SOURCE,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, path)
    return path, log


@functools.lru_cache(maxsize=None)
def _library():
    path, _ = build_library()
    lib = ctypes.CDLL(path)
    for fn in (lib.tile_matvec_f32, lib.tile_matvec_f64):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(uvals, ubidx, x):
    if uvals.ndim != 4 or uvals.shape[2] != TM or uvals.shape[3] != BLOCK:
        raise ValueError(f"uvals must be (ntiles, BU, {TM}, {BLOCK}), got {tuple(uvals.shape)}")
    if tuple(ubidx.shape) != tuple(uvals.shape[:2]):
        raise ValueError(f"ubidx must be {tuple(uvals.shape[:2])}, got {tuple(ubidx.shape)}")
    if x.ndim != 1 or x.shape[0] % BLOCK:
        raise ValueError(f"x must be a vector of a multiple of {BLOCK} entries, got {tuple(x.shape)}")
    if uvals.dtype != torch.float32 or ubidx.dtype != torch.int32:
        raise TypeError(f"uvals must be float32 and ubidx int32, got {uvals.dtype}, {ubidx.dtype}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    if not (uvals.device == ubidx.device == x.device):
        raise ValueError(f"tensors on different devices: {uvals.device}, {ubidx.device}, {x.device}")


def tile_matvec_plain(uvals, ubidx, x):
    """y = S @ x through the tile-union layout with plain tensor operations,
    contracted in the dtype of x. Returns (ntiles * 8,). Tiles go in groups
    so that the gathered intermediate stays small beside the packs."""
    _check(uvals, ubidx, x)
    ntiles, BU = ubidx.shape
    xb = x.reshape(-1, BLOCK)
    y = torch.empty(ntiles, TM, dtype=x.dtype, device=x.device)
    step = max(1, (1 << 25) // max(BU * TM * BLOCK, 1))
    for s in range(0, ntiles, step):
        g = xb[ubidx[s : s + step].long()]  # (tiles, BU, 128)
        y[s : s + step] = torch.einsum("tbmk,tbk->tm", uvals[s : s + step].to(x.dtype), g)
    return y.reshape(-1)


def tile_matvec(uvals, ubidx, x):
    """y = S @ x through the tile-union layout. Returns (ntiles * 8,) in the
    dtype of x (the caller slices off row padding). CUDA tensors go through
    the hand-written kernel, on PyTorch's current stream; CPU tensors through
    tile_matvec_plain. `tile_matvec.launches` counts the kernel's launches."""
    _check(uvals, ubidx, x)
    if x.device.type == "cpu":
        return tile_matvec_plain(uvals, ubidx, x)
    if x.device.type != "cuda":
        raise ValueError(f"tile_matvec runs on cuda or cpu tensors, got {x.device}")
    for name, a in (("uvals", uvals), ("ubidx", ubidx), ("x", x)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    ntiles, BU = ubidx.shape
    lib = _library()
    y = torch.empty(ntiles * TM, dtype=x.dtype, device=x.device)
    fn = lib.tile_matvec_f32 if x.dtype == torch.float32 else lib.tile_matvec_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(uvals.data_ptr(), ubidx.data_ptr(), x.data_ptr(), y.data_ptr(),
                 ntiles, BU, stream)
    if err != 0:
        raise RuntimeError(f"tile_matvec launch failed: CUDA error {err}")
    tile_matvec.launches += 1
    return y


tile_matvec.launches = 0
