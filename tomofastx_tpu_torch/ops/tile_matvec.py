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

import torch

from tomofastx_tpu_torch.ops import _cuda_build

TM = 8  # rows per tile
BLOCK = 128  # columns per block

_NAME = "tile_matvec"
_SOURCE = _cuda_build.source_path(_NAME)


def build_library() -> tuple[str, str]:
    """Compile csrc/tile_matvec.cu (see _cuda_build.build_library)."""
    return _cuda_build.build_library(_NAME)


def _library():
    return _cuda_build.load_library(
        _NAME, ("tile_matvec_f32", "tile_matvec_f64"),
        (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
    )


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
    so that the intermediates stay small beside the packs.

    Each tile's row sums are one reduction over the tile's own BU * 128
    products, so, as in the kernel, a tile's result does not depend on which
    other tiles share the call: the result of a pack cut into parts equals
    that of the whole pack bit for bit (a batched product would not promise
    that)."""
    _check(uvals, ubidx, x)
    ntiles, BU = ubidx.shape
    xb = x.reshape(-1, BLOCK)
    y = torch.empty(ntiles, TM, dtype=x.dtype, device=x.device)
    step = max(1, (1 << 25) // max(BU * TM * BLOCK, 1))
    for s in range(0, ntiles, step):
        g = xb[ubidx[s : s + step].long()]  # (tiles, BU, 128)
        prod = torch.empty((g.shape[0], TM, BU, BLOCK), dtype=x.dtype, device=x.device)
        torch.mul(uvals[s : s + step].permute(0, 2, 1, 3), g[:, None], out=prod)
        y[s : s + step] = prod.view(g.shape[0], TM, BU * BLOCK).sum(dim=-1)
    return y.reshape(-1)


def _launch(uvals, ubidx, x):
    """One launch of the kernel of csrc/tile_matvec.cu on x's device and that
    device's current stream. Counts nothing: each wrapper counts its own."""
    _cuda_build.require_launchable(uvals=uvals, ubidx=ubidx, x=x)
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
    return y


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
    y = _launch(uvals, ubidx, x)
    tile_matvec.launches += 1
    return y


tile_matvec.launches = 0


def tile_matvec_sharded_plain(parts, x, home):
    """tile_matvec_sharded with tile_matvec_plain on every part."""
    return torch.cat([tile_matvec_plain(uv, ub, x.to(uv.device)).to(home) for uv, ub in parts])


def tile_matvec_sharded(parts, x, home):
    """y = S @ x over a pack whose tile axis is cut into parts, one per mesh
    slot: the counterpart of TileKernel._shard_map_pallas of the JAX package
    (tomofastx_tpu/ops/tile_kernel.py), which runs the TPU kernel per device
    under shard_map with x replicated and the tile-local outputs concatenated.

    parts: [(uvals_k, ubidx_k)], each pair on its slot's device, in tile
    order. For each part x is copied to the part's device (the replicated
    in-spec; a no-op when it is there already), the kernel of
    csrc/tile_matvec.cu is launched on that device's current stream, and
    the part's output is copied to `home`; the outputs are concatenated
    there in part order (the out-spec's gather). A tile's sum does not
    depend on the other tiles, so the result equals one tile_matvec on the
    whole pack bit for bit. A part on a CUDA device goes through the kernel
    or raises; a part on the CPU takes tile_matvec_plain.
    `tile_matvec_sharded.launches` counts the kernel's launches, one per
    part."""
    home = torch.device(home)
    outs = []
    for uv, ub in parts:
        xk = x.to(uv.device)
        _check(uv, ub, xk)
        if xk.device.type == "cpu":
            y = tile_matvec_plain(uv, ub, xk)
        elif xk.device.type == "cuda":
            y = _launch(uv, ub, xk)
            tile_matvec_sharded.launches += 1
        else:
            raise ValueError(f"tile_matvec_sharded runs on cuda or cpu tensors, got {xk.device}")
        # Tensor.to orders the copy after the kernel on the part's current
        # stream and before later work on home's current stream.
        outs.append(y.to(home))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


tile_matvec_sharded.launches = 0
