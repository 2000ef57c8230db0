"""Tile-union block-sparse matrix-vector product: the CUDA kernel's wrappers
and their plain PyTorch versions.

The tile-union layout packs a block-sparse S (nrows x ncols) as

    uvals (ntiles, BU, 8, 128) float32   tile i = rows 8i .. 8i+7
    ubidx (ntiles, BU)         int32     slot b of tile i reads columns
                                         128*ubidx[i,b] .. +127

and the product is y[8i + m] = sum_b <uvals[i, b, m, :], x[128*ubidx[i,b] : +128]>.
Pad slots point at block 0 and hold zeros.

`tile_matvec` replaces the TPU kernel of the JAX package
(tomofastx_tpu/ops/pallas_kernels.py, tile_matvec with body
_tile_matvec_kernel), and `tile_matvec_sharded` its per-device form
(tomofastx_tpu/ops/tile_kernel.py, TileKernel._shard_map_pallas). On CUDA
tensors both launch the hand-written kernel of csrc/tile_matvec.cu or
raise; they take the plain version only for tensors that lie on the CPU.
The kernel is bound by the bytes of `uvals`, each read once for one
multiply-add; its source says what the design does about that.

`work_plan`, `block_slots` and `launch_table` are the launch's work plan,
in Python so that the CPU tests hold it: how many thread blocks a tile
spans (a cluster) or how many tiles a block holds, which slots each warp
adds in which order, and the table of parts that one launch reads.

`tile_matvec_plain` is the same function as a gather and an einsum (the
counterpart of tile_matvec_xla): the CPU tests use it, and the kernel is
held against it on the card.

The shared library is built with nvcc from the .cu source alone, into
``build/`` beside the package, the first time a CUDA tensor arrives.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tomofastx_tpu_torch.ops import _cuda_build

TM = 8  # rows per tile
BLOCK = 128  # columns per block
# The work plan (csrc/tile_matvec.cu). A tile's sum is CHAINS chains, chain
# c adding slots c, c + CHAINS, ... (the one-block-a-tile kernel's order). A
# short tile (BU <= SHORT, one block id a lane of a warp) is one consumer
# warp's, its chains in turn, and a thread block sums WARPS such tiles; a
# longer tile takes a cluster of CHAINS blocks, one a chain. Either way a
# block holds about 1 MB of values at the smoke's shapes (BU 32 and 1955).
SHORT = 32
WARPS = 8  # short tiles a thread block: csrc/tile_matvec.cu's default
CHAINS = 8  # chains of a tile's sum, and blocks of a long tile's cluster
MAX_PARTS = 64  # parts of one launch

_NAME = "tile_matvec"
_SOURCE = _cuda_build.source_path(_NAME)


def build_library() -> tuple[str, str]:
    """Compile csrc/tile_matvec.cu (see _cuda_build.build_library)."""
    return _cuda_build.build_library(_NAME)


@functools.lru_cache(maxsize=None)
def _library():
    lib = _cuda_build.load_library(
        _NAME, ("tile_matvec_f32", "tile_matvec_f64"),
        (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p),
    )
    lib.tile_matvec_prepare.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.tile_matvec_prepare.restype = ctypes.c_int
    lib.tile_matvec_max_active_clusters.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.tile_matvec_max_active_clusters.restype = ctypes.c_int
    return lib


class _Part(ctypes.Structure):
    """One part of a launch: the kernel's struct Part."""

    _fields_ = [("uvals", ctypes.c_void_p), ("ubidx", ctypes.c_void_p), ("tile0", ctypes.c_longlong),
                ("block0", ctypes.c_longlong), ("ntiles", ctypes.c_int), ("pad", ctypes.c_int)]


def work_plan(bu: int, warps: int = WARPS) -> tuple[int, int]:
    """(thread blocks a tile, tiles a thread block) for tiles of `bu`
    slots: (1, warps) up to SHORT slots, else (CHAINS, 1)."""
    return (1, warps) if bu <= SHORT else (CHAINS, 1)


def chain_order(bu: int) -> list:
    """A tile's slots in the order its sum adds them: chain 0's (0, 8, 16,
    ...), then chain 1's, and so on."""
    return [c + CHAINS * i for c in range(CHAINS) for i in range(-(-(bu - c) // CHAINS))]


def block_slots(bu: int, ntiles: int, lb: int, warps: int = WARPS):
    """What block lb of a pack of `ntiles` tiles sums, as the kernel does:
    for each consumer warp, (its tile, the slots of that tile in the order
    the warp adds them). A short tile is one warp's, all its chains in
    turn; a long tile's block r sums its chain r."""
    blocks, tiles = work_plan(bu, warps)
    if bu <= SHORT:
        return [(lb * tiles + w, chain_order(bu) if lb * tiles + w < ntiles else []) for w in range(warps)]
    tile, r = divmod(lb, blocks)
    return [(tile, list(range(r, bu, CHAINS)))]


def launch_table(part_tiles, bu: int, warps: int = WARPS):
    """One launch's plan for parts of `part_tiles[k]` tiles each, their
    outputs one after another: (1 if long tiles, one cluster of CHAINS
    blocks a tile, else 0; [(first output tile, first block, ntiles)] a
    part; blocks in all)."""
    blocks, tiles = work_plan(bu, warps)
    rows, tile0, block0 = [], 0, 0
    for n in part_tiles:
        rows.append((tile0, block0, n))
        tile0 += n
        block0 += -(-n // tiles) * blocks
    if block0 >= 1 << 31:
        raise ValueError(f"a launch of {block0} thread blocks is too large")
    return int(bu > SHORT), rows, block0


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


_prepared = {}  # device index -> the kernel's (warps, chains, max parts)
_schedulable = {}  # (device index, x dtype) -> clusters of a long tile the device holds at once


def _prepare(lib, device):
    """Set the kernels' shared-memory size on `device` once, and check that
    the library was built with the plan's shape."""
    if device.index not in _prepared:
        vals = [ctypes.c_int() for _ in range(3)]
        with torch.cuda.device(device):
            err = lib.tile_matvec_prepare(*(ctypes.byref(v) for v in vals))
        if err != 0:
            raise RuntimeError(f"tile_matvec: setting the kernels' shared memory failed: CUDA error {err}")
        shape = tuple(v.value for v in vals)
        if shape != (WARPS, CHAINS, MAX_PARTS):
            raise RuntimeError(f"tile_matvec: the library's shape {shape} is not the work plan's")
        _prepared[device.index] = shape


def _require_schedulable(lib, device, dtype):
    """Raise unless the device can run a long tile's cluster of CHAINS blocks."""
    key = (device.index, dtype)
    if key not in _schedulable:
        n = ctypes.c_int()
        with torch.cuda.device(device):
            err = lib.tile_matvec_max_active_clusters(int(dtype == torch.float64), ctypes.byref(n))
        if err != 0:
            raise RuntimeError(f"tile_matvec: cudaOccupancyMaxActiveClusters failed: CUDA error {err}")
        _schedulable[key] = n.value
    if _schedulable[key] < 1:
        raise RuntimeError(f"tile_matvec: {device} cannot schedule a cluster of {CHAINS} thread blocks")


_plans = {}  # (device, dtype, the parts' pointers and shapes, first tiles) -> a launch's plan and table


def _plan(lib, parts, x, tile0s):
    """(kernel function, BU, chain argument, blocks, ctypes table) of one launch over
    `parts`, made once for a set of parts and kept: an operator launches on
    the same parts in every product."""
    key = (x.device.index, x.dtype, tuple((uv.data_ptr(), ub.data_ptr(), *ub.shape) for uv, ub in parts),
           tuple(tile0s))
    plan = _plans.get(key)
    if plan is None:
        bu = parts[0][1].shape[1]
        if any(ub.shape[1] != bu for _, ub in parts):
            raise ValueError(f"one launch takes parts of one BU, got {[ub.shape[1] for _, ub in parts]}")
        if len(parts) > MAX_PARTS:
            raise ValueError(f"one launch takes at most {MAX_PARTS} parts, got {len(parts)}")
        _prepare(lib, x.device)
        chain, rows, nblocks = launch_table([ub.shape[0] for _, ub in parts], bu)
        if chain:
            _require_schedulable(lib, x.device, x.dtype)
        table = (_Part * len(parts))(*(
            _Part(uv.data_ptr(), ub.data_ptr(), t0, b0, n, 0)
            for (uv, ub), t0, (_, b0, n) in zip(parts, tile0s, rows)))
        fn = lib.tile_matvec_f32 if x.dtype == torch.float32 else lib.tile_matvec_f64
        if len(_plans) >= 256:
            _plans.clear()
        plan = _plans[key] = (fn, bu, chain, nblocks, table)
    return plan


def _launch(parts, x, y, tile0s):
    """One launch of the kernel of csrc/tile_matvec.cu over `parts` (pairs
    (uvals, ubidx) of one BU on x's device), on that device's current
    stream, part k's outputs written into y from tile tile0s[k] on. Counts
    nothing: each wrapper counts its own."""
    for uv, ub in parts:
        _cuda_build.require_launchable(uvals=uv, ubidx=ub)
    _cuda_build.require_launchable(x=x, y=y)
    lib = _library()
    fn, bu, chain, nblocks, table = _plan(lib, parts, x, tile0s)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (ctypes.addressof(table), len(parts), x.data_ptr(), y.data_ptr(), bu, chain, nblocks, stream)
    if x.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(x.device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"tile_matvec launch failed: CUDA error {err}")


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
    y = torch.empty(ubidx.shape[0] * TM, dtype=x.dtype, device=x.device)
    _launch([(uvals, ubidx)], x, y, [0])
    tile_matvec.launches += 1
    return y


tile_matvec.launches = 0


def tile_matvec_sharded_plain(parts, x, home):
    """tile_matvec_sharded with tile_matvec_plain on every part."""
    return torch.cat([tile_matvec_plain(uv, ub, x.to(uv.device)).to(home) for uv, ub in parts])


def _device(d):
    """d as a torch.device with its index (the current card for "cuda")."""
    d = torch.device(d)
    return torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d


def tile_matvec_sharded(parts, x, home):
    """y = S @ x over a pack whose tile axis is cut into parts, one per mesh
    slot: the counterpart of TileKernel._shard_map_pallas of the JAX package
    (tomofastx_tpu/ops/tile_kernel.py), which runs the TPU kernel per device
    under shard_map with x replicated and the tile-local outputs concatenated.

    parts: [(uvals_k, ubidx_k)], each pair on its slot's device, in tile
    order. The output, on `home`, holds the parts' rows one after another.
    The parts that share a CUDA device go through one launch of the kernel
    of csrc/tile_matvec.cu, on that device's current stream, with x copied
    there once (the replicated in-spec; a no-op when it is there already):
    on `home` each part's rows go straight into the output, on another
    card into one buffer there, whose rows are then copied to their place
    on `home` (the out-spec's gather; Tensor.copy_ orders the copy after the
    kernel). A tile's sum depends on BU alone (work_plan), so the result
    equals one tile_matvec on the whole pack bit for bit. Parts on the CPU
    take tile_matvec_plain. `tile_matvec_sharded.launches` counts the
    kernel's launches, one a card."""
    home = _device(home)
    first = [0]
    for _, ub in parts:
        first.append(first[-1] + ub.shape[0])
    y = torch.empty(first[-1] * TM, dtype=x.dtype, device=home)
    groups = {}
    for k, (uv, _) in enumerate(parts):
        groups.setdefault(_device(uv.device), []).append(k)
    for dev, ks in groups.items():
        xk = x.to(dev)
        for k in ks:
            _check(*parts[k], xk)
        if dev.type == "cpu":
            for k in ks:
                y[first[k] * TM : first[k + 1] * TM] = tile_matvec_plain(*parts[k], xk)
        elif dev.type == "cuda":
            if dev == home:
                _launch([parts[k] for k in ks], xk, y, [first[k] for k in ks])
            else:
                local = [0]
                for k in ks:
                    local.append(local[-1] + parts[k][1].shape[0])
                yk = torch.empty(local[-1] * TM, dtype=x.dtype, device=dev)
                _launch([parts[k] for k in ks], xk, yk, local[:-1])
                for k, a, b in zip(ks, local[:-1], local[1:]):
                    y[first[k] * TM : first[k + 1] * TM].copy_(yk[a * TM : b * TM])
            tile_matvec_sharded.launches += 1
        else:
            raise ValueError(f"tile_matvec_sharded runs on cuda or cpu tensors, got {dev}")
    return y


tile_matvec_sharded.launches = 0
