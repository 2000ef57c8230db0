"""Tile-union block-sparse sensitivity operator (capacity mode).

Both LSQR directions as tile-union contractions (see ops/tile_matvec.py for
the layout and the kernel):

- forward (S @ x): row tiles over observations, 128-blocks over the
  wavelet-column axis;
- adjoint (S^T @ u): row tiles over wavelet columns, 128-blocks over the
  observation axis — a second pack of S^T, so both directions are
  gather-free streaming reads (the reference's column-sharded adjoint is
  similarly "free by construction", lsqr_solver2.F90:228-245).

Packing is streaming: `TileKernelBuilder` consumes the nonzeros of row
chunks (from the sensit cache reader) in two passes and never materializes
the dense matrix. The usage scan, the slot maps and the value scatter are
tensor operations on the packer's device, with the same shift/mask index
arithmetic as the JAX package's host packer, so the packs are equal to its
arrays entry for entry.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tomofastx_tpu_torch.ops.sparse_kernel import pad_axis
from tomofastx_tpu_torch.ops.tile_matvec import BLOCK, TM, tile_matvec, tile_matvec_sharded


@dataclass
class TileKernel:
    """Block-sparse operator (nrows x ncols), tile-union packed both ways."""

    uvals: torch.Tensor  # (ntiles_r, BU, TM, 128) forward values
    ubidx: torch.Tensor  # (ntiles_r, BU) int32 column-block ids
    uvalsT: torch.Tensor  # (ntiles_c, BUT, TM, 128) adjoint values
    ubidxT: torch.Tensor  # (ntiles_c, BUT) int32 row-block ids
    nrows: int
    ncols: int

    def __post_init__(self):
        # The kernel trusts the block ids it is given: hold them to the
        # vector's length once, here, where a pack enters from outside.
        for name, ub, n_in in (("ubidx", self.ubidx, self.ncols), ("ubidxT", self.ubidxT, self.nrows)):
            nblocks = max(1, -(-n_in // BLOCK))
            if ub.numel() and not (0 <= int(ub.min()) and int(ub.max()) < nblocks):
                raise ValueError(f"{name} holds block ids outside [0, {nblocks})")

    @staticmethod
    def _contract(uvals, ubidx, x, n_in, n_out):
        return tile_matvec(uvals, ubidx, _pad_to_blocks(x, n_in))[:n_out]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._contract(self.uvals, self.ubidx, x, self.ncols, self.nrows)

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        return self._contract(self.uvalsT, self.ubidxT, u, self.nrows, self.ncols)

    @property
    def nbytes(self) -> int:
        return sum(
            a.numel() * a.element_size()
            for a in (self.uvals, self.ubidx, self.uvalsT, self.ubidxT)
        )


def _pad_to_blocks(x, n_in):
    # The vector pads to whole 128-blocks; the rows pad to whole tiles in the
    # pack, and each product's output is cut back to its length.
    if x.shape[0] != n_in:
        raise ValueError(f"vector has {x.shape[0]} entries, operator expects {n_in}")
    npad = (-n_in) % BLOCK
    return torch.nn.functional.pad(x, (0, npad)) if npad else x


def pad_tiles_for_mesh(tk: TileKernel, n: int) -> TileKernel:
    """Pad both packs' tile axes to a multiple of n slots (JAX:
    tomofastx_tpu/ops/tile_kernel.py::pad_tiles_for_mesh). Padding tiles have
    block id 0 and zero values; their output rows land beyond nrows/ncols
    and each product cuts them off. Returns tk itself when both tile axes
    divide already."""
    if tk.uvals.shape[0] % n == 0 and tk.uvalsT.shape[0] % n == 0:
        return tk
    return TileKernel(
        uvals=pad_axis(tk.uvals, 0, n), ubidx=pad_axis(tk.ubidx, 0, n),
        uvalsT=pad_axis(tk.uvalsT, 0, n), ubidxT=pad_axis(tk.ubidxT, 0, n),
        nrows=tk.nrows, ncols=tk.ncols,
    )


def _cut_tiles(uvals, ubidx, slots):
    """One (uvals_k, ubidx_k) part per slot, tile axis cut into equal runs.
    A part's values are a view of the pack when the slot is on the pack's
    device and every slot is (one card holding several slots: no memory
    spent); otherwise each part is a tensor of its own on its slot's device,
    so that the whole pack can be freed. The block ids are always copied: a
    view of them would be 16-byte aligned only when the run's length times
    BU is a multiple of 4, and the kernel refuses a misaligned array."""
    n = len(slots)
    per = uvals.shape[0] // n
    own = any(dev != uvals.device for dev in slots)
    return [
        (uvals[k * per : (k + 1) * per].to(dev, copy=own), ubidx[k * per : (k + 1) * per].to(dev, copy=True))
        for k, dev in enumerate(slots)
    ]


@dataclass
class ShardedTileKernel:
    """A TileKernel placed on a mesh: both packs cut along their tile axis
    into one part per slot (the forward pack by observation-row tiles, the
    reference's data-row split, sensitivity_gravmag.F90:179-189; the adjoint
    pack by cell-column tiles, the column-sharded adjoint,
    lsqr_solver2.F90:228-245). Every product runs tile_matvec_sharded:
    vectors come and go on the home device. Built by shard_kernel from a
    TileKernel whose row weights are applied already."""

    parts: list  # [(uvals_k, ubidx_k)] forward pack
    partsT: list  # [(uvalsT_k, ubidxT_k)] adjoint pack
    nrows: int
    ncols: int
    mesh: object  # parallel.mesh.Mesh

    @classmethod
    def shard(cls, tk: TileKernel, slots, mesh) -> "ShardedTileKernel":
        tk = pad_tiles_for_mesh(tk, len(slots))
        return cls(
            parts=_cut_tiles(tk.uvals, tk.ubidx, slots),
            partsT=_cut_tiles(tk.uvalsT, tk.ubidxT, slots),
            nrows=tk.nrows, ncols=tk.ncols, mesh=mesh,
        )

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return tile_matvec_sharded(self.parts, _pad_to_blocks(x, self.ncols), self.mesh.home)[: self.nrows]

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        return tile_matvec_sharded(self.partsT, _pad_to_blocks(u, self.nrows), self.mesh.home)[: self.ncols]

    def slot_bytes(self) -> list:
        return [
            sum(a.numel() * a.element_size() for a in (*self.parts[k], *self.partsT[k]))
            for k in range(len(self.parts))
        ]


class TileKernelBuilder:
    """Two-pass streaming packer on one device.

    Pass 1 (`scan_coo` per batch of nonzeros, then `finalize_scan`):
    block-usage bitmaps for both orientations -> tile widths + slot index
    maps. Pass 2 (`fill_coo` per batch, then `build`): write values.

    The same nonzeros must be replayed in both passes (e.g. two passes over
    the sensit cache).
    """

    def __init__(self, nrows: int, ncols: int, device="cuda"):
        self.nrows, self.ncols = nrows, ncols
        self.device = torch.device(device)
        self.ntr = (nrows + TM - 1) // TM
        self.ntc = (ncols + TM - 1) // TM
        self.nbr = (nrows + BLOCK - 1) // BLOCK  # row blocks (adjoint axis)
        self.nbc = (ncols + BLOCK - 1) // BLOCK  # col blocks (forward axis)
        self.used_f = torch.zeros((self.ntr, self.nbc), dtype=torch.bool, device=self.device)
        self.used_a = torch.zeros((self.ntc, self.nbr), dtype=torch.bool, device=self.device)
        self._scanned = False

    def _coords(self, r, c):
        r = torch.as_tensor(r, device=self.device).to(torch.int64)
        c = torch.as_tensor(c, device=self.device).to(torch.int64)
        return r, c

    # ---- pass 1 ----
    def scan_coo(self, r, c):
        """Record block usage for nonzeros at (row r[i], col c[i]) — over an
        arbitrary batch of entries, in any order. TM = 8 and BLOCK = 128
        are powers of two, hence the shifts."""
        r, c = self._coords(r, c)
        self.used_f[r >> 3, c >> 7] = True
        self.used_a[c >> 3, r >> 7] = True

    def scan_chunk(self, rows, start_row: int):
        """rows: (B, ncols) dense row slab (transient); records block usage."""
        rr, cc = torch.nonzero(torch.as_tensor(rows, device=self.device), as_tuple=True)
        self.scan_coo(start_row + rr, cc)

    def finalize_scan(self):
        counts_f = self.used_f.sum(dim=1)
        counts_a = self.used_a.sum(dim=1)
        self.BU = max(1, int(counts_f.max())) if counts_f.numel() else 1
        self.BUT = max(1, int(counts_a.max())) if counts_a.numel() else 1
        # Slot index maps: (tile, block) -> slot position or -1.
        self.slot_f, self.ubidx = _slots_from_usage(self.used_f, counts_f, self.BU)
        self.slot_a, self.ubidxT = _slots_from_usage(self.used_a, counts_a, self.BUT)
        self.uvals = torch.zeros(
            (self.ntr, self.BU, TM, BLOCK), dtype=torch.float32, device=self.device
        )
        self.uvalsT = torch.zeros(
            (self.ntc, self.BUT, TM, BLOCK), dtype=torch.float32, device=self.device
        )
        self._scanned = True

    # ---- pass 2 ----
    def fill_coo(self, r, c, v):
        """Write values for nonzeros at (r[i], c[i]); entries must be unique
        (each (r, c) written once), any order. One flat-index scatter per
        orientation."""
        if not self._scanned:
            raise RuntimeError("fill_coo before finalize_scan")
        r, c = self._coords(r, c)
        v = torch.as_tensor(v, device=self.device).to(torch.float32)
        # Forward: row r -> (tile r//8, slot of col block c//128, lane r%8,
        # lane c%128).
        t = r >> 3
        slot = self.slot_f[t, c >> 7].to(torch.int64)
        flat = ((t * self.BU + slot) << 3 | (r & 7)) << 7 | (c & 127)
        self.uvals.view(-1)[flat] = v
        # Adjoint: column c -> (tile c//8, slot of row block r//128, lane
        # c%8, lane r%128).
        tc = c >> 3
        slota = self.slot_a[tc, r >> 7].to(torch.int64)
        flata = ((tc * self.BUT + slota) << 3 | (c & 7)) << 7 | (r & 127)
        self.uvalsT.view(-1)[flata] = v

    def fill_chunk(self, rows, start_row: int):
        rows = torch.as_tensor(rows, device=self.device)
        rr, cc = torch.nonzero(rows, as_tuple=True)
        self.fill_coo(start_row + rr, cc, rows[rr, cc])

    def build(self) -> TileKernel:
        return TileKernel(
            uvals=self.uvals,
            ubidx=self.ubidx,
            uvalsT=self.uvalsT,
            ubidxT=self.ubidxT,
            nrows=self.nrows,
            ncols=self.ncols,
        )


def _slots_from_usage(used: torch.Tensor, counts: torch.Tensor, width: int):
    """(ntiles, nblocks) usage bitmap -> (slot map (ntiles, nblocks) int32
    with -1 for unused, ubidx (ntiles, width) int32 padded with 0)."""
    ntiles, nblocks = used.shape
    # Stable argsort of ~used puts each tile's used block ids first, ascending.
    order = torch.argsort((~used).to(torch.uint8), dim=1, stable=True)
    pos = torch.arange(nblocks, device=used.device).expand(ntiles, nblocks)
    mask = pos < counts[:, None]
    # order is a permutation of each row, so the scatter writes every entry:
    # the slot position for a used block, -1 for an unused one.
    slot = torch.empty((ntiles, nblocks), dtype=torch.int32, device=used.device)
    slot.scatter_(1, order, torch.where(mask, pos, -1).to(torch.int32))
    ubidx = torch.where(mask[:, :width], order[:, :width], 0).to(torch.int32)
    return slot, ubidx.contiguous()


def pack_tiles(S, device="cuda") -> TileKernel:
    """Convenience non-streaming pack from a dense matrix (tests)."""
    S = torch.as_tensor(np.asarray(S), device=device)
    b = TileKernelBuilder(S.shape[0], S.shape[1], device=device)
    b.scan_chunk(S, 0)
    b.finalize_scan()
    b.fill_chunk(S, 0)
    return b.build()


def tile_kernel_from_cache(cache_dir: str, par, grid, device="cuda") -> tuple:
    """Stream a sensit cache (any nbproc) into a TileKernel on `device` —
    two streamed passes, dense matrix never materialized. Returns
    (TileKernel, meta), or (None, None) when there is no cache."""
    from tomofastx_tpu_torch.io.sensit_cache import iter_cache_coo, read_cache_meta

    meta = read_cache_meta(cache_dir, par, grid)
    if meta is None:
        return None, None
    N = meta["nx"] * meta["ny"] * meta["nz"]
    b = TileKernelBuilder(meta["nd"] * meta["ndc"], meta["nmc"] * N, device=device)
    for r, c, _ in iter_cache_coo(cache_dir, meta, b.device, with_vals=False):
        b.scan_coo(r, c)
    b.finalize_scan()
    nnz = 0
    for r, c, v in iter_cache_coo(cache_dir, meta, b.device):
        b.fill_coo(r, c, v)
        nnz += c.shape[0]
    meta["nnz"] = nnz
    return b.build(), meta


def apply_row_weights_tiled(tk: TileKernel, wrow) -> TileKernel:
    """Bake per-row weights into both packs (sensitivity_gravmag.F90:836-843
    semantics). wrow: (nrows,). The packs are scaled in place — a second
    copy of a multi-GB pack would double the peak memory — so `tk` must not
    be used afterwards; the returned kernel shares its storage."""
    w = np.asarray(wrow, np.float32).reshape(-1)
    if w.shape[0] != tk.nrows:
        raise ValueError(f"{w.shape[0]} row weights for {tk.nrows} rows")
    device = tk.uvals.device
    ntr = tk.uvals.shape[0]
    w_pad = np.zeros(ntr * TM, np.float32)
    w_pad[: tk.nrows] = w
    wf = torch.as_tensor(w_pad.reshape(ntr, 1, TM, 1), device=device)
    # Adjoint values are indexed (col tile, row-block slot, col lane, row
    # lane): weight by the row id = ubidxT * 128 + lane.
    nbr_pad = ((tk.nrows + BLOCK - 1) // BLOCK) * BLOCK
    w_rows = np.zeros(nbr_pad, np.float32)
    w_rows[: tk.nrows] = w
    w_blocks = torch.as_tensor(w_rows.reshape(-1, BLOCK), device=device)  # (nbr, 128)
    wa = w_blocks[tk.ubidxT.long()][:, :, None, :]  # (ntc, BUT, 1, 128)
    return TileKernel(
        uvals=tk.uvals.mul_(wf),
        ubidx=tk.ubidx,
        uvalsT=tk.uvalsT.mul_(wa),
        ubidxT=tk.ubidxT,
        nrows=tk.nrows,
        ncols=tk.ncols,
    )
