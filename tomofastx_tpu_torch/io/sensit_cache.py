"""Sensitivity-kernel disk cache, byte-compatible with the reference.

File set (reference: sensitivity_gravmag.F90:139-183, 305-392, 644-883):
- ``sensit_{grav|magn}_<nbproc>_<rank>``: stream binary; header of 5 int32
  (ndata_loc, ndata, nelements_total, myrank, nbproc); then per data row and
  per (data component d, model component k): int32 (idata, nel, k, d)
  followed by int32 columns[nel] (1-based cell indices) and float32
  values[nel];
- ``sensit_{}_meta.txt``: text metadata;
- ``sensit_{}_nnz``: int32 N + int32 per-cell nnz histogram;
- ``sensit_{}_weight``: int32 N + float64 column weights.

This makes kernels produced by the Fortran reference, and by the JAX
package beside this one, directly loadable (``sensit.readFromFiles = 1``)
and vice versa. We always write a single "rank" file (nbproc = 1); the
reader accepts any rank count.

Three reader paths, all fed by one batched stream of the records
(``iter_cache_coo``), whose scatters run on the reader's device:
- ``try_read_kernel_cache``: materializes the dense kernel;
- ``read_kernel_cache_packed``: streams the records into the packed top-k
  layout (ops/sparse_kernel.py) without allocating the dense (nd, N) array —
  the counterpart of the reference's row-streamed re-read into distributed
  CSR (sensitivity_gravmag.F90:723-862), whose memory is nnz-bound;
- ``ops/tile_kernel.py::tile_kernel_from_cache``: the tile-union layout,
  likewise without the dense matrix.
"""

from __future__ import annotations

import os
from types import SimpleNamespace
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

_SUFFIX = ("grav", "magn")
_MATRIX_PRECISION_BYTES = 4  # float32 storage, like the reference default


def _suffix_for(par) -> str:
    from tomofastx_tpu_torch.config.parfile import MagParams

    return _SUFFIX[1] if isinstance(par, MagParams) else _SUFFIX[0]


class SensitStreamWriter:
    """Row-streaming cache writer: rows go to disk as they are built, so
    the writer's memory footprint is one chunk, never the full kernel
    (reference: per-rank file written inside the build hot loop,
    sensitivity_gravmag.F90:306-309)."""

    def __init__(self, cache_dir: str, par, grid, column_weight: np.ndarray,
                 compression_type: int):
        os.makedirs(cache_dir, exist_ok=True)
        self.cache_dir = cache_dir
        self.sfx = _suffix_for(par)
        self.par = par
        self.nx, self.ny, self.nz = grid.nx, grid.ny, grid.nz
        self.N = grid.nelements_total
        self.nd = par.ndata
        self.ndc = par.ndata_components
        self.nmc = par.nmodel_components
        self.compression_type = compression_type
        self.column_weight = np.asarray(column_weight, np.float64)
        self.nnz_per_cell = np.zeros(self.N, np.int32)
        self.nnz_total = 0
        self._rows_written = 0
        self._f = open(os.path.join(cache_dir, f"sensit_{self.sfx}_1_0"), "wb")
        np.array([self.nd, self.nd, self.N, 0, 1], np.int32).tofile(self._f)

    def write_chunk(self, chunk, start_row: int):
        """chunk: (B, ndc, nmc, N) float32 rows for observations
        [start_row, start_row + B), a tensor on any device or a numpy
        array. The rows are compacted where the chunk lies, so only the
        kept columns and values cross to the host."""
        if start_row != self._rows_written:
            raise ValueError("rows must stream in order")
        chunk = torch.as_tensor(chunk)
        B = chunk.shape[0]
        # One record per (observation, data component, model component), in
        # the file's order.
        flat = chunk.reshape(B * self.ndc * self.nmc, self.N)
        if self.compression_type == 0:
            # Uncompressed rows store every element, including zeros
            # (sensitivity_gravmag.F90:287-294).
            counts = np.full(flat.shape[0], self.N, np.int64)
            cols1 = np.tile(np.arange(1, self.N + 1, dtype=np.int32), flat.shape[0])
            vals = flat.to(torch.float32).cpu().numpy().reshape(-1)
            self.nnz_per_cell += flat.shape[0]
        else:
            mask = flat != 0
            counts = mask.sum(dim=1).cpu().numpy()
            # Row-major order: by record, then by ascending column.
            cc = torch.nonzero(mask, as_tuple=True)[1]
            vals = flat[mask].to(torch.float32).cpu().numpy()
            cols1 = (cc + 1).to(torch.int32).cpu().numpy()  # 1-based cell indices
            self.nnz_per_cell += torch.bincount(cc, minlength=self.N).to(torch.int32).cpu().numpy()
        self.nnz_total += int(counts.sum())
        ends = np.cumsum(counts)
        for rec in range(flat.shape[0]):
            b, dk = divmod(rec, self.ndc * self.nmc)
            d, k = divmod(dk, self.nmc)
            n, e = int(counts[rec]), int(ends[rec])
            np.array([start_row + b + 1, n, k + 1, d + 1], np.int32).tofile(self._f)
            if n:
                cols1[e - n : e].tofile(self._f)
                vals[e - n : e].tofile(self._f)
        self._rows_written += B

    def close(self):
        """Close the row file (finalize does; call it when a build fails)."""
        self._f.close()

    def finalize(self, comp_error: float):
        """Close the row file and write meta + nnz + weight files."""
        self.close()
        if self._rows_written != self.nd:
            raise ValueError(
                f"sensit cache incomplete: {self._rows_written}/{self.nd} rows"
            )
        with open(os.path.join(self.cache_dir, f"sensit_{self.sfx}_meta.txt"), "w") as f:
            f.write(f" {self.nx} {self.ny} {self.nz} {self.nd}\n")
            f.write(f" 1 {_MATRIX_PRECISION_BYTES} {self.par.depth_weighting_type}\n")
            f.write(f" {self.compression_type} {comp_error:.9E}\n")
            f.write(f" {self.nmc} {self.ndc}\n")
            f.write(f" {self.nnz_total}\n")
        with open(os.path.join(self.cache_dir, f"sensit_{self.sfx}_nnz"), "wb") as f:
            np.array([self.N], np.int32).tofile(f)
            self.nnz_per_cell.tofile(f)
        with open(os.path.join(self.cache_dir, f"sensit_{self.sfx}_weight"), "wb") as f:
            np.array([self.N], np.int32).tofile(f)
            self.column_weight.tofile(f)


def read_cache_meta(cache_dir: str, par, grid) -> Optional[dict]:
    """Read + validate the metadata file. Returns None when absent; raises
    on inconsistency (the reference's consistency checks,
    sensitivity_gravmag.F90:974-1037)."""
    sfx = _suffix_for(par)
    meta_path = os.path.join(cache_dir, f"sensit_{sfx}_meta.txt")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        nx, ny, nz, nd = (int(t) for t in f.readline().split())
        nbproc, precision, weight_type = (int(t) for t in f.readline().split())
        toks = f.readline().split()
        compression_type, comp_error = int(toks[0]), float(toks[1])
        nmc, ndc = (int(t) for t in f.readline().split())
        nnz_total = int(f.readline().split()[0])

    if (nx, ny, nz) != (grid.nx, grid.ny, grid.nz) or nd != par.ndata:
        raise ValueError("Sensitivity metadata file info does not match the Parfile!")
    if weight_type != par.depth_weighting_type:
        raise ValueError("Sensitivity metadata depth weighting type mismatch!")
    if compression_type != par.compression_type:
        raise ValueError("Compression type is inconsistent!")
    if nmc != par.nmodel_components or ndc != par.ndata_components:
        raise ValueError("Sensitivity metadata component counts mismatch!")
    if precision != _MATRIX_PRECISION_BYTES:
        raise ValueError("Matrix precision is not consistent!")
    return dict(
        nx=nx, ny=ny, nz=nz, nd=nd, nbproc=nbproc,
        compression_type=compression_type, comp_error=comp_error,
        nmc=nmc, ndc=ndc, nnz_total=nnz_total, sfx=sfx,
    )


def iter_cache_rows(cache_dir: str, meta: dict) -> Iterator[Tuple[int, int, int, np.ndarray, np.ndarray]]:
    """Stream (idata_0based, d, k, cols_0based, vals) over all rank files in
    global row order — the reference's per-row re-read loop
    (sensitivity_gravmag.F90:755-830). Memory: one row at a time."""
    nd, N, ndc, nmc = meta["nd"], meta["nx"] * meta["ny"] * meta["nz"], meta["ndc"], meta["nmc"]
    nbproc, sfx = meta["nbproc"], meta["sfx"]
    idata_glob = 0
    for rank in range(nbproc):
        path = os.path.join(cache_dir, f"sensit_{sfx}_{nbproc}_{rank}")
        # The file is mapped and the records sliced out of it: every word of
        # it is a 4-byte int or float, and a read call per record field costs
        # more than the copy.
        words = np.memmap(path, dtype=np.int32, mode="r")
        ndata_loc, ndata_read, N_read, rank_read, nbproc_read = (int(v) for v in words[:5])
        if ndata_read != nd or N_read != N or rank_read != rank or nbproc_read != nbproc:
            raise ValueError("Wrong file header in sensitivity cache!")
        pos = 5
        for _ in range(ndata_loc):
            idata_glob += 1
            for d in range(ndc):
                for k in range(nmc):
                    idata, nel, k_read, d_read = (int(v) for v in words[pos : pos + 4])
                    pos += 4
                    if idata != idata_glob or k_read != k + 1 or d_read != d + 1:
                        raise ValueError("Wrong data ordering in sensitivity cache!")
                    if pos + 2 * nel > words.shape[0]:
                        raise ValueError("Sensitivity cache file is cut short!")
                    cols = np.asarray(words[pos : pos + nel]) - 1
                    vals = np.array(words[pos + nel : pos + 2 * nel].view(np.float32))
                    pos += 2 * nel
                    yield idata - 1, d, k, cols, vals
        del words
    if idata_glob != nd:
        raise ValueError("Sensitivity cache row count mismatch across ranks!")


def write_kernel_cache(cache_dir: str, par, kernel, column_weight: np.ndarray):
    """Write a dense SensitKernel through the stream writer, in row chunks
    that the writer compacts where the kernel lies: only the kept columns
    and values cross to the host. The cache is a float32 format: a bfloat16
    kernel is refused (its rounded values would pass for float32 ones in a
    later run that reads the cache)."""
    if kernel.S.dtype == torch.bfloat16:
        raise ValueError("the sensitivity cache is a float32 format; a bfloat16 kernel is not written to it")
    nd, ndc, nmc = kernel.ndata, kernel.ndata_components, kernel.nmodel_components
    grid = SimpleNamespace(nx=kernel.nx, ny=kernel.ny, nz=kernel.nz, nelements_total=kernel.N)
    w = SensitStreamWriter(cache_dir, par, grid, column_weight, kernel.compression_type)
    # At most 64M entries per chunk: the compaction's masks and index lists
    # stay a fraction of a GB.
    chunk = max(1, min(nd, (1 << 26) // max(ndc * nmc * kernel.N, 1)))
    try:
        for s in range(0, nd, chunk):
            e = min(s + chunk, nd)
            w.write_chunk(kernel.S[s * ndc : e * ndc].reshape(e - s, ndc, nmc, kernel.N), s)
    finally:
        w.close()
    w.finalize(kernel.comp_error)


def iter_cache_coo(cache_dir: str, meta: dict, device="cuda", with_vals: bool = True,
                   flush: int = 16 << 20):
    """Stream the cache's entries in file order as batches of coordinates on
    `device`: yields (r, c, v) with r = idata * ndc + d the matrix row
    (int64), c = k * N + cell the matrix column (int64) and v the float32
    values (None unless with_vals). Whole records are gathered on the host
    into batches of about `flush` entries; each batch crosses to the device
    once, where the row id of every entry is rebuilt from the per-record
    counts."""
    ndc, nmc = meta["ndc"], meta["nmc"]
    N = meta["nx"] * meta["ny"] * meta["nz"]
    # Column ids cross as int32 where they fit; they are widened on the device.
    col_dtype = np.int32 if nmc * N < 2**31 else np.int64

    def batch(rows, counts, buf_c, buf_v):
        cnt = torch.as_tensor(np.asarray(counts, np.int64), device=device)
        r = torch.repeat_interleave(torch.as_tensor(np.asarray(rows, np.int64), device=device), cnt)
        c = torch.as_tensor(np.concatenate(buf_c), device=device).to(torch.int64)
        v = torch.as_tensor(np.concatenate(buf_v), device=device) if with_vals else None
        return r, c, v

    rows, counts, buf_c, buf_v, size = [], [], [], [], 0
    for idata, d, k, cols, vals in iter_cache_rows(cache_dir, meta):
        rows.append(idata * ndc + d)
        counts.append(cols.size)
        buf_c.append(cols.astype(col_dtype, copy=False) + col_dtype(k * N))
        if with_vals:
            buf_v.append(vals)
        size += cols.size
        if size >= flush:
            yield batch(rows, counts, buf_c, buf_v)
            rows, counts, buf_c, buf_v, size = [], [], [], [], 0
    if size:
        yield batch(rows, counts, buf_c, buf_v)


def try_read_kernel_cache(cache_dir: str, par, grid, device="cuda"):
    """Read a reference-format kernel cache into a dense SensitKernel whose
    S lies on `device`: the records are scattered there, batch by batch.
    Returns None when the cache is absent."""
    from tomofastx_tpu_torch.ops.sensitivity import SensitKernel

    meta = read_cache_meta(cache_dir, par, grid)
    if meta is None:
        return None
    nd, ndc, nmc = meta["nd"], meta["ndc"], meta["nmc"]
    N = meta["nx"] * meta["ny"] * meta["nz"]
    ncols = nmc * N

    S = torch.zeros((nd * ndc, ncols), dtype=torch.float32, device=device)
    flat = S.view(-1)
    nnz = 0
    for r, c, v in iter_cache_coo(cache_dir, meta, device):
        flat[r * ncols + c] = v
        nnz += c.shape[0]

    return SensitKernel(
        S=S,
        ndata=nd,
        ndata_components=ndc,
        nmodel_components=nmc,
        nx=meta["nx"],
        ny=meta["ny"],
        nz=meta["nz"],
        compression_type=meta["compression_type"],
        comp_error=meta["comp_error"],
        nnz=nnz,
    )


def read_kernel_cache_packed(
    cache_dir: str, par, grid,
    pad_multiple: int = 8,
    col_cap_factor: float = 4.0,
    device="cuda",
):
    """Stream a reference-format cache directly into the packed top-k
    layout (PackedKernel) on `device`, never materializing the dense
    (nd, N) array.

    Two streaming passes over the row files:
    1. per-row nnz (row pack width K) — the per-cell column histogram comes
       from the ``_nnz`` file the cache already carries (the reference's
       load-balancing input, sensitivity_gravmag.F90:378-392);
    2. fill the row pack + adjoint (heavy dense block / light column pack),
       one batch of records per scatter.

    Device memory: nnz*(4+4) for the row pack, the light column pack padded
    to its widest column, and the heavy dense block.
    Returns (PackedKernel, meta dict), or (None, None) without a cache."""
    from tomofastx_tpu_torch.ops.sparse_kernel import PackedKernel, _pad_to, heavy_light_split

    meta = read_cache_meta(cache_dir, par, grid)
    if meta is None:
        return None, None
    nd, ndc, nmc = meta["nd"], meta["ndc"], meta["nmc"]
    N = meta["nx"] * meta["ny"] * meta["nz"]
    nrows, ncols = nd * ndc, nmc * N
    sfx = meta["sfx"]
    device = torch.device(device)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    # Column histogram over matrix columns (k * N + cell). The _nnz file is
    # summed over model components, so for nmc > 1 it is rebuilt in pass 1.
    row_counts = zeros(nrows, torch.int64)
    if nmc == 1:
        with open(os.path.join(cache_dir, f"sensit_{sfx}_nnz"), "rb") as f:
            N_read = int(np.fromfile(f, np.int32, 1)[0])
            if N_read != N:
                raise ValueError("nnz histogram size mismatch!")
            col_counts = torch.as_tensor(np.fromfile(f, np.int32, N), device=device).to(torch.int64)
    else:
        col_counts = zeros(ncols, torch.int64)
    for r, c, _ in iter_cache_coo(cache_dir, meta, device, with_vals=False):
        row_counts += torch.bincount(r, minlength=nrows)
        if nmc > 1:
            col_counts += torch.bincount(c, minlength=ncols)

    nnz = int(row_counts.sum())
    K = _pad_to(int(row_counts.max()) if nrows else 1, pad_multiple)
    row_vals = zeros((nrows, K), torch.float32)
    row_idx = zeros((nrows, K), torch.int32)

    heavy, light = heavy_light_split(col_counts, nnz, ncols, col_cap_factor)
    # Map matrix column -> position in heavy block / light pack (-1 = none).
    heavy_pos = torch.full((ncols,), -1, dtype=torch.int64, device=device)
    heavy_pos[heavy] = torch.arange(heavy.numel(), device=device)
    light_pos = torch.full((ncols,), -1, dtype=torch.int64, device=device)
    light_pos[light] = torch.arange(light.numel(), device=device)

    dense_block = zeros((nrows, heavy.numel()), torch.float32)
    KT = _pad_to(int(col_counts[light].max()) if light.numel() else 1, pad_multiple)
    light_vals = zeros((light.numel(), KT), torch.float32)
    light_idx = zeros((light.numel(), KT), torch.int32)
    light_cursor = zeros(light.numel(), torch.int64)

    # A row's entries follow each other in the file, so an entry's slot in
    # the row pack is its running number in the file less the number of
    # entries in the rows before its own.
    row_start = torch.cumsum(row_counts, 0) - row_counts
    seen = 0
    for r, c, v in iter_cache_coo(cache_dir, meta, device):
        n = c.shape[0]
        # Row pack.
        p = torch.arange(seen, seen + n, device=device) - row_start[r]
        seen += n
        row_vals[r, p] = v
        row_idx[r, p] = c.to(torch.int32)
        # Heavy columns -> dense block.
        hp = heavy_pos[c]
        hsel = hp >= 0
        dense_block[r[hsel], hp[hsel]] = v[hsel]
        # Light columns -> column pack, appended per column in file order: a
        # stable sort by column numbers this batch's entries within each
        # column, after those that earlier batches put there.
        lp = light_pos[c]
        lsel = lp >= 0
        lcols, lrows, lv = lp[lsel], r[lsel], v[lsel]
        order = torch.argsort(lcols, stable=True)
        lcols, lrows, lv = lcols[order], lrows[order], lv[order]
        added = torch.bincount(lcols, minlength=light.numel())
        first = torch.cumsum(added, 0) - added
        pos = light_cursor[lcols] + torch.arange(lcols.shape[0], device=device) - first[lcols]
        light_vals[lcols, pos] = lv
        light_idx[lcols, pos] = lrows.to(torch.int32)
        light_cursor += added

    pk = PackedKernel(
        row_vals=row_vals,
        row_idx=row_idx,
        dense_cols=heavy.to(torch.int32),
        dense_block=dense_block,
        light_cols=light.to(torch.int32),
        light_vals=light_vals,
        light_idx=light_idx,
        nrows=nrows,
        ncols=ncols,
    )
    meta["nnz"] = nnz
    return pk, meta
