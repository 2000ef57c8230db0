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

Ported so far: the streaming writer, the metadata reader and the row
iterator. The rows are read back by ops/tile_kernel.py, which packs them
into the tile-union layout without materializing the dense matrix.
"""

from __future__ import annotations

import os
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
