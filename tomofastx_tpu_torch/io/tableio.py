"""Whitespace-table load/save: native fast path with numpy fallback.

All ASCII fixture formats (model grids 9/10/12-col, model values, data
points, ADMM bounds, weights) are whitespace tables with a small header
(reference readers: model_IO.F90:135-241, data_gravmag.f90:204-239).
`load_table`/`save_table` route through the multithreaded C++ scanner
(io/_native/fasttab.cpp, built into build/ at first use) and fall back to
np.loadtxt / np.savetxt where it cannot be built, which load_table reports
once on stderr. The values are identical either way (strtod and numpy
parse the same decimal grammar; the writer formats with the same printf
pattern), and so are the files: byte for byte those of np.savetxt and of
the JAX package's writer.
"""

from __future__ import annotations

import ctypes
import os
import sys
import weakref

import numpy as np

from tomofastx_tpu_torch.io import _native

_reported = False


def _native_lib():
    """The native library, or None; the first miss is reported on stderr."""
    global _reported
    lib = _native.lib()
    if lib is None and not _reported:
        _reported = True
        print(f"tableio: the native table reader is unavailable ({_native.build_error()}); "
              "tables are read and written with numpy", file=sys.stderr, flush=True)
    return lib


def load_table(path: str, skiprows: int = 0, ndmin: int = 2) -> np.ndarray:
    """All floats in `path` after `skiprows` lines, reshaped to rows by
    the first data line's column count (np.loadtxt semantics: uniform
    columns, '#' comments, blank lines ignored)."""
    lib = _native_lib()
    if lib is not None:
        n = ctypes.c_long()
        ptr = lib.ft_parse_file(os.fspath(path).encode(), ctypes.c_long(skiprows), ctypes.byref(n))
        if n.value > 0 and ptr:
            # The array views the parse buffer, and a finalizer frees it once
            # every view is gone: a copy would double the peak memory of a
            # large table.
            flat = np.ctypeslib.as_array(ptr, shape=(n.value,))
            weakref.finalize(flat, lib.ft_free, ptr)
            ncols = _first_row_width(path, skiprows)
            if ncols > 0 and flat.size % ncols == 0:
                table = flat.reshape(-1, ncols)
                if ndmin <= 1 and 1 in table.shape:
                    return table.reshape(-1)
                return table
            # A ragged table: numpy below raises its own error.
        elif n.value == 0:
            return np.empty((0, 0)) if ndmin >= 2 else np.empty((0,))
        # n < 0 is an I/O error: numpy below raises the right exception.
    with open(path, "r") as f:
        for _ in range(skiprows):
            f.readline()
        return np.loadtxt(f, ndmin=ndmin)


def _first_row_width(path: str, skiprows: int) -> int:
    with open(path, "r") as f:
        for _ in range(skiprows):
            f.readline()
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                return len(line.replace(",", " ").split())
    return 0


def save_table(path: str, data: np.ndarray, fmt: str = "%.9E",
               header: str | None = None) -> None:
    """Write `data` one space-separated row per line; `header` (no
    trailing newline needed) is written first when given. `fmt` is a
    single printf spec applied to every column, or a space-separated
    row format with one spec per column (np.savetxt semantics).
    Byte-identical to ``np.savetxt(f, data, fmt=fmt)``."""
    data = np.ascontiguousarray(np.atleast_2d(np.asarray(data, np.float64)))
    specs = fmt.split()
    if len(specs) == 1:
        specs = specs * data.shape[1]
    lib = _native_lib()
    if lib is not None and len(specs) == data.shape[1] and all(s.count("%") == 1 for s in specs):
        if header is not None:
            with open(path, "w") as f:
                f.write(header if header.endswith("\n") else header + "\n")
        rc = lib.ft_write_table(
            os.fspath(path).encode(),
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_long(data.shape[0]), ctypes.c_long(data.shape[1]),
            b"\0".join(s.encode() for s in specs) + b"\0",
            ctypes.c_int(1 if header is not None else 0),
        )
        if rc == 0:
            return
        # A failed native write: numpy writes the whole file again below.
    with open(path, "w") as f:
        if header is not None:
            f.write(header if header.endswith("\n") else header + "\n")
        np.savetxt(f, data, fmt=fmt)
