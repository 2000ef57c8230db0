"""Whitespace-table load/save.

All ASCII fixture formats (model grids 9/10/12-col, model values, data
points, ADMM bounds, weights) are whitespace tables with a small header
(reference readers: model_IO.F90:135-241, data_gravmag.f90:204-239).
`load_table`/`save_table` go through np.loadtxt / np.savetxt; the files are
byte-identical to the ones the native scanner of the JAX package writes
(it formats with the same printf pattern).
"""

from __future__ import annotations

import numpy as np


def load_table(path: str, skiprows: int = 0, ndmin: int = 2) -> np.ndarray:
    """All floats in `path` after `skiprows` lines, one row per line
    (np.loadtxt semantics: uniform columns, '#' comments, blank lines
    ignored)."""
    with open(path, "r") as f:
        for _ in range(skiprows):
            f.readline()
        return np.loadtxt(f, ndmin=ndmin)


def save_table(path: str, data: np.ndarray, fmt: str = "%.9E",
               header: str | None = None) -> None:
    """Write `data` one space-separated row per line; `header` (no
    trailing newline needed) is written first when given. `fmt` is a
    single printf spec applied to every column, or a space-separated
    row format with one spec per column (np.savetxt semantics)."""
    data = np.ascontiguousarray(np.atleast_2d(np.asarray(data, np.float64)))
    with open(path, "w") as f:
        if header is not None:
            f.write(header if header.endswith("\n") else header + "\n")
        np.savetxt(f, data, fmt=fmt)
