"""Binary legacy-VTK writers for Paraview visualization.

Byte-layout compatible with the reference (paraview.f90:83-588): same
headers, same structured/lego/points datasets, float32 payloads written in
native endianness via raw streams, Z axis optionally inverted (VTKs are
always in elevation space, Parameters_all.txt:25).
"""

from __future__ import annotations

import os

import numpy as np

_LF = b"\n"


def _i8(n: int) -> bytes:
    """Fortran '(i8)' fixed-width integer field."""
    return f"{n:8d}".encode()


def _open(path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return open(path, "wb")


def _header(f, dataset: bytes):
    f.write(b"# vtk DataFile Version 3.0" + _LF)
    f.write(b"Tomofast-x" + _LF)
    f.write(b"BINARY" + _LF)
    f.write(b"DATASET " + dataset + _LF)


def _component_names(f, invert_z: bool):
    """(reference: add_component_names) metadata naming vector components."""
    f.write(_LF + _LF + b"METADATA" + _LF)
    f.write(b"COMPONENT_NAMES" + _LF)
    f.write(b"X%20Axis" + _LF)
    f.write(b"Y%20Axis" + _LF)
    if invert_z:
        f.write(b"-Z%20Axis" + _LF)
    else:
        f.write(b"Z%20Axis" + _LF)


def _slice_mask(nx, ny, nz, i1, i2, j1, j2, k1, k2):
    """Boolean mask over flat (i-fastest) cells for a 1-based slice window."""
    p = np.arange(nx * ny * nz)
    i = p % nx + 1
    j = (p // nx) % ny + 1
    k = p // (nx * ny) + 1
    return (i >= i1) & (i <= i2) & (j >= j1) & (j <= j2) & (k >= k1) & (k <= k2)


def write_struct_grid(
    path, val, X1, Y1, Z1, X2, Y2, Z2, nx, ny, nz,
    i1=None, i2=None, j1=None, j2=None, k1=None, k2=None,
    invert_z=True, units_mult=1.0, label="rho",
):
    """STRUCTURED_GRID of cell centers with point-centered data
    (paraview.f90:83-232). val: (N, ncomponents)."""
    i1 = 1 if i1 is None else i1
    i2 = nx if i2 is None else i2
    j1 = 1 if j1 is None else j1
    j2 = ny if j2 is None else j2
    k1 = 1 if k1 is None else k1
    k2 = nz if k2 is None else k2

    val = np.atleast_2d(np.asarray(val))
    if val.shape[0] != nx * ny * nz:
        val = val.T
    ncomp = val.shape[1]

    mask = _slice_mask(nx, ny, nz, i1, i2, j1, j2, k1, k2)
    zsign = -1.0 if invert_z else 1.0
    centers = np.stack(
        [
            0.5 * (X1 + X2),
            0.5 * (Y1 + Y2),
            zsign * 0.5 * (Z1 + Z2),
        ],
        axis=0,
    ).astype(np.float32)[:, mask]

    data = (val[mask].T / units_mult).astype(np.float32)
    if ncomp == 3:
        data[2] *= zsign

    n = int(mask.sum())
    with _open(path) as f:
        _header(f, b"STRUCTURED_GRID")
        f.write(b"DIMENSIONS " + _i8(i2 - i1 + 1) + b" " + _i8(j2 - j1 + 1) + b" " + _i8(k2 - k1 + 1) + _LF)
        f.write(_LF + _LF + b"POINTS " + _i8(n) + b" FLOAT" + _LF)
        f.write(centers.T.reshape(-1).astype(np.float32).tobytes())  # (3, n) Fortran order = n points x,y,z
        f.write(_LF + _LF + b"POINT_DATA " + _i8(n) + _LF)
        if ncomp == 1:
            f.write(b"SCALARS " + label.encode() + b" FLOAT" + _LF)
            f.write(b"LOOKUP_TABLE default" + _LF)
        elif ncomp == 3:
            f.write(b"VECTORS " + label.encode() + b" FLOAT" + _LF)
        f.write(data.T.reshape(-1).astype(np.float32).tobytes())
        if ncomp == 3:
            _component_names(f, invert_z)


def write_lego_grid(
    path, val, X1, Y1, Z1, X2, Y2, Z2, nx, ny, nz,
    i1=None, i2=None, j1=None, j2=None, k1=None, k2=None,
    invert_z=True, units_mult=1.0, label="rho",
):
    """UNSTRUCTURED_GRID of VTK_VOXEL cells with cell-centered data
    (paraview.f90:239-449)."""
    i1 = 1 if i1 is None else i1
    i2 = nx if i2 is None else i2
    j1 = 1 if j1 is None else j1
    j2 = ny if j2 is None else j2
    k1 = 1 if k1 is None else k1
    k2 = nz if k2 is None else k2

    val = np.atleast_2d(np.asarray(val))
    if val.shape[0] != nx * ny * nz:
        val = val.T
    ncomp = val.shape[1]

    mask = _slice_mask(nx, ny, nz, i1, i2, j1, j2, k1, k2)
    zsign = -1.0 if invert_z else 1.0
    x1, x2 = X1[mask], X2[mask]
    y1, y2 = Y1[mask], Y2[mask]
    z1, z2 = zsign * Z1[mask], zsign * Z2[mask]
    n = int(mask.sum())

    # VTK_VOXEL corner order (paraview.f90:337-370).
    corners = np.empty((n, 8, 3), np.float32)
    for ci, (cx, cy, cz) in enumerate(
        [(x1, y1, z1), (x2, y1, z1), (x1, y2, z1), (x2, y2, z1),
         (x1, y1, z2), (x2, y1, z2), (x1, y2, z2), (x2, y2, z2)]
    ):
        corners[:, ci, 0] = cx
        corners[:, ci, 1] = cy
        corners[:, ci, 2] = cz

    data = (val[mask].T / units_mult).astype(np.float32)
    if ncomp == 3:
        data[2] *= zsign

    cells = np.empty((n, 9), np.int32)
    cells[:, 0] = 8
    cells[:, 1:] = np.arange(8 * n, dtype=np.int32).reshape(n, 8)

    with _open(path) as f:
        _header(f, b"UNSTRUCTURED_GRID")
        f.write(_LF)
        f.write(b"POINTS " + _i8(8 * n) + b" FLOAT" + _LF)
        f.write(corners.tobytes())
        f.write(_LF + _LF + b"CELLS " + _i8(n) + b" " + _i8(9 * n) + _LF)
        f.write(cells.tobytes())
        f.write(_LF + _LF + b"CELL_TYPES " + _i8(n) + _LF)
        f.write(np.full(n, 11, np.int32).tobytes())
        f.write(_LF + _LF + b"CELL_DATA " + _i8(n) + _LF)
        if ncomp == 1:
            f.write(b"SCALARS " + label.encode() + b" FLOAT" + _LF)
            f.write(b"LOOKUP_TABLE default" + _LF)
        elif ncomp == 3:
            f.write(b"VECTORS " + label.encode() + b" FLOAT" + _LF)
        f.write(data.T.reshape(-1).astype(np.float32).tobytes())
        if ncomp == 3:
            _component_names(f, invert_z)


def write_points(path, val, X, Y, Z, invert_z=True, units_mult=1.0):
    """Data points as VTK_VERTEX cells (paraview.f90:454-588).
    val: (ndata, ncomponents)."""
    val = np.atleast_2d(np.asarray(val))
    n = X.shape[0]
    if val.shape[0] != n:
        val = val.T
    ncomp = val.shape[1]

    xyz = np.stack([X, Y, -Z if invert_z else Z], axis=1).astype(np.float32)
    cells = np.empty((n, 2), np.int32)
    cells[:, 0] = 1
    cells[:, 1] = np.arange(n, dtype=np.int32)
    data = (val / units_mult).astype(np.float32)

    with _open(path) as f:
        _header(f, b"UNSTRUCTURED_GRID")
        f.write(_LF)
        f.write(b"POINTS " + _i8(n) + b" FLOAT" + _LF)
        f.write(xyz.tobytes())
        f.write(_LF + _LF + b"CELLS " + _i8(n) + b" " + _i8(2 * n) + _LF)
        f.write(cells.tobytes())
        f.write(_LF + _LF + b"CELL_TYPES " + _i8(n) + _LF)
        f.write(np.full(n, 1, np.int32).tobytes())
        f.write(_LF + _LF + b"POINT_DATA " + _i8(n) + _LF)
        if ncomp == 1:
            f.write(b"SCALARS F FLOAT" + _LF)
            f.write(b"LOOKUP_TABLE default" + _LF)
        elif ncomp == 3:
            f.write(b"VECTORS vectors FLOAT" + _LF)
        elif ncomp == 6:
            f.write(b"FIELD field 1" + _LF)
            f.write(b"gradi 6 " + _i8(n) + b" FLOAT" + _LF)
        f.write(data.tobytes())
        if ncomp == 3:
            _component_names(f, False)
