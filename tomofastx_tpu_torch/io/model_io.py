"""Model / grid / weights ASCII readers and writers.

File formats are byte-compatible with the reference (model_IO.F90):
- model grid: header line = N, then rows
  ``X1 X2 Y1 Y2 Z1 Z2 [extra cols] i j k`` with 9/10/12-column auto-detect
  (model_IO.F90:174-222);
- model values: header N, then one row of ncomponents values per cell
  (model_IO.F90:87-130);
- ADMM local bounds: header ``N nlithos``, rows ``min1 max1 ... minL maxL w``
  (model_IO.F90:312-380);
- damping-gradient weights: header N, rows ``wx wy wz`` (model_IO.F90:385-420);
- local damping / depth weights: header N, one value per row.
"""

from __future__ import annotations

import numpy as np

from tomofastx_tpu_torch.config.parfile import InversionParams
from tomofastx_tpu_torch.models.grid import Grid
from tomofastx_tpu_torch.models.model import ModelState


def _load_table(path: str, skiprows: int = 1) -> np.ndarray:
    """Whitespace table loader (2-D float array)."""
    from tomofastx_tpu_torch.io.tableio import load_table

    return load_table(path, skiprows=skiprows, ndmin=2)


def read_model_grid(path: str, nx: int, ny: int, nz: int, z_axis_dir: int = 1) -> Grid:
    """Read the model grid file (reference: read_model_grid, model_IO.F90:135-241).

    Auto-detects 9/10/12 columns; validates the i-j-k cell order (i fastest);
    flips the Z axis when z_axis_dir != 1.
    """
    N = nx * ny * nz
    with open(path, "r") as f:
        header = f.readline().split()
        n_read = int(header[0])
        if n_read != N:
            raise ValueError(
                f"Model grid file '{path}' has {n_read} cells, expected {N} ({nx}x{ny}x{nz})"
            )
    table = _load_table(path, skiprows=1)

    ncols = table.shape[1]
    if ncols not in (9, 10, 12):
        raise ValueError(f"Unexpected number of columns in model grid file: {ncols}")
    if table.shape[0] != N:
        raise ValueError(f"Model grid file has {table.shape[0]} rows, expected {N}")

    X1, X2, Y1, Y2, Z1, Z2 = (table[:, c].copy() for c in range(6))
    ir, jr, kr = (table[:, c].astype(int) for c in (ncols - 3, ncols - 2, ncols - 1))

    # Validate i-j-k ordering (i fastest).
    p = np.arange(N)
    i_exp = p % nx + 1
    j_exp = (p // nx) % ny + 1
    k_exp = p // (nx * ny) + 1
    if not (np.array_equal(ir, i_exp) and np.array_equal(jr, j_exp) and np.array_equal(kr, k_exp)):
        raise ValueError(
            "Wrong cell order in the model grid file! Use the i-j-k order (i is the fastest index)."
        )

    if np.any(X1 >= X2) or np.any(Y1 >= Y2) or np.any(Z1 >= Z2):
        raise ValueError("The grid is not correctly defined (X1 >= X2 or Y1 >= Y2 or Z1 >= Z2)!")

    if z_axis_dir != 1:
        Z1, Z2 = -Z2.copy(), -Z1.copy()

    return Grid(nx=nx, ny=ny, nz=nz, X1=X1, X2=X2, Y1=Y1, Y2=Y2, Z1=Z1, Z2=Z2, z_axis_dir=z_axis_dir)


def read_model_values(path: str, nelements_total: int, ncomponents: int = 1) -> np.ndarray:
    """Read model values file → (ncomponents, N)."""
    table = _load_table(path)
    if table.shape[0] != nelements_total:
        raise ValueError(
            f"Model file '{path}' has {table.shape[0]} rows, expected {nelements_total}"
        )
    if table.shape[1] < ncomponents:
        raise ValueError(
            f"Model file '{path}' has {table.shape[1]} columns, expected {ncomponents}"
        )
    return np.ascontiguousarray(table[:, :ncomponents].T)


def set_model(model: ModelState, model_type: int, model_val: float, model_file: str):
    """Set model from a constant or from file, then apply units conversion
    (reference: set_model, model_IO.F90:56-82)."""
    if model_type == 1:
        model.val = np.full_like(model.val, model_val)
    elif model_type == 2:
        model.val = read_model_values(model_file, model.nelements_total, model.ncomponents)
    else:
        raise ValueError(f"Unknown model type {model_type} in set_model!")
    model.val = model.val * model.units_mult


def write_model_ascii(model: ModelState, path: str):
    """Write the full model in the reference ASCII format
    (model_IO.F90:504-539): header N, then ncomponents values per row."""
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    from tomofastx_tpu_torch.io.tableio import save_table

    vals = (model.val / model.units_mult).T  # (N, ncomponents)
    save_table(path, vals, fmt="%.9E", header=f" {model.nelements_total}")


def read_bound_constraints(model: ModelState, path: str):
    """Read local ADMM bounds file (reference: model_IO.F90:312-380)."""
    with open(path, "r") as f:
        header = f.readline().split()
        n_read, nlithos_read = int(header[0]), int(header[1])
        if n_read != model.nelements_total:
            raise ValueError(f"Bounds file has {n_read} cells, expected {model.nelements_total}")
        if nlithos_read != model.nlithos:
            raise ValueError(f"Bounds file has {nlithos_read} lithologies, expected {model.nlithos}")
    table = _load_table(path, skiprows=1)

    L = model.nlithos
    if table.shape[1] < 2 * L + 1:
        raise ValueError("Bounds file must have 2*nlithos + 1 columns: min1 max1 ... w")
    model.min_bound = np.ascontiguousarray(table[:, 0 : 2 * L : 2].T)
    model.max_bound = np.ascontiguousarray(table[:, 1 : 2 * L : 2].T)
    model.bound_weight = table[:, 2 * L].copy()
    if np.any(model.min_bound > model.max_bound):
        raise ValueError("Wrong admm bounds: define bounds as: min1 max1 ... minN maxN.")


def set_model_bounds(ipar: InversionParams, model: ModelState, problem_index: int):
    """Set ADMM bounds from Parfile globals or a per-cell file
    (reference: set_model_bounds, model_IO.F90:273-307)."""
    model.allocate_bound_arrays(ipar.nlithos)
    if ipar.admm_bound_type == 1:
        bounds = ipar.admm_bounds[problem_index]
        if bounds is None:
            raise ValueError("ADMM enabled but no bounds given for the active problem.")
        b = np.asarray(bounds, dtype=float)
        mins, maxs = b[0::2], b[1::2]
        if np.any(mins > maxs):
            raise ValueError("Wrong admm bounds: define bounds as: min1 max1 ... minN maxN.")
        model.min_bound = np.repeat(mins[:, None], model.nelements_total, axis=1)
        model.max_bound = np.repeat(maxs[:, None], model.nelements_total, axis=1)
        model.bound_weight = np.ones(model.nelements_total)
    else:
        read_bound_constraints(model, ipar.bounds_ADMM_file[problem_index])
    model.min_bound = model.min_bound * model.units_mult
    model.max_bound = model.max_bound * model.units_mult


def read_damping_gradient_weights(model: ModelState, path: str):
    """(reference: model_IO.F90:385-420) rows of wx wy wz → (3, N)."""
    table = _load_table(path)
    if table.shape[0] != model.nelements_total or table.shape[1] < 3:
        raise ValueError("The damping gradient weights are not correctly defined!")
    model.damping_grad_weight = np.ascontiguousarray(table[:, :3].T)


def read_damping_weights(model: ModelState, path: str):
    """(reference: model_IO.F90:425-476) one weight per row → (N,)."""
    table = _load_table(path)
    if table.shape[0] != model.nelements_total:
        raise ValueError("The damping weights are not correctly defined!")
    model.damping_weight = table[:, 0].copy()


def read_local_weights(path: str, nelements_total: int) -> np.ndarray:
    """Local depth-weight multipliers (reference: apply_local_depth_weighting,
    weights_gravmag.f90:255-311): header N, one value per row."""
    table = _load_table(path)
    if table.shape[0] != nelements_total:
        raise ValueError("The local weight is not correctly defined!")
    return table[:, 0].copy()


def read_vector_field(path: str, nelements_total: int) -> np.ndarray:
    """Cross-gradient structural vector field (reference: read_vector_field,
    cross_gradient.F90:163-197): header N, rows vx vy vz → (N, 3)."""
    table = _load_table(path)
    if table.shape[0] != nelements_total or table.shape[1] < 3:
        raise ValueError("The vector field is not correctly defined!")
    return np.ascontiguousarray(table[:, :3])
