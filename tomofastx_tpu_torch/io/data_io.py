"""Survey data point readers/writers.

Format (reference: data_gravmag.f90:204-239, 293-336): first line = ndata,
then rows ``x y z v1 .. vC``.
"""

from __future__ import annotations

import os

import numpy as np

from tomofastx_tpu_torch.io.tableio import load_table, save_table
from tomofastx_tpu_torch.models.data import SurveyData


def read_data_points(
    path: str,
    ndata: int,
    ncomponents: int = 1,
    units_mult: float = 1.0,
    z_axis_dir: int = 1,
    grid_only: bool = False,
) -> SurveyData:
    """Read the data grid (positions) or full data (positions + values).

    grid_only=True mirrors data_read_grid (values columns are validated but
    discarded; Z is flipped for elevation-space inputs); grid_only=False
    mirrors data_read (values are unit-converted; positions discarded by the
    reference but kept here).
    """
    with open(path, "r") as f:
        n_read = int(f.readline().split()[0])
        if n_read != ndata:
            raise ValueError(
                f"The number of data in Parfile ({ndata}) differs from the data file ({n_read})!"
            )
    table = load_table(path, skiprows=1)

    if table.shape[0] != ndata or table.shape[1] < 3 + ncomponents:
        raise ValueError(
            f"Problem while reading the data file '{path}': shape {table.shape}, "
            f"expected ({ndata}, >= {3 + ncomponents}). Verify the number of data components."
        )

    data = SurveyData(ndata=ndata, ncomponents=ncomponents, units_mult=units_mult, z_axis_dir=z_axis_dir)
    data.X = table[:, 0].copy()
    data.Y = table[:, 1].copy()
    data.Z = table[:, 2].copy()
    if grid_only:
        if z_axis_dir != 1:
            data.Z = -data.Z
    else:
        data.val_meas = table[:, 3 : 3 + ncomponents] * units_mult
    return data


def read_data_values(data: SurveyData, path: str):
    """Re-read measured values into an existing SurveyData (reference:
    data_read, data_gravmag.f90:156-172 — positions are kept from the grid)."""
    with open(path, "r") as f:
        n_read = int(f.readline().split()[0])
        if n_read != data.ndata:
            raise ValueError("The number of data in Parfile differs from the data file!")
    table = load_table(path, skiprows=1)
    data.val_meas = table[:, 3 : 3 + data.ncomponents] * data.units_mult


def read_data_error(data: SurveyData, path: str):
    """Data error file → weights 1/sigma (reference: data_gravmag.f90:244-281)."""
    with open(path, "r") as f:
        n_read = int(f.readline().split()[0])
        if n_read != data.ndata:
            raise ValueError("The number of data in Parfile differs from the data error file!")
    table = load_table(path, skiprows=1)
    err = table[:, : data.ncomponents] * data.units_mult
    data.weight = 1.0 / err


def write_data_points(data: SurveyData, path: str, which: int):
    """Write data in the input ASCII format (reference: data_write,
    data_gravmag.f90:293-336). which=1 → measured, which=2 → calculated."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    val = (data.val_meas if which == 1 else data.val_calc) / data.units_mult
    Z = data.Z if data.z_axis_dir == 1 else -data.Z
    table = np.column_stack([data.X, data.Y, Z, val])
    save_table(path, table, fmt="%.9E", header=f" {data.ndata}")
