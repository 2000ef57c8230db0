"""Structured prism grid.

Counterpart of the reference's t_grid / t_grad_grid (grid.F90). The
reference stores the six per-cell prism corner arrays in MPI-3 shared
memory windows (grid.F90:99-188); here they are plain host arrays, and the
compute layers move the pieces they need to the device.

Cell ordering convention (must match the reference's file formats,
model_IO.F90:184-222): flat index p = i + j*nx + k*nx*ny with i (x) fastest.
A flat model vector therefore reshapes to a C-order cube of shape
(nz, ny, nx).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Grid:
    """Full structured grid of rectangular prisms.

    Attributes are host numpy arrays (IO-side); compute layers convert the
    pieces they need to device arrays.
    """

    nx: int
    ny: int
    nz: int
    # Per-cell prism corner coordinates, flat (N,) in i-fastest order.
    X1: np.ndarray
    X2: np.ndarray
    Y1: np.ndarray
    Y2: np.ndarray
    Z1: np.ndarray
    Z2: np.ndarray
    z_axis_dir: int = 1

    @property
    def nelements_total(self) -> int:
        return self.nx * self.ny * self.nz

    # ---- geometry getters (reference: grid.F90:212-353) ----
    def cell_sizes(self):
        """(hx, hy, hz) per cell, each flat (N,)."""
        return (
            np.abs(self.X2 - self.X1),
            np.abs(self.Y2 - self.Y1),
            np.abs(self.Z2 - self.Z1),
        )

    def cell_volume(self) -> np.ndarray:
        hx, hy, hz = self.cell_sizes()
        return hx * hy * hz

    def cell_centers(self):
        return (
            0.5 * (self.X1 + self.X2),
            0.5 * (self.Y1 + self.Y2),
            0.5 * (self.Z1 + self.Z2),
        )

    # ---- 1-D spacings for gradient stencils (reference: t_grad_grid,
    #      grid.F90:359-426 — structured-grid assumption: dX depends only on i).
    def dX(self) -> np.ndarray:
        return np.abs(self.X2[: self.nx] - self.X1[: self.nx])

    def dY(self) -> np.ndarray:
        idx = np.arange(self.ny) * self.nx
        return np.abs(self.Y2[idx] - self.Y1[idx])

    def dZ(self) -> np.ndarray:
        idx = np.arange(self.nz) * self.nx * self.ny
        return np.abs(self.Z2[idx] - self.Z1[idx])

    def bounds(self):
        return (
            (self.X1.min(), self.X2.max()),
            (self.Y1.min(), self.Y2.max()),
            (self.Z1.min(), self.Z2.max()),
        )

    def as_cube(self, flat: np.ndarray) -> np.ndarray:
        """Reshape a flat (..., N) field to (..., nz, ny, nx)."""
        return np.asarray(flat).reshape(*flat.shape[:-1], self.nz, self.ny, self.nx)
