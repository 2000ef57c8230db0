"""Survey data container (observation points + measured/calculated values).

Counterpart of the reference's t_data (data_gravmag.f90:32-69). Arrays are
host numpy; values use shape (ndata, ncomponents) — note the reference uses
Fortran (ncomponents, ndata); file layouts are identical (x y z v1..vC rows).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SurveyData:
    ndata: int
    ncomponents: int = 1
    units_mult: float = 1.0
    z_axis_dir: int = 1

    X: np.ndarray = field(default=None)
    Y: np.ndarray = field(default=None)
    Z: np.ndarray = field(default=None)
    val_meas: np.ndarray = field(default=None)  # (ndata, ncomponents)
    val_calc: np.ndarray = field(default=None)  # (ndata, ncomponents)
    weight: np.ndarray = field(default=None)  # 1/sigma, (ndata, ncomponents)

    def __post_init__(self):
        n, c = self.ndata, self.ncomponents
        if self.X is None:
            self.X = np.zeros(n)
        if self.Y is None:
            self.Y = np.zeros(n)
        if self.Z is None:
            self.Z = np.zeros(n)
        if self.val_meas is None:
            self.val_meas = np.zeros((n, c))
        if self.val_calc is None:
            self.val_calc = np.zeros((n, c))
        if self.weight is None:
            self.weight = np.ones((n, c))

    # ---- costs (reference: data_gravmag.f90:123-150) ----
    def get_cost(self) -> float:
        """Relative data cost ||calc - meas|| / ||meas||."""
        denom = np.linalg.norm(self.val_meas)
        if denom == 0.0:
            return 0.0
        return float(np.linalg.norm(self.val_calc - self.val_meas) / denom)

    def get_rmse(self) -> float:
        """Weighted root-mean-square error."""
        r = self.weight * (self.val_calc - self.val_meas)
        return float(np.sqrt(np.sum(r**2) / r.size))
