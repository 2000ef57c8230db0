"""Model container.

Counterpart of the reference's t_model (model.F90:35-87), minus the
local/full split: a model field is one array on the host.  Shapes: val is (ncomponents, N) with N = nx*ny*nz, i-fastest flat
order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from tomofastx_tpu_torch.models.grid import Grid


@dataclass
class ModelState:
    grid: Grid
    ncomponents: int = 1
    units_mult: float = 1.0
    vtk_label: str = "rho"

    val: np.ndarray = field(default=None)  # (ncomponents, N)
    val_prior: np.ndarray = field(default=None)  # (ncomponents, N)

    # ADMM disjoint-interval bounds (reference: model.F90:47-51).
    nlithos: int = 0
    min_bound: Optional[np.ndarray] = None  # (nlithos, N)
    max_bound: Optional[np.ndarray] = None  # (nlithos, N)
    bound_weight: Optional[np.ndarray] = None  # (N,)

    # Local weights for damping-gradient constraints, per direction (3, N).
    damping_grad_weight: Optional[np.ndarray] = None
    # Local damping weights for the prior-model term (N,).
    damping_weight: Optional[np.ndarray] = None

    def __post_init__(self):
        N = self.grid.nelements_total
        if self.val is None:
            self.val = np.zeros((self.ncomponents, N))
        if self.val_prior is None:
            self.val_prior = np.zeros((self.ncomponents, N))
        if self.damping_weight is None:
            self.damping_weight = np.ones(N)

    @property
    def nelements_total(self) -> int:
        return self.grid.nelements_total

    def set_value(self, value: float):
        self.val[:] = value

    def update(self, delta: np.ndarray):
        """m += delta (reference: model.F90:194-200)."""
        self.val = self.val + np.asarray(delta).reshape(self.val.shape)

    def allocate_bound_arrays(self, nlithos: int):
        N = self.nelements_total
        self.nlithos = nlithos
        self.min_bound = np.zeros((nlithos, N))
        self.max_bound = np.zeros((nlithos, N))
        self.bound_weight = np.ones(N)

    def allocate_damping_gradient_arrays(self):
        self.damping_grad_weight = np.ones((3, self.nelements_total))
