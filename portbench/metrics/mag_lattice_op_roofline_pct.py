"""The blended corner-lattice operator's magnetic products against their
least time: the float32 operations that this survey's quadrature points
need, times the products counted, over the device time of every operation
launched inside the products' ranges of the traced inversion.

The least time is counted from the inputs (the survey and the lattice), not
from the kernels that do the work: a frozen copy of `chip_smoke.py`'s bound
arithmetic for kernel B3's TMI family (`b3_bound`, `B2_QUAD_FLOPS["magn"]`,
`FP32_FLOP_PER_S`), as it was. A magnetic cell outside the tensor tier-2
window takes the 8-point rule, one inside it the 27-point rule, at 1170 / 27
float32 operations a point; the near pairs' float64 closed forms are left
out, as the special function unit's reciprocal square roots are (below the
float32 operations for this family)."""

import numpy as np

from portbench import yardstick

PREFIX = "portbench.op.LatticeMatrixFreeKernel."
# Published float32 peak of one H100 SXM (NVIDIA's data sheet), at 700 W.
FP32_FLOP_PER_S = 67e12
# Float32 operations of the magnetic tensor's 27-point rule on one cell.
MAG_QUAD27_FLOPS = 1170
# The tensor families' tier-2 window radius, in half-diagonals
# (ops/prism.py FAR_QUAD2_RADIUS_TENSOR).
TIER2_RADIUS_TENSOR = 16.0


def tmi_pairs(edges, points):
    """(near, window, far) observation-cell pairs of the blended magnetic
    lattice operator: the window's cells within the near radius, the
    window's others, and the cells outside the tensor tier-2 window. The
    near cells lie inside any window of a larger radius, so their count is
    yardstick.lattice_pairs'."""
    near, _, _ = yardstick.lattice_pairs(edges, points)
    (wz, wy, wx), _ = yardstick.lattice_window(edges, points, radius=TIER2_RADIUS_TENSOR)
    npoints = np.asarray(points[0]).size
    ncells = int(np.prod([np.asarray(e).size - 1 for e in edges]))
    window = npoints * wz * wy * wx
    return near, window - near, npoints * ncells - window


def tmi_product_s(edges, points):
    """Least seconds of one TMI product (matvec or rmatvec) of the blended
    lattice operator, by its float32 operations."""
    _, window, far = tmi_pairs(edges, points)
    points = 27 * window + 8 * far
    return MAG_QUAD27_FLOPS / 27 * points / FP32_FLOP_PER_S


def read(run):
    if run.trace is None:
        return None
    calls = sum(n for (cls, _), n in run.products.calls.items() if cls == "LatticeMatrixFreeKernel")
    device_s = run.trace.device_s_in(PREFIX)
    if not calls or device_s <= 0:
        return None
    return 100.0 * calls * tmi_product_s(run.arrays["edges"], run.arrays["points"]) / device_s
