"""The blended corner-lattice operator's products against their least time:
the quadrature points' reciprocal square roots that this survey's pairs need
(portbench/yardstick.py, on the special function unit), times the products
counted, over the device time of every operation launched inside the
products' ranges of the traced inversion."""

from portbench import yardstick

PREFIX = "portbench.op.LatticeMatrixFreeKernel."


def read(run):
    if run.trace is None:
        return None
    calls = sum(n for (cls, _), n in run.products.calls.items() if cls == "LatticeMatrixFreeKernel")
    device_s = run.trace.device_s_in(PREFIX)
    if not calls or device_s <= 0:
        return None
    least = yardstick.lattice_product_s(run.arrays["edges"], run.arrays["points"])
    return 100.0 * calls * least / device_s
