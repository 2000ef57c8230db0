"""The stored kernels' products against their least time: each kernel's
float32 bytes, x and y, each read or written once, at the HBM bandwidth
(portbench/yardstick.py), summed over the products counted, over the device
time of every operation launched inside the products' ranges of the traced
inversion. The stored kernel is the default format's: dense."""

from portbench import yardstick

STORED = ("DenseKernel",)


def read(run):
    if run.trace is None:
        return None
    least = sum(yardstick.stored_product_s(*shape) for cls, _, shape in run.products.shapes
                if cls in STORED and shape is not None)
    device_s = sum(run.trace.device_s_in(f"portbench.op.{cls}.") for cls in STORED)
    if least <= 0 or device_s <= 0:
        return None
    return 100.0 * least / device_s
