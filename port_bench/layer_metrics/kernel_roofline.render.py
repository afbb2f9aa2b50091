"""The port's kernels (A-C on the standard fp32 path) against their
roofline: the sum of each launch's bound (bytes / 3.35 TB/s or operations /
peak, port_bench/reference/bounds.py) over the sum of those kernels' device
time in the trace, in percent. Each forward's launches are derived from its
rows (the traced run's span around each call into the model); where the
trace does not hold exactly those launches the reading is left out."""

from port_bench.harness.layers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx)
