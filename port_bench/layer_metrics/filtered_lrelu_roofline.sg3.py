"""Kernel F (StyleGAN3's filtered leaky ReLU) against its roofline: the sum
of each launch's bound (bytes / 3.35 TB/s or operations / 67 TFLOP/s fp32,
port_bench/reference/bounds_sg3.py) over the sum of F's device time in the
trace, in percent. The launches are derived from the forwards' rows (the
traced run's span around each call into the model); where the trace does not
hold exactly that many of F's launches the reading is left out."""

import sys

from port_bench.reference import bounds_sg3


def read(ctx):
    trace = getattr(ctx, "trace", None)
    rows = getattr(ctx, "forward_rows", None)
    if trace is None or not rows:
        return None
    want = [seconds for count in rows for _, seconds in bounds_sg3.forward_launches(ctx.config, count)]
    spent = [dur * 1e-6 for name, _, dur in trace.device_ops if bounds_sg3.is_f(name)]
    if len(spent) != len(want):
        print(f"port_bench: {len(spent)} launches of kernel F in the trace, the forwards "
              f"make {len(want)}: filtered_lrelu_roofline.sg3 left out", file=sys.stderr)
        return None
    return 100.0 * sum(want) / sum(spent)
