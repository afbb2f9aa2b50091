"""
Readings shared by the per-layer metrics of layer_metrics/: each reader is a
file of its own that calls one of these on the run's context.
"""

import sys
from collections import Counter, defaultdict
from typing import Any, Optional

from port_bench.reference import bounds


def idle_share(ctx: Any) -> Optional[float]:
    """Percent of the traced window with no device operation running."""
    trace = getattr(ctx, "trace", None)
    if trace is None or trace.window_s <= 0 or not trace.device_op_count:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def kernel_roofline(ctx: Any) -> Optional[float]:
    """Percent: the bounds of the forwards' kernel launches over those
    kernels' device time."""
    trace = getattr(ctx, "trace", None)
    rows = getattr(ctx, "forward_rows", None)
    if trace is None or not rows:
        return None
    want: Counter = Counter()
    bound = 0.0
    for count in rows:
        for family, seconds in bounds.forward_launches(ctx.config, count):
            want[family] += 1
            bound += seconds
    got: Counter = Counter()
    spent = defaultdict(float)
    for name, _, dur in trace.device_ops:
        family = bounds.family_of(name)
        if family:
            got[family] += 1
            spent[family] += dur * 1e-6
    if got != want:
        print(f"port_bench: kernel launches in the trace {dict(got)} are not the "
              f"forwards' {dict(want)}: kernel_roofline left out", file=sys.stderr)
        return None
    return 100.0 * bound / sum(spent.values())
