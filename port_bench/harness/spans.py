"""
Readings of the program's own spans and counters (gance_tpu_torch's
`utils/profiling.py`) for the readers of layer_metrics/. A span the program
records on the profiler's thread is a user annotation in the device trace,
so it is among `DeviceTrace.host_ops`; the counters are read in the process
that ran the window, where they counted only while the profiler was on. A
program without those spans or counters gives None, never an error.
"""

from typing import Any, Dict, List, Optional, Tuple

Interval = Tuple[float, float]


def merged(intervals: List[Interval]) -> List[Interval]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[Interval] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def intersect(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """The intersection of two lists of sorted disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        start, end = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if start < end:
            out.append((start, end))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def overlap(a: List[Interval], b: List[Interval]) -> float:
    """Total length of the intersection of two lists of sorted disjoint
    intervals."""
    return sum(end - start for start, end in intersect(a, b))


def span_intervals(trace: Any, name: str) -> List[Interval]:
    """The union of the spans named `name`, clipped to the traced window, in
    the trace's microseconds."""
    lo, hi = trace.window
    return merged([(max(s, lo), min(s + d, hi)) for n, s, d in trace.host_ops
                   if n == name and s + d > lo and s < hi])


def idle_inside_share(ctx: Any, name: str) -> Optional[float]:
    """Percent of the traced window in which the device was idle while a
    span named `name` was open."""
    trace = getattr(ctx, "trace", None)
    if trace is None or trace.window_s <= 0 or not trace.device_op_count:
        return None
    inside = span_intervals(trace, name)
    if not inside:
        return None
    return 100.0 * overlap(trace.idle_gaps(), inside) * 1e-6 / trace.window_s


def span_seconds(ctx: Any, name: str) -> Optional[float]:
    """Seconds of the traced window covered by spans named `name`."""
    trace = getattr(ctx, "trace", None)
    if trace is None:
        return None
    inside = span_intervals(trace, name)
    if not inside:
        return None
    return sum(end - start for start, end in inside) * 1e-6


def program_counters() -> Optional[Dict[str, int]]:
    """The program's counters in this process, or None where it has none."""
    try:
        from gance_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "counters", None)
    return read() if read is not None else None
