"""Share of the rows the render stream dispatched that were padding
(remainders of a window's per-network groups padded to a power of two):
1 - `runtime.rows_real` / `runtime.rows_dispatched` from the program's
counters, which count only while the profiler is on, so over the traced
window alone; in percent. None where the program has no such counters."""

from port_bench.harness.spans import program_counters


def read(ctx):
    counts = program_counters() or {}
    real, dispatched = counts.get("runtime.rows_real"), counts.get("runtime.rows_dispatched")
    if not dispatched or real is None:
        return None
    return 100.0 * (1.0 - real / dispatched)
