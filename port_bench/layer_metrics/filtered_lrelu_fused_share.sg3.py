"""Share of StyleGAN3's filtered leaky ReLUs that ran as kernel F:
`ops.filtered_lrelu_fused` (a forward launched F, under autograd too) over it
plus `ops.filtered_lrelu_twin` (a forward ran the plain twin: a CPU tensor)
from the program's counters, which count only while the profiler is on, so
over the traced window alone; in percent. None where the program has no such
counters."""

from port_bench.harness.spans import program_counters


def read(ctx):
    counts = program_counters() or {}
    fused = counts.get("ops.filtered_lrelu_fused", 0)
    calls = fused + counts.get("ops.filtered_lrelu_twin", 0)
    if not calls:
        return None
    return 100.0 * fused / calls
