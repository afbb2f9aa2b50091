"""Share of kernel A's calls given a conv's demodulation (`scale`) that
applied it in A's own pass over the conv's output: `ops.demod_folded` over it
plus `ops.demod_separate` (calls under autograd, where the wrapper runs the
broadcast multiply first) from the program's counters, which count only
while the profiler is on, so over the traced window alone; in percent. None
where the program has no such counters."""

from port_bench.harness.spans import program_counters


def read(ctx):
    counts = program_counters() or {}
    folded = counts.get("ops.demod_folded", 0)
    calls = folded + counts.get("ops.demod_separate", 0)
    if not calls:
        return None
    return 100.0 * folded / calls
