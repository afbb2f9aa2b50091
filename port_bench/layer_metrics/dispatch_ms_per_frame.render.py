"""Host time the render stream spends queueing windows, per frame: the
traced window's seconds inside the program's `runtime.dispatch_window`
spans over the frames delivered, in ms. None where the program records no
such span."""

from port_bench.harness.spans import span_seconds


def read(ctx):
    seconds = span_seconds(ctx, "runtime.dispatch_window")
    if seconds is None or not ctx.frames:
        return None
    return 1e3 * seconds / ctx.frames
