"""Share of the traced window in which the device was idle while the
render stream was queueing a window (the program's `runtime.dispatch_window`
spans, user annotations in the trace): the idle gaps intersected with those
spans, over the window, in percent. None where the program records no such
span."""

from port_bench.harness.spans import idle_inside_share


def read(ctx):
    return idle_inside_share(ctx, "runtime.dispatch_window")
