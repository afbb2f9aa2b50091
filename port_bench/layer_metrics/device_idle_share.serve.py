"""Share of the traced window in which no operation ran on the card, in
the daemon's process (the trace is taken there and summarised,
harness/serve_child.py): 1 - the union of the device intervals over the
window, in percent."""

from port_bench.harness.layers import idle_share


def read(ctx):
    return idle_share(ctx)
