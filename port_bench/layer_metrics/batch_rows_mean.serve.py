"""Real rows per dispatched batch over the window: the daemon's batcher
counters (`DynamicBatcher.stats()` through /stats) before and after it,
frames / batches."""


def read(ctx):
    if not ctx.batches:
        return None
    return ctx.rows / ctx.batches
