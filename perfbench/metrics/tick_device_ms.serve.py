"""Device ms a serving tick: the traced window's time with an operation on
the card (overlapping operations merged) over its ticks.
None when the trace holds no device operation."""


def read(ctx):
    if not ctx.trace.ops:
        return None
    return 1e3 * ctx.trace.busy_s() / ctx.counts["ticks"]
