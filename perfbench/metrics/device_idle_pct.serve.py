"""Share of the serving window with no kernel, copy or set on the card.
None when the trace holds no device operation."""


def read(ctx):
    if not ctx.trace.ops:
        return None
    return ctx.trace.idle_pct()
