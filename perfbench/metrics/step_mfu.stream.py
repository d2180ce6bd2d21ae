"""The whole step's share of the card's peaks: the least time of a step at
the published peaks (``workcount.step_least_seconds``, the frozen work of
every stage over the peak of the arithmetic it runs) over the traced
window's time per step.
None when the trace holds no device operation."""

from perfbench import workcount


def read(ctx):
    if not ctx.trace.ops:
        return None
    per_step = ctx.trace.window_s / ctx.counts["steps"]
    return 100.0 * workcount.step_least_seconds(ctx.work, ctx.counts["streams"]) / per_step
