"""Device operations (kernels, copies, sets) a step: those of the traced
window over its steps.
None when the trace holds no device operation."""


def read(ctx):
    if not ctx.trace.ops:
        return None
    return len(ctx.trace.ops) / ctx.counts["steps"]
