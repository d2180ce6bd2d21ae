"""Mean host ms of ``StreamServer.step_async`` a tick, from its call to its
return: staging, the engine's ``predict_packets`` issue, and any wait for
the oldest fetch when two ticks are in flight."""


def read(ctx):
    return ctx.trace.span_ms("step_async")
