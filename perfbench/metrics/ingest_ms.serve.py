"""Mean host ms of ``StreamServer.push_block`` a tick: the benchmark's span
around the call (``parallel/server.py`` -> ``parallel/ingest.py``)."""


def read(ctx):
    return ctx.trace.span_ms("push_block")
