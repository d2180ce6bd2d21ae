"""Device ms a step of the embedding CNN, the program's own account of it:
every operation launched inside the program's ``oww/engine.cnn`` or
``oww/engine.prime`` range (``openwakeword_tpu_torch.tracing``): the convs,
the CNN's elementwise passes, the caches' ``cat`` and their cast.
None when the window launched nothing inside them (a program without
these ranges)."""

RANGES = frozenset({"oww/engine.cnn", "oww/engine.prime"})


def read(ctx):
    us = sum(op.end - op.start for op in ctx.trace.ops if op.launched_by & RANGES)
    return us / 1e3 / ctx.counts["steps"] if us else None
