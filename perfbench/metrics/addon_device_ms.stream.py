"""Device ms a step of the add-ons: every operation launched inside the
program's ``oww/engine.ns`` (the noise suppressor) or ``oww/engine.vad``
(the VAD network and its ring) range (``openwakeword_tpu_torch.tracing``).
None when the window launched nothing inside them (add-ons off, or a
program without these ranges)."""

RANGES = frozenset({"oww/engine.ns", "oww/engine.vad"})


def read(ctx):
    us = sum(op.end - op.start for op in ctx.trace.ops if op.launched_by & RANGES)
    return us / 1e3 / ctx.counts["steps"] if us else None
