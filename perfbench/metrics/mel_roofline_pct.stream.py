"""K1-3pass's share of its roofline: the least time of one launch over the
step's streams (``workcount.mel_launch_least_seconds``: three dense bf16
passes over the frozen operations, or the bytes at the HBM rate) over the
mean device time of its launches, found by the kernel's name. None when the
window launched it not at all."""

from perfbench import workcount

KERNEL = "melspec_frames_mma_kernel"


def read(ctx):
    d = [op.end - op.start for op in ctx.trace.ops if KERNEL in op.name]
    if not d:
        return None
    return 100.0 * workcount.mel_launch_least_seconds(ctx.work, ctx.counts["streams"]) / (sum(d) / len(d) / 1e6)
