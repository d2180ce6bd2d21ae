"""Device ms a step of the embedding CNN's convolutions: the operations
launched under ``aten::convolution`` (the runtime call that shares a
device event's correlation id, and that call's parents), and the port's own CNN
kernels by name, so that the metric still reads the CNN when they run it.
None when the window ran no convolution."""

CONV_OPS = {"aten::convolution", "aten::_convolution", "aten::cudnn_convolution", "aten::conv2d"}
CONV_KERNELS = ("conv_layer_kernel", "conv_mma_kernel")


def read(ctx):
    us = sum(op.end - op.start for op in ctx.trace.ops
             if op.launched_by & CONV_OPS or any(k in op.name for k in CONV_KERNELS))
    return us / 1e3 / ctx.counts["steps"] if us else None
