"""Device time in PyTorch's elementwise and reduction kernels over all
device time in the traced steps, in %."""

from portbench.harness import is_elementwise


def read(ctx):
    busy = ctx.trace.busy_s
    return 100.0 * ctx.trace.time_s(is_elementwise) / busy if busy else None
