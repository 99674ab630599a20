"""Share of the traced units' time in which no kernel, copy or memset ran
on the card, in %."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
