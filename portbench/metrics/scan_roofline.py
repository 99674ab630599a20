"""The search's share of its roofline: the least time the traced requests'
needed work takes (per request, the larger of 2 d operations a probed
(query, row) pair at the bf16 peak and each probed row's 64-byte PQ code
read once plus the queries and results, counted by the cell's work module
after the check from the reference's cell sizes; the rows outside the
probed cells and the port's decoded bf16 cache are not counted), over
the device's busy time in those requests, in %."""


def read(ctx):
    bound = (ctx.traced or {}).get("bound_s", 0.0)
    busy = ctx.trace.busy_s
    return 100.0 * bound / busy if bound and busy else None
