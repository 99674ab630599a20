"""The MRConv selection kernel's backward (#4) share of its roofline in
the train step: ``yardstick/flops.py:bound_ms(..., backward=True)`` of the
traced steps over the device time of #4's kernels (``mrconv_rows_kernel``
with backward true, ``mrconv_keys_kernel``, and the row normalisation
launched before them), in %. None when none ran."""

from portbench.metrics_common import selection_time_s
from portbench.yardstick.flops import step_select_bounds_ms


def read(ctx):
    t = selection_time_s(ctx.trace, backward=True)
    steps = (ctx.traced or {}).get("units", 0)
    if not t or not steps:
        return None
    rows = 2 * int(ctx.traffic["pairs"])
    return 100.0 * steps * step_select_bounds_ms(ctx.cfg, rows, backward=True) / 1e3 / t
