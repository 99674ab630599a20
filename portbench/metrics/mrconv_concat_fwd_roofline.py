"""The MRConv selection kernel's forward (#3, ``mrconv_concat``) share of
its roofline in the train step: the least time of the traced steps'
forward selections (``yardstick/flops.py:bound_ms`` at the cell's shapes,
2 x pairs rows, every Grapher) over the device time of #3's kernels, in
%. The forward's kernels are ``mrconv_rows_kernel`` launches whose third
template argument (backward) is false, each with the row normalisation
launched just before it. None when none ran."""

from portbench.metrics_common import selection_time_s
from portbench.yardstick.flops import step_select_bounds_ms


def read(ctx):
    t = selection_time_s(ctx.trace, backward=False)
    steps = (ctx.traced or {}).get("units", 0)
    if not t or not steps:
        return None
    rows = 2 * int(ctx.traffic["pairs"])
    return 100.0 * steps * step_select_bounds_ms(ctx.cfg, rows, backward=False) / 1e3 / t
