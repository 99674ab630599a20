"""The fused Grapher block's (#5) share of its roofline in the DB build:
the least time of the blocks the traced units' forwards needed
(``yardstick/flops.py:block_bound_ms`` at the cell's shapes: the rows the
model embedded in the traced units, in forwards of ``batch_size``), over
the device time of #5's kernels (its products ``grapher_gemm_*`` and its
selection ``normalize_rows`` / ``mrconv_*``), in %. None when no such
kernel ran."""

from portbench.yardstick.flops import forward_block_bounds_ms

KERNELS = ("grapher_gemm", "normalize_rows_kernel", "mrconv_rows_kernel", "mrconv_keys_kernel")


def read(ctx):
    t = ctx.trace.time_s(lambda n: any(k in n for k in KERNELS))
    if not t or not ctx.traced:
        return None
    b = int(ctx.traffic["batch_size"])
    forwards = ctx.traced["embedded_rows"] / b
    return 100.0 * forwards * forward_block_bounds_ms(ctx.cfg, b) / 1e3 / t
