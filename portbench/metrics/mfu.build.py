"""The DB build's share of the card's bf16 peak: the model's operations for
every fingerprint written (``yardstick/flops.py``, the same count whatever
implements the forward) over the host time they took, over 989 TFLOP/s,
in %; taken over the window's units that the profiler did not slow."""

from portbench.yardstick.flops import BF16_OPS_S, model_flops


def read(ctx):
    rows = ctx.untraced.get("rows", 0)
    if not rows or ctx.untraced_s <= 0:
        return None
    return 100.0 * model_flops(ctx.cfg) * rows / ctx.untraced_s / BF16_OPS_S
