"""The train step's share of the card's bf16 peak: three times the
forward's model operations (``yardstick/flops.py``) for each of the 2 x
pairs rows of every step (recomputation not counted) over the host time
they took, over 989 TFLOP/s, in %; taken over the window's steps that the
profiler did not slow."""

from portbench.yardstick.flops import BF16_OPS_S, model_flops


def read(ctx):
    pairs = ctx.untraced.get("pairs", 0)
    if not pairs or ctx.untraced_s <= 0:
        return None
    return 100.0 * 3 * model_flops(ctx.cfg) * 2 * pairs / ctx.untraced_s / BF16_OPS_S
