"""The whole self-play step's share of the card's bf16 peak: the nested-
bottleneck net's forward FLOPs (`yardstick_nbt.py`) of every evaluation in
the traced window (roots and leaves) over the window."""

from harness import yardstick_nbt


def read(ctx):
    rows = ctx.counters.get("eval_rows", 0)
    if ctx.trace is None or rows <= 0 or not yardstick_nbt.counts(
            ctx.config):
        return None
    flops = yardstick_nbt.forward_flops(ctx.config, rows)
    return 100.0 * flops / ctx.trace.window_s / ctx.yardstick.PEAK_BF16_FLOPS
