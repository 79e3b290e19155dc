"""The whole self-play step's share of the card's bf16 peak: forward FLOPs
of every evaluation in the traced window (roots and leaves) over the
window."""


def read(ctx):
    rows = ctx.counters.get("eval_rows", 0)
    if ctx.trace is None or rows <= 0:
        return None
    y = ctx.yardstick
    flops = y.resnet_forward_flops(ctx.config, rows)
    return 100.0 * flops / ctx.trace.window_s / y.PEAK_BF16_FLOPS
