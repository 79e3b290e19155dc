"""The learner step's share of the card's bf16 peak: 3 x the forward FLOPs
a position (forward and backward; remat's recomputed forward is not
counted) x positions, over the window."""


def read(ctx):
    pos = ctx.work.get("positions", 0)
    if ctx.trace is None or pos <= 0:
        return None
    y = ctx.yardstick
    return (100.0 * y.train_step_flops(ctx.config, pos) / ctx.trace.window_s
            / y.PEAK_BF16_FLOPS)
