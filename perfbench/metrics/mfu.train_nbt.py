"""The nested-bottleneck net's learner step against the card's bf16 peak:
3 x the forward FLOPs a position (`yardstick_nbt_train.py`; forward and
backward, remat's recomputed forward not counted) x positions, over the
window."""

from harness import yardstick_nbt, yardstick_nbt_train


def read(ctx):
    pos = ctx.work.get("positions", 0)
    if ctx.trace is None or pos <= 0 or not yardstick_nbt.counts(ctx.config):
        return None
    flops = yardstick_nbt_train.train_step_flops(ctx.config, pos)
    return 100.0 * flops / ctx.trace.window_s / ctx.yardstick.PEAK_BF16_FLOPS
