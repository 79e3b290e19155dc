"""The nested-bottleneck net's forwards against their bound: the least
time of the window's evaluations (forward FLOPs counted from the shapes,
`yardstick_nbt.py`, at the bf16 peak; FLOP-bound: 18.8 GFLOP a position at
19x19 against a few hundred bytes of epilogue traffic per 1,000 FLOPs)
over the device time of the operations launched inside the `net` range."""

from harness import yardstick_nbt


def read(ctx):
    if ctx.trace is None or not yardstick_nbt.counts(ctx.config):
        return None
    s = ctx.trace.device_s("net")
    rows = ctx.counters.get("eval_rows", 0)
    if s <= 0 or rows <= 0:
        return None
    flops = yardstick_nbt.forward_flops(ctx.config, rows)
    return 100.0 * flops / ctx.yardstick.PEAK_BF16_FLOPS / s
