"""The net's forwards against their bound: the least time of the window's
evaluations (forward FLOPs counted from the shapes, at the bf16 peak; the
forward is FLOP-bound: at 2048 rows of the 19x19 net it moves about 0.05
GB of weights and activations per 35 TFLOP) over the device time of the
operations launched inside the `net` range."""


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.device_s("net")
    rows = ctx.counters.get("eval_rows", 0)
    if s <= 0 or rows <= 0:
        return None
    y = ctx.yardstick
    bound = y.resnet_forward_flops(ctx.config, rows) / y.PEAK_BF16_FLOPS
    return 100.0 * bound / s
