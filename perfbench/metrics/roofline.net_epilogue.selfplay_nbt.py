"""The nested-bottleneck net's epilogues against their byte bound: the
bytes the window's epilogue launches must move (`yardstick_nbt.py`, from
the layer list, the harness's `eval_rows` and the program's `net.forwards`
counter), at the card's HBM rate, over the device time of the program's
epilogue kernels (`nbt_normact_kernel`, `nbt_pool_kernel`).  Nothing to
read where the program has no such kernel or keeps no such counter."""

from harness import spans, yardstick_nbt

KERNELS = ["nbt_normact_kernel", "nbt_pool_kernel"]


def read(ctx):
    if ctx.trace is None or not yardstick_nbt.counts(ctx.config):
        return None
    s, launches = ctx.trace.kernel_s(KERNELS)
    rows = ctx.counters.get("eval_rows", 0)
    forwards = spans.counters().get("net.forwards", 0)
    if s <= 0 or launches <= 0 or rows <= 0 or forwards <= 0:
        return None
    nbytes = yardstick_nbt.epilogue_bytes(ctx.config, rows, forwards)
    return 100.0 * nbytes / ctx.yardstick.PEAK_HBM_BYTES / s
