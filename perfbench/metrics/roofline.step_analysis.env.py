"""`step_analysis` against its byte bound: each launch reads the boards,
actions and colours once and writes the board after captures, both
liberty fields and the capture mask once (yardstick.step_analysis_bytes),
at 3.35 TB/s; over the device time of the kernels named below."""

KERNELS = ("step_analysis_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    secs, launches = ctx.trace.kernel_s(KERNELS)
    if secs <= 0:
        return None
    y = ctx.yardstick
    bound = launches * y.step_analysis_bytes(
        ctx.counters["boards"], ctx.config["board_size"]) / y.PEAK_HBM_BYTES
    return 100.0 * bound / secs
