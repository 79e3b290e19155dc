"""The learner step's norm, activation, pooling and residual passes
against their byte bound: the bytes they must move in the window (the
harness's `normact_bytes`, from `yardstick_nbt_train.py`'s layer list at
the configuration's dtypes) at the card's HBM rate, over the device time
of every operation in the window that is not a convolution or a matrix
multiplication (by kernel name).  The same work is read whatever
implements it."""

FRAGMENTS = ("conv", "gemm", "xmma", "cudnn", "cutlass", "fprop", "dgrad",
             "wgrad", "winograd", "fft", "sm90_", "nvjet")


def read(ctx):
    nbytes = ctx.work.get("normact_bytes", 0)
    if ctx.trace is None or nbytes <= 0:
        return None
    s = sum((e - st) * 1e-6 for st, e, n, _ in ctx.trace.ops
            if not any(f in n.lower() for f in FRAGMENTS))
    if s <= 0:
        return None
    return 100.0 * nbytes / ctx.yardstick.PEAK_HBM_BYTES / s
