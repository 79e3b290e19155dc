"""Host milliseconds per learner step in the pipeline's feature
extraction: the summed length of the program's `elf.pipeline.features`
spans (the host batch's copies to the card and the planes built there)
over the traced window's steps."""

from harness import spans


def read(ctx):
    steps = ctx.counters.get("steps", 0)
    if ctx.trace is None or steps <= 0:
        return None
    n, secs = spans.span_stats(ctx.trace, "elf.pipeline.features")
    return 1000.0 * secs / steps if n else None
