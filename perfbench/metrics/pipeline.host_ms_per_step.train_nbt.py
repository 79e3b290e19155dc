"""Host milliseconds per step in the replay pipeline: the program's
`sample_host_batch` and `device_batch`, timed by the harness on the
pipeline it hands to the runner."""


def read(ctx):
    steps = ctx.counters.get("steps", 0)
    if steps <= 0 or "pipeline_s" not in ctx.counters:
        return None
    return 1000.0 * ctx.counters["pipeline_s"] / steps
