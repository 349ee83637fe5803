"""Reads aligned a second through the index-sharded mesh (a
configuration whose index is in more than one slice), over the traced
run's window after its profiled steps and the profiler's shutdown;
nothing elsewhere."""


def read(ctx):
    if ctx.get("n_slices", 1) <= 1 or "traced_s" not in ctx:
        return None
    steps = ctx["steps"] - ctx["traced_steps"]
    secs = ctx["window_s"] - ctx["untraced_from"]
    if steps <= 0 or secs <= 0:
        return None
    return steps * ctx["reads_per_batch"] / secs
