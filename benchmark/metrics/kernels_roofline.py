"""The port's kernels' share of their roofline in the traced steps, in %:
the sum of each launch's bound (benchmark/roofline.py) over the sum of
the same kernels' device time."""


def read(ctx):
    bounds = ctx.get("kernel_bounds") or {}
    t = ctx.get("trace") or {}
    dev_s = sum(t.get("by_kernel", {}).get(k, 0.0) for k in bounds)
    if not bounds or dev_s <= 0:
        return None
    return 100.0 * sum(bounds.values()) / dev_s
