"""Share of the traced steps' device time spent outside the port's own
kernels (K1-K5): elementwise, copies, gathers, reductions, sorts."""


def read(ctx):
    t = ctx.get("trace") or {}
    if not t.get("device_s"):
        return None
    return 1.0 - sum(t["by_kernel"].values()) / t["device_s"]
