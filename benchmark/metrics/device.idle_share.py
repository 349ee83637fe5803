"""1 - the device's busy time (the union of its operation intervals) over
the traced steps' wall time."""


def read(ctx):
    t = ctx.get("trace") or {}
    if not t.get("n_ops") or not ctx.get("traced_s"):
        return None
    return 1.0 - t["busy_s"] / ctx["traced_s"]
