"""Device busy microseconds (the union of the device's operation
intervals) in the traced steps over the reads they aligned."""


def read(ctx):
    t = ctx.get("trace") or {}
    if not t.get("n_ops") or not ctx.get("traced_reads"):
        return None
    return t["busy_s"] * 1e6 / ctx["traced_reads"]
