"""Device operations in the traced steps over the reads they aligned."""


def read(ctx):
    t = ctx.get("trace") or {}
    if not t.get("n_ops") or not ctx.get("traced_reads"):
        return None
    return t["n_ops"] / ctx["traced_reads"]
