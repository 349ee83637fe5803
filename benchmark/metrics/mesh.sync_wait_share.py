"""Share of the traced steps' wall time the host spent blocked in the
mesh's syncs: the program's sync.* spans over the traced seconds."""
from benchmark import spans


def read(ctx):
    if not spans.counts().get("mesh.batches") or not ctx.get("traced_s"):
        return None
    return spans.sync_s() / ctx["traced_s"]
