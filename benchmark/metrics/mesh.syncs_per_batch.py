"""Host syncs a mesh batch in the traced steps: the program's
engine.syncs (each blocking device read, sync.* spans) over
mesh.batches."""
from benchmark import spans


def read(ctx):
    c = spans.counts()
    if not c.get("mesh.batches"):
        return None
    return c.get("engine.syncs", 0) / c["mesh.batches"]
