"""cudaMalloc calls of the caching allocator a batch in the traced steps:
the program's alloc.device_mallocs (the allocator's num_device_alloc
across each engine batch span) over engine.batches."""
from benchmark import spans


def read(ctx):
    c = spans.counts()
    if not c.get("engine.batches") or "alloc.device_mallocs" not in c:
        return None
    return c["alloc.device_mallocs"] / c["engine.batches"]
