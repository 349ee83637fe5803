"""Host syncs a batch in the traced steps: the program's engine.syncs
(each device read the host waits for, and each blocking copy to the
card, as sync.* spans) over engine.batches."""
from benchmark import spans


def read(ctx):
    c = spans.counts()
    if not c.get("engine.batches"):
        return None
    return c.get("engine.syncs", 0) / c["engine.batches"]
