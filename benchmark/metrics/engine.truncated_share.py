"""Share of the traced steps' reads whose candidate hit lists the expand
phase truncated at cand_per_read (the engines' per-read `truncated`
outputs, counted by the program's recorder as engine.truncated, over
engine.reads)."""
from benchmark import spans


def read(ctx):
    c = spans.counts()
    if not c.get("engine.reads"):
        return None
    return c.get("engine.truncated", 0) / c["engine.reads"]
