"""Seconds of the set-up's cuckoo bucket layout, built on the host from
the host tables (the program's index.cuckoo_layout span)."""
from benchmark import spans


def read(ctx):
    return spans.total_s("index.cuckoo_layout")
