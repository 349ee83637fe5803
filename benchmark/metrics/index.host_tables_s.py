"""Seconds of the set-up's DeviceIndex.genome_index, the index's tables
copied to the host and assembled there (the program's index.host_tables
span)."""
from benchmark import spans


def read(ctx):
    return spans.total_s("index.host_tables")
