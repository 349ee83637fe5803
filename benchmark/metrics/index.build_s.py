"""Seconds of the set-up's index build on the card (build_index_device,
ending in a sync), from the benchmark's own span around the call."""


def read(ctx):
    return ctx["parts"].get("index_build_s")
