"""The batch-size sweep that fixes a configuration's reads_per_batch: for
each size, the wall ms of a batch (steps as the window runs them), the
device's busy share of it (torch.profiler) and the allocator's peak, for
each traffic mix of the configuration, in one process on one card.

    python3 -m benchmark.sweep --config hglike-64m --traffic pe100-bulk
        se100-bulk --sizes 32768 65536 131072 [--steps 6]

Prints one JSON line per (mix, size) on stdout.  The configuration takes
the largest size whose peak leaves a tenth of the card's memory free.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import lookup, trace
from .gen.reads import make_pool
from .program import System, sync
from .run import HERE, inputs, load_json, log, set_cache_dirs


def measure(system, host, dev, steps: int) -> dict:
    batches = [[x.to(dev) for x in b] for b in host]
    system.step(batches[0])
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        system.step([x.to(dev, non_blocking=True)
                     for x in host[i % len(host)]]).cpu()
    wall = (time.perf_counter() - t0) / steps
    with trace.profiling() as prof:
        t1 = time.perf_counter()
        for i in range(2):
            system.step([x.to(dev, non_blocking=True)
                         for x in host[i % len(host)]]).cpu()
        sync(dev)
        traced = time.perf_counter() - t1
    s = trace.summarize(prof, traced)
    return dict(wall_ms=wall * 1e3, busy_share=s["busy_s"] / traced,
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                device_ops_per_batch=s["n_ops"] / 2)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.sweep")
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", nargs="+", required=True)
    p.add_argument("--sizes", nargs="+", type=int, required=True)
    p.add_argument("--steps", type=int, default=6)
    a = p.parse_args(argv)
    set_cache_dirs()
    if not torch.cuda.is_available():
        log("sweep: needs a CUDA device")
        return 3
    dev = torch.device("cuda")
    config = load_json(os.path.join(HERE, "configs", a.config + ".json"))
    mixes = {name: load_json(os.path.join(HERE, "traffic", name + ".json"))
             for name in a.traffic}
    for traffic in mixes.values():
        lookup.cell(config, traffic)
    genome, extras = inputs(config)
    total = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    for name, traffic in mixes.items():
        system = System(genome, extras, config, traffic, dev)
        for size in a.sizes:
            pool = make_pool(genome, dict(traffic, pool_batches=2), size, 1,
                             extras)
            host = [[torch.from_numpy(x).pin_memory()
                     for pair in zip(b.reads, b.quals) for x in pair]
                    for b in pool]
            try:
                r = measure(system, host, dev, a.steps)
            except torch.cuda.OutOfMemoryError as exc:
                r = dict(error=repr(exc)[:200])
            torch.cuda.empty_cache()
            print(json.dumps(dict(config=a.config, traffic=name,
                                  reads_per_batch=size, card_gib=total,
                                  parts=system.parts, **r)), flush=True)
        system.free()
        del system
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
