"""The readings a cell's limits are set from, in one process on one card:
for each seed, the timed path at the cell's own size (a short window of
whole batches through the configuration's entry), the harness's sample
of its results and the compared numbers against the plain reference;
then, for each control seed, the control's numbers: the configuration's
plain reference in the precision below the one the configuration states
(the DNA reference: probabilities in bfloat16 for float32), put in the
program's place, against the same reference as stated.

    python3 -m benchmark.limits --workload hglike-64m.pe100-bulk
        --seeds 1 2 ... --control-seeds 101 102 103 [--batches 8]

Prints one JSON line per reading on stdout.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import lookup
from .gen.reads import make_pool
from .program import System
from .run import (benchmark_file, cell_spec, inputs, log, sample_rows,
                  set_cache_dirs, take_sample)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", nargs="+", type=int, required=True)
    p.add_argument("--control-seeds", nargs="*", type=int, default=[])
    p.add_argument("--batches", type=int, default=8)
    a = p.parse_args(argv)
    set_cache_dirs()
    dev = torch.device("cuda")
    spec = cell_spec(benchmark_file(), a.workload)
    config, traffic, cell = spec["config"], spec["traffic"], spec["cell"]
    paired = traffic["mode"] == "paired"
    lookup.cell(config, traffic)
    genome, extras = inputs(config)
    system = System(genome, extras, config, traffic, dev)
    ends = 2 if paired else 1
    taken = []
    for kind, seeds in (("program", a.seeds), ("control", a.control_seeds)):
        for seed in seeds:
            pool = make_pool(genome, traffic, int(config["reads_per_batch"]),
                             seed, extras)
            n_rows = pool[0].n_reads // ends
            outs = []
            for i in range(a.batches):
                b = pool[i % len(pool)]
                batch = [torch.from_numpy(x).to(dev)
                         for pair in zip(b.reads, b.quals) for x in pair]
                outs.append((i % len(pool), system.step(batch).cpu().numpy()))
            picks = sample_rows(outs, n_rows, int(cell["check_reads"]) //
                                ends, seed)
            taken.append((kind, seed, len(picks),
                           *take_sample(pool, outs, picks, system.keys)))
    # the references run once the program's state is freed
    system.free()
    del system
    torch.cuda.empty_cache()
    reference, cmp = lookup.reference(config), lookup.comparison(config)
    ref = reference.make(genome, extras, config, traffic, dev)
    ctl = reference.make(genome, extras, config, traffic, dev, control=True)
    for kind, seed, n, got, reads, quals in taken:
        want = ref.align(reads, quals)
        if kind == "control":
            got = ctl.align(reads, quals)
        vals = cmp.numbers(got, want, paired)
        print(json.dumps(dict(workload=a.workload, kind=kind, seed=seed,
                              n=n, **vals,
                              fields=cmp.fields(got, want, paired))),
              flush=True)
        log(f"{kind} seed {seed}: {vals}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
