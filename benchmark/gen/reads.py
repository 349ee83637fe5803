"""The traffic generator: read batches drawn from `--seed`.

One general generator reads a mix's parameters (benchmark/traffic/*.json)
and draws each batch from the read source the mix names (`source`,
"genome" when it names none: benchmark/gen/sources/<source>.py), with
one random generator for the whole pool.  `pool_batches` is the number
of distinct batches the window cycles, `ends` 2 for pairs, 1 for single
reads.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import lookup


@dataclass
class Batch:
    reads: list          # per end, (n, read_len) uint8 codes
    quals: list          # per end, (n, read_len) uint8 ASCII
    true_loc: list       # per end, (n,) int64 genome offset of the origin

    @property
    def n_reads(self) -> int:
        return sum(r.shape[0] for r in self.reads)


def rng_for(seed: int) -> np.random.Generator:
    """A generator for any whole-number seed (large and negative ones
    included)."""
    return np.random.default_rng(int(seed) % (1 << 64))


def substitute(reads: np.ndarray, rate: float, rng) -> None:
    """Each base, with probability `rate`, replaced by one of the three
    others, in place."""
    hit = rng.random(reads.shape) < rate
    shift = rng.integers(1, 4, reads.shape, dtype=np.uint8)
    reads[hit] = (reads[hit] + shift[hit]) % 4


def make_pool(genome, traffic: dict, reads_per_batch: int,
              seed: int, extras: dict | None = None) -> list:
    """traffic["pool_batches"] distinct batches of reads_per_batch reads
    (pairs: reads_per_batch // 2 pairs) from `seed`; `extras` are the
    configuration's extra inputs by kind."""
    source = lookup.source(traffic)
    rng = rng_for(seed)
    n_frag = reads_per_batch // int(traffic["ends"])
    return [source.make_batch(genome, extras or {}, traffic, n_frag, rng)
            for _ in range(int(traffic["pool_batches"]))]
