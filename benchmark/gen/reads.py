"""The traffic generator: read batches drawn from `--seed`.

One general generator reads a mix's parameters (benchmark/traffic/*.json):
`read_len`, `insert_lo` / `insert_hi` (fragment length, uniform),
`sub_rate` (per-base substitution rate), `quality` (one ASCII quality
byte for every base), `ends` (2: FR pairs, 1: end 0 of each pair) and
`pool_batches` (distinct batches the window cycles).

It is the benchmark's vectorised copy of the port's `wgsim_pairs`: a
fragment of uniform length in [insert_lo, insert_hi) starts uniformly
inside one chromosome's body (never across padding); end 0 is its first
`read_len` bases, end 1 the reverse complement of its last; each base is
substituted with probability `sub_rate` by one of the three others.  The
true origin of each end is kept for `placed_share`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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


def _substitute(reads: np.ndarray, rate: float, rng) -> None:
    hit = rng.random(reads.shape) < rate
    shift = rng.integers(1, 4, reads.shape, dtype=np.uint8)
    reads[hit] = (reads[hit] + shift[hit]) % 4


def make_batch(genome, traffic: dict, n_frag: int, rng) -> Batch:
    """n_frag fragments -> one batch (n_frag pairs, or n_frag single
    reads)."""
    L = int(traffic["read_len"])
    lo, hi = int(traffic["insert_lo"]), int(traffic["insert_hi"])
    ins = rng.integers(lo, hi, n_frag)
    chrom = rng.integers(0, len(genome.piece_offsets), n_frag)
    start = (rng.random(n_frag) * (genome.piece_len - ins - 1)).astype(
        np.int64)
    s = genome.piece_offsets[chrom] + start
    cols = np.arange(L)
    r0 = genome.codes[s[:, None] + cols]
    ends = int(traffic["ends"])
    q = np.full((n_frag, L), ord(traffic["quality"]), np.uint8)
    reads, quals, true = [r0], [q], [s]
    if ends == 2:
        p1 = s + ins - L
        r1 = (3 - genome.codes[p1[:, None] + cols[::-1]]).astype(np.uint8)
        reads.append(r1)
        quals.append(q.copy())
        true.append(p1)
    elif ends != 1:
        raise ValueError("ends must be 1 or 2")
    for r in reads:
        _substitute(r, float(traffic["sub_rate"]), rng)
    return Batch(reads=[np.ascontiguousarray(r) for r in reads],
                 quals=quals, true_loc=true)


def make_pool(genome, traffic: dict, reads_per_batch: int,
              seed: int) -> list:
    """traffic["pool_batches"] distinct batches of reads_per_batch reads
    (pairs: reads_per_batch // 2 pairs) from `seed`."""
    rng = rng_for(seed)
    n_frag = reads_per_batch // int(traffic["ends"])
    return [make_batch(genome, traffic, n_frag, rng)
            for _ in range(int(traffic["pool_batches"]))]
