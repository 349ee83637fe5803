"""Read source "genome": contiguous fragments of the genome, the
benchmark's vectorised copy of the port's `wgsim_pairs`.

A mix's `read_len`, `insert_lo` / `insert_hi` (fragment length,
uniform), `sub_rate` (per-base substitution rate) and `quality` (one
ASCII quality byte for every base): a fragment of uniform length in
[insert_lo, insert_hi) starts uniformly inside one chromosome's body
(never across padding); end 0 is its first `read_len` bases, end 1 the
reverse complement of its last; each base is substituted with
probability `sub_rate` by one of the three others.  The true origin of
each end is kept for `placed_share`.
"""
from __future__ import annotations

import numpy as np

from ..reads import Batch, substitute


def make_batch(genome, extras: dict, traffic: dict, n_frag: int,
               rng) -> Batch:
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
        substitute(r, float(traffic["sub_rate"]), rng)
    return Batch(reads=[np.ascontiguousarray(r) for r in reads],
                 quals=quals, true_loc=true)
