"""Synthetic genomes with human-like repeat structure.

A uniform-random genome exercises almost none of an aligner's hard paths:
every 20-mer is unique, so there are no popular seeds, no overflow-table
traffic, no candidate-set explosions.  Real mammalian genomes are ~50%
repeats (SINE/LINE/satellite).  `hg_like_genome` plants mutated copies of
shared repeat families over a random backbone so an index built from it
has a realistic seed-popularity tail — the regime the reference was tuned
for (maxHits 16000 default, AlignerOptions.cpp:73-77; BiasTables.cpp
exists only because hg19's seed distribution is this skewed).

Composition (fractions of total bases, loosely matching RepBase numbers
for the human genome):
  ~10%  SINE: one 300 bp "Alu-like" consensus, copies at 5-20% divergence
  ~17%  LINE: one 6 kb "L1-like" consensus, copies 5' truncated (most
        copies short) at 5-25% divergence
  ~3%   satellite: 171 bp unit tandem arrays, 1-2% divergence
  rest  random backbone
"""
from __future__ import annotations

import numpy as np


def _mutate(unit: np.ndarray, rate: float, rng) -> np.ndarray:
    u = unit.copy()
    n = rng.binomial(u.size, rate)
    if n:
        pos = rng.integers(0, u.size, n)
        u[pos] = (u[pos] + rng.integers(1, 4, n)) % 4
    return u


def hg_like_genome(n_bases: int, seed: int = 0,
                   sine_frac: float = 0.10, line_frac: float = 0.17,
                   sat_frac: float = 0.03) -> np.ndarray:
    """Return (n_bases,) uint8 codes (A=0,G=1,C=2,T=3)."""
    rng = np.random.default_rng(seed)
    sine = rng.integers(0, 4, 300, dtype=np.uint8)
    line = rng.integers(0, 4, 6000, dtype=np.uint8)
    sat = rng.integers(0, 4, 171, dtype=np.uint8)

    parts = []
    total = 0
    sine_left = int(n_bases * sine_frac)
    line_left = int(n_bases * line_frac)
    sat_left = int(n_bases * sat_frac)
    while total < n_bases:
        r = rng.random()
        if sine_left > 0 and r < 0.35:
            u = _mutate(sine, rng.uniform(0.05, 0.20), rng)
            sine_left -= u.size
        elif line_left > 0 and r < 0.50:
            # 5' truncation: most L1 copies are short fragments
            keep = max(300, int(line.size * rng.beta(1.2, 2.5)))
            u = _mutate(line[-keep:], rng.uniform(0.05, 0.25), rng)
            line_left -= u.size
        elif sat_left > 0 and r < 0.55:
            n_units = int(rng.integers(5, 60))
            u = np.concatenate([_mutate(sat, 0.015, rng)
                                for _ in range(n_units)])
            sat_left -= u.size
        else:
            u = rng.integers(0, 4, int(rng.integers(500, 4000)),
                             dtype=np.uint8)
        parts.append(u)
        total += u.size
    return np.concatenate(parts)[:n_bases]


def wgsim_pairs(codes: np.ndarray, n_pairs: int, read_len: int = 100,
                insert_lo: int = 200, insert_hi: int = 400,
                sub_rate: float = 0.01, seed: int = 1):
    """Simulate error-bearing read pairs (FR orientation) from `codes`.

    Returns (reads0, quals0, reads1, quals1, true_pos0, true_pos1) with
    reads as (N, L) uint8 codes; end 1 is the reverse complement of the
    downstream fragment end, as in wgsim / the reference's -e oracle.
    """
    rng = np.random.default_rng(seed)
    G = codes.size
    r0 = np.empty((n_pairs, read_len), np.uint8)
    r1 = np.empty((n_pairs, read_len), np.uint8)
    p0 = np.empty(n_pairs, np.int64)
    p1 = np.empty(n_pairs, np.int64)
    for i in range(n_pairs):
        ins = int(rng.integers(insert_lo, insert_hi))
        s = int(rng.integers(0, G - ins - 1))
        a = codes[s:s + read_len].copy()
        b = codes[s + ins - read_len:s + ins].copy()
        for arr in (a, b):
            n_sub = rng.binomial(read_len, sub_rate)
            if n_sub:
                pos = rng.integers(0, read_len, n_sub)
                arr[pos] = (arr[pos] + rng.integers(1, 4, n_sub)) % 4
        r0[i] = a
        r1[i] = (3 - b[::-1]) & 3        # reverse complement
        p0[i] = s
        p1[i] = s + ins - read_len
    quals = np.full((n_pairs, read_len), ord("I"), np.uint8)
    return r0, quals, r1, quals.copy(), p0, p1
