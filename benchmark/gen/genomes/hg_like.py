"""Genome kind "hg_like": the benchmark's copy of the port's synthetic
genome with human-like repeat structure (a random backbone with mutated
copies of a 300 bp SINE-like, a 6 kb LINE-like and a 171 bp satellite
consensus), so that the same seed gives the same bases.  A
configuration's genome is `chromosomes` such pieces of
`bases // chromosomes` bases, piece c made from seed `seed + c`, each
after `padding` padding codes and `padding` more at the end, as the
port's genome files lay them out.
"""
from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

from ..genome import PAD_CODE, Genome


def _mutate(unit: np.ndarray, rate: float, rng) -> np.ndarray:
    u = unit.copy()
    n = rng.binomial(u.size, rate)
    if n:
        pos = rng.integers(0, u.size, n)
        u[pos] = (u[pos] + rng.integers(1, 4, n)) % 4
    return u


def hg_like(n_bases: int, seed: int = 0, sine_frac: float = 0.10,
            line_frac: float = 0.17, sat_frac: float = 0.03) -> np.ndarray:
    """(n_bases,) uint8 codes: ~10% SINE copies at 5-20% divergence, ~17%
    5'-truncated LINE copies at 5-25%, ~3% satellite arrays at 1.5%, the
    rest random."""
    rng = np.random.default_rng(seed)
    sine = rng.integers(0, 4, 300, dtype=np.uint8)
    line = rng.integers(0, 4, 6000, dtype=np.uint8)
    sat = rng.integers(0, 4, 171, dtype=np.uint8)
    parts, total = [], 0
    sine_left = int(n_bases * sine_frac)
    line_left = int(n_bases * line_frac)
    sat_left = int(n_bases * sat_frac)
    while total < n_bases:
        r = rng.random()
        if sine_left > 0 and r < 0.35:
            u = _mutate(sine, rng.uniform(0.05, 0.20), rng)
            sine_left -= u.size
        elif line_left > 0 and r < 0.50:
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


def _packed_piece(n_bases: int, seed: int, fracs: dict) -> np.ndarray:
    """hg_like(n_bases, seed, **fracs) packed four bases a byte (what a
    worker process sends back: a quarter of the bytes through the pipe,
    which otherwise takes most of a 3.2 Gb genome's time)."""
    codes = hg_like(n_bases, seed, **fracs)
    codes = np.concatenate([codes, np.zeros(-n_bases % 4, np.uint8)])
    q = codes.reshape(-1, 4)
    return (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]


def _unpack(packed: np.ndarray, n_bases: int, out: np.ndarray) -> None:
    view = out[:n_bases - n_bases % 4].reshape(-1, 4)
    full = packed[:view.shape[0]]
    for i, shift in enumerate((6, 4, 2, 0)):
        view[:, i] = (full >> shift) & 3
    for i in range(n_bases % 4):
        out[n_bases - n_bases % 4 + i] = (packed[-1] >> (6 - 2 * i)) & 3


def make(spec: dict, workers: int | None = None) -> Genome:
    """The genome a configuration's `genome` entry states; pieces are made
    by `workers` processes (default: one per core) when there are
    several."""
    n_chroms = int(spec["chromosomes"])
    per = int(spec["bases"]) // n_chroms
    pad = int(spec["padding"])
    seeds = [int(spec["seed"]) + c for c in range(n_chroms)]
    fracs = {k: float(spec[k]) for k in ("sine_frac", "line_frac",
                                         "sat_frac") if k in spec}
    codes = np.full(n_chroms * (pad + per) + pad, PAD_CODE, np.uint8)
    offsets = np.asarray([pad + c * (pad + per) for c in range(n_chroms)],
                         np.int64)
    workers = min(n_chroms, workers or os.cpu_count() or 1)
    if workers <= 1:
        for off, s in zip(offsets, seeds):
            codes[off:off + per] = hg_like(per, s, **fracs)
    else:
        with ProcessPoolExecutor(workers,
                                 mp_context=get_context("spawn")) as pool:
            for off, packed in zip(offsets, pool.map(
                    _packed_piece, [per] * n_chroms, seeds,
                    [fracs] * n_chroms)):
                _unpack(packed, per, codes[off:off + per])
    return Genome(codes=codes, piece_offsets=offsets, piece_len=per,
                  padding=pad)
