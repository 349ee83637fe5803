"""Seed packing: 2-bit k-mers with precomputed reverse complements.

Analog of reference SNAPLib/Seed.h:32-190.  A seed of length L (16..25,
L<=32) packs base codes (A=0,G=1,C=2,T=3) big-endian-by-base into a uint64:

    bases |= code[i] << 2*(L-1-i)        (Seed.h:44-50)
    rc    |= (code[i] ^ 3) << 2*i

The canonical form is min(bases, rc); the hash-table key is the canonical
seed's low 32 bits ("low bases" = last 16 bases) and the table selector is
the remaining high bits (Seed.h:60-66, GenomeIndex.cpp:316).
"""
from __future__ import annotations

import numpy as np


def pack_all_seeds(codes: np.ndarray, seed_len: int):
    """Pack the seed starting at EVERY position of ``codes``.

    Returns (fwd, rc, valid): uint64 arrays of length n - seed_len + 1 and a
    bool validity mask (False where the window contains any non-ACGT code,
    the analog of Seed::DoesTextRepresentASeed).
    """
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    m = n - seed_len + 1
    if m <= 0:
        z = np.zeros(0, dtype=np.uint64)
        return z, z.copy(), np.zeros(0, dtype=bool)
    fwd = np.zeros(m, dtype=np.uint64)
    rc = np.zeros(m, dtype=np.uint64)
    valid = np.ones(m, dtype=bool)
    # in-place formulation: one reused u64/bool scratch instead of five
    # fresh temporaries per base position — the build host is memory-
    # bandwidth-bound, so allocation/page-fault traffic dominates
    tmp = np.empty(m, dtype=np.uint64)
    tb = np.empty(m, dtype=bool)
    for i in range(seed_len):
        col = codes[i:m + i]
        np.less(col, 4, out=tb)
        np.logical_and(valid, tb, out=valid)
        c = col.astype(np.uint64)
        np.left_shift(c, np.uint64(2 * (seed_len - 1 - i)), out=tmp)
        np.bitwise_or(fwd, tmp, out=fwd)
        np.bitwise_xor(c, np.uint64(3), out=c)
        np.left_shift(c, np.uint64(2 * i), out=tmp)
        np.bitwise_or(rc, tmp, out=rc)
    # Mask out junk bits from invalid windows so downstream code can't
    # accidentally treat them as real seeds.
    fwd[~valid] = 0
    rc[~valid] = 0
    return fwd, rc, valid


def pack_seeds_at(codes: np.ndarray, positions: np.ndarray, seed_len: int):
    """Pack seeds at the given start positions (gather formulation)."""
    positions = np.asarray(positions, dtype=np.int64)
    window = codes[positions[:, None] + np.arange(seed_len)]
    valid = (window < 4).all(axis=1)
    w = window.astype(np.uint64)
    shifts_f = np.uint64(2) * (np.uint64(seed_len - 1) - np.arange(seed_len, dtype=np.uint64))
    shifts_r = np.uint64(2) * np.arange(seed_len, dtype=np.uint64)
    fwd = (w << shifts_f).sum(axis=1, dtype=np.uint64)
    rc = ((w ^ np.uint64(3)) << shifts_r).sum(axis=1, dtype=np.uint64)
    fwd[~valid] = 0
    rc[~valid] = 0
    return fwd, rc, valid


def seed_to_string(packed: int, seed_len: int) -> str:
    return "".join("AGCT"[(int(packed) >> (2 * (seed_len - 1 - i))) & 3]
                   for i in range(seed_len))


def string_to_seed(s: str) -> tuple[int, int]:
    """ASCII seed -> (bases, reverse complement), as Seed's constructor."""
    code = {"A": 0, "G": 1, "C": 2, "T": 3}
    bases = 0
    rc = 0
    L = len(s)
    for i, ch in enumerate(s.upper()):
        v = code[ch]
        bases |= v << (2 * (L - 1 - i))
        rc |= (v ^ 3) << (2 * i)
    return bases, rc


def murmur_finalize_u32(key: np.ndarray) -> np.ndarray:
    """MurmurHash3 32-bit finalizer (HashTable.h:60-72), vectorized."""
    k = np.asarray(key, dtype=np.uint64) & np.uint64(0xFFFFFFFF)
    M = np.uint64(0xFFFFFFFF)
    k ^= k >> np.uint64(16)
    k = (k * np.uint64(0x85EBCA6B)) & M
    k ^= k >> np.uint64(13)
    k = (k * np.uint64(0xC2B2AE35)) & M
    k ^= k >> np.uint64(16)
    return k.astype(np.uint32)
