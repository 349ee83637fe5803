"""Wrapped seed-offset schedules, the analog of reference SeedSequencer.h.

When an aligner has exhausted the non-overlapping seeds of a read (offsets
0, L, 2L, ...), it "wraps" and starts again from an offset chosen to spread
the additional seeds as evenly as possible across the read
(SeedSequencer.h:28-287, used from BaseAligner.cpp:686-745).

The tables below hold, for each seed length 16-25, the starting offset for
wrap counts 1..seedLen-1 (wrap 0 always starts at 0).  Values match the
reference's hard-coded switch tables exactly — including the reference's
quirk for seed length 23, whose table repeats offset 4 and omits 13.
"""
from __future__ import annotations

import functools

import numpy as np

_WRAP_OFFSETS = {
    16: [8, 4, 12, 2, 6, 10, 14, 1, 3, 5, 7, 9, 11, 13, 15],
    17: [8, 4, 12, 2, 6, 10, 14, 1, 3, 5, 7, 9, 11, 13, 15, 16],
    18: [9, 4, 13, 2, 6, 11, 15, 1, 3, 5, 7, 8, 10, 12, 14, 16, 17],
    19: [10, 4, 14, 2, 6, 8, 12, 16, 18, 1, 3, 5, 7, 9, 11, 13, 15, 17],
    20: [10, 5, 15, 2, 7, 12, 17, 3, 9, 11, 13, 19, 1, 4, 6, 8, 14, 18, 16],
    21: [11, 6, 16, 3, 9, 13, 17, 18, 2, 5, 8, 15, 20, 1, 4, 7, 10, 12, 14, 19],
    22: [11, 6, 16, 3, 9, 14, 19, 2, 7, 12, 17, 20, 4, 1, 10, 13, 15, 18, 21, 5, 8],
    23: [12, 6, 17, 3, 9, 20, 14, 1, 4, 7, 10, 15, 18, 21, 4, 2, 5, 11, 16, 19, 22, 8],
    24: [12, 6, 18, 3, 15, 21, 9, 1, 13, 19, 7, 16, 4, 22, 10, 2, 14, 20, 5, 17, 8, 23, 11],
    25: [13, 6, 19, 3, 16, 22, 9, 11, 1, 14, 7, 20, 4, 17, 23, 2, 15, 5, 21, 8, 24, 10, 18, 12],
}


def wrapped_offset(seed_len: int, wrap_count: int) -> int:
    """GetWrappedNextSeedToTest(seedLen, wrapCount)."""
    if wrap_count == 0:
        return 0
    return _WRAP_OFFSETS[seed_len][wrap_count - 1]


@functools.lru_cache(maxsize=None)
def seed_position_schedule(read_len: int, seed_len: int) -> tuple[np.ndarray, np.ndarray]:
    """The order in which the reference visits seed start positions for a read
    of ``read_len``, produced by simulating the exact automaton of
    BaseAligner::AlignRead's seed loop (BaseAligner.cpp:686-745):

      * ``nextSeedToTest`` advances by ``seed_len`` after each visited seed;
      * past the end of the read it wraps to ``wrapped_offset(seed_len, w)``;
      * already-visited positions slide it forward by one (the ``IsSeedUsed``
        inner loop), which also resolves the duplicate entry in the reference's
        seed-length-23 wrap table.

    Returns ``(positions, wraps)``: int32 arrays giving each visited position
    and the wrap round that produced it.  ``wraps[i] + 1`` is the reference's
    ``mostSeedsContainingAnyParticularBase`` while seed i is processed.
    Usually every position in [0, read_len - seed_len] appears exactly once;
    for seed length 23 the reference's duplicated wrap entry can leave a few
    positions unvisited when the wrap budget runs out, and we reproduce that.
    """
    n_possible = read_len - seed_len + 1
    if n_possible <= 0:
        return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32)
    used = np.zeros(n_possible, dtype=bool)
    positions: list[int] = []
    wraps: list[int] = []
    pos = 0
    wrap = 0
    while True:
        if pos >= n_possible:
            wrap += 1
            if wrap >= seed_len:
                break
            pos = wrapped_offset(seed_len, wrap)
            continue
        while pos < n_possible and used[pos]:
            pos += 1
        if pos >= n_possible:
            continue
        used[pos] = True
        positions.append(pos)
        wraps.append(wrap)
        pos += seed_len
    return np.asarray(positions, dtype=np.int32), np.asarray(wraps, dtype=np.int32)
