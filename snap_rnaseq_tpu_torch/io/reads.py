"""Read containers, clipping, and quality filters.

Analog of the read-level pieces of reference SNAPLib/Read.h:

* clipping trims '#'-quality (phred 2) bases from front/back, reverting to
  the full read when fewer than 50 bases remain (Read.h clip(), see also
  AlignerOptions.cpp:48 — default is ClipFrontAndBack);
* the per-read quality filter mirrors Read::qualityFilter as used by
  SingleAligner.cpp:246-257: at least `min_percent` of bases with phred >=
  `min_phred`.

Batches are uint8 matrices padded with the N code so the device engine can
treat them as fixed-shape; the host keeps ids and clip bookkeeping.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..constants import (DEFAULT_MIN_PERCENT_ABOVE_PHRED, DEFAULT_MIN_PHRED,
                         DEFAULT_PHRED_OFFSET)
from ..utils.tables import BASE_VALUE

NO_CLIPPING = 0
CLIP_FRONT = 1
CLIP_BACK = 2
CLIP_FRONT_AND_BACK = 3

_HASH_Q = ord("#")


@dataclass
class Read:
    rid: bytes
    seq: bytes           # full (unclipped) ASCII sequence
    qual: bytes          # full ASCII quality
    clip_front: int = 0
    clip_back: int = 0

    @property
    def unclipped_length(self) -> int:
        return len(self.seq)

    @property
    def data_length(self) -> int:
        return len(self.seq) - self.clip_front - self.clip_back

    def clipped_seq(self) -> bytes:
        return self.seq[self.clip_front:len(self.seq) - self.clip_back]

    def clipped_qual(self) -> bytes:
        return self.qual[self.clip_front:len(self.qual) - self.clip_back]


def clip_read(read: Read, clipping: int = CLIP_FRONT_AND_BACK) -> Read:
    """Apply the reference clipping rule in place; returns the read."""
    n = len(read.seq)
    back = 0
    front = 0
    if clipping & CLIP_BACK:
        while back < n and read.qual[n - 1 - back] == _HASH_Q:
            back += 1
    if clipping & CLIP_FRONT:
        while front < n - back and read.qual[front] == _HASH_Q:
            front += 1
    if n - front - back < 50:
        front = back = 0
    read.clip_front = front
    read.clip_back = back
    return read


def quality_filter(read: Read,
                   min_percent: float = DEFAULT_MIN_PERCENT_ABOVE_PHRED,
                   min_phred: int = DEFAULT_MIN_PHRED,
                   phred_offset: int = DEFAULT_PHRED_OFFSET) -> bool:
    q = np.frombuffer(read.qual, np.uint8)
    if q.size == 0:
        return False
    ok = (q >= phred_offset + min_phred).sum()
    return ok * 100.0 >= min_percent * q.size


_ACGT_BYTES = (b"A", b"G", b"C", b"T", b"a", b"g", b"c", b"t")


def count_ns(read: Read) -> int:
    """Bases that do NOT code to A/G/C/T (BASE_VALUE >= 4: N and every
    other byte).  bytes.count is ~25x cheaper than the numpy translate for
    a 100bp read, and this runs once per read on the reader thread."""
    s = read.clipped_seq()
    return len(s) - sum(s.count(c) for c in _ACGT_BYTES)


@dataclass
class ReadBatch:
    """Fixed-shape batch of same-length (clipped) reads for the device."""
    reads: list              # list[Read], len <= batch capacity
    codes: np.ndarray        # (B, L) uint8, clipped read codes, N-padded
    quals: np.ndarray        # (B, L) uint8 ASCII

    @property
    def n(self) -> int:
        return len(self.reads)


def make_batch(reads: list, length: int, capacity: int) -> ReadBatch:
    codes = np.full((capacity, length), 4, np.uint8)
    quals = np.full((capacity, length), ord("!"), np.uint8)
    for i, r in enumerate(reads):
        s = BASE_VALUE[np.frombuffer(r.clipped_seq(), np.uint8)]
        codes[i, :s.shape[0]] = np.minimum(s, 4)
        quals[i, :s.shape[0]] = np.frombuffer(r.clipped_qual(), np.uint8)
    return ReadBatch(reads=reads, codes=codes, quals=quals)
