"""Input range splitting for multi-host data parallelism.

Role of reference SNAPLib/RangeSplitter.{h,cpp}: carve a directly-splittable
input (plain FASTQ / SAM) into byte ranges that workers consume
independently (RangeSplitter.h:37-55 computes chunks; FASTQReader's
``skipPartialRecord`` then snaps a range start to the next record
boundary).  The reference steals ranges between threads with an atomic
cursor; across HOSTS there is no cheap shared cursor, so we use static
contiguous ranges — the reference's own chunk formula at divisor 1 — which
also keeps every host's output a contiguous slice of the input (stable
merge order).

FASTQ boundary snapping: a '@' at a line start is ambiguous (quality lines
may start with '@'), so a candidate record start requires line[i] to begin
with '@' AND line[i+2] to begin with '+' (the FASTQ separator), the same
disambiguation the reference uses (FASTQ.cpp skipPartialRecord).

Paired two-file FASTQ: ranges are computed on file 0 and mapped to file 1
by read-ID correspondence — scan file 1 from the PROPORTIONAL byte offset
(records appear in identical order; mate files differ only in id suffix /
read bytes) until the record whose id pairs with the range-start id of
file 0, growing the search window geometrically.  This costs O(skew) I/O
instead of a serial full-file record count.
"""
from __future__ import annotations

import os

from .readers import read_ids_match

_WINDOW = 1 << 20


def _snap_to_fastq_record(f, offset: int, file_size: int) -> int:
    """Smallest record-start byte offset >= offset (file_size if none)."""
    if offset <= 0:
        return 0
    if offset >= file_size:
        return file_size
    f.seek(offset)
    # drop the (possibly partial) line containing `offset`
    carry = offset + len(f.readline())
    window = _WINDOW
    while carry < file_size:
        f.seek(carry)
        buf = f.read(window)
        lines = buf.split(b"\n")
        starts = []
        p = 0
        for ln in lines:
            starts.append(p)
            p += len(ln) + 1
        for i in range(len(lines) - 3):
            if lines[i][:1] == b"@" and lines[i + 2][:1] == b"+":
                return carry + starts[i]
        if carry + len(buf) >= file_size:
            return file_size
        # no boundary in window (pathological long lines): widen
        window *= 4
    return file_size


def split_fastq_ranges(path: str, n: int) -> list[tuple[int, int]]:
    """n contiguous, record-aligned (start, end) byte ranges covering the
    file.  Ranges may be empty for tiny files."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        bounds = [0]
        for k in range(1, n):
            b = _snap_to_fastq_record(f, size * k // n, size)
            bounds.append(max(b, bounds[-1]))
        bounds.append(size)
    return [(bounds[k], bounds[k + 1]) for k in range(n)]


def read_fastq_range(path: str, start: int, end: int):
    """Yield Read objects for the records in [start, end) of a plain FASTQ.

    A record belongs to the range iff its FIRST byte is in [start, end) —
    ranges from split_fastq_ranges partition the file exactly.
    """
    from .fastq import read_fastq
    from .reads import Read
    if str(path).endswith(".gz"):
        # gzip streams are not byte-splittable (reference routes .gz through
        # the queue-based supplier instead, ReadSupplierQueue.h); a single
        # range covering the whole file keeps the API total.
        if start == 0:
            yield from read_fastq(path)
        return
    with open(path, "rb", buffering=1 << 20) as f:
        f.seek(start)
        pos = start
        while pos < end:
            rid = f.readline()
            if not rid:
                return
            seq = f.readline()
            plus = f.readline()
            qual = f.readline()
            if not qual:
                raise ValueError(f"truncated FASTQ record in {path}")
            if not rid.startswith(b"@"):
                raise ValueError(f"bad FASTQ record id line: {rid[:50]!r}")
            pos += len(rid) + len(seq) + len(plus) + len(qual)
            yield Read(rid=rid[1:].strip(), seq=seq.strip().upper(),
                       qual=qual.strip())


def _first_record_id(f, offset: int, size: int) -> bytes | None:
    if offset >= size:
        return None
    f.seek(offset)
    rid = f.readline()
    return rid[1:].strip() if rid[:1] == b"@" else None


def mate_range_for(path1: str, id0_first: bytes | None,
                   frac_lo: float) -> int:
    """Byte offset in mate file `path1` of the record pairing with
    ``id0_first`` (the first read id of a file-0 range).  None -> EOF."""
    size = os.path.getsize(path1)
    if id0_first is None:
        return size
    guess = int(size * frac_lo)
    with open(path1, "rb") as f:
        back = _WINDOW
        while True:
            lo = max(0, guess - back)
            start = _snap_to_fastq_record(f, lo, size)
            # walk records forward looking for the matching id
            f.seek(start)
            pos = start
            scanned = 0
            while pos < size and scanned < 4 * back + _WINDOW:
                rid = f.readline()
                if not rid:
                    break
                rest = f.readline(); rest2 = f.readline(); rest3 = f.readline()
                if read_ids_match(id0_first, rid[1:].strip()):
                    return pos
                pos += len(rid) + len(rest) + len(rest2) + len(rest3)
                scanned += len(rid) + len(rest) + len(rest2) + len(rest3)
            if lo == 0 and pos >= size:
                raise ValueError(
                    f"mate id {id0_first!r} not found in {path1}")
            back *= 4


def split_paired_fastq_ranges(path0: str, path1: str, n: int):
    """Record-consistent ranges over a mate-pair of FASTQ files.

    Returns [((s0, e0), (s1, e1)), ...] such that range k of file 0 and
    range k of file 1 hold the same pair indexes.
    """
    size0 = os.path.getsize(path0)
    size1 = os.path.getsize(path1)
    r0 = split_fastq_ranges(path0, n)
    bounds1 = [0]
    with open(path0, "rb") as f0:
        for k in range(1, n):
            start0 = r0[k][0]
            id0 = _first_record_id(f0, start0, size0)
            b = mate_range_for(path1, id0, start0 / max(size0, 1))
            bounds1.append(max(b, bounds1[-1]))
    bounds1.append(size1)
    return [(r0[k], (bounds1[k], bounds1[k + 1])) for k in range(n)]


def read_paired_fastq_range(path0, path1, range0, range1, check_ids=True):
    """Lockstep mate-pair iteration over consistent ranges (the range
    analog of fastq.read_paired_fastq)."""
    it0 = read_fastq_range(path0, *range0)
    it1 = read_fastq_range(path1, *range1)
    while True:
        r0 = next(it0, None)
        r1 = next(it1, None)
        if r0 is None and r1 is None:
            return
        if r0 is None or r1 is None:
            raise ValueError("paired FASTQ ranges have different read counts")
        if check_ids and not read_ids_match(r0.rid, r1.rid):
            raise ValueError(f"mismatched mate ids {r0.rid!r} / {r1.rid!r}")
        yield r0, r1
