"""FASTQ input (plain or gzip), single or paired.

Analog of reference SNAPLib/FASTQ.{h,cpp}: 4-line records, '@id', sequence,
'+', quality; PairedFASTQReader reads two files in lockstep (FASTQ.h:97-134).
Decompression goes through Python's zlib (the reference links the same zlib,
DataReader.cpp:651-930); batching/lookahead is the host pipeline's job here —
the device engine consumes fixed-shape uint8 batches.
"""
from __future__ import annotations

import gzip
import io
import os

from .reads import Read


def _open(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb", buffering=1 << 20)


def read_fastq(path):
    """Yield Read objects from a FASTQ(.gz) file."""
    with _open(path) as f:
        while True:
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
            yield Read(rid=rid[1:].strip(), seq=seq.strip().upper(),
                       qual=qual.strip())


def read_paired_fastq(path0, path1):
    """Yield (Read, Read) mate pairs from two FASTQ files in lockstep."""
    it0, it1 = read_fastq(path0), read_fastq(path1)
    while True:
        r0 = next(it0, None)
        r1 = next(it1, None)
        if r0 is None and r1 is None:
            return
        if r0 is None or r1 is None:
            raise ValueError("paired FASTQ files have different read counts")
        yield r0, r1


def write_fastq(reads, path):
    with open(path, "wb") as f:
        for r in reads:
            f.write(b"@" + r.rid + b"\n" + r.seq + b"\n+\n" + r.qual + b"\n")
