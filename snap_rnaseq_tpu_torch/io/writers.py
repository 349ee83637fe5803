"""Output writer stack: SAM/BAM x {plain, gzip} x {unsorted, sorted}.

Analog of the reference's DataWriter filter pipeline (DataWriter.h:31-153):

* FileFormat-style dispatch by output extension (FileFormat.h:38-100):
  .bam -> BGZF BAM, .sam/.anything -> SAM text, .sam.gz/.gz -> gzip SAM;
* sorted output reproduces SortedDataWriter.cpp:34-478: batches of records
  tagged with their flat genome location spill sorted to a temp file, then a
  k-way merge (heapq, the PriorityQueue.h analog) rewrites the final file
  with the header's SO: field set to `coordinate`;
* compression runs through the native multi-threaded BGZF codec (native/).

Unmapped records sort with key = 2^63-ish so they land at the end, like the
reference's location-sorted writer (SortEntry uses the emitted location).
"""
from __future__ import annotations

import heapq
import os
import struct
import tempfile

from .. import native
from ..index.genome import Genome

UNMAPPED_KEY = (1 << 62) - 1


class _PlainSink:
    def __init__(self, path):
        self._f = open(path, "wb")

    def write(self, blob: bytes):
        self._f.write(blob)

    def close(self):
        self._f.close()


class _GzipSink:
    """BGZF-compressed byte sink (valid gzip; block-parallel like
    GzipDataWriter.h:36-80)."""

    def __init__(self, path, level=6, threads=4, bam_eof=False):
        self._f = open(path, "wb")
        self._buf = bytearray()
        self._level = level
        self._threads = threads
        self._bam_eof = bam_eof

    def write(self, blob: bytes):
        self._buf += blob
        if len(self._buf) >= 16 << 20:
            self.flush()

    def flush(self):
        if self._buf:
            self._f.write(native.bgzf_compress(bytes(self._buf),
                                               level=self._level,
                                               threads=self._threads))
            self._buf.clear()

    def close(self):
        self.flush()
        if self._bam_eof:
            self._f.write(native.BGZF_EOF)
        self._f.close()


class _SortedSpill:
    """Location-sorted record store: in-memory batches spill to one temp
    file; merge() yields records in global key order (SortedDataWriter)."""

    def __init__(self, spill_bytes: int = 256 << 20):
        self._records: list[tuple[int, int, bytes]] = []
        self._seq = 0
        self._bytes = 0
        self._spill_bytes = spill_bytes
        self._runs: list[tuple[int, int]] = []   # (offset, n_records)
        self._tmp = None

    def add(self, key: int, blob: bytes):
        self._records.append((key, self._seq, blob))
        self._seq += 1
        self._bytes += len(blob) + 24
        if self._bytes >= self._spill_bytes:
            self._spill()

    def _spill(self):
        if not self._records:
            return
        if self._tmp is None:
            self._tmp = tempfile.TemporaryFile()
        self._records.sort(key=lambda r: (r[0], r[1]))
        off = self._tmp.tell()
        for key, seq, blob in self._records:
            self._tmp.write(struct.pack("<qqI", key, seq, len(blob)))
            self._tmp.write(blob)
        self._runs.append((off, len(self._records)))
        self._records.clear()
        self._bytes = 0

    def _run_iter(self, offset, count):
        f = os.fdopen(os.dup(self._tmp.fileno()), "rb")
        f.seek(offset)
        for _ in range(count):
            key, seq, ln = struct.unpack("<qqI", f.read(20))
            yield key, seq, f.read(ln)
        f.close()

    def merge(self):
        """Yield record blobs in (key, insertion order)."""
        if self._tmp is None:
            self._records.sort(key=lambda r: (r[0], r[1]))
            for _, _, blob in self._records:
                yield blob
            self._records.clear()
            return
        self._spill()
        self._tmp.flush()
        iters = [self._run_iter(off, n) for off, n in self._runs]
        for _, _, blob in heapq.merge(*iters, key=lambda r: (r[0], r[1])):
            yield blob
        self._tmp.close()


class RecordOutput:
    """Uniform record-oriented output: write_record(key, blob) + close().

    For BAM the header blob must be the *uncompressed* BAM header block; for
    SAM it's the text header.

    bam_finalize (sorted BAM only): dict(path, n_refs, mark_duplicates,
    build_index) — at close the merged record stream gets coordinate
    duplicates flagged (0x400) and a .bai built from the deterministic BGZF
    block layout (the reference's markDuplicates/bamIndex DataWriter
    filters, DataWriter.h:133-152).
    """

    def __init__(self, sink, header_blob: bytes, sorted_output: bool,
                 bam_finalize: dict | None = None):
        self._sink = sink
        self._sorted = _SortedSpill() if sorted_output else None
        self._bam_finalize = bam_finalize if sorted_output else None
        self._header_blob = header_blob
        if self._bam_finalize is None:
            sink.write(header_blob)

    def write_record(self, key: int, blob: bytes):
        if self._sorted is not None:
            self._sorted.add(key if key is not None else UNMAPPED_KEY, blob)
        else:
            self._sink.write(blob)

    # file-object compatibility for code that just streams bytes
    def write(self, blob: bytes):
        self.write_record(UNMAPPED_KEY, blob)

    def close(self):
        if self._bam_finalize is not None:
            self._close_bam_finalize()
            return
        if self._sorted is not None:
            for blob in self._sorted.merge():
                self._sink.write(blob)
        self._sink.close()

    def _close_bam_finalize(self):
        import struct
        from .bai import (BaiBuilder, bam_record_span, set_bam_flag,
                          virtual_offset, walk_bgzf_blocks)
        fin = self._bam_finalize
        blobs = list(self._sorted.merge())

        if fin.get("mark_duplicates"):
            # coordinate duplicates: same (ref, pos, strand, mate ref/pos)
            # after the first stay flagged 0x400 (the markDuplicates filter)
            seen = set()
            for i, blob in enumerate(blobs):
                ref_id, pos = struct.unpack_from("<ii", blob, 4)
                flag = struct.unpack_from("<H", blob, 18)[0]
                if ref_id < 0 or flag & 0x4:
                    continue
                next_ref, next_pos = struct.unpack_from("<ii", blob, 24)
                key = (ref_id, pos, flag & 0x10, next_ref, next_pos)
                if key in seen:
                    blobs[i] = set_bam_flag(blob, 0x400)
                else:
                    seen.add(key)

        header_z = native.bgzf_compress(self._header_blob)
        body = bytearray()
        offsets = []
        for blob in blobs:
            offsets.append(len(body))
            body += blob
        body_z = native.bgzf_compress(bytes(body))
        raw = self._sink._f if hasattr(self._sink, "_f") else None
        raw.write(header_z)
        raw.write(body_z)
        raw.write(native.BGZF_EOF)
        raw.close()

        if fin.get("build_index"):
            block_offs = walk_bgzf_blocks(body_z)
            bai = BaiBuilder(fin["n_refs"])
            base = len(header_z)
            for blob, uoff in zip(blobs, offsets):
                ref_id, pos, end, flag = bam_record_span(blob)
                if ref_id < 0:
                    continue
                v0 = virtual_offset(uoff, block_offs, base)
                v1 = virtual_offset(uoff + len(blob), block_offs, base) \
                    if uoff + len(blob) < len(body) else \
                    ((base + block_offs[-1]) << 16) | (len(body) % 0xFF00)
                bai.add(ref_id, pos, end, v0, v1)
            bai.write(fin["path"] + ".bai")


def open_output(path: str, genome: Genome, sam_header: bytes,
                sorted_output: bool = False, compression_threads: int = 4,
                mark_duplicates: bool = True, build_index: bool = True):
    """FileFormat dispatch: returns (RecordOutput, is_bam).

    Like the reference, sorted BAM output gets duplicate marking and a .bai
    by default; `-S i`/`-S d` suppress them (AlignerOptions usage text)."""
    from .bam import make_bam_header_block
    lower = path.lower()
    if lower.endswith(".bam"):
        sink = _GzipSink(path, threads=compression_threads, bam_eof=True)
        header = make_bam_header_block(genome, sam_header)
        finalize = None
        if sorted_output and (mark_duplicates or build_index):
            finalize = dict(path=path, n_refs=genome.num_pieces,
                            mark_duplicates=mark_duplicates,
                            build_index=build_index)
        return RecordOutput(sink, header, sorted_output, finalize), True
    if lower.endswith(".gz"):
        sink = _GzipSink(path, threads=compression_threads)
        return RecordOutput(sink, sam_header, sorted_output), False
    return RecordOutput(_PlainSink(path), sam_header, sorted_output), False


def make_output_and_builder(path: str, genome: Genome, *, sorted_output: bool,
                            use_m: bool, read_group: str | None,
                            command_line: str, mark_duplicates: bool = True,
                            build_index: bool = True, device="cuda"):
    """One-stop output setup: header + format dispatch + record builder.

    Returns (RecordOutput, SamRecordBuilder-or-BamRecordBuilder); the
    builder computes CIGARs on `device`.
    """
    from .bam import BamRecordBuilder
    from .sam import SamRecordBuilder, make_header
    header = make_header(genome, sorted_output=sorted_output,
                         command_line=command_line)
    writer, is_bam = open_output(path, genome, header,
                                 sorted_output=sorted_output,
                                 mark_duplicates=mark_duplicates,
                                 build_index=build_index)
    cls = BamRecordBuilder if is_bam else SamRecordBuilder
    return writer, cls(genome, use_m=use_m, read_group=read_group,
                       device=device)
