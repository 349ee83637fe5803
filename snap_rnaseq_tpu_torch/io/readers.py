"""SAM/BAM input readers + unified read-supplier dispatch.

Analog of the reference's input half:

* SAMReader (SAM.h:50+): parse records, recover the as-sequenced read by
  un-reverse-complementing FLAG 0x10 records;
* BAMReader (Bam.h:291): BGZF-decompress (native/), parse the binary
  header + records;
* PairedReadMatcher (PairedReadMatcher.cpp:34-55): pair mates from a single
  interleaved stream by read id;
* ReadSupplier dispatch by extension (FASTQ/FASTQ.gz/SAM/BAM), the
  FileFormat + supplier-generator tower of Read.h:49-79 collapsed to two
  generator functions.
"""
from __future__ import annotations

import struct

import numpy as np

from .. import native
from ..utils.tables import COMPLEMENT
from .reads import Read

_BAM_CIGAR_CHARS = "MIDNSHP=X"
_SEQ4_CHARS = b"=ACMGRSVTWYHKDBN"


def _unrc(seq: bytes, qual: bytes) -> tuple[bytes, bytes]:
    rc = COMPLEMENT[np.frombuffer(seq, np.uint8)][::-1].tobytes()
    return rc, qual[::-1]


def read_sam(path):
    """Yield Read objects from a SAM file (as-sequenced orientation)."""
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"@") or not line.strip():
                continue
            fields = line.rstrip(b"\n").split(b"\t")
            if len(fields) < 11:
                raise ValueError(f"bad SAM record: {line[:60]!r}")
            flag = int(fields[1])
            seq, qual = fields[9], fields[10]
            if seq == b"*":
                continue
            if flag & 0x10:
                seq, qual = _unrc(seq, qual)
            yield Read(rid=fields[0], seq=seq, qual=qual)


def bam_records(path):
    """Yield raw BAM record dicts from a BAM file."""
    with open(path, "rb") as f:
        data = native.bgzf_decompress(f.read())
    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM file")
    l_text = struct.unpack_from("<i", data, 4)[0]
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    refs = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]
        name = data[off + 4:off + 4 + l_name - 1].decode()
        l_ref = struct.unpack_from("<i", data, off + 4 + l_name)[0]
        refs.append((name, l_ref))
        off += 8 + l_name
    while off < len(data):
        block_size = struct.unpack_from("<i", data, off)[0]
        body = data[off + 4:off + 4 + block_size]
        off += 4 + block_size
        yield _parse_bam_body(body, refs)


def _parse_bam_body(body: bytes, refs) -> dict:
    """Decode one BAM record body (everything after block_size)."""
    (ref_id, pos, l_read_name, mapq, bin_, n_cigar, flag, l_seq,
     next_ref, next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", body)
    p = 32
    qname = body[p:p + l_read_name - 1]
    p += l_read_name
    cigar = []
    for _ in range(n_cigar):
        v = struct.unpack_from("<I", body, p)[0]
        cigar.append((v >> 4, _BAM_CIGAR_CHARS[v & 0xF]))
        p += 4
    packed = body[p:p + (l_seq + 1) // 2]
    p += (l_seq + 1) // 2
    quals = body[p:p + l_seq]
    p += l_seq
    codes = np.frombuffer(packed, np.uint8)
    hi = codes >> 4
    lo = codes & 0xF
    interleaved = np.empty(hi.size * 2, np.uint8)
    interleaved[0::2] = hi
    interleaved[1::2] = lo
    seq = bytes(bytearray(_SEQ4_CHARS[c] for c in interleaved[:l_seq]))
    qual = bytes((np.frombuffer(quals, np.uint8) + 33).astype(np.uint8)) \
        if l_seq else b""
    return dict(qname=qname, flag=flag, ref_id=ref_id, pos=pos, mapq=mapq,
                cigar=cigar, next_ref=next_ref, next_pos=next_pos,
                tlen=tlen, seq=seq, qual=qual, aux=body[p:], refs=refs)


def read_bam(path):
    """Yield Read objects from a BAM file (as-sequenced orientation)."""
    for rec in bam_records(path):
        seq, qual = rec["seq"], rec["qual"]
        if not seq:
            continue
        if rec["flag"] & 0x10:
            seq, qual = _unrc(seq, qual)
        yield Read(rid=rec["qname"], seq=seq, qual=qual)


def open_read_supplier(path):
    """Single-end supplier dispatch by extension (FileFormat analog)."""
    from . import fastq as fq
    lower = str(path).lower()
    if lower.endswith(".sam"):
        return read_sam(path)
    if lower.endswith(".bam"):
        return read_bam(path)
    return fq.read_fastq(path)


class PairMatchStats:
    """Orphan accounting for interleaved pairing (the reference's
    "discarding %d+%d unpaired reads" counters,
    PairedReadMatcher.cpp:104-110 + overflowMatched)."""

    def __init__(self):
        self.pairs_matched = 0
        self.window_matched = 0      # matched within the rolling window
        self.overflow_matched = 0    # matched beyond it (overflow map)
        self.orphans_dropped = 0


# two 10,000-read map generations before spilling to overflow — the
# reference's unmatched[2] batch window (PairedReadMatcher.cpp:85,
# constructor VariableSizeMap(10000) x 2)
_MATCH_WINDOW = 10_000


def _pair_interleaved(reads, match_stats: PairMatchStats | None = None):
    """PairedReadMatcher: pair mates by qname from one stream.

    The key drops everything after the first space/tab and a trailing /1
    or /2 (PairedReadMatcher.cpp:113-119).  Mates may arrive in any order
    and ANY distance apart: a two-generation window of recent unmatched
    reads rolls into an unbounded overflow map exactly like the
    reference's unmatched[2] -> overflow spill
    (PairedReadMatcher.cpp:120-138) — so a coordinate-sorted SAM with
    mates megabytes apart still pairs fully.  Pairs are yielded
    (ARRIVING read, stored mate), the reference's (read1=current,
    read2=matched) order (PairedReadMatcher.cpp:148-188) — which is why a
    normally-interleaved /1,/2 stream reaches the writer as (/2,/1) and
    the QNAME-truncation typo (io/sam.py) then leaves ids untouched.
    Reads whose mate never appears are DROPPED with a warning at end of
    stream, mirroring "discarding %d+%d unpaired reads at eof"
    (PairedReadMatcher.cpp:104-110), not an error."""
    import sys
    st = match_stats or PairMatchStats()
    window: list[dict[bytes, Read]] = [{}, {}]
    overflow: dict[bytes, Read] = {}
    since_roll = 0
    for r in reads:
        key = bytes(r.rid.split(b" ")[0].split(b"\t")[0])
        if len(key) > 2 and key[-2:] in (b"/1", b"/2"):
            key = key[:-2]
        mate = window[0].pop(key, None) or window[1].pop(key, None)
        if mate is not None:
            st.pairs_matched += 1
            st.window_matched += 1
            yield r, mate
            continue
        mate = overflow.pop(key, None)
        if mate is not None:
            st.pairs_matched += 1
            st.overflow_matched += 1
            yield r, mate
            continue
        window[0][key] = r
        since_roll += 1
        if since_roll >= _MATCH_WINDOW:
            overflow.update(window[1])
            window[1] = window[0]
            window[0] = {}
            since_roll = 0
    n_win = len(window[0]) + len(window[1])
    n_ovf = len(overflow)
    if n_win + n_ovf:
        st.orphans_dropped += n_win + n_ovf
        print(f"warning: PairedReadMatcher discarding {n_win}+{n_ovf} "
              "unpaired reads at eof", file=sys.stderr)


def read_ids_match(id0: bytes, id1: bytes) -> bool:
    """Mate IDs match up to the first space or '/' (readIdsMatch,
    SAM.cpp: byte compare that stops at NUL/' '/'/', so foo/1 pairs with
    foo/2)."""
    for i in range(max(len(id0), len(id1)) + 1):
        c0 = id0[i] if i < len(id0) else 0
        c1 = id1[i] if i < len(id1) else 0
        if c0 != c1:
            return False
        if c0 in (0, 0x20, 0x2F):
            return True
    return True


def _check_pair_ids(pairs):
    for r0, r1 in pairs:
        if not read_ids_match(r0.rid, r1.rid):
            raise ValueError(
                f"Unmatched read IDs {r0.rid!r} and {r1.rid!r}.  "
                "Use the -I option to ignore this.")
        yield r0, r1


def open_paired_read_supplier(path0, path1=None, check_ids: bool = True):
    """Paired supplier: two FASTQs in lockstep, one interleaved input
    (SAM/BAM/FASTQ — mates paired by qname, PairedReadMatcher.cpp:34-55),
    or LISTS of paths processed as consecutive pairs (the reference's
    'FASTQ files must come in pairs' multi-input form).

    check_ids enforces the reference's mate-ID check (PairedAligner.cpp:445,
    disabled there with -I); the interleaved path pairs BY id so it never
    needs the check.
    """
    from . import fastq as fq
    if isinstance(path0, (list, tuple)):
        p1s = path1 if isinstance(path1, (list, tuple)) else \
            [path1] * len(path0)

        def chain():
            for a, b in zip(path0, p1s):
                yield from open_paired_read_supplier(a, b, check_ids)
        return chain()
    lower = str(path0).lower()
    if path1 is None or lower.endswith((".sam", ".bam")):
        return _pair_interleaved(open_read_supplier(path0))
    pairs = fq.read_paired_fastq(path0, path1)
    return _check_pair_ids(pairs) if check_ids else pairs


def open_multi_read_supplier(paths):
    """MultiInputReadSupplier analog (MultiInputReadSupplier.h:28-75):
    consume several single-end inputs in sequence (the reference
    round-robins batches; ordering within the output is unspecified there
    too, so sequential chaining is equivalent)."""
    for p in paths:
        yield from open_read_supplier(p)


# ----------------------------------------------------------------------
# indexed region queries (.bai + BGZF virtual-offset seeking)
# ----------------------------------------------------------------------

class _BgzfSeekReader:
    """Random access into a BGZF file by virtual offset.

    A virtual offset packs (compressed block start << 16 | offset within
    the decompressed block) — the same encoding our BaiBuilder emits and
    the reference's bamIndex filter computes via its logical->physical
    offset map (GzipDataWriter.h:63-74)."""

    def __init__(self, path: str):
        self._f = open(path, "rb")

    def close(self):
        self._f.close()

    def _block(self, coffset: int):
        """Decompress the BGZF block at compressed offset -> (data, next)."""
        import zlib
        self._f.seek(coffset)
        head = self._f.read(18)
        if len(head) < 18:
            return b"", None
        bsize = struct.unpack_from("<H", head, 16)[0] + 1
        rest = self._f.read(bsize - 18)
        data = zlib.decompress(head + rest, 31)
        return data, coffset + bsize

    def records(self, vbeg: int, vend: int):
        """Yield (voff, body) for records starting in [vbeg, vend)."""
        coff = vbeg >> 16
        buf = bytearray()
        blocks = []                      # (start offset in buf, coffset)
        next_coff = coff

        def fill(need: int) -> bool:
            nonlocal next_coff
            while len(buf) < need and next_coff is not None:
                blocks.append((len(buf), next_coff))
                data, next_coff = self._block(next_coff)
                if not data and next_coff is None:
                    return len(buf) >= need
                buf.extend(data)
            return len(buf) >= need

        def voff_at(p: int) -> int:
            # last block whose buffer start is <= p (few blocks per chunk,
            # linear scan is fine)
            best = blocks[0]
            for start, c in blocks:
                if start <= p:
                    best = (start, c)
            return (best[1] << 16) | (p - best[0])

        p = vbeg & 0xFFFF
        while True:
            if not fill(p + 4):
                return
            voff = voff_at(p)
            if voff >= vend:
                return
            size = struct.unpack_from("<i", buf, p)[0]
            if not fill(p + 4 + size):
                return
            yield voff, bytes(buf[p + 4:p + 4 + size])
            p += 4 + size


def bam_header_refs(path: str):
    """(ref name, length) list straight from a BAM's header block."""
    from . import bai as bai_mod
    r = _BgzfSeekReader(path)
    try:
        data = bytearray()
        coff = 0
        while len(data) < 12:
            blk, coff = r._block(coff)
            if not blk:
                break
            data.extend(blk)
        l_text = struct.unpack_from("<i", data, 4)[0]
        need = 8 + l_text + 4
        while len(data) < need + 8:
            blk, coff = r._block(coff)
            if not blk:
                break
            data.extend(blk)
        n_ref = struct.unpack_from("<i", data, 8 + l_text)[0]
        off = 12 + l_text
        refs = []
        for _ in range(n_ref):
            while len(data) < off + 8:
                blk, coff = r._block(coff)
                data.extend(blk)
            l_name = struct.unpack_from("<i", data, off)[0]
            while len(data) < off + 8 + l_name:
                blk, coff = r._block(coff)
                data.extend(blk)
            name = bytes(data[off + 4:off + 4 + l_name - 1]).decode()
            l_ref = struct.unpack_from("<i", data, off + 4 + l_name)[0]
            refs.append((name, l_ref))
            off += 8 + l_name
        return refs
    finally:
        r.close()


def bam_query(path: str, ref: str | int, beg: int, end: int,
              bai_path: str | None = None):
    """Yield record dicts overlapping [beg, end) on `ref` (0-based
    half-open), using the .bai the sorted-BAM writer produced.

    The binning/linear index walk follows SAM spec §5.3 (reg2bins +
    16kb-window pruning); record overlap is judged on the reference span
    implied by the CIGAR, like samtools view region semantics."""
    from .bai import bam_record_span, read_bai, region_chunks
    refs = bam_header_refs(path)
    if isinstance(ref, int):
        ref_id = ref
    else:
        names = [n for n, _ in refs]
        ref_id = names.index(ref)
    bai = read_bai(bai_path or path + ".bai")
    if ref_id >= len(bai):
        return
    reader = _BgzfSeekReader(path)
    try:
        for vbeg, vend in region_chunks(bai[ref_id], beg, end):
            for voff, body in reader.records(vbeg, vend):
                rid, pos, rend, _flag = bam_record_span(
                    struct.pack("<i", len(body)) + body)
                if rid != ref_id or pos >= end:
                    continue
                if rend <= beg:
                    continue
                rec = _parse_bam_body(body, refs)
                yield rec
    finally:
        reader.close()
