"""BAM index (.bai) generation for coordinate-sorted BAM output.

Analog of the reference's bamIndex DataWriter filter hook
(DataWriter.h:133-152, GzipDataWriter.h:63-74: the logical->physical offset
map exists exactly to produce BAM virtual offsets).  Here the whole sorted
record stream is compressed in deterministic 65,280-byte BGZF blocks, so a
record's virtual offset is computable from its uncompressed offset plus the
compressed block offsets recovered by walking the BSIZE fields of the
emitted stream — no bookkeeping during compression.

Format (SAM spec §5.2): magic BAI\\1, per reference: binning index
(bin -> chunks of virtual offsets) + linear index (16kb window -> min
virtual offset).
"""
from __future__ import annotations

import struct

BGZF_BLOCK = 0x10000 - 256          # uncompressed bytes per BGZF block
BAI_MAGIC = b"BAI\x01"


def walk_bgzf_blocks(compressed: bytes) -> list[int]:
    """Compressed byte offset of each BGZF block (BSIZE walk)."""
    offs = []
    pos = 0
    n = len(compressed)
    while pos < n:
        offs.append(pos)
        bsize = struct.unpack_from("<H", compressed, pos + 16)[0] + 1
        pos += bsize
    return offs


def virtual_offset(uoffset: int, block_offsets: list[int],
                   base_voffset: int = 0) -> int:
    """Uncompressed stream offset -> BAM virtual offset."""
    b = uoffset // BGZF_BLOCK
    within = uoffset % BGZF_BLOCK
    return ((base_voffset + block_offsets[b]) << 16) | within


class BaiBuilder:
    """Accumulates (ref_id, pos, end, voff_start, voff_end) per record."""

    def __init__(self, n_refs: int):
        self.n_refs = n_refs
        self.bins = [dict() for _ in range(n_refs)]      # bin -> [chunks]
        self.linear = [dict() for _ in range(n_refs)]    # window -> min voff

    def add(self, ref_id: int, pos: int, end: int, voff_start: int,
            voff_end: int):
        if ref_id < 0 or ref_id >= self.n_refs:
            return
        from .bam import reg2bin
        b = reg2bin(pos, max(end, pos + 1))
        chunks = self.bins[ref_id].setdefault(b, [])
        if chunks and chunks[-1][1] == voff_start:
            chunks[-1] = (chunks[-1][0], voff_end)
        else:
            chunks.append((voff_start, voff_end))
        for w in range(pos >> 14, (max(end - 1, pos) >> 14) + 1):
            cur = self.linear[ref_id].get(w)
            if cur is None or voff_start < cur:
                self.linear[ref_id][w] = voff_start

    def write(self, path: str):
        out = bytearray()
        out += BAI_MAGIC
        out += struct.pack("<i", self.n_refs)
        for r in range(self.n_refs):
            bins = self.bins[r]
            out += struct.pack("<i", len(bins))
            for b in sorted(bins):
                chunks = bins[b]
                out += struct.pack("<Ii", b, len(chunks))
                for beg, end in chunks:
                    out += struct.pack("<QQ", beg, end)
            lin = self.linear[r]
            n_win = (max(lin) + 1) if lin else 0
            out += struct.pack("<i", n_win)
            last = 0
            for w in range(n_win):
                v = lin.get(w, last)
                last = v
                out += struct.pack("<Q", v)
        with open(path, "wb") as f:
            f.write(bytes(out))


def bam_record_span(blob: bytes) -> tuple[int, int, int, int]:
    """(ref_id, pos, end, flag) from one raw BAM record blob."""
    ref_id, pos = struct.unpack_from("<ii", blob, 4)
    l_read_name = blob[12]
    n_cigar, flag = struct.unpack_from("<HH", blob, 16)
    ref_len = 0
    coff = 4 + 32 + l_read_name
    for i in range(n_cigar):
        v = struct.unpack_from("<I", blob, coff + 4 * i)[0]
        op = v & 0xF
        if op in (0, 2, 3, 7, 8):       # M D N = X consume reference
            ref_len += v >> 4
    return ref_id, pos, pos + max(ref_len, 1), flag


def set_bam_flag(blob: bytes, flag_bits: int) -> bytes:
    """Return the blob with flag bits OR-ed in (flag at body offset 14)."""
    flag = struct.unpack_from("<H", blob, 18)[0] | flag_bits
    b = bytearray(blob)
    struct.pack_into("<H", b, 18, flag)
    return bytes(b)


# ----------------------------------------------------------------------
# query side: .bai parsing + region -> candidate chunks (SAM spec §5.3)
# ----------------------------------------------------------------------

def read_bai(path: str) -> list[tuple[dict, list]]:
    """Parse a .bai file -> per reference (bins{bin: [(vbeg, vend)]},
    linear[list of min voffs per 16kb window])."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != BAI_MAGIC:
        raise ValueError("not a BAI file")
    n_ref = struct.unpack_from("<i", data, 4)[0]
    off = 8
    out = []
    for _ in range(n_ref):
        n_bin = struct.unpack_from("<i", data, off)[0]
        off += 4
        bins = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                beg, end = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((beg, end))
            bins[b] = chunks
        n_intv = struct.unpack_from("<i", data, off)[0]
        off += 4
        linear = list(struct.unpack_from(f"<{n_intv}Q", data, off))
        off += 8 * n_intv
        out.append((bins, linear))
    return out


def reg2bins(beg: int, end: int) -> list[int]:
    """All bins a [beg, end) region can fall in (SAM spec §5.3 algorithm)."""
    end -= 1
    bins = [0]
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


def region_chunks(bai_ref: tuple[dict, list], beg: int, end: int):
    """Candidate (vbeg, vend) chunks for a region, linear-index pruned,
    sorted and merged."""
    bins, linear = bai_ref
    min_voff = 0
    w = beg >> 14
    if linear:
        min_voff = linear[min(w, len(linear) - 1)]
    chunks = []
    for b in reg2bins(beg, end):
        for cb, ce in bins.get(b, ()):
            if ce > min_voff:
                chunks.append((max(cb, min_voff), ce))
    chunks.sort()
    merged = []
    for cb, ce in chunks:
        if merged and cb <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
        else:
            merged.append((cb, ce))
    return merged
