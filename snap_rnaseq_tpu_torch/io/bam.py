"""BAM output: binary records + BGZF container.

Analog of reference SNAPLib/Bam.{h,cpp}'s writer half (BAMHeader /
BAMHeaderRefSeq / BAMAlignment, Bam.h:37-125; record assembly mirroring the
SAM getSAMData fields, Bam.cpp:449-680) on top of the native BGZF compressor
(native/, the GzipDataWriter analog).

Layout (SAM spec §4.2):
    magic 'BAM\\1' | l_text | text | n_ref | {l_name name\\0 l_ref}*
    per record: block_size refID pos l_read_name mapq bin n_cigar_op flag
                l_seq next_refID next_pos tlen read_name\\0 cigar[] seq4bit
                qual aux
"""
from __future__ import annotations

import struct

import numpy as np

from ..index.genome import Genome

BAM_MAGIC = b"BAM\x01"

# CIGAR op codes: MIDNSHP=X
CIGAR_OPS = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6,
             "=": 7, "X": 8}

# 4-bit base codes indexed by ASCII (=ACMGRSVTWYHKDBN)
_SEQ4 = np.full(256, 15, np.uint8)
for i, ch in enumerate("=ACMGRSVTWYHKDBN"):
    _SEQ4[ord(ch)] = i
    _SEQ4[ord(ch.lower())] = i


def reg2bin(beg: int, end: int) -> int:
    """BAM bin number for [beg, end) (SAM spec §5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def make_bam_header_block(genome: Genome, sam_header: bytes) -> bytes:
    """Uncompressed BAM header: magic + SAM text + reference dictionary."""
    out = bytearray()
    out += BAM_MAGIC
    out += struct.pack("<i", len(sam_header))
    out += sam_header
    ends = np.append(genome.piece_offsets[1:], genome.num_bases)
    out += struct.pack("<i", genome.num_pieces)
    for i, name in enumerate(genome.piece_names):
        nm = name.encode() + b"\x00"
        ln = int(ends[i] - genome.piece_offsets[i]) - genome.padding
        out += struct.pack("<i", len(nm)) + nm + struct.pack("<i", ln)
    return bytes(out)


def pack_bam_record(qname: bytes, flag: int, ref_id: int, pos0: int,
                    mapq: int, cigar: list[tuple[int, str]] | None,
                    next_ref_id: int, next_pos0: int, tlen: int,
                    seq: bytes, qual: bytes, aux: bytes) -> bytes:
    """One BAMAlignment; pos0/next_pos0 are 0-based (-1 = unmapped)."""
    name = qname + b"\x00"
    cig = cigar or []
    n_cigar = len(cig)
    l_seq = len(seq)
    ref_len = sum(c for c, op in cig if op in "MDN=X") or 1
    bin_ = reg2bin(pos0, pos0 + ref_len) if pos0 >= 0 else 4680
    # 4-bit packed sequence
    codes = _SEQ4[np.frombuffer(seq, np.uint8)] if l_seq else \
        np.zeros(0, np.uint8)
    if l_seq % 2:
        codes = np.append(codes, 0)
    packed = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()
    quals = (np.frombuffer(qual, np.uint8) - 33).astype(np.uint8).tobytes() \
        if qual else b"\xff" * l_seq

    body = bytearray()
    body += struct.pack("<iiBBHHHiiii", ref_id, pos0,
                        len(name), mapq & 0xFF, bin_, n_cigar, flag,
                        l_seq, next_ref_id, next_pos0, tlen)
    body += name
    for count, op in cig:
        body += struct.pack("<I", (count << 4) | CIGAR_OPS[op])
    body += packed
    body += quals
    body += aux
    return struct.pack("<i", len(body)) + bytes(body)


def pack_aux(read_group: str | None, program: str | None,
             edit_distance: int | None) -> bytes:
    """RG:Z / PG:Z / NM:i tags (same set the SAM writer emits)."""
    out = bytearray()
    if read_group:
        out += b"RGZ" + read_group.encode() + b"\x00"
    if program:
        out += b"PGZ" + program.encode() + b"\x00"
    if edit_distance is not None:
        out += b"NMi" + struct.pack("<i", edit_distance)
    return bytes(out)


from .sam import SamRecordBuilder  # noqa: E402  (no import cycle: sam never imports bam)


class BamRecordBuilder(SamRecordBuilder):
    """SamRecordBuilder variant rendering binary BAM records.

    Shares field computation with the SAM builder (io/sam.py _fields); only
    _render differs — mirroring how the reference's BAMFormat::writeRead
    reuses getSAMData (Bam.cpp:449-680).
    """

    def __init__(self, genome, use_m=False, read_group="FASTQ",
                 device="cuda"):
        super().__init__(genome, use_m=use_m, read_group=read_group,
                         device=device)
        self._ref_idx = {n: i for i, n in enumerate(genome.piece_names)}

    def _render(self, f: dict) -> bytes:
        ref_id = self._ref_idx.get(f["rname"], -1) if f["rname"] else -1
        if f["rnext"] is None:
            next_ref = -1
            next_pos = -1
        else:
            next_ref = self._ref_idx.get(f["rnext"], -1)
            next_pos = f["pnext"] - 1
        aux = pack_aux(self.read_group, "SNAP", f["edit_distance"])
        return pack_bam_record(
            f["qname"], f["flags"], ref_id, f["pos"] - 1,
            f["mapq"], f["cigar"], next_ref, next_pos, f["tlen"],
            f["seq"], f["qual"], aux)
