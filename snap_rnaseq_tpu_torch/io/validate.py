"""Pure-Python SAM/BAM validity checker (Picard ValidateSamFile analog).

The reference ships Picard's ValidateSamFile.jar and runs it over every
datatest output (reference tests/datatest.py:68-108; a sample report lives
at reference validate.out).  This module re-implements the error-level
checks that matter for an aligner's output so CI fails on malformed
flags/CIGAR/TLEN/mate bookkeeping rather than only on golden-file drift.

`validate_sam(path)` / `validate_bam(path)` return a list of error strings
(empty == valid).  Warning-level Picard findings that the reference corpus
itself triggers (missing RG, missing NM on unmapped mates, etc.) are NOT
errors here, matching validate.out's warnings-only status.
"""
from __future__ import annotations

import re

_CIGAR_RE = re.compile(rb"^(?:\d+[MIDNSHP=X])+$")
_QNAME_RE = re.compile(rb"^[!-?A-~]{1,254}$")

FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST = 0x40
FLAG_SECOND = 0x80
FLAG_SECONDARY = 0x100
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800


def _cigar_lengths(cigar: bytes) -> tuple[int, int]:
    """(query_length, reference_length) consumed by a CIGAR string."""
    qlen = rlen = 0
    for m in re.finditer(rb"(\d+)([MIDNSHP=X])", cigar):
        n, op = int(m.group(1)), m.group(2)
        if op in b"MIS=X":
            qlen += n
        if op in b"MDN=X":
            rlen += n
    return qlen, rlen


def validate_records(lines, *, max_errors: int = 50) -> list[str]:
    """Validate an iterable of raw SAM lines (header + records)."""
    errors: list[str] = []
    refs: dict[bytes, int] = {}
    seen_record = False
    # per-qname primary mate bookkeeping: qname -> {which: (rname,pos,flag)}
    mates: dict[bytes, dict[int, tuple]] = {}

    def err(msg):
        if len(errors) < max_errors:
            errors.append(msg)

    for ln, raw in enumerate(lines, 1):
        line = raw.rstrip(b"\r\n")
        if not line:
            continue
        if line.startswith(b"@"):
            if seen_record:
                err(f"line {ln}: header line after records")
            if line.startswith(b"@SQ"):
                fields = dict(f.split(b":", 1) for f in line.split(b"\t")[1:]
                              if b":" in f)
                sn, lnth = fields.get(b"SN"), fields.get(b"LN")
                if sn is None or lnth is None:
                    err(f"line {ln}: @SQ missing SN or LN")
                    continue
                if sn in refs:
                    err(f"line {ln}: duplicate @SQ {sn.decode()}")
                try:
                    refs[sn] = int(lnth)
                except ValueError:
                    err(f"line {ln}: bad @SQ LN {lnth.decode()}")
            continue

        seen_record = True
        f = line.split(b"\t")
        if len(f) < 11:
            err(f"line {ln}: fewer than 11 fields")
            continue
        qname, flag_s, rname, pos_s, mapq_s, cigar, rnext, pnext_s, \
            tlen_s, seq, qual = f[:11]
        try:
            flag = int(flag_s)
            pos = int(pos_s)
            mapq = int(mapq_s)
            pnext = int(pnext_s)
            tlen = int(tlen_s)
        except ValueError:
            err(f"line {ln}: non-integer numeric field")
            continue

        if qname != b"*" and not _QNAME_RE.match(qname):
            err(f"line {ln}: invalid QNAME {qname[:40]!r}")
        if not 0 <= flag <= 0xFFFF:
            err(f"line {ln}: FLAG out of range {flag}")
        if not 0 <= mapq <= 255:
            err(f"line {ln}: MAPQ out of range {mapq}")

        paired = flag & FLAG_PAIRED
        unmapped = flag & FLAG_UNMAPPED
        if not paired:
            for bit, name in ((FLAG_PROPER, "proper-pair"),
                              (FLAG_MATE_UNMAPPED, "mate-unmapped"),
                              (FLAG_MATE_REVERSE, "mate-reverse"),
                              (FLAG_FIRST, "first-of-pair"),
                              (FLAG_SECOND, "second-of-pair")):
                if flag & bit:
                    err(f"line {ln}: {name} flag set on unpaired read")
        if paired and not (flag & (FLAG_FIRST | FLAG_SECOND)):
            err(f"line {ln}: paired read with neither first nor second flag")
        if unmapped and (flag & FLAG_PROPER):
            err(f"line {ln}: proper-pair flag set on unmapped read")

        if unmapped:
            # Picard allows RNAME/POS on unmapped reads (mate's coords) but
            # requires CIGAR to be absent
            if cigar != b"*":
                err(f"line {ln}: unmapped read has CIGAR {cigar[:20]!r}")
        else:
            if rname == b"*":
                err(f"line {ln}: mapped read with RNAME *")
            elif refs and rname not in refs:
                err(f"line {ln}: RNAME {rname.decode()} not in header")
            if pos <= 0:
                err(f"line {ln}: mapped read with POS {pos}")
            if cigar == b"*":
                err(f"line {ln}: mapped read with no CIGAR")
            elif not _CIGAR_RE.match(cigar):
                err(f"line {ln}: malformed CIGAR {cigar[:30]!r}")
            else:
                qlen, rlen = _cigar_lengths(cigar)
                if seq != b"*" and qlen != len(seq):
                    err(f"line {ln}: CIGAR length {qlen} != SEQ length "
                        f"{len(seq)}")
                if refs and rname in refs and pos + rlen - 1 > refs[rname]:
                    err(f"line {ln}: alignment end {pos + rlen - 1} past "
                        f"end of {rname.decode()} ({refs[rname]})")

        if seq != b"*" and qual != b"*" and len(seq) != len(qual):
            err(f"line {ln}: SEQ and QUAL lengths differ")
        if paired and rnext == b"*" and not (flag & FLAG_MATE_UNMAPPED) \
                and pnext != 0:
            err(f"line {ln}: PNEXT set with RNEXT *")
        if rnext not in (b"*", b"=") and refs and rnext not in refs:
            err(f"line {ln}: RNEXT {rnext.decode()} not in header")

        if paired and not (flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)):
            which = FLAG_FIRST if flag & FLAG_FIRST else FLAG_SECOND
            rec = (rname, pos, flag, rnext, pnext, tlen, ln)
            slot = mates.setdefault(bytes(qname), {})
            if which in slot:
                err(f"line {ln}: duplicate primary record for "
                    f"{qname.decode()}/{which}")
            slot[which] = rec

    # cross-mate checks
    for qname, slot in mates.items():
        if len(slot) != 2:
            err(f"qname {qname.decode()}: mate not found")
            continue
        a = slot[FLAG_FIRST]
        b = slot[FLAG_SECOND]
        for me, other in ((a, b), (b, a)):
            rname, pos, flag, rnext, pnext, tlen, ln = me
            o_rname, o_pos, o_flag = other[0], other[1], other[2]
            if bool(flag & FLAG_MATE_UNMAPPED) != bool(o_flag & FLAG_UNMAPPED):
                err(f"line {ln}: mate-unmapped flag inconsistent with mate")
            if not (o_flag & FLAG_UNMAPPED):
                want = b"=" if o_rname == rname and rname != b"*" else o_rname
                if rnext not in (want, o_rname):
                    err(f"line {ln}: RNEXT {rnext.decode()} != mate RNAME "
                        f"{o_rname.decode()}")
                if pnext != o_pos:
                    err(f"line {ln}: PNEXT {pnext} != mate POS {o_pos}")
                if bool(flag & FLAG_MATE_REVERSE) != \
                        bool(o_flag & FLAG_REVERSE):
                    err(f"line {ln}: mate-reverse flag inconsistent")
        # TLEN: primary mapped pairs on the same reference must have
        # equal-magnitude opposite-sign TLEN (Picard INVALID_TLEN is
        # warning-level; sign symmetry violation is an error here)
        if not ((a[2] | b[2]) & FLAG_UNMAPPED) and a[0] == b[0] \
                and a[5] != -b[5]:
            err(f"qname {qname.decode()}: TLEN {a[5]} vs mate {b[5]} "
                "not symmetric")
    return errors


def validate_sam(path, **kw) -> list[str]:
    with open(path, "rb") as f:
        return validate_records(f, **kw)


def bam_to_sam_lines(path):
    """Render a BAM's records as SAM text lines (header @SQ lines rebuilt
    from the BAM reference dictionary)."""
    from .readers import bam_records
    first = True
    for rec in bam_records(path):
        if first:
            for name, ln in rec["refs"]:
                yield f"@SQ\tSN:{name}\tLN:{ln}".encode()
            first = False
        rname = rec["refs"][rec["ref_id"]][0] if rec["ref_id"] >= 0 else "*"
        if rec["next_ref"] < 0:
            rnext = "*"
        elif rec["next_ref"] == rec["ref_id"]:
            rnext = "="
        else:
            rnext = rec["refs"][rec["next_ref"]][0]
        cigar = "".join(f"{n}{op}" for n, op in rec["cigar"]) or "*"
        yield b"\t".join([
            rec["qname"], str(rec["flag"]).encode(), rname.encode(),
            str(rec["pos"] + 1).encode(), str(rec["mapq"]).encode(),
            cigar.encode(), rnext.encode(), str(rec["next_pos"] + 1).encode(),
            str(rec["tlen"]).encode(), rec["seq"] or b"*",
            rec["qual"] or b"*"])


def validate_bam(path, **kw) -> list[str]:
    """Validate a BAM by converting records to SAM lines first (reference
    datatest.py does the same via samtools view)."""
    return validate_records(bam_to_sam_lines(path), **kw)
