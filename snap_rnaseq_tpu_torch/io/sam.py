"""SAM output (and, later rounds, input).

Analog of reference SNAPLib/SAM.cpp's writer half:

* header: @HD VN:1.4 SO:..., an @RG line (default "ID:FASTQ SM:sample"),
  @PG ID:SNAP, and one @SQ per piece whose LN excludes the padding
  (SAM.cpp:736-799);
* records follow getSAMData (SAM.cpp:820-975): unmapped reads are emitted
  forward with RNAME */POS 0/MAPQ 0; mapped reads carry 1-based POS within
  their piece, soft clips around the aligner's CIGAR, and NM:i:<dist>;
* SEQ/QUAL are the full unclipped read, reverse-complemented when the
  alignment is RC;
* QNAME is truncated at the first space (SAM.cpp:1092-1096);
* transcriptome alignments are rewritten to genome coordinates with splice
  junction N ops before emission (SAM.cpp:1040-1066) — see rna/splice.py.

CIGARs for a batch of records are computed with the batched device kernel
(ops/cigar.py, on the builder's `device`), so the host loop only formats
strings.
"""
from __future__ import annotations

import numpy as np

from ..constants import INVALID_GENOME_LOCATION, MAX_K, MAX_READ_LENGTH
from ..index.genome import Genome
from ..ops.cigar import compute_cigars, tokens_to_string
from ..utils.tables import BASE_VALUE, COMPLEMENT
from .reads import Read

# SAM flags
FLAG_PAIRED = 0x1
FLAG_ALL_ALIGNED = 0x2
FLAG_UNMAPPED = 0x4
FLAG_NEXT_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_NEXT_REVERSED = 0x20
FLAG_FIRST_SEGMENT = 0x40
FLAG_LAST_SEGMENT = 0x80

# result codes shared with models.single
NOT_FOUND, SINGLE_HIT, MULTIPLE_HITS = 0, 1, 2


def passes_filter(result: int, mode: str) -> bool:
    """-F output filter (AlignerOptions passFilter): a=aligned only,
    s=single hit only, u=unaligned only; '' = everything."""
    if not mode:
        return True
    if mode == "a":
        return result != NOT_FOUND
    if mode == "s":
        return result == SINGLE_HIT
    if mode == "u":
        return result == NOT_FOUND
    return True


def make_header(genome: Genome, sorted_output: bool = False,
                rg_line: str | None = None, command_line: str = "snap-rna-tpu",
                version: str = "0.1") -> bytes:
    lines = [f"@HD\tVN:1.4\tSO:{'coordinate' if sorted_output else 'unsorted'}"]
    lines.append(rg_line or "@RG\tID:FASTQ\tSM:sample")
    lines.append(f"@PG\tID:SNAP\tPN:SNAP\tCL:{command_line}\tVN:{version}")
    ends = np.append(genome.piece_offsets[1:], genome.num_bases)
    for i, name in enumerate(genome.piece_names):
        ln = int(ends[i] - genome.piece_offsets[i]) - genome.padding
        lines.append(f"@SQ\tSN:{name}\tLN:{ln}")
    return ("\n".join(lines) + "\n").encode()


class SamRecordBuilder:
    """Accumulates one batch of alignment results, computes all CIGARs with
    one device call, then formats records."""

    def __init__(self, genome: Genome, use_m: bool = False,
                 read_group: str | None = "FASTQ", device="cuda"):
        self.genome = genome
        self.use_m = use_m
        self.read_group = read_group
        self.device = device      # where the CIGAR kernel runs
        self._items = []

    def add(self, read: Read, result: int, location: int, direction: int,
            mapq: int, *, mate=None, splice_rewriter=None, tsource=None,
            score=None):
        """mate: optional dict(result, location, direction, read, first) for
        paired output; splice_rewriter: callable(tokens) -> tokens rewriting
        transcript-space CIGAR tokens to genome space (N ops inserted);
        tsource: optional (codes_array, tlocation) — the transcriptome the
        CIGAR text is gathered from instead of the output genome
        (SAM.cpp:1040-1066's transcriptome branch);
        score: the engine's edit distance for this alignment, when known.
        When it equals the anchored mismatch count (the overwhelmingly
        common substitution-only case), the CIGAR has a closed form and the
        batched LV backtrace kernel is skipped for this record entirely —
        the device call + table fetch is the dominant host-pipeline cost
        (the reference reuses its per-read LV cache here,
        BaseAligner.cpp:1196-1238; our engine recomputes, so not re-running
        the DP for indel-free records is the batched analog)."""
        self._items.append((read, result, location, direction, mapq, mate,
                            splice_rewriter, tsource, score))

    def _cigar_inputs(self):
        """Gather (pattern, text) for every mapped record.  Records whose
        engine score equals the anchored mismatch count get their CIGAR
        emitted immediately from the closed form (see add()); only the
        indel/unknown-score remainder is returned for the LV kernel."""
        from ..ops.cigar import emit_tokens
        idxs, pats, texts, plens, tlens = [], [], [], [], []
        fast_toks, fast_dists = {}, {}
        for i, (read, result, loc, direction, *_rest) in enumerate(self._items):
            if result == NOT_FOUND or loc in (None, -1, INVALID_GENOME_LOCATION):
                continue
            tsource = self._items[i][7]
            score = self._items[i][8]
            seq = read.clipped_seq()
            if direction:
                seq = COMPLEMENT[np.frombuffer(read.seq, np.uint8)][::-1]
                cb, ca = read.clip_back, read.clip_front
                seq = seq[cb:len(seq) - ca].tobytes()
            codes = BASE_VALUE[np.frombuffer(seq, np.uint8)]
            n = codes.shape[0]
            if tsource is not None:
                src, tloc = tsource
                text = src[tloc:tloc + n]
            else:
                text = self.genome.codes[loc:loc + n]
            if score is not None and score >= 0:
                end = min(n, len(text))
                straight = int((codes[:end] != text[:end]).sum()) + (n - end)
                if straight == score:
                    # substitution-only optimum: emit_tokens' straight==e
                    # branch never touches the DP tables
                    fast_toks[i] = emit_tokens(codes, text, n, len(text),
                                               straight, None, None, 0,
                                               self.use_m)
                    fast_dists[i] = straight
                    continue
            idxs.append(i)
            pats.append(codes)
            texts.append(text)
            plens.append(n)
            tlens.append(len(text))
        return idxs, pats, texts, plens, tlens, fast_toks, fast_dists

    def flush(self, out) -> int:
        """Compute CIGARs and write all records to `out` (binary file)."""
        if not self._items:
            return 0
        idxs, pats, texts, plens, tlens, cigars, dists = self._cigar_inputs()
        if idxs:
            P, B = max(plens), len(idxs)
            pat = np.zeros((B, P), np.uint8)
            txt = np.zeros((B, P), np.uint8)
            pl = np.zeros(B, np.int32)
            tl = np.zeros(B, np.int32)
            for j in range(len(idxs)):
                pat[j, :plens[j]] = pats[j]
                txt[j, :tlens[j]] = texts[j]
                pl[j], tl[j] = plens[j], tlens[j]
            dist, toks = compute_cigars(pat, pl, txt, tl,
                                        use_m=self.use_m, k=MAX_K - 1,
                                        e_max=MAX_K, device=self.device)
            for j, i in enumerate(idxs):
                cigars[i] = toks[j]
                dists[i] = int(dist[j])
        n = 0
        record_out = hasattr(out, "write_record")
        for i, item in enumerate(self._items):
            fields = self._fields(item, cigars.get(i), dists.get(i, -1))
            blob = self._render(fields)
            if record_out:
                out.write_record(self._sort_key(fields), blob)
            else:
                out.write(blob)
            n += 1
        self._items.clear()
        return n

    def _sort_key(self, f: dict):
        """Flat genome location for coordinate-sorted output
        (SortedDataWriter's SortEntry.location)."""
        if f["rname"] is None:
            return None
        return self.genome.offset_of_piece(f["rname"]) + f["pos"] - 1

    def _fields(self, item, tokens, edit_distance) -> dict:
        """Compute every SAM/BAM field for one record (getSAMData analog,
        SAM.cpp:820-975).  Rendering to text or binary happens in _render."""
        read, result, loc, direction, mapq, mate, splice, _tsource, _score = item
        genome = self.genome
        flags = 0
        rname, pos = None, 0
        cigar = None
        mapped = result != NOT_FOUND and loc not in (None, -1, INVALID_GENOME_LOCATION)
        if not mapped:
            direction = 0

        if direction:
            seq = COMPLEMENT[np.frombuffer(read.seq, np.uint8)][::-1].tobytes()
            qual = read.qual[::-1]
            clip_before, clip_after = read.clip_back, read.clip_front
        else:
            seq = read.seq
            qual = read.qual
            clip_before, clip_after = read.clip_front, read.clip_back

        if mapped:
            if direction:
                flags |= FLAG_REVERSE
            if splice is not None and tokens is not None:
                tokens = splice(tokens)
            name, off = genome.piece_at(loc)
            rname, pos = name, off + 1
            mapq = max(0, min(70, int(mapq)))
            if tokens is not None:
                full = []
                if clip_before:
                    full.append((clip_before, "S"))
                full += tokens
                if clip_after:
                    full.append((clip_after, "S"))
                cigar = full
        else:
            flags |= FLAG_UNMAPPED
            mapq = 0

        rnext, pnext, tlen = None, 0, 0
        if mate is not None:
            flags |= FLAG_PAIRED
            flags |= FLAG_FIRST_SEGMENT if mate["first"] else FLAG_LAST_SEGMENT
            m_mapped = mate["result"] != NOT_FOUND and \
                mate["location"] not in (None, -1, INVALID_GENOME_LOCATION)
            if m_mapped:
                mname, moff = genome.piece_at(mate["location"])
                if mate["direction"]:
                    flags |= FLAG_NEXT_REVERSED
                if not mapped:
                    rname, pos = mname, moff + 1
                    rnext, pnext = mname, moff + 1
                else:
                    rnext = mname
                    pnext = moff + 1
                    flags |= FLAG_ALL_ALIGNED
                    if mname == rname:
                        mread = mate["read"]
                        m_cb = mread.clip_back if mate["direction"] else mread.clip_front
                        m_ca = mread.clip_front if mate["direction"] else mread.clip_back
                        my_start = loc - clip_before
                        my_end = loc + read.data_length + clip_after
                        mate_start = mate["location"] - m_cb
                        mate_end = mate["location"] + mread.data_length + m_ca
                        if my_start < mate_start:
                            tlen = mate_end - my_start
                        else:
                            tlen = -(my_end - mate_start)
            else:
                flags |= FLAG_NEXT_UNMAPPED
                rnext, pnext = rname, pos

        rid = read.rid
        if mate is not None:
            # Pairs must share one QNAME: truncate matching trailing /1 /2
            # from the FULL ids before space-truncation, replicating the
            # reference's LITERAL check (ReadWriter.cpp:154-162) including
            # its typo.  The decision is made once per PAIR on (first mate,
            # second mate) — lastChar0 is always read0's — and applied to
            # BOTH records; the typo'd second clause is
            # (lastChar0=='1'||lastChar1=='2') with lastChar0 reused, so a
            # pair whose FIRST mate ends in /2 (e.g. from the interleaved
            # matcher's arrival order) is NOT truncated by the binary.  We
            # match that bit-for-bit for oracle-diff cleanliness.
            mid = mate["read"].rid
            id0, id1 = (rid, mid) if mate["first"] else (mid, rid)
            c0, c1 = id0[-1:], id1[-1:]
            if (len(rid) == len(mid) and len(rid) > 2
                    and id0[-2:-1] == b"/" and id1[-2:-1] == b"/"
                    and c0 in (b"1", b"2")
                    and (c0 == b"1" or c1 == b"2")
                    and c0 != c1):
                rid = rid[:-2]
        qname = rid.split(b" ")[0].split(b"\t")[0]
        return dict(qname=qname, flags=flags, rname=rname, pos=pos,
                    mapq=mapq, cigar=cigar, rnext=rnext, pnext=pnext,
                    tlen=tlen, seq=seq, qual=qual,
                    edit_distance=edit_distance)

    def _render(self, f: dict) -> bytes:
        """SAM text line from computed fields."""
        rname = f["rname"] or "*"
        if f["rnext"] is None:
            rnext = "*"
        elif f["rnext"] == f["rname"]:
            rnext = "="
        else:
            rnext = f["rnext"]
        cigar = tokens_to_string(f["cigar"]) if f["cigar"] else "*"
        rg = f"\tRG:Z:{self.read_group}" if self.read_group else ""
        return (f"{f['qname'].decode()}\t{f['flags']}\t{rname}\t{f['pos']}\t"
                f"{f['mapq']}\t{cigar}\t{rnext}\t{f['pnext']}\t{f['tlen']}\t"
                f"{f['seq'].decode()}\t{f['qual'].decode()}"
                f"{rg}\tPG:Z:SNAP\tNM:i:{f['edit_distance']}\n").encode()
