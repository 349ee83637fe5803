"""Precomputed transcriptome -> genome coordinate tensors.

The reference converts every transcriptome alignment to genome coordinates
with a per-hit exon walk (GTFTranscript::GenomicPosition,
GTFReader.cpp:1075-1107) inside AlignmentFilter::AddAlignment.  On the
batched device pipeline that walk — plus the piece_at bisect and the
transcript-object lookup — is the per-hit Python that caps RNA throughput
(SURVEY.md §7 flags it and prescribes exactly this fix: "transcript->
genome coordinate mapping as precomputed exon-offset tensors").

This module flattens the mapping ONCE per (gtf, transcriptome) into dense
arrays indexed by transcriptome flat location, so a whole batch of
multi-hit results converts with a handful of numpy gathers:

  g_of_t[toff]     1-based genome position of that transcript base
                   (0 on padding / outside any transcript)
  t_end[toff]      transcript.end (last exon end) — the overrun check
                   `genome_pos + span > end -> 0` replicated vectorized
  piece_start[toff] flat start of the piece -> pos_original derivation
  chr_no[toff]     index into .chr_names
  piece_no[toff]   index into .pieces (transcript objects for the slow
                   path: counting walks, evidence recording)
  gene_lo/gene_hi/gene_chr_no[piece_no]  gene bounds for the vectorized
                   check_boundary (GTFReader.h:290 buffer logic)
"""
from __future__ import annotations

import numpy as np


class TranscriptomeCoordMap:
    def __init__(self, gtf, transcriptome_genome):
        tg = transcriptome_genome
        total = int(tg.codes.shape[0])
        self.g_of_t = np.zeros(total, np.int64)
        self.t_end = np.zeros(total, np.int64)
        self.piece_start = np.zeros(total, np.int64)
        self.chr_no = np.full(total, -1, np.int32)
        self.piece_no = np.full(total, -1, np.int32)

        self.chr_names: list[str] = []
        chr_idx: dict[str, int] = {}
        self.pieces = []            # transcript object per piece_no
        gene_lo, gene_hi, gene_chr = [], [], []

        for name in tg.piece_names:
            p0 = int(tg.offset_of_piece(name))
            try:
                t = gtf.get_transcript(name)
            except KeyError:
                continue
            L = int(t.exon_cum[-1]) if len(t.exon_cum) else 0
            if L == 0:
                continue
            pno = len(self.pieces)
            self.pieces.append(t)
            c = chr_idx.setdefault(t.chr, len(self.chr_names))
            if c == len(self.chr_names):
                self.chr_names.append(t.chr)
            # genome position of every transcript base, exon by exon
            lens = np.asarray(t.exon_lens, np.int64)
            starts = np.asarray(t.exon_starts, np.int64)
            cum_prev = np.concatenate(([0], np.cumsum(lens)[:-1]))
            base = np.repeat(starts - cum_prev, lens)
            self.g_of_t[p0:p0 + L] = base + np.arange(L, dtype=np.int64)
            self.t_end[p0:p0 + L] = int(t.end)
            self.piece_start[p0:p0 + L] = p0
            self.chr_no[p0:p0 + L] = c
            self.piece_no[p0:p0 + L] = pno
            g = gtf.get_gene(t.gene_id)
            gene_lo.append(int(g.start))
            gene_hi.append(int(g.end))
            gene_chr.append(c)
        self.gene_lo = np.asarray(gene_lo, np.int64)
        self.gene_hi = np.asarray(gene_hi, np.int64)
        self.gene_chr_no = np.asarray(gene_chr, np.int32)

    # ------------------------------------------------------------------

    def convert(self, tloc: np.ndarray, read_len):
        """Vectorized AddAlignment transcriptome branch
        (AlignmentFilter.cpp:160-196 semantics, including the reference's
        genome_pos + span > end overrun rule).

        tloc: int64 array of transcriptome flat locations; read_len may be
        a scalar or an array broadcastable against tloc (per-read clipped
        lengths).  Returns dict of arrays: valid, pos, pos_end,
        pos_original, chr_no, piece_no.
        """
        tloc = np.asarray(tloc, np.int64)
        read_len = np.asarray(read_len, np.int64)
        n = self.g_of_t.shape[0]
        inb = (tloc >= 0) & (tloc < n)
        safe = np.where(inb, tloc, 0)
        pno = np.where(inb, self.piece_no[safe], -1)
        gp = self.g_of_t[safe]
        valid = inb & (pno >= 0) & (gp > 0) & \
            (gp + read_len <= self.t_end[safe])
        pos_original = tloc - self.piece_start[safe] + 1
        # pos_end: genomic position of the LAST read base (span 0 -> only
        # the tpos<=spliced_length validity applies; 0 past the end)
        last = safe + read_len - 1
        last_in = inb & (last < n)
        lastc = np.where(last_in, last, 0)
        pos_end = np.where(last_in & (self.piece_no[lastc] == pno),
                           self.g_of_t[lastc], 0)
        return dict(valid=valid, pos=gp, pos_end=pos_end,
                    pos_original=pos_original,
                    chr_no=np.where(inb, self.chr_no[safe], -1),
                    piece_no=pno)

    def same_gene(self, piece_no: np.ndarray, other_chr_no: np.ndarray,
                  other_pos: np.ndarray, buffer: int = 1000):
        """Vectorized GTFGene::CheckBoundary (gene span +- buffer;
        start+1 off-by-one replicated from check_boundary)."""
        pno = np.asarray(piece_no)
        ok = pno >= 0
        safe = np.where(ok, pno, 0)
        lo = np.maximum(self.gene_lo[safe] - buffer + 1, 1)
        hi = self.gene_hi[safe] + buffer
        return ok & (self.gene_chr_no[safe] == other_chr_no) & \
            (other_pos >= lo) & (other_pos <= hi)
