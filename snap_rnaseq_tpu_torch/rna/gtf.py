"""GTF/GFF3 annotation model: features, transcripts, genes, read counting.

TPU-native analog of reference SNAPLib/GTFReader.{h,cpp} (authors' fork layer).
Behavioral contract mirrored from the reference:

* only `exon` records are consumed (GTFReader.cpp Parse, "feature != exon ->
  skip"); exons dedup across transcripts by (chr,start,end) into shared
  GTFFeature objects carrying a transcript_ids set;
* each transcript's feature walk is [exon0, intron0, exon1, ...] in genome
  order, introns synthesized between consecutive exons
  (GTFTranscript::Process, GTFReader.cpp);
* GenomicPosition(tpos, span): 1-based transcript coord -> 1-based genome
  coord within the chromosome, 0 when pos+span overruns the transcript end
  (GTFReader.cpp:1075-1107);
* Junctions(tpos, span): introns crossed by [tpos, tpos+span), as
  (transcript position after the exon boundary, intron) pairs
  (GTFReader.cpp:1109-1138);
* read counting: gene counts incremented per aligned fragment; transcript
  counts incremented 1/|compatible transcripts| using interval-feature
  intersection along the (splice-segmented) alignment; junction (intron)
  features count supporting reads (GTFReader.cpp:1388-1607);
* CheckBoundary: position within [start-buffer+1, end+buffer] on the same
  chromosome (GTFReader.cpp:890-902).

Interval stabbing queries (IntervalGenes/IntervalFeatures/IntervalTranscripts)
replace the reference's augmented interval trees (IntervalTree.h) with flat
sorted arrays + per-chromosome binning: query cost is O(bin occupancy), build
is fully vectorized — the same data is reusable on device later.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

EXON, INTRON = 1, 2

_BIN_SHIFT = 14  # 16 kb bins


def _parse_attributes(attr: str) -> dict:
    """Parse GTF `key "value";` or GFF3 `key=value;` attribute strings."""
    out = {}
    attr = attr.strip()
    if "=" in attr.split(";")[0] and '"' not in attr.split(";")[0]:
        for part in attr.split(";"):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            out[k.strip()] = v.strip().strip('"')
    else:
        for part in attr.split(";"):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition(" ")
            out[k.strip()] = v.strip().strip('"')
    return out


@dataclass
class GTFFeature:
    """One deduplicated exon or synthesized intron."""
    chr: str
    start: int              # 1-based inclusive
    end: int                # 1-based inclusive
    strand: str
    type: int               # EXON or INTRON
    gene_id: str
    transcript_id: str      # first transcript that introduced it
    gene_name: str = ""
    transcript_name: str = ""
    transcript_ids: set = field(default_factory=set)
    read_count: float = 0.0

    @property
    def length(self) -> int:
        return self.end - self.start + 1

    def increment_read_count(self, n: float = 1.0):
        self.read_count += n


class GTFTranscript:
    """Transcript = ordered exon list + synthesized introns.

    Numpy mirrors (exon_starts / exon_cum / intron_lens) drive the hot
    coordinate mapping; the feature objects remain for counting.
    """

    __slots__ = ("chr", "gene_id", "transcript_id", "gene_name",
                 "transcript_name", "start", "end", "exons", "introns",
                 "exon_starts", "exon_lens", "exon_cum", "intron_lens",
                 "read_count")

    def __init__(self, chr, gene_id, transcript_id, gene_name, transcript_name):
        self.chr = chr
        self.gene_id = gene_id
        self.transcript_id = transcript_id
        self.gene_name = gene_name
        self.transcript_name = transcript_name
        self.exons: list[GTFFeature] = []
        self.introns: list[GTFFeature] = []
        self.start = 0
        self.end = 0
        self.exon_starts = self.exon_lens = self.exon_cum = self.intron_lens = None
        self.read_count = 0.0

    def finalize(self, all_features: dict):
        """Sort exons, synthesize introns, build numpy arrays.

        Mirrors GTFTranscript::Process: introns are shared per (chr,start,end)
        via all_features so junction counts aggregate across transcripts.
        """
        self.exons.sort(key=lambda f: (f.start, f.end))
        self.introns = []
        for prev, cur in zip(self.exons, self.exons[1:]):
            key = (self.gene_id, self.chr, prev.end + 1, cur.start - 1, INTRON)
            intron = all_features.get(key)
            if intron is None:
                intron = GTFFeature(chr=self.chr, start=prev.end + 1,
                                    end=cur.start - 1, strand=prev.strand,
                                    type=INTRON, gene_id=self.gene_id,
                                    transcript_id=self.transcript_id,
                                    gene_name=self.gene_name)
                all_features[key] = intron
            intron.transcript_ids.add(self.transcript_id)
            self.introns.append(intron)
        self.start = self.exons[0].start if self.exons else 0
        self.end = max((e.end for e in self.exons), default=0)
        self.exon_starts = np.asarray([e.start for e in self.exons], np.int64)
        self.exon_lens = np.asarray([e.length for e in self.exons], np.int64)
        self.exon_cum = np.cumsum(self.exon_lens)
        self.intron_lens = np.asarray([i.length for i in self.introns], np.int64)

    @property
    def spliced_length(self) -> int:
        return max(int(self.exon_cum[-1]) if len(self.exon_cum) else 0, 1)

    def genomic_position(self, tpos: int, span: int) -> int:
        """1-based transcript pos -> 1-based genome pos; 0 on overrun
        (GTFReader.cpp:1075-1107)."""
        if tpos < 1 or len(self.exon_cum) == 0 or tpos > self.exon_cum[-1]:
            return 0
        i = int(np.searchsorted(self.exon_cum, tpos, side="left"))
        prev_cum = int(self.exon_cum[i - 1]) if i else 0
        genome_pos = int(self.exon_starts[i]) + (tpos - prev_cum) - 1
        if genome_pos + span > self.end:
            return 0
        return genome_pos

    def junctions(self, tpos: int, span: int) -> list[tuple[int, GTFFeature]]:
        """Introns crossed by [tpos, tpos+span): (pos after exon boundary,
        intron feature), reproducing the reference walk exactly
        (GTFReader.cpp:1109-1138)."""
        out = []
        end_pos = tpos + span
        n = len(self.exons)
        for i in range(n):
            cur = int(self.exon_cum[i])
            if tpos <= cur:
                if cur >= end_pos:        # EXON branch return
                    return out
                if i < n - 1:             # INTRON after exon i
                    out.append((cur + 1, self.introns[i]))
        return out

    def increment_read_count(self, n_potential: int = 1):
        self.read_count += 1.0 / float(n_potential)


class GTFGene:
    __slots__ = ("chr", "gene_id", "gene_name", "start", "end",
                 "transcript_ids", "read_count")

    def __init__(self, chr, gene_id, gene_name, start, end):
        self.chr = chr
        self.gene_id = gene_id
        self.gene_name = gene_name
        self.start = start
        self.end = end
        self.transcript_ids: set[str] = set()
        self.read_count = 0.0

    def update_boundaries(self, start, end):
        self.start = min(self.start, start)
        self.end = max(self.end, end)

    def check_boundary(self, query_chr: str, query_pos: int,
                       buffer: int = 1000) -> bool:
        """Default buffer 1000 like the reference (GTFReader.h:290)."""
        if self.chr != query_chr:
            return False
        return max(self.start - buffer + 1, 1) <= query_pos <= self.end + buffer

    def increment_read_count(self):
        self.read_count += 1.0


class _IntervalIndex:
    """Per-chromosome binned stabbing index over [start, end] intervals."""

    def __init__(self):
        self._by_chr: dict[str, tuple] = {}

    def build(self, items: list, chr_of, start_of, end_of):
        from collections import defaultdict
        groups = defaultdict(list)
        for i, it in enumerate(items):
            groups[chr_of(it)].append(i)
        for chrom, idxs in groups.items():
            idxs = np.asarray(idxs, np.int64)
            starts = np.asarray([start_of(items[i]) for i in idxs], np.int64)
            ends = np.asarray([end_of(items[i]) for i in idxs], np.int64)
            b0 = starts >> _BIN_SHIFT
            b1 = ends >> _BIN_SHIFT
            counts = (b1 - b0 + 1)
            total = int(counts.sum())
            bin_ids = np.repeat(b0, counts) + _ranges(counts)
            member = np.repeat(np.arange(len(idxs)), counts)
            order = np.argsort(bin_ids, kind="stable")
            bin_ids = bin_ids[order]
            member = member[order]
            ub, first = np.unique(bin_ids, return_index=True)
            bounds = np.append(first, total)
            self._by_chr[chrom] = (idxs, starts, ends, ub, bounds, member)

    def query(self, chrom: str, qstart: int, qend: int) -> np.ndarray:
        """Indices (into the original item list) overlapping [qstart, qend]."""
        entry = self._by_chr.get(chrom)
        if entry is None:
            return np.zeros(0, np.int64)
        idxs, starts, ends, ub, bounds, member = entry
        lo = int(np.searchsorted(ub, qstart >> _BIN_SHIFT, side="left"))
        hi = int(np.searchsorted(ub, qend >> _BIN_SHIFT, side="right"))
        if lo >= hi:
            return np.zeros(0, np.int64)
        cand = np.unique(member[bounds[lo]:bounds[hi]])
        hit = (starts[cand] <= qend) & (ends[cand] >= qstart)
        return idxs[cand[hit]]


def _ranges(counts: np.ndarray) -> np.ndarray:
    """Concatenated arange(c) for each c in counts."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    out = np.ones(total, np.int64)
    out[0] = 0
    starts = np.cumsum(counts)[:-1]
    out[starts] = 1 - counts[:-1]
    return np.cumsum(out)


class GTFReader:
    """Parsed annotation + interval indexes + read counters + fusion maps."""

    def __init__(self):
        self.features: dict[tuple, GTFFeature] = {}
        self.transcripts: dict[str, GTFTranscript] = {}
        self.genes: dict[str, GTFGene] = {}
        self.prefix = "output"
        self._gene_index = None
        self._feature_index = None
        self._transcript_index = None
        self._gene_list = []
        self._feature_list = []
        self._transcript_list = []
        # fusion evidence maps (populated by AlignmentFilter)
        from .intervals import ReadIntervalMap
        self.interchromosomal_pairs = ReadIntervalMap()
        self.intrachromosomal_pairs = ReadIntervalMap()
        self.interchromosomal_splices = ReadIntervalMap()
        self.intrachromosomal_splices = ReadIntervalMap()

    # ------------------------------------------------------------------
    # loading
    # ------------------------------------------------------------------

    @classmethod
    def load(cls, filename: str, prefix: str | None = None) -> "GTFReader":
        r = cls()
        if prefix:
            r.prefix = prefix
        with open(filename, "rt") as f:
            for line in f:
                if not line.strip() or line.startswith("#"):
                    continue
                r._parse_line(line.rstrip("\n"))
        r._finalize()
        return r

    def _parse_line(self, line: str):
        parts = line.split("\t")
        if len(parts) < 9:
            return
        chrom, _source, feature, start, end, _score, strand, _frame, attrs = \
            parts[:9]
        if feature != "exon":
            return
        a = _parse_attributes(attrs)
        gene_id = a.get("gene_id") or a.get("Parent") or ""
        transcript_id = a.get("transcript_id") or a.get("Parent") or ""
        gene_name = a.get("gene_name", gene_id)
        transcript_name = a.get("transcript_name", transcript_id)
        start_i, end_i = int(start), int(end)

        # gene_id prepended like the reference's feature key so overlapping
        # genes don't share exon objects (GTFReader.cpp GTFFeature ctor tail)
        key = (gene_id, chrom, start_i, end_i, EXON)
        feat = self.features.get(key)
        if feat is None:
            feat = GTFFeature(chr=chrom, start=start_i, end=end_i,
                              strand=strand, type=EXON, gene_id=gene_id,
                              transcript_id=transcript_id,
                              gene_name=gene_name,
                              transcript_name=transcript_name)
            self.features[key] = feat
        feat.transcript_ids.add(transcript_id)

        t = self.transcripts.get(transcript_id)
        if t is None:
            t = GTFTranscript(chrom, gene_id, transcript_id, gene_name,
                              transcript_name)
            self.transcripts[transcript_id] = t
        t.exons.append(feat)

        g = self.genes.get(gene_id)
        if g is None:
            g = GTFGene(chrom, gene_id, gene_name, start_i, end_i)
            self.genes[gene_id] = g
        g.transcript_ids.add(transcript_id)
        g.update_boundaries(start_i, end_i)

    def _finalize(self):
        for t in self.transcripts.values():
            t.finalize(self.features)
        self._gene_list = list(self.genes.values())
        self._feature_list = list(self.features.values())
        self._transcript_list = list(self.transcripts.values())
        self._gene_index = _IntervalIndex()
        self._gene_index.build(self._gene_list, lambda g: g.chr,
                               lambda g: g.start, lambda g: g.end)
        self._feature_index = _IntervalIndex()
        self._feature_index.build(self._feature_list, lambda f: f.chr,
                                  lambda f: f.start, lambda f: f.end)
        self._transcript_index = _IntervalIndex()
        self._transcript_index.build(self._transcript_list, lambda t: t.chr,
                                     lambda t: t.start, lambda t: t.end)

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def get_transcript(self, transcript_id: str) -> GTFTranscript:
        return self.transcripts[transcript_id]

    def get_gene(self, gene_id: str) -> GTFGene:
        return self.genes[gene_id]

    def interval_genes(self, chrom, start, stop) -> list[GTFGene]:
        idx = self._gene_index.query(chrom, start, stop)
        return [self._gene_list[i] for i in idx]

    def interval_features(self, chrom, start, stop) -> list[GTFFeature]:
        idx = self._feature_index.query(chrom, start, stop)
        return [self._feature_list[i] for i in idx]

    def interval_transcripts(self, chrom, start, stop) -> list[GTFTranscript]:
        idx = self._transcript_index.query(chrom, start, stop)
        return [self._transcript_list[i] for i in idx]

    # ------------------------------------------------------------------
    # read counting (GTFReader.cpp:1388-1607)
    # ------------------------------------------------------------------

    def increment_read_count_single(self, transcript_id0: str):
        """Single-end: bump the gene count only (GTFReader.cpp:1388-1406)."""
        t = self.transcripts[transcript_id0]
        self.genes[t.gene_id].increment_read_count()

    def _walk_transcript_ids(self, transcript_id, tstart, gstart, length):
        """Splice-aware walk: per segment between junctions, query the
        feature index and intersect compatible transcript id sets; also bumps
        junction (intron) read counts.  Returns the compatible-id set."""
        ids: set[str] = set()
        t = self.transcripts[transcript_id]
        for jpos, intron in t.junctions(tstart, length):
            intron.increment_read_count()
            seg = jpos - tstart
            feats = self.interval_features(t.chr, gstart, gstart + seg - 1)
            # each deduped feature contributes its SINGULAR first-inserted
            # transcript_id, not its full transcript_ids set — the reference
            # inserts (*it2)->transcript_id (GTFReader.cpp:1440-1454), and a
            # duplicate exon keeps the first line's id (map insert no-op,
            # GTFReader.cpp:1323)
            seg_ids = {f.transcript_id for f in feats}
            ids = seg_ids if not ids else (ids & seg_ids)
            tstart += seg
            gstart += seg + intron.length
            length -= seg
        feats = self.interval_features(t.chr, gstart, gstart + length - 1)
        seg_ids = {f.transcript_id for f in feats}
        ids = seg_ids if not ids else (ids & seg_ids)
        return ids

    def increment_read_count_paired(self, transcript_id0, tstart0, gstart0,
                                    length0, transcript_id1, tstart1, gstart1,
                                    length1):
        """Paired: intersect both mates' compatible transcripts; fractional
        transcript counts; one gene count per fragment."""
        if not transcript_id0 or not transcript_id1:
            return
        ids0 = self._walk_transcript_ids(transcript_id0, tstart0, gstart0, length0)
        ids1 = self._walk_transcript_ids(transcript_id1, tstart1, gstart1, length1)
        final = ids0 & ids1
        if not final:
            return
        gene_id = None
        for tid in final:
            t = self.transcripts.get(tid)
            if t is None:
                continue
            gene_id = t.gene_id
            t.increment_read_count(len(final))
        if gene_id is not None and gene_id in self.genes:
            self.genes[gene_id].increment_read_count()

    # ------------------------------------------------------------------
    # outputs (GTFReader.cpp:1710-1772, 1774-1838)
    # ------------------------------------------------------------------

    def write_read_counts(self, prefix: str | None = None):
        prefix = prefix or self.prefix
        with open(prefix + ".transcript_id.counts.txt", "w") as f_tid, \
             open(prefix + ".transcript_name.counts.txt", "w") as f_tname, \
             open(prefix + ".gene_id.counts.txt", "w") as f_gid, \
             open(prefix + ".gene_name.counts.txt", "w") as f_gname, \
             open(prefix + ".junction_id.counts.txt", "w") as f_jid, \
             open(prefix + ".junction_name.counts.txt", "w") as f_jname:
            for t in self.transcripts.values():
                f_tid.write(f"{t.transcript_id}\t{t.read_count:.6g}\n")
                f_tname.write(f"{t.transcript_name}\t{t.read_count:.6g}\n")
            gene_name_counts: dict[str, float] = {}
            for g in self.genes.values():
                f_gid.write(f"{g.gene_id}\t{g.read_count:.6g}\n")
                gene_name_counts[g.gene_name] = \
                    gene_name_counts.get(g.gene_name, 0.0) + g.read_count
            for name, count in gene_name_counts.items():
                f_gname.write(f"{name}\t{count:.6g}\n")
            for key, feat in self.features.items():
                if feat.type != INTRON:
                    continue
                jid = f"{feat.chr}:{feat.start}-{feat.end}"
                f_jid.write(f"{feat.gene_id}\t{jid}\t{feat.read_count:.6g}\n")
                f_jname.write(f"{feat.gene_name}\t{jid}\t{feat.read_count:.6g}\n")

    def analyze_read_intervals(self, prefix: str | None = None):
        """Fusion/rearrangement evidence: consolidate splice + pair maps,
        intersect them, write interval GTFs and the log
        (GTFReader.cpp:1774-1838)."""
        prefix = prefix or self.prefix
        paired_buffer = 100
        spliced_buffer = 0
        min_count = 5
        intersection_buffer = 10
        with open(prefix + ".interchromosomal_intervals.gtf", "w") as f_inter, \
             open(prefix + ".intrachromosomal_intervals.gtf", "w") as f_intra, \
             open(prefix + ".read_intervals.txt", "w") as logfile:
            self.interchromosomal_pairs.consolidate(self, paired_buffer)
            self.interchromosomal_splices.consolidate(self, spliced_buffer)
            self.interchromosomal_splices.intersect(
                self.interchromosomal_pairs, intersection_buffer, min_count, self)
            logfile.write("Inter-Chromosomal Intervals\n")
            self.interchromosomal_splices.write_gtf(f_inter)
            self.interchromosomal_splices.write_spliced_mate_pairs(logfile)
            logfile.write("\n")

            self.intrachromosomal_pairs.consolidate(self, paired_buffer)
            self.intrachromosomal_splices.consolidate(self, spliced_buffer)
            self.intrachromosomal_splices.intersect(
                self.intrachromosomal_pairs, intersection_buffer, min_count, self)
            logfile.write("Intra-Chromosomal Intervals\n")
            self.intrachromosomal_splices.write_gtf(f_intra)
            self.intrachromosomal_splices.write_spliced_mate_pairs(logfile)
            logfile.write("\n")

    # ------------------------------------------------------------------
    # persistence alongside a transcriptome index
    # ------------------------------------------------------------------

    def save_cache(self, directory: str):
        """Record the source annotation path; reload parses the original
        (single-pass parse is fast relative to index build)."""
        import json
        with open(os.path.join(directory, "gtf.json"), "w") as f:
            json.dump({"n_transcripts": len(self.transcripts),
                       "n_genes": len(self.genes)}, f)
