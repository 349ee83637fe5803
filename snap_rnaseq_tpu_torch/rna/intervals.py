"""Fusion / rearrangement read-interval evidence maps.

Analog of reference SNAPLib/GTFReader.{h,cpp} ReadInterval /
ReadIntervalPair / ReadIntervalMap (GTFReader.cpp:45-760):

* AddInterval records a mate-linked pair of genomic intervals per read
  (paired-end evidence or split-read splice evidence);
* consolidate() repeatedly merges overlapping same-chromosome intervals
  (within `buffer`), unioning read-id sets and re-pointing mate links,
  until a fixed point; then intervals touching mitochondrial ("MT") or
  HLA genes are filtered and (interval, mate) pairs are formed, sorted by
  shared-read-count descending;
* intersect() cross-checks a spliced-evidence map against a paired-evidence
  map: a fusion candidate must have >= min_count shared reads in BOTH maps
  and linked intervals overlapping within `buffer`;
* write_gtf()/write_spliced_mate_pairs() emit the same GTF-style interval
  records and log lines the reference produces.

The consolidation uses a sort-sweep over (chr, start) instead of the
reference's repeated interval-tree rebuilds — same fixed point, one pass.
"""
from __future__ import annotations

from collections import defaultdict


class ReadInterval:
    __slots__ = ("chr", "start", "end", "ids", "gene_ids", "gene_names",
                 "is_spliced", "mate")

    def __init__(self, chrom, start, end, ids, is_spliced):
        self.chr = chrom
        self.start = int(start)
        self.end = int(end)
        self.ids = set(ids) if not isinstance(ids, str) else {ids}
        self.gene_ids: set[str] = set()
        self.gene_names: set[str] = set()
        self.is_spliced = is_spliced
        self.mate: set[ReadInterval] = set()

    def gene_id_str(self) -> str:
        return ",".join(sorted(self.gene_ids)) if self.gene_ids else "NoGene"

    def gene_name_str(self) -> str:
        return ",".join(sorted(self.gene_names)) if self.gene_names \
            else self.gene_id_str()

    def gene_name_spliced(self, intersection: int) -> str:
        tag = "S" if self.is_spliced else "P"
        return f"{self.gene_name_str()},{tag},{intersection}"

    def get_gene_info(self, gtf):
        for g in gtf.interval_genes(self.chr, self.start, self.end):
            self.gene_ids.add(g.gene_id)
            if g.gene_name:
                self.gene_names.add(g.gene_name)

    def filter(self) -> bool:
        """Promiscuous-interval filter: mitochondrial or HLA evidence
        (GTFReader.cpp:173-187)."""
        if "MT" in self.chr:
            return True
        return any("HLA-" in n for n in self.gene_names)

    def write_gtf(self, out, intersection: int):
        out.write(f"{self.chr}\tsnap-rna\tinterval\t{self.start}\t{self.end}"
                  f"\t.\t.\t.\tgene_id \"{self.gene_id_str()}\"; "
                  f"transcript_id \"{self.gene_name_spliced(intersection)}\"; "
                  f"gene_name \"{self.gene_name_str()}\";\n")


class ReadIntervalPair:
    __slots__ = ("interval1", "interval2", "intersection")

    def __init__(self, i1: ReadInterval, i2: ReadInterval):
        self.interval1 = i1
        self.interval2 = i2
        self.intersection = i1.ids & i2.ids

    def write_gtf(self, out):
        self.interval1.write_gtf(out, len(self.intersection))
        self.interval2.write_gtf(out, len(self.intersection))

    def write(self, out):
        i1, i2 = self.interval1, self.interval2
        out.write(f"{len(self.intersection)}\t"
                  f"{i1.chr}:{i1.start}-{i1.end}\t"
                  f"{i1.gene_id_str()}\t{i1.gene_name_str()}\t"
                  f"{i2.chr}:{i2.start}-{i2.end}\t"
                  f"{i2.gene_id_str()}\t{i2.gene_name_str()}")


class ReadIntervalMap:
    def __init__(self):
        self.intervals: list[ReadInterval] = []
        self.pairs: list[ReadIntervalPair] = []
        self.spliced_mate_pairs: list[tuple[ReadIntervalPair, ReadIntervalPair]] = []

    def add_interval(self, chr0, start0, end0, chr1, start1, end1, read_id,
                     is_spliced):
        m0 = ReadInterval(chr0, start0, end0, read_id, is_spliced)
        m1 = ReadInterval(chr1, start1, end1, read_id, is_spliced)
        m0.mate.add(m1)
        m1.mate.add(m0)
        self.intervals.append(m0)
        self.intervals.append(m1)

    def clear(self):
        self.intervals = []
        self.pairs = []
        self.spliced_mate_pairs = []

    # ------------------------------------------------------------------

    def _merge_once(self, buffer: int) -> bool:
        """One sweep of same-chromosome merging; True if anything merged."""
        by_chr = defaultdict(list)
        for iv in self.intervals:
            by_chr[iv.chr].append(iv)
        merged_any = False
        out: list[ReadInterval] = []
        for chrom, ivs in by_chr.items():
            ivs.sort(key=lambda i: (i.start, i.end))
            cur = None
            for iv in ivs:
                if cur is not None and iv.start <= cur.end + buffer:
                    # merge iv into cur
                    cur.end = max(cur.end, iv.end)
                    cur.ids |= iv.ids
                    for m in iv.mate:
                        m.mate.discard(iv)
                        m.mate.add(cur)
                        cur.mate.add(m)
                    merged_any = True
                else:
                    if cur is not None:
                        out.append(cur)
                    cur = iv
            if cur is not None:
                out.append(cur)
        self.intervals = out
        return merged_any

    def consolidate(self, gtf, buffer: int, filter_promiscuous: bool = True):
        while self._merge_once(buffer):
            pass
        kept = []
        for iv in self.intervals:
            iv.get_gene_info(gtf)
            if filter_promiscuous and iv.filter():
                continue
            kept.append(iv)
        self.intervals = kept
        kept_set = set(map(id, kept))
        self.pairs = []
        seen = set()
        for iv in kept:
            for m in iv.mate:
                if id(m) not in kept_set:
                    continue
                pair_key = frozenset((id(iv), id(m)))
                if pair_key in seen:
                    continue
                seen.add(pair_key)
                self.pairs.append(ReadIntervalPair(iv, m))
        self.pairs.sort(key=lambda p: -len(p.intersection))

    def _overlapping(self, chrom, start, end, buffer):
        return [iv for iv in self.intervals
                if iv.chr == chrom and iv.start <= end + buffer
                and iv.end >= start - buffer]

    def intersect(self, pair_map: "ReadIntervalMap", buffer: int,
                  min_count: int, gtf):
        """Cross-validate this (spliced) map's pairs against the paired-end
        evidence map; survivors land in spliced_mate_pairs."""
        self.spliced_mate_pairs = []
        for p in pair_map.pairs:
            lefts = self._overlapping(p.interval1.chr, p.interval1.start,
                                      p.interval1.end, buffer)
            rights = self._overlapping(p.interval2.chr, p.interval2.start,
                                       p.interval2.end, buffer)
            for left in lefts:
                for right in rights:
                    if right not in left.mate:
                        continue
                    pair1 = ReadIntervalPair(left, right)
                    if len(p.intersection) >= min_count and \
                            len(pair1.intersection) >= min_count:
                        for iv in (p.interval1, p.interval2, left, right):
                            iv.get_gene_info(gtf)
                        self.spliced_mate_pairs.append((p, pair1))

    def write_gtf(self, out):
        for p0, p1 in self.spliced_mate_pairs:
            p0.write_gtf(out)
            p1.write_gtf(out)

    def write_spliced_mate_pairs(self, out):
        for p0, p1 in self.spliced_mate_pairs:
            p0.write(out)
            out.write("\t")
            p1.write(out)
            out.write("\n")
