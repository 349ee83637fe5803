"""Extra input "transcriptome": a gene annotation made from the spec's
seed, and the transcriptome the `transcriptome` command builds from it.

Genes at the density of the human GENCODE annotation scaled to the
genome (about 20,000 protein-coding genes over 3.1 Gb: 1,300 over
64 Mb): the `genes` are dealt over the chromosomes in turn, and each
chromosome is cut into equal slots, one gene a slot, on either strand;
a chromosome too short for its genes' widest span in each slot takes
as many as fit (the harness's tests run configurations on 1 Mb).  A gene
has `exons` exons of `exon_len` bases, `intron_len` apart, the first
`first_gap` from its slot's start; it has `isoforms` transcripts, each
keeping each exon with probability `keep` (its first and last exon when
fewer than two are kept).  Every range [lo, hi] is inclusive.  Each
transcript has an expression weight drawn log-normal with
`expression_sigma`.  RNA-seq abundances span orders of magnitude, but
no value of `expression_sigma` has a published source yet (the tests'
1.5 is a guess): a configuration that sets it cites the published
expression distribution it takes it from.

`make` returns a dict of plain arrays and text:

gtf          the annotation as GTF text, exon lines, transcripts in order
codes        the transcriptome: one piece per transcript in GTF order, its
             exons joined in genome order (no reverse complement), PAD
             padding codes before every piece and after the last
names, offsets   each piece's transcript id and first base
pos          per transcriptome base: its 1-based position on its
             chromosome (0 on padding)
t_end        per base: its transcript's last exon end (1-based; 0 on padding)
transcript, gene, chrom   per base: its transcript, gene and chromosome
             index (-1 on padding)
tx_gene, tx_chrom, tx_len, weight   per transcript
gene_chrom, gene_lo, gene_hi        per gene: its chromosome, first exon
             start and last exon end over every transcript (1-based)
"""
from __future__ import annotations

import numpy as np

from ..genome import PAD_CODE

PAD = 500


def _range(rng, spec, key, size=None):
    lo, hi = (int(x) for x in spec[key])
    return rng.integers(lo, hi + 1, size)


def annotation(genome, spec: dict, rng) -> list:
    """(gene, isoform, chromosome, strand, [(start, end), ...] 1-based)
    for each transcript, in GTF order."""
    n_chrom = len(genome.piece_offsets)
    genes = int(spec["genes"])
    per_chrom = [genes // n_chrom + (c < genes % n_chrom)
                 for c in range(n_chrom)]
    widest = (int(spec["first_gap"][1]) + int(spec["exons"][1])
              * int(spec["exon_len"][1])
              + (int(spec["exons"][1]) - 1) * int(spec["intron_len"][1]))
    out = []
    gi = 0
    for c, n in enumerate(per_chrom):
        n = min(n, genome.piece_len // widest)
        slot = genome.piece_len // max(n, 1)
        for k in range(n):
            n_ex = int(_range(rng, spec, "exons"))
            lens = _range(rng, spec, "exon_len", n_ex)
            gaps = _range(rng, spec, "intron_len", n_ex)
            gaps[0] = _range(rng, spec, "first_gap")
            starts = (k * slot + np.cumsum(gaps)
                      + np.concatenate([[0], np.cumsum(lens[:-1])]))
            exons = [(int(a) + 1, int(a + n_)) for a, n_ in zip(starts, lens)]
            strand = "+" if rng.random() < 0.5 else "-"
            for ti in range(int(_range(rng, spec, "isoforms"))):
                keep = rng.random(n_ex) < float(spec["keep"])
                if keep.sum() < 2:
                    keep[[0, -1]] = True
                out.append((gi, ti, c, strand,
                            [e for e, k_ in zip(exons, keep) if k_]))
            gi += 1
    return out


def make(genome, spec: dict) -> dict:
    rng = np.random.default_rng(int(spec["seed"]))
    txs = annotation(genome, spec, rng)
    weight = rng.lognormal(0.0, float(spec["expression_sigma"]), len(txs))
    names = [f"T{g}.{i}" for g, i, *_ in txs]
    lines = []
    for name, (g, _, c, strand, exons) in zip(names, txs):
        for s, e in exons:
            lines.append(f"chr{c + 1}\tbenchmark\texon\t{s}\t{e}\t.\t"
                         f"{strand}\t.\tgene_id \"G{g}\"; transcript_id "
                         f"\"{name}\";\n")
    tx_len = np.array([sum(e - s + 1 for s, e in ex) for *_, ex in txs],
                      np.int64)
    offsets = PAD * np.arange(1, len(txs) + 1) + np.concatenate(
        [[0], np.cumsum(tx_len)[:-1]])
    total = int(offsets[-1] + tx_len[-1] + PAD)
    # every exon's bases: its transcript, first transcriptome base, length
    ex_tx = np.concatenate([np.full(len(ex), t) for t, (*_, ex) in
                            enumerate(txs)])
    ex_s = np.concatenate([[s for s, _ in ex] for *_, ex in txs])
    ex_n = np.concatenate([[e - s + 1 for s, e in ex] for *_, ex in txs])
    ex_t0 = offsets[ex_tx] + np.concatenate(
        [np.concatenate([[0], np.cumsum([e - s + 1 for s, e in ex])[:-1]])
         for *_, ex in txs]).astype(np.int64)
    within = np.arange(int(ex_n.sum())) - np.repeat(
        np.cumsum(ex_n) - ex_n, ex_n)
    at = np.repeat(ex_t0, ex_n) + within              # transcriptome base
    gpos = np.repeat(ex_s, ex_n) + within              # 1-based on chrom
    tx_gene = np.array([g for g, *_ in txs], np.int32)
    tx_chrom = np.array([c for _, _, c, *_ in txs], np.int32)
    base_tx = np.repeat(ex_tx, ex_n)
    codes = np.full(total, PAD_CODE, np.uint8)
    codes[at] = genome.codes[genome.piece_offsets[tx_chrom[base_tx]]
                             + gpos - 1]
    pos = np.zeros(total, np.int32)
    pos[at] = gpos
    tx_end = np.array([ex[-1][1] for *_, ex in txs], np.int32)
    t_end = np.zeros(total, np.int32)
    t_end[at] = tx_end[base_tx]
    per_base = {}
    for key, per_tx in (("transcript", np.arange(len(txs), dtype=np.int32)),
                        ("gene", tx_gene), ("chrom", tx_chrom)):
        a = np.full(total, -1, np.int32)
        a[at] = per_tx[base_tx]
        per_base[key] = a
    n_genes = int(tx_gene.max()) + 1
    gene_lo = np.full(n_genes, np.iinfo(np.int32).max, np.int64)
    gene_hi = np.zeros(n_genes, np.int64)
    np.minimum.at(gene_lo, tx_gene, [ex[0][0] for *_, ex in txs])
    np.maximum.at(gene_hi, tx_gene, tx_end)
    gene_chrom = np.zeros(n_genes, np.int32)
    gene_chrom[tx_gene] = tx_chrom
    return dict(gtf="".join(lines), codes=codes, names=names,
                offsets=offsets.astype(np.int64), padding=PAD, pos=pos,
                t_end=t_end, **per_base, tx_gene=tx_gene, tx_chrom=tx_chrom,
                tx_len=tx_len, weight=weight, gene_chrom=gene_chrom,
                gene_lo=gene_lo, gene_hi=gene_hi)

