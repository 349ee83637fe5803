"""Read source "transcripts": FR pairs of an RNA-seq library, cut from
the configuration's extra input "transcriptome"
(benchmark/gen/extras/transcriptome.py).

A mix's `read_len`, `insert_lo` / `insert_hi`, `sub_rate` and `quality`
as for the source "genome", and:
  genomic_share   fragments cut from the genome body by the source
                  "genome" (intronic and intergenic fragments of a
                  poly-A library);
  chimeric_share  fragments whose two ends come from fragments of two
                  transcripts of different genes;
the rest from one transcript, chosen in proportion to its expression
weight among the transcripts at least `insert_lo` long, the fragment's
length uniform in [insert_lo, insert_hi) as the source "genome" draws
it, and no longer than the transcript, cut from the spliced sequence at
a uniform start.  Each fragment's kind is drawn on its own.  End 0 is
a fragment's first `read_len` bases, end 1 the reverse complement of its
last; `true_loc` is the genome offset of each end's first aligned base.

Neither share has a published source yet: the tests' 0.10 and 0.005 are
guesses, not readings of a library.  A mix that sets them for a cell
cites beside each the published figure it takes, such as the intronic
and intergenic read rates of GTEx or ENCODE poly-A libraries, and a
measured chimeric read rate.
"""
from __future__ import annotations

import numpy as np

from ..reads import Batch, substitute
from . import genome as genome_source

GENOMIC, TRANSCRIPT, CHIMERIC = 0, 1, 2


def _genome_offsets(genome, tr: dict, at: np.ndarray) -> np.ndarray:
    """Genome offset of each transcriptome base at `at`."""
    return (genome.piece_offsets[tr["chrom"][at]]
            + tr["pos"][at].astype(np.int64) - 1)


def _spliced(tr: dict, traffic: dict, n: int, rng):
    """n fragments of transcripts drawn by weight: (transcript, first
    transcriptome base, length)."""
    lo, hi = int(traffic["insert_lo"]), int(traffic["insert_hi"])
    ok = np.nonzero(tr["tx_len"] >= lo)[0]
    w = tr["weight"][ok]
    t = ok[rng.choice(ok.size, size=n, p=w / w.sum())]
    top = np.minimum(hi, tr["tx_len"][t] + 1)
    ins = lo + (rng.random(n) * (top - lo)).astype(np.int64)
    start = (rng.random(n) * (tr["tx_len"][t] - ins + 1)).astype(np.int64)
    return t, tr["offsets"][t] + start, ins


def fragments(genome, extras: dict, traffic: dict, n_frag: int, rng):
    """(Batch, kind of each fragment: GENOMIC, TRANSCRIPT or CHIMERIC)."""
    tr = extras["transcriptome"]
    L = int(traffic["read_len"])
    u = rng.random(n_frag)
    gs, cs = float(traffic["genomic_share"]), float(traffic["chimeric_share"])
    kind = np.where(u < gs, GENOMIC,
                    np.where(u < gs + cs, CHIMERIC, TRANSCRIPT))
    # from the genome body, by the source "genome"
    g = np.nonzero(kind == GENOMIC)[0]
    body = genome_source.make_batch(genome, extras, traffic, g.size, rng)
    # from one transcript; end 1 of a chimeric fragment from a second
    # transcript of another gene
    t = np.nonzero(kind != GENOMIC)[0]
    tx_a, first_a, ins_a = _spliced(tr, traffic, t.size, rng)
    tx_b, first_b, ins_b = tx_a, first_a, ins_a
    c = np.nonzero(kind[t] == CHIMERIC)[0]
    if c.size:
        tx_b, first_b, ins_b = (x.copy() for x in (tx_a, first_a, ins_a))
        todo = c
        while todo.size:
            tx, fi, ii = _spliced(tr, traffic, todo.size, rng)
            tx_b[todo], first_b[todo], ins_b[todo] = tx, fi, ii
            todo = todo[tr["tx_gene"][tx] == tr["tx_gene"][tx_a[todo]]]
    cols = np.arange(L)
    at = [first_a[:, None] + cols, (first_b + ins_b - L)[:, None] + cols]
    spliced = [tr["codes"][at[0]], 3 - tr["codes"][at[1][:, ::-1]]]
    for r in spliced:
        substitute(r, float(traffic["sub_rate"]), rng)
    reads = [np.zeros((n_frag, L), np.uint8) for _ in range(2)]
    true = [np.zeros(n_frag, np.int64) for _ in range(2)]
    for e in (0, 1):
        reads[e][g], true[e][g] = body.reads[e], body.true_loc[e]
        reads[e][t] = spliced[e]
        true[e][t] = _genome_offsets(genome, tr, at[e][:, 0])
    q = np.full((n_frag, L), ord(traffic["quality"]), np.uint8)
    return Batch(reads=reads, quals=[q, q.copy()], true_loc=true), kind


def make_batch(genome, extras: dict, traffic: dict, n_frag: int,
               rng) -> Batch:
    if int(traffic["ends"]) != 2:
        raise ValueError("the source 'transcripts' makes pairs")
    return fragments(genome, extras, traffic, n_frag, rng)[0]
