"""The RNA-seq cell's inputs on the CPU: the extra input "transcriptome"
(gen/extras/transcriptome.py) and the read source "transcripts"
(gen/sources/transcripts.py) are the seed's; without substitutions each
end is the spliced genome sequence at its true_loc; the genomic and
chimeric shares are the mix's.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import numpy as np
import pytest

from benchmark.gen.extras import transcriptome
from benchmark.gen.genome import make_genome
from benchmark.gen.reads import rng_for
from benchmark.gen.sources import transcripts
from benchmark.gen.sources.transcripts import CHIMERIC, GENOMIC, TRANSCRIPT
from benchmark.tests.test_bench_lookups import digest, extras_arrays

# hglike-64m-rna's annotation at 1 Mb, its gene density kept
SPEC = dict(kind="transcriptome", seed=20261018, genes=20, isoforms=[2, 6],
            exons=[3, 12], exon_len=[80, 400], intron_len=[150, 2500],
            first_gap=[1000, 5000], keep=0.7, expression_sigma=1.5)
MIX = dict(mode="paired", read_len=100, insert_lo=200, insert_hi=400,
           sub_rate=0.01, quality="I", ends=2, source="transcripts",
           genomic_share=0.10, chimeric_share=0.005)
N_FRAG = 16384


@pytest.fixture(scope="module")
def genome():
    return make_genome(dict(kind="hg_like", bases=1_000_000, chromosomes=1,
                            seed=0, padding=500), workers=1)


@pytest.fixture(scope="module")
def tr(genome):
    return transcriptome.make(genome, SPEC)


def test_extra_and_source_are_the_seed_s(genome, tr):
    assert digest(extras_arrays(transcriptome.make(genome, SPEC))) == \
        digest(extras_arrays(tr))
    other = transcriptome.make(genome, dict(SPEC, seed=SPEC["seed"] + 1))
    assert other["gtf"] != tr["gtf"]
    assert len(tr["names"]) > 2 * SPEC["genes"]
    seed = 2 ** 31 + 977

    def batch(s):
        b, kind = transcripts.fragments(genome, {"transcriptome": tr}, MIX,
                                        512, rng_for(s))
        return [kind] + b.reads + b.quals + b.true_loc
    a, b, c = batch(seed), batch(seed), batch(seed + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])


def _gene_at(tr, true_loc, genome):
    """The gene whose span holds each genome offset (genes never overlap),
    -1 between genes."""
    pos = true_loc - genome.piece_offsets[0] + 1
    g = np.searchsorted(tr["gene_lo"], pos, side="right") - 1
    return np.where((g >= 0) & (pos <= tr["gene_hi"][np.maximum(g, 0)]),
                    g, -1)


def test_ends_are_the_spliced_genome_at_true_loc(genome, tr):
    b, kind = transcripts.fragments(genome, {"transcriptome": tr},
                                    dict(MIX, sub_rate=0.0), 2048,
                                    rng_for(5))
    L = MIX["read_len"]
    # genome offset of every transcriptome base, -1 on padding
    flat = np.where(tr["transcript"] >= 0, genome.piece_offsets[0]
                    + tr["pos"].astype(np.int64) - 1, -1)
    by_flat = np.argsort(flat, kind="stable")
    spliced = 0
    for e, (reads, true) in enumerate(zip(b.reads, b.true_loc)):
        seq = reads if e == 0 else (3 - reads[:, ::-1])
        for i in range(len(true)):
            if kind[i] == GENOMIC:
                assert np.array_equal(seq[i], genome.codes[true[i]:
                                                           true[i] + L])
                continue
            lo, hi = np.searchsorted(flat[by_flat], [true[i], true[i] + 1])
            at = by_flat[lo:hi]
            assert any(np.array_equal(seq[i], tr["codes"][o:o + L])
                       and tr["transcript"][o] == tr["transcript"][o + L - 1]
                       for o in at), (e, i)
            spliced += flat[at[0] + L - 1] - flat[at[0]] != L - 1
    assert spliced > 0
    genes = [_gene_at(tr, t, genome) for t in b.true_loc]
    from_tx = kind != GENOMIC
    assert (genes[0][from_tx] >= 0).all() and (genes[1][from_tx] >= 0).all()
    assert (genes[0][kind == TRANSCRIPT] == genes[1][kind == TRANSCRIPT]
            ).all()
    assert (genes[0][kind == CHIMERIC] != genes[1][kind == CHIMERIC]).all()


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 12])
def test_shares_are_the_mix_s(genome, tr, seed):
    _, kind = transcripts.fragments(genome, {"transcriptome": tr}, MIX,
                                    N_FRAG, rng_for(seed))
    for k, p in ((GENOMIC, MIX["genomic_share"]),
                 (CHIMERIC, MIX["chimeric_share"])):
        n = int((kind == k).sum())
        sd = (N_FRAG * p * (1 - p)) ** 0.5
        assert abs(n - N_FRAG * p) <= 4 * sd, (k, n)
