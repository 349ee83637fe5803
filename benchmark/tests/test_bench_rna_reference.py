"""The RNA reference (reference/rna.py) against the port's RNA paired
path on the CPU, and its control shown to differ.

At 1 Mb with the annotation's gene density kept (20 genes), the pool of
256 pairs of the mix rna-pe100-bulk, written as FASTQ, goes through the
port as its `paired` command runs it: `build_index`, `GTFReader.load` of
the extra's GTF text, `build_transcriptome_genome` and
`RnaPairedEndPipeline(..., device="cpu")` with the transcriptome aligner
it builds itself (2 x -tmh candidate slots).  `AlignmentFilter
.filter_paired` is wrapped to keep each pair's `PairResult`, which the
pipeline's MAPQ halving then changes in place, and the genome aligner's
`align_batch_device` to keep the genome pair's results.  Every output
of every pair that rna.py judges must equal the reference's, and the
port's transcriptome the extra's.

Pairs of the mix seldom reach the filter's rarer branches, so a second
genome (two chromosomes, four multi-hits an end) is written to hold
pairs made for each: a stretch in six genes' exons, where the first
four multi-hits leave some copies out; copies 3 and 4 substitutions off
the best, at the best + 4; a genome-only end just inside and just
outside the gene buffer at both ends of a gene; end 1 written exactly
in the other direction, a lower pair for CheckNoRC (within a chromosome
and across); end 1's seeds written near end 0, for FindPartialMatches;
the last bases of a transcript, which the overrun rule drops.  With 128
pairs of the mix at half chimeric, every output must again equal the
reference's, and each made pair's outcome be its branch's.

The bfloat16 control must differ from the reference on
test_bench_checks.py's duplicated genome.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.entries.paired import (PAIR_KEYS, PAIRED_OPTIONS,
                                      SINGLE_OPTIONS, options, seed_lookup)
from benchmark.gen.genome import make_genome
from benchmark.gen.reads import Batch, make_pool
from benchmark.program import port_genome
from benchmark.reference import compare, rna
from benchmark.tests.test_bench_checks import duplicated

SEEDS = (2 ** 31 + 5, 977)
PAIRS = 256

# hglike-64m-rna and rna-pe100-bulk as the cell will name them, at 1 Mb
CONFIG = dict(run.load_json(f"{run.HERE}/configs/hglike-64m.json"),
              name="hglike-64m-rna", t_cand_per_read=2000, reference="rna",
              extras=[dict(kind="transcriptome", seed=20261018, genes=1300,
                           isoforms=[2, 6], exons=[3, 12],
                           exon_len=[80, 400], intron_len=[150, 2500],
                           first_gap=[1000, 5000], keep=0.7,
                           expression_sigma=1.5)])
TRAFFIC = dict(run.load_json(f"{run.HERE}/traffic/pe100-bulk.json"),
               name="rna-pe100-bulk", source="transcripts",
               genomic_share=0.10, chimeric_share=0.005)
TRAFFIC["aligner"] = dict(TRAFFIC["aligner"], transcriptome_multi_hits=1000,
                          conf_diff=2)


def small(config: dict) -> dict:
    config = copy.deepcopy(config)
    config["genome"]["bases"] = 1_000_000
    config["extras"][0]["genes"] = 20
    return config


@pytest.fixture(autouse=True)
def _four_threads():
    """The port's transcriptome engine at 2,000 slots takes most of this
    file's time; four threads keep it near 20 s a seed."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _write_fastq(path, reads):
    bases = np.frombuffer(b"AGCT", np.uint8)
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b"@p%d\n%s\n+\n%s\n" % (i, bases[r].tobytes(),
                                           b"I" * len(r)))


def _port(tmp, config, genome, extras) -> dict:
    """The port's genome and transcriptome indexes and annotation."""
    from snap_rnaseq_tpu_torch.index.hash_index import build_index
    from snap_rnaseq_tpu_torch.rna.gtf import GTFReader
    from snap_rnaseq_tpu_torch.rna.transcriptome import \
        build_transcriptome_genome
    gtf = tmp / "anno.gtf"
    gtf.write_text(extras["transcriptome"]["gtf"])
    pg = port_genome(genome)
    tg = build_transcriptome_genome(GTFReader.load(str(gtf)), pg)
    seed_len = int(config["index"]["seed_len"])
    return dict(tmp=tmp, config=config, genome=genome, extras=extras,
                gtf=str(gtf), tg=tg, gidx=build_index(pg, seed_len),
                tidx=build_index(tg, seed_len))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    config = small(CONFIG)
    return _port(tmp_path_factory.mktemp("rna"), config,
                 *run.inputs(config))


def test_port_transcriptome_is_the_extra_s(port):
    from snap_rnaseq_tpu_torch.rna.gtf import GTFReader
    from snap_rnaseq_tpu_torch.rna.t2g import TranscriptomeCoordMap
    x, tg = port["extras"]["transcriptome"], port["tg"]
    assert np.array_equal(tg.codes, x["codes"])
    assert tg.piece_names == x["names"]
    assert np.array_equal(tg.piece_offsets, x["offsets"])
    cmap = TranscriptomeCoordMap(GTFReader.load(port["gtf"]), tg)
    assert np.array_equal(cmap.g_of_t, x["pos"])
    assert np.array_equal(cmap.t_end, x["t_end"])
    assert np.array_equal(cmap.piece_no, x["transcript"])


def port_results(port, pool_batch, tag: str, monkeypatch,
                 traffic: dict = TRAFFIC) -> dict:
    """The pairs through the port's RNA paired pipeline: each pair's
    results as the pipeline leaves them, and the genome aligner's (keys
    "g_*"), in the reference's keys."""
    from snap_rnaseq_tpu_torch.models.paired import PairedAligner
    from snap_rnaseq_tpu_torch.models.paired_pipeline import \
        PairedPipelineOptions
    from snap_rnaseq_tpu_torch.rna import filter as rf
    from snap_rnaseq_tpu_torch.rna.pipeline import RnaPairedEndPipeline
    config, a = port["config"], traffic["aligner"]
    n = pool_batch.reads[0].shape[0]
    fq = [str(port["tmp"] / f"{tag}_{e}.fq") for e in (0, 1)]
    for path, reads in zip(fq, pool_batch.reads):
        _write_fastq(path, reads)
    kept = []
    filter_paired = rf.AlignmentFilter.filter_paired

    def keep(self):
        kept.append(filter_paired(self))
        return kept[-1]
    monkeypatch.setattr(rf.AlignmentFilter, "filter_paired", keep)
    over = options(config, traffic, SINGLE_OPTIONS)
    del over["cand_per_read"]          # the genome's; see the check below
    with seed_lookup(config):
        pipe = RnaPairedEndPipeline(
            port["gidx"], port["tidx"], port["gtf"],
            options=PairedPipelineOptions(min_spacing=a["min_spacing"],
                                          max_spacing=a["max_spacing"]),
            conf_diff=a["conf_diff"],
            transcriptome_multi_hits=a["transcriptome_multi_hits"],
            device="cpu", g_aligner=PairedAligner(
                port["gidx"], device="cpu",
                **options(config, traffic, PAIRED_OPTIONS)), **over)
    assert pipe.g_aligner.cfg.cand_per_read == config["cand_per_read"]
    assert pipe.t_aligner.cfg.cand_per_read == config["t_cand_per_read"]
    genome_rows = []
    align = pipe.g_aligner.align_batch_device

    def keep_rows(*batch):
        res = align(*batch)
        genome_rows.append({k: res[k].cpu().numpy().astype(np.int64)
                            for k in PAIR_KEYS})
        return res
    pipe.g_aligner.align_batch_device = keep_rows
    pipe.run(*fq, str(port["tmp"] / f"{tag}.sam"))
    assert len(kept) == n
    out = {"g_" + k: np.concatenate([r[k] for r in genome_rows])[:n]
           for k in PAIR_KEYS}
    for e in (0, 1):
        out[f"g_loc{e}"] &= 0xFFFFFFFF
    out.update({k: np.zeros(n, np.int64) for k in PAIR_KEYS})
    for i, r in enumerate(kept):
        out["pair_found"][i] = int(r.aligned_as_pair)
        out["pair_score"][i] = (r.ends[0].score + r.ends[1].score
                                if r.aligned_as_pair else -1)
        for e, end in enumerate(r.ends):
            out[f"result{e}"][i] = end.status
            out[f"loc{e}"][i] = end.location if end.status else \
                compare.INVALID
            out[f"dir{e}"][i] = end.direction
            out[f"score{e}"][i] = end.score
            out[f"mapq{e}"][i] = end.mapq
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_port_rna_paired_is_the_reference_s(port, seed, monkeypatch):
    b = make_pool(port["genome"], dict(TRAFFIC, pool_batches=1), 2 * PAIRS,
                  seed, port["extras"])[0]
    got = port_results(port, b, f"s{seed}", monkeypatch)
    ref = rna.make(port["genome"], port["extras"], port["config"], TRAFFIC,
                   "cpu")
    want = ref.align(b.reads, b.quals)
    assert set(rna.fields(got, want, True).values()) == {0}
    assert rna.numbers(got, want, True) == dict(
        mismatch_share=0.0, genome_mismatch_share=0.0)
    for k in got:
        assert np.array_equal(got[k], want[k]), k
    # reads with several transcriptome hits are among them
    assert ref.stats["multi_hits"].max() > 1


def test_partial_matches_are_the_port_s(port):
    """FindPartialMatches: each read's locations, from the reference's
    genome scan and from the port's CharacterizeSeeds on its index; and
    the demotion, for each pair's two ends (near, in one gene) and for
    end 0 beside the next pair's end 1 (genes apart)."""
    from snap_rnaseq_tpu_torch.rna.filter import (SINGLE_HIT,
                                                  AlignmentFilter,
                                                  PairResult,
                                                  characterize_seeds)
    b = make_pool(port["genome"], dict(TRAFFIC, pool_batches=1), 2 * PAIRS,
                  SEEDS[0], port["extras"])[0]
    ref = rna.make(port["genome"], port["extras"], port["config"], TRAFFIC,
                   "cpu")
    reads = np.concatenate(b.reads)
    L = reads.shape[1]
    maps = [characterize_seeds(port["gidx"], r, rna.CHAR_SEEDS,
                               rna.CHAR_MAX_HITS) for r in reads]
    values = ref._partial_values(reads, ref._char_hits(reads))
    for (fwd, rc), v in zip(maps, values):
        assert sorted(v.tolist()) == sorted(
            [loc + min(o) for loc, o in fwd.items()]
            + [loc + L - max(o) for loc, o in rc.items()])
    a = TRAFFIC["aligner"]
    demoted = []
    for i in range(PAIRS):
        for j in (PAIRS + i, PAIRS + (i + 1) % PAIRS):
            result = PairResult()
            for end in result.ends:
                end.status = SINGLE_HIT
            AlignmentFilter(
                port["gidx"].genome, None, None, a["min_spacing"],
                a["max_spacing"], a["conf_diff"], a["max_dist"],
                ref.seed_len, read_lens=(L, L),
                characterizer=lambda e, m=(maps[i], maps[j]): m[e]
            )._find_partial_matches(result)
            got = result.ends[0].status != SINGLE_HIT
            assert ref._partial_match(values[i], values[j]) == got, (i, j)
            demoted.append(got)
    assert 0 < np.mean(demoted) < 1


def test_control_in_bfloat16_differs(monkeypatch):
    """The control on a genome whose reads all have a near placement."""
    import benchmark.gen.genomes.hg_like as hg
    monkeypatch.setattr(hg, "hg_like", duplicated)
    config = small(CONFIG)
    genome, extras = run.inputs(config)
    b = make_pool(genome, dict(TRAFFIC, pool_batches=1), 2 * PAIRS,
                  SEEDS[0], extras)[0]
    want = rna.make(genome, extras, config, TRAFFIC, "cpu").align(
        b.reads, b.quals)
    got = rna.make(genome, extras, config, TRAFFIC, "cpu",
                   control=True).align(b.reads, b.quals)
    assert rna.numbers(got, want, True)["genome_mismatch_share"] > 0


# ------------------------------------------------------------ branches

# two chromosomes, four multi-hits an end (the port's 128 slots for
# them, max(128, 2 x -tmh)), half the fragments chimeric
BRANCH_CONFIG = dict(small(CONFIG), t_cand_per_read=128)
BRANCH_CONFIG["genome"] = dict(BRANCH_CONFIG["genome"], chromosomes=2)
BRANCH_TRAFFIC = dict(TRAFFIC, chimeric_share=0.5)
BRANCH_TRAFFIC["aligner"] = dict(TRAFFIC["aligner"],
                                 transcriptome_multi_hits=4)
L = 100


class Layout:
    """The annotation of a genome, before its transcriptome is made: each
    gene's chromosome, span, exons and transcripts, and where reads can
    be cut and sequence written."""

    def __init__(self, genome, spec: dict):
        from benchmark.gen.extras import transcriptome
        self.genome = genome
        self.txs = transcriptome.annotation(
            genome, spec, np.random.default_rng(int(spec["seed"])))
        self.genes = sorted({g for g, *_ in self.txs})
        self.chrom = {g: c for g, _, c, *_ in self.txs}
        self.span = {g: (min(ex[0][0] for g_, *_, ex in self.txs
                             if g_ == g),
                         max(ex[-1][1] for g_, *_, ex in self.txs
                             if g_ == g)) for g in self.genes}
        self.free = list(self.genes)

    def take(self, pick=lambda g: True, chrom=None) -> int:
        """A gene used by no other case."""
        g = next(g for g in self.free if pick(g)
                 and chrom in (None, self.chrom[g]))
        self.free.remove(g)
        return g

    def offset(self, g: int, pos: int) -> int:
        """The genome offset of 1-based position `pos` on g's chromosome."""
        return int(self.genome.piece_offsets[self.chrom[g]]) + pos - 1

    def exons(self, g: int) -> list:
        """(exon, transcripts that keep it) of gene g, in genome order."""
        keep = {}
        for t, (g_, _, _, _, ex) in enumerate(self.txs):
            if g_ == g:
                for e in ex:
                    keep.setdefault(e, []).append(t)
        return sorted(keep.items())

    def intergenic(self, chrom: int) -> int:
        """A genome offset on `chrom` 2,000 bases or more from every gene
        and from the chromosome's ends, after the last gene."""
        hi = max(self.span[g][1] for g in self.genes
                 if self.chrom[g] == chrom)
        assert hi + 2_000 + 4 * L < self.genome.piece_len
        return int(self.genome.piece_offsets[chrom]) + hi + 2_000

    def spliced(self, tr: dict, t: int):
        """Transcript t's codes and each base's genome offset."""
        at = np.arange(tr["offsets"][t], tr["offsets"][t] + tr["tx_len"][t])
        return tr["codes"][at], (self.genome.piece_offsets[tr["chrom"][at]]
                                 + tr["pos"][at].astype(np.int64) - 1)


def rc(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(np.uint8)


def mutate(codes: np.ndarray, at) -> np.ndarray:
    out = codes.copy()
    out[list(at)] = (out[list(at)] + 1) % 4
    return out


def branch_cases(genome, spec: dict):
    """Pairs, each made to reach one branch of the filter, and the genome
    written to hold them: (extras, [(name, read 0, read 1)])."""
    from benchmark.gen.extras import transcriptome
    lay, codes = Layout(genome, spec), genome.codes
    rng = np.random.default_rng(11)
    later = []         # (name, reads(transcriptome) -> (read 0, read 1))

    def first_tx(g):
        return next(t for t, (g_, *_) in enumerate(lay.txs) if g_ == g)

    def head(tr, g):
        """The first L bases of g's first transcript."""
        return lay.spliced(tr, first_tx(g))[0][:L]

    def at(g, pos, n=L):
        return codes[lay.offset(g, pos):lay.offset(g, pos) + n]

    # CheckNoRC: end 0 on gene A, end 1 on gene B (on A's chromosome, or
    # the other) 2 substitutions off, and end 1 as read written exactly
    # past the genes of A's chromosome: a pair of one direction scores
    # lower than the best
    a = lay.take(chrom=0)
    for name, chrom, shift in (("no_rc_intrachrom", 0, 0),
                               ("no_rc_interchrom", 1, 2 * L)):
        b = lay.take(chrom=chrom)

        def no_rc(tr, a=a, b=b, x=lay.intergenic(0) + shift):
            r1 = mutate(rc(head(tr, b)), (30, 70))
            codes[x:x + L] = r1
            return head(tr, a), r1
        later.append((name, no_rc))
    # FindPartialMatches: end 0 near gene A's end, end 1 on gene B, and
    # end 1's first 40 bases written 300 past A's end, where its seeds
    # reach and no alignment of it does
    a, b = lay.take(chrom=0), lay.take(chrom=0)

    def partial(tr, a=a, b=b):
        r1 = rc(head(tr, b))
        at(a, lay.span[a][1] + 300, 40)[:] = r1[:40]
        return at(a, lay.span[a][1] - L - 50).copy(), r1
    later.append(("partial", partial))
    # the overrun rule: end 1 the last L bases of a transcript whose last
    # exon holds them (a transcriptome hit that AddAlignment drops), end 0
    # on the other chromosome's genome alone
    g = lay.take(lambda g: lay.exons(g)[-1][0][1] - lay.exons(g)[-1][0][0]
                 >= L, chrom=0)
    t = next(t for t, (g_, *_, ex) in enumerate(lay.txs)
             if g_ == g and ex[-1] == lay.exons(g)[-1][0])
    x = lay.intergenic(1) + 4 * L
    later.append(("overrun", lambda tr, t=t, x=x: (
        codes[x:x + L].copy(), rc(lay.spliced(tr, t)[0][-L:]))))
    # the gene buffer: end 0 on a gene's transcript, end 1 on the genome
    # alone, just inside and just outside 1,000 bases of the gene's ends
    g = lay.take()
    lo, hi = lay.span[g]
    for name, pos in (("buffer_in_3", hi + 1_000),
                      ("buffer_out_3", hi + 1_001),
                      ("buffer_in_5", lo - 999),
                      ("buffer_out_5", lo - 1_000)):
        later.append((name, lambda tr, g=g, pos=pos: (
            head(tr, g), rc(at(g, pos)))))

    # the multi-hit cuts: a 120-base stretch written into an exon of
    # several genes; end 0 reads it, end 1 lies 1,200 or more bases off
    # in one of them, out of the genome pair's reach
    def far(g, ex):
        return [e for e, _ in lay.exons(g)
                if abs(e[0] - ex[0]) >= 1_200 and e[1] - e[0] + 1 >= L]

    def stretch(g, once: bool):
        """An exon of g 200 bases or more long (held by one transcript
        alone where `once`) with an exon far from it."""
        return next((e for e, ts in lay.exons(g) if e[1] - e[0] >= 200
                     and (len(ts) == 1 or not once) and far(g, e)), None)

    def cut(name, g, ex, sub, subs=()):
        at(g, ex[0] + 40, 120)[:] = mutate(sub, subs)
        e = far(g, ex)[0]
        return (name, lambda tr: (sub[10:110], rc(at(g, e[0]))))
    # at the best + 4: exact in one gene, 3 substitutions off in a second,
    # 4 in a third; end 1 in the second or the third
    R = rng.integers(0, 4, 120, dtype=np.uint8)
    for subs in ((), (30, 50, 70), (30, 50, 70, 90)):
        g = lay.take(lambda g: stretch(g, True))
        case = cut(f"best_plus_{len(subs)}", g, stretch(g, True), R, subs)
        if subs:
            later.append(case)
    # at transcriptome_multi_hits: exact in six genes; the genome pair
    # picks one copy, and which others stay is the first four hits'
    R = rng.integers(0, 4, 120, dtype=np.uint8)
    for k in range(6):
        g = lay.take(lambda g: stretch(g, False))
        later.append(cut(f"multi_hits_{k}", g, stretch(g, False), R))
    # the reads of CheckNoRC and FindPartialMatches are written where no
    # exon lies: the transcriptome made again is the same
    tr0 = transcriptome.make(genome, spec)
    cases = [(name, *reads(tr0)) for name, reads in later]
    tr = transcriptome.make(genome, spec)
    assert np.array_equal(tr["codes"], tr0["codes"])
    return {"transcriptome": tr}, cases


@pytest.fixture(scope="module")
def branch_port(tmp_path_factory):
    genome = make_genome(BRANCH_CONFIG["genome"], workers=1)
    extras, cases = branch_cases(genome, BRANCH_CONFIG["extras"][0])
    return (_port(tmp_path_factory.mktemp("branches"), BRANCH_CONFIG,
                  genome, extras), cases)


@pytest.mark.parametrize("seed", SEEDS)
def test_port_rna_paired_is_the_reference_s_on_every_branch(
        branch_port, seed, monkeypatch):
    """The made pairs, then 128 of the mix at half chimeric: every output
    equal, and each made pair's outcome the one its branch gives."""
    port, cases = branch_port
    b = make_pool(port["genome"], dict(BRANCH_TRAFFIC, pool_batches=1),
                  256, seed, port["extras"])[0]
    reads = [np.concatenate([np.stack([c[1 + e] for c in cases]),
                             b.reads[e]]) for e in (0, 1)]
    quals = [np.full_like(r, ord("I")) for r in reads]
    got = port_results(port, Batch(reads=reads, quals=quals, true_loc=[]),
                       f"b{seed}", monkeypatch, BRANCH_TRAFFIC)
    ref = rna.make(port["genome"], port["extras"], port["config"],
                   BRANCH_TRAFFIC, "cpu")
    want = ref.align(reads, quals)
    for k in got:
        assert np.array_equal(got[k], want[k]), k
    out = {name: {k: int(v[i]) for k, v in want.items()} | dict(
        cls=int(ref.stats["cls"][i]), fpm=bool(ref.stats["fpm"][i]))
        for i, (name, *_) in enumerate(cases)}
    chrom = np.searchsorted(port["genome"].piece_offsets,
                            [out["overrun"]["loc0"], out["overrun"]["loc1"]],
                            side="right") - 1
    # two ends on the genome alone pair wherever they lie
    assert out["overrun"]["pair_found"] == 1 and list(chrom) == [1, 0]
    for side in (3, 5):
        assert out[f"buffer_in_{side}"]["pair_found"] == 1
        assert out[f"buffer_out_{side}"]["cls"] == rna.INTRACHROM
    for name, cls in (("no_rc_intrachrom", rna.INTRACHROM),
                      ("no_rc_interchrom", rna.INTERCHROM)):
        assert out[name]["cls"] == cls and not out[name]["fpm"]
        assert out[name]["result0"] == rna.MULTIPLE_HITS
    assert out["partial"]["fpm"]
    assert out["partial"]["result0"] == rna.MULTIPLE_HITS
    assert out["best_plus_3"]["pair_found"] == 1
    assert out["best_plus_4"]["pair_found"] == 0
    cut = [out[f"multi_hits_{k}"]["pair_found"] for k in range(6)]
    assert 0 < sum(cut) < 6
    rest = ref.stats["cls"][len(cases):]
    assert {rna.INTRACHROM, rna.INTERCHROM} <= set(rest.tolist())
    assert ref.stats["fpm"][len(cases):].any()
