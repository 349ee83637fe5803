"""Genomes past 2^31 bases: the port's big-location path against the JAX
package, on the CPU.

The input of every check is a lifted index: a small index whose sequence
is placed at an offset BASE into the location space (the JAX package's
tests/test_big_locations.py _lift_index; this file keeps its own copy).
Hash values and overflow locations shift by +BASE, overflow counts stay,
the genome is BASE padding bases followed by the old codes.  The lifted
genome's packed words are lifted too (BASE is a multiple of 512 bases,
whole 64-word rows), so no 2.2e9-base genome is packed.  Three offsets:

  A  2^31 minus half the genome, a multiple of 512: the genome's middle
     sits at 2^31, one batch holds locations of both signs as int32;
  B  2,200,000,000 (the JAX test's offset): every location past 2^31;
  C  the top: the largest multiple of 512 that leaves genome size plus
     overflow length 1 MiB below 0xFFFFFFF0, expand_phase's dead marker
     (phases only; no genome words).

* pack_genome_4bit in chunks against the JAX function;
* gather_windows(big=True) against the JAX function (after
  tests/test_big_locations.py:78) and on lifted words against the
  unlifted windows;
* _aggregate_rows(big=True) against the JAX function and a u64 oracle
  (after :34);
* seed_phase -> budget_phase -> expand_phase -> _aggregate_rows on lifted
  index arrays at A, B and C against the JAX phases, and against the
  unlifted phases with loc + BASE; the cuckoo layout of a lifted index
  against the JAX package's and the unlifted layout with its values
  lifted;
* SingleAligner and PairedAligner on a 200 kb genome lifted to A and B:
  the unlifted run's outputs with loc + BASE (mod 2^32), held to the
  port's and the JAX package's unlifted runs (the port's counterpart of
  the JAX test at :144);
* characterize_batch and BatchCharacterizer on lifted arrays against the
  JAX package's;
* partition_index of a lifted index in both lookup branches, array for
  array against the JAX function; the mesh aligners on a lifted genome
  against the single-card engines;
* the bulk route's SAM (paired FASTQ to SAM, plain and sorted) on a
  lifted genome: byte-identical to the unlifted run's;
* the per-read route's fault, shared with the JAX package (ROADMAP.md
  section 3): SamRecordBuilder and BamRecordBuilder of both packages on
  the same lifted genome and the int32-wrapped location the pipelines
  pass, and the DNA `single` and RNA `single` pipelines of both packages
  on the same engine results (RNA single reads the genome engine's
  location as int32 and drops every genome hit past 2^31).

Host memory: a lifted genome's words take 4 bytes per 8 bases (1.1 GB at
B); its codes are zero pages but for the real bases and a 64 KiB padding
run below them (the engines read the words; the host's readers read a
record's own bases).  One lifted genome is held at a time.

Integers must be bit-identical, log-probabilities within rtol/atol 1e-5."""
import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_golden_paired_rna as golden_rna

from snap_rnaseq_tpu.index.genome import Genome as JGenome
from snap_rnaseq_tpu.index.genome import genome_from_codes as jgenome
from snap_rnaseq_tpu.index.hash_index import GenomeIndex as JGenomeIndex
from snap_rnaseq_tpu.index.hash_index import build_index as jbuild_index
from snap_rnaseq_tpu.index.hash_index import \
    cuckoo_layout_for as jcuckoo_layout_for
from snap_rnaseq_tpu.io.bam import BamRecordBuilder as JBamRecordBuilder
from snap_rnaseq_tpu.io.reads import Read as JRead
from snap_rnaseq_tpu.io.sam import SamRecordBuilder as JSamRecordBuilder
from snap_rnaseq_tpu.models import single as js
from snap_rnaseq_tpu.models.paired import PairedAligner as JPairedAligner
from snap_rnaseq_tpu.models.pipeline import \
    SingleEndPipeline as JSingleEndPipeline
from snap_rnaseq_tpu.ops.genome_gather import gather_windows as jgather
from snap_rnaseq_tpu.ops.genome_gather import pack_genome_4bit as jpack
from snap_rnaseq_tpu.parallel import sharded as jsh
from snap_rnaseq_tpu.models.pipeline import PipelineOptions as JOptions
from snap_rnaseq_tpu.rna import filter as jfilter
from snap_rnaseq_tpu.rna import pipeline as jrna
from snap_rnaseq_tpu_torch.cli import main as port_cli
from snap_rnaseq_tpu_torch.constants import (INVALID_GENOME_LOCATION,
                                             UNUSED_HASH_VALUE)
from snap_rnaseq_tpu_torch.index.genome import (Genome, genome_from_codes,
                                                read_fasta_genome)
from snap_rnaseq_tpu_torch.index.hash_index import (GenomeIndex,
                                                    build_index,
                                                    cuckoo_layout_for)
from snap_rnaseq_tpu_torch.io.bam import BamRecordBuilder
from snap_rnaseq_tpu_torch.io.reads import Read
from snap_rnaseq_tpu_torch.io.sam import SamRecordBuilder
from snap_rnaseq_tpu_torch.models import single as ts
from snap_rnaseq_tpu_torch.models.paired import PairedAligner
from snap_rnaseq_tpu_torch.models.paired_pipeline import (
    PairedEndPipeline, PairedPipelineOptions)
from snap_rnaseq_tpu_torch.models.pipeline import (PipelineOptions,
                                                   SingleEndPipeline)
from snap_rnaseq_tpu_torch.ops import genome_gather, u32
from snap_rnaseq_tpu_torch.ops.genome_gather import (BASES_PER_WORD,
                                                     gather_windows,
                                                     pack_genome_4bit)
from snap_rnaseq_tpu_torch.parallel import sharded as tsh
from snap_rnaseq_tpu_torch.rna import filter as tfilter
from snap_rnaseq_tpu_torch.rna.pipeline import RnaSingleEndPipeline
from snap_rnaseq_tpu_torch.utils.seed_sequencer import seed_position_schedule
from snap_rnaseq_tpu_torch.utils.synth_genome import (hg_like_genome,
                                                      wgsim_pairs)
from snap_rnaseq_tpu_torch.utils.tables import decode_bases

torch.set_num_threads(1)

N_REAL = 200_000
L = 100
B_READS = 64
OFFSET_B = 2_200_000_000
LIFT_ALIGN = 512                 # BASES_PER_WORD x ROW_WORDS
DEAD = 0xFFFFFFF0                # expand_phase's dead marker -16, as u32
PAD_RUN = 1 << 16                # padding codes written below BASE


# ---------------------------------------------------------------- the lift

def offsets(genome_size: int, overflow_len: int) -> dict:
    """The three lift offsets of a genome of `genome_size` bases."""
    a = ((1 << 31) - genome_size // 2) // LIFT_ALIGN * LIFT_ALIGN
    c = (DEAD - (1 << 20) - genome_size - overflow_len) \
        // LIFT_ALIGN * LIFT_ALIGN
    return dict(A=a, B=OFFSET_B, C=c)


def lift_values(vals, base):
    """Hash values + base, but for the empty and invalid markers."""
    v = np.asarray(vals, np.uint32).copy()
    keep = (v == np.uint32(INVALID_GENOME_LOCATION)) | \
        (v == np.uint32(UNUSED_HASH_VALUE))
    v[~keep] += np.uint32(base)
    return v


def lift_overflow(ovf, base):
    """[count, loc...] runs: the counts stay, the locations shift."""
    ovf = np.asarray(ovf, np.uint32).copy()
    pos = 0
    while pos < ovf.size:
        count = int(ovf[pos])
        ovf[pos + 1:pos + 1 + count] += np.uint32(base)
        pos += 1 + count
    return ovf


def lift_layout(layout, base):
    """A cuckoo layout's entries with their values lifted: bucket columns
    [key x8 | shard x8 | val1 x8 | val2 x8], stash rows [key, shard,
    val1, val2]; an entry is occupied where its shard is not the empty
    marker (INVALID_GENOME_LOCATION)."""
    out = {}
    for k, v in layout.items():
        v = np.asarray(v, np.uint32).copy()
        cap = 8 if k != "ck_stash" else 1
        occ = v[:, cap:2 * cap] != np.uint32(INVALID_GENOME_LOCATION)
        for c in (2, 3):
            cols = v[:, c * cap:(c + 1) * cap]
            cols[occ] = lift_values(cols[occ], base)
        out[k] = v
    return out


def lift_index(idx, base, words=True):
    """`idx` with its sequence placed at `base` (a multiple of 512).  The
    codes below base - PAD_RUN are zero pages that are never touched;
    with `words`, the genome carries its packed words, lifted as whole
    rows of the unlifted genome's."""
    g = idx.genome
    old = np.asarray(g.codes)
    codes = np.zeros(base + old.size, np.uint8)
    codes[base - PAD_RUN:base] = 5
    codes[base:] = old
    extra = {}
    if words:
        p4 = pack_genome_4bit(old)
        w = np.full(base // BASES_PER_WORD + p4.size, 0x55555555, np.uint32)
        w[base // BASES_PER_WORD:] = p4
        extra = dict(packed_4bit=w)
    lg = Genome(codes=codes, piece_names=list(g.piece_names),
                piece_offsets=np.asarray(g.piece_offsets) + base,
                padding=g.padding, **extra)
    return GenomeIndex(genome=lg, seed_len=idx.seed_len, ht_keys=idx.ht_keys,
                       ht_val1=lift_values(idx.ht_val1, base),
                       ht_val2=lift_values(idx.ht_val2, base),
                       shard_starts=idx.shard_starts,
                       overflow=lift_overflow(idx.overflow, base),
                       shard_ovf_starts=idx.shard_ovf_starts)


def jax_twin(idx):
    """The JAX package's GenomeIndex over the same arrays (no copies)."""
    g = idx.genome
    return JGenomeIndex(
        genome=JGenome(codes=g.codes, piece_names=list(g.piece_names),
                       piece_offsets=g.piece_offsets, padding=g.padding),
        seed_len=idx.seed_len, ht_keys=idx.ht_keys, ht_val1=idx.ht_val1,
        ht_val2=idx.ht_val2, shard_starts=idx.shard_starts,
        overflow=idx.overflow, shard_ovf_starts=idx.shard_ovf_starts)


def as_u32(a):
    """Engine locations (int32 bit patterns) as unsigned int64 values."""
    return np.asarray(a).astype(np.int32).view(np.uint32).astype(np.int64)


def same(got, want, name=""):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    if w.dtype == np.uint32:
        g = g.astype(np.int32).view(np.uint32)
    if w.dtype == np.float32:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)
    else:
        np.testing.assert_array_equal(g, w, err_msg=name)


def t(x):
    a = np.array(x)
    return u32.from_numpy(a) if a.dtype == np.uint32 else torch.from_numpy(a)


# ---------------------------------------------------------------- inputs

def simulate_reads(codes, rng, n, starts=()):
    """Reads with substitutions, some indels, N bases and both strands;
    `starts` first (exact copies), then random ones."""
    reads = np.empty((n, L), np.uint8)
    for i in range(n):
        s = int(starts[i]) if i < len(starts) else \
            int(rng.integers(0, codes.size - L - 8))
        seg = list(codes[s:s + L + 8])
        if i >= len(starts):
            for _ in range(int(rng.integers(0, 4))):
                p = int(rng.integers(0, L))
                seg[p] = (seg[p] + int(rng.integers(1, 4))) % 4
            if rng.random() < 0.3:
                p = int(rng.integers(10, L - 10))
                if rng.random() < 0.5:
                    del seg[p:p + int(rng.integers(1, 3))]
                else:
                    seg[p:p] = list(rng.integers(0, 4,
                                                 int(rng.integers(1, 3))))
        r = np.asarray(seg[:L], np.uint8)
        if i % 2:
            r = (3 - r[::-1]).astype(np.uint8)
        reads[i] = r
    reads[-1, 7] = 4
    return reads


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 200 kb hg-like genome indexed by both packages, 64 reads (three
    across the genome's middle, which offset A puts at 2^31) and 64 pairs
    (five with a seedless mate, which the rescue places; two across the
    middle, one of them rescued), the FASTQ files of the pairs, and the
    unlifted runs of both
    packages' aligners."""
    d = tmp_path_factory.mktemp("big_genome")
    real = hg_like_genome(N_REAL, seed=5)
    idx = build_index(genome_from_codes(real), seed_len=20)
    jidx = jbuild_index(jgenome(real), seed_len=20)
    pad = int(idx.genome.piece_offsets[0])
    # the real base that offset A puts at 2^31
    mid = (1 << 31) - offsets(idx.genome_size, idx.overflow.size)["A"] - pad
    rng = np.random.default_rng(11)
    reads = simulate_reads(real, rng, B_READS,
                           starts=(mid - 50, mid - 99, mid))
    quals = rng.integers(40, 74, (B_READS, L)).astype(np.uint8)
    r0, q0, r1, q1, p0, _ = wgsim_pairs(real, B_READS, L, seed=13)
    for i, s in ((0, mid - 150), (1, mid - 60)):     # across the middle
        r0[i] = real[s:s + L]
        r1[i] = 3 - real[s + 300 - L:s + 300][::-1]
    # no exact 20-mer in these mates: the rescue places them (pair 1's
    # rescue window spans the genome's middle)
    for i in range(1, 6):
        r1[i, ::9] = (r1[i, ::9] + 1) % 4
    fq = [str(d / f"r{e}.fq") for e in (1, 2)]
    with open(fq[0], "wb") as f0, open(fq[1], "wb") as f1:
        for i in range(B_READS):
            f0.write(b"@p%d/1\n" % i + decode_bases(r0[i]) + b"\n+\n"
                     + q0[i].tobytes() + b"\n")
            f1.write(b"@p%d/2\n" % i + decode_bases(r1[i]) + b"\n+\n"
                     + q1[i].tobytes() + b"\n")
    pairs = (r0, q0, r1, q1)
    return dict(
        dir=d, real=real, idx=idx, jidx=jidx, reads=reads, quals=quals,
        pairs=pairs, fq=fq,
        single=ts.SingleAligner(idx, device="cpu").align_batch(reads, quals),
        paired=PairedAligner(idx, device="cpu").align_batch(*pairs),
        jsingle=js.SingleAligner(jidx).align_batch(reads, quals),
        jpaired=JPairedAligner(jidx).align_batch(*pairs))


@pytest.fixture(scope="module", params=["A", "B"])
def lifted(request, world):
    """The world's index lifted to offset A or B, with its words."""
    idx = world["idx"]
    base = offsets(idx.genome_size, idx.overflow.size)[request.param]
    return dict(name=request.param, base=base, idx=lift_index(idx, base))


# ---------------------------------------------------------------- ops

@pytest.mark.parametrize("chunk", [8, 1000, 4096, 1 << 24])
def test_pack_genome_4bit_chunked_matches_jax(chunk, monkeypatch):
    """The words of the JAX function, packed `chunk` bases at a time (a
    chunk not a multiple of 8 is cut to one), on a length that no chunk
    divides, with every code 0-5."""
    monkeypatch.setattr(genome_gather, "PACK_CHUNK_BASES", chunk)
    codes = np.random.default_rng(1).integers(0, 6, 100_003).astype(np.uint8)
    got = pack_genome_4bit(codes)
    np.testing.assert_array_equal(got, jpack(codes))
    assert got.dtype == np.uint32


def test_gather_windows_big_matches_jax():
    """tests/test_big_locations.py:78's cases in both packages: small
    positive locations give the big=False windows, u32 locations past
    the table read padding."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, 100_000).astype(np.uint8)
    p4 = pack_genome_4bit(codes)
    locs = np.concatenate([rng.integers(0, 99_000, 64),
                           [3_000_000_000, 2_200_000_000, 4_294_967_000,
                            99_990, 0]]).astype(np.uint64)
    w32 = locs.astype(np.uint32).view(np.int32)
    for big in (True, False):
        if not big:
            w32 = w32[:64]
        for packed in (False, True):
            want = jgather(jnp.asarray(p4), jnp.asarray(w32), width=120,
                           big=big, return_packed=packed)
            got = gather_windows(u32.from_numpy(p4), torch.from_numpy(w32),
                                 width=120, big=big, return_packed=packed)
            for g, w in zip(*((got, want) if packed else ([got], [want]))):
                same(g, w)
    got = gather_windows(u32.from_numpy(p4), torch.from_numpy(w32[:64]),
                         width=120, big=True)
    same(got, jgather(jnp.asarray(p4), jnp.asarray(w32[:64]), width=120))


def test_gather_windows_on_lifted_words(world, lifted):
    """Windows on the lifted words at loc + BASE (u32) are the unlifted
    windows at loc, across 2^31 at A and at the genome's start, where
    the lifted window reads the padding below BASE."""
    idx, base = world["idx"], lifted["base"]
    p4 = pack_genome_4bit(np.asarray(idx.genome.codes))
    lp4 = lifted["idx"].genome.packed_4bit
    rng = np.random.default_rng(4)
    gs = idx.genome_size
    mid = (1 << 31) - offsets(gs, idx.overflow.size)["A"]   # 2^31 at A
    locs = np.concatenate([rng.integers(0, gs - 200, 200),
                           mid - np.arange(0, 140, 7), [0, 3, gs - 1]])
    for packed in (False, True):
        want = gather_windows(u32.from_numpy(p4),
                              torch.from_numpy(locs.astype(np.int32)),
                              width=134, return_packed=packed)
        got = gather_windows(
            u32.from_numpy(lp4),
            t((locs + base).astype(np.uint32)), width=134, big=True,
            return_packed=packed)
        for g, w in zip(*((got, want) if packed else ([got], [want]))):
            assert torch.equal(g, w)
    # just below the genome's start: the unlifted gather clamps to 0, the
    # lifted one reads the padding below BASE
    got = gather_windows(u32.from_numpy(lp4),
                         t(np.array([base - 16], np.uint32)), width=134,
                         big=True)
    assert (got[0, :16] == 5).all()
    same(got[0, 16:], np.asarray(idx.genome.codes[:118]))


def test_aggregate_rows_big_matches_jax_and_oracle():
    """tests/test_big_locations.py:34's rows (locations around 2^31, dead
    slots at the u32 dead marker): the port's rows equal the JAX
    package's, and each row's groups and first orders equal a u64
    oracle's."""
    rng = np.random.default_rng(3)
    R, W = 8, 64
    loc_u = (np.uint64(2_147_482_000)
             + rng.integers(0, 4000, (R, W)).astype(np.uint64))
    dirs = rng.integers(0, 2, (R, W)).astype(np.int32)
    live = rng.random((R, W)) < 0.8
    order = rng.integers(0, 1 << 21, (R, W)).astype(np.int32)
    loc_u = np.where(live, loc_u, np.uint64(DEAD))
    c = dict(dir=dirs, loc=loc_u.astype(np.uint32).view(np.int32),
             order=order,
             offset=rng.integers(0, 900, (R, W)).astype(np.int32),
             round=(order >> 17).astype(np.int32),
             lp=rng.integers(0, 30, (R, W)).astype(np.int32), live=live)
    want = js._aggregate_rows({k: jnp.asarray(v) for k, v in c.items()},
                              big=True)
    got = ts._aggregate_rows({k: torch.from_numpy(v) for k, v in c.items()},
                             big=True)
    assert set(got) == set(want)
    for k in want:
        same(got[k], want[k], k)
    g = {k: v.numpy() for k, v in got.items()}
    for r in range(R):
        groups = {}
        for w in range(W):
            if live[r, w]:
                key = (int(dirs[r, w]), int(loc_u[r, w]))
                groups[key] = min(groups.get(key, 1 << 30), int(order[r, w]))
        reps = {(int(g["dir"][r, w]), int(as_u32(g["loc"][r, w]))):
                int(g["order"][r, w]) for w in range(W) if g["live"][r, w]}
        assert reps == groups, r


# ---------------------------------------------------------------- phases

def _phases(mod, reads, state, arrays, genome_size, positions, wraps, cfg,
            big):
    """seed -> budget -> expand -> _aggregate_rows of one package."""
    if mod is js:
        j = lambda a: jnp.asarray(a)
        seeds = js.seed_phase(j(reads), j(positions), 20, None, None, None,
                              j(arrays["overflow"]), genome_size,
                              tuple(int(p) for p in positions),
                              {k: j(v) for k, v in state.items()})
        cg = jnp.where(seeds["found"][:, :, None], seeds["counts"], 0)
        budget = js.budget_phase(seeds["valid"], cg, j(wraps), cfg)
        cands = js.expand_phase(seeds, budget, j(positions),
                                j(arrays["overflow"]), cfg, 20, L,
                                cfg.cand_per_read, big=big)
    else:
        seeds = ts.seed_phase(t(reads), tuple(int(p) for p in positions), 20,
                              state["overflow"], genome_size, state)
        cg = torch.where(seeds["found"][:, :, None], seeds["counts"], 0)
        budget = ts.budget_phase(seeds["valid"], cg, t(wraps), cfg)
        cands = ts.expand_phase(seeds, budget, t(positions),
                                state["overflow"], cfg, 20, L,
                                cfg.cand_per_read, big=big)
    return seeds, budget, cands, mod._aggregate_rows(cands, big=big)


def _phase_inputs(idx, world):
    arrays = idx.device_arrays()
    layout = cuckoo_layout_for(idx)
    state = ts.index_state_from_numpy(
        dict(arrays, genome_p4=np.zeros(64, np.uint32),
             piece_starts=idx.genome.piece_offsets), layout, "cpu")
    return arrays, layout, state


@pytest.mark.parametrize("at", ["A", "B", "C"])
def test_phases_on_lifted_index(world, at):
    """seed_phase -> budget_phase -> expand_phase -> _aggregate_rows on the
    lifted index arrays (no genome words): every output equals the JAX
    phases' on the same arrays, and the unlifted phases' with each live
    location + BASE (the dead slots at the u32 dead marker); the cuckoo
    layout of the lifted index is the JAX package's and the unlifted
    layout with its values lifted."""
    idx = world["idx"]
    base = offsets(idx.genome_size, idx.overflow.size)[at]
    lifted = lift_index(idx, base, words=False)
    gs = lifted.genome_size
    assert ts.big_locations(gs) and gs + idx.overflow.size <= DEAD - (1 << 20)
    positions, wraps = seed_position_schedule(L, 20)
    positions, wraps = positions[:32], wraps[:32]
    kw = dict(seed_len=20, max_hits_to_get=4, max_hits=24)
    jcfg, tcfg = js.SingleAlignerConfig(**kw), ts.SingleAlignerConfig(**kw)
    reads = world["reads"]

    arrays, layout, state = _phase_inputs(lifted, world)
    jlayout = jcuckoo_layout_for(jax_twin(lifted))
    _, ulayout, ustate = _phase_inputs(idx, world)
    raised = lift_layout(ulayout, base)
    for k in layout:
        np.testing.assert_array_equal(layout[k], jlayout[k], err_msg=k)
        np.testing.assert_array_equal(layout[k], raised[k], err_msg=k)
    got = _phases(ts, reads, state, arrays, gs, positions, wraps, tcfg, True)
    want = _phases(js, reads, layout, arrays, gs, positions, wraps, jcfg,
                   True)
    for g, w in zip(got, want):
        for k in w:
            same(g[k], w[k], k)
    # against the unlifted phases: the same decisions, loc + BASE.  The
    # element stats of _aggregate_rows (weight, lp) group locations into
    # 48-base buckets aligned to location 0, so a lift that is not a
    # multiple of 48 moves their edges; the JAX comparison holds them.
    ref = _phases(ts, reads, ustate, idx.device_arrays(), idx.genome_size,
                  positions, wraps, tcfg, False)
    for stage, (g, r) in enumerate(zip(got, ref)):
        for k in r:
            if k in ("loc", "vals", "bases") or (
                    stage == 3 and k in ("weight", "lp")):
                continue
            assert torch.equal(g[k], r[k]), (stage, k)
    rv = u32.to_i64(ref[0]["vals"])
    marker = (rv == INVALID_GENOME_LOCATION) | (rv == UNUSED_HASH_VALUE)
    assert torch.equal(u32.to_i64(got[0]["vals"]),
                       torch.where(marker, rv, rv + base))
    for c, (g, r) in enumerate(zip(got[2:], ref[2:])):
        live = r["live"]
        assert torch.equal(u32.to_i64(g["loc"])[live],
                           u32.to_i64(r["loc"])[live] + base)
        if c == 0:
            assert (g["loc"][~live] == -16).all()
    assert bool(got[3]["live"].any())


# ---------------------------------------------------------------- RNA single

@pytest.fixture(scope="module")
def rna_world(tmp_path_factory):
    """tests/test_golden_paired_rna.py's two-chromosome genome, annotation
    and RNA reads (from a spliced transcript and from the genome), the
    port's genome index and its `transcriptome` directory."""
    tmp = str(tmp_path_factory.mktemp("big_rna"))
    fa, gtf, jg = golden_rna._build_ref(tmp)
    reads = golden_rna._rna_dataset(tmp, jg, gtf)
    tidx = os.path.join(tmp, "tidx")
    with contextlib.redirect_stdout(io.StringIO()):
        assert port_cli(["transcriptome", gtf, fa, tidx,
                         "--device", "cpu"]) == 0
    return dict(tmp=tmp, gtf=gtf, reads=reads, tidx=tidx,
                index=build_index(read_fasta_genome(fa), seed_len=20))


def _spied(aligner):
    """The aligner's fetched outputs, batch by batch, as it runs."""
    outs, real = [], aligner.align_batch_device

    def spy(*a):
        out = real(*a)
        outs.append(ts.fetch(out))
        return out
    aligner.align_batch_device = spy
    return outs


def test_rna_single_fault_shared(rna_world, monkeypatch):
    """RNA `single` with the genome index lifted to B: the port's run (its
    engines) and the JAX package's (RnaSingleEndPipeline on the same
    engine outputs) write the same SAM records and count files; a record
    differs from the unlifted run's only for a read whose genome engine
    result lies past 2^31, which the drain's int32 `gloc >= 0` drops."""
    w = rna_world
    lifted = lift_index(w["index"], OFFSET_B)
    g_al = ts.SingleAligner(lifted, device="cpu")
    t_al = ts.SingleAligner(GenomeIndex.load(w["tidx"]), device="cpu")
    g_outs, t_outs = _spied(g_al), _spied(t_al)
    runs = {}
    for name in ("port", "jax", "unlifted"):
        d = os.path.join(w["tmp"], f"rna_{name}")
        os.makedirs(d)
        out = os.path.join(d, "r.sam")
        if name == "jax":
            jlifted = jax_twin(lifted)

            class Load:
                load = staticmethod(lambda p: jlifted if p == "lifted"
                                    else JGenomeIndex.load(p))
            monkeypatch.setattr(jrna, "GenomeIndex", Load)
            jrna.RnaSingleEndPipeline(
                "lifted", w["tidx"], w["gtf"],
                options=JOptions(batch_size=B_READS),
                g_aligner=_Replay(g_al.cfg, g_outs),
                t_aligner=_Replay(t_al.cfg, t_outs)).run(w["reads"], out)
        else:
            RnaSingleEndPipeline(
                lifted if name == "port" else w["index"], w["tidx"],
                w["gtf"], options=PipelineOptions(batch_size=B_READS),
                device="cpu", **(dict(g_aligner=g_al, t_aligner=t_al)
                                 if name == "port" else {})).run(
                                     w["reads"], out)
        runs[name] = {f: open(os.path.join(d, f), "rb").read()
                      for f in sorted(os.listdir(d)) if f != "r.sam"}
        runs[name]["records"] = _records(out)
    assert runs["port"] == runs["jax"]
    got, ref = runs["port"]["records"], runs["unlifted"]["records"]
    n = len(ref)                   # one record a read; the batch is padded
    res = np.concatenate([o["result"] for o in g_outs])[:n]
    loc = np.concatenate([as_u32(o["loc"]) for o in g_outs])[:n]
    past = (res != 0) & (loc >= 1 << 31)
    unlike = [i for i, (a, b) in enumerate(zip(got, ref)) if a != b]
    assert len(got) == n
    assert unlike and all(past[i] for i in unlike)


# ---------------------------------------------------------------- engines

SINGLE_FIELDS = ("result", "direction", "score", "mapq", "log_pbest",
                 "log_pall", "popular", "truncated", "n_lookups",
                 "n_candidates", "n_unique_candidates", "n_scored",
                 "score_overflow")


def _held(got, want, base, loc_keys):
    """Every field of `want` in `got`; locations + base (mod 2^32) where
    their result is mapped, else equal."""
    for k, w in want.items():
        g = np.asarray(got[k])
        if k in loc_keys:
            res = np.asarray(want[loc_keys[k]]) != 0
            np.testing.assert_array_equal(
                as_u32(g)[res], (as_u32(w)[res] + base) % (1 << 32), k)
            np.testing.assert_array_equal(g[~res], np.asarray(w)[~res], k)
        elif np.asarray(w).dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_single_aligner_on_lifted_genome(world, lifted):
    """SingleAligner on the lifted genome: the port's unlifted outputs
    with loc + BASE, and the JAX package's unlifted ones."""
    base = lifted["base"]
    got = ts.SingleAligner(lifted["idx"], device="cpu").align_batch(
        world["reads"], world["quals"])
    _held(got, world["single"], base, {"loc": "result"})
    jwant = {k: np.asarray(world["jsingle"][k]) for k in world["single"]}
    _held(got, jwant, base, {"loc": "result"})
    mapped = np.asarray(got["result"]) != 0
    assert mapped.sum() >= B_READS - 4
    loc = as_u32(got["loc"])[mapped]
    if lifted["name"] == "A":            # both int32 signs in one batch
        assert (loc < 1 << 31).any() and (loc >= 1 << 31).any()
    else:
        assert (loc >= 1 << 31).all()


def test_paired_aligner_on_lifted_genome(world, lifted):
    """PairedAligner on the lifted genome (mates, rescue windows, pair
    distance and key in u32): the port's unlifted outputs with both
    ends' loc + BASE, and the JAX package's unlifted ones."""
    base = lifted["base"]
    got = PairedAligner(lifted["idx"], device="cpu").align_batch(
        *world["pairs"])
    keys = {"loc0": "result0", "loc1": "result1"}
    _held(got, world["paired"], base, keys)
    jwant = {k: np.asarray(world["jpaired"][k]) for k in world["paired"]}
    _held(got, jwant, base, keys)
    assert int(got["n_rescued0"]) + int(got["n_rescued1"]) >= 5
    assert np.asarray(got["pair_found"]).sum() >= B_READS - 4
    if lifted["name"] == "A":            # pairs with an end on each side
        lo = as_u32(got["loc0"])[:2] < 1 << 31
        hi = as_u32(got["loc1"])[:2] >= 1 << 31
        assert (lo & hi).all()


def test_mesh_on_lifted_genome(world, lifted):
    """The mesh aligners on a (1, 2) CPU mesh over the lifted index
    (partition_index's slices, their overflow pointers past 2^31): the
    same mesh's results on the unlifted index with loc + BASE."""
    mesh = tsh.make_mesh(1, 2, device="cpu")
    base, idx = lifted["base"], world["idx"]
    runs = [(tsh.ShardedSingleAligner(i, mesh).align_batch(
        world["reads"], world["quals"]), tsh.ShardedPairedAligner(
            i, mesh).align_batch(*world["pairs"]))
            for i in (lifted["idx"], idx)]
    (single, paired), (usingle, upaired) = runs
    _held(single, usingle, base, {"loc": "result"})
    _held(paired, upaired, base, {"loc0": "result0", "loc1": "result1"})
    assert (np.asarray(single["result"]) != 0).sum() >= B_READS - 4


# ---------------------------------------------------------------- RNA, mesh

@pytest.mark.parametrize("at", ["A", "B"])
def test_characterize_batch_on_lifted_index(world, at):
    """The seed characterizer on lifted index arrays: characterize_batch's
    outputs and BatchCharacterizer's maps equal the JAX package's.  Its
    int32 loc drops every hit past 2^31 from the maps in both packages
    (the shared fault of ROADMAP.md section 3), where the host walk
    keeps them."""
    idx = world["idx"]
    base = offsets(idx.genome_size, idx.overflow.size)[at]
    lifted = lift_index(idx, base, words=False)
    arrays, layout, state = _phase_inputs(lifted, world)
    reads = world["reads"]
    positions = tuple(int(p) for p in seed_position_schedule(L, 20)[0][:12])
    got = tfilter.characterize_batch(t(reads), state, positions=positions,
                                     seed_len=20, max_hits=300, read_len=L,
                                     cpr=512)
    jdev = {k: jnp.asarray(arrays[k]) for k in
            ("ht_entries", "shard_start", "shard_size", "overflow")}
    jlayout = {k: jnp.asarray(v) for k, v in layout.items()}
    want = jfilter._characterize_batch_jit()(
        jnp.asarray(reads), jdev["ht_entries"], jdev["shard_start"],
        jdev["shard_size"], jdev["overflow"], jlayout, positions=positions,
        seed_len=20, genome_size=lifted.genome_size, max_hits=300,
        read_len=L, cpr=512)
    for k in ("loc", "seed_off", "is_rc", "live", "total"):
        same(got[k], want[k], k)
    grows = tfilter.BatchCharacterizer(lifted, state).characterize(reads)
    wrows = jfilter.BatchCharacterizer(
        jax_twin(lifted), jdev, lifted.genome_size,
        cuckoo=jlayout).characterize(reads)
    dropped = 0
    for i in range(B_READS):
        g, w = grows(i), wrows(i)
        assert [list(m.items()) for m in g] == [list(m.items()) for m in w]
        host = tfilter.characterize_seeds(lifted, reads[i])
        past = sum(loc >= 1 << 31 for m in host for loc in m)
        assert sum(len(m) for m in g) == sum(len(m) for m in host) - past
        dropped += past
    assert dropped > 0


@pytest.mark.parametrize("use_cuckoo", [True, False])
def test_partition_index_on_lifted_index(world, use_cuckoo):
    """partition_index of the index lifted to B, in both lookup branches:
    array for array the JAX function's (the overflow pointers, past
    2^31, rebased to each slice)."""
    idx = world["idx"]
    lifted = lift_index(idx, OFFSET_B, words=False)
    jlifted = jax_twin(lifted)
    for n in (1, 2, 3):
        want = jsh.partition_index(jlifted, n, use_cuckoo)
        got = tsh.partition_index(lifted, n, use_cuckoo)
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=f"{k} n={n}")
    # the slices' locations and overflow pointers are all past 2^31
    v1 = got["ht_entries"][..., 1]
    v1 = v1[(v1 != INVALID_GENOME_LOCATION) & (v1 != UNUSED_HASH_VALUE)]
    assert v1.size and (v1 >= OFFSET_B).all()


# ---------------------------------------------------------------- host routes

def _body(path):
    return [l for l in open(path, "rb").read().splitlines()
            if not l.startswith(b"@PG")]


def _records(path):
    return [l for l in open(path, "rb").read().splitlines()
            if not l.startswith(b"@")]


@pytest.fixture(scope="module")
def unlifted_sams(world):
    d, idx, out = world["dir"], world["idx"], {}
    for name, so in (("plain", False), ("sorted", True)):
        p = str(d / f"unlifted_{name}.sam")
        PairedEndPipeline(idx, options=PairedPipelineOptions(
            batch_size=B_READS, sorted_output=so), device="cpu").run(
                *world["fq"], p)
        out[name] = _body(p)
    p = str(d / "unlifted_single.sam")
    SingleEndPipeline(idx, options=PipelineOptions(batch_size=B_READS),
                      device="cpu").run(world["fq"][0], p)
    out["single"] = _records(p)
    return out


def test_bulk_route_sam_on_lifted_genome(world, lifted, unlifted_sams):
    """Paired FASTQ to SAM through io/bulk.py, plain and sorted (-so), on
    the lifted genome: the unlifted run's SAM byte for byte (positions
    are piece-relative; the sort keys are u32 locations)."""
    d = world["dir"]
    aligner = PairedAligner(lifted["idx"], device="cpu")
    for name, so in (("plain", False), ("sorted", True)):
        p = str(d / f"lifted_{lifted['name']}_{name}.sam")
        PairedEndPipeline(lifted["idx"], options=PairedPipelineOptions(
            batch_size=B_READS, sorted_output=so), aligner=aligner).run(
                *world["fq"], p)
        assert _body(p) == unlifted_sams[name], name


class _Replay:
    """An aligner that hands a pipeline recorded engine outputs, batch by
    batch (the same FASTQ and batch size give the same batches)."""

    def __init__(self, cfg, outputs):
        self.cfg, self.outputs = cfg, list(outputs)

    def align_batch_device(self, *_):
        return self.outputs.pop(0)


def test_per_read_route_fault_shared(world, lifted, unlifted_sams):
    """The per-read route reads engine locations as int32.  DNA `single`
    on the lifted genome, in the port with its engine and in the JAX
    package on the port engine's outputs (held to the JAX engine's
    above): the same SAM in both, unlike the unlifted run's in exactly
    the records placed past 2^31 (POS below 0, CIGAR `*`)."""
    d, base = world["dir"], lifted["base"]
    aligner = ts.SingleAligner(lifted["idx"], device="cpu")
    outs, real = [], aligner.align_batch_device

    def spy(*a):
        out = real(*a)
        outs.append(ts.fetch(out))
        return out
    aligner.align_batch_device = spy
    p = str(d / f"single_{lifted['name']}_port.sam")
    SingleEndPipeline(lifted["idx"], options=PipelineOptions(
        batch_size=B_READS), aligner=aligner).run(world["fq"][0], p)
    got = _records(p)
    q = str(d / f"single_{lifted['name']}_jax.sam")
    JSingleEndPipeline(
        jax_twin(lifted["idx"]), options=JOptions(batch_size=B_READS),
        aligner=_Replay(aligner.cfg, outs)).run(world["fq"][0], q)
    assert _records(q) == got
    ref = unlifted_sams["single"]
    res = np.concatenate([o["result"] for o in outs])
    loc = np.concatenate([as_u32(o["loc"]) for o in outs])
    past = (res != 0) & (loc >= 1 << 31)
    unlike = [i for i, (a, b) in enumerate(zip(got, ref)) if a != b]
    assert len(got) == len(ref) == B_READS
    assert unlike == list(np.flatnonzero(past)) and past.any()
    for i in unlike:
        f = got[i].split(b"\t")
        assert int(f[3]) < 0 and f[5] == b"*"


@pytest.mark.parametrize("form", ["sam", "bam"])
def test_record_builders_fault_shared(world, form):
    """SamRecordBuilder and BamRecordBuilder of both packages on the
    genome lifted to B, fed a read placed at 2,200,001,234: as a u32
    value both write the unlifted record; as the int32 the pipelines pass
    (-2,094,966,062) both write a POS below -2^31 (the location less the
    first piece's start: Genome.piece_index_at clips it to piece 0) and
    CIGAR `*` (SAM), or both raise struct.error (BAM's int32 POS)."""
    import struct
    idx = world["idx"]
    lifted = lift_index(idx, OFFSET_B, words=False)
    g, jg = lifted.genome, jax_twin(lifted).genome
    seq = decode_bases(np.asarray(idx.genome.codes[1234:1234 + L]))
    loc_u = OFFSET_B + 1234
    loc_i = int(np.uint32(loc_u).view(np.int32))
    assert loc_i == -2_094_966_062

    def write(builder_cls, read_cls, genome, loc, **kw):
        b = builder_cls(genome, **kw)
        b.add(read_cls(b"r", seq, b"I" * L), 1, loc, 0, 60, score=0)
        sink = _Sink()
        b.flush(sink)
        return sink.data
    port_cls, jax_cls = ((SamRecordBuilder, JSamRecordBuilder)
                         if form == "sam" else
                         (BamRecordBuilder, JBamRecordBuilder))
    right = write(port_cls, Read, g, loc_u, device="cpu")
    assert right == write(jax_cls, JRead, jg, loc_u)
    unlifted = write(port_cls, Read, idx.genome, loc_u - OFFSET_B,
                     device="cpu")
    assert right == unlifted
    if form == "sam":
        wrong = write(port_cls, Read, g, loc_i, device="cpu")
        assert wrong == write(jax_cls, JRead, jg, loc_i)
        f = wrong.split(b"\t")
        pos = loc_i - int(g.piece_offsets[0]) + 1        # piece 0, clipped
        assert (int(f[3]), f[5]) == (pos, b"*") and pos < -(1 << 31)
    else:
        for cls, rcls, gen, kw in ((port_cls, Read, g, dict(device="cpu")),
                                   (jax_cls, JRead, jg, {})):
            with pytest.raises(struct.error):
                write(cls, rcls, gen, loc_i, **kw)


class _Sink:
    def __init__(self):
        self.data = b""

    def write(self, blob):
        self.data += blob
