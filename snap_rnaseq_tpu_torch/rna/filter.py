"""Genome/transcriptome alignment reconciliation (the RNA-seq core).

Analog of reference SNAPLib/AlignmentFilter.{h,cpp}.  Per read (single) or
read pair (paired):

* add_alignment() (AlignmentFilter.cpp:140-214): converts transcriptome hits
  to genome coordinates via GTFTranscript::GenomicPosition, dedups into a
  per-end map keyed (rname, pos) keeping the better score, transcriptome
  preferred on ties;
* filter_single() (cpp:216-300): best alignment wins; demoted to
  MultipleHits (mapq 1) unless it beats the runner-up by conf_diff;
* filter_paired() (cpp:302-739): cross-product of the two ends' candidate
  sets, classified no-RC / intragene / intrachromosomal / interchromosomal
  (gene-boundary checks via the GTF), picked in that priority order
  (intragene first), with CheckNoRC / FindPartialMatches guards and fusion
  evidence recorded into the GTFReader's interval maps;
* unaligned_read() (cpp:742-938): mines an unaligned read's seed maps
  (characterize_seeds) for split-segment pairs -> novel splice evidence.

Scores/locations come from the batched device engine; this layer is
host-side control logic over per-read candidate sets (a few entries each),
exactly the split SURVEY.md §7 prescribes.

Port of snap_rnaseq_tpu/rna/filter.py: the host logic is the same; the
batched characterizer (characterize_batch, BatchCharacterizer) is torch
code on the genome aligner's device, over the genome aligner's seed
phase (models/single.py seed_phase: the cuckoo layout, in K7 on a card,
or the probe chain under SNAP_TPU_LOOKUP=probe).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import INVALID_GENOME_LOCATION
from ..index.genome import Genome
from ..index.hash_index import GenomeIndex
from ..index.seeds import pack_seeds_at
from ..utils.seed_sequencer import seed_position_schedule

NOT_FOUND, SINGLE_HIT, MULTIPLE_HITS = 0, 1, 2
MAX_MAPQ = 70

# pair-class flag bits (GTFReader.h:38-47)
FIRST_NOT_ALIGNED = 0
SECOND_NOT_ALIGNED = 1
NOT_REVERSE_COMPLIMENTED = 2
ALIGNED_SAME_GENE = 3
ALIGNED_SAME_CHR = 4
ALIGNED_DIFF_CHR = 5
UNANNOTATED = 6
CIRCULAR = 7


@dataclass
class Alignment:
    location: int            # flat location in source genome (g or t)
    direction: int
    score: int
    mapq: int
    rname: str               # genome chromosome name
    pos: int                 # 1-based genome position
    pos_end: int
    pos_original: int        # 1-based position within source piece
    transcript_id: str
    gene_id: str
    is_transcriptome: bool


@dataclass
class EndResult:
    status: int = NOT_FOUND
    location: int = 0
    direction: int = 0
    score: int = 0
    mapq: int = 0
    is_transcriptome: bool = False
    tlocation: int = 0


@dataclass
class PairResult:
    ends: tuple = (None, None)
    aligned_as_pair: bool = False
    flags: tuple = (0, 0)

    def __post_init__(self):
        if self.ends == (None, None):
            self.ends = (EndResult(), EndResult())


class AlignmentFilter:
    """One instance per read pair (or single read at index 0)."""

    def __init__(self, genome: Genome, transcriptome: Genome | None, gtf,
                 min_spacing: int, max_spacing: int, conf_diff: int,
                 max_dist: int, seed_len: int, read_lens=(0, 0),
                 read_ids=(b"", b""), characterizer=None):
        self.genome = genome
        self.transcriptome = transcriptome
        self.gtf = gtf
        self.min_spacing = min_spacing
        self.max_spacing = max_spacing
        self.conf_diff = conf_diff
        self.max_dist = max_dist
        self.seed_len = seed_len
        self.read_lens = read_lens
        self.read_ids = read_ids
        self.characterizer = characterizer
        self.maps: tuple[dict, dict] = ({}, {})
        self.genome_mapq = MAX_MAPQ

    # ------------------------------------------------------------------

    def add_alignment(self, location, direction, score, mapq,
                      is_transcriptome: bool, end: int):
        """AddAlignment (AlignmentFilter.cpp:140-214); end is the read index
        (0 or 1) the alignment belongs to."""
        if score > self.max_dist or score < 0:
            return
        if location in (None, -1) or location == INVALID_GENOME_LOCATION:
            return
        location = int(location)
        read_len = self.read_lens[end]
        transcript_id = gene_id = ""
        if not is_transcriptome:
            rname, off = self.genome.piece_at(location)
            pos_original = off + 1
            pos = pos_original
            pos_end = pos + read_len - 1
        else:
            tname, toff = self.transcriptome.piece_at(location)
            pos_original = toff + 1
            try:
                transcript = self.gtf.get_transcript(tname)
            except KeyError:
                return
            transcript_id = transcript.transcript_id
            gene_id = transcript.gene_id
            rname = transcript.chr
            pos_end = transcript.genomic_position(pos_original + read_len - 1, 0)
            pos = transcript.genomic_position(pos_original, read_len)
        if pos == 0:
            return
        aln = Alignment(location=location, direction=int(direction),
                        score=int(score), mapq=int(mapq), rname=rname,
                        pos=pos, pos_end=pos_end, pos_original=pos_original,
                        transcript_id=transcript_id, gene_id=gene_id,
                        is_transcriptome=is_transcriptome)
        self.add_prepared(aln, end)

    def add_prepared(self, aln: Alignment, end: int) -> None:
        """Dedup fold of AddAlignment for a pre-converted Alignment (the
        batch path precomputes coordinates via rna/t2g.py and skips the
        per-hit walks); keeps the better score, transcriptome preferred on
        ties — insertion-order semantics identical to add_alignment."""
        key = (aln.rname, aln.pos)
        cur = self.maps[end].get(key)
        if cur is None or aln.score < cur.score or \
                (aln.score == cur.score and aln.is_transcriptome):
            self.maps[end][key] = aln

    # ------------------------------------------------------------------

    def _resolve(self, aln: Alignment) -> tuple[int, int]:
        """(genome flat location, tlocation) for an output alignment
        (the transcriptome branch of FilterSingle/ProcessPairs)."""
        if aln.is_transcriptome:
            tloc = aln.location
            loc = self.genome.offset_of_piece(aln.rname) + aln.pos - 1
            return loc, tloc
        return aln.location, 0

    def filter_single(self) -> EndResult:
        res = EndResult()
        alns = [a for a in self.maps[0].values() if a.score <= self.max_dist]
        if not alns:
            return res
        alns.sort(key=lambda a: a.score)
        best = alns[0]
        loc, tloc = self._resolve(best)
        res.location, res.tlocation = loc, tloc
        res.direction = best.direction
        res.score = best.score
        res.is_transcriptome = best.is_transcriptome
        if len(alns) == 1 or alns[1].score - best.score >= self.conf_diff:
            res.status = SINGLE_HIT
            res.mapq = min(MAX_MAPQ, self.genome_mapq)
            if best.is_transcriptome:
                self.gtf.increment_read_count_single(best.transcript_id)
        else:
            res.status = MULTIPLE_HITS
            res.mapq = 1
        return res

    # ------------------------------------------------------------------

    def filter_paired(self) -> PairResult:
        """Filter (AlignmentFilter.cpp:302-739).  maps[0] holds read0's
        candidates, maps[1] read1's; pair = (align0 from read0, align1 from
        read1), result end 0 <-> read0."""
        gtf = self.gtf
        no_rc, intragene, intrachrom, interchrom = [], [], [], []

        m0s, m1s = self.maps[0], self.maps[1]
        if not m0s and not m1s:
            pass
        elif not m0s:
            self._unaligned_evidence(0)
        elif not m1s:
            self._unaligned_evidence(1)

        for a0 in m0s.values():
            for a1 in m1s.values():
                distance = 0
                if a0.direction and not a1.direction:
                    distance = a0.pos - a1.pos
                elif not a0.direction and a1.direction:
                    distance = a1.pos - a0.pos
                is_backspliced = distance < -100
                if a0.direction == a1.direction:
                    no_rc.append((a0, a1, 1 << NOT_REVERSE_COMPLIMENTED,
                                  False, is_backspliced, distance))
                    continue
                both_t = a0.is_transcriptome and a1.is_transcriptome
                unk = not (a0.is_transcriptome or a1.is_transcriptome)
                if unk:
                    # neither end is transcriptome: treated as intragene
                    # (reference's "can't be sure" branch, cpp:463-466)
                    intragene.append((a0, a1, 0, True, is_backspliced, distance))
                    continue
                if a0.rname != a1.rname:
                    interchrom.append((a0, a1, 1 << ALIGNED_DIFF_CHR,
                                       not both_t, is_backspliced, distance))
                    continue
                same_gene = False
                if a0.is_transcriptome and \
                        gtf.get_gene(a0.gene_id).check_boundary(a1.rname, a1.pos):
                    same_gene = True
                elif a1.is_transcriptome and \
                        gtf.get_gene(a1.gene_id).check_boundary(a0.rname, a0.pos):
                    same_gene = True
                if same_gene:
                    intragene.append((a0, a1, 1 << ALIGNED_SAME_GENE,
                                      not both_t, is_backspliced, distance))
                else:
                    intrachrom.append((a0, a1, 1 << ALIGNED_SAME_CHR,
                                       not both_t, is_backspliced, distance))

        result = PairResult()
        rid = self.read_ids[0].decode() if self.read_ids[0] else ""

        if intragene:
            self._process_pairs(result, intragene)
            if result.ends[0].status == SINGLE_HIT:
                a0, a1 = intragene[0][0], intragene[0][1]
                if a0.is_transcriptome and a1.is_transcriptome:
                    gtf.increment_read_count_paired(
                        a0.transcript_id, a0.pos_original, a0.pos,
                        self.read_lens[0],
                        a1.transcript_id, a1.pos_original, a1.pos,
                        self.read_lens[1])
            result.aligned_as_pair = True
            return result

        if intrachrom:
            self._process_pairs(result, intrachrom)
            if result.ends[0].status == SINGLE_HIT:
                self._check_no_rc(result, no_rc)
            # the reference compares int distance <= unsigned maxSpacing,
            # so negative distances wrap to huge values and fail the test
            if (intrachrom[0][5] & 0xFFFFFFFF) <= self.max_spacing:
                return result
            if result.ends[0].status == SINGLE_HIT:
                self._find_partial_matches(result)
            if result.ends[0].status == SINGLE_HIT:
                a0, a1 = intrachrom[0][0], intrachrom[0][1]
                gtf.intrachromosomal_pairs.add_interval(
                    a0.rname, a0.pos, a0.pos_end,
                    a1.rname, a1.pos, a1.pos_end, rid, False)
            return result

        if interchrom:
            self._process_pairs(result, interchrom)
            if result.ends[0].status == SINGLE_HIT:
                self._check_no_rc(result, no_rc)
            if result.ends[0].status == SINGLE_HIT:
                self._find_partial_matches(result)
            if result.ends[0].status == SINGLE_HIT:
                a0, a1 = interchrom[0][0], interchrom[0][1]
                gtf.interchromosomal_pairs.add_interval(
                    a0.rname, a0.pos, a0.pos_end,
                    a1.rname, a1.pos, a1.pos_end, rid, False)
            return result

        if no_rc:
            self._process_pairs(result, no_rc)
            if result.ends[0].status == SINGLE_HIT:
                self._find_partial_matches(result)
            if result.ends[0].status == SINGLE_HIT:
                a0, a1 = no_rc[0][0], no_rc[0][1]
                target = gtf.intrachromosomal_pairs if a0.rname == a1.rname \
                    else gtf.interchromosomal_pairs
                target.add_interval(a0.rname, a0.pos, a0.pos_end,
                                    a1.rname, a1.pos, a1.pos_end, rid, False)
            return result

        return result

    # ------------------------------------------------------------------

    def _process_pairs(self, result: PairResult, pairs: list):
        """ProcessPairs (AlignmentFilter.cpp:1061-1179): sort by pair score,
        fill both ends, demote below conf_diff."""
        pairs.sort(key=lambda p: p[0].score + p[1].score)
        a0, a1 = pairs[0][0], pairs[0][1]
        if not a0.is_transcriptome and not a1.is_transcriptome:
            self.genome_mapq = a0.mapq
        for e, a in ((0, a0), (1, a1)):
            loc, tloc = self._resolve(a)
            end = result.ends[e]
            end.location, end.tlocation = loc, tloc
            end.direction = a.direction
            end.score = a.score
            end.is_transcriptome = a.is_transcriptome
        if len(pairs) == 1:
            status, mapq = SINGLE_HIT, min(MAX_MAPQ, self.genome_mapq)
        else:
            diff = (pairs[1][0].score + pairs[1][1].score) - \
                   (a0.score + a1.score)
            if diff >= self.conf_diff:
                status, mapq = SINGLE_HIT, min(MAX_MAPQ, self.genome_mapq)
            else:
                status, mapq = MULTIPLE_HITS, 1
        for e in (0, 1):
            result.ends[e].status = status
            result.ends[e].mapq = mapq

    def _check_no_rc(self, result: PairResult, no_rc: list):
        """CheckNoRC (cpp:1039-1059)."""
        cur = result.ends[0].score + result.ends[1].score
        for a0, a1, *_ in no_rc:
            if a0.rname == a1.rname and a0.score + a1.score < cur:
                for e in (0, 1):
                    result.ends[e].status = MULTIPLE_HITS
                    result.ends[e].mapq = 1
                return

    def _find_partial_matches(self, result: PairResult):
        """FindPartialMatches (cpp:957-1037): if both reads have partial seed
        matches within max_spacing on one chromosome, demote the pair."""
        if self.characterizer is None:
            return
        locs = []
        for e in (0, 1):
            fwd_map, rc_map = self.characterizer(e)
            ls = []
            L = self.read_lens[e]
            for loc, offs in fwd_map.items():
                ls.append(loc + min(offs))
            for loc, offs in rc_map.items():
                ls.append(loc + L - max(offs))
            locs.append(ls)
        for l0 in locs[0]:
            c0, p0 = self.genome.piece_at(l0)
            for l1 in locs[1]:
                c1, p1 = self.genome.piece_at(l1)
                if c0 != c1:
                    continue
                if abs(p1 - p0) < self.max_spacing:
                    for e in (0, 1):
                        result.ends[e].status = MULTIPLE_HITS
                        result.ends[e].mapq = 1
                    return

    # ------------------------------------------------------------------

    def _unaligned_evidence(self, end: int):
        """UnalignedRead (cpp:742-938): split-segment splice evidence from
        the unaligned mate's seed maps."""
        if self.characterizer is None:
            return
        fwd_map, rc_map = self.characterizer(end)
        L = self.read_lens[end]
        rid = self.read_ids[end].decode() if self.read_ids[end] else ""
        segs = []
        for loc, offs in fwd_map.items():
            length = max(offs) - min(offs) + self.seed_len
            chrom, p = self.genome.piece_at(loc)
            start = p + 1 + min(offs)
            segs.append((chrom, start, start + length - 1, length))
        for loc, offs in rc_map.items():
            length = max(offs) - min(offs) + self.seed_len
            chrom, p = self.genome.piece_at(loc)
            start = p + 1 + L - (max(offs) + self.seed_len)
            segs.append((chrom, start, start + length - 1, length))

        intrachrom, interchrom = [], []
        for i in range(len(segs)):
            for j in range(i + 1, len(segs)):
                c0, s0, e0, len0 = segs[i]
                c1, s1, e1, len1 = segs[j]
                if len0 + len1 < L - self.seed_len:
                    continue
                if not (s0 > e1 or s1 > e0):
                    continue  # overlapping segments
                if c0 != c1:
                    interchrom.append((segs[i], segs[j]))
                else:
                    # intragene splices are dropped by the reference
                    genes = self.gtf.interval_genes(c0, s0, e0)
                    if any(g.check_boundary(c1, s1) for g in genes):
                        continue
                    intrachrom.append((segs[i], segs[j]))
        if intrachrom:
            for (c0, s0, e0, _), (c1, s1, e1, _) in intrachrom:
                self.gtf.intrachromosomal_splices.add_interval(
                    c0, s0, e0, c1, s1, e1, rid, True)
        elif interchrom:
            for (c0, s0, e0, _), (c1, s1, e1, _) in interchrom:
                self.gtf.interchromosomal_splices.add_interval(
                    c0, s0, e0, c1, s1, e1, rid, True)


def characterize_seeds(index: GenomeIndex, codes: np.ndarray,
                       max_seeds: int = 12, max_hits: int = 300):
    """Host analog of BaseAligner::CharacterizeSeeds (BaseAligner.cpp:207-508):
    seed the read on the index and return (fwd_map, rc_map) of
    candidate-location -> set of read seed offsets.

    codes: (L,) uint8 base codes of the (clipped) read.
    """
    seed_len = index.seed_len
    L = int(codes.shape[0])
    positions, _ = seed_position_schedule(L, seed_len)
    positions = positions[:max_seeds]
    if len(positions) == 0:
        return {}, {}
    fwd, rc, valid = pack_seeds_at(codes, positions, seed_len)
    fwd_map: dict[int, set] = {}
    rc_map: dict[int, set] = {}
    for p, f, r, v in zip(positions, fwd, rc, valid):
        if not v:
            continue
        hits, rc_hits = index.lookup_seed(int(f), int(r))
        p = int(p)
        if 0 < len(hits) <= max_hits:
            for h in hits[:max_hits]:
                loc = int(h) - p
                if loc >= 0:
                    fwd_map.setdefault(loc, set()).add(p)
        if 0 < len(rc_hits) <= max_hits:
            off = L - seed_len - p
            for h in rc_hits[:max_hits]:
                loc = int(h) - off
                if loc >= 0:
                    rc_map.setdefault(loc, set()).add(p)
    return fwd_map, rc_map




# ----------------------------------------------------------------------
# device-side batched CharacterizeSeeds
# ----------------------------------------------------------------------

def characterize_batch(reads: torch.Tensor, state: dict, *, positions,
                       seed_len: int, max_hits: int, read_len: int,
                       cpr: int) -> dict:
    """Every read's per-seed hit locations in one pass over the batch.

    reads: (B, L) uint8 codes on the index state's device; state: the
    aligner's index tensors (models/single.py index_state_from_numpy:
    overflow, the cuckoo layout or the probe-chain table, genome_size).  Seeds whose hit count is
    in (0, max_hits] are expanded into at most `cpr` slots per read, the
    forward groups first; loc is the hit minus the seed's read offset in
    int32 (it wraps for genomes past 2^31 exactly as the int32 arithmetic
    of the JAX package's characterizer does)."""
    from ..models.single import row_select, seed_phase
    from ..ops import lookup as lk
    dev = reads.device
    i32 = torch.int32
    overflow = state["overflow"]
    pos_t = torch.tensor(positions, dtype=i32, device=dev)
    seeds = seed_phase(reads, positions, seed_len, overflow,
                       state["genome_size"], state, schedule_t=pos_t)
    found = seeds["found"] & seeds["valid"]
    cf, cr = seeds["counts"].unbind(2)
    bf, br = seeds["bases"].unbind(2)
    fv, rv = seeds["vals"].unbind(2)
    okf = found & (cf > 0) & (cf <= max_hits)
    okr = found & (cr > 0) & (cr <= max_hits)
    used2 = torch.cat([torch.where(okf, cf, 0),
                       torch.where(okr, cr, 0)], dim=1)           # (B, 2S)
    B, S2 = used2.shape
    S = S2 // 2
    cum = torch.cumsum(used2, dim=1, dtype=i32)
    total = cum[:, -1]
    slots = torch.arange(cpr, dtype=i32, device=dev)
    # #{j: cum[j] <= slot}: cum is non-decreasing, so a right searchsorted
    group = torch.searchsorted(cum, slots.expand(B, cpr).contiguous(),
                               right=True).to(i32).clamp_max(S2 - 1)
    live = slots[None, :] < total.clamp_max(cpr)[:, None]
    prev = torch.cat([torch.zeros((B, 1), dtype=i32, device=dev),
                      cum[:, :-1]], dim=1)
    within = slots[None, :] - row_select(prev, group)
    g_base = row_select(torch.cat([bf, br], dim=1), group)
    g_val = row_select(torch.cat([fv, rv], dim=1), group)
    hit = lk.gather_hit(within, None, g_base, g_val, overflow)
    s_idx = torch.where(group < S, group, group - S)
    is_rc = group >= S
    pos_arr = pos_t[s_idx.long()]
    adj = torch.where(is_rc, read_len - seed_len - pos_arr, pos_arr)
    return dict(loc=hit - adj, seed_off=pos_arr, is_rc=is_rc, live=live,
                total=total)


class BatchCharacterizer:
    """Device analog of BaseAligner::CharacterizeSeeds over a whole batch.

    One pass computes every read's per-seed hit locations on the index
    state's device (the host fallback `characterize_seeds` walks each
    read's seeds in Python); rows whose hit total overflows the slot
    budget fall back to the host walk, so the maps are always exact.  Seeds
    are looked up in whichever table the genome aligner's state holds (the
    cuckoo layout, or the probe chain under SNAP_TPU_LOOKUP=probe), as the
    JAX package's characterizer follows its genome aligner
    (rna/pipeline.py)."""

    def __init__(self, index: GenomeIndex, state: dict, max_seeds: int = 12,
                 max_hits: int = 300, slots: int = 512):
        self.index = index
        self.state = state
        self.device = state["overflow"].device
        self.max_seeds = max_seeds
        self.max_hits = max_hits
        self.slots = slots

    def characterize(self, codes: np.ndarray):
        """codes: (B, L) uint8 batch -> per-read lazy (fwd_map, rc_map).

        The device pass is queued here; its results are copied to the host
        at the first row asked for (on the pipeline's writer thread), so
        the dispatching thread does not wait on the device."""
        from ..models.single import fetch
        B, L = codes.shape
        positions, _ = seed_position_schedule(L, self.index.seed_len)
        positions = tuple(int(p) for p in positions[:self.max_seeds])
        if not positions:
            return lambda i: ({}, {})
        dev_out = characterize_batch(
            torch.from_numpy(np.ascontiguousarray(codes)).to(self.device),
            self.state, positions=positions, seed_len=self.index.seed_len,
            max_hits=self.max_hits, read_len=L, cpr=self.slots)
        cache: dict = {}

        def row(i: int):
            got = cache.get(i)
            if got is not None:
                return got
            res = cache.get("res")
            if res is None:
                res = cache["res"] = fetch(dev_out)
            if int(res["total"][i]) > self.slots:
                got = characterize_seeds(self.index, codes[i],
                                         self.max_seeds, self.max_hits)
            else:
                fwd_map: dict[int, set] = {}
                rc_map: dict[int, set] = {}
                live = res["live"][i]
                locs = res["loc"][i]
                offs = res["seed_off"][i]
                rcs = res["is_rc"][i]
                for j in np.nonzero(live)[0]:
                    loc = int(locs[j])
                    if loc < 0:
                        continue
                    m = rc_map if rcs[j] else fwd_map
                    m.setdefault(loc, set()).add(int(offs[j]))
                got = (fwd_map, rc_map)
            cache[i] = got
            return got
        return row
