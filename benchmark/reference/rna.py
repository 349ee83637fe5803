"""Reference "rna": SNAP-RNA's paired-end alignment, the genome's and the
transcriptome's reconciled by its AlignmentFilter, written from the
algorithm on the plain DNA reference (aligner.py), with nothing of the
port.

For each pair, in this order:

1. the genome pair: `Reference` at the configuration's `cand_per_read`;
2. each end against the extra input "transcriptome"'s codes
   (gen/extras/transcriptome.py): a single-end `Reference` at
   `t_cand_per_read` candidate slots, whose multi-hits follow
   fillHitsFound (BaseAligner.cpp:940-975): the in-play candidates,
   stable-sorted by score and then discovery order, those scoring under
   the best + 4 and at most e_max, the first `transcriptome_multi_hits`;
3. each transcriptome hit scoring at most max_dist taken to genome
   coordinates, none where the read overruns its transcript's last exon
   (AlignmentFilter.cpp:160-196);
4. per end, the candidates keyed by (chromosome, position), in the order
   first inserted (the transcriptome hits, then the genome result), each
   keeping the lower score, the transcriptome's on a tie;
5. Filter (cpp:302-739): the two ends' cross product classed as no-RC
   (both ends one direction), intragene (one end's gene, +-1,000 bases,
   holds the other; or neither end on the transcriptome),
   intrachromosomal or interchromosomal, taken in the order intragene,
   intrachromosomal, interchromosomal, no-RC; ProcessPairs (cpp:1061-1179)
   over the class by pair score with `conf_diff`, a genome-only best pair
   giving end 0's genome MAPQ; CheckNoRC (cpp:1039-1059); the
   intrachromosomal pair's distance held to max_spacing unsigned; and
   FindPartialMatches (cpp:957-1037) over CharacterizeSeeds (the first
   12 seed positions, seeds of 1-300 hits, found by scanning the genome);
6. the MAPQ halving of PairedAligner.cpp:653-663.

It returns the paired entry's keys: per end `result`, `loc` (a
transcriptome winner's as its chromosome's offset + position - 1;
0xFFFFFFFF unaligned), `dir`, `score`, `mapq`; `pair_found` 1 where the
pair was aligned as a pair (the intragene class) and `pair_score`, the two
ends' scores there and -1 elsewhere; and the genome pair's own results
of step 1 under the same keys with the prefix "g_".
`stats` keeps the last call's pair classes, multi-hits and unique
candidates per end, and the pairs that reached FindPartialMatches.

It reads the configuration's `index.seed_len`, `cand_per_read` and
`t_cand_per_read`, and the mix's `aligner` options, with
`transcriptome_multi_hits` and `conf_diff`.  It leaves out what the
comparison does not judge: splice, fusion and unaligned-read evidence,
the gene and transcript counts, the contamination index and
`force_spacing`.  `control` computes both references' probabilities in
bfloat16.

The file defines its comparison (benchmark/lookup.py `comparison`):
compare.py's numbers over the pairs' results, and the same again over
the genome pair's results that the filter starts from,

  mismatch_share         compare.py's, over the reconciled results
  genome_mismatch_share  compare.py's, over the genome pair's "g_" keys

since a reconciled MAPQ rests on match probabilities only where the
winning pair is the genome's alone (about the tenth of the fragments
that are genomic): the genome pair's MAPQs, one for every read, are
what show a change of their precision.
"""
from __future__ import annotations

import numpy as np

from . import compare
from .aligner import INVALID, Reference, ref_params, seed_hits, seed_keys, \
    seed_schedule

NOT_FOUND, SINGLE_HIT, MULTIPLE_HITS = 0, 1, 2
MAX_MAPQ = 70
GENE_BUFFER = 1000
CHAR_SEEDS, CHAR_MAX_HITS = 12, 300
NONE, INTRAGENE, INTRACHROM, INTERCHROM, NO_RC = range(5)
PREFIX = "g_"                  # the genome pair's results


class MultiHitReference(Reference):
    """The single-end reference that also returns each read's multi-hits
    (loc, dir, score), fillHitsFound's."""

    def __init__(self, *args, max_get: int, **kw):
        super().__init__(*args, **kw)
        self.max_get = max_get

    def single_result(self, e) -> dict:
        out = super().single_result(e)
        play = sorted((c for c in e.cols if c["in_play"]),
                      key=lambda c: (c["score"], c["first_order"]))
        lim = play[0]["score"] + 4 if play else 0
        out["mh"] = [(c["loc_adj"], c["dir"], c["score"]) for c in play
                     if c["score"] < lim and c["score"] <= self.p.e_max
                     ][:self.max_get]
        return out

    def hits(self, reads: np.ndarray, quals: np.ndarray) -> list:
        """Each read's multi-hits."""
        p = self.p
        keys = sorted({k for rows, _ in self._seed_table(reads)
                       for _, _, fk, rk in rows if fk >= 0
                       for k in (fk, rk)})
        keys = np.array(keys, np.int64)
        counts, starts, pos = seed_hits(self.g.codes, keys, p.seed_len,
                                        p.cand_per_read, self.device)
        ends = self._ends(reads, quals, dict(
            counts=counts, starts=starts, pos=pos,
            index={int(k): i for i, k in enumerate(keys)}))
        self.score_candidates(ends, reads.shape[1])
        return [self.single_result(e)["mh"] for e in ends]


class RnaReference:
    def __init__(self, genome, tr: dict, config: dict, traffic: dict,
                 device, control: bool = False):
        a = traffic["aligner"]
        dtype = "bfloat16" if control else "float32"
        self.genome, self.tr, self.device = genome, tr, device
        self.g_ref = Reference(genome.codes, genome.piece_offsets,
                               ref_params(config, traffic), device,
                               prob_dtype=dtype)
        t_params = ref_params(
            dict(config, cand_per_read=int(config["t_cand_per_read"])),
            dict(traffic, mode="single"))
        self.t_ref = MultiHitReference(
            tr["codes"], tr["offsets"], t_params, device, prob_dtype=dtype,
            max_get=int(a["transcriptome_multi_hits"]))
        self.max_k = int(a["max_dist"])
        self.max_spacing = int(a["max_spacing"])
        self.conf_diff = int(a["conf_diff"])
        self.seed_len = int(config["index"]["seed_len"])
        self.stats = {}

    # ------------------------------------------------------------ step 3-4

    def _candidates(self, mh: list, g: dict, e: int, b: int, L: int):
        """One end's candidates after the dedup, as arrays: dir, score,
        mapq, chrom, pos, is_t, gene, loc (the output location)."""
        tr, offs = self.tr, self.genome.piece_offsets
        n_t = tr["codes"].shape[0]
        keyed, rows = {}, []

        def add(row):
            k = (row[3], row[4])
            i = keyed.get(k)
            if i is None:
                keyed[k] = len(rows)
                rows.append(row)
            elif row[1] < rows[i][1] or (row[1] == rows[i][1] and row[5]):
                rows[i] = row
        for loc, d, s in mh:
            if not 0 <= s <= self.max_k or not 0 <= loc < n_t:
                continue
            gp = int(tr["pos"][loc])
            if tr["transcript"][loc] < 0 or gp <= 0 or \
                    gp + L > tr["t_end"][loc]:
                continue
            c = int(tr["chrom"][loc])
            add((d, s, 0, c, gp, True, int(tr["gene"][loc]),
                 int(offs[c]) + gp - 1))
        loc, s = int(g[f"loc{e}"][b]), int(g[f"score{e}"][b])
        if loc != INVALID and loc < self.genome.codes.shape[0] and \
                0 <= s <= self.max_k:
            c = int(np.clip(np.searchsorted(offs, loc, side="right") - 1,
                            0, len(offs) - 1))
            add((int(g[f"dir{e}"][b]), s, int(g[f"mapq{e}"][b]), c,
                 loc - int(offs[c]) + 1, False, -1, loc))
        cols = list(zip(*rows)) if rows else [()] * 8
        return [np.asarray(x, np.int64) for x in cols]

    # ------------------------------------------------------------ step 5

    def _same_gene(self, gene, chrom, pos):
        tr = self.tr
        gs = np.maximum(gene, 0)
        lo = np.maximum(tr["gene_lo"][gs] - GENE_BUFFER + 1, 1)
        return ((gene >= 0) & (tr["gene_chrom"][gs] == chrom)
                & (pos >= lo) & (pos <= tr["gene_hi"][gs] + GENE_BUFFER))

    def _filter(self, c0, c1) -> dict:
        """Filter up to FindPartialMatches: the class, the winning pair,
        status and MAPQ, and whether FindPartialMatches is due."""
        d0, s0, q0, ch0, p0, t0, g0, _ = c0
        d1, s1, q1, ch1, p1, t1, g1, _ = c1
        out = dict(cls=NONE, status=NOT_FOUND, fpm=False)
        if not d0.size or not d1.size:
            return out
        no_rc = d0[:, None] == d1[None, :]
        unk = ~t0[:, None].astype(bool) & ~t1[None, :].astype(bool)
        same_chr = ch0[:, None] == ch1[None, :]
        gene = ((t0.astype(bool)[:, None]
                 & self._same_gene(g0[:, None], ch1[None, :], p1[None, :]))
                | (t1.astype(bool)[None, :]
                   & self._same_gene(g1[None, :], ch0[:, None], p0[:, None])))
        rest = ~no_rc & ~unk
        classes = ((INTRAGENE, ~no_rc & (unk | (same_chr & gene))),
                   (INTRACHROM, rest & same_chr & ~gene),
                   (INTERCHROM, rest & ~same_chr), (NO_RC, no_rc))
        ps = (s0[:, None] + s1[None, :]).ravel()
        cls, idx = next(((c, np.nonzero(m.ravel())[0]) for c, m in classes
                         if m.any()), (NONE, None))
        if cls == NONE:
            return out
        order = idx[np.argsort(ps[idx], kind="stable")]
        i, j = divmod(int(order[0]), d1.size)
        gm = int(q0[i]) if not t0[i] and not t1[j] else MAX_MAPQ
        if order.size == 1 or ps[order[1]] - ps[order[0]] >= self.conf_diff:
            status, mapq = SINGLE_HIT, min(MAX_MAPQ, gm)
        else:
            status, mapq = MULTIPLE_HITS, 1
        out.update(cls=cls, status=status, mapq=mapq, w=(i, j))
        if cls == INTRAGENE:
            return out
        if cls in (INTRACHROM, INTERCHROM) and status == SINGLE_HIT:
            # CheckNoRC
            if (no_rc & same_chr).ravel()[ps < ps[order[0]]].any():
                out.update(status=MULTIPLE_HITS, mapq=1)
        if cls == INTRACHROM:
            dist = (p0[i] - p1[j] if d0[i] and not d1[j] else
                    p1[j] - p0[i] if not d0[i] and d1[j] else 0)
            if (int(dist) & 0xFFFFFFFF) <= self.max_spacing:
                return out
        out["fpm"] = out["status"] == SINGLE_HIT
        return out

    def _partial_values(self, reads: np.ndarray, hits) -> list:
        """FindPartialMatches' locations of each read: CharacterizeSeeds'
        forward map's location + its least seed offset, the reverse
        map's location + read length - its largest."""
        counts, starts, pos, index = hits
        B, L = reads.shape
        sl = self.seed_len
        positions = seed_schedule(L, sl)[0][:CHAR_SEEDS]
        fks, rks = seed_keys(reads, positions, sl)
        out = []
        for b in range(B):
            fwd, rc = {}, {}
            for p, fk, rk in zip(positions, fks[b], rks[b]):
                if fk < 0:
                    continue
                for key, m, adj in ((fk, fwd, p), (rk, rc, L - sl - p)):
                    k = index[int(key)]
                    if 0 < counts[k] <= CHAR_MAX_HITS:
                        for h in pos[starts[k]:starts[k + 1]]:
                            if h - adj >= 0:
                                m.setdefault(int(h - adj), []).append(p)
            out.append(np.array([loc + min(o) for loc, o in fwd.items()]
                                + [loc + L - max(o) for loc, o in rc.items()],
                                np.int64))
        return out

    def _partial_match(self, v0: np.ndarray, v1: np.ndarray) -> bool:
        """Any two locations, one of each read, on one chromosome less than
        max_spacing apart."""
        if not v0.size or not v1.size:
            return False
        offs = self.genome.piece_offsets
        key = [np.clip(np.searchsorted(offs, v, side="right") - 1, 0,
                       len(offs) - 1) * (1 << 40) + v for v in (v0, v1)]
        k1 = np.sort(key[1])
        ms = self.max_spacing - 1
        lo = np.searchsorted(k1, key[0] - ms, side="left")
        hi = np.searchsorted(k1, key[0] + ms, side="right")
        return bool((hi > lo).any())

    # ------------------------------------------------------------ align

    def align(self, reads: list, quals: list) -> dict:
        B, L = reads[0].shape
        g = self.g_ref.align(reads, quals)
        mh = [self.t_ref.hits(reads[e], quals[e]) for e in (0, 1)]
        cands = [[self._candidates(mh[e][b], g, e, b, L) for e in (0, 1)]
                 for b in range(B)]
        res = [self._filter(*c) for c in cands]
        due = [b for b in range(B) if res[b]["fpm"]]
        if due:
            both = np.concatenate([reads[0][due], reads[1][due]])
            vals = self._partial_values(both, self._char_hits(both))
            for k, b in enumerate(due):
                if self._partial_match(vals[k], vals[k + len(due)]):
                    res[b].update(status=MULTIPLE_HITS, mapq=1)
        out = {k: np.zeros(B, np.int64) for k in (
            "pair_found", "pair_score", "result0", "loc0", "dir0", "score0",
            "mapq0", "result1", "loc1", "dir1", "score1", "mapq1")}
        for b, r in enumerate(res):
            found = r["status"] != NOT_FOUND
            ends = []
            for e in (0, 1):
                if found:
                    c, w = cands[b][e], r["w"][e]
                    ends.append([r["status"], int(c[7][w]), int(c[0][w]),
                                 int(c[1][w]), r["mapq"]])
                else:
                    ends.append([NOT_FOUND, INVALID, 0, 0, 0])
            if ends[0][3] + ends[1][3] >= 5:
                for x in ends:
                    if x[4] < 50:
                        x[4] //= 2
            for e, x in enumerate(ends):
                for k, v in zip(("result", "loc", "dir", "score", "mapq"), x):
                    out[f"{k}{e}"][b] = v
            pf = r["cls"] == INTRAGENE
            out["pair_found"][b] = int(pf)
            out["pair_score"][b] = ends[0][3] + ends[1][3] if pf else -1
        out.update({PREFIX + k: v for k, v in g.items()})
        self.stats = dict(
            cls=np.array([r["cls"] for r in res]),
            multi_hits=np.array([[len(x) for x in mh[e]] for e in (0, 1)]),
            unique=np.array([[c[e][0].size for c in cands] for e in (0, 1)]),
            fpm=np.array([r["fpm"] for r in res], bool))
        return out

    def _char_hits(self, reads: np.ndarray):
        """Every genome hit of the reads' CharacterizeSeeds seeds with at
        most CHAR_MAX_HITS hits."""
        positions = seed_schedule(reads.shape[1], self.seed_len)[0][
            :CHAR_SEEDS]
        fks, rks = seed_keys(reads, positions, self.seed_len)
        keys = np.unique(np.concatenate([fks[fks >= 0], rks[rks >= 0]]))
        counts, starts, pos = seed_hits(self.genome.codes, keys,
                                        self.seed_len, CHAR_MAX_HITS,
                                        self.device)
        return counts, starts, pos, {int(k): i for i, k in enumerate(keys)}


def make(genome, extras: dict, config: dict, traffic: dict, device,
         control: bool = False) -> RnaReference:
    """Reference "rna": the reference for an RNA-seq configuration (extra
    input "transcriptome") and a paired mix; `control` computes its
    probabilities in bfloat16, the precision below the configurations'
    float32."""
    return RnaReference(genome, extras["transcriptome"], config, traffic,
                        device, control)


# ------------------------------------------------------------ comparison


def _genome(d: dict) -> dict:
    return {k[len(PREFIX):]: v for k, v in d.items() if k.startswith(PREFIX)}


def numbers(got: dict, want: dict, paired: bool) -> dict:
    return dict(compare.numbers(got, want, paired),
                genome_mismatch_share=compare.numbers(
                    _genome(got), _genome(want), paired)["mismatch_share"])


def fields(got: dict, want: dict, paired: bool) -> dict:
    return dict(compare.fields(got, want, paired), **{
        PREFIX + k: v for k, v in compare.fields(
            _genome(got), _genome(want), paired).items()})
