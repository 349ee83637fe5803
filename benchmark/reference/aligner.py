"""Plain reference of what the timed path computes: SNAP's single-end and
paired-end alignment as the configurations state it, written from the
algorithm, with no index, no kernel and nothing of the port.

It works out again, from the genome and the reads alone:

* seeds: the seed sequencer's positions (seed_schedule); each seed and its
  reverse complement found by scanning the genome (seed_hits), with every
  hit counted and each seed's hits in descending genome order, as the
  index's hit lists hold them;
* candidates: the seed budget (paired: the first `num_seeds` valid
  positions; single-end: positions until `num_seeds` (seed, direction)
  lookups apply), seeds over `max_hits` hits skipped as popular, and
  `cand_per_read` candidate slots filled rarest seed first;
* scoring (score_candidates): the whole read against the genome at each
  candidate: the substitution-only score where the anchored edit distance
  (dynamic programming) equals it, else Landau-Vishkin through the seed
  that found the candidate (lv.py); the score gate e_max = max_dist +
  extra_search_depth;
* selection and MAPQ (single_result): the best candidate by score, then
  probability, then discovery order; the probability mass of every
  48-base cluster within extra_search_depth of the best, with the early
  stop of the lowest-possible-score bound; computeMAPQ;
* pairs (pair_results): each end's mate rescue (the two spacing windows
  of the mate's two best candidates scanned for the best start, scored
  from there), the pair of opposite directions within the spacing window
  with the fewest edits, then the highest probability, its probability
  mass and each end's MAPQ; an end falls back to its single-end result
  when no pair is found.

Probabilities are float32, as the configurations state; `prob_dtype=
"bfloat16"` computes them in bfloat16 instead (the comparison's control).
Locations are uint32 values held in int64; an unaligned read has
0xFFFFFFFF.  Seeds whose hits lie in different index slices are filled
per slice when `slice_of` maps a canonical seed key to its index slice
(the mesh: reference/slices.py), and a read's dense pair-join set is its
first `cand_per_read` scored candidates in (direction, location) order.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import dp, lv

NEG_INF = np.float32(-1e30)
BIG = 0x7FFFFFF0
INVALID = 0xFFFFFFFF
M32 = 0xFFFFFFFF
MAX_MERGE_DIST = 48
MAPQ_LIMIT_FOR_SINGLE_HIT = 10
NOT_FOUND, SINGLE_HIT, MULTIPLE_HITS = 0, 1, 2
MAX_K = 31
F3E12 = np.float32(3e12)
LOG_ONE_MINUS_SNP = np.float32(lv.LOG_ONE_MINUS_SNP)
LOG_SNP = float(np.log(lv.SNP_PROB))

# SeedSequencer's wrap offsets: the start of wrap round w (w >= 1)
WRAP_OFFSETS = {
    16: [8, 4, 12, 2, 6, 10, 14, 1, 3, 5, 7, 9, 11, 13, 15],
    17: [8, 4, 12, 2, 6, 10, 14, 1, 3, 5, 7, 9, 11, 13, 15, 16],
    18: [9, 4, 13, 2, 6, 11, 15, 1, 3, 5, 7, 8, 10, 12, 14, 16, 17],
    19: [10, 4, 14, 2, 6, 8, 12, 16, 18, 1, 3, 5, 7, 9, 11, 13, 15, 17],
    20: [10, 5, 15, 2, 7, 12, 17, 3, 9, 11, 13, 19, 1, 4, 6, 8, 14, 18, 16],
    21: [11, 6, 16, 3, 9, 13, 17, 18, 2, 5, 8, 15, 20, 1, 4, 7, 10, 12, 14,
         19],
    22: [11, 6, 16, 3, 9, 14, 19, 2, 7, 12, 17, 20, 4, 1, 10, 13, 15, 18, 21,
         5, 8],
    23: [12, 6, 17, 3, 9, 20, 14, 1, 4, 7, 10, 15, 18, 21, 4, 2, 5, 11, 16,
         19, 22, 8],
    24: [12, 6, 18, 3, 15, 21, 9, 1, 13, 19, 7, 16, 4, 22, 10, 2, 14, 20, 5,
         17, 8, 23, 11],
    25: [13, 6, 19, 3, 16, 22, 9, 11, 1, 14, 7, 20, 4, 17, 23, 2, 15, 5, 21,
         8, 24, 10, 18, 12],
}


@dataclass(frozen=True)
class Params:
    seed_len: int
    max_k: int
    num_seeds: int
    max_hits: int
    extra: int
    cand_per_read: int
    max_seed_slots: int
    paired: bool
    min_spacing: int = 50
    max_spacing: int = 1000
    rescue_mates: int = 2

    @property
    def e_max(self) -> int:
        return min(MAX_K, self.max_k + self.extra)


def seed_schedule(read_len: int, seed_len: int):
    """(positions, wraps): the order the seed sequencer visits seed start
    positions, non-overlapping seeds first, then each wrap round from its
    offset, a used position sliding the next one forward."""
    n = read_len - seed_len + 1
    used = [False] * max(n, 0)
    pos_out, wrap_out = [], []
    pos = wrap = 0
    while n > 0:
        if pos >= n:
            wrap += 1
            if wrap >= seed_len:
                break
            pos = WRAP_OFFSETS[seed_len][wrap - 1]
            continue
        while pos < n and used[pos]:
            pos += 1
        if pos >= n:
            continue
        used[pos] = True
        pos_out.append(pos)
        wrap_out.append(wrap)
        pos += seed_len
    return pos_out, wrap_out


def seed_keys(reads: np.ndarray, positions, seed_len: int):
    """(fwd, rc) keys of each read's seeds at `positions`, (B, S) int64:
    2 bits a base, the first base highest; -1 for a seed with an N."""
    idx = np.asarray(positions)[:, None] + np.arange(seed_len)
    sd = reads[:, idx].astype(np.int64)                    # (B, S, len)
    bad = (sd > 3).any(axis=2)
    w = 4 ** np.arange(seed_len - 1, -1, -1, dtype=np.int64)
    fwd = (np.minimum(sd, 3) * w).sum(axis=2)
    rc = ((3 - np.minimum(sd, 3))[:, :, ::-1] * w).sum(axis=2)
    return np.where(bad, -1, fwd), np.where(bad, -1, rc)


# ---------------------------------------------------------------- hits

def seed_hits(codes: np.ndarray, keys: np.ndarray, seed_len: int, cap: int,
              device, chunk: int = 1 << 26):
    """Every genome position of each key in `keys` (sorted, distinct):
    (counts (n,), starts (n + 1,), hits) with each key's first `cap`
    hits in descending order at hits[starts[i]:starts[i + 1]]."""
    dev = torch.device(device)
    q = torch.from_numpy(keys).to(dev)
    nq = q.shape[0]
    counts = torch.zeros(nq, dtype=torch.int64, device=dev)
    kept_q, kept_p = [], []
    n_pos = codes.shape[0] - seed_len + 1
    hi = n_pos
    while hi > 0 and nq:
        lo = max(0, hi - chunk)
        seg = torch.from_numpy(codes[lo:hi + seed_len - 1]).to(dev)
        n = hi - lo
        key = torch.zeros(n, dtype=torch.int64, device=dev)
        bad = torch.zeros(n, dtype=torch.bool, device=dev)
        for t in range(seed_len):
            x = seg[t:t + n]
            key = key * 4 + x.clamp_max(3).to(torch.int64)
            bad |= x > 3
        idx = torch.searchsorted(q, key).clamp_max(nq - 1)
        m = (q[idx] == key) & ~bad
        pos = torch.nonzero(m).squeeze(1) + lo
        qid = idx[m]
        # descending positions within each key; the first `cap` of each
        # key over the whole scan (which runs from the genome's end)
        order = torch.argsort(qid * (1 << 34) + (pos.max() - pos
                                                 if pos.numel() else pos))
        qid, pos = qid[order], pos[order]
        new = torch.ones_like(qid, dtype=torch.bool)
        new[1:] = qid[1:] != qid[:-1]
        first = torch.nonzero(new).squeeze(1)
        grp = torch.cumsum(new.to(torch.int64), 0) - 1
        rank = torch.arange(qid.shape[0], device=dev) - first[grp]
        keep = rank + counts.clamp_max(cap)[qid] < cap
        kept_q.append(qid[keep])
        kept_p.append(pos[keep])
        counts += torch.bincount(qid, minlength=nq)
        hi = lo
    if kept_q:
        qid = torch.cat(kept_q)
        pos = torch.cat(kept_p)
        order = torch.argsort(qid * (1 << 34) + ((1 << 34) - 1 - pos))
        qid, pos = qid[order], pos[order]
    else:
        qid = pos = torch.zeros(0, dtype=torch.int64, device=dev)
    starts = torch.zeros(nq + 1, dtype=torch.int64, device=dev)
    starts[1:] = torch.cumsum(torch.bincount(qid, minlength=nq), 0)
    return (counts.cpu().numpy(), starts.cpu().numpy(),
            pos.cpu().numpy())


# ---------------------------------------------------------------- genome

class GenomeView:
    """Windows of the genome codes as the aligner reads them: padding past
    either end; non-big genomes clamp a negative start to 0, big ones
    (past 2^31 - 2^26 bases) wrap it as uint32."""

    def __init__(self, codes: np.ndarray, piece_offsets: np.ndarray):
        self.codes = codes
        self.size = int(codes.shape[0])
        self.piece_starts = np.asarray(piece_offsets, np.int64)
        self.big = self.size > (1 << 31) - (1 << 26)

    def window(self, start: int, width: int) -> np.ndarray:
        s = start % (1 << 32) if self.big else max(start, 0)
        out = np.full(width, 5, np.uint8)
        a, b = min(s, self.size), min(s + width, self.size)
        out[:b - a] = self.codes[a:b]
        return out

    def next_start(self, loc: int) -> int:
        p = int(np.searchsorted(self.piece_starts, loc, side="right")) - 1
        p = min(max(p, 0), len(self.piece_starts) - 1)
        return (int(self.piece_starts[p + 1])
                if p + 1 < len(self.piece_starts) else self.size)


def i32(x: int) -> int:
    """x as a 32-bit two's complement value."""
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


def phred_log_prob(q: np.ndarray) -> np.ndarray:
    """float32 log of the probability a base of quality byte q is misread,
    or a SNP: 1 - (1 - pe)(1 - SNP) = pe + SNP (1 - pe), pe =
    10^(-(q - 33)/10)."""
    f = np.float32
    pe = np.exp2((q.astype(f) - f(33.0)) * f(-np.log2(10.0) / 10.0))
    v = pe + f(lv.SNP_PROB) * (f(1.0) - pe)
    ok = (q >= 33) & (q <= 126)
    return np.where(ok, np.log(v), f(LOG_SNP)).astype(f)


def bf16(x):
    """float32 rounded to the nearest bfloat16 (ties to even), as float32."""
    a = np.asarray(x, np.float32)
    b = a.view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32).reshape(a.shape)


# ---------------------------------------------------------------- the reads

@dataclass
class End:
    """One read's candidates after the slot fill, in column order (the
    slots sorted by direction, then location)."""
    read: np.ndarray
    qlp: np.ndarray            # (2, L) float64: forward and reversed
    n_count: int
    S: int
    valid: np.ndarray          # (S,) bool
    popular: np.ndarray        # (S, 2) bool
    active: np.ndarray         # (S,) bool
    applied_act: np.ndarray    # (S, 2) bool
    lp_after: np.ndarray       # (S, 2) int
    cols: list                 # slot dicts in column order


class Reference:
    def __init__(self, codes: np.ndarray, piece_offsets, params: Params,
                 device="cpu", prob_dtype: str = "float32",
                 slice_of=None):
        self.g = GenomeView(codes, piece_offsets)
        self.p = params
        self.device = torch.device(device)
        self.r = bf16 if prob_dtype == "bfloat16" else np.float32
        self.slice_of = slice_of
        self.dead = (-16) % (1 << 32) if self.g.big else BIG

    # ------------------------------------------------------------ seeds

    def _seed_table(self, reads: np.ndarray):
        """Per read: schedule positions looked up, their keys (fwd, rc)
        and validity."""
        p = self.p
        B, L = reads.shape
        pos, wraps = seed_schedule(L, p.seed_len)
        pos, wraps = pos[:p.max_seed_slots], wraps[:p.max_seed_slots]
        fks, rks = seed_keys(reads, pos, p.seed_len)
        out = []
        for b in range(B):
            rows = [(s, w, int(fk), int(rk)) for s, w, fk, rk in
                    zip(pos, wraps, fks[b], rks[b])]
            if p.paired:
                valid_rows = [x for x in rows if x[2] >= 0]
                n_sel = min(p.num_seeds, len(pos))
                sel = valid_rows[:n_sel]
                valid = [True] * len(sel) + [False] * (n_sel - len(sel))
                sel = sel + [(rows[0][0], rows[0][1], -1, -1)] * (
                    n_sel - len(sel))
                out.append((sel, np.array(valid)))
            else:
                out.append((rows, np.array([x[2] >= 0 for x in rows])))
        return out

    def _ends(self, reads: np.ndarray, quals: np.ndarray, hits) -> list:
        p = self.p
        counts, starts, hitpos = hits["counts"], hits["starts"], hits["pos"]
        kidx = hits["index"]
        B, L = reads.shape
        ends = []
        for b, (rows, valid) in enumerate(self._seed_table(reads)):
            S = len(rows)
            cnt = np.zeros((S, 2), np.int64)
            kk = np.full((S, 2), -1, np.int64)
            for s, (_, _, fk, rk) in enumerate(rows):
                for d, k in ((0, fk), (1, rk)):
                    if k >= 0 and valid[s]:
                        kk[s, d] = kidx[k]
                        cnt[s, d] = counts[kidx[k]]
            popular = (cnt > p.max_hits) & valid[:, None]
            applied = valid[:, None] & ~popular
            if p.paired:
                lookups = valid.astype(np.int64)
                before = np.cumsum(lookups) - lookups
                active = (before < p.num_seeds) & valid
            else:
                per = applied.sum(axis=1)
                before = np.cumsum(per) - per
                active = before < p.num_seeds
            applied_act = applied & active[:, None]
            wr = np.array([x[1] for x in rows], np.int64)
            n_after = np.cumsum(applied_act, axis=0)
            lp_after = np.maximum.accumulate(n_after // (wr + 1)[:, None],
                                             axis=0)
            lp_pre = np.vstack([np.zeros((1, 2), np.int64), lp_after[:-1]])
            used = np.where(applied_act & (cnt > 0), cnt, 0)
            slots = self._fill(rows, used, kk, starts, hitpos, lp_pre, L)
            slots.sort(key=lambda c: (c["dir"], c["loc"]))
            q = phred_log_prob(quals[b])
            ends.append(End(read=reads[b], qlp=np.stack([q, q[::-1]]),
                            n_count=int((reads[b] == 4).sum()), S=S,
                            valid=valid, popular=popular, active=active,
                            applied_act=applied_act, lp_after=lp_after,
                            cols=slots))
        return ends

    def _fill(self, rows, used, kk, starts, hitpos, lp_pre, L):
        """The candidate slots, rarest applied seed first (a stable sort of
        the (position, direction) groups by hit count), each group's hits
        in list order; per index slice when seeds are split over slices."""
        p = self.p
        S = len(rows)
        groups = [(s, d) for s in range(S) for d in (0, 1)]
        by_slice = {}
        for g, (s, d) in enumerate(groups):
            key = min(rows[s][2], rows[s][3])          # canonical
            sl = 0 if self.slice_of is None or key < 0 else \
                self.slice_of(key)
            by_slice.setdefault(sl, []).append(g)
        slots = []
        for sl in sorted(by_slice):
            order = sorted(by_slice[sl], key=lambda g: used[groups[g]])
            left = p.cand_per_read
            for g in order:
                s, d = groups[g]
                n = int(min(used[s, d], left))
                if n <= 0:
                    continue
                k = kk[s, d]
                lst = hitpos[starts[k]:starts[k] + n]
                pos = rows[s][0]
                off = pos if d == 0 else L - p.seed_len - pos
                for w, h in enumerate(lst):
                    h = int(h)
                    slots.append(dict(dir=d, live=off <= h,
                                      loc=(h - off) if off <= h else self.dead,
                                      order=(g << 16) | min(w, 0xFFFF),
                                      off=off, lp=int(lp_pre[s, d]),
                                      round=s))
                left -= n
        return slots

    # ------------------------------------------------------------ align

    def align(self, reads: list, quals: list) -> dict:
        """reads, quals: one (B, L) array per end (two for pairs)."""
        p = self.p
        keys = set()
        tables = [self._seed_table(r) for r in reads]
        for t in tables:
            for rows, _ in t:
                for _, _, fk, rk in rows:
                    if fk >= 0:
                        keys.add(fk)
                        keys.add(rk)
        keys = np.array(sorted(keys), np.int64)
        counts, starts, pos = seed_hits(self.g.codes, keys, p.seed_len,
                                        p.cand_per_read, self.device)
        hits = dict(counts=counts, starts=starts, pos=pos,
                    index={int(k): i for i, k in enumerate(keys)})
        ends = [self._ends(r, q, hits) for r, q in zip(reads, quals)]
        L = reads[0].shape[1]
        self.score_candidates([e for es in ends for e in es], L)
        singles = [[self.single_result(e) for e in es] for es in ends]
        if not p.paired:
            return _stack(singles[0], "")
        return self.pair_results(ends, singles, L)

    # ------------------------------------------------------------ scoring

    def score_candidates(self, ends: list, L: int) -> None:
        """Scores every unique live candidate (the first slot of each
        (direction, location) run) in place: score, logp, loc_adj,
        scored_ok; the run's first order, its last hit's seed offset and
        its 48-base element's lowest-possible bound."""
        p = self.p
        M = e_max = p.e_max
        want = L + M
        todo = []
        for e in ends:
            cols = e.cols
            for i, c in enumerate(cols):
                c.update(uniq=False, scored_ok=False, score=BIG,
                         logp=NEG_INF, loc_adj=c["loc"])
            # runs of equal (dir, loc) and 48-base elements
            i = 0
            while i < len(cols):
                j = i
                while (j < len(cols) and cols[j]["dir"] == cols[i]["dir"]
                       and cols[j]["loc"] == cols[i]["loc"]):
                    j += 1
                run = [c for c in cols[i:j] if c["live"]]
                if cols[i]["live"]:
                    c = cols[i]
                    c["uniq"] = True
                    c["first_order"] = min(x["order"] for x in run)
                    c["first_round"] = c["first_order"] >> 17
                    packed = max(((((x["order"] << 10) & M32) | x["off"])
                                  + 1) & M32 for x in run)
                    c["seed_off"] = (packed - 1) & 0x3FF
                    todo.append((e, c))
                i = j
            elem = {}
            for c in cols:
                if c["live"]:
                    k = (c["dir"], c["loc"] - c["loc"] % MAX_MERGE_DIST)
                    elem[k] = min(elem.get(k, BIG), c["lp"])
            for c in cols:
                if c["uniq"]:
                    c["elem_lp"] = elem[(c["dir"],
                                         c["loc"] - c["loc"] % MAX_MERGE_DIST)]
        if not todo:
            return
        comp = np.array([3, 2, 1, 0, 4], np.uint8)
        sel = np.stack([e.read if c["dir"] == 0 else
                        comp[np.minimum(e.read[::-1], 4)] for e, c in todo])
        selq = np.stack([e.qlp[c["dir"]] for e, c in todo])
        win = np.stack([self.g.window(c["loc"] - M, L + 2 * M)
                        for _, c in todo])
        locs = [c["loc"] for _, c in todo]
        text_len, crosses = [], []
        for loc in locs:
            nxt = self.g.next_start(loc)
            cr = min(nxt, self.g.size) < loc + want
            end = self.g.size if self.g.size <= loc + want else nxt
            crosses.append(cr)
            text_len.append(end - loc - 1 if cr else want)
        text_len = np.array(text_len)
        crosses = np.array(crosses)
        data_ok = text_len >= L - M
        dev = self.device
        ham = (sel != win[:, M:M + L]).sum(axis=1)
        # the anchored whole-read distance over L + e_max columns
        last = dp.unit_dp(torch.from_numpy(sel).to(dev),
                          torch.from_numpy(win[:, M:M + want]).to(dev),
                          free_start=False, cap=L + want)
        wdist = last[:, 1:want + 1].amin(dim=1).cpu().numpy()
        fast = ~crosses & (wdist <= e_max) & (ham == wdist)
        need = ~fast & (wdist <= e_max)
        mm = sel != win[:, M:M + L]
        for t, (e, c) in enumerate(todo):
            if fast[t]:
                c.update(scored_ok=True, score=int(ham[t]),
                         logp=self._logp_sub(selq[t], mm[t], int(ham[t]), L),
                         loc_adj=c["loc"])
        idx = np.nonzero(need)[0]
        if idx.size:
            self._score_through_seed(idx, todo, sel, selq, win, text_len,
                                     data_ok, L)

    def _logp_sub(self, q, mm, ham, L):
        r = self.r
        qq = r(q.astype(np.float32))
        s = r(np.float32(0))
        for v in qq[mm]:
            s = r(s + v)
        return r(s + r(np.float32(L - ham) * r(LOG_ONE_MINUS_SNP)))

    def _score_through_seed(self, idx, todo, sel, selq, win, text_len,
                            data_ok, L):
        """LV's two problems through the seed at seed_off: the read from
        the candidate with the seed and what precedes it free (the tail),
        and the reversed read back from the seed's end with the seed and
        what follows it free (the head); each at most e_max edits."""
        p = self.p
        M = e_max = p.e_max
        so = np.array([todo[t][1]["seed_off"] for t in idx], np.int64)
        locs = np.array([todo[t][1]["loc"] for t in idx], np.int64)
        fwd = win[idx, M:]
        bwd = win[idx, :L + M][:, ::-1]
        n = idx.size
        d1, lp1, _ = lv.landau_vishkin(
            sel[idx], np.full(n, L), fwd, text_len[idx], np.full(n, e_max),
            selq[idx], so + p.seed_len, e_max)
        bwd_tlen = (L - so) + np.minimum(so + M, locs + so)
        d2, lp2, net2 = lv.landau_vishkin(
            sel[idx][:, ::-1], np.full(n, L), bwd, bwd_tlen,
            np.full(n, e_max), selq[idx][:, ::-1], L - so, e_max)
        r32 = self.r
        for r, t in enumerate(idx):
            c = todo[t][1]
            if (data_ok[t] and d1[r] >= 0 and d2[r] >= 0
                    and d1[r] + d2[r] <= e_max):
                c.update(scored_ok=True, score=int(d1[r] + d2[r]),
                         logp=r32(r32(r32(lp1[r]) + r32(lp2[r]))
                                  + r32(np.float32(p.seed_len)
                                        * LOG_ONE_MINUS_SNP)),
                         loc_adj=(c["loc"] + int(net2[r])) % (1 << 32))

    # ------------------------------------------------------------ single

    def _comp(self, score, logp):
        r = self.r
        return r(r(np.float32(score) * np.float32(1e6))
                 - r(np.clip(np.float32(logp), -1e5, 0)))

    def single_result(self, e: End) -> dict:
        """The replay of the sequential engine: early stop round, winner,
        cluster mass, MAPQ, result."""
        p = self.p
        r = self.r
        maxK, extra, S = p.max_k, p.extra, e.S
        cols = e.cols
        cand = [c for c in cols if c["uniq"]]
        best_by_round = np.full(S, BIG, np.int64)
        for c in cand:
            if c["scored_ok"]:
                s = min(max(c["first_round"], 0), S - 1)
                best_by_round[s] = min(best_by_round[s], c["score"])
        best_upto = np.minimum.accumulate(best_by_round)
        limit_r = np.minimum(best_upto, maxK) + extra
        stop = np.minimum(e.lp_after[:, 0], e.lp_after[:, 1]) > limit_r
        r_star = int(np.argmax(stop)) if stop.any() else S - 1
        for c in cols:
            c["in_play"] = (c["uniq"] and c["scored_ok"]
                            and min(max(c["first_round"], 0), S - 1)
                            <= r_star)
        play = [i for i, c in enumerate(cols) if c["in_play"]]
        has_best = bool(play)
        if has_best:
            comps = {i: self._comp(cols[i]["score"], cols[i]["logp"])
                     for i in play}
            m1 = min(comps.values())
            c1 = [i for i in play if comps[i] <= m1]
            m2 = min(cols[i]["first_order"] for i in c1)
            win = min(i for i in c1 if cols[i]["first_order"] == m2)
        else:
            win = 0
        wc = cols[win] if cols else None
        best_score = wc["score"] if has_best else BIG
        best_logp = r(wc["logp"]) if has_best else NEG_INF
        final_limit = min(min(best_score, maxK) + extra, p.e_max)
        # clusters along the columns: a new one at a direction change or a
        # gap of more than 48 bases in the adjusted locations
        clus_best = []
        cur, prev = None, None
        for i, c in enumerate(cols):
            la = c["loc_adj"] if c["uniq"] else c["loc"]
            if (prev is None or c["dir"] != prev[0]
                    or i32(la - prev[1]) > MAX_MERGE_DIST):
                cur = []
                clus_best.append(cur)
            prev = (c["dir"], la)
            in_prob = (c["in_play"] and c["score"] <= final_limit
                       and c["elem_lp"] <= final_limit)
            cur.append((i, self._comp(c["score"], c["logp"])
                        if in_prob else F3E12))
        reps = []
        for cl in clus_best:
            k = min(v for _, v in cl)
            if k < F3E12:
                reps.append(next(i for i, v in cl if v <= k))
        logps = [r(cols[i]["logp"]) for i in reps]
        log_pall = self._logsum(logps)
        log_pother = self._logsum([r(cols[i]["logp"]) for i in reps
                                   if i != win], ref=logps)
        popular_n = int(sum(e.popular[s].sum() for s in range(S)
                            if e.active[s] and s <= r_star))
        mapq = self.compute_mapq(log_pall, best_logp, log_pother,
                                 best_score, popular_n)
        applied_any = bool(e.applied_act.any())
        aligned = has_best and best_score <= maxK
        if aligned:
            result = SINGLE_HIT if mapq >= MAPQ_LIMIT_FOR_SINGLE_HIT else \
                MULTIPLE_HITS
        else:
            result = NOT_FOUND if applied_any else MULTIPLE_HITS
        if e.n_count > maxK:
            result = NOT_FOUND
        ok = aligned and e.n_count <= maxK
        return dict(result=result,
                    loc=wc["loc_adj"] if ok else INVALID,
                    dir=wc["dir"] if cols else 0,
                    score=best_score if has_best else -1,
                    mapq=mapq if ok else 0, popular=popular_n,
                    dense=[c for c in cols if c["uniq"] and c["scored_ok"]
                           ][:p.cand_per_read])

    def _logsum(self, lps, ref=None):
        """log of the sum of exp(lps), taken from the maximum of `ref`
        (default lps) as the engine takes it; NEG_INF for an empty sum."""
        r = self.r
        ref = lps if ref is None else ref
        mx = max(ref) if ref else NEG_INF
        mx = r(max(mx, np.float32(-1e29)))
        s = r(np.float32(0))
        for v in lps:
            s = r(s + r(np.exp(r(v - mx))))
        if s > 0:
            return r(r(np.log(s)) + mx)
        return NEG_INF

    def compute_mapq(self, log_pall, log_pbest, log_pother, score,
                     popular) -> int:
        """computeMAPQ in log space: 70 for an exact unique hit with a low
        score and no popular seed skipped; else -10 log10 of the other
        candidates' share of the mass, at most 69, less half the popular
        seeds past ten."""
        r = self.r
        d = r(np.float32(log_pother) - np.float32(log_pbest))
        exact = d < np.float32(-36.7368)
        if exact and popular == 0 and score < 5:
            return 70
        ratio = r(np.exp(np.minimum(d, np.float32(50.0))))
        frac = r(ratio / r(np.float32(1.0) + ratio))
        if frac <= 0:
            base = 69
        else:
            v = r(np.float32(-10.0) * r(np.log10(max(frac,
                                                      np.float32(1e-30)))))
            base = min(int(v), 69)
        base = max(base - max(popular - 10, 0) // 2, 0)
        return int(base)

    # ------------------------------------------------------------ pairs

    def _key(self, c):
        return self._comp(c["score"], c["logp"])

    def pair_results(self, ends, singles, L) -> dict:
        p = self.p
        B = len(ends[0])
        dense = [[s["dense"] for s in singles[e]] for e in (0, 1)]
        rescued = [self._rescue(dense[e], dense[1 - e], ends[e], L)
                   for e in (0, 1)]
        out = {k: [] for k in ("pair_found", "pair_score")}
        for e in (0, 1):
            for k in ("result", "loc", "dir", "score", "mapq"):
                out[f"{k}{e}"] = []
        for b in range(B):
            d0 = dense[0][b] + rescued[0][b]
            d1 = dense[1][b] + rescued[1][b]
            pr = self._pair(d0, d1, singles[0][b]["popular"]
                            + singles[1][b]["popular"])
            pf = pr["found"]
            out["pair_found"].append(pf)
            out["pair_score"].append(pr["score"] if pf else -1)
            for e, d in ((0, d0), (1, d1)):
                s = singles[e][b]
                if pf:
                    c = d[pr["w"][e]]
                    mq = pr["mapq"][e]
                    out[f"result{e}"].append(
                        SINGLE_HIT if mq >= MAPQ_LIMIT_FOR_SINGLE_HIT
                        else MULTIPLE_HITS)
                    out[f"loc{e}"].append(c["loc_adj"])
                    out[f"dir{e}"].append(c["dir"])
                    out[f"score{e}"].append(c["score"])
                    out[f"mapq{e}"].append(mq)
                else:
                    out[f"result{e}"].append(s["result"])
                    out[f"loc{e}"].append(s["loc"])
                    out[f"dir{e}"].append(s["dir"])
                    out[f"score{e}"].append(s["score"])
                    out[f"mapq{e}"].append(
                        s["mapq"] if s["result"] != NOT_FOUND else 0)
        return {k: np.asarray(v, np.int64) for k, v in out.items()}

    def _pair(self, d0, d1, popular) -> dict:
        p = self.p
        r = self.r
        best, bi = None, None
        pairs = []
        for i, a in enumerate(d0):
            for j, b in enumerate(d1):
                dist = abs(i32(a["loc_adj"] - b["loc_adj"]))
                if (a["dir"] != b["dir"] and p.min_spacing <= dist
                        <= p.max_spacing):
                    s = a["score"] + b["score"]
                    lp = r(r(a["logp"]) + r(b["logp"]))
                    pairs.append((i, j, s, lp))
                    k = self._comp(s, lp)
                    if best is None or k < best:
                        best, bi = k, (i, j, s, lp)
        if bi is None:
            return dict(found=False)
        i, j, s_best, lp_best = bi
        found = s_best <= p.max_k
        limit = min(s_best, p.max_k) + p.extra
        mass = [lp for (_, _, s, lp) in pairs if s <= limit]
        other = [lp for (a, b, s, lp) in pairs if s <= limit
                 and (a, b) != (i, j)]
        log_pall = self._logsum(mass)
        log_pother = self._logsum(other, ref=mass)
        mapq = [self.compute_mapq(log_pall, lp_best, log_pother,
                                  d[k]["score"], popular)
                for d, k in ((d0, i), (d1, j))]
        return dict(found=found, score=s_best, w=(i, j), mapq=mapq)

    def _rescue(self, dense_e, dense_m, ends_e, L) -> list:
        """One rescued candidate per read of end e (a one-element list, or
        empty): the best start in the spacing windows of its mate's two
        best candidates, scored from that start."""
        p = self.p
        M = gate = p.e_max
        span = p.max_spacing - p.min_spacing
        WLEN = span + L + 2 * M
        comp = np.array([3, 2, 1, 0, 4], np.uint8)
        rows = []                      # (b, w, win_start, dir)
        for b, dm in enumerate(dense_m):
            keys = [self._key(c) for c in dm]
            chosen = []
            for _ in range(p.rescue_mates):
                live = [i for i in range(len(dm)) if i not in chosen]
                if not live:
                    break
                m = min(keys[i] for i in live)
                chosen.append(min(i for i in live if keys[i] <= m))
            for r_i, mi in enumerate(chosen):
                c = dm[mi]
                for side, lo in enumerate((c["loc_adj"] - p.max_spacing,
                                           c["loc_adj"] + p.min_spacing)):
                    rows.append((b, r_i * 2 + side, i32(lo - M), 1 - c["dir"]))
        out = [[] for _ in range(len(dense_e))]
        if not rows:
            return out
        pats = np.stack([ends_e[b].read if d == 0 else
                         comp[np.minimum(ends_e[b].read[::-1], 4)]
                         for b, _, _, d in rows])
        texts = np.stack([self.g.window(ws, WLEN)[::-1]
                          for _, _, ws, _ in rows])
        dev = self.device
        last = dp.unit_dp(torch.from_numpy(np.ascontiguousarray(
            pats[:, ::-1])).to(dev), torch.from_numpy(
                np.ascontiguousarray(texts)).to(dev), free_start=True,
            cap=4095)
        # the best end column of the reversed scan, the earliest on ties
        sc = last[:, 1:].to(torch.int64)
        enc = (sc * 4096 + torch.arange(WLEN, device=dev)).amin(dim=1)
        enc = enc.cpu().numpy()
        best = {}
        for (b, w, ws, d), v in zip(rows, enc):
            dist, j = int(v >> 12), int(v & 4095)
            start = WLEN - 1 - j
            if M <= start <= M + span and dist <= gate:
                k = (dist, w)
                if b not in best or k < best[b][0]:
                    best[b] = (k, (ws + start) % (1 << 32), d)
        todo = []
        for b, (_, loc, d) in best.items():
            if any(c["dir"] == d and abs(i32(c["loc_adj"] - loc))
                   <= MAX_MERGE_DIST for c in dense_e[b]):
                continue
            todo.append((b, loc, d))
        if not todo:
            return out
        want = L + M
        pats, qs, txts, tls = [], [], [], []
        for b, loc, d in todo:
            e = ends_e[b]
            pats.append(e.read if d == 0 else comp[np.minimum(e.read[::-1],
                                                               4)])
            qs.append(e.qlp[d].astype(np.float32))
            nxt = self.g.next_start(loc)
            cr = min(nxt, self.g.size) < loc + want
            end = self.g.size if self.g.size <= loc + want else nxt
            tls.append(end - loc - 1 if cr else want)
            txts.append(self.g.window(loc - M, L + 2 * M)[M:])
        n = len(todo)
        tls = np.array(tls, np.int64)
        d1, lp1, _ = lv.landau_vishkin(
            np.stack(pats), np.full(n, L), np.stack(txts), tls,
            np.full(n, p.e_max), np.stack(qs), np.zeros(n, np.int64),
            p.e_max)
        for t, (b, loc, d) in enumerate(todo):
            if tls[t] >= L - M and 0 <= d1[t] <= gate:
                out[b] = [dict(dir=d, loc_adj=loc, score=int(d1[t]),
                               logp=self.r(lp1[t]))]
        return out


def _stack(rows: list, suffix: str) -> dict:
    keys = ("result", "loc", "dir", "score", "mapq")
    return {k + suffix: np.asarray([r[k] for r in rows], np.int64)
            for k in keys}


def ref_params(config: dict, traffic: dict) -> Params:
    a = traffic["aligner"]
    paired = traffic["mode"] == "paired"
    extra = dict(min_spacing=a["min_spacing"], max_spacing=a["max_spacing"],
                 rescue_mates=a["rescue_mates"]) if paired else {}
    return Params(seed_len=int(config["index"]["seed_len"]),
                  max_k=a["max_dist"], num_seeds=a["num_seeds"],
                  max_hits=a["max_hits"], extra=a["extra_search_depth"],
                  cand_per_read=int(config["cand_per_read"]),
                  max_seed_slots=a["max_seed_slots"], paired=paired, **extra)


def slice_map(genome, config: dict, traffic: dict, dev):
    """canonical seed key -> index slice, where the entry is the mesh over
    the index's slices (None otherwise), worked out from the genome by
    the reference (reference/slices.py)."""
    if config["entry"][traffic["mode"]] != "sharded_paired":
        return None
    from .slices import key_slicer
    return key_slicer(torch.from_numpy(genome.codes).to(dev),
                      int(config["index"]["seed_len"]),
                      float(config["index"]["load_factor"]),
                      config["index"].get("slices"))


def make(genome, extras: dict, config: dict, traffic: dict, device,
         control: bool = False) -> Reference:
    """Reference "aligner": the reference for a DNA configuration and
    mix; `control` computes its probabilities in bfloat16, the precision
    below the configurations' float32."""
    return Reference(genome.codes, genome.piece_offsets,
                     ref_params(config, traffic), device,
                     prob_dtype="bfloat16" if control else "float32",
                     slice_of=slice_map(genome, config, traffic, device))
