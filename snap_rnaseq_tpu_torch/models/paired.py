"""Batched paired-end aligner on the card: the port of
snap_rnaseq_tpu/models/paired.py.

Reference: SNAPLib/IntersectingPairedEndAligner.{h,cpp} (sorted-hit-set
intersection, pair probability mass) wrapped by
ChimericPairedEndAligner.{h,cpp} (single-end fallback per end when no pair
is found).  As in the JAX engine, both ends run the single-end candidate
phases of models/single.py in ONE 2B-row pipeline (rows 0..B-1 end 0,
B..2B-1 end 1); the reference's coordinated walk of two sorted hit lists
becomes a dense per-read (K x K) pair matrix over the two ends' scored
candidates, with the spacing/orientation window as a mask.  Pair
probability = product of end probabilities; MAPQ from best/all pair mass
(IntersectingPairedEndAligner.cpp:514-741).

Mate-window rescue (_mate_rescue_end): for each end, the two spacing
windows of its mate's best candidates are scanned by the reversed,
free-start, position-tracking form of the bit-parallel kernel (K2 on a
card), and the best in-budget hit is scored by score_phase (K1).  It
recovers in-window alignments that the static candidate budgets dropped.

The pair edit-distance budget (-d, default 15) bounds the SUM of the two
ends' scores, as in the reference (AlignerOptions.cpp:73).

Device rule: PairedAligner runs on the device it is given (default
"cuda") and raises if that device is absent.  SNAP_TPU_LOOKUP picks the
seed lookup at construction (models/single.py index_state).  The JAX
package's AOT executable cache has no counterpart here: the port runs
eagerly.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (DEFAULT_EXTRA_SEARCH_DEPTH, MAX_K, MAX_MERGE_DIST,
                         MAPQ_LIMIT_FOR_SINGLE_HIT, PAIRED_DEFAULTS)
from ..index.hash_index import GenomeIndex
from ..ops.bitpar import bitpar_distance_words
from ..ops.genome_gather import gather_windows
from ..ops.lv import NEG_INF, _first_argmin, phred_log_prob_device
from ..utils import stats
from ..utils.seed_sequencer import seed_position_schedule
from . import single as sg

NOT_FOUND, SINGLE_HIT, MULTIPLE_HITS = 0, 1, 2
BIG = sg.BIG
I32 = torch.int32
F32 = torch.float32


@dataclass(frozen=True)
class PairedAlignerConfig:
    seed_len: int
    max_k: int = PAIRED_DEFAULTS["max_dist"]          # pair-total edit budget
    num_seeds: int = PAIRED_DEFAULTS["num_seeds"]
    max_hits: int = PAIRED_DEFAULTS["max_hits"]
    min_spacing: int = PAIRED_DEFAULTS["min_spacing"]
    max_spacing: int = PAIRED_DEFAULTS["max_spacing"]
    extra_search_depth: int = DEFAULT_EXTRA_SEARCH_DEPTH
    cand_per_read: int = 128
    max_seed_slots: int = 32
    force_spacing: bool = False
    score_budget_per_read: int = 16
    overflow_tier: bool = False
    # mate-window rescue: scan the spacing windows of the mate's best
    # `rescue_mates` candidates (see the module docstring)
    mate_rescue: bool = True
    rescue_mates: int = 2
    # fold the estimated pair mass of truncation-dropped candidates into
    # the MAPQ denominator (never raises MAPQ); env override
    # SNAP_TPU_TRUNC_MASS=0/1
    truncation_mass: bool = False

    @property
    def e_max(self) -> int:
        return min(MAX_K, self.max_k + self.extra_search_depth)

    def end_config(self) -> sg.SingleAlignerConfig:
        """Per-end single config used for candidate generation + fallback."""
        return sg.SingleAlignerConfig(
            seed_len=self.seed_len, max_k=self.max_k,
            num_seeds=self.num_seeds, max_hits=self.max_hits,
            extra_search_depth=self.extra_search_depth,
            cand_per_read=self.cand_per_read,
            max_seed_slots=self.max_seed_slots,
            score_budget_per_read=self.score_budget_per_read,
            overflow_tier=self.overflow_tier,
            seed_budget_per_position=True)


def _key(score, logp, live):
    """(score asc, logp desc) as one f32 key; 3e12 for dead entries.  Every
    operand stays float32, as in the JAX engine."""
    f3e12 = stats.to_device("const", torch.tensor(3e12, dtype=F32),
                            score.device)
    return torch.where(live, score.to(F32) * 1e6 - logp.clamp(-1e5, 0),
                       f3e12)


def _dense_per_read(u, sc, in_prob_flags, B, K):
    """Scatter the flat, read-sorted candidate arrays into (B, K) dense.

    Only SCORED candidates are densified (unscored rows are dead in the
    pair join anyway), and the K-cap ranks among scored rows, so a wide
    overflow tier carrying hundreds of unscored repeat candidates per read
    can never push a true scored hit past the cap.  No engine path calls
    it; it is held to the JAX package's function."""
    r = u["read"]
    dev = r.device
    sel = u["live"] & sc["scored_ok"]
    ones = sel.to(I32)
    cum = torch.cumsum(ones, 0, dtype=I32) - ones    # exclusive prefix count
    first = sg._segment_min(torch.where(sel, cum, BIG), r, B)
    rank = cum - first[r.long()]
    keep = sel & (rank < K)
    # the JAX scatter's mode="drop" on rows that are not kept
    tr, tc = r[keep].long(), rank[keep].long()

    def scat(x, fill):
        out = torch.full((B, K), fill, dtype=x.dtype, device=dev)
        out[tr, tc] = x[keep]
        return out

    return dict(
        loc=scat(sc["loc_adj"], 0),
        dir=scat(u["dir"], 0),
        score=scat(torch.where(sc["scored_ok"], sc["score"], BIG), BIG),
        logp=scat(torch.where(sc["scored_ok"], sc["logp"], NEG_INF),
                  NEG_INF),
        live=scat(sc["scored_ok"], False),
        in_prob=scat(in_prob_flags, False),
        # scored candidates the K-cap dropped from the pair join (flood
        # reads with > K scored locations): observable, never silent
        overflow=(sel & ~keep).sum(dtype=I32),
    )


def _mate_rescue_end(d_e, d_m, reads_e, quals_e, genome_p4, piece_starts,
                     ecfg, cfg: PairedAlignerConfig, read_len, genome_size,
                     B, qlp_e=None):
    """One rescued candidate for end e from its mate's top candidates.

    For each of the mate's top `rescue_mates` scored candidates, the two
    pair-spacing windows ([loc_m - max_sp, loc_m - min_sp] and
    [loc_m + min_sp, loc_m + max_sp], opposite orientation) are scanned
    back to front with a free start (K2's rescue form), which returns the
    best whole-read distance and its start; the best in-budget window
    winner is then scored by score_phase with seed_len = 0 (whole-read LV,
    K1), so its score/logp/loc_adj match budget-kept candidates."""
    R = cfg.rescue_mates
    dev = reads_e.device
    gate = ecfg.e_max
    span = cfg.max_spacing - cfg.min_spacing
    M = ecfg.e_max                     # window margin = the scan's gate
    WLEN = span + read_len + 2 * M
    f3e12 = stats.to_device("const", torch.tensor(3e12, dtype=F32), dev)

    # top-R mate candidates by (score asc, logp desc), first-index ties
    key = _key(d_m["score"], d_m["logp"], d_m["live"])
    rows = torch.arange(B, device=dev)
    m_loc, m_dir, m_live = [], [], []
    for _ in range(R):
        w = _first_argmin(key).long()
        m_loc.append(d_m["loc"][rows, w])
        m_dir.append(d_m["dir"][rows, w])
        m_live.append(key[rows, w] < f3e12)
        key = key.clone()
        key[rows, w] = f3e12
    m_loc = torch.stack(m_loc, dim=1)                 # (B, R)
    m_dir = torch.stack(m_dir, dim=1)
    m_live = torch.stack(m_live, dim=1)

    # window starts: side 0 = upstream of the mate, side 1 = downstream;
    # (B, R, 2) flattens to B * NW rows in that order
    lo = torch.stack([m_loc - cfg.max_spacing, m_loc + cfg.min_spacing],
                     dim=2)
    NW = R * 2
    win_start = (lo - M).reshape(B * NW)
    dir_rows = (1 - m_dir)[:, :, None].expand(B, R, 2).reshape(B * NW)
    live_rows = m_live[:, :, None].expand(B, R, 2).reshape(B * NW)

    _win, win_words = gather_windows(
        genome_p4, win_start, width=WLEN,
        big=sg.big_locations(genome_size), return_packed=True)

    comp = stats.to_device("comp_lut", torch.from_numpy(sg._COMP_LUT),
                           dev)
    rc_reads = comp[reads_e.flip(1).long()]
    read_both = torch.stack([reads_e, rc_reads], dim=1)
    ridx = torch.arange(B, device=dev).repeat_interleave(NW)
    pat = read_both[ridx, dir_rows.long()]                   # (B*NW, L)

    # reversed scan: forward start s is reversed end column WLEN - 1 - j;
    # free start + free end = the best substring match
    enc = bitpar_distance_words(
        pat.flip(1), win_words,
        torch.full((B * NW,), WLEN, dtype=I32, device=dev),
        P=read_len, TXT=WLEN, packed_off=0, track_pos=True,
        free_start=True, reverse=True)
    dist = enc >> 12
    start_in_w = WLEN - 1 - (enc & 4095)
    loc_r = win_start + start_in_w
    # the start must lie inside the spacing interval for pair_phase
    in_range = (start_in_w >= M) & (start_in_w <= M + span)
    ok = live_rows & in_range & (dist <= gate)

    # best window per read: (dist asc, row asc)
    side = torch.arange(B * NW, dtype=I32, device=dev) % NW
    ekey = torch.where(ok, dist * NW + side, BIG).reshape(B, NW)
    wsel = _first_argmin(ekey).long()
    valid = ekey[rows, wsel] < BIG
    loc_best = loc_r.reshape(B, NW)[rows, wsel]
    dir_best = dir_rows.reshape(B, NW)[rows, wsel]

    # dedup: drop if a live dense candidate already covers the location
    dup = (((d_e["loc"] - loc_best[:, None]).abs() <= MAX_MERGE_DIST)
           & (d_e["dir"] == dir_best[:, None]) & d_e["live"]).any(dim=1)
    valid = valid & ~dup

    u_r = dict(read=torch.arange(B, dtype=I32, device=dev), dir=dir_best,
               loc=torch.where(valid, loc_best, 0),
               off=torch.zeros(B, dtype=I32, device=dev), live=valid)
    sc = sg.score_phase(u_r, reads_e, quals_e, genome_p4, piece_starts,
                        ecfg, 0, read_len, genome_size, qlp_both=qlp_e)
    keep = valid & sc["scored_ok"]
    return dict(loc=torch.where(keep, sc["loc_adj"], 0)[:, None],
                dir=dir_best[:, None],
                score=torch.where(keep, sc["score"], BIG)[:, None],
                logp=torch.where(keep, sc["logp"], NEG_INF)[:, None],
                live=keep[:, None], in_prob=keep[:, None],
                n_rescued=keep.sum(dtype=I32))


def _append_dense(d, resc):
    out = {k: torch.cat([d[k], resc[k]], dim=1)
           for k in ("loc", "dir", "score", "logp", "live", "in_prob")}
    out["overflow"] = d["overflow"]
    return out


def pair_phase(d0, d1, cfg: PairedAlignerConfig, popular0, popular1,
               trunc_total=None):
    """Dense pair join + selection + pair MAPQ.

    trunc_total: optional (B,) count of expand-truncated candidates across
    both ends; with cfg.truncation_mass the estimated mass of the dropped
    candidates joins the MAPQ denominator."""
    B, K = d0["score"].shape
    dev = d0["score"].device
    maxK, extra = cfg.max_k, cfg.extra_search_depth

    dist = (d0["loc"][:, :, None] - d1["loc"][:, None, :]).abs()
    opp = d0["dir"][:, :, None] != d1["dir"][:, None, :]
    window = (dist >= cfg.min_spacing) & (dist <= cfg.max_spacing)
    valid = (d0["live"][:, :, None] & d1["live"][:, None, :] & opp & window)

    s_pair = torch.where(valid,
                         d0["score"][:, :, None] + d1["score"][:, None, :],
                         BIG).reshape(B, K * K)
    lp_pair = (d0["logp"][:, :, None]
               + d1["logp"][:, None, :]).reshape(B, K * K)

    # winner: (score asc, prob desc); f32 composite is exact for score<=62
    w = _first_argmin(_key(s_pair, lp_pair, s_pair < BIG)).long()
    rows = torch.arange(B, device=dev)
    best_score = s_pair[rows, w]
    best_logp = lp_pair[rows, w]
    pair_found = best_score <= maxK
    w0, w1 = w // K, w % K

    # pair probability mass over cluster-representative pairs
    limit = best_score.clamp_max(maxK) + extra
    in_prob = (d0["in_prob"][:, :, None]
               & d1["in_prob"][:, None, :]).reshape(B, K * K)
    in_mass = valid.reshape(B, K * K) & (s_pair <= limit[:, None]) & in_prob
    neg_inf = stats.to_device("const", torch.tensor(NEG_INF, dtype=F32),
                              dev)
    mx = torch.where(in_mass, lp_pair, neg_inf).amax(dim=1).clamp_min(-1e29)
    e = torch.exp(lp_pair - mx[:, None])
    mass = torch.where(in_mass, e, 0.0).sum(dim=1)
    log_pall = torch.where(mass > 0, torch.log(mass) + mx, neg_inf)

    is_best = torch.zeros((B, K * K), dtype=torch.bool, device=dev)
    with stats.sync("best_flag", device=dev):   # True is copied from host
        is_best[rows, w] = True
    other = in_mass & ~is_best
    mass_o = torch.where(other, e, 0.0).sum(dim=1)
    if cfg.truncation_mass and trunc_total is not None:
        # dropped candidates estimated at the mean kept non-best pair
        # mass; adds to BOTH denominators, so MAPQ only moves down
        count_o = other.sum(dim=1, dtype=I32)
        est = trunc_total.to(F32) * mass_o / count_o.clamp_min(1).to(F32)
        mass = mass + est
        mass_o = mass_o + est
        log_pall = torch.where(mass > 0, torch.log(mass) + mx, neg_inf)
    log_pother = torch.where(mass_o > 0, torch.log(mass_o) + mx, neg_inf)

    popular = popular0 + popular1
    # the reference hands computeMAPQ each END's score, not the pair sum
    # (IntersectingPairedEndAligner.cpp:741)
    s0_best = d0["score"][rows, w0]
    s1_best = d1["score"][rows, w1]
    mapq0 = sg._compute_mapq(log_pall, best_logp, log_pother, s0_best,
                             popular)
    mapq1 = sg._compute_mapq(log_pall, best_logp, log_pother, s1_best,
                             popular)
    return dict(pair_found=pair_found, w0=w0, w1=w1,
                score=torch.where(pair_found, best_score, -1).to(I32),
                mapq=torch.where(pair_found, torch.minimum(mapq0, mapq1),
                                 0).to(I32),
                mapq0=torch.where(pair_found, mapq0, 0).to(I32),
                mapq1=torch.where(pair_found, mapq1, 0).to(I32),
                log_pbest=best_logp, log_pall=log_pall)


@stats.timed("engine.paired", batch=True)
def _paired_align_batch(reads0, quals0, reads1, quals1, state, schedule,
                        wraps, *, cfg: PairedAlignerConfig, seed_len: int,
                        read_len: int, sched_static: tuple):
    genome_size = state["genome_size"]
    genome_p4, piece_starts = state["genome_p4"], state["piece_starts"]
    B = reads0.shape[0]
    S_all = schedule.shape[0]
    dev = reads0.device
    # active-position lookups: the paired seed budget is position-based
    # (IntersectingPairedEndAligner.cpp:266), so only each read's first
    # num_seeds valid positions are looked up (seed_phase
    # select_first_valid)
    S = min(cfg.num_seeds, S_all)
    ecfg = cfg.end_config()
    # both ends in one pipeline of 2B rows; the pooled caps span both ends
    reads_cat = torch.cat([reads0, reads1], dim=0)
    quals_cat = torch.cat([quals0, quals1], dim=0)
    B2 = 2 * B
    with stats.span("quals"):
        qlp_cat = phred_log_prob_device(
            torch.stack([quals_cat, quals_cat.flip(1)], dim=1))
    with stats.span("seed"):
        seeds = sg.seed_phase(reads_cat, sched_static, seed_len,
                              state["overflow"], genome_size, state,
                              select_first_valid=S, schedule_t=schedule)
        sel_pos = seeds["sel_pos"]                        # (2B, S)
        sched_tab = sg.row_select(schedule[None, :].expand(B2, S_all),
                                  sel_pos)
        wraps_tab = sg.row_select(wraps[None, :].expand(B2, S_all), sel_pos)
    with stats.span("budget"):
        cg = torch.where(seeds["found"][:, :, None], seeds["counts"], 0)
        budget = sg.budget_phase(seeds["valid"], cg, wraps_tab, ecfg)

    def from_cands(cands, score_scale=1):
        """Rowwise back half over the 2B rows; the dense pair-join view is
        the rowwise arrays themselves (W == cand_per_read)."""
        with stats.span("back_half"):
            u2, sc2, single_out = sg.rowwise_back_half(
                cands, budget, reads_cat, quals_cat, genome_p4,
                piece_starts, ecfg, seed_len, read_len, genome_size, S,
                qlp_both=qlp_cat, score_scale=score_scale)
        with stats.span("dense_topk"):
            dense = sg.dense_topk_rowwise(u2, sc2, ecfg.cand_per_read)
        score_overflow = single_out.pop("score_overflow")
        # scalar counters do not survive the per-end row slicing below
        for k in ("n_unique_candidates", "n_scored", "n_bucket2"):
            single_out.pop(k, None)
        return dict(dense=dense, single=single_out,
                    n_scored0=sc2["scored_ok"][:B].sum(dtype=I32),
                    n_scored1=sc2["scored_ok"][B:].sum(dtype=I32),
                    score_overflow=score_overflow,
                    truncated=cands["truncated"],
                    n_cand0=cands["live"][:B].sum(dtype=I32),
                    n_cand1=cands["live"][B:].sum(dtype=I32))

    big = sg.big_locations(genome_size)
    with stats.span("expand"):
        cands = sg.expand_phase(seeds, budget, sched_tab, state["overflow"],
                                ecfg, seed_len, read_len, ecfg.cand_per_read,
                                big=big)
    if (ecfg.overflow_tier and ecfg.cand_per_read > 0
            and stats.host_int("overflow_tier",
                               cands["truncated"].sum()) > 0):
        # candidate-overflow exact fallback: 4x re-expand when the narrow
        # tier truncated any hit list
        with stats.span("expand"):
            wide = sg.expand_phase(seeds, budget, sched_tab,
                                   state["overflow"], ecfg, seed_len,
                                   read_len, 4 * ecfg.cand_per_read, big=big)
        eo = from_cands(wide, score_scale=4)
    else:
        eo = from_cands(cands)

    # per-end views; pooled scalar counters (score_overflow, dense
    # overflow) are attributed to end 0 so the summed stats stay exact
    zero = torch.zeros((), dtype=I32, device=dev)
    ends = []
    for e in (0, 1):
        rows_e = slice(e * B, (e + 1) * B)
        dense_e = {k: (v[rows_e] if v.dim() >= 1 else v)
                   for k, v in eo["dense"].items()}
        dense_e["overflow"] = eo["dense"]["overflow"] if e == 0 else zero
        single_e = {k: v[rows_e] for k, v in eo["single"].items()}
        ends.append(dict(dense=dense_e, single=single_e,
                         popular=single_e["popular"],
                         truncated=eo["truncated"][rows_e],
                         n_lookups=seeds["found"][rows_e].sum(dtype=I32),
                         n_candidates=eo[f"n_cand{e}"],
                         n_scored=eo[f"n_scored{e}"],
                         score_overflow=(eo["score_overflow"] if e == 0
                                         else zero),
                         dense_overflow=dense_e["overflow"]))

    if cfg.mate_rescue and cfg.rescue_mates > 0:
        # both rescues read the PRE-append mate dense sets
        rrs = []
        for e, (reads_e, quals_e) in enumerate(((reads0, quals0),
                                                (reads1, quals1))):
            with stats.span("mate_rescue"):
                rrs.append(_mate_rescue_end(
                    ends[e]["dense"], ends[1 - e]["dense"], reads_e, quals_e,
                    genome_p4, piece_starts, ecfg, cfg, read_len,
                    genome_size, B, qlp_e=qlp_cat[e * B:(e + 1) * B]))
        for e in (0, 1):
            ends[e]["dense"] = _append_dense(ends[e]["dense"], rrs[e])
            ends[e]["n_rescued"] = rrs[e]["n_rescued"]
    else:
        for e in (0, 1):
            ends[e]["n_rescued"] = zero

    with stats.span("pair_join"):
        pr = pair_phase(ends[0]["dense"], ends[1]["dense"], cfg,
                        ends[0]["popular"], ends[1]["popular"],
                        trunc_total=(ends[0]["truncated"]
                                     + ends[1]["truncated"]))
    with stats.span("outputs"):
        out = dict(pair_found=pr["pair_found"], pair_score=pr["score"],
                   pair_mapq=pr["mapq"], pair_log_pall=pr["log_pall"])
        rows = torch.arange(B, device=dev)
        pf = pr["pair_found"]
        for e in (0, 1):
            d = ends[e]["dense"]
            s = ends[e]["single"]
            wsel = pr["w0"] if e == 0 else pr["w1"]
            e_mapq = pr[f"mapq{e}"]
            mapq = torch.where(pf, e_mapq, s["mapq"])
            result = torch.where(
                pf,
                torch.where(e_mapq >= MAPQ_LIMIT_FOR_SINGLE_HIT, SINGLE_HIT,
                            MULTIPLE_HITS).to(I32),
                s["result"])
            out[f"result{e}"] = result.to(I32)
            out[f"loc{e}"] = torch.where(pf, d["loc"][rows, wsel], s["loc"])
            out[f"dir{e}"] = torch.where(pf, d["dir"][rows, wsel],
                                         s["direction"])
            out[f"score{e}"] = torch.where(pf, d["score"][rows, wsel],
                                           s["score"])
            out[f"mapq{e}"] = torch.where(pf | (s["result"] != NOT_FOUND),
                                          mapq, 0).to(I32)
            out[f"truncated{e}"] = ends[e]["truncated"]
            # per-end device counters (BaseAligner.h:113-118 analog),
            # read by the pipeline's perf log
            for c in ("n_lookups", "n_candidates", "n_scored",
                      "score_overflow", "dense_overflow", "n_rescued"):
                out[f"{c}{e}"] = ends[e][c]
    sg.count_batch(2 * B, [eo["truncated"]])
    return out


class PairedAligner:
    """Host-facing paired-end wrapper: owns the device copies of the index
    (the same state SingleAligner builds) and runs the paired engine."""

    def __init__(self, index: GenomeIndex,
                 config: PairedAlignerConfig | None = None, device="cuda",
                 **overrides):
        self.index = index
        self.device = sg.resolve_device(device)
        cfg = config or PairedAlignerConfig(seed_len=index.seed_len)
        if overrides:
            cfg = PairedAlignerConfig(**{**cfg.__dict__, **overrides})
        env_tm = os.environ.get("SNAP_TPU_TRUNC_MASS")
        if env_tm is not None and "truncation_mass" not in overrides:
            cfg = PairedAlignerConfig(**{**cfg.__dict__,
                                         "truncation_mass": env_tm == "1"})
        self.cfg = cfg
        self.state = sg.index_state(index, self.device)
        self.genome_size = self.state["genome_size"]

    def align_batch_device(self, reads0, quals0, reads1, quals1):
        """Device to device: (B, L) uint8 tensors per end in, a dict of
        tensors on self.device out."""
        B, L = reads0.shape
        positions, wraps = seed_position_schedule(L, self.index.seed_len)
        S = min(self.cfg.max_seed_slots, len(positions))
        positions, wraps = positions[:S], wraps[:S]
        dev = self.device
        return _paired_align_batch(
            reads0.to(dev), quals0.to(dev), reads1.to(dev), quals1.to(dev),
            self.state, sg.schedule_on(positions, dev),
            sg.schedule_on(wraps, dev),
            cfg=self.cfg, seed_len=self.index.seed_len, read_len=L,
            sched_static=tuple(int(x) for x in positions))

    def align_batch(self, reads0, quals0, reads1, quals1) -> dict:
        """numpy (B, L) uint8 codes and ASCII qualities per end in, a dict
        of numpy arrays out."""
        out = self.align_batch_device(
            *(torch.from_numpy(np.asarray(a))
              for a in (reads0, quals0, reads1, quals1)))
        return sg.fetch(out)
