"""Batched single-end aligner on the card: the port of
snap_rnaseq_tpu/models/single.py (the analog of SNAPLib/BaseAligner).

The reference engine is a sequential per-read loop: look up seeds one at a
time, insert candidates into 48-wide weight-list elements, score the
highest-weight element with two LV calls, stop early when no unseen
location can win (BaseAligner.cpp:510-1399).  Here, as in the JAX engine,
a batch of reads goes through phases over whole tensors:

  seed_phase      pack + cuckoo-look-up every scheduled seed at once
  budget_phase    seed budget / popularity / lowest-possible-score tables
  expand_phase    every hit -> candidate slot (rare-seed-first, stable)
  _aggregate_rows rowwise (dir, loc) sort + segmented element/candidate
                  reductions
  rowwise_score_phase  bit-parallel whole-read prefilter (K2), the anchored
                  substitution closed form, LV + backtrace (K1) on the rest
  rowwise_replay_phase vectorized replay of the early-exit / score-limit /
                  merge logic; winner pick + MAPQ

The JAX engine's flat back half is here too, for `trace` and the parity
tests: aggregate_phase -> compact_phase -> filtered_score_phase (K4's
whole-read prefilter, the substitution closed form, K1 in three distance
buckets) -> replay_phase over (C,) candidate arrays.

The JAX engine's documented deviations from the reference (its module
docstring) are reproduced, not fixed.  u32 quantities (locations of
genomes past 2^31, hash values) ride in int32 tensors (ops/u32.py).

Device rule: SingleAligner runs on the device it is given (default
"cuda") and raises if that device is absent; the kernels it reaches are
chosen by tensor device inside ops/.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (DEFAULT_EXTRA_SEARCH_DEPTH, INVALID_GENOME_LOCATION,
                         MAX_K, MAX_MERGE_DIST, MAPQ_LIMIT_FOR_SINGLE_HIT,
                         SINGLE_DEFAULTS, SNP_PROB)
from ..index.hash_index import GenomeIndex, cuckoo_layout_for
from ..ops import lookup as lk
from ..ops import u32
from ..ops.bitpar import bitpar_distance, bitpar_distance_words
from ..ops.genome_gather import gather_windows, pack_genome_4bit
from ..ops.lv import NEG_INF, lv_distance, phred_log_prob_device
from ..ops.rowscan import seg_broadcast
from ..utils.seed_sequencer import seed_position_schedule

# result codes (analog of AlignmentResult, Aligner.h)
NOT_FOUND, SINGLE_HIT, MULTIPLE_HITS = 0, 1, 2

LOG_ONE_MINUS_SNP = float(np.log1p(-SNP_PROB))
BIG = 0x7FFFFFF0

_COMP_LUT = np.array([3, 2, 1, 0, 4, 5, 255, 255], np.uint8)
I32 = torch.int32


@dataclass(frozen=True)
class SingleAlignerConfig:
    seed_len: int
    max_k: int = SINGLE_DEFAULTS["max_dist"]
    num_seeds: int = SINGLE_DEFAULTS["num_seeds"]       # -n: applied-seed budget
    max_hits: int = SINGLE_DEFAULTS["max_hits"]         # -h: popularity cutoff
    extra_search_depth: int = DEFAULT_EXTRA_SEARCH_DEPTH
    cand_per_read: int = 128                            # static candidate slots
    # exact fallback: re-expand at 4x when the narrow candidate tier
    # truncates (repeat-dense batches); False = fixed narrow width
    overflow_tier: bool = False
    max_seed_slots: int = 48                            # schedule positions looked up
    max_hits_to_get: int = 0                            # multi-hit output size
    seed_coverage: float = 0.0      # -sc: num_seeds = cov*readLen/seedLen
    explore_popular: bool = False   # -x: use (capped) hits of popular seeds
    stop_on_first: bool = False     # -f: filtering mode, any hit -> SingleHit
    # LV survivors of the whole-read prefilter per read (tiny tier = 1/4
    # of it per read, the rest pooled); 0 scores every candidate slot
    score_budget_per_read: int = 16
    # unique candidates kept after aggregation by the flat back half's
    # live-first compaction (compact_phase), per read pooled; the rowwise
    # engine does not read it
    compact_per_read: int = 32
    # True = the paired engine's seed budget (one unit per valid position,
    # IntersectingPairedEndAligner.cpp:266); False = the single-end
    # BaseAligner's (each applied (seed, direction), BaseAligner.cpp:336)
    seed_budget_per_position: bool = False

    @property
    def e_max(self) -> int:
        return min(MAX_K, self.max_k + self.extra_search_depth)

    def resolve_for_read_len(self, read_len: int) -> "SingleAlignerConfig":
        """-sc: seed budget proportional to read length."""
        if self.seed_coverage <= 0:
            return self
        n = max(1, int(self.seed_coverage * read_len / self.seed_len))
        return SingleAlignerConfig(**{**self.__dict__,
                                      "num_seeds": n, "seed_coverage": 0.0})


# ----------------------------------------------------------------------
# device handling and the index state
# ----------------------------------------------------------------------

def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  No fallback: asking for CUDA
    where there is none raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch versions on the CPU")
    return dev


def index_state_from_numpy(arrays: dict, cuckoo: dict, device) -> dict:
    """The numpy arrays an index ships to the device -> the port's tensors.

    arrays: GenomeIndex.device_arrays() (needs overflow, genome_size and
    genome_codes, or a pre-packed genome_p4) plus piece_starts (the
    genome's piece_offsets); cuckoo: cuckoo_layout_for(index).  u32 arrays
    become int32 tensors with the same bits, so both engines can align
    against the very same tables."""
    dev = torch.device(device)
    p4 = arrays.get("genome_p4")
    if p4 is None:
        p4 = pack_genome_4bit(np.asarray(arrays["genome_codes"]))
    state = dict(
        overflow=u32.from_numpy(arrays["overflow"], dev),
        genome_p4=u32.from_numpy(p4, dev),
        piece_starts=torch.from_numpy(
            np.asarray(arrays["piece_starts"]).astype(np.int32)).to(dev),
        genome_size=int(arrays["genome_size"]))
    for k in ("ck_buckets", "ck_buckets2", "ck_stash"):
        state[k] = u32.from_numpy(cuckoo[k], dev)
    return state


# ----------------------------------------------------------------------
# small helpers
# ----------------------------------------------------------------------

def row_select(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis(table, idx, axis=1)."""
    return torch.gather(table, 1, idx.long())


def first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along `dim` (0 where none) — argmax of a
    boolean with first-index ties, written out."""
    n = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = n
    idx = torch.arange(n, dtype=I32, device=mask.device).reshape(shape)
    first = torch.where(mask, idx, n).amin(dim=dim)
    return torch.where(first < n, first, 0).to(I32)


def big_locations(genome_size: int) -> bool:
    """Does this genome need uint32 (not int31) location order?"""
    return genome_size > (1 << 31) - (1 << 26)


def _loc_ord(x: torch.Tensor) -> torch.Tensor:
    """Monotone uint32 -> int32 order map (sign-bit flip)."""
    return u32.ord32(x)


def piece_index_of(piece_starts: torch.Tensor, loc: torch.Tensor,
                   big: bool = False) -> torch.Tensor:
    """searchsorted(piece_starts, loc, 'right') - 1, clipped.

    The JAX engine writes this as a broadcast compare-and-sum, which XLA
    fuses; eager torch would materialize the (C, n_pieces) compare (and an
    int32 copy for the sum), 50 GB at a transcriptome's 5,000 pieces and
    2 M candidates.  A binary search gives the same index (the piece
    starts ascend, also under the u32 order map)."""
    n = piece_starts.shape[0]
    ps, lq = (piece_starts, loc) if not big else \
        (_loc_ord(piece_starts), _loc_ord(loc))
    idx = torch.searchsorted(ps.contiguous(), lq.contiguous(),
                             right=True).to(I32) - 1
    return idx.clamp(0, n - 1)


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x.to(I32), dim=dim, dtype=I32)


def _next_start(piece_starts, pidx, genome_size):
    n = piece_starts.shape[0]
    nxt = piece_starts[torch.clamp(pidx + 1, max=n - 1).long()]
    return torch.where(pidx + 1 < n, nxt, u32.const(genome_size))


def _crosses(loc, next_start, genome_size, want):
    """loc + want > min(next_start, genome_size), all uint32."""
    return u32.ult(u32.umin(next_start, _full_like(next_start, genome_size)),
                   loc + want)


def _full_like(x, v):
    return torch.full_like(x, u32.const(v))


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def seed_phase(reads, schedule, seed_len, overflow, genome_size, cuckoo,
               select_first_valid: int = 0):
    """Pack + look up every scheduled seed (cuckoo layout).

    select_first_valid=N: look up only each read's first N VALID schedule
    positions (the paired engine's budget, one unit per valid position,
    never reaches past them); out["sel_pos"] (B, N) holds the selected
    position indices, 0 where a read has fewer valid positions."""
    packed = lk.pack_seeds(reads, schedule, seed_len)
    sel_pos = None
    if select_first_valid:
        valid_all = packed["valid"]
        v = valid_all.to(I32)
        rank = _cumsum(v, 1) - v
        match = valid_all[:, None, :] & (
            rank[:, None, :] == torch.arange(
                select_first_valid, dtype=I32,
                device=reads.device)[None, :, None])
        sel_pos = first_true(match, 2)                       # (B, N)
        take = lambda x: row_select(x, sel_pos)
        packed = dict(lo_f=take(packed["lo_f"]), hi_f=take(packed["hi_f"]),
                      lo_r=take(packed["lo_r"]), hi_r=take(packed["hi_r"]),
                      valid=match.any(dim=2),
                      n_hi_bits=packed["n_hi_bits"])
    found, fwd_val, rc_val = lk.lookup_seeds_cuckoo(
        packed, cuckoo["ck_buckets"], cuckoo["ck_buckets2"],
        cuckoo["ck_stash"])
    cnt_f, base_f = lk.expand_counts(fwd_val, overflow, genome_size)
    cnt_r, base_r = lk.expand_counts(rc_val, overflow, genome_size)
    out = dict(valid=packed["valid"], found=found,
               counts=torch.stack([cnt_f, cnt_r], dim=2),   # (B,S,2)
               bases=torch.stack([base_f, base_r], dim=2),
               vals=torch.stack([fwd_val, rc_val], dim=2))
    if sel_pos is not None:
        out["sel_pos"] = sel_pos
    return out


def budget_phase(valid, counts_global, wraps, cfg: SingleAlignerConfig):
    """Seed budget, popularity skip and lowest-possible-score tables
    (BaseAligner.cpp:686-914 and :1053-1061)."""
    B, S = valid.shape
    popular = (counts_global > cfg.max_hits) & valid[:, :, None]
    if cfg.explore_popular:
        applied = valid[:, :, None] & (counts_global > 0)
    else:
        applied = valid[:, :, None] & ~popular                # (B,S,2)
    if cfg.seed_budget_per_position:
        lookups = valid.to(I32)
        cum_before = _cumsum(lookups, 1) - lookups
        active_pos = (cum_before < cfg.num_seeds) & valid
    else:
        applied_per_pos = applied.to(I32).sum(dim=2, dtype=I32)
        cum_before = _cumsum(applied_per_pos, 1) - applied_per_pos
        active_pos = cum_before < cfg.num_seeds
    applied_act = applied & active_pos[:, :, None]
    n_applied_after = _cumsum(applied_act, 1)
    most = ((wraps + 1).to(I32)[:, :, None] if wraps.dim() == 2
            else (wraps + 1).to(I32)[None, :, None])
    lp_after = torch.cummax(torch.div(n_applied_after, most,
                                      rounding_mode="floor"), dim=1).values
    lp_pre = torch.cat([torch.zeros((B, 1, 2), dtype=I32,
                                    device=valid.device),
                        lp_after[:, :-1, :]], dim=1)
    return dict(popular=popular, applied_act=applied_act,
                active_pos=active_pos, lp_after=lp_after, lp_pre=lp_pre)


def expand_phase(seeds, budget, schedule, overflow, cfg, seed_len, read_len,
                 cand_slots, big: bool = False):
    """Hits -> candidate slots: (loc, dir, order, seedOffset, round,
    lowest-possible bound), filled rare-seed-first (a STABLE sort of the
    (seed, dir) groups by hit count)."""
    counts, bases, vals = seeds["counts"], seeds["bases"], seeds["vals"]
    B, S, _ = counts.shape
    CPR = cand_slots
    dev = counts.device

    used = torch.where(budget["applied_act"] & seeds["found"][:, :, None],
                       counts, 0)
    if cfg.explore_popular:
        used = used.clamp_max(cfg.max_hits)
    used2 = used.reshape(B, S * 2)
    used_sorted, perm = torch.sort(used2, dim=1, stable=True)
    perm = perm.to(I32)
    cum = _cumsum(used_sorted, 1)
    total = cum[:, -1]
    slots = torch.arange(CPR, dtype=I32, device=dev)
    # #{j: cum[j] <= slot}
    spos = torch.searchsorted(cum, slots.expand(B, CPR).contiguous(),
                              right=True).to(I32)
    spos = spos.clamp_max(S * 2 - 1)
    group = row_select(perm, spos)
    cand_live = slots[None, :] < torch.clamp(total, max=CPR)[:, None]
    n_truncated = (total - CPR).clamp_min(0)

    prev_cum = torch.cat([torch.zeros((B, 1), dtype=I32, device=dev),
                          cum[:, :-1]], dim=1)
    within = slots[None, :] - row_select(prev_cum, spos)

    s_idx = torch.div(group, 2, rounding_mode="floor")
    dir_idx = group % 2
    g_base = row_select(bases.reshape(B, S * 2), group)
    g_val = row_select(vals.reshape(B, S * 2), group)
    hit = lk.gather_hit(within, None, g_base, g_val, overflow)

    pos_at = (row_select(schedule, s_idx) if schedule.dim() == 2
              else schedule[s_idx.long()])
    offset = torch.where(dir_idx == 0, pos_at, read_len - seed_len - pos_at)
    cand_loc = hit - offset
    cand_live = cand_live & u32.ule(offset, hit)
    order = (group << 16) | within.clamp_max(0xFFFF)
    lp_at = row_select(budget["lp_pre"].reshape(B, S * 2), group)

    read_id = torch.arange(B, dtype=I32, device=dev)[:, None].expand(B, CPR)
    dead = -16 if big else BIG
    return dict(read=read_id, dir=dir_idx,
                loc=torch.where(cand_live, cand_loc, dead),
                order=order, offset=offset, round=s_idx, lp=lp_at,
                live=cand_live, truncated=n_truncated)


def _aggregate_rows(c, big: bool = False):
    """Rowwise (dir, loc) sort + segmented reductions into unique
    candidates and 48-wide element stats; returns (rows, W) arrays.

    The JAX engine sorts a packed u32 key without stability; every output
    is either a key or a segment-broadcast reduction, so any tie order gives
    the same result.  torch cannot sort uint32, so the key here is the
    int64 dir << 32 | u32(loc), sorted stably, and the payloads are
    gathered by the permutation."""
    dir_, loc = c["dir"], c["loc"]
    key = (dir_.to(torch.int64) << 32) | u32.to_i64(loc)
    _, perm = torch.sort(key, dim=1, stable=True)
    take = lambda x: torch.gather(x, 1, perm)
    d_, l_ = take(dir_), take(loc)
    o_, live_, lp_, off_ = (take(c["order"]), take(c["live"]),
                            take(c["lp"]), take(c["offset"]))
    rows, W = d_.shape

    def differs(x):
        prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
        return x != prev

    col0 = torch.zeros((rows, W), dtype=torch.bool, device=d_.device)
    col0[:, 0] = True
    # 48-bucket ids on the unsigned location (big genomes included)
    l_u = u32.to_i64(l_)
    elem_loc = l_u - l_u % MAX_MERGE_DIST
    diff_d = col0 | differs(d_)
    elem_b = diff_d | differs(elem_loc)
    cand_b = diff_d | differs(l_)

    elem_weight = seg_broadcast(live_.to(I32), elem_b, torch.add,
                                0).clamp_max(63)
    elem_lp = seg_broadcast(torch.where(live_, lp_, BIG), elem_b,
                            torch.minimum, BIG)
    cand_first_order = seg_broadcast(torch.where(live_, o_, BIG), cand_b,
                                     torch.minimum, BIG)
    cand_first_round = torch.where(cand_first_order < BIG,
                                   cand_first_order >> 17, BIG)
    # seedOffset of the LAST hit on this location: a u32 max of
    # ((order << 10) | offset) + 1, wrapping at 32 bits as the JAX engine's
    # uint32 arithmetic does (order << 10 passes 2^32 once the group id
    # reaches 64)
    m32 = u32.MASK32
    packed_last = ((((o_.to(torch.int64) << 10) & m32)
                    | off_.to(torch.int64)) + 1) & m32
    cand_last = seg_broadcast(torch.where(live_, packed_last, 0), cand_b,
                              torch.maximum, 0)
    off_out = torch.where(cand_last > 0, (cand_last - 1) & 0x3FF,
                          0).to(I32)
    return dict(dir=d_, loc=l_, off=off_out, order=cand_first_order,
                round=cand_first_round, weight=elem_weight, lp=elem_lp,
                live=cand_b & live_)


def score_phase(u, reads, quals, genome_p4, piece_starts, cfg, seed_len,
                read_len, genome_size, band: int | None = None,
                window: torch.Tensor | None = None,
                qlp_both: torch.Tensor | None = None):
    """Two LV problems per unique candidate in ONE kernel call (rows
    [0, C) the forward tail, [C, 2C) the reversed head), free-prefix
    formulation, log-space probabilities (BaseAligner.cpp:1150-1260 with
    the piece-boundary text clipping and the (1-SNP)^seedLen factor)."""
    e_max = cfg.e_max if band is None else band
    gate = cfg.e_max
    M = cfg.e_max
    C = u["read"].shape[0]
    dev = reads.device
    comp = torch.from_numpy(_COMP_LUT).to(dev)
    rc_reads = comp[reads.flip(1).long()]
    read_both = torch.stack([reads, rc_reads], dim=1)
    if qlp_both is None:
        qual_both = torch.stack([quals, quals.flip(1)], dim=1)
    else:
        qual_both = qlp_both

    live = u["live"]
    so = torch.where(live, u["off"], 0)
    tail = so + seed_len
    loc_c = torch.where(live, u["loc"], 0)
    big = big_locations(genome_size)

    pidx = piece_index_of(piece_starts, loc_c, big=big)
    next_start = _next_start(piece_starts, pidx, genome_size)
    want = read_len + M
    crosses = _crosses(loc_c, next_start, genome_size, want)
    gs = _full_like(loc_c, genome_size)
    end_off = torch.where(u32.ule(gs, loc_c + want), gs, next_start)
    text_len = torch.where(crosses, (end_off - loc_c) - 1, want).to(I32)
    data_ok = text_len >= read_len - M

    ridx, didx = u["read"].long(), u["dir"].long()
    sel = read_both[ridx, didx]
    selq = qual_both[ridx, didx]
    if window is None:
        window = gather_windows(genome_p4, loc_c - M,
                                width=read_len + 2 * M, big=big)
    fwd_text = window[:, M:]
    bwd_text = window[:, :read_len + M].flip(1)
    plen_full = torch.full((2 * C,), read_len, dtype=I32, device=dev)
    kvec = torch.where(live & data_ok, e_max, 0).to(I32)

    rsel = sel.flip(1)
    rselq = selq.flip(1)
    # genome-start guard in uint32 (big-genome locations wrap int32)
    bwd_tlen = (read_len - so) + u32.umin(so + M, loc_c + so)
    r = lv_distance(
        torch.cat([sel, rsel], dim=0), plen_full,
        torch.cat([fwd_text, bwd_text], dim=0),
        torch.cat([text_len, bwd_tlen], dim=0),
        torch.cat([kvec, kvec], dim=0),
        torch.cat([selq, rselq], dim=0),
        free=torch.cat([tail, read_len - so], dim=0),
        e_max=e_max)
    d1, d2 = r.distance[:C], r.distance[C:]
    lp1, lp2 = r.log_prob[:C], r.log_prob[C:]
    net2 = r.net_indel[C:]

    scored_ok = live & data_ok & (d1 >= 0) & (d2 >= 0) & (d1 + d2 <= gate)
    score = torch.where(scored_ok, d1 + d2, BIG).to(I32)
    logp = torch.where(scored_ok, lp1 + lp2 + seed_len * LOG_ONE_MINUS_SNP,
                       NEG_INF)
    loc_adj = torch.where(scored_ok, loc_c + net2, loc_c)
    return dict(score=score, logp=logp, loc_adj=loc_adj, scored_ok=scored_ok)


def stable_partition_indices(mask: torch.Tensor, K: int) -> torch.Tensor:
    """First K indices of a stable true-first partition."""
    C = mask.shape[0]
    mask_i = mask.to(I32)
    pos_true = _cumsum(mask_i, 0) - 1
    n_true = pos_true[-1] + 1
    pos_false = n_true + _cumsum(1 - mask_i, 0) - 1
    dest = torch.where(mask, pos_true, pos_false).long()
    inv = torch.zeros(C, dtype=I32, device=mask.device)
    inv[dest] = torch.arange(C, dtype=I32, device=mask.device)
    return inv[:K]


# ----------------------------------------------------------------------
# flat back half (the trace tool's phases)
# ----------------------------------------------------------------------
# The JAX engine's older back half over flat (C,) candidate arrays:
# aggregate_phase -> compact_phase -> filtered_score_phase -> replay_phase.
# The engines run the rowwise back half below; the flat phases serve
# `trace` (models/trace.py) and parity tests.  Their jax.ops.segment_*
# reductions become the helpers here: min and max as scatter_reduce,
# whose result does not depend on the order of the scatter; float sums
# in a fixed order (no atomics), so a card's sums repeat run to run.

def _segment_min(vals: torch.Tensor, seg: torch.Tensor, n: int):
    """jax.ops.segment_min: an empty segment holds the identity
    (int32 max, or +inf)."""
    ident = float("inf") if vals.is_floating_point() else \
        torch.iinfo(vals.dtype).max
    out = torch.full((n,), ident, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg.long(), vals, reduce="amin")


def _segment_max(vals: torch.Tensor, seg: torch.Tensor, n: int):
    """jax.ops.segment_max: an empty segment holds the identity (-inf, or
    int32 min)."""
    ident = float("-inf") if vals.is_floating_point() else \
        torch.iinfo(vals.dtype).min
    out = torch.full((n,), ident, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg.long(), vals, reduce="amax")


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int):
    """jax.ops.segment_sum.  Integers add exactly in any order.  Floats are
    laid out as an (n, longest segment) matrix, each segment's values in
    index order (a stable sort by segment), and summed along its rows: a
    fixed order, where an atomic scatter-add's order would change from run
    to run."""
    if not vals.is_floating_point():
        out = torch.zeros((n,), dtype=vals.dtype, device=vals.device)
        return out.index_add_(0, seg.long(), vals)
    seg_s, perm = torch.sort(seg.long(), stable=True)
    counts = torch.bincount(seg_s, minlength=n)
    starts = _cumsum(counts, 0) - counts.to(I32)
    col = torch.arange(seg_s.shape[0], device=vals.device) - starts[seg_s]
    width = max(int(counts.max()), 1)
    dense = torch.zeros((n, width), dtype=vals.dtype, device=vals.device)
    dense[seg_s, col] = vals[perm]
    return dense.sum(dim=1)


def _lexsort(keys) -> torch.Tensor:
    """jnp.lexsort: the LAST key is the primary one; stable sorts applied
    from the first key to the last."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        _, p = torch.sort(k[perm], stable=True)
        perm = perm[p]
    return perm


def aggregate_phase(c):
    """_aggregate_rows flattened to (C,) arrays, with a `read` column."""
    u2 = _aggregate_rows(c)
    rows, W = u2["dir"].shape
    out = {k: v.reshape(rows * W) for k, v in u2.items()}
    out["read"] = torch.arange(rows, dtype=I32, device=u2["dir"].device)[
        :, None].expand(rows, W).reshape(rows * W)
    return out


def compact_phase(u, B, cfg):
    """Live-first stable compaction of the aggregated candidates to
    B * compact_per_read slots: the live prefix keeps its (read, dir, loc)
    order, so replay_phase sees the same cluster gaps.  Live candidates
    past the pooled budget are counted (the reference's candidate-pool
    cap)."""
    C = u["read"].shape[0]
    CB = min(B * cfg.compact_per_read, C)
    take = stable_partition_indices(u["live"], CB).long()
    out = {k: v[take] for k, v in u.items()}
    overflow = (u["live"].sum(dtype=I32) - CB).clamp_min(0)
    return out, overflow


def filtered_score_phase(u, reads, quals, genome_p4, piece_starts, cfg,
                         seed_len, read_len, genome_size, B,
                         qlp_both: torch.Tensor | None = None):
    """Two-stage scoring of flat candidates: whole-read bit-parallel
    distances for every slot (K4 on a card), the anchored substitution
    closed form, then LV + backtrace (K1) on the survivors in three
    distance buckets with pooled budgets.  Exactness, the accepted
    equal-cost-indel deviation and the tier budgets are the JAX engine's
    (its filtered_score_phase).  Each bucket's tier is picked on the host
    from its survivor count; every tier gives the same result, and the
    survivors past the largest tier are counted in score_overflow."""
    e_max = cfg.e_max
    C = u["read"].shape[0]
    dev = reads.device
    big = big_locations(genome_size)
    live = u["live"]
    loc_c = torch.where(live, u["loc"], 0)

    comp = torch.from_numpy(_COMP_LUT).to(dev)
    rc_reads = comp[reads.flip(1).long()]
    read_both = torch.stack([reads, rc_reads], dim=1)
    ridx, didx = u["read"].long(), u["dir"].long()
    sel = read_both[ridx, didx]                               # (C, L)

    # one window per candidate serves the prefilter and both LV slices
    M = cfg.e_max
    window = gather_windows(genome_p4, loc_c - M, width=read_len + 2 * M,
                            big=big)
    want = read_len + e_max
    t_len = torch.full((C,), want, dtype=I32, device=dev)
    wdist = bitpar_distance(sel, window[:, M:M + want], t_len, P=read_len)

    E0 = min(3, e_max)
    E1 = min(7, e_max)
    score = torch.full((C,), BIG, dtype=I32, device=dev)
    logp = torch.full((C,), NEG_INF, dtype=torch.float32, device=dev)
    loc_adj = u["loc"]
    scored_ok = torch.zeros((C,), dtype=torch.bool, device=dev)

    if qlp_both is None:
        qlp_both = phred_log_prob_device(
            torch.stack([quals, quals.flip(1)], dim=1))

    fast = torch.zeros((C,), dtype=torch.bool, device=dev)
    if os.environ.get("SNAP_TPU_FAST_SUB", "1") != "0":
        pidx = piece_index_of(piece_starts, loc_c, big=big)
        next_start = _next_start(piece_starts, pidx, genome_size)
        crosses = _crosses(loc_c, next_start, genome_size, read_len + M)
        mm = sel != window[:, M:M + read_len]
        ham = mm.sum(dim=1, dtype=I32)
        fast = live & ~crosses & (wdist <= e_max) & (ham == wdist)
        logp_f = (torch.where(mm, qlp_both[ridx, didx], 0.0).sum(dim=1)
                  + (read_len - ham).to(torch.float32) * LOG_ONE_MINUS_SNP)
        score = torch.where(fast, ham, score)
        logp = torch.where(fast, logp_f, logp)
        scored_ok = fast

    keep0 = live & ~fast & (wdist <= E0)
    keep1 = live & ~fast & (wdist > E0) & (wdist <= E1)
    keep2 = live & ~fast & (wdist > E1) & (wdist <= e_max)
    per_read = max(cfg.score_budget_per_read, cfg.max_hits_to_get)

    def run_bucket(keep, SB, band, st):
        chosen = stable_partition_indices(keep, SB).long()
        u_sub = {k: u[k][chosen] for k in ("read", "dir", "loc", "off")}
        lv_live = live[chosen] & keep[chosen]
        u_sub["live"] = lv_live
        sc_sub = score_phase(u_sub, reads, quals, genome_p4, piece_starts,
                             cfg, seed_len, read_len, genome_size, band=band,
                             window=window[chosen], qlp_both=qlp_both)
        out = []
        for dst, key in zip(st, ("score", "logp", "loc_adj", "scored_ok")):
            dst = dst.clone()
            dst[chosen] = torch.where(lv_live, sc_sub[key], dst[chosen])
            out.append(dst)
        return tuple(out)

    def tier(n, tiers):
        """The smallest tier that holds n survivors, else the last."""
        return next((t for t in tiers[:-1] if n <= t), tiers[-1])

    # bucket 0: up to three tiers (tiny, small, big)
    SB_big = min(B * per_read, C)
    SB_small = min(B * max(2, per_read // 4), SB_big)
    SB_tiny = min(B, SB_small)
    n0 = int(keep0.sum())
    tiers = [SB_big]
    if SB_small < SB_big:
        tiers = ([SB_tiny] if SB_tiny < SB_small else []) + [SB_small, SB_big]
    st = run_bucket(keep0, tier(n0, tiers), E0,
                    (score, logp, loc_adj, scored_ok))
    overflow = max(n0 - SB_big, 0)

    # bucket 1 (two tiers) and bucket 2 (one pooled cap); the JAX engine
    # skips both when e_max <= 7
    for keep, hi in ((keep1, E1), (keep2, e_max)):
        if hi <= E0 or (hi == e_max and e_max <= E1):
            continue
        SBt = min(max(B // 2, 256), C)
        nk = int(keep.sum())
        if hi == E1:
            SBt_big = min(B * max(2, per_read // 4), C)
            st = run_bucket(keep, tier(nk, [SBt, SBt_big])
                            if SBt < SBt_big else SBt_big, hi, st)
            overflow += max(nk - SBt_big, 0)
            continue
        st = run_bucket(keep, SBt, hi, st)
        overflow += max(nk - SBt, 0)

    score, logp, loc_adj, scored_ok = st
    return dict(score=score, logp=logp, loc_adj=loc_adj, scored_ok=scored_ok,
                score_overflow=torch.tensor(overflow, dtype=I32, device=dev),
                n_bucket2=keep2.sum(dtype=I32), n_fast=fast.sum(dtype=I32))


def replay_phase(u, sc, budget, reads, B, S, cfg: SingleAlignerConfig):
    """Replay of the sequential engine's selection over flat scored
    candidates (the JAX engine's replay_phase): segment reductions by read,
    by (read, round) and by merge cluster."""
    maxK, extra = cfg.max_k, cfg.extra_search_depth
    C = u["read"].shape[0]
    dev = reads.device
    score, logp, loc_adj = sc["score"], sc["logp"], sc["loc_adj"]
    scored_ok = sc["scored_ok"]
    u_read, u_dir, u_round, u_order, u_lp = (
        u["read"], u["dir"], u["round"], u["order"], u["lp"])
    ridx = u_read.long()
    f3e12 = torch.tensor(3e12, dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    slots = torch.arange(C, dtype=I32, device=dev)

    n_count = (reads == 4).sum(dim=1, dtype=I32)

    # stopping round R*: lowest-possible bound exceeds the evolving limit
    round_of = u_round.clamp(0, S - 1)
    best_by_round = _segment_min(torch.where(scored_ok, score, BIG),
                                 u_read * S + round_of, B * S).reshape(B, S)
    best_upto = torch.cummin(best_by_round, dim=1).values
    limit_r = best_upto.clamp_max(maxK) + extra
    lp_after = budget["lp_after"]
    stop_r = torch.minimum(lp_after[:, :, 0], lp_after[:, :, 1]) > limit_r
    r_star = torch.where(stop_r.any(dim=1), first_true(stop_r, 1), S - 1)

    in_play = scored_ok & (u_round <= r_star[ridx])
    score_f = torch.where(in_play, score, BIG)

    # winner per read by (score asc, logp desc, order asc, index asc)
    comp = torch.where(score_f < BIG,
                       score_f.to(torch.float32) * 1e6
                       - logp.clamp(-1e5, 0), f3e12)
    m1 = _segment_min(comp, u_read, B)
    cand1 = comp <= m1[ridx]
    m2 = _segment_min(torch.where(cand1, u_order, BIG), u_read, B)
    cand2 = cand1 & (u_order == m2[ridx])
    winner_slot = _segment_min(torch.where(cand2, slots, BIG), u_read, B)
    has_best = _segment_min(score_f, u_read, B) < BIG
    winner_slot = torch.where(has_best, winner_slot, 0)
    ws = winner_slot.long()
    best_score = score_f[ws]
    best_loc = loc_adj[ws]
    best_dir = u_dir[ws]
    best_logp = logp[ws]

    final_limit = (best_score.clamp_max(maxK) + extra).clamp_max(cfg.e_max)
    in_prob = in_play & (score <= final_limit[ridx]) \
        & (u_lp <= final_limit[ridx])

    gap_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         (u_read[1:] != u_read[:-1])
                         | (u_dir[1:] != u_dir[:-1])
                         | (loc_adj[1:] - loc_adj[:-1] > MAX_MERGE_DIST)])
    clus_id = _cumsum(gap_new, 0) - 1
    cidx = clus_id.long()
    clus_key = torch.where(in_prob,
                           score.to(torch.float32) * 1e6
                           - logp.clamp(-1e5, 0), f3e12)
    clus_min = _segment_min(clus_key, clus_id, C)
    is_clus_best = in_prob & (clus_key <= clus_min[cidx])
    cum_best = _cumsum(is_clus_best, 0)
    first_best_rank = _segment_min(torch.where(is_clus_best, cum_best, BIG),
                                   clus_id, C)
    is_clus_best = is_clus_best & (cum_best == first_best_rank[cidx])

    clus_logp = torch.where(is_clus_best, logp, neg_inf)
    read_max = _segment_max(clus_logp, u_read, B).clamp_min(-1e29)
    psum = _segment_sum(
        torch.where(is_clus_best, torch.exp(clus_logp - read_max[ridx]),
                    0.0), u_read, B)
    log_pall = torch.where(psum > 0, torch.log(psum) + read_max, neg_inf)

    not_best = is_clus_best & (slots != winner_slot[ridx])
    psum_o = _segment_sum(
        torch.where(not_best,
                    torch.exp(torch.where(not_best, logp, neg_inf)
                              - read_max[ridx]), 0.0), u_read, B)
    log_pother = torch.where(psum_o > 0, torch.log(psum_o) + read_max,
                             neg_inf)

    s_ar = torch.arange(S, dtype=I32, device=dev)
    popular_n = (budget["popular"] & budget["active_pos"][:, :, None]
                 & (s_ar[None, :, None] <= r_star[:, None, None])
                 ).sum(dim=(1, 2), dtype=I32)

    mapq = _compute_mapq(log_pall, best_logp, log_pother, best_score,
                         popular_n)

    applied_any = budget["applied_act"].any(dim=2).any(dim=1)
    aligned = has_best & (best_score <= maxK)
    unaligned = torch.where(applied_any, NOT_FOUND, MULTIPLE_HITS)
    if cfg.stop_on_first:
        result = torch.where(aligned, SINGLE_HIT, unaligned)
    else:
        result = torch.where(
            aligned,
            torch.where(mapq >= MAPQ_LIMIT_FOR_SINGLE_HIT, SINGLE_HIT,
                        MULTIPLE_HITS),
            unaligned)
    result = torch.where(n_count > maxK, NOT_FOUND, result).to(I32)
    ok = aligned & (n_count <= maxK)
    out = dict(result=result,
               loc=torch.where(ok, best_loc, -1).to(I32),
               direction=best_dir,
               score=torch.where(has_best, best_score, -1).to(I32),
               mapq=torch.where(ok, mapq, 0).to(I32),
               log_pbest=best_logp, log_pall=log_pall,
               popular=popular_n)
    if cfg.max_hits_to_get > 0:
        out.update(_multi_hits(u_read, loc_adj, u_dir, score, u_order,
                               in_play, B, cfg.max_hits_to_get, cfg.e_max))
    return out


def _multi_hits(u_read, loc_adj, u_dir, score, u_order, in_play, B,
                max_get, e_max):
    """fillHitsFound analog (BaseAligner.cpp:940-975) over flat candidates:
    up to max_get hits per read, scores within [firstDist, firstDist+4),
    in (score, order) order."""
    dev = score.device
    score_m = torch.where(in_play, score, BIG)
    perm = _lexsort((u_order, score_m, u_read))
    r_, s_, l_, d_ = u_read[perm], score_m[perm], loc_adj[perm], u_dir[perm]
    first_score = _segment_min(s_, r_, B)
    okh = (s_ < BIG) & (s_ < first_score[r_.long()] + 4) & (s_ <= e_max)
    rank = _cumsum(okh, 0) - 1
    base_rank = _segment_min(torch.where(okh, rank, BIG), r_, B)
    rr = rank - base_rank[r_.long()]
    keep = okh & (rr < max_get)
    # the JAX scatter's mode="drop" on rows past B: masked writes
    tr, tc = r_[keep].long(), rr[keep].long()
    mh_loc = torch.full((B, max_get), u32.const(INVALID_GENOME_LOCATION),
                        dtype=I32, device=dev)
    mh_dir = torch.zeros((B, max_get), dtype=I32, device=dev)
    mh_score = torch.full((B, max_get), -1, dtype=I32, device=dev)
    mh_loc[tr, tc] = l_[keep]
    mh_dir[tr, tc] = d_[keep]
    mh_score[tr, tc] = s_[keep]
    return dict(mh_loc=mh_loc, mh_dir=mh_dir, mh_score=mh_score,
                mh_n=_segment_sum(keep.to(I32), r_, B))


def rowwise_score_phase(u2, reads, quals, genome_p4, piece_starts, cfg,
                        seed_len, read_len, genome_size,
                        qlp_both: torch.Tensor | None = None,
                        score_scale: int = 1):
    """Whole-read prefilter (K2) + anchored substitution closed form on
    all (rows, W) candidates; LV (K1) on the survivors: a per-read tiny
    tier of J/4 lanes chosen by lane rank, the rest pooled into one spill
    tier of R rows.  Rows beyond the pool are counted in score_overflow
    (IntersectingPairedEndAligner.h:33's candidate-pool cap analog)."""
    e_max = cfg.e_max
    R, W = u2["dir"].shape
    dev = reads.device
    big = big_locations(genome_size)
    live = u2["live"]
    loc = torch.where(live, u2["loc"], 0)
    flat_loc = loc.reshape(R * W)

    M = cfg.e_max
    WIN = read_len + 2 * M
    window, win_words = gather_windows(genome_p4, flat_loc - M, width=WIN,
                                       big=big, return_packed=True)
    window = window.reshape(R, W, WIN)

    if cfg.score_budget_per_read == 0:
        # prefilter disabled: full LV on every candidate slot
        u_flat = dict(
            read=torch.arange(R, dtype=I32, device=dev)[:, None]
            .expand(R, W).reshape(R * W),
            dir=u2["dir"].reshape(R * W), loc=u2["loc"].reshape(R * W),
            off=u2["off"].reshape(R * W), live=live.reshape(R * W))
        sc = score_phase(u_flat, reads, quals, genome_p4, piece_starts,
                         cfg, seed_len, read_len, genome_size,
                         window=window.reshape(R * W, WIN),
                         qlp_both=qlp_both)
        zero = torch.zeros((), dtype=I32, device=dev)
        return dict(score=sc["score"].reshape(R, W),
                    logp=sc["logp"].reshape(R, W),
                    loc_adj=sc["loc_adj"].reshape(R, W),
                    scored_ok=sc["scored_ok"].reshape(R, W),
                    score_overflow=zero, n_bucket2=zero, n_fast=zero)

    comp = torch.from_numpy(_COMP_LUT).to(dev)
    rc_reads = comp[reads.flip(1).long()]
    is_rc = (u2["dir"] == 1)[:, :, None]
    sel = torch.where(is_rc, rc_reads[:, None, :], reads[:, None, :])

    want = read_len + e_max
    t_len = torch.full((R * W,), want, dtype=I32, device=dev)
    wdist = bitpar_distance_words(sel.reshape(R * W, read_len), win_words,
                                  t_len, P=read_len, TXT=want,
                                  packed_off=M).reshape(R, W)

    pidx = piece_index_of(piece_starts, flat_loc, big=big).reshape(R, W)
    next_start = _next_start(piece_starts, pidx, genome_size)
    crosses = _crosses(loc, next_start, genome_size, read_len + M)

    if qlp_both is None:
        qlp_both = phred_log_prob_device(
            torch.stack([quals, quals.flip(1)], dim=1))

    score = torch.full((R, W), BIG, dtype=I32, device=dev)
    logp = torch.full((R, W), NEG_INF, dtype=torch.float32, device=dev)
    loc_adj = u2["loc"]
    scored_ok = torch.zeros((R, W), dtype=torch.bool, device=dev)

    fast = torch.zeros((R, W), dtype=torch.bool, device=dev)
    if os.environ.get("SNAP_TPU_FAST_SUB", "1") != "0":
        # anchored pure-substitution closed form (the exactness argument and
        # the equal-cost-indel deviation are documented in the JAX engine's
        # filtered_score_phase)
        text0 = window[:, :, M:M + read_len]
        mm = sel != text0
        ham = mm.sum(dim=2, dtype=I32)
        fast = live & ~crosses & (wdist <= e_max) & (ham == wdist)
        qlp_sel = torch.where(is_rc, qlp_both[:, None, 1, :],
                              qlp_both[:, None, 0, :])
        logp_f = (torch.where(mm, qlp_sel, 0.0).sum(dim=2)
                  + (read_len - ham).to(torch.float32) * LOG_ONE_MINUS_SNP)
        score = torch.where(fast, ham, score)
        logp = torch.where(fast, logp_f, logp)
        scored_ok = fast

    need = live & ~fast & (wdist <= e_max)
    J = min(W, max(2, cfg.score_budget_per_read * score_scale))
    need_i = need.to(I32)
    rank = _cumsum(need_i, 1) - need_i
    need_per_read = need_i.sum(dim=1, dtype=I32)
    rows_r = torch.arange(R, dtype=I32, device=dev)

    def run_lv(Jt, score, logp, loc_adj, scored_ok):
        match = need[:, None, :] & (
            rank[:, None, :] == torch.arange(Jt, dtype=I32,
                                             device=dev)[None, :, None])
        sel_w = first_true(match, 2)                          # (R, Jt)
        lv_valid = match.any(dim=2)
        take = lambda x: torch.gather(x, 1, sel_w.long())
        u_sub = dict(read=rows_r[:, None].expand(R, Jt).reshape(R * Jt),
                     dir=take(u2["dir"]).reshape(R * Jt),
                     loc=take(u2["loc"]).reshape(R * Jt),
                     off=take(u2["off"]).reshape(R * Jt),
                     live=lv_valid.reshape(R * Jt))
        win_sub = torch.gather(window, 1, sel_w.long()[:, :, None].expand(
            R, Jt, WIN)).reshape(R * Jt, WIN)
        sc_sub = score_phase(u_sub, reads, quals, genome_p4, piece_starts,
                             cfg, seed_len, read_len, genome_size,
                             window=win_sub, qlp_both=qlp_both)
        # scatter the Jt results back into their lanes; invalid picks are
        # dropped (the JAX scatter's mode="drop" on an out-of-range row)
        tr = rows_r[:, None].expand(R, Jt)[lv_valid].long()
        tc = sel_w[lv_valid].long()
        out = []
        for dst, new in ((score, sc_sub["score"]), (logp, sc_sub["logp"]),
                         (loc_adj, sc_sub["loc_adj"]),
                         (scored_ok, sc_sub["scored_ok"])):
            dst = dst.clone()
            dst[tr, tc] = new.reshape(R, Jt)[lv_valid]
            out.append(dst)
        return tuple(out)

    J_small = max(2, J // 4)
    score, logp, loc_adj, scored_ok = run_lv(
        J_small, score, logp, loc_adj, scored_ok)
    if J_small < J:
        SPILL = R
        spill_flat = (need & (rank >= J_small)).reshape(R * W)
        chosen = stable_partition_indices(spill_flat, SPILL)
        ok_sp = spill_flat[chosen.long()]
        ch = chosen.long()
        u_sp = dict(read=torch.div(chosen, W, rounding_mode="floor").to(I32),
                    dir=u2["dir"].reshape(R * W)[ch],
                    loc=u2["loc"].reshape(R * W)[ch],
                    off=u2["off"].reshape(R * W)[ch],
                    live=ok_sp)
        win_sp = window.reshape(R * W, WIN)[ch]
        sc_sp = score_phase(u_sp, reads, quals, genome_p4, piece_starts,
                            cfg, seed_len, read_len, genome_size,
                            window=win_sp, qlp_both=qlp_both)

        def flat_set(dst, new):
            d = dst.reshape(R * W).clone()
            d[ch] = torch.where(ok_sp, new, d[ch])
            return d.reshape(R, W)
        score = flat_set(score, sc_sp["score"])
        logp = flat_set(logp, sc_sp["logp"])
        loc_adj = flat_set(loc_adj, sc_sp["loc_adj"])
        scored_ok = flat_set(scored_ok, sc_sp["scored_ok"])
        overflow = (spill_flat.sum(dtype=I32) - SPILL).clamp_min(0)
    else:
        overflow = (need_per_read - J).clamp_min(0).sum(dtype=I32)

    return dict(score=score, logp=logp, loc_adj=loc_adj, scored_ok=scored_ok,
                score_overflow=overflow,
                n_bucket2=torch.zeros((), dtype=I32, device=dev),
                n_fast=fast.sum(dtype=I32))


def rowwise_replay_phase(u2, sc2, budget, reads, S, cfg: SingleAlignerConfig):
    """Replay of the sequential engine's selection with every segment
    reduction as a row reduction or a rowwise lane scan."""
    maxK, extra = cfg.max_k, cfg.extra_search_depth
    R, W = u2["dir"].shape
    dev = reads.device
    score, logp, loc_adj = sc2["score"], sc2["logp"], sc2["loc_adj"]
    scored_ok = sc2["scored_ok"]
    f3e12 = torch.tensor(3e12, dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)

    n_count = (reads == 4).sum(dim=1, dtype=I32)

    round_of = u2["round"].clamp(0, S - 1)
    rmask = round_of[:, None, :] == torch.arange(S, dtype=I32,
                                                 device=dev)[None, :, None]
    best_by_round = torch.where(rmask & scored_ok[:, None, :],
                                score[:, None, :], BIG).amin(dim=2)   # (R, S)
    best_upto = torch.cummin(best_by_round, dim=1).values
    limit_r = best_upto.clamp_max(maxK) + extra
    lp_after = budget["lp_after"]
    stop_r = torch.minimum(lp_after[:, :, 0], lp_after[:, :, 1]) > limit_r
    r_star = torch.where(stop_r.any(dim=1), first_true(stop_r, 1), S - 1)

    in_play = scored_ok & (round_of <= r_star[:, None])
    score_f = torch.where(in_play, score, BIG)

    comp = torch.where(score_f < BIG,
                       score_f.to(torch.float32) * 1e6
                       - logp.clamp(-1e5, 0), f3e12)
    m1 = comp.amin(dim=1)
    cand1 = comp <= m1[:, None]
    m2 = torch.where(cand1, u2["order"], BIG).amin(dim=1)
    cand2 = cand1 & (u2["order"] == m2[:, None])
    cols = torch.arange(W, dtype=I32, device=dev)[None, :]
    winner_col = torch.where(cand2, cols, BIG).amin(dim=1)
    has_best = score_f.amin(dim=1) < BIG
    winner_col = torch.where(has_best, winner_col, 0)
    pick = lambda x: torch.gather(x, 1, winner_col.long()[:, None])[:, 0]
    best_score = pick(score_f)
    best_loc = pick(loc_adj)
    best_dir = pick(u2["dir"])
    best_logp = pick(logp)

    final_limit = (best_score.clamp_max(maxK) + extra).clamp_max(cfg.e_max)
    in_prob = in_play & (score <= final_limit[:, None]) \
        & (u2["lp"] <= final_limit[:, None])

    col0 = torch.zeros((R, W), dtype=torch.bool, device=dev)
    col0[:, 0] = True
    d_prev = torch.cat([torch.zeros_like(u2["dir"][:, :1]),
                        u2["dir"][:, :-1]], dim=1)
    l_prev = torch.cat([torch.zeros_like(loc_adj[:, :1]), loc_adj[:, :-1]],
                       dim=1)
    gap_new = col0 | (u2["dir"] != d_prev) \
        | (loc_adj - l_prev > MAX_MERGE_DIST)
    clus_key = torch.where(in_prob,
                           score.to(torch.float32) * 1e6
                           - logp.clamp(-1e5, 0), f3e12)
    clus_min = seg_broadcast(clus_key, gap_new, torch.minimum, 3e12)
    is_clus_best = in_prob & (clus_key <= clus_min)
    cum_best = _cumsum(is_clus_best, 1)
    first_rank = seg_broadcast(torch.where(is_clus_best, cum_best, BIG),
                               gap_new, torch.minimum, BIG)
    is_clus_best = is_clus_best & (cum_best == first_rank)

    clus_logp = torch.where(is_clus_best, logp, neg_inf)
    read_max = clus_logp.amax(dim=1).clamp_min(-1e29)
    psum = torch.where(is_clus_best, torch.exp(clus_logp - read_max[:, None]),
                       0.0).sum(dim=1)
    log_pall = torch.where(psum > 0, torch.log(psum) + read_max, neg_inf)

    not_best = is_clus_best & (cols != winner_col[:, None])
    psum_o = torch.where(not_best, torch.exp(clus_logp - read_max[:, None]),
                         0.0).sum(dim=1)
    log_pother = torch.where(psum_o > 0, torch.log(psum_o) + read_max,
                             neg_inf)

    s_ar = torch.arange(S, dtype=I32, device=dev)
    popular_n = (budget["popular"] & budget["active_pos"][:, :, None]
                 & (s_ar[None, :, None] <= r_star[:, None, None])
                 ).sum(dim=(1, 2), dtype=I32)

    mapq = _compute_mapq(log_pall, best_logp, log_pother, best_score,
                         popular_n)

    applied_any = budget["applied_act"].any(dim=2).any(dim=1)
    aligned = has_best & (best_score <= maxK)
    unaligned = torch.where(applied_any, NOT_FOUND, MULTIPLE_HITS)
    if cfg.stop_on_first:
        result = torch.where(aligned, SINGLE_HIT, unaligned)
    else:
        result = torch.where(
            aligned,
            torch.where(mapq >= MAPQ_LIMIT_FOR_SINGLE_HIT, SINGLE_HIT,
                        MULTIPLE_HITS),
            unaligned)
    result = torch.where(n_count > maxK, NOT_FOUND, result).to(I32)
    ok = aligned & (n_count <= maxK)
    out = dict(result=result,
               loc=torch.where(ok, best_loc, -1).to(I32),
               direction=best_dir,
               score=torch.where(has_best, best_score, -1).to(I32),
               mapq=torch.where(ok, mapq, 0).to(I32),
               log_pbest=best_logp, log_pall=log_pall,
               popular=popular_n)
    if cfg.max_hits_to_get > 0:
        out.update(_multi_hits_rowwise(u2, loc_adj, score, in_play,
                                       cfg.max_hits_to_get, cfg.e_max))
    return out


def _compute_mapq(log_pall, log_pbest, log_pother, score, popular):
    """computeMAPQ (mapq.h:32-65) in log space; `pAll == pBest` becomes
    "other mass < 2^-53 of best"."""
    exact = log_pother - log_pbest < -36.7368  # log(2^-53)
    special70 = exact & (popular == 0) & (score < 5)
    r = torch.exp(torch.clamp(log_pother - log_pbest, max=50.0))
    frac = r / (1.0 + r)
    base = torch.where(
        frac <= 0, 69,
        torch.clamp((-10.0 * torch.log10(frac.clamp_min(1e-30))).to(I32),
                    max=69))
    base = (base - torch.div((popular - 10).clamp_min(0), 2,
                             rounding_mode="floor")).clamp_min(0)
    return torch.where(special70, 70, base).to(I32)


def _multi_hits_rowwise(u2, loc_adj, score, in_play, max_get, e_max):
    """fillHitsFound analog (BaseAligner.cpp:940-975), rowwise: a stable
    per-row sort by (score, order)."""
    R, W = score.shape
    dev = score.device
    score_m = torch.where(in_play, score, BIG)
    key = (score_m.to(torch.int64) << 32) | u2["order"].to(torch.int64)
    _, perm = torch.sort(key, dim=1, stable=True)
    take = lambda x: torch.gather(x, 1, perm)
    s_, l_, d_ = take(score_m), take(loc_adj), take(u2["dir"])
    first_score = s_[:, :1]
    okh = (s_ < BIG) & (s_ < first_score + 4) & (s_ <= e_max)
    rank = _cumsum(okh, 1) - 1
    keep = okh & (rank < max_get)
    tr = torch.arange(R, device=dev)[:, None].expand(R, W)[keep]
    tc = rank[keep].long()
    mh_loc = torch.full((R, max_get), u32.const(INVALID_GENOME_LOCATION),
                        dtype=I32, device=dev)
    mh_dir = torch.zeros((R, max_get), dtype=I32, device=dev)
    mh_score = torch.full((R, max_get), -1, dtype=I32, device=dev)
    mh_loc[tr, tc] = l_[keep]
    mh_dir[tr, tc] = d_[keep]
    mh_score[tr, tc] = s_[keep]
    return dict(mh_loc=mh_loc, mh_dir=mh_dir, mh_score=mh_score,
                mh_n=keep.sum(dim=1, dtype=I32))


def dense_topk_rowwise(u2, sc2, K):
    """(B, K) dense view of the scored candidates: the first K scored
    candidates of each row in (dir, loc) order (the pair join's input)."""
    R, W = sc2["score"].shape
    dev = sc2["score"].device
    live = u2["live"] & sc2["scored_ok"]
    loc = torch.where(live, sc2["loc_adj"], 0)
    score = torch.where(live, sc2["score"], BIG)
    logp = torch.where(live, sc2["logp"], NEG_INF)
    if W == K:
        return dict(loc=loc, dir=u2["dir"], score=score, logp=logp,
                    live=live, in_prob=live,
                    overflow=torch.zeros((), dtype=I32, device=dev))
    sel = live.to(I32)
    rank = _cumsum(sel, 1) - sel
    keep = live & (rank < K)
    match = keep[:, None, :] & (
        rank[:, None, :] == torch.arange(K, dtype=I32, device=dev)[None, :, None])
    sel_w = first_true(match, 2).long()
    valid = match.any(dim=2)
    take = lambda x, fill: torch.where(valid, torch.gather(x, 1, sel_w), fill)
    return dict(loc=take(loc, 0), dir=take(u2["dir"], 0),
                score=take(score, BIG), logp=take(logp, NEG_INF),
                live=valid, in_prob=valid,
                overflow=(live & ~keep).sum(dtype=I32))


def rowwise_back_half(cands, budget, reads, quals, genome_p4, piece_starts,
                      cfg, seed_len, read_len, genome_size, S,
                      qlp_both=None, score_scale: int = 1):
    """aggregate -> rowwise score -> rowwise replay.  Returns (u2, sc2,
    out) where out carries the replay results + device counters."""
    u2 = _aggregate_rows(cands, big=big_locations(genome_size))
    sc2 = rowwise_score_phase(u2, reads, quals, genome_p4, piece_starts,
                              cfg, seed_len, read_len, genome_size,
                              qlp_both=qlp_both, score_scale=score_scale)
    out = rowwise_replay_phase(u2, sc2, budget, reads, S, cfg)
    out["score_overflow"] = sc2["score_overflow"]
    out["n_unique_candidates"] = u2["live"].sum(dtype=I32)
    out["n_scored"] = sc2["scored_ok"].sum(dtype=I32)
    out["n_bucket2"] = sc2["n_bucket2"]
    return u2, sc2, out


def flat_align_batch(aligner, reads: torch.Tensor, quals: torch.Tensor):
    """One batch through the flat phases on the aligner's device: seed ->
    budget -> expand -> aggregate_phase -> compact_phase ->
    filtered_score_phase -> replay_phase, composed as the JAX package's
    tests/test_fast_sub.py composes them.  Returns (u, sc, out): the
    compacted candidates, their scores, and the replay's results with
    `compact_overflow` added."""
    dev = aligner.device
    B, L = reads.shape
    reads, quals = reads.to(dev), quals.to(dev)
    positions, wraps = aligner.schedule_for(L)
    cfg = aligner.cfg.resolve_for_read_len(L)
    st = aligner.state
    seed_len = aligner.index.seed_len
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    seeds = seed_phase(reads, tuple(int(x) for x in positions), seed_len,
                       st["overflow"], aligner.genome_size, st)
    counts = torch.where(seeds["found"][:, :, None], seeds["counts"], 0)
    budget = budget_phase(seeds["valid"], counts, as_t(wraps), cfg)
    cands = expand_phase(seeds, budget, as_t(positions), st["overflow"],
                         cfg, seed_len, L, cfg.cand_per_read)
    u, overflow = compact_phase(aggregate_phase(cands), B, cfg)
    sc = filtered_score_phase(u, reads, quals, st["genome_p4"],
                              st["piece_starts"], cfg, seed_len, L,
                              aligner.genome_size, B)
    out = replay_phase(u, sc, budget, reads, B, len(positions), cfg)
    out["compact_overflow"] = overflow
    return u, sc, out


# ----------------------------------------------------------------------
# single-device composition
# ----------------------------------------------------------------------

def _align_batch(reads, quals, state, schedule, wraps, *,
                 cfg: SingleAlignerConfig, seed_len: int, read_len: int,
                 sched_static: tuple):
    genome_size = state["genome_size"]
    S = schedule.shape[0]
    seeds = seed_phase(reads, sched_static, seed_len, state["overflow"],
                       genome_size, state)
    counts_global = torch.where(seeds["found"][:, :, None], seeds["counts"],
                                0)
    budget = budget_phase(seeds["valid"], counts_global, wraps, cfg)

    def from_cands(cands, score_scale=1):
        _u2, _sc2, out = rowwise_back_half(
            cands, budget, reads, quals, state["genome_p4"],
            state["piece_starts"], cfg, seed_len, read_len, genome_size, S,
            score_scale=score_scale)
        out["truncated"] = cands["truncated"]
        # per-phase device counters (BaseAligner.h:113-118 analog)
        out["n_lookups"] = seeds["found"].sum(dtype=I32)
        out["n_candidates"] = cands["live"].sum(dtype=I32)
        return out

    big = big_locations(genome_size)
    cands = expand_phase(seeds, budget, schedule, state["overflow"], cfg,
                         seed_len, read_len, cfg.cand_per_read, big=big)
    if not (cfg.overflow_tier and cfg.cand_per_read > 0):
        return from_cands(cands)
    # candidate-overflow exact fallback: when the narrow expand truncated
    # any read's hit list, re-expand at 4x and run the wide back half (the
    # narrow result is bit-identical whenever nothing truncated)
    if int(cands["truncated"].sum()) > 0:
        return from_cands(
            expand_phase(seeds, budget, schedule, state["overflow"], cfg,
                         seed_len, read_len, 4 * cfg.cand_per_read, big=big),
            score_scale=4)
    return from_cands(cands)


def fetch(out: dict) -> dict:
    """Device result dict -> numpy, with one device-to-host copy per dtype
    (the outputs are grouped into one flat buffer each)."""
    res, groups = {}, {}
    for k, v in out.items():
        groups.setdefault(v.dtype, []).append((k, v))
    for dtype, items in groups.items():
        flat = torch.cat([v.reshape(-1) for _, v in items]).cpu().numpy()
        pos = 0
        for k, v in items:
            n = v.numel()
            res[k] = flat[pos:pos + n].reshape(tuple(v.shape))
            pos += n
    return res


class SingleAligner:
    """Host-facing wrapper: owns the device copies of the index and runs
    the batched engine on them."""

    def __init__(self, index: GenomeIndex,
                 config: SingleAlignerConfig | None = None,
                 device="cuda", **overrides):
        self.index = index
        self.device = resolve_device(device)
        cfg = config or SingleAlignerConfig(seed_len=index.seed_len)
        if overrides:
            cfg = SingleAlignerConfig(**{**cfg.__dict__, **overrides})
        self.cfg = cfg
        arrays = index.device_arrays()
        arrays["piece_starts"] = index.genome.piece_offsets
        self.state = index_state_from_numpy(arrays, cuckoo_layout_for(index),
                                            self.device)
        self.genome_size = self.state["genome_size"]

    def schedule_for(self, read_len: int):
        positions, wraps = seed_position_schedule(read_len, self.index.seed_len)
        S = min(self.cfg.max_seed_slots, len(positions))
        return positions[:S], wraps[:S]

    def align_batch_device(self, reads: torch.Tensor, quals: torch.Tensor):
        """Device to device: (B, L) uint8 tensors in, a dict of tensors
        on self.device out."""
        B, L = reads.shape
        positions, wraps = self.schedule_for(L)
        dev = self.device
        return _align_batch(
            reads.to(dev), quals.to(dev), self.state,
            torch.from_numpy(np.asarray(positions, np.int32)).to(dev),
            torch.from_numpy(np.asarray(wraps, np.int32)).to(dev),
            cfg=self.cfg.resolve_for_read_len(L),
            seed_len=self.index.seed_len, read_len=L,
            sched_static=tuple(int(x) for x in positions))

    def align_batch(self, reads: np.ndarray, quals: np.ndarray) -> dict:
        """reads: (B, L) uint8 base codes (uniform length); quals ASCII."""
        out = self.align_batch_device(torch.from_numpy(np.asarray(reads)),
                                      torch.from_numpy(np.asarray(quals)))
        return fetch(out)
