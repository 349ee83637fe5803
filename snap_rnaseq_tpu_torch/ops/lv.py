"""Batched banded Landau-Vishkin edit distance.

Port of snap_rnaseq_tpu/ops/lv.py (reference SNAPLib/LandauVishkin.h:
159-502 and LandauVishkin.cpp:253-530).  L[e][d] is the furthest pattern
index reachable with e edits on diagonal d; each level takes the best of
the three neighbours and extends along the diagonal to the next mismatch;
diagonals are ranked 0,1,-1,2,-2,... (0,-1,1,... for the CIGAR variant) and
the first level that reaches the pattern end wins.  The match probability
is accumulated in log space by the backtrace.

`_lv_distance_plain` is the plain PyTorch version (the next-mismatch tensor
+ a level loop over the whole batch).  `lv_distance` routes by the device
of its input: a CPU tensor goes to the plain version; a CUDA tensor goes to
the hand-written kernels of ops/lv_cuda.py (K1 without tables, K3 with
them) or raises — there is no fallback.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import GAP_EXTEND_PROB, GAP_OPEN_PROB, SNP_PROB

NEG_INF = -1e30
LOG_GAP_OPEN = float(np.log(GAP_OPEN_PROB))
LOG_GAP_EXTEND = float(np.log(GAP_EXTEND_PROB))
LOG_ONE_MINUS_SNP = float(np.log1p(-SNP_PROB))

# Action codes (reference uses chars 'X','D','I')
ACT_X, ACT_D, ACT_I = 0, 1, 2


def phred_log_prob_table() -> np.ndarray:
    """log of lv_phredToProbability per ASCII quality byte
    (initializeLVProbabilitiesToPhredPlus33, LandauVishkin.cpp:601-650)."""
    t = np.full(256, SNP_PROB, dtype=np.float64)
    for i in range(33, 127):
        t[i] = 1.0 - (1.0 - 10.0 ** (-(i - 33) / 10.0)) * (1.0 - SNP_PROB)
    return np.log(t).astype(np.float32)


PHRED_LOG_PROB = phred_log_prob_table()

_LOG2_10_OVER_10 = float(np.log2(10.0) / 10.0)
_LOG_SNP = float(np.log(SNP_PROB))


def phred_log_prob_device(qbytes: torch.Tensor) -> torch.Tensor:
    """Closed form of phred_log_prob_table in f32, cancellation-free:
    1 - (1-pe)(1-s) = pe + s*(1-pe)."""
    q = qbytes.to(torch.float32) - 33.0
    pe = torch.exp2(q * -_LOG2_10_OVER_10)
    v = pe + SNP_PROB * (1.0 - pe)
    in_range = (qbytes >= 33) & (qbytes <= 126)
    return torch.where(in_range, torch.log(v),
                       torch.tensor(_LOG_SNP, dtype=torch.float32,
                                    device=qbytes.device))


class LVResult(NamedTuple):
    distance: torch.Tensor   # int32 (B,): edit distance, or -1 if > k
    log_prob: torch.Tensor   # float32 (B,): log matchProbability
    net_indel: torch.Tensor  # int32 (B,): insertions - deletions
    e_final: torch.Tensor    # int32 (B,): DP level reached
    d_final: torch.Tensor    # int32 (B,): winning diagonal
    L: torch.Tensor          # int32 (B, E_MAX+1, D) (when keep_tables)
    A: torch.Tensor          # int32 (B, E_MAX+1, D) (when keep_tables)
    acts: torch.Tensor       # int32 (B, E_MAX) (when keep_tables)
    matched: torch.Tensor    # int32 (B, E_MAX) (when keep_tables)
    start_run: torch.Tensor  # int32 (B,): L[0][center]


def _d_order(e_max: int, cigar_order: bool) -> np.ndarray:
    """Diagonal priority: position in the reference's d visit order.

    distance kernel (LandauVishkin.h:180-182): 0, 1, -1, 2, -2, ...
    CIGAR kernel (LandauVishkin.cpp:313):      0, -1, 1, -2, 2, ...
    """
    order = [0]
    d = 0
    for _ in range(2 * e_max):
        d = (-d - 1 if d >= 0 else -d) if cigar_order else (-d if d > 0 else -d + 1)
        order.append(d)
    prio = np.empty(2 * e_max + 1, dtype=np.int32)
    for rank, dd in enumerate(order):
        prio[dd + e_max] = rank
    return prio


def qual_logp_rows(quality) -> torch.Tensor | None:
    """(B, P) f32 per-base log error probability, or None for "all
    maximum quality" (the kernels then use PHRED_LOG_PROB[126])."""
    if quality is None:
        return None
    if quality.dtype == torch.float32:
        return quality
    return phred_log_prob_device(quality)


def lv_distance(pattern: torch.Tensor, p_len: torch.Tensor,
                text: torch.Tensor, t_len: torch.Tensor, k: torch.Tensor,
                quality: torch.Tensor | None = None,
                free: torch.Tensor | None = None, *, e_max: int,
                cigar_order: bool = False,
                keep_tables: bool = False) -> LVResult:
    """free: optional (B,) per-row FREE PREFIX length — pattern positions
    < free match any text byte and carry no probability.

    Routes by device: CPU -> the plain version; CUDA -> K1 (no tables) or
    K3 (keep_tables) of ops/lv_cuda.py."""
    if pattern.is_cuda:
        from . import lv_cuda
        if keep_tables:
            if free is not None:
                raise NotImplementedError("free prefix + tables")
            return lv_cuda.lv_cigar(pattern, p_len, text, t_len, k, quality,
                                    e_max=e_max, cigar_order=cigar_order,
                                    tables=True)
        return lv_cuda.lv_lanes(pattern, p_len, text, t_len, k, quality,
                                free, e_max=e_max, cigar_order=cigar_order)
    if pattern.device.type != "cpu":
        raise RuntimeError(f"lv_distance: no kernel for {pattern.device}")
    return _lv_distance_plain(pattern, p_len, text, t_len, k, quality, free,
                              e_max=e_max, cigar_order=cigar_order,
                              keep_tables=keep_tables)


def _recover_actions(L_all, A_all, e_fin, d_fin, e_max):
    """Phase-1 backtrace only (action + matched-run recovery) for the CIGAR
    path, from materialized tables.  Returns (acts, matched) (B, e_max)."""
    B, _, D = L_all.shape
    center = e_max
    rows = torch.arange(B, device=L_all.device)

    def gather_L(e_idx, d_idx):
        return L_all[rows, e_idx, (d_idx + center).clamp(0, D - 1)]

    cur_d = d_fin
    acts_rev, matched_rev = [], []
    for e in range(e_max, 0, -1):
        active = (e <= e_fin) & (e >= 1)
        act = A_all[rows, e, (cur_d + center).clamp(0, D - 1)]
        L_here = gather_L(e, cur_d)
        m_I = L_here - gather_L(e - 1, cur_d + 1) - 1
        m_D = L_here - gather_L(e - 1, cur_d - 1)
        m_X = L_here - gather_L(e - 1, cur_d) - 1
        matched = torch.where(act == ACT_I, m_I,
                              torch.where(act == ACT_D, m_D, m_X))
        step = torch.where(act == ACT_I, 1, torch.where(act == ACT_D, -1, 0))
        cur_d = torch.where(active, cur_d + step, cur_d)
        acts_rev.append(torch.where(active, act, -1))
        matched_rev.append(torch.where(active, matched, 0))
    if not acts_rev:
        z = torch.zeros((B, 0), dtype=torch.int32, device=L_all.device)
        return z, z.clone()
    acts = torch.stack(acts_rev[::-1], dim=1).to(torch.int32)
    matched = torch.stack(matched_rev[::-1], dim=1).to(torch.int32)
    return acts, matched


def _lv_distance_plain(pattern, p_len, text, t_len, k, quality=None,
                       free=None, *, e_max: int, cigar_order: bool = False,
                       keep_tables: bool = False) -> LVResult:
    """Plain PyTorch version (the oracle for K1 and K3).

    pattern: (B, P) codes; text: (B, T) codes; p_len, t_len, k: (B,) int;
    quality: (B, P) u8 ASCII or f32 log-probs or None.  Returns distance in
    [0, k] or -1; the zero-edit early-out charges (p_len - end) when the
    text is shorter than the pattern (LandauVishkin.h:290-305)."""
    dev = pattern.device
    B, P = pattern.shape
    D = 2 * e_max + 1
    i32 = torch.int32
    p_len = p_len.to(i32)
    t_len = t_len.to(i32)
    k = torch.minimum(k.to(i32), torch.tensor(e_max, dtype=i32, device=dev))
    pos = torch.arange(P, dtype=i32, device=dev)

    # ---- next-mismatch tensor --------------------------------------------
    pat = pattern.to(i32)
    textp = torch.cat([torch.full((B, e_max), 255, dtype=i32, device=dev),
                       text.to(i32),
                       torch.full((B, e_max + P), 255, dtype=i32,
                                  device=dev)], dim=1)
    tpos = torch.arange(textp.shape[1], dtype=i32, device=dev) - e_max
    textp = torch.where(tpos[None, :] < t_len[:, None], textp, 255)
    shifted = textp.unfold(1, P, 1)[:, :D, :]               # (B, D, P)
    match = shifted == pat[:, None, :]
    if free is not None:
        match = match | (pos[None, None, :] < free.to(i32)[:, None, None])
    mm_idx = torch.where(match, torch.tensor(P, dtype=torch.int16, device=dev),
                         pos.to(torch.int16)[None, None, :])
    # nextmm[b, d, p] = min_{q >= p} mm_idx[b, d, q], plus sentinel column P
    nextmm = torch.cummin(mm_idx.flip(2), dim=2).values.flip(2)
    nextmm = torch.cat([nextmm, torch.full((B, D, 1), P, dtype=torch.int16,
                                           device=dev)], dim=2)

    d_vals = torch.arange(-e_max, e_max + 1, dtype=i32, device=dev)
    end_d = torch.minimum(p_len[:, None], t_len[:, None] - d_vals[None, :])

    def extend(best):
        gb = best.clamp(0, P).long()
        ext = torch.gather(nextmm, 2, gb[:, :, None])[:, :, 0].to(i32)
        ext = torch.minimum(ext, end_d)
        return torch.maximum(best, torch.where(best >= 0, ext, best))

    # ---- level 0 ----------------------------------------------------------
    center = e_max
    end0 = torch.minimum(p_len, t_len)
    first_mm = torch.minimum(nextmm[:, center, 0].to(i32), end0)
    L0 = torch.full((B, D), -2, dtype=i32, device=dev)
    L0[:, center] = first_mm

    perfect = first_mm >= end0
    perfect_dist = (p_len - end0).clamp_min(0)
    perfect_ok = perfect & (perfect_dist <= k)

    # ---- DP over e --------------------------------------------------------
    prio = torch.from_numpy(_d_order(e_max, cigar_order)).to(dev)
    done = perfect
    dist = torch.where(perfect_ok, perfect_dist, -1)
    e_fin = torch.zeros(B, dtype=i32, device=dev)
    d_fin = torch.zeros(B, dtype=i32, device=dev)
    abs_d = d_vals.abs()
    no_rank = torch.tensor(2 * e_max + 2, dtype=i32, device=dev)

    Ls, As = [L0], [torch.zeros((B, D), dtype=i32, device=dev)]
    L_prev = L0
    for e in range(1, e_max + 1):
        up = L_prev + 1
        left = torch.cat([torch.full((B, 1), -2, dtype=i32, device=dev),
                          L_prev[:, :-1]], dim=1)
        right = torch.cat([L_prev[:, 1:] + 1,
                           torch.full((B, 1), -1, dtype=i32, device=dev)],
                          dim=1)
        best = up
        act = torch.full_like(L_prev, ACT_X)
        better_l = left > best
        best = torch.where(better_l, left, best)
        act = torch.where(better_l, ACT_D, act)
        better_r = right > best
        best = torch.where(better_r, right, best)
        act = torch.where(better_r, ACT_I, act)

        in_band = (abs_d <= e)[None, :]
        best = extend(best)
        best = torch.where(in_band, best, -2)

        hit = in_band & (best >= p_len[:, None]) & (e <= k)[:, None]
        any_hit = hit.any(dim=1) & ~done
        rank = torch.where(hit, prio[None, :], no_rank)
        win = _first_argmin(rank)

        new_done = done | any_hit | (e >= k)
        dist = torch.where(any_hit, e, dist)
        e_fin = torch.where(any_hit, e, e_fin)
        d_fin = torch.where(any_hit, win - e_max, d_fin)

        L_prev = torch.where(done[:, None], L_prev, best)
        done = new_done
        Ls.append(L_prev)
        As.append(act)

    L_all = torch.stack(Ls, dim=1)                           # (B, E+1, D)
    A_all = torch.stack(As, dim=1)

    # ---- backtrace: match probability + net indel -------------------------
    log_prob, net_indel, acts_bt, matched_bt = _backtrace_prob(
        pattern, p_len, quality, L_all, A_all, e_fin, d_fin, e_max)

    l1s = LOG_ONE_MINUS_SNP
    eff_len = p_len if free is None else p_len - free.to(i32)
    log_perfect = eff_len.to(torch.float32) * l1s
    if free is not None:
        log_prob = log_prob - free.to(torch.float32) * l1s
    neg_inf = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    log_prob = torch.where(perfect, torch.where(perfect_ok, log_perfect,
                                                neg_inf), log_prob)
    net_indel = torch.where(perfect, 0, net_indel)
    log_prob = torch.where(dist >= 0, log_prob, neg_inf)

    start_run = L0[:, center]
    if not keep_tables:
        L_all = torch.zeros((B, 0, D), dtype=i32, device=dev)
        A_all = torch.zeros((B, 0, D), dtype=i32, device=dev)
        acts_bt = torch.zeros((B, 0), dtype=i32, device=dev)
        matched_bt = torch.zeros((B, 0), dtype=i32, device=dev)
    return LVResult(distance=dist.to(i32), log_prob=log_prob,
                    net_indel=net_indel.to(i32), e_final=e_fin,
                    d_final=d_fin, L=L_all, A=A_all, acts=acts_bt,
                    matched=matched_bt, start_run=start_run)


def _first_argmin(x: torch.Tensor) -> torch.Tensor:
    """argmin along axis 1 keeping the FIRST index among ties."""
    W = x.shape[1]
    cols = torch.arange(W, dtype=torch.int32, device=x.device)
    is_min = x == x.amin(dim=1, keepdim=True)
    return torch.where(is_min, cols[None, :], W).amin(dim=1).to(torch.int32)


def _backtrace_prob(pattern, p_len, quality, L_all, A_all, e_fin, d_fin,
                    e_max):
    """Backtrace probability accounting (LandauVishkin.h:379-431): phase 1
    recovers each level's action and matched run in reverse; phase 2 walks
    the edit script forward, adding the phred log-probability at each
    substitution offset and gap open/extend log-probabilities per run,
    tracking the net indel; finally + (p_len - e) * log(1 - SNP)."""
    B = L_all.shape[0]
    dev = L_all.device
    center = e_max
    qual_logp = qual_logp_rows(quality)
    if qual_logp is None:
        qual_logp = torch.full(pattern.shape, float(PHRED_LOG_PROB[33 + 93]),
                               dtype=torch.float32, device=dev)
    # qual index clamped to [0, p_len-1], the reference's BUGBUG clamp
    # (LandauVishkin.h:422)
    qmax = (p_len - 1).clamp_min(0)

    acts, matched = _recover_actions(L_all, A_all, e_fin, d_fin, e_max)

    offset = L_all[:, 0, center]
    logp = torch.zeros(B, dtype=torch.float32, device=dev)
    net = torch.zeros(B, dtype=torch.int32, device=dev)
    prev_act = torch.full((B,), -1, dtype=torch.int32, device=dev)
    run_open = torch.zeros(B, dtype=torch.bool, device=dev)
    lg_ext = torch.tensor(LOG_GAP_EXTEND, dtype=torch.float32, device=dev)
    lg_open = torch.tensor(LOG_GAP_OPEN, dtype=torch.float32, device=dev)
    for e in range(1, e_max + 1):
        act, m = acts[:, e - 1], matched[:, e - 1]
        active = (e <= e_fin) & (e_fin > 0)
        cont = run_open & (act == prev_act)
        is_indel = (act == ACT_I) | (act == ACT_D)
        indel_log = torch.where(cont, lg_ext, lg_open)
        qi = torch.minimum(offset.clamp_min(0), qmax).long()
        q_at = torch.gather(qual_logp, 1, qi[:, None])[:, 0]
        add = torch.where(is_indel, indel_log, q_at)
        logp = torch.where(active, logp + add, logp)
        delta = torch.where(act == ACT_D, -1, 1)
        offset = torch.where(active, offset + delta, offset)
        net = torch.where(active & (act == ACT_I), net + 1,
                          torch.where(active & (act == ACT_D), net - 1, net))
        offset = torch.where(active, offset + m, offset)
        run_open = torch.where(active, m == 0, run_open)
        prev_act = torch.where(active, act, prev_act)

    logp = logp + (p_len - e_fin).to(torch.float32) * LOG_ONE_MINUS_SNP
    return logp, net, acts, matched
