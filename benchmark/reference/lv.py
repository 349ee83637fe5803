"""Landau-Vishkin edit distance with its match probability, plain numpy,
batched over rows: the scorer the aligner's semantics name (SNAP's
LandauVishkin.h), written from the algorithm.

L[e][d] is the furthest pattern index reachable with e edits on diagonal
d (text index = pattern index + d).  Level e takes, per diagonal, the
best of a substitution (L[e-1][d] + 1), a deletion (L[e-1][d-1]) and an
insertion (L[e-1][d+1] + 1), in that order of preference on ties, then
extends along the diagonal to the next mismatch.  The first level at
which a diagonal reaches the pattern's end gives the distance; among the
diagonals that reach it, the first of 0, 1, -1, 2, -2, ... wins.  The
probability walks the winning path: a substitution costs the base's
error probability, an indel run gap open then gap extend per base, every
base that is no edit 1 - SNP.  Pattern positions below `free` match any
text byte and carry no probability; text past t_len matches nothing.
Arithmetic on probabilities is float32.
"""
from __future__ import annotations

import math

import numpy as np

# SNAP's probability model (BaseAligner.h)
SNP_PROB = 0.001
GAP_OPEN_PROB = 0.001
GAP_EXTEND_PROB = 0.5
LOG_ONE_MINUS_SNP = math.log1p(-SNP_PROB)
LOG_GAP_OPEN = math.log(GAP_OPEN_PROB)
LOG_GAP_EXTEND = math.log(GAP_EXTEND_PROB)
NEG_INF = np.float32(-1e30)
X, D, I = 0, 1, 2


def _priority(e_max: int) -> np.ndarray:
    order, d = [0], 0
    for _ in range(2 * e_max):
        d = -d if d > 0 else -d + 1
        order.append(d)
    prio = np.empty(2 * e_max + 1, np.int64)
    for rank, dd in enumerate(order):
        prio[dd + e_max] = rank
    return prio


def landau_vishkin(pat, p_len, text, t_len, k, qlp, free, e_max: int):
    """pat (N, P) and text (N, T) uint8 codes; p_len, t_len, k, free (N,)
    ints; qlp (N, P) float32 log error probability of each pattern base.
    Returns (distance or -1 when over min(k, e_max), log probability
    (float32; NEG_INF when over), net indel = insertions - deletions)."""
    N, P = pat.shape
    T = text.shape[1]
    E = e_max
    Dn = 2 * E + 1
    p_len = np.asarray(p_len, np.int64)
    t_len = np.asarray(t_len, np.int64)
    free = np.asarray(free, np.int64)
    k = np.minimum(np.asarray(k, np.int64), E)
    rows = np.arange(N)
    pos = np.arange(P)

    # next mismatch at or after each pattern position, per diagonal
    tp = np.full((N, E + T + E + P), 255, np.int64)
    tp[:, E:E + T] = text
    tcol = np.arange(tp.shape[1]) - E
    tp[tcol[None, :] >= t_len[:, None]] = 255
    nextmm = np.empty((N, Dn, P + 1), np.int64)
    for di in range(Dn):
        shifted = tp[:, di + pos]                   # text index p + d
        match = (shifted == pat) | (pos[None, :] < free[:, None])
        mm = np.where(match, P, pos[None, :])
        nextmm[:, di, :P] = np.minimum.accumulate(mm[:, ::-1], axis=1)[:, ::-1]
        nextmm[:, di, P] = P
    d_vals = np.arange(-E, E + 1)
    end_d = np.minimum(p_len[:, None], t_len[:, None] - d_vals[None, :])

    def extend(best):
        gb = np.clip(best, 0, P)
        ext = np.take_along_axis(nextmm, gb[:, :, None], axis=2)[:, :, 0]
        ext = np.minimum(ext, end_d)
        return np.maximum(best, np.where(best >= 0, ext, best))

    c = E
    end0 = np.minimum(p_len, t_len)
    first_mm = np.minimum(nextmm[:, c, 0], end0)
    L0 = np.full((N, Dn), -2, np.int64)
    L0[:, c] = first_mm
    perfect = first_mm >= end0
    perfect_dist = np.maximum(p_len - end0, 0)
    perfect_ok = perfect & (perfect_dist <= k)

    prio = _priority(E)
    done = perfect.copy()
    dist = np.where(perfect_ok, perfect_dist, -1)
    e_fin = np.zeros(N, np.int64)
    d_fin = np.zeros(N, np.int64)
    Ls, As = [L0], [np.zeros((N, Dn), np.int64)]
    L_prev = L0
    for e in range(1, E + 1):
        up = L_prev + 1
        left = np.concatenate([np.full((N, 1), -2), L_prev[:, :-1]], axis=1)
        right = np.concatenate([L_prev[:, 1:] + 1, np.full((N, 1), -1)],
                               axis=1)
        best, act = up, np.full((N, Dn), X)
        bl = left > best
        best, act = np.where(bl, left, best), np.where(bl, D, act)
        br = right > best
        best, act = np.where(br, right, best), np.where(br, I, act)
        in_band = (np.abs(d_vals) <= e)[None, :]
        best = np.where(in_band, extend(best), -2)
        hit = in_band & (best >= p_len[:, None]) & (e <= k)[:, None]
        any_hit = hit.any(axis=1) & ~done
        rank = np.where(hit, prio[None, :], 2 * E + 2)
        win = np.argmin(rank, axis=1)
        new_done = done | any_hit | (e >= k)
        dist = np.where(any_hit, e, dist)
        e_fin = np.where(any_hit, e, e_fin)
        d_fin = np.where(any_hit, win - E, d_fin)
        L_prev = np.where(done[:, None], L_prev, best)
        done = new_done
        Ls.append(L_prev)
        As.append(act)
    L_all = np.stack(Ls, axis=1)                    # (N, E + 1, Dn)
    A_all = np.stack(As, axis=1)

    def L_at(e, d):
        return L_all[rows, e, np.clip(d + c, 0, Dn - 1)]

    # the winning path's edits, last level first
    acts = np.full((N, E), -1, np.int64)
    matched = np.zeros((N, E), np.int64)
    cur = d_fin.copy()
    for e in range(E, 0, -1):
        active = e <= e_fin
        a = A_all[rows, e, np.clip(cur + c, 0, Dn - 1)]
        here = L_at(e, cur)
        m = np.where(a == I, here - L_at(e - 1, cur + 1) - 1,
                     np.where(a == D, here - L_at(e - 1, cur - 1),
                              here - L_at(e - 1, cur) - 1))
        step = np.where(a == I, 1, np.where(a == D, -1, 0))
        cur = np.where(active, cur + step, cur)
        acts[:, e - 1] = np.where(active, a, -1)
        matched[:, e - 1] = np.where(active, m, 0)

    # the walk forward: probabilities and the net indel
    f32 = np.float32
    qmax = np.maximum(p_len - 1, 0)
    offset = L_all[:, 0, c].copy()
    logp = np.zeros(N, f32)
    net = np.zeros(N, np.int64)
    prev = np.full(N, -1)
    run_open = np.zeros(N, bool)
    for e in range(1, E + 1):
        a, m = acts[:, e - 1], matched[:, e - 1]
        active = (e <= e_fin) & (e_fin > 0)
        cont = run_open & (a == prev)
        indel = (a == I) | (a == D)
        gap = np.where(cont, f32(LOG_GAP_EXTEND), f32(LOG_GAP_OPEN))
        qi = np.minimum(np.maximum(offset, 0), qmax)
        q = qlp[rows, qi].astype(f32)
        logp = np.where(active, logp + np.where(indel, gap, q), logp)
        offset = np.where(active, offset + np.where(a == D, -1, 1), offset)
        net = np.where(active & (a == I), net + 1,
                       np.where(active & (a == D), net - 1, net))
        offset = np.where(active, offset + m, offset)
        run_open = np.where(active, m == 0, run_open)
        prev = np.where(active, a, prev)
    l1s = f32(LOG_ONE_MINUS_SNP)
    logp = (logp + (p_len - e_fin).astype(f32) * l1s).astype(f32)
    logp = (logp - free.astype(f32) * l1s).astype(f32)
    log_perfect = ((p_len - free).astype(f32) * l1s).astype(f32)
    logp = np.where(perfect, np.where(perfect_ok, log_perfect, NEG_INF), logp)
    net = np.where(perfect, 0, net)
    logp = np.where(dist >= 0, logp, NEG_INF).astype(f32)
    return dist, logp, net
