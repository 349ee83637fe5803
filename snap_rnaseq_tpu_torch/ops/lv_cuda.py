"""Wrappers for the hand-written LV kernels (port of ops/lv_pallas.py).

  lv_lanes  K1, csrc/lv_lanes.cu: distance, e_final, d_final, log_prob and
            net_indel per row, with a per-row free prefix — the hot path
            of score_phase.
  lv_cigar  K3, csrc/lv_cigar.cu: the same five scalars plus the edit
            script that CIGAR emission reads (start run, and actions and
            matched runs per level); with tables=True also the whole
            (e_max+1, D) L and action tables, for checks against the plain
            version.

Both take CUDA tensors only: they check device, dtype, shape and
contiguity, allocate outputs with torch.empty, launch on the current
stream and raise if the launch failed.  Each adds one to its entry of
kernels.LAUNCHES per launch.  The plain PyTorch versions they are held to
are ops/lv.py _lv_distance_plain (same inputs, same outputs).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels as kx
from .lv import (LOG_GAP_EXTEND, LOG_GAP_OPEN, LOG_ONE_MINUS_SNP,
                 PHRED_LOG_PROB, LVResult, _d_order, qual_logp_rows)

_F = ctypes.c_float


_PRIO: dict = {}


def _prio(e_max: int, cigar_order: bool, device) -> torch.Tensor:
    key = (e_max, cigar_order, str(device))
    t = _PRIO.get(key)
    if t is None:
        t = torch.from_numpy(_d_order(e_max, cigar_order)).to(device)
        _PRIO[key] = t
    return t


def _prepare(pattern, p_len, text, t_len, k, quality, e_max):
    """Common argument checks; returns contiguous int32 row vectors and the
    (B, P) f32 quality rows (or None)."""
    dev = pattern.device
    if dev.type != "cuda":
        raise RuntimeError(f"LV kernel wrapper needs CUDA tensors, got {dev}")
    if not 1 <= e_max <= 31:
        raise ValueError(f"e_max {e_max} outside [1, 31]")
    B, P = pattern.shape
    if text.dim() != 2 or text.shape[0] != B:
        raise ValueError(f"text shape {tuple(text.shape)} vs B={B}")
    pattern = pattern.contiguous()
    text = text.contiguous()
    kx.require(pattern, "pattern", torch.uint8, 2, dev)
    kx.require(text, "text", torch.uint8, 2, dev)
    rows = []
    for name, v in (("p_len", p_len), ("t_len", t_len), ("k", k)):
        v = v.to(torch.int32).contiguous()
        kx.require(v, name, torch.int32, 1, dev)
        if v.shape[0] != B:
            raise ValueError(f"{name} has {v.shape[0]} rows, expected {B}")
        rows.append(v)
    qlp = qual_logp_rows(quality)
    if qlp is not None:
        qlp = qlp.contiguous()
        kx.require(qlp, "quality", torch.float32, 2, dev)
        if tuple(qlp.shape) != (B, P):
            raise ValueError(f"quality shape {tuple(qlp.shape)} vs {(B, P)}")
    return pattern, text, rows, qlp


def _consts():
    return (_F(np.float32(LOG_GAP_OPEN)), _F(np.float32(LOG_GAP_EXTEND)),
            _F(np.float32(LOG_ONE_MINUS_SNP)),
            _F(float(PHRED_LOG_PROB[33 + 93])))


def lv_lanes(pattern, p_len, text, t_len, k, quality=None, free=None, *,
             e_max: int, cigar_order: bool = False) -> LVResult:
    """K1.  pattern (B, P) u8, text (B, T) u8 (the kernel masks text
    beyond t_len), p_len/t_len/k/free (B,), quality (B, P) u8 or f32."""
    pattern, text, (p_len, t_len, k), qlp = _prepare(
        pattern, p_len, text, t_len, k, quality, e_max)
    dev = pattern.device
    B, P = pattern.shape
    if free is not None:
        free = free.to(torch.int32).contiguous()
        kx.require(free, "free", torch.int32, 1, dev)
    outs = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3)]
    logp = torch.empty(B, dtype=torch.float32, device=dev)
    net = torch.empty(B, dtype=torch.int32, device=dev)
    err = kx.launcher("lv_lanes")(
        kx.ptr(pattern), kx.ptr(p_len), kx.ptr(text), kx.ptr(t_len),
        kx.ptr(k), kx.ptr(qlp), kx.ptr(free),
        kx.ptr(_prio(e_max, cigar_order, dev)), B, P, text.shape[1], e_max,
        *_consts(), kx.ptr(outs[0]), kx.ptr(outs[1]), kx.ptr(outs[2]),
        kx.ptr(logp), kx.ptr(net), kx.stream())
    kx.check(err, "lv_lanes_launch")
    kx.count_launch("K1_lv_lanes")
    dist, e_fin, d_fin = outs
    D = 2 * e_max + 1
    z3 = torch.zeros((B, 0, D), dtype=torch.int32, device=dev)
    z2 = torch.zeros((B, 0), dtype=torch.int32, device=dev)
    # start_run (L[0][center]) is a CIGAR-path output; K1 does not return it
    return LVResult(distance=dist, log_prob=logp, net_indel=net,
                    e_final=e_fin, d_final=d_fin, L=z3, A=z3.clone(),
                    acts=z2, matched=z2.clone(),
                    start_run=torch.zeros(B, dtype=torch.int32, device=dev))


def lv_cigar(pattern, p_len, text, t_len, k, quality=None, *, e_max: int,
             cigar_order: bool = True, tables: bool = False) -> LVResult:
    """K3: the five scalars and the recovered edit script (start_run;
    acts, matched: (B, e_max), -1 / 0 past the final level).  The L/A
    tables are written only with tables=True (else (B, 0, D)): emission
    reads the script alone."""
    pattern, text, (p_len, t_len, k), qlp = _prepare(
        pattern, p_len, text, t_len, k, quality, e_max)
    dev = pattern.device
    B, P = pattern.shape
    D = 2 * e_max + 1
    outs = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3)]
    logp = torch.empty(B, dtype=torch.float32, device=dev)
    net = torch.empty(B, dtype=torch.int32, device=dev)
    start_run = torch.empty(B, dtype=torch.int32, device=dev)
    n_lev = e_max + 1 if tables else 0
    L_all = torch.empty((B, n_lev, D), dtype=torch.int32, device=dev)
    A_all = torch.empty((B, n_lev, D), dtype=torch.int32, device=dev)
    acts = torch.empty((B, e_max), dtype=torch.int32, device=dev)
    matched = torch.empty((B, e_max), dtype=torch.int32, device=dev)
    err = kx.launcher("lv_cigar")(
        kx.ptr(pattern), kx.ptr(p_len), kx.ptr(text), kx.ptr(t_len),
        kx.ptr(k), kx.ptr(qlp), kx.ptr(_prio(e_max, cigar_order, dev)),
        B, P, text.shape[1], e_max, *_consts(), kx.ptr(outs[0]),
        kx.ptr(outs[1]), kx.ptr(outs[2]), kx.ptr(logp), kx.ptr(net),
        kx.ptr(start_run), kx.ptr(L_all if tables else None),
        kx.ptr(A_all if tables else None), kx.ptr(acts), kx.ptr(matched),
        kx.stream())
    kx.check(err, "lv_cigar_launch")
    kx.count_launch("K3_lv_cigar")
    dist, e_fin, d_fin = outs
    return LVResult(distance=dist, log_prob=logp, net_indel=net,
                    e_final=e_fin, d_final=d_fin, L=L_all, A=A_all,
                    acts=acts, matched=matched, start_run=start_run)
