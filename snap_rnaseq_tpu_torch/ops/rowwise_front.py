"""The whole-slot front of the rowwise score: for every slot (r, w) of the
(R, W) candidate table, the slot's packed genome window, its read in the
slot's orientation, and the anchored substitution closed form.

    win_words (C, n_w) int32   gather_windows(genome_p4, loc - M, width=
                               P + 2M, big=big, return_packed=True)[1],
                               loc = where(live, loc, 0)
    sel       (C, P) uint8     the read, its reverse complement where
                               dir == 1 (K2's pattern rows)
    ham       (C,) int32       positions i < P where sel differs from
                               window base M + i
    logp_f    (C,) float32     the sum of qlp_both[r, dir == 1, i] over
                               those positions + (P - ham) log(1 - SNP)

C = R * W.  `rowwise_front` routes by device, with no fallback: CPU
tensors -> `rowwise_front_plain` (the chain rowwise_score_phase ran
before K6: full windows, then elementwise compare and sums); CUDA tensors
-> K6 (csrc/rowwise_front.cu), which writes the four outputs in one pass
and no slot-sized intermediate.  K6 sums logp_f in position order and
writes it only where ham <= M (the closed form's `fast` needs ham <=
e_max = M); elsewhere it holds -inf.
"""
from __future__ import annotations

import ctypes

import torch

from ..constants import MAX_K, MAX_READ_LENGTH
from .genome_gather import (BASES_PER_WORD, ROW_WORDS, gather_windows,
                            unpack_words)
from .lv import LOG_ONE_MINUS_SNP

I32 = torch.int32


def slot_windows(win_words, idx, width: int) -> torch.Tensor:
    """The (n, width) code windows of the slots at flat indices idx: their
    rows of win_words unpacked, the same bytes as those rows of
    gather_windows' codes."""
    return unpack_words(win_words[idx])[:, :width]


def rowwise_front(genome_p4, loc, dir_, live, reads, comp, qlp_both, *,
                  M: int, big: bool):
    """(win_words, sel, ham, logp_f) of every slot; see the module."""
    if reads.is_cuda:
        return rowwise_front_cuda(genome_p4, loc, dir_, live, reads, comp,
                                  qlp_both, M=M, big=big)
    if reads.device.type != "cpu":
        raise RuntimeError(f"rowwise_front: no kernel for {reads.device}")
    return rowwise_front_plain(genome_p4, loc, dir_, live, reads, comp,
                               qlp_both, M=M, big=big)


def rowwise_front_plain(genome_p4, loc, dir_, live, reads, comp, qlp_both,
                        *, M: int, big: bool):
    """Plain PyTorch version: the whole (R, W, P + 2M) window, then the
    compare and the sums over (R, W, P) tensors."""
    R, W = dir_.shape
    P = reads.shape[1]
    WIN = P + 2 * M
    flat_loc = torch.where(live, loc, 0).reshape(R * W)
    window, win_words = gather_windows(genome_p4, flat_loc - M, width=WIN,
                                       big=big, return_packed=True)
    window = window.reshape(R, W, WIN)
    rc_reads = comp[reads.flip(1).long()]
    is_rc = (dir_ == 1)[:, :, None]
    sel = torch.where(is_rc, rc_reads[:, None, :], reads[:, None, :])
    text0 = window[:, :, M:M + P]
    mm = sel != text0
    ham = mm.sum(dim=2, dtype=I32)
    qlp_sel = torch.where(is_rc, qlp_both[:, None, 1, :],
                          qlp_both[:, None, 0, :])
    logp_f = (torch.where(mm, qlp_sel, 0.0).sum(dim=2)
              + (P - ham).to(torch.float32) * LOG_ONE_MINUS_SNP)
    return (win_words, sel.reshape(R * W, P), ham.reshape(R * W),
            logp_f.reshape(R * W))


def rowwise_front_cuda(genome_p4, loc, dir_, live, reads, comp, qlp_both,
                       *, M: int, big: bool):
    """K6 wrapper: checks device, dtypes, shapes and contiguity, allocates
    the outputs, launches on the current stream; counts K6_rowwise_front."""
    from . import kernels as kx
    dev = reads.device
    if dev.type != "cuda":
        raise RuntimeError(f"rowwise_front_cuda needs CUDA tensors, got {dev}")
    R, W = dir_.shape
    P = reads.shape[1]
    # gather_windows' words for a window of P + 2M bases
    n_w = (P + 2 * M + BASES_PER_WORD - 1) // BASES_PER_WORD + 1
    genome_p4, loc, dir_, live, reads, comp, qlp_both = (
        t.contiguous() for t in (genome_p4, loc, dir_, live, reads, comp,
                                 qlp_both))
    kx.require(genome_p4, "genome_p4", I32, 1, dev)
    kx.require(loc, "loc", I32, 2, dev)
    kx.require(dir_, "dir", I32, 2, dev)
    kx.require(live, "live", torch.bool, 2, dev)
    kx.require(reads, "reads", torch.uint8, 2, dev)
    kx.require(comp, "comp", torch.uint8, 1, dev)
    kx.require(qlp_both, "qlp_both", torch.float32, 3, dev)
    if (tuple(loc.shape) != (R, W) or tuple(live.shape) != (R, W)
            or reads.shape[0] != R or comp.shape[0] != 8
            or tuple(qlp_both.shape) != (R, 2, P)):
        raise ValueError(
            f"rowwise_front: loc {tuple(loc.shape)}, dir {(R, W)}, live "
            f"{tuple(live.shape)}, reads {tuple(reads.shape)}, comp "
            f"{tuple(comp.shape)}, qlp_both {tuple(qlp_both.shape)}")
    if not 1 <= P <= MAX_READ_LENGTH or not 0 <= M <= MAX_K:
        raise ValueError(f"rowwise_front takes 1 <= P <= {MAX_READ_LENGTH} "
                         f"and 0 <= M <= {MAX_K}, got P={P}, M={M}")
    n_words = genome_p4.shape[0]
    C = R * W
    win = torch.empty((C, n_w), dtype=I32, device=dev)
    sel = torch.empty((C, P), dtype=torch.uint8, device=dev)
    ham = torch.empty(C, dtype=I32, device=dev)
    logp = torch.empty(C, dtype=torch.float32, device=dev)
    err = kx.launcher("rowwise_front")(
        kx.ptr(genome_p4), n_words, int(n_words % ROW_WORDS == 0),
        kx.ptr(loc), kx.ptr(dir_), kx.ptr(live), kx.ptr(reads),
        kx.ptr(comp), kx.ptr(qlp_both), R, W, P, M, n_w, int(big),
        ctypes.c_float(LOG_ONE_MINUS_SNP), kx.ptr(win), kx.ptr(sel),
        kx.ptr(ham), kx.ptr(logp), kx.stream())
    kx.check(err, "rowwise_front_launch")
    kx.count_launch("K6_rowwise_front")
    return win, sel, ham, logp
