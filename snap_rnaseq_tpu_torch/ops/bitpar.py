"""Bit-parallel (Myers/Hyyrö) semi-global edit distance — the candidate
prefilter.

Port of snap_rnaseq_tpu/ops/bitpar.py.  Every candidate gets a whole-read
distance from this recurrence (32 pattern bases per u32 word) and only
survivors (distance <= e_max) go through the LV kernel: concatenating a
candidate's LV head/tail alignments is a whole-read alignment, so a
whole-read distance above e_max means the seed-split score fails the gate
anyway.

    per text column j with character c:
        EQ = Peq[c]; Xv = EQ | MV; Xh = (((EQ & PV) + PV) ^ PV) | EQ
        Ph = MV | ~(Xh | PV); Mh = PV & Xh
        score += bit(Ph, P-1) - bit(Mh, P-1)
        Ph' = (Ph << 1) | 1; Mh' = Mh << 1
        PV = Mh' | ~(Xv | Ph'); MV = Ph' & Xv
    result = min over columns j < t_len of score.

`bitpar_distance_plain` is the plain PyTorch version (u32 words carried in
int32, ops/u32.py).  `bitpar_distance_words` routes by device: CPU -> the
nibble unpack + plain version; CUDA -> the packed-text kernel K2
(csrc/bitpar_packed.cu), which this slice runs in its forward, global-start
form only.
"""
from __future__ import annotations

import torch

from . import u32


def pack_peq(pattern: torch.Tensor, P: int) -> torch.Tensor:
    """Peq bitmasks: (B, 4, W) int32-carried u32; bit p%32 of word p//32
    set when pattern[b, p] == base.  Codes >= 4 match nothing."""
    W = (P + 31) // 32
    pat = pattern[:, :P].to(torch.int64)
    p_idx = torch.arange(P, device=pattern.device)
    weights = torch.ones(P, dtype=torch.int64, device=pattern.device) << (p_idx % 32)
    word = p_idx // 32
    out = []
    for base in range(4):
        is_b = (pat == base).to(torch.int64) * weights
        cols = [is_b[:, word == w].sum(dim=1) for w in range(W)]
        out.append(u32.from_i64(torch.stack(cols, dim=1)))
    return torch.stack(out, dim=1)


def bitpar_distance_plain(pattern, text, t_len, *, P: int,
                          track_pos: bool = False, free_start: bool = False):
    """Plain PyTorch version: the recurrence column by column.

    pattern: (B, P) codes; text: (B, TXT) codes; t_len: (B,) int."""
    dev = pattern.device
    B, TXT = text.shape
    W = (P + 31) // 32
    peq = pack_peq(pattern, P)                               # (B, 4, W)
    PV = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    MV = torch.zeros((B, W), dtype=torch.int32, device=dev)
    score = torch.full((B,), P, dtype=torch.int32, device=dev)
    best = (score * 4096 + 4095) if track_pos else score
    hb_word = (P - 1) // 32
    hb_bit = u32.const(1 << ((P - 1) % 32))
    t_len = t_len.to(torch.int32)
    big = torch.tensor(0x7FFFFFF0, dtype=torch.int32, device=dev)
    zeros1 = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    ones1 = torch.ones((B, 1), dtype=torch.int32, device=dev)
    bases = torch.arange(4, device=dev)

    def add_carry(a, b):
        # word-wise sum, carries rippled up one word per round (the u32
        # carry test s < a, ops/u32.py)
        s = a + b
        c = u32.ult(s, a).to(torch.int32)
        for _ in range(W - 1):
            cin = torch.cat([zeros1, c[:, :-1]], dim=1)
            s1 = s + cin
            c = u32.ult(s1, s).to(torch.int32)
            s = s1
        return s

    def shl1(x, fill):
        hi = u32.shr(x, 31)
        return (x << 1) | torch.cat([fill, hi[:, :-1]], dim=1)

    for j in range(TXT):
        cj = text[:, j].to(torch.int64)
        onehot = (cj[:, None] == bases[None, :]).to(torch.int32)   # (B, 4)
        eq = (peq * onehot[:, :, None]).sum(dim=1, dtype=torch.int32)
        Xv = eq | MV
        Xh = (add_carry(eq & PV, PV) ^ PV) | eq
        Ph = MV | ~(Xh | PV)
        Mh = PV & Xh
        ph_hi = ((Ph[:, hb_word] & hb_bit) != 0).to(torch.int32)
        mh_hi = ((Mh[:, hb_word] & hb_bit) != 0).to(torch.int32)
        score = score + ph_hi - mh_hi
        Phs = shl1(Ph, zeros1 if free_start else ones1)
        Mhs = shl1(Mh, zeros1)
        PV = Mhs | ~(Xv | Phs)
        MV = Phs & Xv
        enc = (score * 4096 + j) if track_pos else score
        best = torch.minimum(best, torch.where(j < t_len, enc, big))
    return best


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """(C, n_w) packed words -> (C, 8 * n_w) u8 nibble codes."""
    shifts = torch.arange(8, dtype=torch.int32, device=words.device) * 4
    nib = (words[:, :, None] >> shifts[None, None, :]) & 15
    return nib.to(torch.uint8).reshape(words.shape[0], -1)


def bitpar_distance_words(pattern, words, t_len, *, P: int, TXT: int,
                          packed_off: int, track_pos: bool = False,
                          free_start: bool = False, reverse: bool = False):
    """Whole-read distances over 4-bit packed text: column j's code is
    nibble packed_off + j of each row of `words` (int32-carried u32).

    CPU tensors -> unpack + the plain version.  CUDA tensors -> K2; the
    mate-rescue forms (reverse, free_start, track_pos) are not ported to
    the card yet and raise."""
    if words.is_cuda:
        if reverse or free_start or track_pos:
            raise NotImplementedError(
                "bitpar on CUDA: reverse/free_start/track_pos are not ported")
        return bitpar_packed(pattern, words, t_len, P=P, TXT=TXT,
                             packed_off=packed_off)
    if words.device.type != "cpu":
        raise RuntimeError(f"bitpar: no kernel for {words.device}")
    text = unpack_words(words)[:, packed_off:packed_off + TXT]
    if reverse:
        text = text.flip(1)
    return bitpar_distance_plain(pattern, text, t_len, P=P,
                                 track_pos=track_pos, free_start=free_start)


def bitpar_packed(pattern, words, t_len, *, P: int, TXT: int,
                  packed_off: int) -> torch.Tensor:
    """K2 wrapper: forward, global-start distances on the card."""
    from . import kernels as kx
    dev = words.device
    if dev.type != "cuda":
        raise RuntimeError(f"bitpar_packed needs CUDA tensors, got {dev}")
    pattern = pattern.contiguous()
    words = words.contiguous()
    t_len = t_len.to(torch.int32).contiguous()
    kx.require(pattern, "pattern", torch.uint8, 2, dev)
    kx.require(words, "words", torch.int32, 2, dev)
    kx.require(t_len, "t_len", torch.int32, 1, dev)
    B, NW = words.shape
    if pattern.shape != (B, P) or t_len.shape[0] != B:
        raise ValueError(f"pattern {tuple(pattern.shape)} / t_len "
                         f"{tuple(t_len.shape)} vs words {(B, NW)}, P={P}")
    if not 1 <= P <= 128:
        raise ValueError(f"bitpar_packed takes 1 <= P <= 128, got {P}")
    if packed_off < 0 or packed_off + TXT > 8 * NW:
        raise ValueError(f"columns [{packed_off}, {packed_off + TXT}) "
                         f"exceed {NW} packed words")
    out = torch.empty(B, dtype=torch.int32, device=dev)
    err = kx.launcher("bitpar_packed")(kx.ptr(pattern), P, kx.ptr(words), NW, kx.ptr(t_len), TXT,
             packed_off, B, kx.ptr(out), kx.stream())
    kx.check(err, "bitpar_packed_launch")
    kx.count_launch("K2_bitpar_packed")
    return out
