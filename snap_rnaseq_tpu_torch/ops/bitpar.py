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
int32, ops/u32.py).  With a free start K2 splits each row's scan into
chunks, each warmed up over the 2P columns before it (`scan_chunks`, whose
geometry the plain version can replay with `first_col` and `warm`).  Two
dispatchers route by device, with no fallback:

  bitpar_distance_words  packed 4-bit text rows.  CPU -> the nibble unpack
                         + plain version; CUDA -> K2 (csrc/bitpar_packed.cu)
                         in every form: forward or reversed, global or free
                         start (split into chunks), with or without
                         track_pos.
  bitpar_distance        (B, TXT) u8 code rows.  CPU -> the plain version;
                         CUDA -> K4 (csrc/bitpar_rows.cu).
"""
from __future__ import annotations

import torch

from ..constants import MAX_READ_LENGTH
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


# rescue-form threads K2 aims for: about 8 warps on each of an H100's 132
# SMs, so the 4,096-row mate rescue does not run one warp per SM
SCAN_THREADS = 32_768
MIN_CHUNK = 32          # columns; shorter chunks would be mostly warm-up
MAX_CHUNKS = 32         # a row's chunks share one warp
# the most text columns, warm-ups included, that the rows of one split scan
# may run between them: beyond it the card is busy and another halving of
# the chunks adds more warm-up than it takes off a row's chain.  Measured
# at the mate rescue's 4,096 rows on an H100 (bitpar_ab.py, PERF.md): 4
# chunks beat 8 by 1.4-1.6x at P = 250 (8 would scan 17.1M columns) and
# P = 512 (26.0M; 4 scan 14.9M); 8 beat 4 at P = 100 and 150 (9.9M, 12.6M).
SCAN_COLUMNS = 1 << 24


def scanned_columns(TXT: int, n_chunks: int, warm: int) -> int:
    """Columns one row's n_chunks chunks scan between them, warm-ups
    included."""
    L = -(-TXT // n_chunks)
    return TXT + sum(min(q * L, warm) for q in range(1, n_chunks)
                     if q * L < TXT)


def scan_chunks(B: int, P: int, TXT: int,
                free_start: bool) -> tuple[int, int, int]:
    """K2's scan geometry: (chunk_len, warm, n_chunks).

    With a free start an optimal alignment costs at most P and so spans at
    most 2P text columns; a scan restarted with fresh state `warm` = 2P
    columns before a chunk gives the serial scan's score at each column of
    the chunk.  Chunk q covers columns [q * chunk_len, (q + 1) * chunk_len)
    (cut at TXT), scanned from max(0, q * chunk_len - warm).  n_chunks is a
    power of two: the least that brings B * n_chunks to SCAN_THREADS,
    keeping chunks of at least MIN_CHUNK columns and the B rows' scanned
    columns within SCAN_COLUMNS.  A global start depends on every earlier
    column: one chunk."""
    if not free_start or TXT <= 0:
        return max(TXT, 0), 0, 1
    n_chunks = 1
    while (n_chunks < MAX_CHUNKS and B * n_chunks < SCAN_THREADS
           and -(-TXT // (2 * n_chunks)) >= MIN_CHUNK
           and B * scanned_columns(TXT, 2 * n_chunks, 2 * P) <= SCAN_COLUMNS):
        n_chunks *= 2
    return -(-TXT // n_chunks), 2 * P, n_chunks


def bitpar_distance_plain(pattern, text, t_len, *, P: int,
                          track_pos: bool = False, free_start: bool = False,
                          first_col: int = 0, warm: int = 0):
    """Plain PyTorch version: the recurrence column by column.

    pattern: (B, P) codes; text: (B, TXT) codes; t_len: (B,) int.  Text
    column j is global column first_col + j (the number track_pos encodes
    and t_len masks); the first `warm` columns are scanned but offer
    nothing (one chunk of K2's split scan, scan_chunks)."""
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
        if j < warm:
            continue
        col = first_col + j
        enc = (score * 4096 + col) if track_pos else score
        best = torch.minimum(best, torch.where(col < t_len, enc, big))
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
    nibble packed_off + j of each row of `words` (int32-carried u32), or
    with reverse nibble packed_off + TXT - 1 - j.

    CPU tensors -> unpack + the plain version.  CUDA tensors -> K2."""
    if words.is_cuda:
        return bitpar_packed(pattern, words, t_len, P=P, TXT=TXT,
                             packed_off=packed_off, track_pos=track_pos,
                             free_start=free_start, reverse=reverse)
    if words.device.type != "cpu":
        raise RuntimeError(f"bitpar: no kernel for {words.device}")
    text = unpack_words(words)[:, packed_off:packed_off + TXT]
    if reverse:
        text = text.flip(1)
    return bitpar_distance_plain(pattern, text, t_len, P=P,
                                 track_pos=track_pos, free_start=free_start)


def bitpar_distance(pattern, text, t_len, *, P: int, track_pos: bool = False,
                    free_start: bool = False):
    """Distances over (B, TXT) code rows.  With track_pos the result is the
    (score << 12) | end_column encoding, minimized lexicographically: the
    EARLIEST best end column.

    CPU tensors -> the plain version.  CUDA tensors -> K4."""
    if text.is_cuda:
        return bitpar_rows(pattern, text, t_len, P=P, track_pos=track_pos,
                           free_start=free_start)
    if text.device.type != "cpu":
        raise RuntimeError(f"bitpar: no kernel for {text.device}")
    return bitpar_distance_plain(pattern, text, t_len, P=P,
                                 track_pos=track_pos, free_start=free_start)


def _checked_rows(pattern, t_len, P, B, dev):
    from . import kernels as kx
    pattern = pattern.contiguous()
    t_len = t_len.to(torch.int32).contiguous()
    kx.require(pattern, "pattern", torch.uint8, 2, dev)
    kx.require(t_len, "t_len", torch.int32, 1, dev)
    if tuple(pattern.shape) != (B, P) or t_len.shape[0] != B:
        raise ValueError(f"pattern {tuple(pattern.shape)} / t_len "
                         f"{tuple(t_len.shape)} vs {B} rows, P={P}")
    if not 1 <= P <= MAX_READ_LENGTH:
        raise ValueError(f"bitpar kernels take 1 <= P <= {MAX_READ_LENGTH}, "
                         f"got {P}")
    return pattern, t_len


def bitpar_packed(pattern, words, t_len, *, P: int, TXT: int,
                  packed_off: int, track_pos: bool = False,
                  free_start: bool = False, reverse: bool = False
                  ) -> torch.Tensor:
    """K2 wrapper.  Counts the forward, global-start form as
    K2_bitpar_packed and any other form (the mate rescue's) as
    K2_bitpar_rescue.  The scan geometry is scan_chunks'."""
    from . import kernels as kx
    dev = words.device
    if dev.type != "cuda":
        raise RuntimeError(f"bitpar_packed needs CUDA tensors, got {dev}")
    words = words.contiguous()
    kx.require(words, "words", torch.int32, 2, dev)
    B, NW = words.shape
    pattern, t_len = _checked_rows(pattern, t_len, P, B, dev)
    if packed_off < 0 or packed_off + TXT > 8 * NW:
        raise ValueError(f"columns [{packed_off}, {packed_off + TXT}) "
                         f"exceed {NW} packed words")
    chunk_len, warm, n = scan_chunks(B, P, TXT, free_start)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    err = kx.launcher(kx.k2_library(P))(
        kx.ptr(pattern), P, kx.ptr(words), NW, kx.ptr(t_len), TXT,
        packed_off, int(reverse), int(free_start), int(track_pos),
        chunk_len, warm, n, B, kx.ptr(out), kx.stream())
    kx.check(err, "bitpar_packed_launch")
    rescue = reverse or free_start or track_pos
    kx.count_launch("K2_bitpar_rescue" if rescue else "K2_bitpar_packed")
    return out


def bitpar_rows(pattern, text, t_len, *, P: int, track_pos: bool = False,
                free_start: bool = False) -> torch.Tensor:
    """K4 wrapper: pattern (B, P) u8, text (B, TXT) u8 code rows."""
    from . import kernels as kx
    dev = text.device
    if dev.type != "cuda":
        raise RuntimeError(f"bitpar_rows needs CUDA tensors, got {dev}")
    text = text.contiguous()
    kx.require(text, "text", torch.uint8, 2, dev)
    B, TXT = text.shape
    pattern, t_len = _checked_rows(pattern, t_len, P, B, dev)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    err = kx.launcher("bitpar_rows")(
        kx.ptr(pattern), P, kx.ptr(text), TXT, kx.ptr(t_len),
        int(free_start), int(track_pos), B, kx.ptr(out), kx.stream())
    kx.check(err, "bitpar_rows_launch")
    kx.count_launch("K4_bitpar_rows")
    return out
