"""Packed-genome window gathers.

Port of snap_rnaseq_tpu/ops/genome_gather.py.  The genome is packed 4 bits
per base (codes 0-5; N=4 / pad=5 preserved), 8 bases per u32 word, so a
window is ~n_w word gathers instead of one gather per base.  On the card a
plain (C, n_w) word gather serves; the TPU's aligned-row fetch + lane-roll
trick is not needed.  The sub-word offset is resolved with three
conditional funnel shifts, after which base i of the window is exactly
nibble i of the word stream, so the packed rows can feed the bit-parallel
kernel directly (return_packed).
"""
from __future__ import annotations

import numpy as np
import torch

from . import u32

BASES_PER_WORD = 8   # 4 bits per base code in a uint32
ROW_WORDS = 64       # pack_genome_4bit pads the word count to this multiple
_PAD_WORD = u32.const(0x55555555)   # eight padding nibbles (code 5)
PACK_CHUNK_BASES = 1 << 24   # bases pack_genome_4bit packs at a time


def pack_genome_4bit(codes: np.ndarray) -> np.ndarray:
    """Host-side: uint8 base codes -> uint32 words, 8 bases each, little-
    endian by base (base i of word w = bits [4i, 4i+4)).  The word count
    is padded to a ROW_WORDS multiple with padding-code words.

    Packed PACK_CHUNK_BASES at a time into the one output array, so the host
    holds the packed words and one chunk's temporaries (12 bytes a base),
    not a 4-byte copy of every base: a 3.1 Gb genome's words are 1.55 GB."""
    n = codes.shape[0]
    n_words = (n + BASES_PER_WORD - 1) // BASES_PER_WORD
    n_words = -(-n_words // ROW_WORDS) * ROW_WORDS
    out = np.full(n_words, 0x55555555, np.uint32)
    shifts = (np.arange(BASES_PER_WORD, dtype=np.uint32) * 4)
    step = max(BASES_PER_WORD,
               PACK_CHUNK_BASES // BASES_PER_WORD * BASES_PER_WORD)
    for s in range(0, n, step):
        chunk = np.asarray(codes[s:s + step], np.uint8)
        if chunk.shape[0] % BASES_PER_WORD:        # the last, partial word
            tail = np.full(-chunk.shape[0] % BASES_PER_WORD, 5, np.uint8)
            chunk = np.concatenate([chunk, tail])
        w = chunk.reshape(-1, BASES_PER_WORD).astype(np.uint32)
        w0 = s // BASES_PER_WORD
        out[w0:w0 + w.shape[0]] = (w << shifts).sum(axis=1, dtype=np.uint32)
    return out


def pack_genome_4bit_torch(codes: torch.Tensor) -> torch.Tensor:
    """pack_genome_4bit on a uint8 tensor, on its device: the same words
    as int32 carriers.  One nibble column at a time, so a 3.2 Gb genome
    needs its 1.6 GB of words, a 3.2 GB padded copy of the codes and two
    400 MB columns."""
    n = codes.shape[0]
    n_words = (n + BASES_PER_WORD - 1) // BASES_PER_WORD
    n_words = -(-n_words // ROW_WORDS) * ROW_WORDS
    padded = torch.full((n_words * BASES_PER_WORD,), 5, dtype=torch.uint8,
                        device=codes.device)
    padded[:n] = codes
    out = torch.zeros(n_words, dtype=torch.int32, device=codes.device)
    for i in range(BASES_PER_WORD):
        out |= padded[i::BASES_PER_WORD].to(torch.int32) << (4 * i)
    return out


def genome_words(genome) -> np.ndarray:
    """A Genome's packed words: those it carries (Genome.packed_4bit, set
    where the words are made without its codes, e.g. a genome lifted past
    2^31 bases), else pack_genome_4bit of its codes (also for a genome
    object without the attribute, such as the JAX package's)."""
    words = getattr(genome, "packed_4bit", None)
    return pack_genome_4bit(genome.codes) if words is None else words


def gather_windows(genome_p4: torch.Tensor, loc: torch.Tensor, *, width: int,
                   big: bool = False, return_packed: bool = False):
    """(C,) start locations -> (C, width) uint8 base codes (and, with
    return_packed, the (C, n_w) nibble-aligned words as int32-carried u32).

    Windows that run past the table read padding (code 5, matches
    nothing).  big: locations are int32-wrapped uint32 (genomes past 2^31
    bases); otherwise negative starts clamp to 0, as in the JAX gather."""
    n_words = genome_p4.shape[0]
    if big:
        wstart = u32.shr(loc, 3)
    else:
        loc = loc.clamp_min(0)
        wstart = loc >> 3
    sub_off = loc & 7
    n_w = (width + BASES_PER_WORD - 1) // BASES_PER_WORD + 1

    jpos = wstart[:, None] + torch.arange(n_w, dtype=torch.int32,
                                          device=loc.device)[None, :]
    if n_words % ROW_WORDS == 0:
        words = genome_p4[jpos.clamp(0, n_words - 1).long()]
        words = torch.where(jpos < n_words, words,
                            torch.full_like(words, _PAD_WORD))
    else:
        # genomes packed before the ROW_WORDS padding clamp per word
        words = genome_p4[jpos.clamp(0, n_words - 1).long()]

    # nibble-level alignment: conditional funnel shifts of 4/2/1 bases
    pad_col = torch.full_like(words[:, :1], _PAD_WORD)
    for b in (2, 1, 0):
        bits = 4 << b
        w_next = torch.cat([words[:, 1:], pad_col], dim=1)
        shifted = u32.shr(words, bits) | (w_next << (32 - bits))
        words = torch.where(((sub_off & (1 << b)) > 0)[:, None], shifted,
                            words)

    codes = unpack_words(words)
    if return_packed:
        return codes[:, :width], words
    return codes[:, :width]


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """(C, n_w) packed words -> (C, 8 * n_w) u8 nibble codes, from the
    words' little-endian bytes (two codes a byte, low nibble first)."""
    b = words.contiguous().view(torch.uint8)
    return torch.stack([b & 15, b >> 4], dim=2).reshape(words.shape[0], -1)
