"""Batched seed packing + cuckoo hash lookup on the card.

Port of snap_rnaseq_tpu/ops/lookup.py's default (cuckoo) path: the analog
of GenomeIndex::lookupSeed (GenomeIndex.cpp:966-1086) with the probe chain
replaced by the two-level bucket layout that index/hash_index.py builds.

* seeds for a whole batch are packed with vectorized shifts (Seed.h:38-51:
  A=0,G=1,C=2,T=3, RC = code^3 mirrored), over a static schedule;
* each seed is canonicalized against its reverse complement, hashed twice
  (murmur finalizer + Lemire range reduction, matching the host build bit
  for bit) and compared against two 32-word bucket rows plus the stash.

All u32 values ride in int32 tensors (ops/u32.py); the hash runs in int64,
where the 32x32-bit products are exact after masking.
"""
from __future__ import annotations

import torch

from ..constants import UNUSED_HASH_VALUE
from . import u32

_UNUSED = u32.const(UNUSED_HASH_VALUE)
_CK_SALT1 = 0x9E3779B1
_CK_SALT2 = 0x85EBCA77
_M32 = u32.MASK32


def murmur32(key: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 finalizer (HashTable.h:60-72) on u32 lanes (int32)."""
    return u32.from_i64(_murmur64(u32.to_i64(key)))


def _murmur64(k: torch.Tensor) -> torch.Tensor:
    """The finalizer on unsigned values held in int64 (< 2^32)."""
    k = k ^ (k >> 16)
    k = (k * 0x85EBCA6B) & _M32
    k = k ^ (k >> 13)
    k = (k * 0xC2B2AE35) & _M32
    return k ^ (k >> 16)


def pack_seeds(reads: torch.Tensor, positions, seed_len: int) -> dict:
    """Pack the seeds of each read at the static schedule `positions`.

    reads: (B, L) uint8 base codes.  Returns lo/hi (int32-carried u32,
    (B, S)) for the forward and RC packs plus validity; lo = last 16
    bases, hi = the rest (Seed.h:60-66).  One gather brings every seed's
    bases into a (B, S, seed_len) tensor and the packing runs once per
    base position over all seeds (OR of shifted codes, as the JAX
    packing), so the launch count does not grow with the schedule."""
    B, L = reads.shape
    n_hi = max(0, seed_len - 16)
    idx = torch.tensor([[min(int(p) + i, L - 1) for i in range(seed_len)]
                        for p in positions], dtype=torch.long,
                       device=reads.device)                 # (S, seed_len)
    win = reads[:, idx].to(torch.int32)                     # (B, S, seed_len)
    valid = (win < 4).all(dim=2)
    wc = win ^ 3
    zeros = torch.zeros(win.shape[:2], dtype=torch.int32, device=reads.device)
    lo_f, hi_f, lo_r, hi_r = zeros, zeros, zeros, zeros
    for i in range(seed_len):
        sh = 2 * (seed_len - 1 - i)
        if sh >= 32:
            hi_f = hi_f | (win[:, :, i] << (sh - 32))
        else:
            lo_f = lo_f | (win[:, :, i] << sh)
        shr = 2 * i
        if shr >= 32:
            hi_r = hi_r | (wc[:, :, i] << (shr - 32))
        else:
            lo_r = lo_r | (wc[:, :, i] << shr)
    return dict(lo_f=lo_f, hi_f=hi_f, lo_r=lo_r, hi_r=hi_r, valid=valid,
                n_hi_bits=2 * n_hi)


def _canonicalize(packed: dict):
    """Canonical (key, shard) per seed + the fwd/rc value-swap predicates
    (the isBiggerThanItsReverseComplement dance, GenomeIndex.cpp:984-1010)."""
    lo_f, hi_f = packed["lo_f"], packed["hi_f"]
    lo_r, hi_r = packed["lo_r"], packed["hi_r"]
    fwd_smaller = u32.ult(hi_f, hi_r) | ((hi_f == hi_r) & u32.ule(lo_f, lo_r))
    key = torch.where(fwd_smaller, lo_f, lo_r)
    shard = torch.where(fwd_smaller, hi_f, hi_r)
    palindrome = (hi_f == hi_r) & (lo_f == lo_r)
    return key, shard, fwd_smaller, palindrome


def _range_reduce(h: torch.Tensor, n: int) -> torch.Tensor:
    """(h * n) >> 32 for unsigned h < 2^32 held in int64 (Lemire)."""
    return (h * int(n)) >> 32


def lookup_seeds_cuckoo(packed: dict, ck_buckets, ck_buckets2, ck_stash):
    """Two bucket-row gathers per seed + a broadcast stash compare.

    Returns (found bool (B,S), fwd_val, rc_val) with the values as
    int32-carried u32, the same contract as the JAX lookup."""
    key, shard, fwd_smaller, palindrome = _canonicalize(packed)
    valid = packed["valid"]
    CAP = ck_buckets.shape[1] // 4
    k64, s64 = u32.to_i64(key), u32.to_i64(shard)

    h1 = _range_reduce(_murmur64(k64 ^ ((s64 * _CK_SALT1) & _M32)),
                       ck_buckets.shape[0])
    h2 = _range_reduce(
        _murmur64((((k64 + _CK_SALT2) & _M32) ^ ((s64 * _CK_SALT2) & _M32))),
        ck_buckets2.shape[0])

    found = torch.zeros(key.shape, dtype=torch.bool, device=key.device)
    v1 = torch.zeros_like(key)
    v2 = torch.zeros_like(key)
    for tbl, h in ((ck_buckets, h1), (ck_buckets2, h2)):
        rows = tbl[h]                                   # (B, S, 4*CAP)
        for j in range(CAP):
            m = (rows[..., j] == key) & (rows[..., CAP + j] == shard)
            found = found | m
            v1 = torch.where(m, rows[..., 2 * CAP + j], v1)
            v2 = torch.where(m, rows[..., 3 * CAP + j], v2)
    # stash: broadcast compare; the JAX max over matches is a u32 max
    st_m = (key[..., None] == ck_stash[:, 0]) & (shard[..., None] == ck_stash[:, 1])
    any_st = st_m.any(dim=-1)
    found = found | any_st
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    st_v1 = torch.where(st_m, u32.to_i64(ck_stash[:, 2]), zero).amax(dim=-1)
    st_v2 = torch.where(st_m, u32.to_i64(ck_stash[:, 3]), zero).amax(dim=-1)
    v1 = torch.where(any_st, u32.from_i64(st_v1), v1)
    v2 = torch.where(any_st, u32.from_i64(st_v2), v2)

    found = found & valid
    unused = torch.full_like(key, _UNUSED)
    fwd_val = torch.where(found, torch.where(fwd_smaller, v1, v2), unused)
    rc_val = torch.where(found, torch.where(fwd_smaller, v2, v1), unused)
    rc_val = torch.where(palindrome, fwd_val, rc_val)
    return found, fwd_val, rc_val


def expand_counts(val: torch.Tensor, overflow: torch.Tensor, genome_size):
    """Decode an entry half into (count, list_base): count 0 (unused), 1
    (direct location) or the overflow count; list_base indexes `overflow`
    at the first location, or -1 when the value IS the location
    (GenomeIndex.cpp:1013-1086)."""
    is_unused = val == _UNUSED
    is_single = u32.ult(val, genome_size)
    ovf_off = torch.where(is_single | is_unused, torch.zeros_like(val),
                          val - u32.const(genome_size))
    if overflow.shape[0]:
        ovf_count = overflow[ovf_off.clamp(0, overflow.shape[0] - 1).long()]
    else:
        ovf_count = torch.zeros_like(val)
    count = torch.where(is_unused, torch.zeros_like(val),
                        torch.where(is_single, torch.ones_like(val),
                                    ovf_count))
    list_base = torch.where(is_single | is_unused,
                            torch.full_like(val, -1), ovf_off + 1)
    return count, list_base


def gather_hit(slot_in_list, count, list_base, val, overflow):
    """Location of the `slot_in_list`-th hit of an entry half (u32 in
    int32)."""
    direct = list_base < 0
    if overflow.shape[0]:
        ovf_idx = (list_base + slot_in_list).clamp(0, overflow.shape[0] - 1)
        from_ovf = overflow[ovf_idx.long()]
    else:
        from_ovf = torch.zeros_like(val)
    return torch.where(direct, val, from_ovf)
