"""Batched seed packing + hash lookup on the card.

Port of snap_rnaseq_tpu/ops/lookup.py: the analog of
GenomeIndex::lookupSeed (GenomeIndex.cpp:966-1086) and
SNAPHashTable::Lookup (HashTable.h:74-105).

* seeds for a whole batch are packed with vectorized shifts (Seed.h:38-51:
  A=0,G=1,C=2,T=3, RC = code^3 mirrored), over a static schedule;
* each seed is canonicalized against its reverse complement;
* the default lookup (lookup_seeds_cuckoo) hashes it twice (murmur
  finalizer + Lemire range reduction, matching the host build bit for
  bit) and compares it against two 32-word bucket rows plus the stash of
  the two-level bucket layout that index/hash_index.py builds;
* lookup_seeds walks the reference's probe chain over the (slots, 3)
  table instead (SNAP_TPU_LOOKUP=probe): a gather chain in torch code,
  not a kernel;
* seed_lookup_cuda runs the whole cuckoo seed phase on a card as one
  kernel, K7 (csrc/seed_lookup.cu): packing, the first-N-valid selection,
  both bucket rows and the stash, and expand_counts of both halves, with
  the outputs of models/single.py seed_phase_plain, its plain version.

All u32 values ride in int32 tensors (ops/u32.py); the hash runs in int64,
where the 32x32-bit products are exact after masking.
"""
from __future__ import annotations

import torch

from ..constants import (INVALID_GENOME_LOCATION, MAX_SEED_LENGTH,
                         MIN_SEED_LENGTH, UNUSED_HASH_VALUE)
from ..index.hash_index import CUCKOO_STASH
from ..utils import stats
from . import u32

_EMPTY = u32.const(INVALID_GENOME_LOCATION)
_UNUSED = u32.const(UNUSED_HASH_VALUE)
MAX_PROBES = 64  # probes a lane; a longer chain counts as not found
UNROLLED = 4     # probe rounds over every lane before the stragglers' loop
PROBE_WINDOW = 16  # stragglers' probes read at once
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
    idx = stats.to_device("seed_index", torch.tensor(
        [[min(int(p) + i, L - 1) for i in range(seed_len)]
         for p in positions], dtype=torch.long), reads.device)  # (S, len)
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


def _probe(ht_entries, base, idx, key):
    """One probe of the entry at base + idx: (holds `key`, is empty,
    value1, value2)."""
    e = ht_entries[(base + idx).long()]
    v1 = e[..., 1]
    return (e[..., 0] == key) & (v1 != _EMPTY), v1 == _EMPTY, v1, e[..., 2]


def lookup_seeds(packed: dict, ht_entries, shard_start, shard_size, *,
                 rem: int | None = None,
                 max_probes: int | None = MAX_PROBES):
    """Probe the index's probe-chain table for every (read, seed).

    ht_entries: (slots, 3) int32-carried u32, the reference's 12-byte
    {key, value1, value2} entries interleaved (HashTable.h:119-123);
    shard_start / shard_size: (n_shards,) int32 slot range of each
    per-high-bases table (GenomeIndex.cpp:316).  Probes follow the
    reference's sequence (murmur start, then +1, +4, +9, +16, then +1).
    UNROLLED rounds run over every lane; the stragglers are then taken in
    blocks of `rem` lanes (default min(B*S, max(256, B*S // 16)), as the
    JAX package) and walked until each ends, PROBE_WINDOW probes at a
    time, the host checking after each window whether any lane of the
    block is still going, and at most to max_probes probes a lane (a
    chain cut there counts as not found, as in the JAX package; None
    walks every chain to its end, as the host GenomeIndex.lookup_seed
    does).  The results do not depend on `rem` or the window.

    Returns (found bool (B,S), fwd_val, rc_val) with the values as
    int32-carried u32, already swapped so fwd_val describes the seed as
    read and rc_val its reverse complement (the
    isBiggerThanItsReverseComplement dance, GenomeIndex.cpp:984-1010)."""
    key, shard, fwd_smaller, palindrome = _canonicalize(packed)
    valid = packed["valid"]
    n_shards = shard_start.shape[0]
    # a seed with a non-base code packs to an arbitrary shard id; it is
    # dead (~valid), so any in-range shard serves its (unused) probe
    sh = shard.long().clamp(0, n_shards - 1)
    base = shard_start[sh]
    size = shard_size[sh]
    size_safe = size.clamp_min(1)
    idx = (_murmur64(u32.to_i64(key)) % size_safe.long()).to(torch.int32)
    # a dead lane's base may sit past the last slot (an empty last shard)
    base = base.clamp_max(ht_entries.shape[0] - 1)

    hit, _, v1, v2 = _probe(ht_entries, base, idx, key)
    dead = (size <= 0) | ~valid
    done = hit | dead
    found = hit & ~dead
    unused = torch.full_like(key, _UNUSED)
    slot_v1 = torch.where(hit, v1, unused)
    slot_v2 = torch.where(hit, v2, unused)
    n_probes = torch.zeros_like(idx)
    for r in range(1, UNROLLED + 1):
        idx = torch.where(done, idx, (idx + r * r) % size_safe)
        n_probes = torch.where(done, n_probes, n_probes + 1)
        hit, empty, v1, v2 = _probe(ht_entries, base, idx, key)
        newly = ~done & (hit | empty | (n_probes > size + 5))
        got = newly & hit
        found = found | got
        slot_v1 = torch.where(got, v1, slot_v1)
        slot_v2 = torch.where(got, v2, slot_v2)
        done = done | newly

    # the stragglers, compacted pending-first in lane order; a pending
    # lane has found False and UNUSED values, so its block's results are
    # written back as they are
    BS = key.numel()
    rem = rem or min(BS, max(256, BS // 16))
    flat = lambda x: x.reshape(BS)
    found, slot_v1, slot_v2 = flat(found), flat(slot_v1), flat(slot_v2)
    with stats.sync("probe_pending"):
        pending = torch.nonzero(~flat(done)).squeeze(1)
    for lo in range(0, pending.numel(), rem):
        take = pending[lo:lo + rem]
        c_key, c_base = flat(key)[take], flat(base)[take]
        c_size = flat(size_safe)[take]
        c_idx = flat(idx)[take]
        c_done = torch.zeros_like(take, dtype=torch.bool)
        c_found = torch.zeros_like(c_done)
        c_v1 = torch.full_like(c_key, _UNUSED)
        c_v2 = torch.full_like(c_key, _UNUSED)
        # past the unrolled rounds every step is +1: the t-th further
        # probe reads slot (idx + t) % size, and a lane stops at a hit, an
        # empty slot or once its probe count passes size + 5; a window of
        # PROBE_WINDOW probes is read at once and each lane takes its first
        # stop in it (the per-probe walk's answer, in fewer operations)
        t0 = 0
        while max_probes is None or t0 < max_probes - UNROLLED:
            w = PROBE_WINDOW if max_probes is None else \
                min(PROBE_WINDOW, max_probes - UNROLLED - t0)
            t = torch.arange(t0 + 1, t0 + w + 1, dtype=torch.int32,
                             device=key.device)
            hit, empty, v1, v2 = _probe(                      # (R, w)
                ht_entries, c_base[:, None],
                (c_idx[:, None] + t) % c_size[:, None], c_key[:, None])
            stop = hit | empty | (UNROLLED + t > c_size[:, None] + 5)
            j = torch.where(stop, t - t0 - 1, w).amin(dim=1, keepdim=True)
            newly = ~c_done & (j[:, 0] < w)
            j = j.clamp_max(w - 1).long()
            got = newly & hit.gather(1, j)[:, 0]
            c_found = c_found | got
            c_v1 = torch.where(got, v1.gather(1, j)[:, 0], c_v1)
            c_v2 = torch.where(got, v2.gather(1, j)[:, 0], c_v2)
            c_done = c_done | newly
            t0 += w
            stats.count("lookup.probe_windows")
            if stats.host_int("probe_window", c_done.all()):
                break
        found[take], slot_v1[take], slot_v2[take] = c_found, c_v1, c_v2
    found = found.reshape(key.shape)
    v1, v2 = slot_v1.reshape(key.shape), slot_v2.reshape(key.shape)

    fwd_val = torch.where(found, torch.where(fwd_smaller, v1, v2), unused)
    rc_val = torch.where(found, torch.where(fwd_smaller, v2, v1), unused)
    rc_val = torch.where(palindrome, fwd_val, rc_val)
    return found, fwd_val, rc_val


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


def seed_lookup_cuda(reads, positions, seed_len: int, tables: dict,
                     overflow, genome_size: int,
                     select_first_valid: int = 0) -> dict:
    """K7 wrapper: models/single.py seed_phase's outputs (valid, found,
    counts, bases, vals, and sel_pos when select_first_valid = N > 0) from
    the cuckoo layout in `tables`, in one launch on the current stream.

    positions: the schedule's S positions, an int32 tensor on the reads'
    card (the engines' `schedule`), each >= 0 as a schedule's are (a seed
    past the read's end repeats its last base, as pack_seeds does; K7
    reads a negative position as 0).  Checks the seed length,
    N (0-S), dtypes, shapes, contiguity and alignment, then that the
    tensors are on a card, and raises on what K7 does not take.  Counts
    K7_seed_lookup and the recorder's lookup.kernel_seeds (the B x (N or
    S) columns it wrote)."""
    from . import kernels as kx
    N = int(select_first_valid)
    if not MIN_SEED_LENGTH <= seed_len <= MAX_SEED_LENGTH:
        raise ValueError(f"seed_lookup_cuda takes seed lengths "
                         f"{MIN_SEED_LENGTH}-{MAX_SEED_LENGTH}, got "
                         f"{seed_len}")
    dev = reads.device
    reads = reads.contiguous()
    b1, b2, stash = (tables[k] for k in ("ck_buckets", "ck_buckets2",
                                         "ck_stash"))
    kx.require(reads, "reads", torch.uint8, 2, dev)
    kx.require(positions, "positions", torch.int32, 1, dev)
    kx.require(b1, "ck_buckets", torch.int32, 2, dev)
    kx.require(b2, "ck_buckets2", torch.int32, 2, dev)
    kx.require(stash, "ck_stash", torch.int32, 2, dev)
    kx.require(overflow, "overflow", torch.int32, 1, dev)
    S = positions.shape[0]
    if not 0 <= N <= S:
        raise ValueError(f"seed_lookup_cuda: select_first_valid {N} must "
                         f"lie in 0-{S} (the schedule's positions)")
    if (b1.shape[1] != 32 or b2.shape[1] != 32 or min(b1.shape[0],
                                                      b2.shape[0]) < 1
            or tuple(stash.shape) != (CUCKOO_STASH, 4)
            or reads.shape[1] < 1):
        raise ValueError(
            f"seed_lookup_cuda: ck_buckets {tuple(b1.shape)}, ck_buckets2 "
            f"{tuple(b2.shape)} (rows of 32 words), ck_stash "
            f"{tuple(stash.shape)} ({CUCKOO_STASH} x 4), reads "
            f"{tuple(reads.shape)}")
    if dev.type != "cuda":
        raise RuntimeError(f"seed_lookup_cuda needs CUDA tensors, got {dev}")
    if any(t.data_ptr() % 16 for t in (b1, b2, stash)):
        raise ValueError("seed_lookup_cuda: the bucket rows and the stash "
                         "must start at 16-byte boundaries")
    B = reads.shape[0]
    n = N or S
    i32 = dict(dtype=torch.int32, device=dev)
    out = dict(valid=torch.empty((B, n), dtype=torch.bool, device=dev),
               found=torch.empty((B, n), dtype=torch.bool, device=dev),
               counts=torch.empty((B, n, 2), **i32),
               bases=torch.empty((B, n, 2), **i32),
               vals=torch.empty((B, n, 2), **i32))
    if N:
        out["sel_pos"] = torch.empty((B, N), **i32)
    if B == 0 or S == 0:
        return out
    err = kx.launcher("seed_lookup")(
        kx.ptr(reads), B, reads.shape[1], kx.ptr(positions), S, seed_len, N,
        kx.ptr(b1), b1.shape[0], kx.ptr(b2), b2.shape[0], kx.ptr(stash),
        stash.shape[0], kx.ptr(overflow), overflow.shape[0],
        int(genome_size) & _M32, kx.ptr(out["valid"]), kx.ptr(out["found"]),
        kx.ptr(out["counts"]), kx.ptr(out["bases"]), kx.ptr(out["vals"]),
        kx.ptr(out.get("sel_pos")), kx.stream())
    kx.check(err, "seed_lookup_launch")
    kx.count_launch("K7_seed_lookup")
    stats.count("lookup.kernel_seeds", B * n)
    return out
