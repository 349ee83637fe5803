"""The genome seed index: open-addressed hash tables + overflow list.

TPU-native analog of reference SNAPLib/{HashTable,GenomeIndex}.{h,cpp}.
Behavioral contract (what lookupSeed returns) matches the reference exactly:

* one logical table per seed "high bases" value (the bases beyond the last
  16): 4^(seedLen-16) shards, the same partitioning the reference uses
  (GenomeIndex.cpp:316) and the natural multi-chip sharding seam;
* each entry is {key: u32 (canonical seed low bases), value1: u32, value2: u32}
  where value1 holds the hits of the *lower* of (seed, RC-seed) and value2 the
  higher (HashTable.h:119-123); 0xFFFFFFFE marks an unused half; values >=
  genome size point into a shared overflow table laid out as
  [count, loc0 > loc1 > ...] (descending) per repeated seed
  (GenomeIndex.cpp:538-620, 966-1086);
* probing is MurmurHash3-finalizer start, quadratic for 5 probes then linear
  (HashTable.h:60-105), empty slot = value1 == 0xFFFFFFFF.

The *build* is a clean-room redesign: instead of the reference's multithreaded
genome scan with per-table locks, approximate counters and 350k lines of
precomputed bias tables (GenomeIndex.cpp:1109-1578, BiasTables.cpp), we pack
every seed vectorized, lexsort (key, half, -location) once, and size every
shard from exact distinct counts.  All arrays are flat and ready to ship to
TPU HBM (see device_arrays()).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (INVALID_GENOME_LOCATION, MAX_SEED_LENGTH,
                         MIN_SEED_LENGTH, UNUSED_HASH_VALUE)
from ..ops import u32
from ..utils import stats
from .genome import Genome
from .seeds import (murmur_finalize_torch, murmur_finalize_u32,
                    pack_all_seeds, pack_all_seeds_torch)

QUADRATIC_CHAINING_DEPTH = 5  # HashTable.h:117
_EMPTY = np.uint32(INVALID_GENOME_LOCATION)
_UNUSED = np.uint32(UNUSED_HASH_VALUE)


@dataclass
class GenomeIndex:
    genome: Genome
    seed_len: int
    ht_keys: np.ndarray        # uint32[total_slots]
    ht_val1: np.ndarray        # uint32[total_slots]
    ht_val2: np.ndarray        # uint32[total_slots]
    shard_starts: np.ndarray   # int64[n_shards+1] slot offset of each shard
    overflow: np.ndarray       # uint32[overflow_len]
    # overflow offset where each logical shard's entries begin; the overflow
    # list is laid out in canonical-seed order, so shards own contiguous
    # overflow ranges — the seam that lets a pod slice the whole index by
    # seed high-bases (see parallel/sharded.py)
    shard_ovf_starts: np.ndarray = None  # int64[n_shards+1]

    @property
    def n_shards(self) -> int:
        return self.shard_starts.shape[0] - 1

    @property
    def genome_size(self) -> int:
        return self.genome.num_bases

    # ------------------------------------------------------------------
    # host-side lookup (oracle for tests; the batched TPU path lives in
    # ops/lookup.py and must agree with this bit-for-bit)
    # ------------------------------------------------------------------

    def _probe(self, shard: int, key: int) -> int:
        """Return global slot index holding `key`, or -1."""
        start = int(self.shard_starts[shard])
        size = int(self.shard_starts[shard + 1]) - start
        if size <= 0:
            return -1
        idx = int(murmur_finalize_u32(np.uint32(key))) % size
        if self.ht_keys[start + idx] == key and self.ht_val1[start + idx] != _EMPTY:
            return start + idx
        n_probes = 0
        while True:
            n_probes += 1
            if n_probes > size + QUADRATIC_CHAINING_DEPTH:
                return -1
            if n_probes < QUADRATIC_CHAINING_DEPTH:
                idx = (idx + n_probes * n_probes) % size
            else:
                idx = (idx + 1) % size
            if self.ht_val1[start + idx] == _EMPTY:
                return -1
            if self.ht_keys[start + idx] == key:
                return start + idx

    def _expand_half(self, value: int, min_loc: int, max_loc: int) -> np.ndarray:
        if value == _UNUSED:
            return np.zeros(0, dtype=np.uint32)
        if value < self.genome_size:
            v = np.asarray([value], dtype=np.uint32)
        else:
            off = value - self.genome_size
            count = int(self.overflow[off])
            v = self.overflow[off + 1:off + 1 + count]
        if min_loc == 0 and max_loc == INVALID_GENOME_LOCATION:
            return v
        return v[(v >= min_loc) & (v <= max_loc)]

    def lookup_seed(self, fwd: int, rc: int, min_loc: int = 0,
                    max_loc: int = INVALID_GENOME_LOCATION):
        """Returns (hits, rc_hits) — descending uint32 location arrays for the
        seed and its reverse complement, like GenomeIndex::lookupSeed."""
        fwd, rc = int(fwd), int(rc)
        canonical = min(fwd, rc)
        swapped = fwd > rc
        shard = canonical >> 32
        key = canonical & 0xFFFFFFFF
        slot = self._probe(int(shard), int(key))
        if slot < 0:
            z = np.zeros(0, dtype=np.uint32)
            return z, z.copy()
        v1, v2 = int(self.ht_val1[slot]), int(self.ht_val2[slot])
        lo = self._expand_half(v1, min_loc, max_loc)
        if fwd == rc:
            return lo, lo
        hi = self._expand_half(v2, min_loc, max_loc)
        return (hi, lo) if swapped else (lo, hi)

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        self.genome.save(directory)
        with open(os.path.join(directory, "index.json"), "w") as f:
            json.dump({"format": "snap-rnaseq-tpu-index", "version": 1,
                       "seed_len": self.seed_len,
                       "total_slots": int(self.ht_keys.shape[0]),
                       "overflow_len": int(self.overflow.shape[0])}, f)
        np.save(os.path.join(directory, "ht_keys.npy"), self.ht_keys)
        np.save(os.path.join(directory, "ht_val1.npy"), self.ht_val1)
        np.save(os.path.join(directory, "ht_val2.npy"), self.ht_val2)
        np.save(os.path.join(directory, "shard_starts.npy"), self.shard_starts)
        np.save(os.path.join(directory, "overflow.npy"), self.overflow)
        np.save(os.path.join(directory, "shard_ovf_starts.npy"), self.shard_ovf_starts)
        # A rebuilt index invalidates any cached device bucket layout for
        # the PREVIOUS contents of this directory (the layout is a pure
        # function of the table; a stale one silently mislooks up seeds).
        stale = os.path.join(directory, "bucket_layout_v2.npz")
        if os.path.exists(stale):
            os.remove(stale)
        object.__setattr__(self, "_dir", directory)

    @classmethod
    def load(cls, directory: str, mmap: bool = True) -> "GenomeIndex":
        if not os.path.exists(os.path.join(directory, "index.json")):
            # Transparently accept a reference-format index directory
            # (GenomeIndex/Genome/GenomeIndexHash/OverflowTable) so existing
            # SNAP indices work unchanged; see index/snap_format.py.
            from .snap_format import is_snap_format_dir, load_snap_index
            if is_snap_format_dir(directory):
                return load_snap_index(directory)
        with open(os.path.join(directory, "index.json")) as f:
            meta = json.load(f)
        mm = "r" if mmap else None
        load = lambda n: np.load(os.path.join(directory, n), mmap_mode=mm)
        idx = cls(genome=Genome.load(directory, mmap=mmap),
                  seed_len=int(meta["seed_len"]),
                  ht_keys=load("ht_keys.npy"), ht_val1=load("ht_val1.npy"),
                  ht_val2=load("ht_val2.npy"),
                  shard_starts=load("shard_starts.npy"),
                  overflow=load("overflow.npy"),
                  shard_ovf_starts=load("shard_ovf_starts.npy"))
        object.__setattr__(idx, "_dir", directory)
        return idx

    def device_arrays(self) -> dict:
        """Arrays for the jitted lookup kernel, as plain numpy (uint32/int32).

        64-bit-free on purpose: shard starts fit int64 on host but the device
        kernel receives per-shard (start, size) as int32 pairs when total
        slots < 2^31 (always true for genomes this index supports).
        """
        starts = self.shard_starts
        return dict(
            ht_entries=np.ascontiguousarray(
                np.stack([self.ht_keys, self.ht_val1, self.ht_val2], axis=1)),
            shard_start=starts[:-1].astype(np.int32),
            shard_size=np.diff(starts).astype(np.int32),
            overflow=np.ascontiguousarray(self.overflow),
            genome_codes=np.ascontiguousarray(self.genome.codes),
            genome_size=np.int64(self.genome_size),
        )


# ----------------------------------------------------------------------
# device lookup layout: (2,4)-bucketized cuckoo
# ----------------------------------------------------------------------
#
# The on-disk/table format above keeps the reference's probe-chain layout
# (needed for both-ways SNAP interop, snap_format.py).  The DEVICE lookup
# does not have to probe, though: we own the layout, so at load time we
# rehash every occupied entry into a two-level bucket table — each
# (key, shard) lives in its h1-addressed 8-entry L1 bucket, or (for the
# ~2% of entries whose L1 bucket overflows) its h2-addressed 8-entry L2
# bucket, or a tiny fixed stash.  The batched lookup is a fixed TWO
# 128-byte row gathers + a broadcast stash compare.  No while_loop, no
# data-dependent probe chains — the TPU shape of SNAPHashTable::Lookup
# (HashTable.h:74-105) with the probe chain compiled away.  The build is
# deterministic and one-shot: two sort/rank passes, no iteration.
# Bucket row layout: 32 u32 = [klo x8 | khi x8 | v1 x8 | v2 x8]; empty
# entry khi = 0xFFFFFFFF (valid shards are < 4^9).

CUCKOO_STASH = 128
BUCKET_CAP = 8
_CK_SALT1 = np.uint32(0x9E3779B1)
_CK_SALT2 = np.uint32(0x85EBCA77)


def _ck_h1(key, shard, nb):
    """Bucket of (key, shard) in an nb-bucket table: murmur + Lemire range
    reduction ((h * nb) >> 32) — matches ops/lookup.py _range_reduce, which
    avoids the TPU's slow u32 modulo."""
    h = murmur_finalize_u32(key ^ (shard * _CK_SALT1))
    return ((h.astype(np.uint64) * np.uint64(nb)) >> np.uint64(32)).astype(np.int64)


def _ck_h2(key, shard, nb):
    h = murmur_finalize_u32((key + _CK_SALT2) ^ (shard * _CK_SALT2))
    return ((h.astype(np.uint64) * np.uint64(nb)) >> np.uint64(32)).astype(np.int64)


def _rank_in_bucket(b: np.ndarray):
    """(order, rank) of each element within its bucket value group.  The
    order is the stable argsort of b (int64), taken as the plain argsort
    of the distinct keys b * n + i, which numpy sorts about 2.5x faster
    than its stable sort."""
    n = b.size
    order = np.argsort(b * n + np.arange(n), kind="quicksort")
    bs = b[order]
    first = np.concatenate([[True], bs[1:] != bs[:-1]])
    grp_start = np.maximum.accumulate(np.where(first, np.arange(bs.size), 0))
    return order, bs, (np.arange(bs.size) - grp_start).astype(np.int64)


def _fill_buckets(nb, bucket_of, rank, src_idx, keys, shards, v1, v2):
    buckets = np.zeros((nb, 4 * BUCKET_CAP), np.uint32)
    buckets[:, BUCKET_CAP:2 * BUCKET_CAP] = _EMPTY
    buckets[bucket_of, rank] = keys[src_idx]
    buckets[bucket_of, BUCKET_CAP + rank] = shards[src_idx]
    buckets[bucket_of, 2 * BUCKET_CAP + rank] = v1[src_idx]
    buckets[bucket_of, 3 * BUCKET_CAP + rank] = v2[src_idx]
    return buckets


def build_cuckoo_layout(ht_keys, ht_val1, ht_val2, shard_starts,
                        verbose: bool = False, shard_base: int = 0,
                        nb1: int = None, nb2_min: int = None) -> dict:
    """Rehash the occupied slots of the probe-chain table into the
    two-level bucket layout.  Deterministic: one rank pass per level.

    shard_base: global logical-shard id of shard_starts[0] — device slices
    of a sharded index pass their range offset so the hash sees GLOBAL
    shard ids (the lookup hashes (key, global shard)).
    nb1 / nb2_min: optional size overrides so per-device slices of a
    sharded index can be built to one common shape.
    """
    occ = ht_val1 != _EMPTY
    keys = ht_keys[occ].astype(np.uint32)
    v1 = ht_val1[occ]
    v2 = ht_val2[occ]
    slot_idx = np.nonzero(occ)[0]
    shards = (np.searchsorted(shard_starts, slot_idx, side="right") - 1
              + shard_base).astype(np.uint32)
    del slot_idx
    n = keys.shape[0]

    # L1: h1-addressed, load 0.8 of the 8-entry buckets (the modulo on
    # device is by a trace-time constant, so XLA strength-reduces it)
    if nb1 is None:
        nb1 = max(16, int(np.ceil(n / (BUCKET_CAP * 0.8))))
    h1 = _ck_h1(keys, shards, nb1)
    order, bs, rank = _rank_in_bucket(h1)
    fits = rank < BUCKET_CAP
    buckets1 = _fill_buckets(nb1, bs[fits], rank[fits], order[fits],
                             keys, shards, v1, v2)
    spill = order[~fits]

    # L2: h2-addressed buckets for the spillers, sized so its own spill
    # fits the stash (grown geometrically in the rare case it does not)
    nb2 = max(nb2_min or 16, 16, (spill.size // (2 * BUCKET_CAP)) + 1)
    while True:
        h2 = _ck_h2(keys[spill], shards[spill], nb2)
        order2, bs2, rank2 = _rank_in_bucket(h2)
        fits2 = rank2 < BUCKET_CAP
        if (~fits2).sum() <= CUCKOO_STASH:
            break
        nb2 = int(nb2 * 1.6) + 1
    buckets2 = _fill_buckets(nb2, bs2[fits2], rank2[fits2],
                             spill[order2[fits2]], keys, shards, v1, v2)
    rest = spill[order2[~fits2]]

    stash = np.zeros((CUCKOO_STASH, 4), np.uint32)
    stash[:, 1] = _EMPTY
    stash[:rest.size, 0] = keys[rest]
    stash[:rest.size, 1] = shards[rest]
    stash[:rest.size, 2] = v1[rest]
    stash[:rest.size, 3] = v2[rest]
    if verbose:
        print(f"bucket layout: {n} entries, L1 {nb1} buckets "
              f"(load {n / (BUCKET_CAP * nb1):.2f}), L2 {nb2} buckets "
              f"({spill.size} spill), stash {rest.size}")
    return dict(ck_buckets=buckets1, ck_buckets2=buckets2, ck_stash=stash)


def _table_fingerprint(index: "GenomeIndex") -> np.ndarray:
    """Cheap content fingerprint of the hash table, used to tie a cached
    bucket layout to the table it was built from.  Strided samples (so the
    cost is O(MB) even on multi-GB tables) + exact shape/occupancy counts;
    any rebuild into the same directory changes it."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    for arr in (index.ht_keys, index.ht_val1, index.ht_val2,
                index.shard_starts, index.overflow):
        a = np.asarray(arr)
        h.update(np.int64(a.shape[0]).tobytes())
        stride = max(1, a.shape[0] // 65536)
        h.update(np.ascontiguousarray(a[::stride]).tobytes())
    h.update(np.int64(index.seed_len).tobytes())
    return np.frombuffer(h.digest(), dtype=np.uint8)


def cuckoo_layout_for(index: "GenomeIndex", verbose: bool = False) -> dict:
    """Build the device bucket layout, memoized on the index object and —
    when the index came from / lives in a directory — cached on disk
    beside it (the layout is a pure function of the table contents).
    The cache carries a content fingerprint and is rebuilt on mismatch,
    so a stale layout can never serve lookups for a rebuilt table."""
    cached = getattr(index, "_cuckoo_layout", None)
    if cached is not None:
        return cached
    d = getattr(index, "_dir", None)
    path = os.path.join(d, "bucket_layout_v2.npz") if d else None
    fp = _table_fingerprint(index)
    if path and os.path.exists(path):
        z = np.load(path)
        if "fingerprint" in z and np.array_equal(z["fingerprint"], fp):
            cached = dict(ck_buckets=z["ck_buckets"],
                          ck_buckets2=z["ck_buckets2"],
                          ck_stash=z["ck_stash"])
    if cached is None:
        with stats.span("index.cuckoo_layout"):
            cached = build_cuckoo_layout(index.ht_keys, index.ht_val1,
                                         index.ht_val2, index.shard_starts,
                                         verbose=verbose)
        if path:
            # written whole under another name, then renamed: processes
            # that open a fresh index at once never load a partial file
            tmp = f"{path}.tmp{os.getpid()}"
            try:
                with open(tmp, "wb") as f:
                    np.savez(f, fingerprint=fp, **cached)
                os.replace(tmp, path)
            except OSError:
                pass    # read-only index dir: memoize in memory only
    object.__setattr__(index, "_cuckoo_layout", cached)
    return cached


# ----------------------------------------------------------------------
# builder
# ----------------------------------------------------------------------

def build_index(genome: Genome, seed_len: int, load_factor: float = 0.7,
                verbose: bool = False) -> GenomeIndex:
    if not MIN_SEED_LENGTH <= seed_len <= MAX_SEED_LENGTH:
        raise ValueError(f"seed length must be in [{MIN_SEED_LENGTH}, {MAX_SEED_LENGTH}]")
    if genome.num_bases >= 0xFFFFFFF0:
        raise ValueError("genome too large for 32-bit locations")

    fwd, rc, valid = pack_all_seeds(genome.codes, seed_len)
    locs = np.nonzero(valid)[0].astype(np.uint32)
    fwd = fwd[valid]
    rc = rc[valid]

    # ONE radix-sortable u64 key: (canonical << 1) | half — canonical uses
    # <= 2*25 bits so the packed key always fits.  A single stable integer
    # argsort (numpy radix) replaces the old 3-key lexsort (3 mergesort
    # passes); stability keeps locations ASCENDING within each group (the
    # seed stream is position-ordered), and _grouped_tables writes overflow
    # lists with reversed ranks to recover the reference's descending order.
    sortkey = (np.minimum(fwd, rc) << np.uint64(1)) | (fwd > rc)
    del fwd, rc
    order = np.argsort(sortkey, kind="stable")
    sk = sortkey[order]
    cl = locs[order]
    del sortkey, locs, order

    (distinct_keys, val1, val2, overflow, multi_entry_starts,
     multi_keys) = _grouped_tables(sk, cl, genome.num_bases, 0)
    overflow_len = overflow.shape[0]
    if genome.num_bases + overflow_len > 0xFFFFFFF0:
        raise ValueError("overflow table too large; use a longer seed")
    del sk, cl

    # shard by high bases; distinct_keys are sorted so shards are contiguous
    n_shards = 4 ** max(0, seed_len - 16)
    shard_of_key = (distinct_keys >> np.uint64(32)).astype(np.int64)
    keys_per_shard = np.bincount(shard_of_key, minlength=n_shards)
    shard_sizes = np.maximum(2, np.ceil(keys_per_shard / load_factor).astype(np.int64) + 1)
    shard_sizes[keys_per_shard == 0] = 0
    shard_starts = np.concatenate(([0], np.cumsum(shard_sizes)))
    total_slots = int(shard_starts[-1])

    ht_keys = np.zeros(total_slots, dtype=np.uint32)
    ht_val1 = np.full(total_slots, _EMPTY, dtype=np.uint32)
    ht_val2 = np.zeros(total_slots, dtype=np.uint32)

    _insert_all(ht_keys, ht_val1, ht_val2,
                shard_starts, shard_sizes, shard_of_key,
                (distinct_keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                val1, val2, verbose=verbose)

    # overflow entries are in canonical order, so each logical shard owns a
    # contiguous overflow range; record the boundaries for index sharding
    shard_ovf_starts = _ovf_shard_bounds(multi_keys, multi_entry_starts,
                                         overflow_len, n_shards)

    return GenomeIndex(genome=genome, seed_len=seed_len,
                       ht_keys=ht_keys, ht_val1=ht_val1, ht_val2=ht_val2,
                       shard_starts=shard_starts, overflow=overflow,
                       shard_ovf_starts=shard_ovf_starts)


def entry_starts_at(is_multi: np.ndarray, entry_starts: np.ndarray) -> np.ndarray:
    """Expand compacted entry_starts back to per-group positions (0 where single)."""
    out = np.zeros(is_multi.shape[0], dtype=np.uint64)
    out[is_multi] = entry_starts.astype(np.uint64)
    return out


def _grouped_tables(sk, cl, num_bases, ovf_base):
    """Core grouping over a SORTED combined-key stream.

    ``sk`` is the u64 packed key ``(canonical << 1) | half`` and ``cl`` the
    matching locations, sorted stably by ``sk`` — so locations are
    ASCENDING within each group (the seed stream is position-ordered).
    Works on any canonical-contiguous slice (the whole genome, or one
    shard's bucket in the chunked builder); overflow pointers are emitted
    relative to ``ovf_base`` so per-shard chunks concatenate into one
    global overflow table.  Overflow location lists are written with
    REVERSED ranks, recovering the reference's descending order
    (GenomeIndex.cpp:538-620) without a location sort key.

    Returns (distinct_keys u64, val1, val2, overflow_chunk u32,
    multi_entry_starts int64 absolute, multi_keys u64).
    """
    n = sk.shape[0]
    if n == 0:
        z32 = np.zeros(0, np.uint32)
        return (np.zeros(0, np.uint64), z32, z32, z32,
                np.zeros(0, np.int64), np.zeros(0, np.uint64))
    # element indexes stay well under 2^31 for non-chunked builds and for
    # per-shard chunks at hg19 scale; int32 halves the cumsum/gather traffic
    idt = np.int32 if n < 2**31 else np.int64
    new_group = np.empty(n, dtype=bool)
    new_group[0] = True
    np.not_equal(sk[1:], sk[:-1], out=new_group[1:])
    group_start = np.nonzero(new_group)[0].astype(idt)
    group_count = np.diff(group_start, append=idt(n))
    n_groups = group_start.shape[0]

    genome_size = np.uint32(num_bases)

    # overflow layout: concatenated [count, locs...] for every group with >=2 hits
    is_multi = group_count >= 2
    multi_counts = group_count[is_multi]
    entry_sizes = multi_counts.astype(np.int64) + 1
    entry_starts = np.concatenate(([0], np.cumsum(entry_sizes)))[:-1]
    overflow_len = int(entry_sizes.sum()) if multi_counts.size else 0
    overflow = np.empty(overflow_len, dtype=np.uint32)
    if overflow_len:
        overflow[entry_starts] = multi_counts.astype(np.uint32)
        multi_group_idx = np.nonzero(is_multi)[0]
        elem_group = np.cumsum(new_group, dtype=idt) - idt(1)
        in_multi = is_multi[elem_group]
        rank = np.arange(n, dtype=idt) - group_start[elem_group]
        slot_of_group = np.full(n_groups, -1, dtype=np.int64)
        slot_of_group[multi_group_idx] = entry_starts
        eg_m = elem_group[in_multi]
        # ascending input + reversed rank -> descending stored list
        dest = slot_of_group[eg_m] + group_count[eg_m] - rank[in_multi]
        overflow[dest] = cl[in_multi]

    # per-(key,half) value (overflow pointers rebased by ovf_base)
    group_value = np.where(
        is_multi,
        genome_size + np.uint64(ovf_base) + entry_starts_at(is_multi, entry_starts),
        cl[group_start].astype(np.uint64)).astype(np.uint32)

    # collapse to distinct keys: (value1, value2)
    sk_of_group = sk[group_start]
    key_of_group = sk_of_group >> np.uint64(1)
    new_key = np.empty(n_groups, dtype=bool)
    new_key[0] = True
    np.not_equal(key_of_group[1:], key_of_group[:-1], out=new_key[1:])
    key_start = np.nonzero(new_key)[0]
    n_keys = key_start.shape[0]
    distinct_keys = key_of_group[key_start]

    val1 = np.full(n_keys, _UNUSED, dtype=np.uint32)
    val2 = np.full(n_keys, _UNUSED, dtype=np.uint32)
    key_id_of_group = (np.cumsum(new_key, dtype=idt) - idt(1))
    h0 = (sk_of_group & np.uint64(1)) == 0
    val1[key_id_of_group[h0]] = group_value[h0]
    val2[key_id_of_group[~h0]] = group_value[~h0]
    return (distinct_keys.astype(np.uint64), val1, val2, overflow,
            entry_starts.astype(np.int64) + ovf_base,
            key_of_group[is_multi].astype(np.uint64))


def _insert_all(ht_keys, ht_val1, ht_val2, shard_starts, shard_sizes,
                shard_of_key, keys_u32, val1, val2, verbose=False,
                claim_base=0, claim_size=None):
    """Vectorized multi-round open-addressing insertion.

    Every round, each still-pending key proposes its current probe slot; the
    first pending key per free slot wins (resolved with np.unique); everyone
    else advances one probe step (quadratic for the first 5, then linear),
    exactly the probe sequence of SNAPHashTable::Lookup so lookups terminate.

    claim_base/claim_size bound the slot-claim scratch to the slot range the
    call can touch (used by the per-shard driver below; defaults cover the
    whole table).
    """
    n = keys_u32.shape[0]
    sizes = shard_sizes[shard_of_key]
    base = shard_starts[shard_of_key]
    idx = murmur_finalize_u32(keys_u32).astype(np.int64) % np.maximum(sizes, 1)
    pending = np.arange(n)
    n_probes = np.zeros(n, dtype=np.int64)
    # slot-claim scratch, reused across rounds WITHOUT clearing: every slot
    # read in a round was just written in the same round, so stale entries
    # are never observed.  Writing candidates REVERSED makes the lowest
    # pending id win per slot (numpy fancy assignment keeps the last
    # write), reproducing the old np.unique first-occurrence winner —
    # layouts stay bit-identical — at O(candidates) instead of a sort.
    if claim_size is None:
        claim_size = int(shard_starts[-1]) if len(shard_starts) else 0
    claim = np.empty(claim_size, dtype=np.int64)
    round_no = 0
    while pending.size:
        slots = (base[pending] + idx[pending])
        free = ht_val1[slots] == _EMPTY
        free_pos = np.nonzero(free)[0]
        cand = pending[free_pos]
        cand_slots = slots[free_pos] - claim_base
        claim[cand_slots[::-1]] = cand[::-1]
        won = claim[cand_slots] == cand
        cand_slots = cand_slots + claim_base
        winners = cand[won]
        win_slots = cand_slots[won]
        ht_keys[win_slots] = keys_u32[winners]
        ht_val1[win_slots] = val1[winners]
        ht_val2[win_slots] = val2[winners]
        placed = np.zeros(pending.shape[0], dtype=bool)
        placed[free_pos[won]] = True
        pending = pending[~placed]
        if pending.size:
            n_probes[pending] += 1
            np_p = n_probes[pending]
            step = np.where(np_p < QUADRATIC_CHAINING_DEPTH, np_p * np_p, 1)
            idx[pending] = (idx[pending] + step) % sizes[pending]
        round_no += 1
        if verbose and round_no % 8 == 0:
            print(f"  insert round {round_no}: {pending.size} pending")
        if round_no > 10000:
            raise RuntimeError("hash insertion failed to converge")


def _insert_all_sharded(ht_keys, ht_val1, ht_val2, shard_starts, shard_sizes,
                        shard_of_key, keys_u32, val1, val2, verbose=False):
    """Per-shard _insert_all driver for genome-scale builds.

    shard_of_key must be non-decreasing (the chunked build emits shards in
    order).  Produces a BIT-IDENTICAL table to one global _insert_all call
    — shards never share slots, so per-slot winner resolution is unchanged
    — with O(largest shard) scratch instead of O(total keys + total slots)
    int64 temporaries (the global formulation needs ~100GB at hg19 scale
    and was OOM-killed on the 3.2Gb proof build)."""
    n_shards = len(shard_sizes)
    bounds = np.searchsorted(shard_of_key, np.arange(n_shards + 1))
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        if hi <= lo:
            continue
        _insert_all(ht_keys, ht_val1, ht_val2, shard_starts, shard_sizes,
                    shard_of_key[lo:hi], keys_u32[lo:hi],
                    val1[lo:hi], val2[lo:hi], verbose=False,
                    claim_base=int(shard_starts[s]),
                    claim_size=int(shard_sizes[s]))
        if verbose and s % 32 == 0:
            print(f"  insert shard {s}/{n_shards}: {hi - lo:,} keys",
                  flush=True)


def _ovf_shard_bounds(multi_keys, multi_entry_starts, overflow_len, n_shards):
    """Per-shard overflow range boundaries from the ordered multi-groups."""
    multi_shards = (multi_keys >> np.uint64(32)).astype(np.int64)
    entry_ext = np.append(multi_entry_starts, overflow_len).astype(np.int64)
    bounds = np.searchsorted(multi_shards, np.arange(n_shards + 1))
    if len(entry_ext):
        out = entry_ext[np.minimum(bounds, len(entry_ext) - 1)].copy()
    else:
        out = np.zeros(n_shards + 1, np.int64)
    out[-1] = overflow_len
    return out


def build_index_chunked(genome: Genome, seed_len: int,
                        load_factor: float = 0.7, verbose: bool = False,
                        chunk: int = 16_000_000,
                        tmpdir: str | None = None) -> GenomeIndex:
    """Memory-bounded builder for genome-scale references.

    Produces BIT-IDENTICAL output to build_index, but never materializes
    the whole seed stream in RAM at once:

      pass A  pack seeds chunk-by-chunk, count seeds per logical shard;
      pass B  re-pack and scatter (key, half, loc) into disk-backed
              per-shard buckets (np.memmap spill, ~9 bytes/seed on disk);
      pass C  per shard: load its bucket (1/4^(seedLen-16) of the stream),
              lexsort, run the same grouping core (_grouped_tables) and
              append to the global tables.

    Peak RAM is O(chunk + largest shard + final index arrays) instead of
    O(seed stream x sort workspace) — the difference between ~50GB of
    transient overhead and ~1GB at hg19 scale.  The reference bounds build
    memory with approximate counters + precomputed bias tables instead
    (GenomeIndex.cpp:1109-1578); exact bucket spill needs neither.

    The spill is a SINGLE pass: each chunk is packed once and its
    (low-key, half<<33-combined sortkey, loc) records appended to
    per-shard spill files — no counting prepass, so the seed stream is
    packed exactly once (packing is ~1/4 of build time on this host).
    """
    import tempfile

    if not MIN_SEED_LENGTH <= seed_len <= MAX_SEED_LENGTH:
        raise ValueError(
            f"seed length must be in [{MIN_SEED_LENGTH}, {MAX_SEED_LENGTH}]")
    if genome.num_bases >= 0xFFFFFFF0:
        raise ValueError("genome too large for 32-bit locations")

    from .seeds import pack_all_seeds
    n_shards = 4 ** max(0, seed_len - 16)
    codes = genome.codes
    n_pos = genome.num_bases - seed_len + 1
    tail = seed_len - 1

    with tempfile.TemporaryDirectory(dir=tmpdir) as td:
        fk = [open(os.path.join(td, f"k{s:03d}"), "wb", buffering=1 << 18)
              for s in range(n_shards)]
        fh = [open(os.path.join(td, f"h{s:03d}"), "wb", buffering=1 << 16)
              for s in range(n_shards)]
        fl = [open(os.path.join(td, f"l{s:03d}"), "wb", buffering=1 << 18)
              for s in range(n_shards)]
        for start in range(0, n_pos, chunk):
            stop = min(start + chunk, n_pos)
            fwd, rc, valid = pack_all_seeds(
                np.asarray(codes[start:stop + tail]), seed_len)
            canonical = np.minimum(fwd, rc)
            half = (fwd > rc).astype(np.uint8)
            locs = (np.nonzero(valid)[0] + start).astype(np.uint32)
            canonical = canonical[valid]
            half = half[valid]
            del fwd, rc, valid
            sh = (canonical >> np.uint64(32)).astype(np.int64)
            order = np.argsort(sh, kind="stable")
            sh_s = sh[order]
            bounds = np.searchsorted(sh_s, np.arange(n_shards + 1))
            present = np.nonzero(np.diff(bounds) > 0)[0]
            ck_s = (canonical[order] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            ch_s = half[order]
            cl_s = locs[order]
            for s in present:
                lo, hi = int(bounds[s]), int(bounds[s + 1])
                fk[s].write(ck_s[lo:hi].tobytes())
                fh[s].write(ch_s[lo:hi].tobytes())
                fl[s].write(cl_s[lo:hi].tobytes())
            if verbose:
                print(f"  spilled {stop:,}/{n_pos:,} positions")
        for f in fk + fh + fl:
            f.close()

        # per-shard sort + grouping, appended into global tables
        keys_l, v1_l, v2_l, ovf_l = [], [], [], []
        multi_keys_l, multi_starts_l = [], []
        ovf_base = 0
        for s in range(n_shards):
            with open(os.path.join(td, f"k{s:03d}"), "rb") as f:
                ck = np.frombuffer(f.read(), np.uint32)
            if ck.size == 0:
                continue
            with open(os.path.join(td, f"h{s:03d}"), "rb") as f:
                ch = np.frombuffer(f.read(), np.uint8)
            with open(os.path.join(td, f"l{s:03d}"), "rb") as f:
                cl = np.frombuffer(f.read(), np.uint32)
            # same combined-key radix sort as build_index; the spill
            # preserved position order, so stability keeps locations
            # ascending within groups (bit-identical final tables)
            sk33 = (ck.astype(np.uint64) << np.uint64(1)) | ch
            order = np.argsort(sk33, kind="stable")
            sk = sk33[order] | (np.uint64(s) << np.uint64(33))
            (dk, v1, v2, ovf, m_starts, m_keys) = _grouped_tables(
                sk, cl[order], genome.num_bases, ovf_base)
            keys_l.append(dk)
            v1_l.append(v1)
            v2_l.append(v2)
            ovf_l.append(ovf)
            multi_keys_l.append(m_keys)
            multi_starts_l.append(m_starts)
            ovf_base += ovf.shape[0]
            if verbose and s % 32 == 0:
                print(f"  shard {s}/{n_shards}: {ck.size:,} seeds")

    def cat(lst, dt):
        # concatenate then FREE the parts immediately — at hg19 scale the
        # parts + results together are ~90GB and were part of the OOM
        out = np.concatenate(lst) if lst else np.zeros(0, dt)
        lst.clear()
        return out

    distinct_keys = cat(keys_l, np.uint64)
    val1 = cat(v1_l, np.uint32)
    val2 = cat(v2_l, np.uint32)
    overflow = cat(ovf_l, np.uint32)
    multi_keys = cat(multi_keys_l, np.uint64)
    multi_entry_starts = cat(multi_starts_l, np.int64)
    overflow_len = overflow.shape[0]
    if genome.num_bases + overflow_len > 0xFFFFFFF0:
        raise ValueError("overflow table too large; use a longer seed")

    shard_of_key = (distinct_keys >> np.uint64(32)).astype(np.int32)
    keys_per_shard = np.bincount(shard_of_key, minlength=n_shards)
    shard_sizes = np.maximum(
        2, np.ceil(keys_per_shard / load_factor).astype(np.int64) + 1)
    shard_sizes[keys_per_shard == 0] = 0
    shard_starts = np.concatenate(([0], np.cumsum(shard_sizes)))
    total_slots = int(shard_starts[-1])

    ht_keys = np.zeros(total_slots, dtype=np.uint32)
    ht_val1 = np.full(total_slots, _EMPTY, dtype=np.uint32)
    ht_val2 = np.zeros(total_slots, dtype=np.uint32)
    keys_u32 = (distinct_keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    del distinct_keys
    _insert_all_sharded(ht_keys, ht_val1, ht_val2,
                        shard_starts, shard_sizes, shard_of_key,
                        keys_u32, val1, val2, verbose=verbose)

    shard_ovf_starts = _ovf_shard_bounds(multi_keys, multi_entry_starts,
                                         overflow_len, n_shards)
    return GenomeIndex(genome=genome, seed_len=seed_len,
                       ht_keys=ht_keys, ht_val1=ht_val1, ht_val2=ht_val2,
                       shard_starts=shard_starts, overflow=overflow,
                       shard_ovf_starts=shard_ovf_starts)


# ----------------------------------------------------------------------
# the build as torch code on a device
# ----------------------------------------------------------------------
#
# The same tables as build_index / build_index_chunked, built from tensors
# on any device (CPU tensors run the same code).  Memory is bounded as the
# chunked builder bounds it, but without a spill: seeds are packed CHUNK
# positions at a time; one counting pass sizes groups of whole logical
# shards of at most GROUP_SEEDS seeds; each group re-packs the genome,
# keeps its own seeds, sorts them stably by (canonical << 1 | half) and
# runs the grouping core, keeping only the distinct keys and their two
# values (12 bytes a key).  Once every shard's key count is known, the
# tables are allocated straight in parallel/sharded.py partition_index's
# layout (one (max_slots, 3) entry tensor per index slice, overflow
# pointers rebased to the slice) and filled INSERT_KEYS keys at a time.
# The budgets keep a 3.2 Gb genome's build (seed length 20, 8 slices)
# inside an 80 GB card: 48 GB of entries and 2 GB of overflow, the keys not
# yet inserted, and one batch's sort or insert temporaries.

BUILD_CHUNK = 1 << 27        # genome positions packed at a time
BUILD_GROUP_SEEDS = 1 << 28  # seeds sorted at a time (whole logical shards)
BUILD_INSERT_KEYS = 1 << 26  # keys inserted at a time (whole logical shards)
CHUNKED_SCALE = 1 << 4       # -chunked divides the three by this
# a slice's slot offsets are int32 (ops/lookup.py lookup_seeds' shard_start)
MAX_SLICE_SLOTS = (1 << 31) - 1
HOST_COPY_ROWS = 1 << 26     # entry rows genome_index() copies at a time


def shard_sizes_for(keys_per_shard: np.ndarray, load_factor: float):
    """Slots of each logical table: ceil(keys / lf) + 1, at least 2, and 0
    for a table without keys (float64, as build_index computes them)."""
    sizes = np.maximum(
        2, np.ceil(keys_per_shard / load_factor).astype(np.int64) + 1)
    sizes[keys_per_shard == 0] = 0
    return sizes


def slice_cuts(starts: np.ndarray, n_idx: int) -> np.ndarray:
    """Contiguous ranges of logical shards over n_idx slices, balanced by
    slot count: the n_idx + 1 shard indexes where the slices begin."""
    n_shards = starts.shape[0] - 1
    if n_idx > n_shards:
        raise ValueError(f"cannot split {n_shards} logical tables over "
                         f"{n_idx} devices")
    targets = np.linspace(0, int(starts[-1]), n_idx + 1)
    cut = np.searchsorted(starts, targets[1:-1], side="left")
    return np.concatenate(([0], cut, [n_shards])).astype(np.int64)


def slices_needed(starts: np.ndarray) -> int:
    """The fewest slices (slice_cuts) of which none is past MAX_SLICE_SLOTS
    slots."""
    biggest = int(np.diff(starts).max(initial=0))
    if biggest > MAX_SLICE_SLOTS:
        raise ValueError(f"a logical table of {biggest:,} slots is past "
                         "int32 slot offsets; use a longer seed")
    n = max(1, -(-int(starts[-1]) // MAX_SLICE_SLOTS))
    while np.diff(starts[slice_cuts(starts, n)]).max() > MAX_SLICE_SLOTS:
        n += 1
    return n


def slice_layout(starts, ovf_starts, cuts):
    """(max_slots, max_ovf, shard_start, shard_size) of the slices: the
    common padded lengths, and per slice its (n_shards,) int32 slot ranges
    with size 0 for the tables it does not own.  Raises for a slice past
    MAX_SLICE_SLOTS, whose offsets int32 cannot hold."""
    n_idx, n_shards = cuts.shape[0] - 1, starts.shape[0] - 1
    max_slots = int(np.diff(starts[cuts]).max())
    if max_slots > MAX_SLICE_SLOTS:
        raise ValueError(f"a slice of {max_slots:,} slots is past int32 "
                         "slot offsets; split the index over more slices")
    max_ovf = max(1, int(np.diff(ovf_starts[cuts]).max()))
    sh_start = np.zeros((n_idx, n_shards), np.int32)
    sh_size = np.zeros((n_idx, n_shards), np.int32)
    for d in range(n_idx):
        lo, hi = int(cuts[d]), int(cuts[d + 1])
        sh_start[d, lo:hi] = (starts[lo:hi] - starts[lo]).astype(np.int32)
        sh_size[d, lo:hi] = np.diff(starts[lo:hi + 1]).astype(np.int32)
    return max_slots, max_ovf, sh_start, sh_size


def rebase_values(v, genome_size: int, o0: int):
    """Entry values (int32-carried u32) with overflow pointers moved down
    by o0, a slice's first overflow offset (up for a negative o0, which
    undoes it); locations, the empty and the unused markers stay."""
    if o0 == 0:
        return v
    w = u32.to_i64(v)
    is_ovf = (w >= genome_size) & (w != INVALID_GENOME_LOCATION) & \
        (w != UNUSED_HASH_VALUE)
    return u32.from_i64(torch.where(is_ovf, w - o0, w))


def empty_entries(n_slots: int, device):
    """(n_slots, 3) int32-carried u32 entries: key 0, value1 empty,
    value2 0 (build_index's fill)."""
    e = torch.zeros((n_slots, 3), dtype=torch.int32, device=device)
    e[:, 1] = u32.const(INVALID_GENOME_LOCATION)
    return e


@dataclass
class DeviceIndex:
    """An index's tables as tensors on one device, in n_index slices of
    whole logical shards (parallel/sharded.py partition_index's layout).

    parts: ht_entries and overflow, lists of n_index (max_slots, 3) and
    (max_ovf,) int32 tensors holding u32 bits; shard_start and shard_size,
    (n_index, n_shards) int32 tensors; cuts, the slices' first shards."""
    genome: Genome
    seed_len: int
    shard_starts: np.ndarray       # int64[n_shards + 1], global slots
    shard_ovf_starts: np.ndarray   # int64[n_shards + 1]
    parts: dict

    @property
    def genome_size(self) -> int:
        return self.genome.num_bases

    @property
    def total_slots(self) -> int:
        return int(self.shard_starts[-1])

    @property
    def overflow_len(self) -> int:
        return int(self.shard_ovf_starts[-1])

    @stats.timed("index.host_tables")
    def genome_index(self) -> GenomeIndex:
        """The tables as a host GenomeIndex (what build_index returns,
        ready to save), assembled slice by slice: each slice's own rows,
        HOST_COPY_ROWS at a time, with its overflow pointers moved back to
        the global offsets, and its own overflow entries."""
        gsize, starts = self.genome_size, self.shard_starts
        ovf_starts, cuts = self.shard_ovf_starts, self.parts["cuts"]
        cols = [np.empty(self.total_slots, np.uint32) for _ in range(3)]
        overflow = np.empty(self.overflow_len, np.uint32)
        for d, (e, o) in enumerate(zip(self.parts["ht_entries"],
                                       self.parts["overflow"])):
            lo, hi = int(cuts[d]), int(cuts[d + 1])
            s0, s1 = int(starts[lo]), int(starts[hi])
            o0, o1 = int(ovf_starts[lo]), int(ovf_starts[hi])
            for r0 in range(0, s1 - s0, HOST_COPY_ROWS):
                r1 = min(r0 + HOST_COPY_ROWS, s1 - s0)
                rows = e[r0:r1]
                host = u32.to_numpy(torch.stack(
                    [rows[:, 0], rebase_values(rows[:, 1], gsize, -o0),
                     rebase_values(rows[:, 2], gsize, -o0)], dim=1))
                for j in range(3):
                    cols[j][s0 + r0:s0 + r1] = host[:, j]
            overflow[o0:o1] = u32.to_numpy(o[:o1 - o0])
        return GenomeIndex(
            genome=self.genome, seed_len=self.seed_len, ht_keys=cols[0],
            ht_val1=cols[1], ht_val2=cols[2],
            shard_starts=starts.copy(), overflow=overflow,
            shard_ovf_starts=ovf_starts.copy())


@stats.timed("index.build")
def build_index_device(genome: Genome, seed_len: int,
                       load_factor: float = 0.7, device="cuda",
                       n_index: int | None = None, *,
                       chunked: bool = False,
                       chunk: int | None = None,
                       group_seeds: int | None = None,
                       insert_keys: int | None = None,
                       verbose: bool = False) -> DeviceIndex:
    """build_index on `device`: the same tables, in n_index slices (by
    default the fewest whose slot offsets int32 holds, slices_needed).

    chunked divides the packing, sorting and insert budgets by
    CHUNKED_SCALE (less memory, more passes; the same bytes).  chunk,
    group_seeds and insert_keys override the budgets (positions, seeds and
    keys).  The genome's codes are copied to the device for the build and
    freed with its other temporaries before it returns."""
    if not MIN_SEED_LENGTH <= seed_len <= MAX_SEED_LENGTH:
        raise ValueError(
            f"seed length must be in [{MIN_SEED_LENGTH}, {MAX_SEED_LENGTH}]")
    if genome.num_bases >= 0xFFFFFFF0:
        raise ValueError("genome too large for 32-bit locations")
    scale = CHUNKED_SCALE if chunked else 1
    chunk = chunk or BUILD_CHUNK // scale
    group_seeds = group_seeds or BUILD_GROUP_SEEDS // scale
    insert_keys = insert_keys or BUILD_INSERT_KEYS // scale
    dev = torch.device(device)
    t0 = time.time()

    def say(msg):
        if verbose:
            held = (f", {torch.cuda.memory_allocated(dev):,} device bytes "
                    "held" if dev.type == "cuda" else "")
            print(f"  [{time.time() - t0:7.1f} s] {msg}{held}", flush=True)

    n_shards = 4 ** max(0, seed_len - 16)
    host = np.ascontiguousarray(genome.codes, dtype=np.uint8)
    if not host.flags.writeable:      # a memory-mapped genome
        host = host.copy()
    codes = torch.from_numpy(host).to(dev)

    seeds_per_shard = torch.zeros(n_shards, dtype=torch.int64, device=dev)
    for _start, canon, _half, valid in _seed_chunks(codes, seed_len, chunk):
        seeds_per_shard += torch.bincount(canon[valid] >> 32,
                                          minlength=n_shards)
        del canon, _half, valid        # before the next chunk is packed
    sps = seeds_per_shard.cpu().numpy()
    groups = _shard_groups(sps, group_seeds)
    say(f"{int(sps.sum()):,} seeds in {n_shards} logical tables, "
        f"{len(groups)} groups")

    keys_per_shard = np.zeros(n_shards, np.int64)
    ovf_starts = np.zeros(n_shards + 1, np.int64)
    compact, ovf_chunks, ovf_base = [], [], 0
    for g0, g1 in groups:
        n_seeds = int(sps[g0:g1].sum())
        if n_seeds == 0:
            ovf_starts[g0:g1] = ovf_base
            continue
        sk = torch.empty(n_seeds, dtype=torch.int64, device=dev)
        cl = torch.empty(n_seeds, dtype=torch.int64, device=dev)
        p = 0
        for start, canon, half, valid in _seed_chunks(codes, seed_len,
                                                       chunk):
            sh = canon >> 32
            take = torch.nonzero(valid & (sh >= g0) & (sh < g1)).squeeze(1)
            k = take.numel()
            sk[p:p + k] = (canon[take] << 1) | half[take]
            cl[p:p + k] = take + start
            p += k
            del canon, half, valid, sh, take
        sk, order = torch.sort(sk, stable=True)
        cl = cl[order]
        del order
        g = _grouped_tables_torch(sk, cl, genome.num_bases, ovf_base)
        del sk, cl
        kps = torch.bincount((g["keys"] >> 32) - g0,
                             minlength=g1 - g0).cpu().numpy()
        keys_per_shard[g0:g1] = kps
        # each shard's overflow range (_ovf_shard_bounds, in the group)
        n_ovf = g["overflow"].shape[0]
        ext = torch.cat([g["multi_starts"], torch.tensor(
            [ovf_base + n_ovf], dtype=torch.int64, device=dev)])
        first = torch.searchsorted(
            g["multi_keys"] >> 32,
            torch.arange(g0, g1, dtype=torch.int64, device=dev))
        ovf_starts[g0:g1] = ext[first].cpu().numpy()
        compact.append(dict(g0=g0, g1=g1, kps=kps,
                            keys=u32.from_i64(g["keys"]),
                            val1=g["val1"], val2=g["val2"]))
        ovf_chunks.append(g["overflow"])
        ovf_base += n_ovf
        del g
        say(f"shards {g0}-{g1 - 1}: {n_seeds:,} seeds, "
            f"{int(kps.sum()):,} keys")
    del codes
    ovf_starts[n_shards] = ovf_base
    if genome.num_bases + ovf_base > 0xFFFFFFF0:
        raise ValueError("overflow table too large; use a longer seed")
    overflow = (torch.cat(ovf_chunks) if ovf_chunks else
                torch.zeros(0, dtype=torch.int32, device=dev))
    ovf_chunks.clear()

    sizes = shard_sizes_for(keys_per_shard, load_factor)
    starts = np.concatenate(([0], np.cumsum(sizes))).astype(np.int64)
    if n_index is None:
        n_index = slices_needed(starts)
    cuts = slice_cuts(starts, n_index)
    max_slots, max_ovf, sh_start, sh_size = slice_layout(starts, ovf_starts,
                                                         cuts)
    ovf_slices = []
    for d in range(n_index):
        o0, o1 = (int(ovf_starts[cuts[d]]), int(ovf_starts[cuts[d + 1]]))
        ovf = torch.zeros(max_ovf, dtype=torch.int32, device=dev)
        ovf[:o1 - o0] = overflow[o0:o1]
        ovf_slices.append(ovf)
    del overflow
    key_starts = {c["g0"]: np.concatenate(([0], np.cumsum(c["kps"])))
                  for c in compact}
    entries = []
    for d in range(n_index):
        lo, hi = int(cuts[d]), int(cuts[d + 1])
        s0 = int(starts[lo])
        o0 = int(ovf_starts[lo])
        ent = empty_entries(max_slots, dev)
        for ci, c in enumerate(compact):
            if c is None or c["g1"] <= lo or c["g0"] >= hi:
                continue
            a, b = max(lo, c["g0"]), min(hi, c["g1"])
            ks = key_starts[c["g0"]]
            for b0, b1 in _shard_groups(c["kps"][a - c["g0"]:b - c["g0"]],
                                        insert_keys):
                s_a, s_b = a + b0, a + b1
                k0, k1 = int(ks[s_a - c["g0"]]), int(ks[s_b - c["g0"]])
                if k1 == k0:
                    continue
                counts = torch.from_numpy(keys_per_shard[s_a:s_b]).to(dev)
                base = torch.repeat_interleave(torch.from_numpy(
                    starts[s_a:s_b] - s0).to(dev), counts)
                size = torch.repeat_interleave(
                    torch.from_numpy(sizes[s_a:s_b]).to(dev), counts)
                _insert_torch(
                    ent, c["keys"][k0:k1],
                    rebase_values(c["val1"][k0:k1], genome.num_bases, o0),
                    rebase_values(c["val2"][k0:k1], genome.num_bases, o0),
                    base, size, int(starts[s_a] - s0),
                    int(starts[s_b] - starts[s_a]))
            if c["g1"] <= hi:
                compact[ci] = None        # every shard of it is in place
        entries.append(ent)
        say(f"slice {d}: shards {lo}-{hi - 1}, "
            f"{int(starts[hi] - s0):,} slots")
    parts = dict(ht_entries=entries, overflow=ovf_slices,
                 shard_start=torch.from_numpy(sh_start).to(dev),
                 shard_size=torch.from_numpy(sh_size).to(dev), cuts=cuts)
    return DeviceIndex(genome=genome, seed_len=seed_len,
                       shard_starts=starts, shard_ovf_starts=ovf_starts,
                       parts=parts)


def _seed_chunks(codes, seed_len: int, chunk: int):
    """(first position, canonical, half, valid) of every position's seed,
    `chunk` positions at a time; canonical = min(fwd, rc) and half = fwd
    > rc, int64 and bool tensors on the codes' device."""
    n_pos = codes.shape[0] - seed_len + 1
    for start in range(0, max(n_pos, 0), chunk):
        stop = min(start + chunk, n_pos)
        fwd, rc, valid = pack_all_seeds_torch(
            codes[start:stop + seed_len - 1], seed_len)
        yield start, torch.minimum(fwd, rc), fwd > rc, valid


def _shard_groups(counts: np.ndarray, budget: int):
    """Consecutive (lo, hi) ranges of shards whose counts sum to at most
    `budget` (a single shard over it forms its own range)."""
    groups, lo, acc = [], 0, 0
    for s, c in enumerate(counts.tolist()):
        if s > lo and acc + c > budget:
            groups.append((lo, s))
            lo, acc = s, 0
        acc += c
    groups.append((lo, len(counts)))
    return groups


def _grouped_tables_torch(sk, cl, num_bases: int, ovf_base: int) -> dict:
    """_grouped_tables on tensors: sk the sorted (canonical << 1 | half)
    int64 keys, cl their int64 locations (ascending within a key, the
    stable sort's order).  Returns the distinct canonical keys (int64),
    val1 / val2 and the overflow chunk (int32-carried u32; pointers
    rebased by ovf_base), and each multi-hit group's absolute overflow
    start and canonical key."""
    dev = sk.device
    n = sk.shape[0]
    new_group = torch.ones(n, dtype=torch.bool, device=dev)
    new_group[1:] = sk[1:] != sk[:-1]
    group_start = torch.nonzero(new_group).squeeze(1)
    n_groups = group_start.shape[0]
    group_count = torch.diff(group_start, append=torch.tensor(
        [n], dtype=torch.int64, device=dev))
    is_multi = group_count >= 2
    multi_counts = group_count[is_multi]
    entry_sizes = multi_counts + 1
    entry_starts = torch.cumsum(entry_sizes, 0) - entry_sizes
    n_ovf = int(entry_sizes.sum())
    overflow = torch.empty(n_ovf, dtype=torch.int32, device=dev)
    if n_ovf:
        overflow[entry_starts] = u32.from_i64(multi_counts)
        elem_group = torch.cumsum(new_group, 0) - 1
        in_multi = is_multi[elem_group]
        eg = elem_group[in_multi]
        del elem_group
        rank = torch.nonzero(in_multi).squeeze(1) - group_start[eg]
        slot_of_group = torch.full((n_groups,), -1, dtype=torch.int64,
                                   device=dev)
        slot_of_group[is_multi] = entry_starts
        # ascending input + reversed rank -> descending stored list
        dest = slot_of_group[eg] + group_count[eg] - rank
        del eg, rank, slot_of_group
        overflow[dest] = u32.from_i64(cl[in_multi])
        del dest, in_multi
    at_entry = torch.zeros(n_groups, dtype=torch.int64, device=dev)
    at_entry[is_multi] = entry_starts
    group_value = u32.from_i64(torch.where(
        is_multi, num_bases + ovf_base + at_entry, cl[group_start]))
    del at_entry
    sk_of_group = sk[group_start]
    key_of_group = sk_of_group >> 1
    upper = (sk_of_group & 1).bool()
    del sk_of_group
    new_key = torch.ones(n_groups, dtype=torch.bool, device=dev)
    new_key[1:] = key_of_group[1:] != key_of_group[:-1]
    key_id = torch.cumsum(new_key, 0) - 1
    keys = key_of_group[new_key]
    unused = u32.const(UNUSED_HASH_VALUE)
    val1 = torch.full((keys.shape[0],), unused, dtype=torch.int32, device=dev)
    val2 = torch.full_like(val1, unused)
    val1[key_id[~upper]] = group_value[~upper]
    val2[key_id[upper]] = group_value[upper]
    return dict(keys=keys, val1=val1, val2=val2, overflow=overflow,
                multi_starts=entry_starts + ovf_base,
                multi_keys=key_of_group[is_multi])


def _insert_torch(entries, keys, val1, val2, base, size, claim_base: int,
                  claim_size: int) -> None:
    """_insert_all on tensors, into the (slots, 3) int32 `entries`.

    keys / val1 / val2: int32-carried u32, in canonical order; base, size:
    int64 slot offset and size of each key's table in `entries`.  Every
    round, each pending key proposes its probe slot; of the proposals for
    a free slot the lowest key id wins (a scatter with amin, which is
    defined whatever the order of the writes, as numpy's reversed writes
    are in build_index), and the others take their next probe step.
    claim_base / claim_size bound the slots the keys can reach."""
    dev = keys.device
    n = keys.shape[0]
    empty = u32.const(INVALID_GENOME_LOCATION)
    idx = murmur_finalize_torch(u32.to_i64(keys)) % size.clamp_min(1)
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    n_probes = torch.zeros(n, dtype=torch.int64, device=dev)
    claim = torch.full((claim_size,), n, dtype=torch.int64, device=dev)
    rounds = 0
    while ids.shape[0]:
        slots = base + idx
        free = entries[slots, 1] == empty
        cand, rel = ids[free], slots[free] - claim_base
        claim.scatter_reduce_(0, rel, cand, "amin")
        won = claim[rel] == cand
        claim[rel] = n
        w, ws = cand[won], rel[won] + claim_base
        entries[ws] = torch.stack([keys[w], val1[w], val2[w]], dim=1)
        placed = torch.zeros_like(free)
        placed[free] = won
        keep = ~placed
        ids, idx, n_probes = ids[keep], idx[keep], n_probes[keep] + 1
        base, size = base[keep], size[keep]
        step = torch.where(n_probes < QUADRATIC_CHAINING_DEPTH,
                           n_probes * n_probes, 1)
        idx = (idx + step) % size
        rounds += 1
        if rounds > 10000:
            raise RuntimeError("hash insertion failed to converge")
