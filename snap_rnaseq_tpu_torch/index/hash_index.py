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
from dataclasses import dataclass

import numpy as np

from ..constants import (INVALID_GENOME_LOCATION, MAX_SEED_LENGTH,
                         MIN_SEED_LENGTH, UNUSED_HASH_VALUE)
from .genome import Genome
from .seeds import murmur_finalize_u32, pack_all_seeds

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
    """(order, rank) of each element within its bucket value group."""
    order = np.argsort(b, kind="stable")
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
        cached = build_cuckoo_layout(index.ht_keys, index.ht_val1,
                                     index.ht_val2, index.shard_starts,
                                     verbose=verbose)
        if path:
            try:
                np.savez(path, fingerprint=fp, **cached)
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
