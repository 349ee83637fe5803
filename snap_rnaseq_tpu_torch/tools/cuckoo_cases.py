"""Seed-phase inputs for K7's checks: reads, a seed schedule and a cuckoo
bucket layout made with numpy from the caller's generator, for the tests
and chip_smoke.py (numpy only, so they run where neither a card nor jax
is).

The layout holds the reads' own canonical seeds as index/hash_index.py
build_cuckoo_layout places them: each (key, shard) in one place, its h1
bucket where it has room, else its h2 bucket, else the stash.  Besides,
a share of the keys goes straight to the h2 buckets or the stash, some
stash keys hold several entries (the lookup takes the u32 max of each
half), a share is left out (absent), and free bucket slots hold other
keys under the reads' shards.  Values mix locations below genome_size,
overflow references (a few past the end of the overflow table) and
UNUSED halves; with `wild`, a few values past genome_size + 2^31 as well,
whose overflow offset is negative as an int32."""
import numpy as np

from ..constants import INVALID_GENOME_LOCATION, UNUSED_HASH_VALUE
from ..index.hash_index import (BUCKET_CAP, CUCKOO_STASH, _ck_h1, _ck_h2,
                                _rank_in_bucket)
from ..utils.seed_sequencer import seed_position_schedule

M32 = np.uint64(0xFFFFFFFF)


def pack(reads, positions, seed_len):
    """(f, rc, valid), (B, S): each scheduled seed's 2-bit pack (first base
    most significant, bases at min(p + i, L - 1)), its reverse
    complement's, as uint64, and whether all its bases are below 4."""
    B, L = reads.shape
    pos = np.asarray(positions, np.int64)
    f = np.zeros((B, pos.size), np.uint64)
    rc = np.zeros_like(f)
    valid = np.ones(f.shape, bool)
    for i in range(seed_len):
        c = reads[:, np.minimum(pos + i, L - 1)]
        valid &= c < 4
        c = (c & 3).astype(np.uint64)
        f = (f << np.uint64(2)) | c
        rc |= (c ^ np.uint64(3)) << np.uint64(2 * i)
    return f, rc, valid


def make_reads(rng, B, L, seed_len, positions):
    """B reads of L bases cut from a random genome of about B * L / 4
    bases (so seeds repeat across reads), half reverse complemented, 1%
    substitutions, 0.5% N and a few padding codes; 3% of the reads N over
    40-95% of their length (fewer valid positions than a paired budget),
    one all N; for an even seed length, 2% with a palindromic seed at a
    scheduled position."""
    n = max(4 * L, B * L // 4)
    genome = rng.integers(0, 4, n, dtype=np.uint8)
    start = rng.integers(0, n - L, B)
    reads = genome[start[:, None] + np.arange(L)]
    rcr = rng.random(B) < 0.5
    reads[rcr] = 3 - reads[rcr, ::-1]
    sub = rng.random((B, L)) < 0.01
    reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    reads[rng.random((B, L)) < 0.005] = 4
    reads[rng.random((B, L)) < 0.0005] = 5
    for r in np.flatnonzero(rng.random(B) < 0.03):
        a = int(rng.integers(0, L // 2))
        reads[r, a:a + int(L * rng.uniform(0.4, 0.95))] = 4
    reads[0] = 4
    if seed_len % 2 == 0:
        ok = [p for p in positions if p + seed_len <= L]
        for r in np.flatnonzero(rng.random(B) < 0.02):
            p = int(rng.choice(ok))
            half = rng.integers(0, 4, seed_len // 2, dtype=np.uint8)
            reads[r, p:p + seed_len] = np.concatenate([half, 3 - half[::-1]])
    return reads


def _values(rng, n, genome_size, n_ovf, wild):
    """n value halves: 60% locations, 30% overflow references (2% of them
    past the table), 10% UNUSED; with wild, 1% past genome_size + 2^31."""
    kind = rng.choice(4, n, p=[0.6, 0.3, 0.09, 0.01] if wild
                      else [0.6, 0.3, 0.1, 0.0])
    v = rng.integers(0, genome_size, n, dtype=np.uint64)
    ovf = genome_size + rng.integers(0, int(n_ovf * 1.02) + 1, n)
    v = np.where(kind == 1, ovf.astype(np.uint64), v)
    v = np.where(kind == 2, np.uint64(UNUSED_HASH_VALUE), v)
    lo = genome_size + (1 << 31)
    if wild and lo < 0xFFFFFFF0:
        v = np.where(kind == 3, rng.integers(lo, 0xFFFFFFF0, n,
                                             dtype=np.uint64), v)
    return v.astype(np.uint32)


def _place(nb, h, keys, shards):
    """An (nb, 32) table holding the keys whose bucket h has room (rank
    below BUCKET_CAP), values left 0: (table, the placed keys' indices,
    their rows, their slots, the spilled keys' indices)."""
    order, bs, rank = _rank_in_bucket(h)
    fits = rank < BUCKET_CAP
    tbl = np.zeros((nb, 4 * BUCKET_CAP), np.uint32)
    tbl[:, BUCKET_CAP:2 * BUCKET_CAP] = INVALID_GENOME_LOCATION
    i = order[fits]
    tbl[bs[fits], rank[fits]] = keys[i]
    tbl[bs[fits], BUCKET_CAP + rank[fits]] = shards[i]
    return tbl, i, bs[fits], rank[fits], order[~fits]


def seed_case(rng, B, L, seed_len, S, *, genome_size=4_000_000,
              n_ovf=5000, absent=0.2, to_l2=0.1, to_stash=24, dups=3,
              load=0.85, past_end=False, wild=False, reads=None):
    """One K7 case: reads (B, L) uint8, positions (S,) int32 (the seed
    schedule's first S; with past_end the last one 3 bases past L -
    seed_len, so its seed repeats the read's last base), ck_buckets,
    ck_buckets2 (rows of 32 uint32), ck_stash (CUCKOO_STASH, 4) uint32,
    overflow (n_ovf,) int32 counts, genome_size, and `placed`: how many
    keys went to each place ({"l1", "l2", "stash", "stash_dups",
    "absent"})."""
    positions = seed_position_schedule(L, seed_len)[0][:S].astype(np.int32)
    if past_end:
        positions[-1] = L - seed_len + 3
    if reads is None:
        reads = make_reads(rng, B, L, seed_len, positions)
    f, rc, valid = pack(reads, positions, seed_len)
    canon = np.unique(np.minimum(f, rc)[valid])
    rng.shuffle(canon)
    n = canon.size
    n_absent, n_st = int(n * absent), min(to_stash, n // 10)
    n_l2 = int(n * to_l2)
    absent_k, stash_k, rest = np.split(canon, [n_absent, n_absent + n_st])
    keys = (rest & M32).astype(np.uint32)
    shards = (rest >> np.uint64(32)).astype(np.uint32)
    # the first n_l2 keys skip their h1 bucket; the others spill there
    # only where it is full
    direct = np.arange(rest.size) < n_l2
    l1_idx = np.flatnonzero(~direct)
    nb1 = max(16, int(np.ceil(l1_idx.size / (BUCKET_CAP * load))))
    h1 = _ck_h1(keys[l1_idx], shards[l1_idx], nb1)
    b1, p1, row1, rank1, spill = _place(nb1, h1, keys[l1_idx],
                                        shards[l1_idx])
    l2_idx = np.concatenate([np.flatnonzero(direct), l1_idx[spill]])
    nb2 = max(16, l2_idx.size // 5 + 1)
    h2 = _ck_h2(keys[l2_idx], shards[l2_idx], nb2)
    b2, p2, row2, rank2, spill2 = _place(nb2, h2, keys[l2_idx],
                                         shards[l2_idx])
    stash_keys = np.concatenate(
        [(stash_k & M32).astype(np.uint32), keys[l2_idx[spill2]]])
    stash_shards = np.concatenate(
        [(stash_k >> np.uint64(32)).astype(np.uint32),
         shards[l2_idx[spill2]]])
    room = CUCKOO_STASH - 2 * dups - 1
    n_absent += max(0, stash_keys.size - room)
    stash_keys, stash_shards = stash_keys[:room], stash_shards[:room]

    for tbl, rows, ranks, cnt in ((b1, row1, rank1, p1.size),
                                  (b2, row2, rank2, p2.size)):
        vals = _values(rng, 2 * cnt, genome_size, n_ovf, wild)
        tbl[rows, 2 * BUCKET_CAP + ranks] = vals[:cnt]
        tbl[rows, 3 * BUCKET_CAP + ranks] = vals[cnt:]
        # other keys under the reads' shards in a share of the free slots
        free = np.argwhere(tbl[:, BUCKET_CAP:2 * BUCKET_CAP]
                           == INVALID_GENOME_LOCATION)
        free = free[rng.random(len(free)) < 0.5]
        other = rng.integers(0, 1 << 32, len(free), dtype=np.uint64)
        sh = shards[rng.integers(0, shards.size, len(free))]
        clash = np.isin((sh.astype(np.uint64) << np.uint64(32)) | other,
                        canon)
        free, other, sh = free[~clash], other[~clash], sh[~clash]
        tbl[free[:, 0], free[:, 1]] = other.astype(np.uint32)
        tbl[free[:, 0], BUCKET_CAP + free[:, 1]] = sh

    stash = np.zeros((CUCKOO_STASH, 4), np.uint32)
    stash[:, 1] = INVALID_GENOME_LOCATION
    k = stash_keys.size
    stash[:k, 0], stash[:k, 1] = stash_keys, stash_shards
    # `dups` stash keys twice more, other values each time
    d = min(dups, k)
    rep = np.concatenate([np.arange(d), np.arange(d)])
    stash[k:k + 2 * d, 0] = stash_keys[rep]
    stash[k:k + 2 * d, 1] = stash_shards[rep]
    n_rows = k + 2 * d
    stash[:n_rows, 2:] = _values(rng, 2 * n_rows, genome_size, n_ovf,
                                 wild).reshape(2, n_rows).T
    # a stash key under a shard no seed of this length has
    stash[n_rows, 0] = keys[0] if keys.size else 0
    stash[n_rows, 1] = 0xFFFFFFF0
    overflow = rng.integers(2, 1000, n_ovf).astype(np.int32)
    return dict(reads=reads, positions=positions, ck_buckets=b1,
                ck_buckets2=b2, ck_stash=stash, overflow=overflow,
                genome_size=int(genome_size),
                placed=dict(l1=int(p1.size), l2=int(p2.size), stash=int(k),
                            stash_dups=int(d), absent=int(n_absent)))
