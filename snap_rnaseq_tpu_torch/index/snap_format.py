"""Interop with the reference SNAP on-disk index format.

Reads (and writes) the 4-file index directory produced by the reference
``snap index`` command, so existing SNAP/SNAP-RNA indices drop straight into
this framework and vice versa.  Layout (reference file:line cites):

``GenomeIndex``   text: ``major minor nHashTables overflowTableSize seedLen
                  chromosomePadding`` (GenomeIndex.cpp:662, loadFromDirectory
                  GenomeIndex.cpp:845-873).  Major version 1.
``Genome``        text header ``nBases nPieces\\n`` then one ``offset name``
                  line per piece, then ``nBases`` raw base characters,
                  'n' for padding/genome-N (Genome.cpp saveToFile /
                  loadFromFile, openFileAndGetSizes).
``GenomeIndexHash``  nHashTables consecutive tables, each: u32 magic
                  0xb111b010, u64 tableSize, u64 usedElementCount, then
                  tableSize * {u32 key, u32 value1, u32 value2} slots
                  (HashTable.cpp:103-160, saveToFile HashTable.cpp:175-215,
                  Entry layout HashTable.h:119-132, magic HashTable.cpp:298).
``OverflowTable`` overflowTableSize little-endian u32s: per repeated seed a
                  group ``[count, loc0 > loc1 > ...]`` descending
                  (GenomeIndex.cpp:538-620).

Hash-table entry semantics are exactly our native ones (hash_index.py was
designed around the same contract): the stored key is the low 32 bits of the
*canonical* seed (min of seed and its reverse complement), the table shard is
its high bases, value1 holds the canonical seed's hits and value2 the
complement's; values >= nBases point at ``value - nBases`` in the overflow
table; 0xFFFFFFFE marks an unused half, value1 == 0xFFFFFFFF an empty slot.

The only real difference from our native format is overflow-table ordering:
the reference emits overflow groups in hash-bucket creation order, while the
native builder lays them out canonical-seed ordered so every shard owns a
contiguous overflow slice (the multi-chip seam, see parallel/sharded.py).
``load_snap_index`` therefore rewrites the overflow table into per-shard
contiguous form on load (cheap, vectorized) and fixes the entry pointers, so
a loaded SNAP index is indistinguishable from a natively-built one.
"""
from __future__ import annotations

import os
import struct

import numpy as np

from ..constants import INVALID_GENOME_LOCATION, UNUSED_HASH_VALUE
from .genome import Genome
from .hash_index import GenomeIndex

HASH_TABLE_MAGIC = 0xB111B010  # HashTable.cpp:298
FORMAT_MAJOR_VERSION = 1       # GenomeIndex.h:88
FORMAT_MINOR_VERSION = 0

# base char -> our code.  The reference upcases FASTA input and rewrites N
# to 'n' (FASTA.cpp:110-116), so the Genome file holds only A,C,G,T,n; we map
# everything that isn't ACGT to our pad/genome-N code 5.
_CHAR_TO_CODE = np.full(256, 5, dtype=np.uint8)
for _c, _v in zip(b"AGCT", (0, 1, 2, 3)):
    _CHAR_TO_CODE[_c] = _v
_CODE_TO_CHAR = np.frombuffer(b"AGCTNn", dtype=np.uint8).copy()


def is_snap_format_dir(directory: str) -> bool:
    """True if `directory` holds a reference-format index (4-file layout)."""
    return (os.path.isfile(os.path.join(directory, "GenomeIndex"))
            and os.path.isfile(os.path.join(directory, "GenomeIndexHash")))


# ----------------------------------------------------------------------
# reading
# ----------------------------------------------------------------------

def read_snap_genome(path: str, padding: int) -> Genome:
    """Parse the reference ``Genome`` file (Genome.cpp loadFromFile)."""
    with open(path, "rb") as f:
        header = f.readline().split()
        n_bases, n_pieces = int(header[0]), int(header[1])
        names, offsets = [], []
        for _ in range(n_pieces):
            line = f.readline().rstrip(b"\n")
            off_s, name = line.split(b" ", 1)
            offsets.append(int(off_s))
            names.append(name.decode())
        raw = np.frombuffer(f.read(n_bases), dtype=np.uint8)
    if raw.shape[0] != n_bases:
        raise ValueError(f"Genome file truncated: {raw.shape[0]} != {n_bases}")
    return Genome(codes=_CHAR_TO_CODE[raw], piece_names=names,
                  piece_offsets=np.asarray(offsets, dtype=np.int64),
                  padding=padding)


def _read_hash_tables(path: str, n_tables: int):
    """Parse ``GenomeIndexHash`` into flat (keys, val1, val2, shard_starts)."""
    keys, val1, val2, sizes = [], [], [], []
    with open(path, "rb") as f:
        for i in range(n_tables):
            head = f.read(20)
            magic, table_size, _used = struct.unpack("<IQQ", head)
            if magic != HASH_TABLE_MAGIC:
                raise ValueError(
                    f"hash table {i}: bad magic {magic:#x} != {HASH_TABLE_MAGIC:#x}")
            ent = np.frombuffer(f.read(12 * table_size), dtype=np.uint32)
            if ent.shape[0] != 3 * table_size:
                raise ValueError(f"hash table {i} truncated")
            ent = ent.reshape(table_size, 3)
            keys.append(ent[:, 0].copy())
            val1.append(ent[:, 1].copy())
            val2.append(ent[:, 2].copy())
            sizes.append(table_size)
    starts = np.zeros(n_tables + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    return (np.concatenate(keys), np.concatenate(val1), np.concatenate(val2),
            starts)


def _reshard_overflow(ht_val1, ht_val2, shard_starts, overflow, genome_size):
    """Rewrite the overflow table so each shard's groups are contiguous.

    Returns (new_overflow, new_val1, new_val2, shard_ovf_starts).  Group
    contents (count + descending locations) are preserved verbatim; only
    group placement and the entry pointers change, so lookups return
    identical hit lists.
    """
    n_shards = shard_starts.shape[0] - 1
    gsz = np.uint32(genome_size)
    new_val1, new_val2 = ht_val1.copy(), ht_val2.copy()
    unused = np.uint32(UNUSED_HASH_VALUE)
    pieces = []
    shard_ovf_starts = np.zeros(n_shards + 1, dtype=np.int64)
    out_off = 0
    for s in range(n_shards):
        lo, hi = int(shard_starts[s]), int(shard_starts[s + 1])
        for vals, new_vals in ((ht_val1, new_val1), (ht_val2, new_val2)):
            seg = vals[lo:hi]
            sel = np.nonzero((seg >= gsz) & (seg != unused)
                             & (seg != np.uint32(INVALID_GENOME_LOCATION)))[0]
            for slot in sel:
                src = int(seg[slot]) - genome_size
                count = int(overflow[src])
                pieces.append(overflow[src:src + 1 + count])
                new_vals[lo + int(slot)] = np.uint32(out_off + genome_size)
                out_off += 1 + count
        shard_ovf_starts[s + 1] = out_off
    new_overflow = (np.concatenate(pieces) if pieces
                    else np.zeros(0, dtype=np.uint32))
    return new_overflow, new_val1, new_val2, shard_ovf_starts


def load_snap_index(directory: str, reshard: bool = True) -> GenomeIndex:
    """Load a reference-format index directory as a native GenomeIndex.

    With reshard=True (default) the overflow table is rewritten per-shard
    contiguous so the result supports the multi-chip index-sharding path too.
    """
    with open(os.path.join(directory, "GenomeIndex")) as f:
        major, _minor, n_tables, ovf_size, seed_len, padding = (
            int(x) for x in f.read().split())
    if major != FORMAT_MAJOR_VERSION:
        raise ValueError(f"unsupported SNAP index format version {major}")
    genome = read_snap_genome(os.path.join(directory, "Genome"), padding)
    keys, val1, val2, shard_starts = _read_hash_tables(
        os.path.join(directory, "GenomeIndexHash"), n_tables)
    overflow = np.fromfile(os.path.join(directory, "OverflowTable"),
                           dtype=np.uint32)
    if overflow.shape[0] != ovf_size:
        raise ValueError(
            f"OverflowTable has {overflow.shape[0]} words, header says {ovf_size}")
    shard_ovf_starts = None
    if reshard:
        overflow, val1, val2, shard_ovf_starts = _reshard_overflow(
            val1, val2, shard_starts, overflow, genome.num_bases)
    return GenomeIndex(genome=genome, seed_len=seed_len, ht_keys=keys,
                       ht_val1=val1, ht_val2=val2, shard_starts=shard_starts,
                       overflow=overflow, shard_ovf_starts=shard_ovf_starts)


# ----------------------------------------------------------------------
# writing
# ----------------------------------------------------------------------

def write_snap_genome(genome: Genome, path: str) -> None:
    with open(path, "wb") as f:
        f.write(f"{genome.num_bases} {genome.num_pieces}\n".encode())
        for name, off in zip(genome.piece_names, genome.piece_offsets):
            f.write(f"{int(off)} {name}\n".encode())
        chars = _CODE_TO_CHAR[np.minimum(genome.codes, 5)]
        f.write(chars.tobytes())


def write_snap_index(index: GenomeIndex, directory: str) -> None:
    """Export a native index as a reference-format directory.

    The reference loader accepts it directly: entry semantics and overflow
    group layout are shared; our canonical-ordered overflow placement is just
    one of the orders the reference itself can produce.
    """
    os.makedirs(directory, exist_ok=True)
    n_shards = index.n_shards
    with open(os.path.join(directory, "GenomeIndex"), "w") as f:
        f.write(f"{FORMAT_MAJOR_VERSION} {FORMAT_MINOR_VERSION} {n_shards} "
                f"{index.overflow.shape[0]} {index.seed_len} "
                f"{index.genome.padding}")
    write_snap_genome(index.genome, os.path.join(directory, "Genome"))
    with open(os.path.join(directory, "GenomeIndexHash"), "wb") as f:
        for s in range(n_shards):
            lo, hi = int(index.shard_starts[s]), int(index.shard_starts[s + 1])
            if hi == lo:
                # the reference loader rejects tableSize <= 0
                # (HashTable.cpp:128-131); emit one empty slot instead.
                f.write(struct.pack("<IQQ", HASH_TABLE_MAGIC, 1, 0))
                f.write(np.array([0, INVALID_GENOME_LOCATION,
                                  INVALID_GENOME_LOCATION],
                                 dtype=np.uint32).tobytes())
                continue
            used = int(np.count_nonzero(
                index.ht_val1[lo:hi] != np.uint32(INVALID_GENOME_LOCATION)))
            f.write(struct.pack("<IQQ", HASH_TABLE_MAGIC, hi - lo, used))
            ent = np.empty((hi - lo, 3), dtype=np.uint32)
            ent[:, 0] = index.ht_keys[lo:hi]
            ent[:, 1] = index.ht_val1[lo:hi]
            ent[:, 2] = index.ht_val2[lo:hi]
            f.write(ent.tobytes())
    np.ascontiguousarray(index.overflow, dtype=np.uint32).tofile(
        os.path.join(directory, "OverflowTable"))
