"""Which index slice holds a seed, worked out from the genome alone.

A seed's canonical form is the smaller of its 2-bit packing and its
reverse complement's; the index keeps one logical table per value of the
canonical key's bits above the low 32 (4^(seed_len - 16) tables), sized
ceil(distinct keys / load factor) + 1 slots (at least 2; none when
empty).  Slices are contiguous ranges of tables, cut where the running
slot count crosses even shares of the total; a genome takes the fewest
slices that keep every slice under 2^31 - 1 slots, unless the
configuration names a number.
"""
from __future__ import annotations

import numpy as np
import torch

MAX_SLICE_SLOTS = (1 << 31) - 1


def _canonical_chunks(codes: torch.Tensor, seed_len: int, chunk: int):
    n_pos = codes.shape[0] - seed_len + 1
    for lo in range(0, max(n_pos, 0), chunk):
        n = min(chunk, n_pos - lo)
        seg = codes[lo:lo + n + seed_len - 1]
        fwd = torch.zeros(n, dtype=torch.int64, device=codes.device)
        rc = torch.zeros(n, dtype=torch.int64, device=codes.device)
        bad = torch.zeros(n, dtype=torch.bool, device=codes.device)
        for t in range(seed_len):
            x = seg[t:t + n]
            c = x.clamp_max(3).to(torch.int64)
            fwd = fwd * 4 + c
            rc = rc + ((3 - c) << (2 * t))
            bad |= x > 3
        yield torch.minimum(fwd, rc)[~bad]


def table_keys(codes: torch.Tensor, seed_len: int,
               chunk: int = 1 << 26, group_keys: int = 1 << 28):
    """Distinct canonical keys of each logical table (int64 numpy): one
    scan that files each chunk's sorted keys under groups of tables of
    about `group_keys` seeds, then each group's distinct keys."""
    n_tables = 4 ** (seed_len - 16)
    n_groups = max(1, -(-(codes.shape[0] - seed_len + 1) // group_keys))
    edges = torch.linspace(0, n_tables, n_groups + 1,
                           device=codes.device).round().to(torch.int64)
    parts = [[] for _ in range(n_groups)]
    for canon in _canonical_chunks(codes, seed_len, chunk):
        canon = torch.sort(canon).values
        cut = torch.searchsorted(canon, edges << 32).tolist()
        for g in range(n_groups):
            if cut[g + 1] > cut[g]:
                parts[g].append(canon[cut[g]:cut[g + 1]].clone())
        del canon
    distinct = np.zeros(n_tables, np.int64)
    for g in range(n_groups):
        if parts[g]:
            u = torch.unique(torch.cat(parts[g]))
            distinct += torch.bincount(u >> 32, minlength=n_tables
                                       ).cpu().numpy()
            del u
        parts[g] = None
    return distinct


def slice_cuts(keys_per_table: np.ndarray, load_factor: float,
               n_slices: int | None):
    """The tables where each slice begins (n_slices + 1 entries)."""
    sizes = np.maximum(2, np.ceil(keys_per_table / load_factor).astype(
        np.int64) + 1)
    sizes[keys_per_table == 0] = 0
    starts = np.concatenate([[0], np.cumsum(sizes)])

    def cuts(n):
        targets = np.linspace(0, int(starts[-1]), n + 1)
        c = np.searchsorted(starts, targets[1:-1], side="left")
        return np.concatenate(([0], c, [len(sizes)])).astype(np.int64)
    if n_slices is None:
        n_slices = max(1, -(-int(starts[-1]) // MAX_SLICE_SLOTS))
        while np.diff(starts[cuts(n_slices)]).max() > MAX_SLICE_SLOTS:
            n_slices += 1
    return cuts(n_slices)


def key_slicer(codes: torch.Tensor, seed_len: int, load_factor: float,
               n_slices: int | None):
    """canonical key -> slice index."""
    cuts = slice_cuts(table_keys(codes, seed_len), load_factor, n_slices)

    def slice_of(canon: int) -> int:
        return int(np.searchsorted(cuts, canon >> 32, side="right")) - 1
    slice_of.n_slices = len(cuts) - 1
    return slice_of
