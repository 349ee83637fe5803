"""The comparison that decides `correct`: the timed path's results against
the plain reference's, read by read, over a sample drawn from the seed.

The number compared, against its limit in the cell's file:
  mismatch_share  the share of the sampled reads (a pair's two ends count
                  as two reads) for which any judged output differs: the
                  aligned flag; for a read both sides align, its
                  location, direction, score and MAPQ; for a pair, also
                  pair_found and the pair score.
`fields` counts the reads that differ in each output, for the log.
"""
from __future__ import annotations

import numpy as np

INVALID = 0xFFFFFFFF


def differences(got: dict, want: dict, paired: bool) -> dict:
    """Per judged output, a (reads,) bool array: does it differ."""
    ends = ("0", "1") if paired else ("",)
    out = {}
    for e in ends:
        a_g = got["loc" + e] != INVALID
        a_w = want["loc" + e] != INVALID
        both = a_g & a_w
        rows = {"aligned": a_g != a_w}
        for k in ("loc", "dir", "score", "mapq"):
            rows[k] = both & (got[k + e] != want[k + e])
        if paired:
            for k in ("pair_found", "pair_score"):
                rows[k] = got[k] != want[k]
        for k, v in rows.items():
            out[k] = v if k not in out else np.concatenate([out[k], v])
    return out


def numbers(got: dict, want: dict, paired: bool) -> dict:
    diff = differences(got, want, paired)
    any_ = np.zeros_like(diff["aligned"])
    for v in diff.values():
        any_ |= v
    return dict(mismatch_share=float(any_.mean()))


def fields(got: dict, want: dict, paired: bool) -> dict:
    return {k: int(v.sum()) for k, v in
            differences(got, want, paired).items()}


def judge(values: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number at or under its
    limit."""
    rows = [(k, float(values[k]), float(limits[k])) for k in values]
    return all(v <= lim for _, v, lim in rows), rows
