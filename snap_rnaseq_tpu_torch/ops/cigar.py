"""CIGAR generation for final alignments.

Port of snap_rnaseq_tpu/ops/cigar.py, the analog of
LandauVishkinWithCigar::computeEditDistance (LandauVishkin.cpp:253-530).
The banded DP + action recovery runs batched on the device (ops/lv.py with
the CIGAR variant's diagonal order 0,-1,1,... and the tables kept: kernel
K3 on a card); token emission happens on the host from the compact
(acts, matched, start_run) arrays, with the reference's special cases:

* zero-edit early out: "<end>=" plus trailing X's when the pattern overruns
  the text (LandauVishkin.cpp:285-308);
* when e edits can be explained without indels ("straightMismatches == e"),
  emit per-base '='/'X' runs instead of the DP's path (cpp:355-414);
* useM mode collapses '='/'X' into 'M' (cpp:465-523).
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import MAX_K
from .lv import ACT_D, ACT_I, ACT_X, lv_distance

_ACT_CHAR = {ACT_X: "X", ACT_D: "D", ACT_I: "I"}


def lv_cigar_device(pattern, p_len, text, t_len, k, *, e_max: int,
                    device="cuda"):
    """Run the CIGAR-variant LV on `device` (numpy or tensor inputs);
    returns the LVResult with the edit script (acts, matched, start_run).
    On a card that is K3 without its L/A tables, which emission never
    reads; the plain version keeps them."""
    dev = torch.device(device)
    args = [torch.as_tensor(np.asarray(a)).to(dev)
            for a in (pattern, p_len, text, t_len, k)]
    if dev.type == "cuda":
        from .lv_cuda import lv_cigar
        return lv_cigar(*args, None, e_max=e_max, cigar_order=True)
    return lv_distance(*args, None, e_max=e_max, cigar_order=True,
                       keep_tables=True)


def _push(tokens: list, count: int, op: str):
    if count <= 0:
        return
    if tokens and tokens[-1][1] == op:
        tokens[-1] = (tokens[-1][0] + count, op)
    else:
        tokens.append((count, op))


def emit_tokens(pattern_row: np.ndarray, text_row: np.ndarray,
                p_len: int, t_len: int,
                e: int, acts: np.ndarray, matched: np.ndarray,
                start_run: int, use_m: bool) -> list[tuple[int, str]]:
    """Token list [(count, op), ...] for one alignment; ops in {=,X,I,D,M}."""
    end = min(p_len, t_len)
    out: list[tuple[int, str]] = []
    if e <= 0:
        # perfect-prefix early out
        if use_m:
            _push(out, p_len, "M")
        else:
            _push(out, end, "=")
            if p_len > end:
                _push(out, p_len - end, "X")
        return out

    mism = pattern_row[:end] != text_row[:end]
    straight = int(mism.sum()) + (p_len - end)
    if straight == e:
        if use_m:
            _push(out, p_len, "M")
        else:
            # RLE of '='/'X' over [0, end), then trailing X's
            idx = np.flatnonzero(np.diff(mism.astype(np.int8)) != 0) + 1
            bounds = np.concatenate(([0], idx, [end]))
            for a, b in zip(bounds[:-1], bounds[1:]):
                _push(out, int(b - a), "X" if mism[a] else "=")
            if p_len > end:
                _push(out, p_len - end, "X")
        return out

    # general DP path
    if use_m:
        acc_m = int(start_run)
    else:
        _push(out, int(start_run), "=")
        acc_m = 0
    cur = 1
    while cur <= e:
        op = _ACT_CHAR[int(acts[cur - 1])]
        count = 1
        while cur + 1 <= e and matched[cur - 1] == 0 and \
                _ACT_CHAR[int(acts[cur])] == op:
            count += 1
            cur += 1
        if use_m:
            if op == "X":
                acc_m += count
            else:
                if acc_m:
                    _push(out, acc_m, "M")
                    acc_m = 0
                _push(out, count, op)
        else:
            _push(out, count, op)
        m = int(matched[cur - 1])
        if m > 0:
            if use_m:
                acc_m += m
            else:
                _push(out, m, "=")
        cur += 1
    if use_m and acc_m:
        _push(out, acc_m, "M")
    return out


def tokens_to_string(tokens: list[tuple[int, str]]) -> str:
    return "".join(f"{c}{op}" for c, op in tokens)


def compute_cigars(pattern: np.ndarray, p_len: np.ndarray,
                   text: np.ndarray, t_len: np.ndarray,
                   use_m: bool = False, k: int = MAX_K - 1,
                   e_max: int = MAX_K, device="cuda") -> tuple[np.ndarray, list]:
    """Batched CIGAR: device DP + host emission.

    Returns (edit_distance int32 (B,), token lists).  Distance -1 means the
    strings don't align within k (CIGAR '*', SAM.cpp:1188-1199).
    """
    B = pattern.shape[0]
    kvec = np.full(B, min(k, e_max), np.int32)
    res = lv_cigar_device(pattern, p_len, text, t_len, kvec, e_max=e_max,
                          device=device)
    host = torch.stack([res.distance, res.start_run]).cpu().numpy()
    tables = torch.cat([res.acts, res.matched], dim=1).cpu().numpy()
    dist, start = host[0], host[1]
    acts, matched = tables[:, :e_max], tables[:, e_max:]
    toks = []
    for i in range(B):
        if dist[i] < 0:
            toks.append(None)
        else:
            toks.append(emit_tokens(pattern[i], text[i], int(p_len[i]),
                                    int(t_len[i]), int(dist[i]),
                                    acts[i], matched[i], int(start[i]), use_m))
    return dist, toks
