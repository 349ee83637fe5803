"""Plain dynamic programming over base codes, batched over rows (torch, any
device).  Codes: 0-3 bases, 4 a read's N, 5 genome padding (matches
nothing).

unit_dp    unit-cost edit distance of each whole pattern against the text,
           the start anchored at text column 0 or free; returns the last
           row (the distance with the text consumed up to each column).
"""
from __future__ import annotations

import torch


def unit_dp(pat: torch.Tensor, text: torch.Tensor, free_start: bool,
            cap: int = 1 << 14) -> torch.Tensor:
    """(N, T + 1) int32: entry j is the fewest edits aligning the whole
    pattern row against text columns [start, j), the start 0 or (free)
    any column; values above `cap` read as `cap`."""
    N, P = pat.shape
    T = text.shape[1]
    dev = text.device
    cols = torch.arange(T + 1, dtype=torch.int32, device=dev)
    if free_start:
        prev = torch.zeros((N, T + 1), dtype=torch.int32, device=dev)
    else:
        prev = cols.expand(N, T + 1).clamp_max(cap).contiguous()
    for i in range(P):
        mm = (text != pat[:, i:i + 1]).to(torch.int32)
        v = prev + 1
        v[:, 1:] = torch.minimum(v[:, 1:], prev[:, :-1] + mm)
        prev = (torch.cummin(v - cols, dim=1).values + cols).clamp_max(cap)
    return prev
