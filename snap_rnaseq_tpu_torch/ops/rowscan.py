"""Rowwise segmented reductions via log-step lane shifts.

Port of snap_rnaseq_tpu/ops/rowscan.py.  After the rowwise (dir, loc) sort
every candidate/element segment is a contiguous run within one row of the
(rows, W) candidate array, so a segmented reduction is a Hillis-Steele scan
over the W axis: log2(W) shift+select steps.  `op` is an elementwise torch
function (torch.add, torch.minimum, torch.maximum).
"""
from __future__ import annotations

import torch


def _shift_right(x: torch.Tensor, step: int, fill) -> torch.Tensor:
    """Shift along axis 1 by `step`, filling with `fill`."""
    pad = torch.full_like(x[:, :step], fill)
    return torch.cat([pad, x[:, :-step]], dim=1)


def seg_scan(val: torch.Tensor, boundary: torch.Tensor, op, identity):
    """Inclusive segmented scan of associative `op` along axis 1.

    boundary[i, j] marks element j as the first of its segment;
    boundary[:, 0] must be True."""
    W = val.shape[1]
    v = val
    m = ~boundary
    step = 1
    while step < W:
        v2 = _shift_right(v, step, identity)
        m2 = _shift_right(m, step, False)
        v = torch.where(m, op(v2, v), v)
        m = m & m2
        step *= 2
    return v


def seg_first(val: torch.Tensor, boundary: torch.Tensor) -> torch.Tensor:
    """Broadcast each segment's FIRST element to all its members."""
    W = val.shape[1]
    v = val
    m = ~boundary
    step = 1
    while step < W:
        v2 = _shift_right(v, step, 0)
        m2 = _shift_right(m, step, False)
        v = torch.where(m, v2, v)
        m = m & m2
        step *= 2
    return v


def seg_broadcast(val: torch.Tensor, boundary: torch.Tensor, op, identity):
    """Segment-total of `op`, broadcast to every member of the segment."""
    total_at_last = seg_scan(val, boundary, op, identity)
    is_last = torch.cat([boundary[:, 1:],
                         torch.ones_like(boundary[:, :1])], dim=1)
    rv = total_at_last.flip(1)
    rb = is_last.flip(1)
    return seg_first(rv, rb).flip(1)
