"""The least time the card could take for a kernel launch: the larger of
its bytes at HBM bandwidth and its 32-bit operations at the card's
integer issue rate.  Inputs are counted once and outputs once, whatever
the kernel reads again; operations are what these inputs need (an LV
row: the levels it ran).

Peaks: HBM 3.35e12 B/s (NVIDIA H100 SXM data sheet); 32-bit integer and
logic issue = SMs x 64 lanes x the card's maximum SM clock.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64


def int32_ops_per_s(sms: int, max_sm_clock_hz: float) -> float:
    return sms * INT32_LANES_PER_SM * max_sm_clock_hz


def bound_s(n_bytes: float, n_ops: float, ops_per_s: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)


def lv_ops(levels: np.ndarray, P: int) -> float:
    """An LV row's 32-bit operations for the levels it ran: ~12 per
    in-band diagonal (2e + 1 of them at level e) and, for the extension,
    a 4-byte compare of ~6 operations per pattern word on each diagonal
    the band reached."""
    n = np.asarray(levels, np.float64)
    return float((12 * (n * n + 2 * n) + (2 * n + 1) * (P // 4) * 6).sum())


def lv_levels(distance: np.ndarray, e_final: np.ndarray, k: np.ndarray,
              e_max: int) -> np.ndarray:
    """Levels each LV row ran: the level it finished at, or every level
    up to its limit when it found no alignment (at least one)."""
    return np.where(distance >= 0, e_final,
                    np.maximum(np.minimum(k, e_max), 1))


def lv_bytes(B: int, P: int, T: int, quality_bytes: int,
             has_free: bool) -> float:
    """Pattern, text and quality rows and the i32 vectors in, five i32
    scalars a row out."""
    n_vec = 3 + int(has_free)
    return float(B * (P + T + quality_bytes * P + 4 * n_vec + 20))


def bitpar_ops(B: int, TXT: int, P: int) -> float:
    """The bit-parallel scan's 32-bit operations at the least: per pattern
    word and text column the recurrence as three-input logic operations,
    the carried add and two funnel shifts (10), per column ~4 more for
    the score, plus the pattern's match masks."""
    W = (P + 31) // 32
    return float(B) * TXT * (W * 10 + 4) + B * P * W


def bitpar_packed_bytes(B: int, P: int, n_words: int) -> float:
    """Pattern rows, packed text words and t_len in, one i32 out."""
    return float(B * (P + 4 * n_words + 4) + 4 * B)
