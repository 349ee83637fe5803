"""Full probability-model alignment scorer.

Analog of reference SNAPLib/ProbabilityDistance.{h,cpp}: computes the
probability of a read being generated from a reference window under a
snp / gap-open / gap-extend error model with per-base phred qualities,
maximizing over alignments whose start shift is within [-max_start_shift,
+max_start_shift] and whose total shift stays within +-max_total_shift.

The recurrence is the reference's 3-state (NO_GAP / READ_GAP / REF_GAP)
banded DP (ProbabilityDistance.cpp compute()).  The rows vectorize over the
shift axis; the REF_GAP same-row dependency becomes a prefix-max with an
affine extension penalty (cummax of a[j] - j*ext), so each row is O(shift)
vector work — the same formulation a future Pallas port would use.

Kept in float64 numpy on host: the reference uses doubles and this scorer is
invoked sparingly (allocated by BaseAligner, used for diagnostics).
"""
from __future__ import annotations

import numpy as np

NO_PROB = -1000000.0
MAX_SHIFT = 20


class ProbabilityDistance:
    def __init__(self, snp_prob: float, gap_open_prob: float,
                 gap_extension_prob: float, phred_offset: int = 33):
        self.snp_log = np.log(snp_prob)
        self.gap_open_log = np.log(gap_open_prob)
        self.gap_ext_log = np.log(gap_extension_prob)
        q = np.arange(256, dtype=np.float64)
        base_err = np.minimum(10.0 ** (-(q - phred_offset) / 10.0), 1.0)
        match = (1.0 - base_err) * (1.0 - snp_prob)
        with np.errstate(divide="ignore"):
            self.match_log = np.log(match)
            self.mismatch_log = np.log(1.0 - match)

    def compute(self, reference, read, quality, max_start_shift: int,
                max_total_shift: int, ref_origin: int = 0) -> float:
        """Returns matchProbability (not log).

        reference/read/quality: bytes or uint8 arrays.  Logical
        reference[i] = reference[ref_origin + i]; pass ref_origin >=
        max_total_shift when the alignment may shift left of the read start
        (the C++ version reads reference[-shift] off the caller's pointer).
        """
        ref = np.frombuffer(reference, np.uint8) if isinstance(reference, (bytes, bytearray)) \
            else np.asarray(reference, np.uint8)
        rd = np.frombuffer(read, np.uint8) if isinstance(read, (bytes, bytearray)) \
            else np.asarray(read, np.uint8)
        qual = np.frombuffer(quality, np.uint8) if isinstance(quality, (bytes, bytearray)) \
            else np.asarray(quality, np.uint8)
        n = rd.shape[0]
        ms = max_total_shift
        S = 2 * ms + 1
        shifts = np.arange(-ms, ms + 1)

        ng = np.full(S, NO_PROB)
        ng[np.abs(shifts) <= max_start_shift] = 0.0
        read_gap = np.full(S, NO_PROB)
        ref_gap = np.full(S, NO_PROB)

        for r in range(1, n + 1):
            # reference base at logical index (r-1+s)
            idx = ref_origin + (r - 1) + shifts
            ok = (idx >= 0) & (idx < ref.shape[0])
            ref_base = np.where(ok, ref[np.clip(idx, 0, ref.shape[0] - 1)], 255)
            is_match = ref_base == rd[r - 1]
            base_lp = np.where(is_match, self.match_log[qual[r - 1]],
                               self.mismatch_log[qual[r - 1]])

            prev_best = np.maximum(ng, np.maximum(read_gap, ref_gap))
            new_ng = prev_best + base_lp

            # READ_GAP: from previous row at shift s+1
            shifted = np.full(S, NO_PROB)
            shifted[:-1] = np.maximum(np.maximum(ng[1:], ref_gap[1:])
                                      + self.gap_open_log,
                                      read_gap[1:] + self.gap_ext_log)
            new_read_gap = shifted

            # REF_GAP: same-row scan over s (prefix max with affine extend)
            # x[s] = max(a[s-1], x[s-1]+ext)  =>  x[s] = (s-1)*ext +
            #        max_{j<=s-1} (a[j] - j*ext)
            a = np.maximum(new_ng, new_read_gap) + self.gap_open_log
            j = np.arange(S)
            scaled = a - j * self.gap_ext_log
            run_max = np.maximum.accumulate(scaled)
            new_ref_gap = np.full(S, NO_PROB)
            new_ref_gap[1:] = run_max[:-1] + (j[1:] - 1) * self.gap_ext_log
            # numerical guard: anything that started from NO_PROB stays tiny
            new_ref_gap = np.where(new_ref_gap < NO_PROB / 2, NO_PROB,
                                   new_ref_gap)

            ng, read_gap, ref_gap = new_ng, new_read_gap, new_ref_gap

        best = max(float(ng.max()), float(read_gap.max()), float(ref_gap.max()))
        return float(np.exp(best))
