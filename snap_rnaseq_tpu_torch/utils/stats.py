"""Run statistics, the analog of reference SNAPLib/AlignerStats.{h,cpp}.

Collected per batch and summed; printed as the same TSV-ish summary the
reference emits (AlignerContext.cpp:288-292, 371-393): totals, % useful,
single/multi/notFound breakdown, reads/s, plus a MAPQ histogram and —
when a wgsim oracle is active — per-MAPQ error counts for the built-in
accuracy/ROC harness (-e flag, AlignerContext.cpp:409-420).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class AlignerStats:
    total_reads: int = 0
    useful_reads: int = 0
    single_hits: int = 0
    multi_hits: int = 0
    not_found: int = 0
    errors: int = 0
    lv_calls: int = 0
    popular_skipped: int = 0
    truncated_candidates: int = 0
    aligned_as_pairs: int = 0
    mapq_histogram: np.ndarray = field(default_factory=lambda: np.zeros(71, np.int64))
    mapq_errors: np.ndarray = field(default_factory=lambda: np.zeros(71, np.int64))
    start_time: float = field(default_factory=time.time)
    align_time: float = 0.0
    # per-phase device counters (the BaseAligner.h:113-118 analog:
    # nHashTableLookups, nLocationsScored, ...): arbitrary named sums
    # accumulated per batch by the pipelines
    engine_counters: dict = field(default_factory=dict)

    def add(self, other: "AlignerStats"):
        for f in ("total_reads", "useful_reads", "single_hits", "multi_hits",
                  "not_found", "errors", "lv_calls", "popular_skipped",
                  "truncated_candidates", "aligned_as_pairs"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        self.mapq_histogram += other.mapq_histogram
        self.mapq_errors += other.mapq_errors
        self.align_time += other.align_time
        for k, v in other.engine_counters.items():
            self.engine_counters[k] = self.engine_counters.get(k, 0) + v

    def count(self, name: str, value) -> None:
        self.engine_counters[name] = \
            self.engine_counters.get(name, 0) + int(value)

    def counters_line(self) -> str:
        if not self.engine_counters:
            return ""
        return "engine counters: " + " ".join(
            f"{k}={v}" for k, v in sorted(self.engine_counters.items()))

    def record_mapq(self, mapq: int, was_error: bool = False):
        m = max(0, min(70, int(mapq)))
        self.mapq_histogram[m] += 1
        if was_error:
            self.mapq_errors[m] += 1
            self.errors += 1

    @property
    def reads_per_second(self) -> float:
        dt = self.align_time or (time.time() - self.start_time)
        return self.useful_reads / dt if dt > 0 else 0.0

    def summary(self) -> str:
        t = self.total_reads or 1
        u = self.useful_reads or 1
        lines = [
            "Total Reads\tAligned, MAPQ >= 10\tAligned, MAPQ < 10\t"
            "Not Found\tReads/s",
            f"{self.total_reads}\t"
            f"{self.single_hits} ({100.0 * self.single_hits / u:.2f}%)\t"
            f"{self.multi_hits} ({100.0 * self.multi_hits / u:.2f}%)\t"
            f"{self.not_found} ({100.0 * self.not_found / u:.2f}%)\t"
            f"{self.reads_per_second:,.0f}",
        ]
        if self.errors:
            lines.append(f"misaligned (wgsim oracle): {self.errors}")
        cl = self.counters_line()
        if cl:
            lines.append(cl)
        return "\n".join(lines)

    def roc_table(self) -> str:
        """MAPQ -> (count, errors) table, the ComputeROC/-e output analog."""
        rows = ["mapq\tcount\terrors"]
        for m in range(71):
            if self.mapq_histogram[m]:
                rows.append(f"{m}\t{self.mapq_histogram[m]}\t{self.mapq_errors[m]}")
        return "\n".join(rows)


@dataclass
class Histogram:
    """Bucketed counter, optionally exponential (Histogram.h:28-55)."""
    n_buckets: int = 64
    exponential: bool = False
    counts: np.ndarray = None

    def __post_init__(self):
        if self.counts is None:
            self.counts = np.zeros(self.n_buckets, np.int64)

    def add(self, value: int, count: int = 1):
        if self.exponential:
            b = 0 if value <= 0 else min(self.n_buckets - 1,
                                         int(value).bit_length())
        else:
            b = max(0, min(self.n_buckets - 1, int(value)))
        self.counts[b] += count

    def rows(self):
        for b in range(self.n_buckets):
            if self.counts[b]:
                label = (1 << b) if self.exponential else b
                yield label, int(self.counts[b])


@dataclass
class PairedAlignerStats(AlignerStats):
    """AlignerStats + the paired extras (PairedAligner.cpp:57-145):
    mate-distance and pair-score histograms."""
    distance_histogram: Histogram = field(
        default_factory=lambda: Histogram(n_buckets=32, exponential=True))
    score_histogram: Histogram = field(
        default_factory=lambda: Histogram(n_buckets=64))

    def record_pair(self, distance: int, score: int):
        self.distance_histogram.add(abs(int(distance)))
        self.score_histogram.add(int(score))

    def pair_tables(self) -> str:
        lines = ["mate distance\tcount"]
        lines += [f"<={d}\t{c}" for d, c in self.distance_histogram.rows()]
        lines.append("pair score\tcount")
        lines += [f"{s}\t{c}" for s, c in self.score_histogram.rows()]
        return "\n".join(lines)


@dataclass
class WaitProfile:
    """Host-pipeline time split (the PrintWaitProfile analog,
    AlignerContext.cpp:122-123 / DataReader.h:136-137): where wall time goes
    between reading input, waiting on the device, and writing output."""
    read_s: float = 0.0
    device_s: float = 0.0
    write_s: float = 0.0

    def summary(self) -> str:
        return (f"wait profile: read {self.read_s:.2f}s, "
                f"device {self.device_s:.2f}s, write {self.write_s:.2f}s")
