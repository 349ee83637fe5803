"""Run statistics, the analog of reference SNAPLib/AlignerStats.{h,cpp}.

Collected per batch and summed; printed as the same TSV-ish summary the
reference emits (AlignerContext.cpp:288-292, 371-393): totals, % useful,
single/multi/notFound breakdown, reads/s, plus a MAPQ histogram and —
when a wgsim oracle is active — per-MAPQ error counts for the built-in
accuracy/ROC harness (-e flag, AlignerContext.cpp:409-420).
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


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


class WaitProfile:
    """Host-pipeline time split (the PrintWaitProfile analog,
    AlignerContext.cpp:122-123 / DataReader.h:136-137): where wall time goes
    between reading input, waiting on the device, and writing output, read
    from the recorder's pipeline.read, pipeline.device and pipeline.write
    spans since the profile was made."""

    def __init__(self, recorder: "Recorder | None" = None):
        self._rec = recorder or RECORDER
        self._base = {n: self._rec.seconds(n) for n in PIPELINE_SPANS}

    def _since(self, name: str) -> float:
        return self._rec.seconds(name) - self._base[name]

    @property
    def read_s(self) -> float:
        return self._since("pipeline.read")

    @property
    def device_s(self) -> float:
        return self._since("pipeline.device")

    @property
    def write_s(self) -> float:
        return self._since("pipeline.write")

    def summary(self) -> str:
        return (f"wait profile: read {self.read_s:.2f}s, "
                f"device {self.device_s:.2f}s, write {self.write_s:.2f}s")


PIPELINE_SPANS = ("pipeline.read", "pipeline.device", "pipeline.write")
SPAN_KEYS = ("name", "parent", "seq", "thread", "start_ns", "end_ns")
_time_ns = time.time_ns
SYNCS = "engine.syncs"
_NO_SPAN = contextlib.nullcontext()
_END = object()
ALLOC_COUNTERS = ("alloc.device_mallocs", "alloc.retries")


def _profiling() -> bool:
    """Whether a torch profiler is active (torch.profiler.profile sets
    this module bool of torch.autograd.profiler while it records)."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


def _alloc_counts():
    """(cudaMalloc calls, allocation retries) of the caching allocator on
    the current card so far; None where CUDA is not in use.  A host read
    of the allocator's counters, not a sync."""
    if not torch.cuda.is_initialized():
        return None
    s = torch.cuda.memory_stats_as_nested_dict()
    return s.get("num_device_alloc", 0), s.get("num_alloc_retries", 0)


class _Thread:
    """One thread's open spans and totals (its own, so that the hot path
    takes no lock; the readers merge every thread's)."""
    __slots__ = ("stack", "totals", "counts")

    def __init__(self):
        self.stack, self.totals, self.counts = [], {}, {}


class _Span:
    __slots__ = ("rec", "name", "batch", "syncs", "th", "on", "parent",
                 "seq", "mem", "t0")

    def __init__(self, rec: "Recorder", name: str, batch: bool = False,
                 syncs: int = 0):
        self.rec, self.name, self.batch, self.syncs = rec, name, batch, syncs

    def __enter__(self):
        rec = self.rec
        try:
            th = self.th = rec._local.th
        except AttributeError:
            th = self.th = rec._thread()
        self.on = getattr(_autograd_profiler, "_is_profiler_enabled", False)
        if self.on:
            self._open_recorded(th.stack)
        elif rec._on:
            rec._turn(False)
        th.stack.append(self)
        self.t0 = _time_ns()
        return self

    def _open_recorded(self, stack: list) -> None:
        rec = self.rec
        rec._seen(True)
        parent = stack[-1] if stack else None
        self.parent = parent.name if parent else None
        self.mem = None
        if self.batch and not any(p.batch for p in stack):
            self.seq = rec._next_seq()
            self.mem = _alloc_counts()
        else:
            self.batch = False
            self.seq = parent.seq if parent and parent.on else 0

    def __exit__(self, *exc):
        t1 = _time_ns()
        th = self.th
        th.stack.pop()
        tot = th.totals.get(self.name)
        if tot is None:
            tot = th.totals[self.name] = [0, 0]
        tot[0] += 1
        tot[1] += t1 - self.t0
        if self.syncs:
            th.counts[SYNCS] = th.counts.get(SYNCS, 0) + self.syncs
        if self.on:
            self.rec._record(self, t1)
        return False


class Recorder:
    """Host spans and counters at the program's layer boundaries: engine
    batches and their phases, host syncs, mesh slices, index set-up and
    kernel builds.

    Totals are kept always: calls and host seconds a span name, the sum a
    counter.  While a torch profiler is active each span is recorded as
    well (SPAN_KEYS: its name, its parent's, the sequence number of the
    batch it belongs to, its thread, host start and end in
    time.time_ns()), with the host counts, the device counts and, across
    each outermost batch span, the caching allocator's cudaMalloc calls
    and retries (alloc.device_mallocs, alloc.retries).  time.time_ns() is
    the clock kineto stamps host events with, so a span lines up with the
    device trace with no annotation of its own: record_function and NVTX
    ranges are not used, as their ranges come back among the device
    events, where counts of device operations would take them for
    operations.  No call adds a sync (host_int and sync time one the
    caller makes), nor device work but count_device's while recording.
    Safe to use from several threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._threads = []          # every thread's _Thread
        self._seq = 0
        self._on = False            # a profiler was active at the last call
        self._stretch = self._new_stretch()

    @staticmethod
    def _new_stretch() -> dict:
        return dict(spans=[], counts={}, device={})

    def _thread(self) -> _Thread:
        try:
            return self._local.th
        except AttributeError:
            th = self._local.th = _Thread()
            with self._lock:
                self._threads.append(th)
            return th

    def _turn(self, on: bool) -> None:
        """A profiler seen after none starts a new stretch."""
        with self._lock:
            if on and not self._on:
                self._stretch = self._new_stretch()
            self._on = on

    def _seen(self, on: bool) -> bool:
        """Whether to record (a profiler is active); tracks its turns."""
        if on != self._on:
            self._turn(on)
        return on

    def _next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def _record(self, s: _Span, t1: int) -> None:
        mem = _alloc_counts() if s.mem is not None else None
        rec = (s.name, s.parent, s.seq, threading.current_thread().name,
               s.t0, t1)
        with self._lock:
            self._stretch["spans"].append(rec)
            c = self._stretch["counts"]
            if s.syncs:
                c[SYNCS] = c.get(SYNCS, 0) + s.syncs
            if mem is not None:
                for k, a, b in zip(ALLOC_COUNTERS, s.mem, mem):
                    c[k] = c.get(k, 0) + b - a

    # -- spans ---------------------------------------------------------

    def span(self, name: str, batch: bool = False) -> _Span:
        """A context manager timing `name` on the host.  A batch span
        (batch=True, outermost on its thread) starts a new sequence
        number, which the spans inside it share."""
        return _Span(self, name, batch)

    def timed(self, name: str, batch: bool = False):
        """Decorator: each call of the function inside span(name)."""
        def wrap(fn):
            @functools.wraps(fn)
            def inner(*args, **kwargs):
                with _Span(self, name, batch):
                    return fn(*args, **kwargs)
            return inner
        return wrap

    def each(self, name: str, iterable):
        """The items of `iterable`, each one's next() inside
        span(name)."""
        it = iter(iterable)
        while True:
            with _Span(self, name, False):
                item = next(it, _END)
            if item is _END:
                return
            yield item

    def record_span(self, name: str, start_ns: int, end_ns: int) -> None:
        """A span timed by the caller (work that overlaps other work, as
        parallel builds do), with no parent."""
        totals = self._thread().totals
        tot = totals.setdefault(name, [0, 0])
        tot[0] += 1
        tot[1] += end_ns - start_ns
        if self._seen(_profiling()):
            with self._lock:
                self._stretch["spans"].append(
                    (name, None, 0, threading.current_thread().name,
                     start_ns, end_ns))

    # -- counters ------------------------------------------------------

    def count(self, name: str, n: int = 1) -> None:
        counts = self._thread().counts
        counts[name] = counts.get(name, 0) + n
        if self._seen(_profiling()):
            with self._lock:
                c = self._stretch["counts"]
                c[name] = c.get(name, 0) + n

    def count_device(self, name: str, tensor: torch.Tensor) -> None:
        """Adds the number of nonzero elements of a tensor the engine has
        already computed to counter `name`.  Only while recording, and on
        the device: into one int64 scalar a counter and device, which
        recorded() reads on the host.  That costs a few small device
        operations a call (the count and the add: about five on an H100)
        and no sync, and holds no tensor of the engine's, whose memory
        the caching allocator would otherwise have to replace."""
        if not self._seen(_profiling()):
            return
        n = tensor.ne(0).sum(dtype=torch.int64)
        key = (name, tensor.device)
        with self._lock:
            acc = self._stretch["device"]
            if key in acc:
                acc[key].add_(n)
            else:
                acc[key] = n

    # -- host syncs ----------------------------------------------------

    def sync(self, site: str, n: int = 1, device=None):
        """Span sync.<site> around code that blocks the host until the
        device catches up, n times (a device read: on any device, as it
        would be a sync on a card); counts engine.syncs.  With `device`,
        only where that device is a card (a copy there is a sync, and
        elsewhere no copy is made): a span that does nothing otherwise."""
        if device is not None and torch.device(device).type != "cuda":
            return _NO_SPAN
        return _Span(self, "sync." + site, False, n)

    def host_int(self, site: str, tensor: torch.Tensor) -> int:
        """int(tensor), a host sync, timed and counted as sync(site)."""
        with _Span(self, "sync." + site, False, 1):
            return int(tensor)

    def to_device(self, site: str, t: torch.Tensor, device) -> torch.Tensor:
        """t, a host tensor, copied to `device`: a blocking copy, which on
        a card waits for the stream to drain (sync(site, device=))."""
        with self.sync(site, device=device):
            return t.to(device)

    # -- reading -------------------------------------------------------

    def _merged(self, what: str) -> dict:
        with self._lock:
            threads = list(self._threads)
        out = {}
        for th in threads:
            for k, v in dict(getattr(th, what)).items():
                if isinstance(v, list):
                    c, ns = out.get(k, (0, 0))
                    out[k] = (c + v[0], ns + v[1])
                else:
                    out[k] = out.get(k, 0) + v
        return out

    def seconds(self, name: str) -> float:
        """Host seconds in span `name` so far (0 where it never ran)."""
        return self._merged("totals").get(name, (0, 0))[1] / 1e9

    def totals(self) -> dict:
        """{"spans": {name: (calls, host s)}, "counts": {name: sum}} of
        the whole process so far."""
        return dict(spans={k: (c, ns / 1e9) for k, (c, ns)
                           in self._merged("totals").items()},
                    counts=self._merged("counts"))

    def recorded(self) -> dict:
        """The latest stretch recorded under a profiler: {"spans": [dict
        of SPAN_KEYS, in order of their ends], "counts": {name: sum}},
        host and device counts together.  Device counters are read here
        (a copy to the host each) and folded into the counts; the stretch
        is not cleared."""
        with self._lock:
            st = self._stretch
            device, st["device"] = st["device"], {}
        got = {}
        for (name, _dev), acc in device.items():
            got[name] = got.get(name, 0) + int(acc)
        with self._lock:
            counts = st["counts"]
            for name, v in got.items():
                counts[name] = counts.get(name, 0) + v
            return dict(spans=[dict(zip(SPAN_KEYS, r)) for r in st["spans"]],
                        counts=dict(counts))


RECORDER = Recorder()
span = RECORDER.span
timed = RECORDER.timed
each = RECORDER.each
record_span = RECORDER.record_span
count = RECORDER.count
count_device = RECORDER.count_device
sync = RECORDER.sync
host_int = RECORDER.host_int
to_device = RECORDER.to_device
seconds = RECORDER.seconds
totals = RECORDER.totals
recorded = RECORDER.recorded
