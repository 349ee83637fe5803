"""Device time by operation, by category and by engine phase, and the
device's idle gaps, for the paired engine at the bench's operating point:
the counterpart of the JAX repo's tools/xprof_dump.py.

`--batches` batches of `--batch-pairs` wgsim pairs (seeds 0..N-1) through
PairedAligner(index, cand_per_read=64) (with `--single`, their first
reads through the single-end engine at its defaults, cand_per_read=64),
one warm-up batch first.  The batches are timed once on the host's clock,
then run again under torch.profiler (host operations with their Python
stacks, and the card's operations).  Prints one JSON line:
  * the device self-time a batch (every device operation's time summed)
    and the reads/s that alone would allow (2 reads a pair);
  * a rollup by category: each of K1-K6 by kernel name, then sort,
    gather/index, scatter, gather/scatter (torch's one kernel for both),
    reductions, copies and memsets, elementwise, other;
  * the top-n operations by time, ms and count a batch;
  * the host's wall ms a batch and the device's idle share of it;
  * the GAPS longest idle gaps between device operations, each with the
    operations on either side and what the host had open across it: the
    innermost program span (utils/stats.py's recorder), the innermost
    profiled operation or Python frame covering the gap, the innermost
    aten:: operation and the innermost frame of this package;
  * a table by program span (the path of spans open, outermost first), a
    batch: the host ms inside the span and in none of its children, the
    device ms of the operations its runtime calls launched (linked by
    their correlation ids), the idle ms of the gaps it was the innermost
    span open across, and its host syncs and cudaMallocs (the runtime's
    Synchronize and cudaMalloc calls inside it);
  * the recorder's counters over the profiled batches, a batch: reads,
    truncated reads, host syncs (engine.syncs), probe windows of the
    probe-chain lookup (lookup.probe_windows, under
    SNAP_TPU_LOOKUP=probe), the (read, position) columns K7 looked up
    (lookup.kernel_seeds: the cuckoo seed phase reached the kernel), and
    the caching allocator's cudaMallocs and allocation retries across the
    batch spans (alloc.device_mallocs, alloc.retries; on a card).
On the card the JAX tool's xplane parsing becomes the profiler's device
events; it raises if the profiler saw no device operation.  On the CPU
(`--device cpu`) it profiles the host's aten:: operations by self time
instead, labelled "timeline": "cpu", with no idle share and no gaps.

    python -m snap_rnaseq_tpu_torch.tools.op_profile [n_top=40]
        [--batches 4] [--single] [--index DIR | --cache DIR]
        [--batch-pairs 1024] [--bases 64e6] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import bisect
import json
import re
import sys
import threading
import time
from collections import defaultdict

from ..utils import stats
from . import measure as m

# device operation names (lower case) -> category, first match wins
KERNEL_CATEGORIES = (
    ("sort", ("sort", "radix")),
    ("gather/scatter", ("scatter_gather",)),
    ("scatter", ("scatter", "index_put", "put_kernel")),
    ("gather/index", ("index", "gather", "take", "searchsorted")),
    ("reductions", ("reduce", "scan", "cumsum")),
    ("copies and memsets", ("memcpy", "memset", "copy", "fill")),
    ("elementwise", ("elementwise",)),
)
# aten:: operation names, without the namespace and outer underscores
ATEN_CATEGORIES = (
    ("sort", {"sort", "argsort", "topk"}),
    ("scatter", {"scatter", "scatter_add", "scatter_reduce", "index_put",
                 "index_put_impl", "index_add", "masked_scatter"}),
    ("gather/index", {"index", "gather", "take", "take_along_dim",
                      "index_select", "searchsorted", "masked_select"}),
    ("reductions", {"sum", "amin", "amax", "min", "max", "argmin",
                    "argmax", "cumsum", "cumprod", "any", "all", "mean",
                    "prod", "logsumexp"}),
    ("copies and memsets", {"copy", "to", "to_copy", "clone", "contiguous",
                            "fill", "zero", "zeros", "zeros_like", "full",
                            "full_like", "ones", "ones_like", "cat",
                            "stack", "flip", "repeat", "repeat_interleave",
                            "arange", "local_scalar_dense", "item"}),
    ("elementwise", {"add", "sub", "rsub", "mul", "div", "where", "eq",
                     "ne", "lt", "le", "gt", "ge", "neg", "abs", "clamp",
                     "clamp_min", "clamp_max", "remainder", "fmod",
                     "floor_divide", "exp", "log", "log1p", "minimum",
                     "maximum", "pow", "sign", "bitwise_and", "bitwise_or",
                     "bitwise_xor", "bitwise_not", "bitwise_left_shift",
                     "bitwise_right_shift", "and", "or", "xor", "lshift",
                     "rshift", "iand", "ior", "ixor", "ilshift", "irshift",
                     "logical_and", "logical_or", "logical_not"}),
)
PACKAGE = "snap_rnaseq_tpu_torch"
GAPS = 10                 # idle gaps listed
# a Python frame's event name: "path/to/file.py(123): function"
PY_FRAME = re.compile(r"\.py\(\d+\): ")
# a CUDA runtime or driver call's event name (cudaLaunchKernel,
# cudaMemcpyAsync, cudaStreamSynchronize, cuLaunchKernel, ...)
RUNTIME_CALL = re.compile(r"cu[A-Z]|cuda[A-Z]")


def category(name: str, timeline: str = "device") -> str:
    """The rollup category of a device operation (or, on the CPU
    timeline, of an aten:: operation)."""
    k = m.kernel_of(name)
    if k:
        return k
    if timeline == "cpu":
        base = name.split("::")[-1].strip("_")
        return next((c for c, names in ATEN_CATEGORIES if base in names),
                    "other")
    low = name.lower()
    return next((c for c, keys in KERNEL_CATEGORIES
                 if any(s in low for s in keys)), "other")


def _short(name: str, n: int = 160) -> str:
    i = name.find(PACKAGE + "/")
    name = name[i:] if i >= 0 else name
    return name if len(name) <= n else name[:n - 3] + "..."


def self_times(events) -> list:
    """(name, self us) of each aten:: operation among raw events: its time
    less that of the aten:: operations nested in it (one thread)."""
    ops = sorted((e for e in events if e[0].startswith("aten::")),
                 key=lambda e: (e[2], -e[3]))
    out, stack = [], []                  # stack: [index into out, end]
    for name, _, t0, t1 in ops:
        while stack and stack[-1][1] <= t0:
            stack.pop()
        if stack:
            out[stack[-1][0]][1] -= t1 - t0
        out.append([name, t1 - t0])
        stack.append((len(out) - 1, t1))
    return out


def host_events(prof) -> list:
    """The host's aten:: operations and Python frames of a profile as
    (name, False, start us, end us), from the profiler's event tree: the
    raw events of some torch versions hold no Python frames."""
    from torch._C._profiler import _EventType
    keep = (_EventType.TorchOp, _EventType.PyCall)
    out, stack = [], list(prof.profiler.kineto_results.experimental_event_tree())
    while stack:
        e = stack.pop()
        if e.tag in keep:
            out.append((e.name, False, e.start_time_ns / 1e3,
                        e.end_time_ns / 1e3))
        stack.extend(e.children)
    return out


def host_across(cpu_events, g0, g1) -> dict:
    """What the host had open across the gap [g0, g1] (us): the innermost
    covering event (an aten:: operation or a Python frame), the innermost
    aten:: operation and the innermost frame of this package; where
    nothing covers the whole gap, the event that overlaps it most."""
    cover = [e for e in cpu_events if e[2] <= g0 and e[3] >= g1]
    pick = lambda es: (_short(min(es, key=lambda e: e[3] - e[2])[0])
                       if es else None)
    if not cover:
        over = lambda e: min(e[3], g1) - max(e[2], g0)
        best = max(cpu_events, key=over, default=None)
        return dict(host_op=None, overlapping=_short(best[0])
                    if best is not None and over(best) > 0 else None)
    return dict(host_op=pick(cover),
                aten_op=pick([e for e in cover if e[0].startswith("aten::")]),
                frame=pick([e for e in cover if PACKAGE in e[0]
                            and PY_FRAME.search(e[0])]))


def all_gaps(dev_events) -> list:
    """(length, operation before, operation after) of every gap between
    consecutive device operations, in us, longest first."""
    evs = sorted(dev_events, key=lambda e: e[2])
    gaps = [(b[2] - a[3], a, b) for a, b in zip(evs, evs[1:])
            if b[2] > a[3]]
    gaps.sort(key=lambda g: -g[0])
    return gaps


def idle_gaps(dev_events, cpu_events, n: int, timeline=None) -> list:
    """The n longest gaps between consecutive device operations, each
    with what the host had open across it (and, given the program's
    SpanTimeline, the innermost span open across it)."""
    return [dict(gap_ms=g / 1e3, after=_short(a[0], 100),
                 before=_short(b[0], 100),
                 **({} if timeline is None else
                    dict(span=timeline.label(timeline.across(a[3], b[2])))),
                 **host_across(cpu_events, a[3], b[2]))
            for g, a, b in all_gaps(dev_events)[:n]]


class SpanTimeline:
    """The program's spans of one thread (utils/stats.py recorded()) as
    the path of spans open at each moment, in us on the profiler's host
    clock (both are time.time_ns())."""

    def __init__(self, spans: list, thread: str):
        self.spans = [s for s in spans if s["thread"] == thread]
        pts = sorted([(s["start_ns"] / 1e3, 1, i)
                      for i, s in enumerate(self.spans)]
                     + [(s["end_ns"] / 1e3, 0, i)
                        for i, s in enumerate(self.spans)])
        self.times, self.paths, self.parent = [], [], {}
        stack = []
        for t, start, i in pts:
            if start:
                self.parent[i] = stack[-1] if stack else None
                stack.append(i)
            else:
                stack.remove(i)
            self.times.append(t)
            self.paths.append(tuple(stack))

    def at(self, t: float) -> tuple:
        j = bisect.bisect_right(self.times, t) - 1
        return self.paths[j] if j >= 0 else ()

    def across(self, t0: float, t1: float) -> tuple:
        """The spans open across all of [t0, t1], outermost first."""
        a, b = self.at(t0), self.at(t1)
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        return a[:n]

    def label(self, path: tuple) -> str:
        return (" / ".join(self.spans[i]["name"] for i in path)
                if path else "(no span)")

    def path_of(self, i: int) -> tuple:
        out = []
        while i is not None:
            out.append(i)
            i = self.parent[i]
        return tuple(reversed(out))


def linked_events(prof) -> tuple:
    """(runtime calls, device operations) of a profile: (name, start us,
    end us, correlation id) each; a device operation carries its
    launching call's CUPTI correlation id (or, where that finds no call,
    the id of the aten:: operation it belongs to, with the operation's
    times standing in for the call's)."""
    from torch.autograd import DeviceType
    calls, ops, dev = {}, {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        row = (name, e.start_ns() / 1e3, e.end_ns() / 1e3)
        if e.device_type() == DeviceType.CUDA:
            dev.append(row + (e.correlation_id(),
                              e.linked_correlation_id()))
        elif RUNTIME_CALL.match(name):
            calls[e.correlation_id()] = row
        else:
            ops[e.correlation_id()] = row
    linked = []
    for name, t0, t1, corr, op in dev:
        host = calls.get(corr) or ops.get(op)
        linked.append((name, t0, t1, host[1] if host else None))
    return list(calls.values()), linked


def phase_table(prof, timeline: SpanTimeline, gaps, n_batches: int,
                cuda: bool) -> list:
    """[span path, host ms, device ms, idle ms, syncs, mallocs] a batch,
    by the innermost program span, in order of the spans' starts; the
    device columns None on the CPU."""
    rows = defaultdict(lambda: [0.0, 0.0, 0.0, 0, 0])
    first = {}

    def row(path):
        label = timeline.label(path)
        t = timeline.spans[path[-1]]["start_ns"] if path else -1
        first[label] = min(first.get(label, t), t)
        return rows[label]
    for i, s in enumerate(timeline.spans):
        us = (s["end_ns"] - s["start_ns"]) / 1e3
        row(timeline.path_of(i))[0] += us
        if timeline.parent[i] is not None:
            row(timeline.path_of(timeline.parent[i]))[0] -= us
    if cuda:
        calls, linked = linked_events(prof)
        for name, t0, t1, host_t in linked:
            r = (row(timeline.at(host_t)) if host_t is not None
                 else rows["(not linked)"])
            r[1] += t1 - t0
        for g, a, b in gaps:
            row(timeline.across(a[3], b[2]))[2] += g
        for name, t0, _t1 in calls:
            if "Synchronize" in name:
                row(timeline.at(t0))[3] += 1
            elif name.startswith("cudaMalloc"):
                row(timeline.at(t0))[4] += 1
    per = lambda x: x / n_batches if cuda else None
    return [[label, rows[label][0] / 1e3 / n_batches,
             *(per(x) for x in (rows[label][1] / 1e3, rows[label][2] / 1e3,
                                rows[label][3], rows[label][4]))]
            for label in sorted(rows, key=lambda k: first.get(k, 1 << 62))]


def run(index, *, device="cuda", bases=m.GENOME_BASES,
        batch_pairs=m.BATCH_PAIRS, n_batches=4, n_top=40,
        base=None, single=False) -> dict:
    """The profile's JSON line dict.  `base`: an aligner whose device copy
    of the index is used (and whose config, cand_per_read=64 aside);
    `single`: the single-end engine on each batch's first reads."""
    from ..models.paired import PairedAligner
    from ..models.single import resolve_device
    dev = resolve_device(device)
    pa = (m.paired_on_state(base, cand_per_read=m.CAND_PER_READ)
          if base is not None else
          PairedAligner(index, device=dev, cand_per_read=m.CAND_PER_READ))
    batches = m.pair_batches(index, bases, batch_pairs, dev, n_batches)
    if single:
        pa = m.single_on_state(pa, cand_per_read=m.CAND_PER_READ)
        batches = [b[:2] for b in batches]

    def all_batches():
        for b in batches:
            pa.align_batch_device(*b)
    pa.align_batch_device(*batches[0])
    m.sync(dev)
    t0 = time.time()
    all_batches()
    m.sync(dev)
    wall_ms = (time.time() - t0) * 1e3 / n_batches
    cuda = dev.type == "cuda"
    t0 = time.time()
    prof = m.profiled(all_batches, dev, with_stack=cuda)
    prof_wall_ms = (time.time() - t0) * 1e3 / n_batches
    events = m.raw_events(prof)

    dev_events = [e for e in events if e[1]]
    if cuda and not dev_events:
        raise AssertionError("the profiler saw no device operation")
    timeline = "device" if cuda else "cpu"
    per_op = defaultdict(lambda: [0.0, 0])      # name -> [us, count]
    for name, us in ([(e[0], e[3] - e[2]) for e in dev_events] if cuda
                     else self_times(events)):
        per_op[name][0] += us
        per_op[name][1] += 1
    per_batch = lambda us: us / 1e3 / n_batches
    total_ms = per_batch(sum(us for us, _ in per_op.values()))
    rollup = defaultdict(float)
    for name, (us, _) in per_op.items():
        rollup[category(name, timeline)] += per_batch(us)
    top = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:n_top]
    rec = stats.recorded()
    spans = SpanTimeline(rec["spans"], threading.current_thread().name)
    gaps = all_gaps(dev_events) if cuda else []
    return dict(
        engine="single" if single else "paired",
        timeline=timeline, batches=n_batches, batch_pairs=batch_pairs,
        cand_per_read=pa.cfg.cand_per_read, self_ms_per_batch=total_ms,
        reads_per_sec_at_self_time=(2 * batch_pairs * 1e3 / total_ms
                                    if total_ms > 0 else None),
        ops_per_batch=sum(c for _, c in per_op.values()) / n_batches,
        wall_ms_per_batch=wall_ms, profiled_wall_ms_per_batch=prof_wall_ms,
        device_idle_share=1 - total_ms / wall_ms if cuda else None,
        rollup=dict(sorted(rollup.items(), key=lambda kv: -kv[1])),
        top=[[_short(n), per_batch(us), c / n_batches]
             for n, (us, c) in top],
        gaps=(idle_gaps(dev_events, host_events(prof), GAPS, spans)
              if cuda else None),
        phases=phase_table(prof, spans, gaps, n_batches, cuda),
        counters={k: v / n_batches for k, v in sorted(rec["counts"].items())},
        device=m.device_info(dev))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="op_profile")
    p.add_argument("n_top", type=int, nargs="?", default=40)
    m.add_common_args(p)
    p.add_argument("--batches", type=int, default=4)
    p.add_argument("--single", action="store_true",
                   help="the single-end engine on each pair's first read")
    a = p.parse_args(argv)
    from ..models.single import resolve_device
    dev = resolve_device(a.device)
    bases = int(a.bases)
    index, index_s, src = m.open_index(a.index, a.cache, bases, dev)
    m.log(f"op_profile: index {src} in {index_s:.1f} s")
    line = run(index, device=dev, bases=bases, batch_pairs=a.batch_pairs,
               n_batches=a.batches, n_top=a.n_top, single=a.single)
    m.log(f"{line['timeline']} self-time {line['self_ms_per_batch']:.3f} "
          f"ms a batch; by category (ms a batch):")
    for cat, ms in line["rollup"].items():
        m.log(f"  {ms:9.3f}  {cat}")
    m.log("program counters a batch: " + ", ".join(
        f"{k} {v:g}" for k, v in line["counters"].items()))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
