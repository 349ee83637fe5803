"""Device time by operation and by category, and the device's idle gaps,
for the paired engine at the bench's operating point: the counterpart of
the JAX repo's tools/xprof_dump.py.

`--batches` batches of `--batch-pairs` wgsim pairs (seeds 0..N-1) through
PairedAligner(index, cand_per_read=64), one warm-up batch first.  The
batches are timed once on the host's clock, then run again under
torch.profiler (host operations with their Python stacks, and the card's
operations).  Prints one JSON line:
  * the device self-time a batch (every device operation's time summed)
    and the reads/s that alone would allow (2 reads a pair);
  * a rollup by category: each of K1-K5 by kernel name, then sort,
    gather/index, scatter, gather/scatter (torch's one kernel for both),
    reductions, copies and memsets, elementwise, other;
  * the top-n operations by time, ms and count a batch;
  * the host's wall ms a batch and the device's idle share of it;
  * the GAPS longest idle gaps between device operations, each with the
    operations on either side and what the host had open across it: the
    innermost profiled operation or Python frame covering the gap, the
    innermost aten:: operation and the innermost frame of this package.
On the card the JAX tool's xplane parsing becomes the profiler's device
events; it raises if the profiler saw no device operation.  On the CPU
(`--device cpu`) it profiles the host's aten:: operations by self time
instead, labelled "timeline": "cpu", with no idle share and no gaps.

    python -m snap_rnaseq_tpu_torch.tools.op_profile [n_top=40]
        [--batches 4] [--index DIR | --cache DIR]
        [--batch-pairs 1024] [--bases 64e6] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
from collections import defaultdict

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


def idle_gaps(dev_events, cpu_events, n: int) -> list:
    """The n longest gaps between consecutive device operations."""
    evs = sorted(dev_events, key=lambda e: e[2])
    gaps = [(b[2] - a[3], a, b) for a, b in zip(evs, evs[1:])
            if b[2] > a[3]]
    gaps.sort(key=lambda g: -g[0])
    return [dict(gap_ms=g / 1e3, after=_short(a[0], 100),
                 before=_short(b[0], 100),
                 **host_across(cpu_events, a[3], b[2]))
            for g, a, b in gaps[:n]]


def run(index, *, device="cuda", bases=m.GENOME_BASES,
        batch_pairs=m.BATCH_PAIRS, n_batches=4, n_top=40,
        base=None) -> dict:
    """The profile's JSON line dict.  `base`: an aligner whose device copy
    of the index is used (and whose config, cand_per_read=64 aside)."""
    from ..models.paired import PairedAligner
    from ..models.single import resolve_device
    dev = resolve_device(device)
    pa = (m.paired_on_state(base, cand_per_read=m.CAND_PER_READ)
          if base is not None else
          PairedAligner(index, device=dev, cand_per_read=m.CAND_PER_READ))
    batches = m.pair_batches(index, bases, batch_pairs, dev, n_batches)

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
    gaps = idle_gaps(dev_events, host_events(prof), GAPS) if cuda else None
    return dict(
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
        gaps=gaps, device=m.device_info(dev))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="op_profile")
    p.add_argument("n_top", type=int, nargs="?", default=40)
    m.add_common_args(p)
    p.add_argument("--batches", type=int, default=4)
    a = p.parse_args(argv)
    from ..models.single import resolve_device
    dev = resolve_device(a.device)
    bases = int(a.bases)
    index, index_s, src = m.open_index(a.index, a.cache, bases, dev)
    m.log(f"op_profile: index {src} in {index_s:.1f} s")
    line = run(index, device=dev, bases=bases, batch_pairs=a.batch_pairs,
               n_batches=a.batches, n_top=a.n_top)
    m.log(f"{line['timeline']} self-time {line['self_ms_per_batch']:.3f} "
          f"ms a batch; by category (ms a batch):")
    for cat, ms in line["rollup"].items():
        m.log(f"  {ms:9.3f}  {cat}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
