"""The traced part of a `--trace 1` run: torch.profiler over the first
steps of the window, the kernel launches' shapes recorded by hooks around
the port's two kernel wrappers, and their reduction to what the metric
readers take.

Device events are read from the profiler's raw kineto results (building
its FunctionEvents costs tens of microseconds an event).  Categories
follow the port's op profiler: each kernel of the port by its symbol,
then sort, gather/scatter, scatter, gather/index, reductions, copies and
memsets, elementwise, other.
"""
from __future__ import annotations

import bisect
import shutil
import subprocess
from contextlib import contextmanager

import numpy as np
import torch

from . import roofline

# the port's kernels by the symbol their device events carry
KERNELS = (("K1_lv_lanes", "lv_lanes_kernel"),
           ("K2_bitpar_packed", "bitpar_packed_kernel"),
           ("K3_lv_cigar", "lv_cigar_kernel"),
           ("K4_bitpar_rows", "bitpar_rows_kernel"),
           ("K5_lv_onehot", "lv_onehot_kernel"))
CATEGORIES = (
    ("sort", ("sort", "radix")),
    ("gather/scatter", ("scatter_gather",)),
    ("scatter", ("scatter", "index_put", "put_kernel")),
    ("gather/index", ("index", "gather", "take", "searchsorted")),
    ("reductions", ("reduce", "scan", "cumsum")),
    ("copies and memsets", ("memcpy", "memset", "copy", "fill")),
    ("elementwise", ("elementwise",)),
)
TOP = 10


def kernel_of(name: str):
    for k, sym in KERNELS:
        if sym in name:
            if k == "K2_bitpar_packed" and "true" in name:
                return "K2_bitpar_rescue"
            return k
    return None


def category(name: str) -> str:
    k = kernel_of(name)
    if k:
        return k
    low = name.lower()
    return next((c for c, keys in CATEGORIES if any(s in low for s in keys)),
                "other")


def raw_events(prof) -> list:
    """(name, on the device, start us, end us) of every profiled event."""
    from torch.autograd import DeviceType
    return [(e.name(), e.device_type() == DeviceType.CUDA,
             e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()]


def union_us(intervals: list) -> tuple:
    """(busy us, merged intervals) of (start, end) pairs."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def max_sm_clock_hz():
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    r = subprocess.run([smi, "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True)
    try:
        return float(r.stdout.split()[0]) * 1e6
    except (IndexError, ValueError):
        return None


class KernelHooks:
    """Records each K1 and K2 launch's shape (and K1's levels) while
    active; the wrappers are the port's own, called unchanged."""

    def __init__(self):
        self.calls = []

    @contextmanager
    def active(self):
        from snap_rnaseq_tpu_torch.ops import bitpar, lv_cuda
        lanes, packed = lv_cuda._lanes, bitpar.bitpar_packed

        def lanes_hook(lib, counter, pattern, p_len, text, t_len, k, quality,
                       free, e_max, cigar_order):
            res = lanes(lib, counter, pattern, p_len, text, t_len, k,
                        quality, free, e_max, cigar_order)
            qb = 0 if quality is None else quality.element_size()
            self.calls.append(dict(
                kernel="K1_lv_lanes" if counter == "K1_lv_lanes" else counter,
                B=pattern.shape[0], P=pattern.shape[1], T=text.shape[1],
                q_bytes=qb, free=free is not None, e_max=e_max,
                k=k.detach().clone() if torch.is_tensor(k) else k,
                distance=res.distance, e_final=res.e_final))
            return res

        def packed_hook(pattern, words, t_len, *, P, TXT, packed_off,
                        track_pos=False, free_start=False, reverse=False):
            out = packed(pattern, words, t_len, P=P, TXT=TXT,
                         packed_off=packed_off, track_pos=track_pos,
                         free_start=free_start, reverse=reverse)
            rescue = reverse or free_start or track_pos
            self.calls.append(dict(
                kernel="K2_bitpar_rescue" if rescue else "K2_bitpar_packed",
                B=words.shape[0], P=P, TXT=TXT, NW=words.shape[1]))
            return out

        lv_cuda._lanes, bitpar.bitpar_packed = lanes_hook, packed_hook
        try:
            yield self
        finally:
            lv_cuda._lanes, bitpar.bitpar_packed = lanes, packed

    def bounds_s(self, ops_per_s: float) -> dict:
        """Σ bound seconds by kernel over the recorded launches."""
        out = {}
        for c in self.calls:
            if c["kernel"].startswith("K2"):
                b = roofline.bound_s(
                    roofline.bitpar_packed_bytes(c["B"], c["P"], c["NW"]),
                    roofline.bitpar_ops(c["B"], c["TXT"], c["P"]), ops_per_s)
            else:
                k = c["k"]
                k = (k.cpu().numpy() if torch.is_tensor(k)
                     else np.full(c["B"], k))
                lev = roofline.lv_levels(c["distance"].cpu().numpy(),
                                         c["e_final"].cpu().numpy(), k,
                                         c["e_max"])
                b = roofline.bound_s(
                    roofline.lv_bytes(c["B"], c["P"], c["T"], c["q_bytes"],
                                      c["free"]),
                    roofline.lv_ops(lev, c["P"]), ops_per_s)
            out[c["kernel"]] = out.get(c["kernel"], 0.0) + b
        return out


def summarize(prof, window_s: float) -> dict:
    """Device busy time (union of intervals), operations, time by
    category and by kernel, and the longest idle gaps with the host
    operation open across each."""
    events = raw_events(prof)
    dev = [(n, a, b) for n, on_dev, a, b in events if on_dev and b > a]
    host = sorted(((a, b, n) for n, on_dev, a, b in events
                   if not on_dev and b > a))
    if not dev:
        return dict(n_ops=0, busy_s=0.0, window_s=window_s)
    busy_us, merged = union_us([(a, b) for _, a, b in dev])
    by_cat, by_kernel = {}, {}
    for n, a, b in dev:
        c = category(n)
        by_cat[c] = by_cat.get(c, 0.0) + (b - a) / 1e6
        k = kernel_of(n)
        if k:
            by_kernel[k] = by_kernel.get(k, 0.0) + (b - a) / 1e6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:TOP]
    starts = [h[0] for h in host]
    named = []
    for length, a, b in gaps:
        # the longest host operation that overlaps the gap
        j = bisect.bisect_right(starts, b)
        over = [h for h in host[max(0, j - 4000):j] if h[1] > a]
        name = max(over, key=lambda h: min(h[1], b) - max(h[0], a))[2] \
            if over else "no host operation"
        named.append(["host:" + name[:80], length / 1e6])
    cats = sorted(by_cat.items(), key=lambda kv: -kv[1])
    return dict(n_ops=len(dev), busy_s=busy_us / 1e6, window_s=window_s,
                device_s=sum(by_cat.values()), by_category=dict(cats),
                by_kernel=by_kernel,
                device_ops=[[c, s] for c, s in cats[:TOP]],
                idle_gaps=named)


@contextmanager
def profiling():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
