"""What the bench tools share (tools/bench.py, engine_ab.py,
phase_profile.py, op_profile.py): the bench's operating point, its index
and batches, aligners that share one device copy of the index, timed
windows, and device time from torch.profiler.

The operating point is the JAX repo's bench.py: a 64 Mb hg-like genome
(hg_like_genome(64e6, seed=0)) indexed at seed length 20, three batches
of 1,024 wgsim pairs of 100 bases (seeds 0-2) over the genome's body, and
PairedAligner(index, cand_per_read=64).

Device numbers come from the card only.  On the CPU (`--device cpu`, the
tests) every device metric is None ("not measured"), never a host time
under a device metric's name.  They come from profiled windows of at
least MIN_PROFILE_MS of work: the profiler loses a few device events at a
window's edges (all of a window of a few small operations), so a short
window undercounts device operations and busy time.
"""
from __future__ import annotations

import argparse
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE = os.path.join(REPO, ".bench_cache")
GENOME_BASES = 64_000_000
SEED_LEN = 20
BATCH_PAIRS = 1024
READ_LEN = 100
N_BATCHES = 3
CAND_PER_READ = 64
ROUNDS = 10
WINDOWS = 5
MIN_PROFILE_MS = 50.0         # the least work in a profiled window

# the port's kernels by the name the profiler gives their device events
KERNEL_NAMES = (("K1_lv_lanes", "lv_lanes_kernel"),
                ("K2_bitpar_packed", "bitpar_packed_kernel"),
                ("K3_lv_cigar", "lv_cigar_kernel"),
                ("K4_bitpar_rows", "bitpar_rows_kernel"),
                ("K5_lv_onehot", "lv_onehot_kernel"),
                ("K6_rowwise_front", "rowwise_front_kernel"),
                ("K7_seed_lookup", "seed_lookup_kernel"))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`'s
    first line, or None where there is no nvidia-smi."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    r = subprocess.run([smi, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    lines = r.stdout.strip().splitlines()
    return lines[0] if r.returncode == 0 and lines else None


def device_info(dev: torch.device) -> dict:
    """The device a tool ran on: the card's name and nvidia-smi's name and
    power limit, or "cpu"."""
    if dev.type != "cuda":
        return dict(kind="cpu", smi=None)
    return dict(kind=torch.cuda.get_device_name(dev), smi=card_line())


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--index", help="a saved index directory to load")
    p.add_argument("--cache", default=DEFAULT_CACHE,
                   help="where the bench's index is built and kept when "
                        "--index is not given (default: .bench_cache in "
                        "the checkout)")
    p.add_argument("--bases", type=float, default=GENOME_BASES,
                   help="genome bases of the built index and of the body "
                        "the reads are drawn from (default 64e6)")
    p.add_argument("--batch-pairs", type=int, default=BATCH_PAIRS)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions)")


def open_index(index_dir, cache, bases: int, device):
    """(GenomeIndex, seconds, "load" or "build"): `index_dir` loaded, or
    bench.py's index (hg_like_genome(bases, seed=0) at seed length 20)
    loaded from `cache`, or built on `device` with build_index_device and
    saved there first."""
    from ..index.genome import genome_from_codes
    from ..index.hash_index import GenomeIndex, build_index_device
    from ..utils.synth_genome import hg_like_genome
    t0 = time.time()
    d = index_dir or os.path.join(cache, f"hg{bases}_s{SEED_LEN}")
    if index_dir or os.path.exists(os.path.join(d, "index.json")):
        return GenomeIndex.load(d), time.time() - t0, "load"
    genome = genome_from_codes(hg_like_genome(bases, seed=0))
    index = build_index_device(genome, SEED_LEN, device=device).genome_index()
    index.save(d)
    return index, time.time() - t0, "build"


def genome_body(index, bases: int) -> np.ndarray:
    """The first `bases` codes after the first piece's padding (bench.py's
    read source)."""
    codes = np.asarray(index.genome.codes)
    pad = int(index.genome.piece_offsets[0])
    return codes[pad:pad + bases]


def pair_batches(index, bases: int, n_pairs: int, device,
                 n_batches: int = N_BATCHES, read_len: int = READ_LEN):
    """bench.py's batches: wgsim_pairs over the genome body, seeds
    0..n_batches-1, as (reads0, quals0, reads1, quals1) tensors on
    `device`."""
    from ..utils.synth_genome import wgsim_pairs
    body = genome_body(index, bases)
    out = []
    for s in range(n_batches):
        r0, q0, r1, q1, _, _ = wgsim_pairs(body, n_pairs, read_len, seed=s)
        out.append(tuple(torch.from_numpy(x).to(device)
                         for x in (r0, q0, r1, q1)))
    return out


def paired_on_state(base, **overrides):
    """A PairedAligner on `base`'s device copy of the index (no second
    upload), its config `base`'s with `overrides`."""
    from ..models.paired import PairedAligner, PairedAlignerConfig
    p = object.__new__(PairedAligner)
    p.index, p.device = base.index, base.device
    p.state, p.genome_size = base.state, base.genome_size
    p.cfg = PairedAlignerConfig(**{**base.cfg.__dict__, **overrides})
    return p


def single_on_state(base, **overrides):
    """A SingleAligner on an aligner's device copy of the index (bench.py
    :432-436 builds its single-end engine so), at the single-end defaults
    with `overrides`."""
    from ..models.single import SingleAligner, SingleAlignerConfig
    s = object.__new__(SingleAligner)
    s.index, s.device = base.index, base.device
    s.state, s.genome_size = base.state, base.genome_size
    s.cfg = SingleAlignerConfig(seed_len=base.index.seed_len, **overrides)
    return s


def launches() -> dict:
    from ..ops import kernels
    return dict(kernels.LAUNCHES)


def launches_since(before: dict, per: float = 1.0) -> dict:
    """Kernel launches since `before`, divided by `per`.  The counters are
    read, never reset, so a caller counting a whole run keeps its count."""
    return {k: (v - before[k]) / per for k, v in launches().items()
            if v != before[k]}


def spread(xs) -> dict:
    return dict(median=statistics.median(xs), min=min(xs), max=max(xs),
                windows=list(xs))


def kernel_of(event_name: str) -> str | None:
    for name, sym in KERNEL_NAMES:
        if sym in event_name:
            # K2's rescue instantiations carry a true template flag
            if name == "K2_bitpar_packed" and "true" in event_name:
                return "K2_bitpar_rescue"
            return name
    return None


def raw_events(prof) -> list:
    """Every event of a profile as (name, on the device, start us, end
    us), read from the profiler's own results: building its FunctionEvents
    costs tens of microseconds an event, and a profiled window of batches
    holds hundreds of thousands."""
    from torch.autograd import DeviceType
    return [(e.name(), e.device_type() == DeviceType.CUDA,
             e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()]


def profiled(fn, dev: torch.device, with_stack: bool = False):
    """Runs fn() under torch.profiler (host operations, and the card's
    when `dev` is one) and synchronises inside; returns the profile."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, with_stack=with_stack) as prof:
        fn()
        sync(dev)
    return prof


def profiled_units(n: int, wall_ms: float) -> int:
    """Units of work a profiled window holds: at least n, and as many as
    fill MIN_PROFILE_MS at `wall_ms` a unit."""
    return max(n, math.ceil(MIN_PROFILE_MS / max(wall_ms, 1e-3)))


def device_profile(fn, n: int, dev: torch.device) -> dict:
    """fn() (n units of work) under torch.profiler: device busy ms (the
    device operations' times summed), device operations, and each port
    kernel's ms and events, per unit.  On the CPU there is no device: fn
    is not run and every value is None."""
    if dev.type != "cuda":
        return dict(device_busy_ms=None, device_ops=None, kernel_ms=None,
                    kernel_events=None)
    busy_us, n_ops, kern, kern_n = 0.0, 0, {}, {}
    for name, on_dev, t0, t1 in raw_events(profiled(fn, dev)):
        if not on_dev:
            continue
        us = t1 - t0
        busy_us += us
        n_ops += 1
        k = kernel_of(name)
        if k:
            kern[k] = kern.get(k, 0.0) + us
            kern_n[k] = kern_n.get(k, 0) + 1
    if n_ops == 0:
        raise AssertionError("the profiler saw no device operation")
    return dict(device_busy_ms=busy_us / 1e3 / n, device_ops=n_ops / n,
                kernel_ms={k: v / 1e3 / n for k, v in sorted(kern.items())},
                kernel_events={k: v / n for k, v in sorted(kern_n.items())})


def timed_windows(step, batches, per_batch: int, rounds: int, windows: int,
                  dev: torch.device) -> dict:
    """bench.py's measurement of an engine, in windows: one warm-up batch,
    then `windows` windows of `rounds` batches cycling `batches`, each
    window dispatched batch after batch and synchronised once at its end
    (the engines read a few scalars back inside a batch, so a batch is not
    queued behind the one before as XLA queued them); then one more window
    under torch.profiler, of at least `rounds` batches and MIN_PROFILE_MS.
    Rates are `per_batch` reads over the window's wall time.  Returns the rates (median, min, max, each window), wall ms
    a batch (median window), the warm-up seconds, kernel launches a batch
    (timed windows), device busy ms, idle share and device operations a
    batch (the profiled window against the median wall), ms by kernel a
    batch, and the last batch's outputs."""
    t0 = time.time()
    out = step(batches[0])
    sync(dev)
    warm_s = time.time() - t0
    before = launches()
    rates, walls = [], []
    for _ in range(windows):
        t0 = time.time()
        for i in range(rounds):
            out = step(batches[i % len(batches)])
        sync(dev)
        dt = time.time() - t0
        rates.append(per_batch * rounds / dt)
        walls.append(dt * 1e3 / rounds)
    launched = launches_since(before, windows * rounds)

    wall = statistics.median(walls)
    n_prof = profiled_units(rounds, wall)

    def window():
        for i in range(n_prof):
            step(batches[i % len(batches)])
    prof = device_profile(window, n_prof, dev)
    busy = prof["device_busy_ms"]
    return dict(reads_per_sec=spread(rates), wall_ms_per_batch=wall,
                warm_s=warm_s, launches_per_batch=launched,
                device_busy_ms_per_batch=busy,
                device_idle_share=None if busy is None else 1 - busy / wall,
                device_ops_per_batch=prof["device_ops"],
                kernel_ms_per_batch=prof["kernel_ms"], out=out)


def peak_bytes(dev: torch.device):
    return (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def no_stage(name, fn):
    """The default of the tools' `stage` hook: run the stage."""
    return fn()
