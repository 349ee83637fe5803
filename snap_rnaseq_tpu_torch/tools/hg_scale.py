"""A human-sized genome built, checked and aligned on one card.

Port of the JAX package's three CPU scripts tools/hg_scale_build.py,
tools/hg_scale_check.py and tools/hg_align.py, with the index kept in
device memory instead of on disk:

  build  the genome of hg_scale_build.py (24 chromosomes of
         hg_like_genome(N // 24, seed=100 + c), each after a pad of 500
         padding codes, and a final pad; 3,200,012,492 bases at the
         default N) indexed at seed length 20 and load factor 0.7 by
         index/hash_index.py build_index_device, straight into 8 index
         slices; prints HG_SCALE.json's statistics, the seconds, the
         bases/s, the peak device bytes and the peak host RSS;
  check  build, then hg_scale_check.py's test through the probe-chain
         lookup on the card (ops/lookup.py lookup_seeds, each slice in
         turn, chains walked to their end): every sampled genome position
         must be among its seed's hits, and every overflow list read must
         be descending; also counts the seeds past the engine's probe cap;
  align  build, then hg_align.py's run: wgsim pairs of 100 bases from 2 Mb
         windows drawn by default_rng(0), batches of 256 pairs, through
         ShardedPairedAligner on a (1, 8) mesh whose coordinates all sit
         on one device, with cand_per_read 64 and the probe-chain lookup
         (hg_align.py's SNAP_TPU_LOOKUP=probe; the only lookup the device
         index's slices serve); prints HG_ALIGN.json's statistics dict.
  tables the CLI `index` route at this size: the build in the fewest
         slices whose slot offsets int32 holds (build_index_device's
         default), then the host GenomeIndex assembled from them
         (DeviceIndex.genome_index, what `index` saves), whose arrays
         must give HG_SCALE.json's statistics; nothing is written.

A 3.2 Gb build holds 48 GB of hash table, 2 GB of overflow and 1.6 GB of
packed genome on the card; the host holds the 3.2 GB of codes.  The
genome's chromosomes are made by worker processes side by side.

Usage: python -m snap_rnaseq_tpu_torch.tools.hg_scale
       {build,check,align,tables}
       [-n N_BASES] [--pairs N] [--device cuda|cpu] [--workers W]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np
import torch

from ..constants import UNUSED_HASH_VALUE
from ..index.genome import Genome
from ..index.hash_index import DeviceIndex, build_index_device
from ..ops import u32
from ..utils.synth_genome import hg_like_genome, wgsim_pairs
from ..utils.tables import BASE_PAD

N_BASES = 3_200_000_000
N_CHROMS = 24
SEED_LEN = 20
LOAD_FACTOR = 0.7
PAD = 500
N_INDEX = 8
N_CHECKS = 20_000
N_PAIRS = 100_000
BATCH = 256
READ_LEN = 100
WINDOW = 2_000_000
CAND_PER_READ = 64


def _log(msg):
    print(msg, flush=True)


class PeakRSS:
    """This process's peak resident set, sampled every `period` seconds
    from /proc/self/statm while the context is open (the kernel's
    ru_maxrss counts the whole life of the process)."""

    def __init__(self, period=0.05):
        self.period = period
        self.peak = 0
        self._stop = threading.Event()
        self._page = os.sysconf("SC_PAGE_SIZE")

    def _sample(self):
        with open("/proc/self/statm") as f:
            self.peak = max(self.peak, int(f.read().split()[1]) * self._page)

    def _run(self):
        while not self._stop.wait(self.period):
            self._sample()

    def __enter__(self):
        self._sample()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()


def synth_genome(n_bases: int = N_BASES, n_chroms: int = N_CHROMS,
                 workers: int | None = None, log=_log) -> Genome:
    """hg_scale_build.py's genome: n_chroms pieces of hg_like_genome(
    n_bases // n_chroms, seed=100 + c), each after PAD padding codes, and
    PAD more at the end.  The pieces are made by `workers` processes
    (default: one per core, at most n_chroms; 1 makes them here)."""
    per = n_bases // n_chroms
    total = n_chroms * (PAD + per) + PAD
    codes = np.full(total, BASE_PAD, np.uint8)
    offsets = [PAD + c * (PAD + per) for c in range(n_chroms)]
    workers = workers or min(n_chroms, os.cpu_count() or 1)
    seeds = [100 + c for c in range(n_chroms)]
    if workers <= 1:
        chroms = map(hg_like_genome, [per] * n_chroms, seeds)
        for off, chrom in zip(offsets, chroms):
            codes[off:off + per] = chrom
    else:
        with ProcessPoolExecutor(workers,
                                 mp_context=get_context("spawn")) as pool:
            for c, chrom in enumerate(pool.map(hg_like_genome,
                                               [per] * n_chroms, seeds)):
                codes[offsets[c]:offsets[c] + per] = chrom
                if log and (c + 1) % 8 == 0:
                    log(f"  chromosomes 1-{c + 1} made")
    return Genome(codes=codes,
                  piece_names=[f"chr{c + 1}" for c in range(n_chroms)],
                  piece_offsets=np.asarray(offsets, np.int64), padding=PAD)


def table_stats(di: DeviceIndex) -> dict:
    """HG_SCALE.json's table statistics of a device index: occupied_slots
    counts the slots whose value1 is not the unused marker, as
    hg_scale_build.py does (a slice's padding rows are empty, never
    unused)."""
    unused = u32.const(UNUSED_HASH_VALUE)
    n_unused = sum(int((e[:, 1] == unused).sum())
                   for e in di.parts["ht_entries"])
    return dict(total_slots=di.total_slots,
                occupied_slots=di.total_slots - n_unused,
                overflow_entries=di.overflow_len,
                ht_bytes=di.total_slots * 12,
                overflow_bytes=di.overflow_len * 4)


def build(genome: Genome, device="cuda", n_index: int | None = N_INDEX,
          log=_log, **budgets):
    """The index on `device` in n_index slices (None: the fewest that
    int32 slot offsets allow), and its statistics
    (seconds, bases/s, table statistics, peak device bytes of the build,
    the device's name)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    di = build_index_device(genome, SEED_LEN, LOAD_FACTOR, dev,
                            n_index=n_index, verbose=log is not None,
                            **budgets)
    if cuda:
        torch.cuda.synchronize(dev)
    build_s = time.time() - t0
    stats = dict(n_bases=genome.num_bases, n_chromosomes=genome.num_pieces,
                 seed_len=SEED_LEN, build_s=build_s,
                 build_bases_per_s=genome.num_bases / build_s,
                 **table_stats(di),
                 peak_device_bytes=(torch.cuda.max_memory_allocated(dev)
                                    if cuda else None),
                 host=(torch.cuda.get_device_name(dev) if cuda
                       else "CPU tensors"))
    return di, stats


def host_tables(di: DeviceIndex, log=_log) -> dict:
    """DeviceIndex.genome_index() of a build, timed, and HG_SCALE.json's
    statistics counted on its host arrays."""
    t0 = time.time()
    gi = di.genome_index()
    res = dict(slices=len(di.parts["ht_entries"]),
               host_s=time.time() - t0,
               total_slots=int(gi.ht_keys.shape[0]),
               occupied_slots=int((gi.ht_val1 != UNUSED_HASH_VALUE).sum()),
               overflow_entries=int(gi.overflow.shape[0]),
               ht_bytes=int(gi.ht_keys.nbytes * 3),
               overflow_bytes=int(gi.overflow.nbytes))
    if log:
        log("tables: " + json.dumps(res))
    return res


def _packed_seeds(fwd, rc, valid, dev) -> dict:
    """pack_seeds_at's numpy packs as ops/lookup.py pack_seeds' (N, 1)
    int32-carried halves."""
    lo = lambda v: u32.from_numpy((v & 0xFFFFFFFF).astype(np.uint32), dev)
    hi = lambda v: u32.from_numpy((v >> np.uint64(32)).astype(np.uint32),
                                  dev)
    col = lambda t: t.reshape(-1, 1)
    return dict(lo_f=col(lo(fwd)), hi_f=col(hi(fwd)), lo_r=col(lo(rc)),
                hi_r=col(hi(rc)),
                valid=col(torch.from_numpy(valid).to(dev)))


def _in_descending(ovf, base, count, want):
    """Is `want` among ovf[base:base + count] (descending u32 lists), by
    a binary search per row; values compared as int64."""
    lo = torch.zeros_like(base)
    hi = count.clone()
    at = lambda i: u32.to_i64(ovf[(base + i).clamp(0, ovf.shape[0] - 1)])
    for _ in range(33):
        go = lo < hi
        mid = (lo + hi) // 2
        right = go & (at(mid) > want)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(go & ~right, mid, hi)
    return (lo < count) & (at(lo) == want)


def _descending(ovf, base, count) -> bool:
    """Is every list ovf[base:base + count] strictly descending?"""
    many = count > 1
    base, count = base[many], count[many]
    if not base.numel():
        return True
    first = torch.cumsum(count, 0) - count
    rank = torch.arange(int(count.sum()), device=ovf.device) - \
        torch.repeat_interleave(first, count)
    v = u32.to_i64(ovf[torch.repeat_interleave(base, count) + rank])
    step_ok = (v[1:] < v[:-1]) | (rank[1:] == 0)
    return bool(step_ok.all())


def check(di: DeviceIndex, n_checks: int = N_CHECKS, log=_log) -> dict:
    """hg_scale_check.py's lookup test on the device index: the seeds at
    n_checks positions from default_rng(0), looked up in every slice
    (ops/lookup.py lookup_seeds, each probe chain walked to its end, as
    the host lookup the JAX script used walks it); each valid one must be
    found and its position be among its hits; the hit lists read must
    descend.  past_probe_cap counts the valid seeds the engine's lookup,
    cut at MAX_PROBES probes, does not find."""
    from ..index.seeds import pack_seeds_at
    from ..ops.lookup import expand_counts, lookup_seeds
    t0 = time.time()
    genome = di.genome
    gsize = genome.num_bases
    dev = di.parts["ht_entries"][0].device
    rng = np.random.default_rng(0)
    pos = rng.integers(0, gsize - di.seed_len, n_checks)
    fwd, rc, valid = pack_seeds_at(genome.codes, pos, di.seed_len)
    packed = _packed_seeds(fwd, rc, valid, dev)
    want = torch.from_numpy(pos).to(dev)
    found = torch.zeros(n_checks, dtype=torch.bool, device=dev)
    has_pos = torch.zeros_like(found)
    sizes = torch.zeros(n_checks, dtype=torch.int64, device=dev)
    descending = True
    parts = di.parts
    capped = torch.zeros_like(found)
    for d in range(len(parts["ht_entries"])):
        tables = (parts["ht_entries"][d], parts["shard_start"][d],
                  parts["shard_size"][d])
        f, fv, rv = lookup_seeds(packed, *tables, max_probes=None)
        capped |= lookup_seeds(packed, *tables)[0][:, 0]
        f, fv, rv = f[:, 0], fv[:, 0], rv[:, 0]
        ovf = parts["overflow"][d]
        n_f, base_f = expand_counts(fv, ovf, gsize)
        n_r, _ = expand_counts(rv, ovf, gsize)
        n_f, base_f = u32.to_i64(n_f), base_f.to(torch.int64)
        direct = base_f < 0
        hit = torch.where(direct, u32.to_i64(fv) == want,
                          _in_descending(ovf, base_f, n_f, want))
        found |= f
        has_pos |= f & hit
        sizes = torch.where(f, n_f + u32.to_i64(n_r), sizes)
        descending &= _descending(ovf, base_f[f & ~direct],
                                  n_f[f & ~direct])
    ok_t = torch.from_numpy(valid).to(dev)
    n_ok = int((ok_t & found & has_pos).sum())
    n_valid = int(valid.sum())
    hs = sizes[ok_t].cpu().numpy()
    res = dict(n_checked=n_valid, found=n_ok, missing=n_valid - n_ok,
               invalid_windows=int(n_checks - n_valid),
               past_probe_cap=int((ok_t & found & ~capped).sum()),
               overflow_descending=descending,
               hit_size_p50=float(np.percentile(hs, 50)) if hs.size else 0.0,
               hit_size_p99=float(np.percentile(hs, 99)) if hs.size else 0.0,
               hit_size_max=int(hs.max()) if hs.size else 0,
               check_s=time.time() - t0)
    if log:
        log("check: " + json.dumps(res))
    return res


def make_aligner(di: DeviceIndex, device="cuda", cand_per_read=CAND_PER_READ):
    """ShardedPairedAligner on a (1, n_index) mesh whose coordinates are
    all `device`, over the device index's own slices (probe-chain lookup),
    with the genome's packed words made on the device."""
    from ..ops.genome_gather import pack_genome_4bit_torch
    from ..parallel.sharded import ShardedPairedAligner, make_mesh
    n_index = len(di.parts["ht_entries"])
    mesh = make_mesh(1, n_index, device=device)
    dev = mesh.devices[0, 0]
    di.genome.packed_4bit = pack_genome_4bit_torch(
        torch.from_numpy(di.genome.codes).to(dev))
    saved = os.environ.get("SNAP_TPU_LOOKUP")
    os.environ["SNAP_TPU_LOOKUP"] = "probe"       # hg_align.py's lookup
    try:
        return ShardedPairedAligner(di, mesh, cand_per_read=cand_per_read)
    finally:
        if saved is None:
            del os.environ["SNAP_TPU_LOOKUP"]
        else:
            os.environ["SNAP_TPU_LOOKUP"] = saved


def pair_batches(genome: Genome, n_pairs: int = N_PAIRS, batch: int = BATCH,
                 window: int = WINDOW):
    """hg_align.py's batches: per batch a `window`-base window of the
    genome after its first pad, drawn by default_rng(0), and wgsim pairs
    of READ_LEN bases inside it (pad codes read as N), the last batch
    padded to `batch` rows with N reads.  Yields (n, (r0, q0, r1, q1),
    true0, true1)."""
    codes = genome.codes
    pad = int(genome.piece_offsets[0])
    body_len = genome.num_bases - pad
    rng = np.random.default_rng(0)
    done = 0
    while done < n_pairs:
        n = min(batch, n_pairs - done)
        wstart = int(rng.integers(0, body_len - window))
        win = np.minimum(codes[pad + wstart:pad + wstart + window], 4)
        r0, q0, r1, q1, p0, p1 = wgsim_pairs(
            win, n, READ_LEN, seed=int(rng.integers(1 << 30)))
        if n < batch:
            fill = ((0, batch - n), (0, 0))
            r0, r1 = (np.pad(r, fill, constant_values=4) for r in (r0, r1))
            q0, q1 = (np.pad(q, fill, constant_values=ord("!"))
                      for q in (q0, q1))
        yield n, (r0, q0, r1, q1), pad + wstart + p0, pad + wstart + p1
        done += n


def align(aligner, genome: Genome, n_pairs: int = N_PAIRS,
          batch: int = BATCH, window: int = WINDOW, log=_log,
          mesh: str = "1 data x 8 index") -> dict:
    """hg_align.py's loop and statistics dict over `aligner` (any object
    whose align_batch takes the four (batch, READ_LEN) arrays and returns
    loc0, loc1, pair_found, mapq0, mapq1, truncated0 and truncated1)."""
    t0 = time.time()
    stats = dict(n_pairs=0, pos0_ok=0, pos1_ok=0, pair_found=0,
                 both_pos_ok=0, truncated0=0, truncated1=0,
                 mapq_ge10_ok=0, mapq_ge10=0)
    t_align = 0.0
    as_u32 = lambda a: np.asarray(a)[:n].astype(np.int32).view(
        np.uint32).astype(np.int64)
    for n, arrays, true0, true1 in pair_batches(genome, n_pairs, batch,
                                                window):
        ta = time.time()
        out = aligner.align_batch(*arrays)
        t_align += time.time() - ta
        ok0 = np.abs(as_u32(out["loc0"]) - true0) <= 2
        ok1 = np.abs(as_u32(out["loc1"]) - true1) <= 2
        mq = np.minimum(np.asarray(out["mapq0"])[:n],
                        np.asarray(out["mapq1"])[:n])
        hi = mq >= 10
        stats["n_pairs"] += n
        stats["pos0_ok"] += int(ok0.sum())
        stats["pos1_ok"] += int(ok1.sum())
        stats["both_pos_ok"] += int((ok0 & ok1).sum())
        stats["pair_found"] += int(np.asarray(out["pair_found"])[:n].sum())
        stats["truncated0"] += int(np.asarray(out["truncated0"]).sum())
        stats["truncated1"] += int(np.asarray(out["truncated1"]).sum())
        stats["mapq_ge10"] += int(hi.sum())
        stats["mapq_ge10_ok"] += int((hi & ok0 & ok1).sum())
        done = stats["n_pairs"]
        if log and (done % (batch * 64) == 0 or done >= n_pairs):
            log(f"  {done}/{n_pairs} pairs; recall0 "
                f"{stats['pos0_ok'] / done:.4f} recall1 "
                f"{stats['pos1_ok'] / done:.4f} pair "
                f"{stats['pair_found'] / done:.4f} "
                f"({done / max(t_align, 1e-9):,.0f} pairs/s align)")
    done = max(stats["n_pairs"], 1)
    return dict(
        index="in device memory (build_index_device)",
        genome_bases=genome.num_bases, mesh=mesh, lookup="probe",
        batch_pairs=batch, read_len=READ_LEN,
        recall0=stats["pos0_ok"] / done, recall1=stats["pos1_ok"] / done,
        pair_recall=stats["both_pos_ok"] / done,
        pair_found_rate=stats["pair_found"] / done,
        mapq_ge10_precision=stats["mapq_ge10_ok"] / max(stats["mapq_ge10"],
                                                        1),
        align_pairs_per_s=stats["n_pairs"] / max(t_align, 1e-9),
        wall_s=time.time() - t0, **stats)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hg_scale")
    p.add_argument("command", choices=("build", "check", "align",
                                       "tables"))
    p.add_argument("-n", dest="n_bases", type=float, default=N_BASES,
                   help="genome bases before padding (default 3.2e9)")
    p.add_argument("--pairs", type=int, default=N_PAIRS)
    p.add_argument("--checks", type=int, default=N_CHECKS)
    p.add_argument("--device", default="cuda")
    p.add_argument("--workers", type=int, default=None,
                   help="processes making chromosomes (default: cores)")
    a = p.parse_args(argv)
    # the build frees and allocates tens of GB in blocks of many sizes;
    # set before the first CUDA allocation
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    from ..models.single import resolve_device
    dev = resolve_device(a.device)
    with PeakRSS() as rss:
        t0 = time.time()
        genome = synth_genome(int(a.n_bases), workers=a.workers)
        synth_s = time.time() - t0
        _log(f"genome: {genome.num_bases:,} bases, {genome.num_pieces} "
             f"pieces in {synth_s:.1f} s")
        di, stats = build(genome, dev, n_index=(
            None if a.command == "tables" else N_INDEX))
        stats["synth_s"] = synth_s
        _log("build: " + json.dumps(stats))
        if a.command == "tables":
            host_tables(di)
        if a.command == "check":
            check(di, a.checks)
        if a.command == "align":
            res = align(make_aligner(di, dev), genome, a.pairs,
                        mesh=f"1 data x {N_INDEX} index ({dev})")
            _log("align: " + json.dumps(res))
    _log(f"peak host RSS: {rss.peak} bytes" + (
        f"; peak device bytes: {torch.cuda.max_memory_allocated(dev)}"
        if dev.type == "cuda" else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
