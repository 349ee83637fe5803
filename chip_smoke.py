#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (snap_rnaseq_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one NVIDIA card (sm_90a, e.g. an H100) and the CUDA toolkit; exits
non-zero and prints no result without them.  Every phase raises on
failure; nothing is caught.

1. Build: the hand-written kernels are compiled from csrc/ (one nvcc per
   source, all at once); prints the build seconds and the card's name and
   power limit.
2. Kernel checks: K1 (LV-lanes), K2 (packed bitpar) and K3 (LV-CIGAR)
   each against its plain PyTorch version on the card, on random edit
   cases at the main path's shapes; integers must be bit-identical and
   log-probabilities within rtol/atol 1e-5.  Times kernel and plain
   version with CUDA events.
3. Golden: tests/test_golden.py's dataset through the port's `index` +
   `single` CLI on the card must reproduce tests/golden/single_100bp.sam
   (without @PG) byte for byte.
4. Real size: `index` on a 64 Mb hg-like genome, then `single -bs 1024` on
   16 batches of simulated 100 bp reads (substitutions, indels, both
   strands).  The launch counters are zeroed just before this run and read
   just after; each kernel must have launched.  Prints reads/s, the
   aligned share, the share placed at the true origin, index-build
   seconds, peak device memory and the pipeline's wait profile, and
   checks the placement share.  Then the engine alone on the same index
   and reads (SingleAligner.align_batch_device + the grouped fetch): wall
   ms per batch, and under torch.profiler the device's busy ms, its idle
   share, device operations and the hand-written kernels' ms per batch.
5. Prints the kernels line, the card line, and last the result line.
"""
import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GENOME_BASES = 64_000_000
N_BATCHES, BATCH = 16, 1024
READ_LEN = 100
# roofline inputs: HBM bytes/s (NVIDIA H100 SXM data sheet); the 32-bit
# integer/logic peak is derived from the card (int32_ops_per_s)
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64            # 4 partitions x 16 INT32 units (Hopper)
TOL = 1e-5


def log(msg):
    print(msg, flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- helpers

def time_ms(fn, reps):
    """Mean milliseconds per call on the card (CUDA events, after one
    warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@functools.lru_cache(None)
def int32_ops_per_s():
    """Peak 32-bit integer/logic issue rate: SMs x INT32 lanes per SM x
    the card's maximum SM clock (nvidia-smi, MHz)."""
    import torch
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / int32_ops_per_s() * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lv_ops(levels, P):
    """32-bit operations an LV row needs for the levels it ran: ~12 per
    in-band diagonal (2e+1 of them at level e) and, for extension, one
    4-byte compare of ~6 operations per pattern word on each diagonal the
    band reached."""
    n = levels.astype(np.float64)
    return float((12 * (n * n + 2 * n) + (2 * n + 1) * (P // 4) * 6).sum())


def assert_same(name, got, want):
    import torch
    if not torch.equal(got.cpu(), want.cpu()):
        bad = int((got != want).sum())
        raise AssertionError(f"{name}: {bad} entries differ from the plain "
                             "version")


def logp_err(name, got, want):
    """Max abs difference of finite log-probabilities; raises beyond the
    tolerance."""
    import torch
    g, w = got.double(), want.double()
    if not torch.equal(g <= -1e29, w <= -1e29):
        raise AssertionError(f"{name}: failure rows differ")
    fin = w > -1e29
    diff = (g - w).abs()[fin]
    if diff.numel() and bool((diff > TOL + TOL * w.abs()[fin]).any()):
        raise AssertionError(f"{name}: log_prob off by {float(diff.max())}")
    return float(diff.max()) if diff.numel() else 0.0


def edit_cases(rng, B, P, T, n_edits_max, filler=True):
    """Pattern rows and text rows that are the pattern with random
    substitutions, insertions and deletions, then random bases to T."""
    pats = rng.integers(0, 4, (B, P), dtype=np.uint8)
    pats[rng.random((B, P)) < 0.005] = 4
    texts = (rng.integers(0, 4, (B, T), dtype=np.uint8) if filler
             else np.zeros((B, T), np.uint8))
    t_len = np.full(B, T, np.int32)
    n_edits = rng.integers(0, n_edits_max + 1, B)
    for i in range(B):
        t = list(pats[i] % 4)
        for _ in range(int(n_edits[i])):
            op, pos = rng.integers(0, 3), int(rng.integers(0, len(t)))
            if op == 0:
                t[pos] = (t[pos] + 1) % 4
            elif op == 1:
                del t[pos]
            else:
                t.insert(pos, int(rng.integers(0, 4)))
        t = t[:T]
        texts[i, :len(t)] = t
        if not filler:
            t_len[i] = len(t)
    return pats, texts, t_len


# ---------------------------------------------------------------- phase 2

def check_k1(dev, rng):
    """K1 at score_phase's shape: P = 100, T = read_len + e_max = 116,
    e_max = 16, free prefixes, f32 quality rows."""
    import torch
    from snap_rnaseq_tpu_torch.ops import lv
    from snap_rnaseq_tpu_torch.ops.lv_cuda import lv_lanes
    B, P, E = 40_960, READ_LEN, 16
    T = P + E
    pats, texts, t_len = edit_cases(rng, B, P, T, E + 2)
    short = rng.random(B) < 0.05              # clipped text windows
    t_len[short] = rng.integers(P - E, T, int(short.sum()))
    k = np.where(rng.random(B) < 0.9, E, rng.integers(0, E + 1, B)).astype(
        np.int32)
    free = rng.integers(0, P - 10, B).astype(np.int32)
    quals = rng.integers(35, 74, (B, P)).astype(np.uint8)
    to = lambda a: torch.from_numpy(a).to(dev)
    args = (to(pats), to(np.full(B, P, np.int32)), to(texts), to(t_len),
            to(k), lv.phred_log_prob_device(to(quals)))
    fr = to(free)
    got = lv_lanes(*args, fr, e_max=E)
    want = lv._lv_distance_plain(*args, fr, e_max=E)
    for f in ("distance", "e_final", "d_final", "net_indel"):
        assert_same(f"K1 {f}", getattr(got, f), getattr(want, f))
    err = logp_err("K1", got.log_prob, want.log_prob)
    ms = time_ms(lambda: lv_lanes(*args, fr, e_max=E), 20)
    plain_ms = time_ms(lambda: lv._lv_distance_plain(*args, fr, e_max=E), 3)
    # work this data needs: the DP levels each row ran (to the winning
    # level, or to k when none wins); bytes: inputs once (pattern, text,
    # f32 qualities, four i32 vectors) + 5 outputs
    dist = want.distance.cpu().numpy()
    levels = np.where(dist >= 0, want.e_final.cpu().numpy(),
                      np.maximum(np.minimum(k, E), 1))
    nbytes = B * (P + T + 4 * P + 16) + B * 20
    b_ms, b_by = bound(nbytes, lv_ops(levels, P))
    return dict(name="K1_lv_lanes", route="cuda",
                source="snap_rnaseq_tpu_torch/csrc/lv_lanes.cu",
                replaces="snap_rnaseq_tpu/ops/lv_pallas.py:374",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, rows=B,
                found=int((dist >= 0).sum()))


def check_k2(dev, rng):
    """K2 at the prefilter's shape: 256 reads x 128 candidates, P = 100,
    TXT = 116, packed_off = 16, 18 packed words per row."""
    import torch
    from snap_rnaseq_tpu_torch.ops import bitpar
    from snap_rnaseq_tpu_torch.ops import u32
    from snap_rnaseq_tpu_torch.ops.genome_gather import pack_genome_4bit
    B, P, TXT, OFF = 32_768, READ_LEN, READ_LEN + 16, 16
    NW = (READ_LEN + 32 + 7) // 8 + 1
    codes = rng.integers(0, 4, (B, NW * 8), dtype=np.uint8)
    codes[rng.random((B, NW * 8)) < 0.002] = 5
    pats, texts, _ = edit_cases(rng, B, P, TXT - 8, 6)
    live = rng.random(B) < 0.5
    codes[live, OFF + 4:OFF + TXT - 4] = texts[live]
    words = pack_genome_4bit(codes.reshape(-1))[:B * NW].reshape(B, NW)
    to = lambda a: torch.from_numpy(a).to(dev)
    pat, w = to(pats), u32.from_numpy(words, dev)
    tl = to(np.full(B, TXT, np.int32))
    kw = dict(P=P, TXT=TXT, packed_off=OFF)
    got = bitpar.bitpar_packed(pat, w, tl, **kw)
    want = bitpar.bitpar_distance_plain(
        pat, bitpar.unpack_words(w)[:, OFF:OFF + TXT], tl, P=P)
    assert_same("K2 distance", got, want)
    ms = time_ms(lambda: bitpar.bitpar_packed(pat, w, tl, **kw), 20)
    plain_ms = time_ms(lambda: bitpar.bitpar_distance_plain(
        pat, bitpar.unpack_words(w)[:, OFF:OFF + TXT], tl, P=P), 3)
    W = (P + 31) // 32
    ops = float(B) * TXT * (W * 22 + 8) + B * P * 4 * W
    nbytes = B * (P + 4 * NW + 4) + B * 4
    b_ms, b_by = bound(nbytes, ops)
    return dict(name="K2_bitpar_packed", route="cuda",
                source="snap_rnaseq_tpu_torch/csrc/bitpar_packed.cu",
                replaces="snap_rnaseq_tpu/ops/bitpar.py:69",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, rows=B,
                within_e_max=int((want <= 16).sum()))


def check_k3(dev, rng):
    """K3 at the CIGAR path's shape (io/sam.py): pattern and text rows of
    the read length, texts no longer than their reads, e_max = 31, k = 30,
    the CIGAR diagonal order.  Timed as the path calls it, without the
    L/A tables; the tables are checked once more with tables=True."""
    import torch
    from snap_rnaseq_tpu_torch.ops import lv
    from snap_rnaseq_tpu_torch.ops.lv_cuda import lv_cigar
    B, P, E = 10_240, READ_LEN, 31
    pats, texts, t_len = edit_cases(rng, B, P, P, 8, filler=False)
    to = lambda a: torch.from_numpy(a).to(dev)
    args = (to(pats), to(np.full(B, P, np.int32)), to(texts), to(t_len),
            to(np.full(B, E - 1, np.int32)))
    want = lv._lv_distance_plain(*args, None, None, e_max=E,
                                 cigar_order=True, keep_tables=True)
    got = lv_cigar(*args, None, e_max=E)
    if got.L.shape[1] or got.A.shape[1]:
        raise AssertionError("K3 wrote tables it was not asked for")
    for f in ("distance", "e_final", "d_final", "net_indel", "acts",
              "matched", "start_run"):
        assert_same(f"K3 {f}", getattr(got, f), getattr(want, f))
    err = logp_err("K3", got.log_prob, want.log_prob)
    full = lv_cigar(*args, None, e_max=E, tables=True)
    for f in ("L", "A", "acts", "matched", "start_run"):
        assert_same(f"K3 tables {f}", getattr(full, f), getattr(want, f))
    ms = time_ms(lambda: lv_cigar(*args, None, e_max=E), 20)
    plain_ms = time_ms(lambda: lv._lv_distance_plain(
        *args, None, None, e_max=E, cigar_order=True, keep_tables=True), 3)
    # work: levels run (to the winning level, or to k); bytes: pattern,
    # text, three i32 vectors in; six scalars and the (acts, matched)
    # script out
    dist = want.distance.cpu().numpy()
    levels = np.where(dist >= 0, want.e_final.cpu().numpy(), E - 1)
    nbytes = B * (2 * P + 12) + B * (24 + 2 * E * 4)
    b_ms, b_by = bound(nbytes, lv_ops(levels, P))
    return dict(name="K3_lv_cigar", route="cuda",
                source="snap_rnaseq_tpu_torch/csrc/lv_cigar.cu",
                replaces="snap_rnaseq_tpu/ops/lv_pallas.py:90",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, rows=B,
                indel_rows=int((want.net_indel != 0).sum()))


# ---------------------------------------------------------------- phase 3

def golden_dataset(tmp):
    """tests/test_golden.py's dataset, rebuilt with the port's modules."""
    from snap_rnaseq_tpu_torch.index.genome import read_fasta_genome
    from snap_rnaseq_tpu_torch.utils.tables import (decode_bases,
                                                    reverse_complement_codes)
    rng = np.random.default_rng(20260816)
    chr1 = decode_bases(rng.integers(0, 4, 8000, dtype=np.uint8))
    chr2 = decode_bases(rng.integers(0, 4, 5000, dtype=np.uint8))
    fa = os.path.join(tmp, "ref.fa")
    with open(fa, "wb") as f:
        f.write(b">chr1\n" + chr1 + b"\n>chr2\n" + chr2 + b"\n")
    g = read_fasta_genome(fa)
    L = 100
    reads = []
    for i in range(64):
        piece = int(rng.integers(0, 2))
        plen = 8000 if piece == 0 else 5000
        start = int(g.piece_offsets[piece]) + int(rng.integers(0, plen - L))
        codes = np.asarray(g.codes[start:start + L]).copy()
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, L))
            codes[p] = (codes[p] + int(rng.integers(1, 4))) % 4
        if rng.integers(0, 2):
            codes = reverse_complement_codes(codes)
        reads.append((f"g{i}".encode(), decode_bases(codes)))
    fq = os.path.join(tmp, "reads.fq")
    with open(fq, "wb") as f:
        for rid, seq in reads:
            f.write(b"@" + rid + b"\n" + seq + b"\n+\n" + b"I" * L + b"\n")
    return fa, fq


def run_cli(argv):
    from snap_rnaseq_tpu_torch.cli import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} returned {rc}:\n{buf.getvalue()}")
    return buf.getvalue()


def golden_phase(tmp, device="cuda"):
    fa, fq = golden_dataset(tmp)
    idx, out = os.path.join(tmp, "gidx"), os.path.join(tmp, "golden.sam")
    run_cli(["index", fa, idx])
    run_cli(["single", idx, fq, "-o", out, "--device", device])
    got = [l for l in open(out).read().splitlines() if not l.startswith("@PG")]
    want = open(os.path.join(ROOT, "tests", "golden",
                             "single_100bp.sam")).read().splitlines()
    if got != want:
        bad = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
        raise AssertionError(f"golden SAM differs on the card ({bad} lines)")
    return len(got)


# ---------------------------------------------------------------- phase 4

def simulate_reads(codes, n, rng):
    """100 bp reads: ~1% substitutions, 15% with a 1-3 base indel, half
    reverse-complemented; returns (true 0-based start, rc, codes)."""
    L = READ_LEN
    G = codes.size
    starts = rng.integers(1000, G - L - 1000, n)
    out = []
    for i, s in enumerate(starts):
        seg = codes[s:s + L + 8].copy()
        n_sub = rng.binomial(L, 0.01)
        if n_sub:
            pos = rng.integers(0, L, n_sub)
            seg[pos] = (seg[pos] + rng.integers(1, 4, n_sub)) % 4
        if rng.random() < 0.15:
            p, m = int(rng.integers(20, L - 20)), int(rng.integers(1, 4))
            seg = (np.delete(seg, np.arange(p, p + m)) if rng.random() < 0.5
                   else np.insert(seg, p, rng.integers(0, 4, m)))
        r = seg[:L].astype(np.uint8)
        rc = bool(rng.random() < 0.5)
        if rc:
            r = (3 - r[::-1]).astype(np.uint8)
        out.append((int(s), rc, r))
    return out


def write_fasta(path, codes, name="ref"):
    from snap_rnaseq_tpu_torch.utils.tables import decode_bases
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        seq = decode_bases(codes)
        for i in range(0, len(seq), 1 << 20):
            f.write(seq[i:i + (1 << 20)])
        f.write(b"\n")


def real_size_phase(tmp, n_bases, n_reads, batch, device="cuda"):
    import torch
    from snap_rnaseq_tpu_torch.ops import kernels as kx
    from snap_rnaseq_tpu_torch.utils.synth_genome import hg_like_genome
    from snap_rnaseq_tpu_torch.utils.tables import decode_bases
    rng = np.random.default_rng(20261016)
    codes = hg_like_genome(n_bases, seed=0)
    fa = os.path.join(tmp, "hg_like.fa")
    write_fasta(fa, codes)
    idx = os.path.join(tmp, "idx")
    t0 = time.time()
    run_cli(["index", fa, idx])
    index_s = time.time() - t0
    log(f"index: {n_bases} bases in {index_s:.3f} s")

    # the id carries the true start; SAM POS is 1-based within the one
    # chromosome, so POS - 1 is directly comparable
    reads = simulate_reads(codes, n_reads, rng)
    fq = os.path.join(tmp, "reads.fq")
    with open(fq, "wb") as f:
        for i, (s, rc, r) in enumerate(reads):
            f.write(b"@r%d_%d_%d\n" % (i, s, rc) + decode_bases(r)
                    + b"\n+\n" + b"I" * READ_LEN + b"\n")
    out = os.path.join(tmp, "out.sam")
    perf = os.path.join(tmp, "perf.tsv")
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kx.reset_launches()                       # zero just before the run
    t0 = time.time()
    stdout = run_cli(["single", idx, fq, "-o", out, "-bs", str(batch),
                      "--device", device, "-pf", perf])
    if cuda:
        torch.cuda.synchronize()
    wall_s = time.time() - t0
    launches = dict(kx.LAUNCHES)              # read just after
    peak = torch.cuda.max_memory_allocated() if cuda else None
    _, total, useful, align_s, *_ = open(perf).read().split("\t")[:5]
    total, align_s = int(total), float(align_s)

    n_al = n_true = 0
    for line in open(out):
        if line.startswith("@"):
            continue
        f = line.split("\t", 4)
        if int(f[1]) & 4:
            continue
        n_al += 1
        _, s, _ = f[0].split("_")
        if abs(int(f[3]) - 1 - int(s)) <= 2 * READ_LEN:
            n_true += 1
    res = dict(reads=total, align_s=align_s, reads_per_s=total / align_s,
               wall_s=wall_s, aligned_share=n_al / total,
               at_origin_share=n_true / total, index_build_s=index_s,
               peak_device_bytes=peak, launches=launches,
               # the pipeline's split of its wall time (utils/stats.py
               # WaitProfile): reader, waits on device results, SAM writing
               wait_profile=next((l for l in stdout.splitlines()
                                  if l.startswith("wait profile")), None))
    res["engine"] = engine_phase(idx, reads, batch)
    if res["at_origin_share"] < 0.8:
        raise AssertionError(f"only {res['at_origin_share']:.3f} of reads "
                             "placed at their origin")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    return res


def engine_phase(idx, reads, batch, n_warm=2, n_timed=4):
    """The engine alone on `reads`: SingleAligner.align_batch_device and
    the grouped fetch per batch, as the pipeline calls them.  After
    n_warm batches, n_timed batches are timed on the host's clock and the
    same n_timed again under torch.profiler, whose device events give the
    busy time (kernels and copies summed) and the operation count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from snap_rnaseq_tpu_torch.index.hash_index import GenomeIndex
    from snap_rnaseq_tpu_torch.models.single import SingleAligner, fetch
    aligner = SingleAligner(GenomeIndex.load(idx), device="cuda")
    codes = np.stack([r for _, _, r in reads])
    quals = np.full((batch, READ_LEN), ord("I"), np.uint8)
    batches = [codes[i * batch:(i + 1) * batch]
               for i in range(n_warm + n_timed)]

    def run(group):
        for b in group:
            fetch(aligner.align_batch_device(torch.from_numpy(b).cuda(),
                                             torch.from_numpy(quals).cuda()))
        torch.cuda.synchronize()

    run(batches[:n_warm])
    t0 = time.time()
    run(batches[n_warm:])
    wall_ms = (time.time() - t0) * 1e3 / n_timed
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(batches[n_warm:])
    busy_us, n_ops = 0.0, 0
    kern_us = dict.fromkeys(("lv_lanes_kernel", "bitpar_packed_kernel"), 0.0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        busy_us += us
        n_ops += 1
        for name in kern_us:
            if name in e.name:
                kern_us[name] += us
    busy_ms = busy_us / 1e3 / n_timed
    if n_ops == 0:
        raise AssertionError("the profiler saw no device operation")
    return dict(batch=batch, wall_ms_per_batch=wall_ms,
                reads_per_s=batch * 1e3 / wall_ms,
                device_busy_ms_per_batch=busy_ms,
                device_idle_share=1.0 - busy_ms / wall_ms,
                device_ops_per_batch=n_ops / n_timed,
                kernel_ms_per_batch={k: v / 1e3 / n_timed
                                     for k, v in kern_us.items()})


# ---------------------------------------------------------------- main

def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this run needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from snap_rnaseq_tpu_torch.ops import kernels as kx

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = smi_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.time()
    kx.build_all()
    log(f"build: {time.time() - t0:.3f} s for {len(kx.SOURCES)} kernels")
    log(f"peaks: {HBM_BYTES_PER_S:.4g} B/s HBM, {int32_ops_per_s():.4g} "
        "int32 op/s")

    rng = np.random.default_rng(7)
    checks = [check_k1(dev, rng), check_k2(dev, rng), check_k3(dev, rng)]
    for c in checks:
        log(f"{c['name']}: {c['rows']} rows, kernel {c['ms']:.4f} ms, plain "
            f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.5f} ms "
            f"({c['bound_by']}), max_abs_err {c['max_abs_err']}")

    with tempfile.TemporaryDirectory() as tmp:
        n = golden_phase(tmp)
        log(f"golden: {n} SAM lines identical on the card")
        res = real_size_phase(tmp, GENOME_BASES, N_BATCHES * BATCH, BATCH)
    log("real size: " + json.dumps(res))

    kernels = []
    for c in checks:
        kernels.append({k: c[k] for k in (
            "name", "route", "source", "replaces")} | dict(
            launches=res["launches"][c["name"]],
            max_abs_err=c["max_abs_err"], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
