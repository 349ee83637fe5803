#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (snap_rnaseq_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one NVIDIA card (sm_90a, e.g. an H100) and the CUDA toolkit; exits
non-zero and prints no result without them.  Every phase raises on
failure; nothing is caught.

1. Build: the hand-written kernels are compiled from csrc/ (one nvcc per
   library, all at once: K2 is 13 libraries, 1-4 pattern words and one per
   word count from 5 to 16); prints the build seconds (each library's
   too), the card's name and power limit, each kernel's registers and
   spills (`-Xptxas -v`) and the SASS instructions per iteration of K2's
   and K4's column loops at W = 3-5 and of the innermost loops of the
   three LV kernels, with tools/sass_loops.py's cycles an iteration (the
   dependent chain, in-order issue, and issue with loads as fast as
   arithmetic); the SASS analysis runs in a process of its own during
   phase 2 and is logged at its end.
2. Kernel checks: K1 (LV-lanes), K2 (packed bitpar, forward and every
   mate-rescue form), K3 (LV-CIGAR), K4 (bitpar over code rows) and K5
   (LV-lanes over per-diagonal mismatch masks) each against its plain PyTorch
   version on the card, on random edit cases that reach the edges
   (clipped texts, random k, pad codes, K1 at the rescue's e_max 17 with
   free 0 / free = read length rows, K3 also at the CIGAR flushes' sizes
   of 1, 2 and 150 rows with rows that fail, K5 at e_max 16 and 17 with
   free prefixes at and beside a mask word's boundary, also bit for bit
   against K1, both timed on the same rows);
   integers must be bit-identical and log-probabilities within rtol/atol
   1e-5.  K2's rescue form is also run and timed at 1-32 chunks per row
   (the split scan), each count giving the same answer.  Reads past 128
   bases: K2 forward, in every flag form and at the mate rescue's window,
   and K4 in each flag form, at P = 150, 250 and 512.  K7 (the cuckoo
   seed phase) against the plain chain on tools/cuckoo_cases.py's layouts
   (every output equal), at 48 positions and at 32 with the first 8 valid.
3. Golden: tests/test_golden.py's and tests/test_golden_paired_rna.py's
   datasets through the port's `index` + `single`, `index` + `paired` and
   `index` + `transcriptome` + RNA `single` CLI on the card must reproduce
   tests/golden/single_100bp.sam, tests/golden/paired_100bp.sam and
   tests/golden/rna_single_100bp.sam (without @PG) byte for byte; the RNA
   one twice, under SNAP_TPU_LV_LANES=bits (K1 launches, K5 does not) and
   =onehot (K5 launches, K1 does not).
4. Real size: `index` on a 64 Mb hg-like genome, built on the card and
   again with --device cpu (every file byte-identical), then on that one
   index
   a. `single -bs 1024` on 16 batches of simulated 100 bp reads
      (substitutions, indels, both strands);
   b. `paired -bs 1024` on 16 batches of 1024 simulated pairs (insert
      200-400, 1% substitutions);
   a', b'. the same two commands on 150 bp reads and pairs from the same
      genome and simulators, 8 batches of 1024 each (no engine-alone
      runs);
   c. RNA: an annotation made from the seed at the human annotation's
      gene density (about 1,300 genes, 4 isoforms each, 3-12 exons of
      80-400 bp), its transcriptome built by `transcriptome` on the card
      and with --device cpu (every file byte-identical), then RNA
      `single -bs 1024` on 16 batches of reads (80% cut from transcripts,
      20% genomic) and RNA `paired -bs 1024` on 16 batches of 1024 pairs
      from transcript fragments of 200-400 bases at the default -tmh
      1000; RNA `single` once more under SNAP_TPU_LV_LANES=onehot, whose
      SAM must equal the default run's.
   d. formats: 4b's pairs through `paired` to `-o p.sam.gz` (its
      decompressed SAM must equal 4b's without @PG), `-so -o p.bam` and
      `-so -o p.sam` (coordinate order; the BAM's decoded records equal
      the sorted SAM's, duplicate flags aside, and both hold 4b's
      records; the .bai exists), 4c's reads through RNA `single -so -o
      r.bam` (4c's records and count files), and p.sam back in as
      `paired`'s interleaved input (each pair's two placements as in
      4b); every output passes the port's validator; K3 must launch in
      the BAM runs, K1 and K2 in each; each run's rate beside 4b's / 4c's.
   e. flat: 1024 of 4a's reads through seed -> budget -> expand ->
      aggregate_phase -> compact_phase -> filtered_score_phase (K4, K1)
      -> replay_phase (path `flat`, its calls recorded); again with the
      substitution fast path off (where both scored, LV never above the
      closed form, below it only off the anchor; the rest within the LV
      budgets' overflow); 64 of them on
      the card and on the CPU (equal); then `trace` through the CLI on 16
      reads (4 with an indel), each result line equal to the engine's at
      the trace's scoring (every slot scored) and its score to the
      default engine's, and on a random read (NotFound).
   f. --hosts: 4b's pairs through parallel/multihost.py run_host in this
      process (N = 1, the workers' per-read route), `paired --hosts 2`
      and `--hosts 4`, 4a's reads through `single --hosts 2`, and `paired
      --hosts 2 -so`, the workers sharing the card (gloo for the stats):
      each merged body equal to the one-process body (if batch cuts
      change records, to a one-process run over the same cuts, with each
      batch's score_overflow printed), the merged stats to one process's,
      the sorted merge in coordinate order with 4d's -so records; every
      worker on the card, K1, K2 and K3 launched in each (its report
      line), the `multihost:` dict with the JAX package's keys; prints
      the launcher's wall s, each host's local_wall_s and peak device
      memory, the rates beside 4a's / 4b's and os.cpu_count().
   g. the probe-chain lookup: DNA single, DNA paired and RNA single on 4
      x 1024 of their reads under SNAP_TPU_LOOKUP=probe (paths
      single_probe, paired_probe, rna_single_probe) and under the cuckoo
      lookup, the SAMs identical but for @PG, K7 launching under the
      cuckoo lookup only; seed_phase alone under each lookup (wall and
      device-busy ms per batch; K7's by CUDA events), the longest probe
      chain and the stragglers per batch, peak memory.
   h. tools/distance_hist.py on 4a's SAM on the card (path
      distance_hist: K1 at e_max 31 without qualities) and on the CPU,
      the histograms identical.
   i. mesh: parallel/sharded.py with every coordinate on the card, on the
      same index.  ShardedSingleAligner on meshes (1, 2), (1, 4) and
      (2, 2) over 4 x 1024 of 4a's reads (paths mesh_single_<shape>) and
      ShardedPairedAligner on (1, 4) over 4 x 1024 of 4b's pairs (path
      mesh_paired), each batch held to the single-card engine: a row may
      differ only where an engine reports score_overflow or a truncated
      candidate list (printed per batch); K2 forward launches once per
      coordinate, end and batch, K1 at least as often.  One (2, 2) batch
      under SNAP_TPU_LOOKUP=probe gives the cuckoo run's results and the
      single-card engine's found seeds under that lookup.
      PairedEndPipeline with the (1, 4) mesh over all of 4b's pairs (path
      mesh_paired_sam; K3 must launch): its SAM equals 4b's but for pairs
      whose engine results differ as above.  RnaSingleEndPipeline with
      (2, 2) meshes for genome and transcriptome over 4 x 1024 of 4c's
      reads (path mesh_rna_single): SAM (without @PG) equal to the stock
      pipeline's but for reads whose genome or transcriptome results
      differ as above, count files equal where the SAMs are (else their
      unlike lines printed).  64 reads and 64 pairs through the (2, 2)
      mesh on the card and on the CPU: equal.  Prints partition_index
      seconds and bytes per index and n_index, launches and peak device
      bytes per mesh, wall and device-busy ms per batch, each mesh beside
      the single-card engine, and the seconds of each step.
   j. big locations: the index lifted to offsets A (its
      middle at 2^31), B (2,200,000,000) and C (the top: genome size +
      overflow length 1 MiB below the dead marker 0xFFFFFFF0) as
      tests/test_big_locations.py lifts it (codes, hash values, overflow
      locations and packed words; at A the cuckoo layout and the packed
      words are also built by the real functions and held to the lifted
      ones).  At each offset SingleAligner and PairedAligner on 4 x 1024
      of 4a's reads and 4b's pairs: every output field equal to the
      unlifted engines', loc + BASE (mod 2^32); wall and busy ms per
      batch beside the unlifted engines'; paths single_big and paired_big
      at C.  At A and B: 4b's pairs through PairedEndPipeline (the bulk
      route) to plain SAM and -so SAM, byte-identical to 4b's and 4d's;
      -so BAM (the per-read route) must raise struct.error, the shared
      fault of ROADMAP.md section 3; DNA single and RNA single (lifted
      genome, unlifted transcriptome; path rna_big at B) on 4 x 1024 of
      4a's and 4c's reads, where a record may differ from the unlifted
      run's only for a read its genome engine placed past 2^31 (counted).
      At B the card against the CPU on 64 reads and pairs, and a (1, 2)
      mesh on 2 x 1024 reads against the single-card engine (path
      mesh_single_big).  Prints the lift, layout, pack and aligner-build
      seconds, the host and packed genome bytes and the peak device bytes.
   k. human size (tools/hg_scale.py, after 4j): the 3,200,012,492-base,
      24-piece genome of the JAX package's tools/hg_scale_build.py made
      by worker processes (on a thread from phase 2 on, beside the card's
      checks), its seed-20 index built on the card straight
      into 8 slices (total_slots, occupied_slots, overflow_entries,
      ht_bytes and overflow_bytes must equal HG_SCALE.json's), the lookup
      check on 20,000 sampled positions (each among its seed's hits, the
      lists descending; the seeds past the engine's 64-probe cap
      counted), then 100,000 wgsim pairs in batches of 256 through
      ShardedPairedAligner on a (1, 8) mesh on the card (path `hg`;
      recall0 and recall1 >= 0.97, pair_found_rate >= 0.99), its
      statistics beside HG_ALIGN.json's with the counts more than 0.5%
      apart listed, one batch's wall and busy ms, the peak device bytes
      (under the card's memory) and the peak host RSS.
   l. the bench tools (after 4j, before 4k), on phase 4's index, which is
      bench.py's index exactly: tools/bench.py (3 batches of 1,024 wgsim
      pairs, PairedAligner(cand_per_read=64), 3 windows of 10 batches and
      one profiled window; the single-end engine on the
      paired aligner's device copy of the index; the batches as FASTQ to
      SAM through PairedEndPipeline, its SAM validated, one record a read),
      paths bench_pe, bench_se, bench_sam (K3 as well); pairs found and single-end
      reads aligned >= 0.95; tools/engine_ab.py all, 2 windows a
      configuration (paths ab_norescue,
      ab_onehot: K5 and both K2 forms launch and K1 does not, ab_b2048,
      ab_cand128; `onehot` finds the pairs `default` finds);
      tools/phase_profile.py at cand 128 and 64, 4 calls a phase (its flat
      phases as paths profile_flat and profile_flat64: K4 and K1);
      tools/op_profile.py
      on 4 batches (its categories sum to its total).
   The launch counters are zeroed just before each run and read just
   after; each kernel of that path must have launched.  Prints the rate,
   the aligned share, the share placed at the true origin (checked), the
   index-build seconds, peak device memory and the pipeline's wait
   profile (RNA: also the share of records with an N, the transcriptome
   build seconds).  Then each DNA engine alone on the same index and
   reads (SingleAligner / PairedAligner.align_batch_device + the fetch):
   wall ms per batch, and under torch.profiler the device's busy ms, its
   idle share, device operations and the hand-written kernels' ms per
   batch; for pairs also the pair-found share and the rescued ends.
5. stringz: the port's tools/stringz at its defaults (-P 100) and at
   -P 150 on the card; K4 must have launched in each.
6. Path shapes: during each main path's run (4a, 4b, 4c, 4e's `flat`,
   4g's probe runs, 4h's `distance_hist`, 4i's mesh paths, 4j's `*_big`
   paths, 4k's `hg`, 4l's bench tool paths, 5) every
   call of a kernel wrapper is counted by its argument shapes,
   and the first call of each shape is recorded with a copy of its
   inputs.  Each recorded
   call is re-run on those inputs against the plain version (same
   tolerances) and both are timed with CUDA events (the kernel over 20
   calls, the plain version over the one call checked); the bound is computed
   from the same inputs.  K3's levels per row are printed per path; K3 is
   re-timed at the single path's calls with 1, 2, 4 and 8 warps per block
   forced; K5's calls on RNA single under onehot are re-run by K5 and by
   K1 on the same inputs, timed in turns.
7. Prints the kernels line: per kernel, `by_path` holds every path that
   launched it (launches, device and bound ms per launch weighted by
   launches, lost ms = launches x (device - bound), its shapes), and the
   top-level fields are taken at the path where it loses the most; K7's
   entry instead holds its launches by path and, in `cells`, its runs at
   the 64 Mb cells' batches on 4a's index (131,072 reads, 48 positions;
   32 positions, first 8 valid: every output equal to the plain chain's,
   device and bound ms, plain ms); then the card line, and last the
   result line.
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
LONG_READ_LEN = 150                # phase 4's second DNA pair of runs
N_BATCHES_LONG = 8
LONG_P = (150, 250, 512)           # phase 2's reads past four words
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


def timed_once(fn):
    """(milliseconds, result) of one call on the card (CUDA events)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def device_ms(fn, reps):
    """Mean device milliseconds per call, the host's issue hidden: a spin
    kernel (torch.cuda._sleep) holds the stream while the host queues all
    `reps` calls behind it, so the CUDA events time the calls back to
    back on the device (each call's own small kernels included).  The
    spin doubles until the host has finished queueing before it ends; a
    call that waits on the device (a host copy, a pageable upload) never
    does, and raises."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin_s = 2 * reps * issue_s + 1e-3
    while True:
        torch.cuda._sleep(int(spin_s * sm_clock_hz()))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_in_time = not start.query()    # the spin still running
        torch.cuda.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / reps
        spin_s *= 2
        if spin_s > 30:
            raise AssertionError("device_ms: the call waits on the device "
                                 "while it is queued")


@functools.lru_cache(None)
def sm_clock_hz():
    """The card's maximum SM clock (nvidia-smi, MHz) in Hz."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0]) * 1e6


@functools.lru_cache(None)
def int32_ops_per_s():
    """Peak 32-bit integer/logic issue rate: SMs x INT32 lanes per SM x
    the card's maximum SM clock."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * sm_clock_hz()


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
    """K1 on edge cases at the single path's width: P = 100, T = 116,
    e_max = 16, random k and free prefixes, clipped text windows, f32
    quality rows."""
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
    return dict(name="K1_lv_lanes", rows=B, max_abs_err=err,
                found=int((want.distance >= 0).sum()))


def check_k2(dev, rng):
    """K2's forward form on edge cases at the single path's width: P =
    100, TXT = 116, packed_off = 16, 18 packed words per row, pad codes."""
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
    return dict(name="K2_bitpar_packed", rows=B, max_abs_err=0.0,
                within_e_max=int((want <= 16).sum()))


def check_k6(dev, rng):
    """K6 on 8,192 reads x 64 slots at the single path's width (P = 100,
    e_max 16): reads cut from a random 1 Mb genome with 3% substitutions,
    half of them reverse complemented; half of each row's slots at the
    read's origin in its orientation, the rest anywhere up to 600 bases
    past the table in either, a fifth dead."""
    import torch
    from snap_rnaseq_tpu_torch.models.single import _COMP_LUT
    from snap_rnaseq_tpu_torch.ops import rowwise_front as rf
    from snap_rnaseq_tpu_torch.ops import u32
    from snap_rnaseq_tpu_torch.ops.genome_gather import pack_genome_4bit
    R, W, P, M, n = 8192, 64, READ_LEN, 16, 1_000_000
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    origin = rng.integers(0, n - P, R)
    reads = codes[origin[:, None] + np.arange(P)]
    sub = rng.random((R, P)) < 0.03
    reads[sub] = (reads[sub] + 1) % 4
    rc = rng.random(R) < 0.5
    reads[rc] = _COMP_LUT[reads[rc, ::-1]]
    loc = rng.integers(0, n + 600, (R, W)).astype(np.int32)
    loc[:, :W // 2] = origin[:, None]
    dirs = rng.integers(0, 2, (R, W)).astype(np.int32)
    dirs[:, :W // 2] = rc[:, None]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    args = (u32.from_numpy(pack_genome_4bit(codes), dev), to(loc), to(dirs),
            to(rng.random((R, W)) >= 0.2), to(reads), to(_COMP_LUT),
            to(-rng.uniform(0, 5, (R, 2, P)).astype(np.float32)))
    got = rf.rowwise_front_cuda(*args, M=M, big=False)
    want = rf.rowwise_front_plain(*args, M=M, big=False)
    for name, g, w in zip(("K6 win_words", "K6 sel", "K6 ham"), got, want):
        assert_same(name, g, w)
    ok = want[2] <= M
    return dict(name="K6_rowwise_front", rows=R * W,
                max_abs_err=logp_err("K6_rowwise_front", got[3][ok],
                                     want[3][ok]),
                within_e_max=int(ok.sum()))


def same_seeds(what, got, want):
    """K7's outputs against the plain chain's: the same keys, each equal."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: outputs {sorted(got)} against "
                             f"{sorted(want)}")
    for k, w in want.items():
        assert_same(f"{what} {k}", got[k], w)


def check_k7(dev, rng):
    """K7 on 16,384 reads over a tools/cuckoo_cases.py layout (h1 and h2
    buckets, the stash with repeated keys, absent keys, reads with N), at
    48 positions and at 32 positions with the first 8 valid."""
    from snap_rnaseq_tpu_torch.models.single import seed_phase_plain
    from snap_rnaseq_tpu_torch.ops import lookup as lk
    from snap_rnaseq_tpu_torch.ops import u32
    from snap_rnaseq_tpu_torch.tools import cuckoo_cases as cc
    import torch
    B = 16_384
    for S, N in ((48, 0), (32, 8)):
        case = cc.seed_case(rng, B, READ_LEN, 20, S, past_end=True,
                            wild=True)
        tables = {k: u32.from_numpy(case[k], dev)
                  for k in ("ck_buckets", "ck_buckets2", "ck_stash")}
        args = (torch.from_numpy(case["reads"]).to(dev),
                tuple(int(p) for p in case["positions"]), 20,
                torch.from_numpy(case["overflow"]).to(dev),
                case["genome_size"], tables, N)
        pos_t = torch.from_numpy(case["positions"].astype(np.int32)).to(dev)
        same_seeds("K7", lk.seed_lookup_cuda(args[0], pos_t, 20, tables,
                                             args[3], args[4], N),
                   seed_phase_plain(*args))
    return dict(name="K7_seed_lookup (48 positions; 32, first 8 valid)",
                rows=2 * B, max_abs_err=0.0, placed=case["placed"])


def k7_cells(aligner, genome):
    """K7 at the 64 Mb cells' batches on the aligner's index: 131,072
    reads of 100 bases cut from `genome` (1% substitutions, half reverse
    complemented), the single cell's 48 positions and the pairs cell's 32
    with the first 8 valid.  Every output equal to the plain chain's; K7
    timed on the device (CUDA events behind a spin kernel, 20 calls), the
    plain chain once.  Bound by bytes: the reads once, one 128-byte
    bucket row a valid seed looked up and a second where it was not
    found (a seed found in its h2 row counts one), an overflow count a
    half that reads one, and the outputs (26 bytes a column, sel_pos 4)."""
    import torch
    from snap_rnaseq_tpu_torch.models.single import seed_phase_plain
    from snap_rnaseq_tpu_torch.ops import lookup as lk
    from snap_rnaseq_tpu_torch.utils.seed_sequencer import (
        seed_position_schedule)
    B, L, seed_len = 131_072, READ_LEN, aligner.index.seed_len
    rng = np.random.default_rng(20261019)
    start = rng.integers(0, genome.size - L, B)
    reads = genome[start[:, None] + np.arange(L)]
    sub = rng.random((B, L)) < 0.01
    reads[sub] = (reads[sub] + 1) % 4
    rc = rng.random(B) < 0.5
    reads[rc] = np.where(reads[rc, ::-1] < 4, 3 - reads[rc, ::-1],
                         reads[rc, ::-1])
    reads_t = torch.from_numpy(reads).cuda()
    positions = seed_position_schedule(L, seed_len)[0]
    st, gsize = aligner.state, aligner.genome_size
    out = []
    for S, N in ((48, 0), (32, 8)):
        pos = tuple(int(p) for p in positions[:S])
        k7 = functools.partial(lk.seed_lookup_cuda, reads_t,
                               torch.tensor(pos, dtype=torch.int32).cuda(),
                               seed_len, st, st["overflow"], gsize, N)
        plain_ms, want = timed_once(functools.partial(
            seed_phase_plain, reads_t, pos, seed_len, st["overflow"], gsize,
            st, N))
        same_seeds(f"K7 {B} x {S} -> {N or S}", k7(), want)
        dev_ms = device_ms(k7, 20)
        valid, found = want["valid"], want["found"]
        n_valid = int(valid.sum())
        n_bytes = (B * L + 128 * (n_valid + int((valid & ~found).sum()))
                   + 4 * int((want["bases"] >= 0).sum())
                   + B * (N or S) * 26 + 4 * B * N)
        b_ms, b_by = bound(n_bytes, 0)
        out.append(dict(shape=[B, S, N], device_ms=dev_ms, bound_ms=b_ms,
                        bound_by=b_by, plain_ms=plain_ms,
                        valid_share=n_valid / valid.numel(),
                        found_share=int(found.sum()) / max(n_valid, 1),
                        max_abs_err=0.0))
        log(f"K7 at the cells' {[B, S, N]}: {dev_ms:.4f} ms on the device, "
            f"bound {b_ms:.5f} ms ({b_by}), plain {plain_ms:.3f} ms; every "
            "output equal")
    return out


K3_SCRIPT = ("distance", "e_final", "d_final", "net_indel", "acts",
             "matched", "start_run")


def check_k3(dev, rng):
    """K3 at the CIGAR paths' width (io/sam.py, io/bulk.py): pattern and
    text rows of the read length, texts no longer than their reads, e_max
    = 31, k = 30, the CIGAR diagonal order; without the L/A tables, then
    once more with tables=True.  Then at a flush's sizes, 1, 2 and 150
    rows (tools/cigar_cases.py cigar_rows: short indels, a path right
    of the centre diagonal and back, 10-30 edits, and rows that fail after
    all 30 levels)."""
    import torch
    from snap_rnaseq_tpu_torch.ops import lv
    from snap_rnaseq_tpu_torch.ops.lv_cuda import lv_cigar
    from snap_rnaseq_tpu_torch.tools.cigar_cases import cigar_rows
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
    for f in K3_SCRIPT:
        assert_same(f"K3 {f}", getattr(got, f), getattr(want, f))
    err = logp_err("K3", got.log_prob, want.log_prob)
    full = lv_cigar(*args, None, e_max=E, tables=True)
    for f in ("L", "A", "acts", "matched", "start_run"):
        assert_same(f"K3 tables {f}", getattr(full, f), getattr(want, f))
    indel_rows, failed = int((want.net_indel != 0).sum()), 0
    for n in (1, 2, 150):
        c_args = [to(a) for a in cigar_rows(rng, n)]
        c_args.append(to(np.full(n, E - 1, np.int32)))
        want = lv._lv_distance_plain(*c_args, None, None, e_max=E,
                                     cigar_order=True, keep_tables=True)
        got = lv_cigar(*c_args, None, e_max=E)
        for f in K3_SCRIPT:
            assert_same(f"K3 {n} rows {f}", getattr(got, f),
                        getattr(want, f))
        err = max(err, logp_err(f"K3 {n} rows", got.log_prob,
                                want.log_prob))
        failed += int((want.distance < 0).sum())
    return dict(name="K3_lv_cigar (10,240, then 1, 2, 150 rows)",
                rows=B + 153, max_abs_err=err, indel_rows=indel_rows,
                failing_rows=failed)


def check_k1_rescue(dev, rng):
    """K1 at the mate rescue's call (score_phase with seed_len = 0): 1024
    reads, so 2048 rows, P = 100, T = 117, e_max = 17; the forward rows
    have free prefix 0 and the reversed-head rows free = P (distance 0,
    log-probability 0)."""
    import torch
    from snap_rnaseq_tpu_torch.ops import lv
    from snap_rnaseq_tpu_torch.ops.lv_cuda import lv_lanes
    C, P, E = 1024, READ_LEN, 17
    B, T = 2 * C, P + E
    pats, texts, t_len = edit_cases(rng, B, P, T, E + 2)
    free = np.repeat(np.array([0, P], np.int32), C)
    quals = rng.integers(35, 74, (B, P)).astype(np.uint8)
    to = lambda a: torch.from_numpy(a).to(dev)
    args = (to(pats), to(np.full(B, P, np.int32)), to(texts), to(t_len),
            to(np.full(B, E, np.int32)), lv.phred_log_prob_device(to(quals)))
    fr = to(free)
    got = lv_lanes(*args, fr, e_max=E)
    want = lv._lv_distance_plain(*args, fr, e_max=E)
    for f in ("distance", "e_final", "d_final", "net_indel"):
        assert_same(f"K1 rescue {f}", getattr(got, f), getattr(want, f))
    err = logp_err("K1 rescue", got.log_prob, want.log_prob)
    head = want.distance[C:]
    if bool((head != 0).any()) or bool((want.log_prob[C:] != 0).any()):
        raise AssertionError("K1 rescue: free = P rows are not 0 / 0")
    return dict(name="K1_lv_lanes (rescue, e_max 17)", rows=B,
                max_abs_err=err, found=int((want.distance[:C] >= 0).sum()))


def bitpar_ops(B, TXT, P):
    """32-bit instructions the bit-parallel scan needs at the least: per
    pattern word and text column the recurrence's boolean functions as
    three-input LOP3s, the carried add and two funnel shifts (10), per
    column ~4 more for the score, plus the Peq build."""
    W = (P + 31) // 32
    return float(B) * TXT * (W * 10 + 4) + B * P * W


def packed_cases(rng, B, P, TXT, off, reverse, free_start):
    """Packed window rows with an edited copy of the pattern planted in
    half of them (where a global start can reach it)."""
    from snap_rnaseq_tpu_torch.ops.genome_gather import pack_genome_4bit
    NW = (off + TXT + 7) // 8 + 1
    codes = rng.integers(0, 4, (B, NW * 8), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.002] = 5
    pats = rng.integers(0, 4, (B, P), dtype=np.uint8)
    pats[rng.random((B, P)) < 0.005] = 4
    seg = pats % 4
    flip = rng.random(seg.shape) < 0.04
    seg[flip] = (seg[flip] + 1) % 4
    if reverse:
        seg = seg[:, ::-1]
    for i in range(0, B, 2):
        s = (off + int(rng.integers(0, TXT - P)) if free_start
             else off + TXT - P if reverse else off)
        codes[i, s:s + P] = seg[i]
    words = pack_genome_4bit(codes.reshape(-1))[:B * NW].reshape(B, NW)
    return pats, words


def k2_form(dev, rng, B, P, TXT, off, reverse, free_start, track_pos):
    """K2 in one flag form on packed_cases rows against the plain version
    on the scanned columns; returns the plain version's answer."""
    import torch
    from snap_rnaseq_tpu_torch.ops import bitpar, u32
    to = lambda a: torch.from_numpy(a).to(dev)
    pats, words = packed_cases(rng, B, P, TXT, off, reverse, free_start)
    pat, w = to(pats), u32.from_numpy(words, dev)
    tl = to(np.full(B, TXT, np.int32))
    flags = dict(track_pos=track_pos, free_start=free_start)
    got = bitpar.bitpar_packed(pat, w, tl, P=P, TXT=TXT, packed_off=off,
                               reverse=reverse, **flags)
    text = bitpar.unpack_words(w)[:, off:off + TXT]
    want = bitpar.bitpar_distance_plain(
        pat, text.flip(1) if reverse else text, tl, P=P, **flags)
    assert_same(f"K2 P={P} form r={reverse} f={free_start} t={track_pos}",
                got, want)
    return want


def check_k2_rescue(dev, rng):
    """K2 in every flag form: the seven others at a small size, then the
    mate-rescue form at the rescue's shape: 1024 pairs x 2 mate candidates
    x 2 windows = 4096 rows per end, P = 100, TXT = WLEN = 1,084 at the
    paired defaults, packed_off 0, reverse + free_start + track_pos."""
    import torch
    from snap_rnaseq_tpu_torch.ops import bitpar, u32
    scan_chunks = bitpar.scan_chunks
    to = lambda a: torch.from_numpy(a).to(dev)
    for r in (False, True):
        for f in (False, True):
            for t in (False, True):
                if (r, f, t) != (True, True, True):
                    k2_form(dev, rng, 2048, 37, 300, 5, r, f, t)
    B, TXT = 4096, 1084
    want = k2_form(dev, rng, B, READ_LEN, TXT, 0, True, True, True)
    # the split scan's chunk count at the rescue's shape, forced in place
    # of scan_chunks' choice: each count gives the same answer; device
    # time per launch
    chosen = bitpar.scan_chunks(B, READ_LEN, TXT, True)
    pats, words = packed_cases(rng, B, READ_LEN, TXT, 0, True, True)
    pat, w = to(pats), u32.from_numpy(words, dev)
    tl = to(np.full(B, TXT, np.int32))
    kw = dict(P=READ_LEN, TXT=TXT, packed_off=0, reverse=True,
              free_start=True, track_pos=True)
    ref = bitpar.bitpar_packed(pat, w, tl, **kw)
    sweep = {}
    try:
        for n in (1, 2, 4, 8, 16, 32):
            bitpar.scan_chunks = (
                lambda *_, n=n: (-(-TXT // n), 2 * READ_LEN, n))
            assert_same(f"K2 rescue, {n} chunks",
                        bitpar.bitpar_packed(pat, w, tl, **kw), ref)
            sweep[n] = device_ms(
                lambda: bitpar.bitpar_packed(pat, w, tl, **kw), 20)
    finally:
        bitpar.scan_chunks = scan_chunks
    log(f"K2 rescue, {B} x {READ_LEN} x {TXT}, device ms by chunk count: "
        + json.dumps(sweep) + f"; scan_chunks chooses (chunk_len, warm, "
        f"n_chunks) = {chosen}")
    return dict(name="K2_bitpar_rescue", rows=B, max_abs_err=0.0,
                within_e_max=int(((want >> 12) <= 17).sum()))


def check_k4(dev, rng, P=READ_LEN):
    """K4 at the stringz tool's width: 16,384 rows, P = 100 (or the given
    read length), TXT = P + 31 u8 code rows, codes >= 4, the padding byte
    255 and t_len < TXT included; the plain (global-start) form the tool
    runs, then free_start and track_pos."""
    import torch
    from snap_rnaseq_tpu_torch.ops import bitpar
    B, TXT = 16_384, P + 31
    pats, texts, _ = edit_cases(rng, B, P, TXT, 6)
    texts[rng.random((B, TXT)) < 0.005] = 4
    texts[:256, TXT - 8:] = 255
    to = lambda a: torch.from_numpy(a).to(dev)
    pat, txt = to(pats), to(texts)
    tl = to(rng.integers(P, TXT + 1, B).astype(np.int32))
    for flags in (dict(), dict(free_start=True),
                  dict(track_pos=True, free_start=True)):
        got = bitpar.bitpar_rows(pat, txt, tl, P=P, **flags)
        want = bitpar.bitpar_distance_plain(pat, txt, tl, P=P, **flags)
        assert_same(f"K4 P={P} {flags}", got, want)
    want = bitpar.bitpar_distance_plain(pat, txt, tl, P=P)
    return dict(name="K4_bitpar_rows", rows=B, max_abs_err=0.0,
                within_6=int((want <= 6).sum()))


def check_long_reads(dev, rng):
    """Reads past four pattern words (P = 150, 250, 512: W = 5, 8, 16): K2
    forward at the prefilter's TXT = P + 16 (32,768 rows, packed_off 16,
    pad codes), K2 in every flag form (2,048 rows, TXT = P + 200), K2's
    mate-rescue form over the default window WLEN = 950 + P + 34 (4,096
    rows), and K4 in each of its forms at stringz's width; each against
    its plain version."""
    rows = 0
    for P in LONG_P:
        for r in (False, True):
            for f in (False, True):
                for t in (False, True):
                    k2_form(dev, rng, 2048, P, P + 200, 5, r, f, t)
        k2_form(dev, rng, 32_768, P, P + 16, 16, False, False, False)
        k2_form(dev, rng, 4096, P, 950 + P + 34, 0, True, True, True)
        check_k4(dev, rng, P)
        rows += 8 * 2048 + 32_768 + 4096 + 16_384
    return dict(name=f"K2 (every form) and K4 at P = {LONG_P}", rows=rows,
                max_abs_err=0.0)


def check_k5(dev, rng):
    """K5 on edge cases at the RNA paths' widths: P = 100, T = P + e_max
    at e_max 16 (single) and 17 (paired), random k, clipped text windows,
    a third of the rows with a free prefix (up to the whole read; an
    eighth at 31, 32, 33 or P, a mask word's boundary and either side),
    f32 quality rows; against the plain version and, bit for bit (log
    probabilities included), against K1 on the same rows."""
    import torch
    from snap_rnaseq_tpu_torch.ops import lv
    from snap_rnaseq_tpu_torch.ops.lv_cuda import lv_lanes, lv_lanes_onehot
    B, P = 40_960, READ_LEN
    to = lambda a: torch.from_numpy(a).to(dev)
    err, found = 0.0, 0
    for E in (16, 17):
        T = P + E
        pats, texts, t_len = edit_cases(rng, B, P, T, E + 2)
        short = rng.random(B) < 0.05
        t_len[short] = rng.integers(P - E, T, int(short.sum()))
        k = np.where(rng.random(B) < 0.9, E,
                     rng.integers(0, E + 1, B)).astype(np.int32)
        free = np.where(rng.random(B) < 0.33, rng.integers(0, P + 1, B),
                        0).astype(np.int32)
        # a mask word's boundary, either side of it, the whole read
        free[:B // 8] = np.resize(np.array([31, 32, 33, P], np.int32),
                                  B // 8)
        quals = rng.integers(35, 74, (B, P)).astype(np.uint8)
        args = (to(pats), to(np.full(B, P, np.int32)), to(texts), to(t_len),
                to(k), lv.phred_log_prob_device(to(quals)), to(free))
        got = lv_lanes_onehot(*args, e_max=E)
        want = lv._lv_distance_plain(*args, e_max=E)
        k1 = lv_lanes(*args, e_max=E)
        ints = ("distance", "e_final", "d_final", "net_indel")
        for f in ints:
            assert_same(f"K5 e_max {E} {f}", getattr(got, f),
                        getattr(want, f))
        for f in ints + ("log_prob",):
            assert_same(f"K5 vs K1 e_max {E} {f}", getattr(got, f),
                        getattr(k1, f))
        err = max(err, logp_err(f"K5 e_max {E}", got.log_prob,
                                want.log_prob))
        found += int((want.distance >= 0).sum())
        # the two LV-lanes kernels on the same rows, device time
        k5_ms = device_ms(lambda: lv_lanes_onehot(*args, e_max=E), 10)
        k1_ms = device_ms(lambda: lv_lanes(*args, e_max=E), 10)
        log(f"K5 vs K1, {B} rows, e_max {E}: {k5_ms:.4f} and {k1_ms:.4f} "
            "ms on the device")
    return dict(name="K5_lv_onehot (e_max 16 and 17, = plain and K1)",
                rows=2 * B, max_abs_err=err, found=found)


# ---------------------------------------------------------------- path calls

# the kernel wrappers, by the module attribute their callers look up; at
# most this many call shapes are recorded per run (a path makes under 30)
MAX_RECORDED_SHAPES = 64
WRAPPERS = (("lv_cuda", "lv_lanes"), ("lv_cuda", "lv_cigar"),
            ("bitpar", "bitpar_packed"), ("bitpar", "bitpar_rows"),
            ("lv_cuda", "lv_lanes_onehot"),
            ("rowwise_front", "rowwise_front_cuda"))
KERNEL_INFO = {   # name: (source, the TPU kernel it replaces)
    "K1_lv_lanes": ("snap_rnaseq_tpu_torch/csrc/lv_lanes.cu",
                    "snap_rnaseq_tpu/ops/lv_pallas.py:374"),
    "K2_bitpar_packed": ("snap_rnaseq_tpu_torch/csrc/bitpar_packed.cu",
                         "snap_rnaseq_tpu/ops/bitpar.py:69"),
    "K2_bitpar_rescue": ("snap_rnaseq_tpu_torch/csrc/bitpar_packed.cu",
                         "snap_rnaseq_tpu/ops/bitpar.py:69"),
    "K3_lv_cigar": ("snap_rnaseq_tpu_torch/csrc/lv_cigar.cu",
                    "snap_rnaseq_tpu/ops/lv_pallas.py:90"),
    "K4_bitpar_rows": ("snap_rnaseq_tpu_torch/csrc/bitpar_rows.cu",
                       "snap_rnaseq_tpu/ops/bitpar.py:69 (unpacked, call "
                       ":179)"),
    "K5_lv_onehot": ("snap_rnaseq_tpu_torch/csrc/lv_onehot.cu",
                     "snap_rnaseq_tpu/ops/lv_pallas.py:567"),
    "K6_rowwise_front": ("snap_rnaseq_tpu_torch/csrc/rowwise_front.cu",
                         "none: the front of snap_rnaseq_tpu/models/"
                         "single.py rowwise_score_phase, fused by XLA"),
}


def kernel_of_call(attr, a):
    if attr == "bitpar_packed":
        rescue = a["reverse"] or a["free_start"] or a["track_pos"]
        return "K2_bitpar_rescue" if rescue else "K2_bitpar_packed"
    return {"lv_lanes": "K1_lv_lanes", "lv_cigar": "K3_lv_cigar",
            "bitpar_rows": "K4_bitpar_rows",
            "lv_lanes_onehot": "K5_lv_onehot",
            "rowwise_front_cuda": "K6_rowwise_front"}[attr]


def host_copy(t):
    import torch
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t, non_blocking=True)


@contextlib.contextmanager
def recorded_calls():
    """Wraps the kernel wrappers for one run of a main path.  The first
    call of each distinct argument shape is recorded with a copy of its
    inputs, and every call is counted under its shape.  Yields {key:
    {"kernel", "fn", "args", "n"}}; the wrappers' own launch counters are
    untouched.  The copies go to pinned host memory in stream order, so
    the run neither waits for them nor counts them in its peak device
    memory; check_path_calls moves them back to the card.  A genome that
    K6 reads (up to 2.1 GB of words) is held as it is during the run and
    copied to the host once when it ends, however many shapes read it."""
    import inspect
    import threading
    import torch
    from snap_rnaseq_tpu_torch.ops import bitpar, lv_cuda, rowwise_front
    mods = dict(lv_cuda=lv_cuda, bitpar=bitpar, rowwise_front=rowwise_front)
    calls, saved, lock = {}, [], threading.Lock()

    def wrap(mod, attr):
        fn = getattr(mod, attr)
        sig = inspect.signature(fn)

        def shim(*args, **kw):
            b = sig.bind(*args, **kw)
            b.apply_defaults()
            a = b.arguments
            key = (attr,) + tuple(
                (k, (tuple(v.shape), str(v.dtype))
                 if isinstance(v, torch.Tensor) else v) for k, v in a.items())
            with lock:
                rec = calls.get(key)
                if rec is None and len(calls) < MAX_RECORDED_SHAPES:
                    rec = calls[key] = dict(
                        kernel=kernel_of_call(attr, a), fn=fn, n=0,
                        args={k: v if k == "genome_p4" else host_copy(v)
                              if isinstance(v, torch.Tensor) else v
                              for k, v in a.items()})
                if rec is not None:
                    rec["n"] += 1
            return fn(*args, **kw)
        setattr(mod, attr, shim)
        saved.append((mod, attr, fn))

    for m, attr in WRAPPERS:
        wrap(mods[m], attr)
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
        genomes = {}
        for rec in calls.values():
            g = rec["args"].get("genome_p4")
            if g is not None:
                key = (g.data_ptr(), g.numel())
                if key not in genomes:
                    genomes[key] = g.cpu()
                rec["args"]["genome_p4"] = genomes[key]


def lv_levels(want, k, e_max):
    """The DP levels each LV row ran: to its winning level (0 for the
    level-0 early-out), or to k (at least 1) when none won."""
    dist = want.distance.cpu().numpy()
    k = k.cpu().numpy()
    return np.where(dist >= 0, want.e_final.cpu().numpy(),
                    np.maximum(np.minimum(k, e_max), 1))


def _plain_and_work(kernel, a):
    """The plain version of one recorded call, its comparison with the
    kernel's result, and the work this call's data needs: (plain fn,
    compare(got, want) -> max_abs_err, (bytes, operations)(want))."""
    from snap_rnaseq_tpu_torch.ops import bitpar, lv
    if kernel == "K6_rowwise_front":
        return _front_plain_and_work(a)
    B, P = a["pattern"].shape
    if kernel in ("K1_lv_lanes", "K3_lv_cigar", "K5_lv_onehot"):
        cigar = kernel == "K3_lv_cigar"
        E, T = a["e_max"], a["text"].shape[1]
        q = a["quality"]
        plain = functools.partial(
            lv._lv_distance_plain, a["pattern"], a["p_len"], a["text"],
            a["t_len"], a["k"], q, None if cigar else a["free"], e_max=E,
            cigar_order=a["cigar_order"], keep_tables=cigar)
        fields = ("distance", "e_final", "d_final", "net_indel") + (
            ("acts", "matched", "start_run") if cigar else ())

        def compare(got, want):
            for f in fields:
                assert_same(f"{kernel} {f}", getattr(got, f),
                            getattr(want, f))
            return logp_err(kernel, got.log_prob, want.log_prob)

        def work(want):
            # the DP levels each row ran; inputs once (pattern, text,
            # quality rows, i32 vectors), outputs once (five scalars; K3
            # also the start run and the (acts, matched) script)
            levels = lv_levels(want, a["k"], E)
            q_bytes = 0 if q is None else q.element_size() * P
            n_vec = 3 + (not cigar and a["free"] is not None)
            out = 24 + 8 * E if cigar else 20
            return B * (P + T + q_bytes + 4 * n_vec + out), lv_ops(levels, P)
        return plain, compare, work

    flags = dict(track_pos=a["track_pos"], free_start=a["free_start"])
    if kernel == "K4_bitpar_rows":
        TXT = a["text"].shape[1]
        plain = functools.partial(bitpar.bitpar_distance_plain, a["pattern"],
                                  a["text"], a["t_len"], P=P, **flags)
        in_bytes = B * (P + TXT + 4)
    else:
        TXT, off, NW = a["TXT"], a["packed_off"], a["words"].shape[1]

        def plain():
            text = bitpar.unpack_words(a["words"])[:, off:off + TXT]
            return bitpar.bitpar_distance_plain(
                a["pattern"], text.flip(1) if a["reverse"] else text,
                a["t_len"], P=P, **flags)
        in_bytes = B * (P + 4 * NW + 4)

    def compare(got, want):
        assert_same(kernel, got, want)
        return 0.0
    return plain, compare, lambda want: (in_bytes + 4 * B,
                                         bitpar_ops(B, TXT, P))


def _front_plain_and_work(a):
    """_plain_and_work for K6: words, sel and ham equal; logp_f's largest
    difference where ham <= M (the slots the caller reads); the bytes a
    slot needs: its n_w genome words once, loc, dir, live, the read once a
    row, qlp at its mismatches where ham <= M, and the four outputs."""
    from snap_rnaseq_tpu_torch.ops import rowwise_front as rf
    M = a["M"]
    plain = functools.partial(rf.rowwise_front_plain, **a)

    def compare(got, want):
        for name, g, w in zip(("K6 win_words", "K6 sel", "K6 ham"), got,
                              want):
            assert_same(name, g, w)
        ok = want[2] <= M
        return logp_err("K6_rowwise_front", got[3][ok], want[3][ok])

    def work(want):
        R, W = a["dir_"].shape
        P = a["reads"].shape[1]
        C, n_w = want[0].shape
        fast = want[2] <= M
        q_bytes = 4 * int(want[2][fast].sum())
        return (C * (2 * 4 * n_w + 9 + P + 8) + R * P + q_bytes, 0)
    return plain, compare, work


def call_shape(a):
    """[rows, P, text columns, e_max] for LV, [rows, P, TXT, packed_off]
    for K2, [rows, P, TXT] for K4, [rows, slots a row, P, M] for K6."""
    if "M" in a:
        return [int(x) for x in a["dir_"].shape] + [
            int(a["reads"].shape[1]), a["M"]]
    B, P = (int(x) for x in a["pattern"].shape)
    if "e_max" in a:
        return [B, P, int(a["text"].shape[1]), a["e_max"]]
    if "TXT" in a:
        return [B, P, a["TXT"], a["packed_off"]]
    return [B, P, int(a["text"].shape[1])]


def on_card(rec):
    """A recorded call's arguments, its tensors moved back to the card."""
    import torch
    return {k: v.cuda() if isinstance(v, torch.Tensor) else v
            for k, v in rec["args"].items()}


def check_path_calls(path, calls):
    """Every call shape recorded on a main path, re-run on its recorded
    inputs: the kernel against its plain version (bit-identical integers,
    log-probabilities within TOL) and both timed with CUDA events.  Per
    kernel, the times and bounds are means per launch over the path's
    calls, each shape weighted by how often the path launched it."""
    per, k3_levels = {}, []
    for rec in calls.values():
        kernel = rec["kernel"]
        a = on_card(rec)
        plain, compare, work = _plain_and_work(kernel, a)
        # one timed run: the plain versions take 10-1,000 ms a call, and
        # the phase re-runs every recorded shape of every path
        plain_ms, want = timed_once(plain)
        if kernel == "K3_lv_cigar":
            k3_levels.append(lv_levels(want, a["k"], a["e_max"]))
        err = compare(rec["fn"](**a), want)
        ms = time_ms(lambda: rec["fn"](**a), 20)
        dev_ms = device_ms(lambda: rec["fn"](**a), 20)
        b_ms, b_by = bound(*work(want))
        shape = call_shape(a)
        log(f"{path} {kernel} {shape} x{rec['n']}: kernel {ms:.4f} ms "
            f"({dev_ms:.4f} on the device), plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.5f} ms ({b_by}), max_abs_err {err}")
        per.setdefault(kernel, []).append(
            (rec["n"], ms, plain_ms, b_ms, b_by, err, shape, dev_ms))
    if k3_levels:
        # what sets a K3 call's time: its slowest row's levels
        lv_all = np.concatenate(k3_levels)
        log(f"{path} K3 levels per row (winning level, or k for rows that "
            f"fail) over the {len(k3_levels)} recorded calls: "
            f"{json.dumps(np.bincount(lv_all).tolist())} (rows at level "
            f"0, 1, ...); rows {lv_all.size}, failing or at k "
            f"{int((lv_all >= 30).sum())}; slowest row per call "
            f"{[int(x.max()) for x in k3_levels]}")
    out = {}
    for kernel, rows in per.items():
        n = sum(r[0] for r in rows)
        mean = lambda i: sum(r[0] * r[i] for r in rows) / n
        by = max(rows, key=lambda r: r[0] * r[3])[4]
        out[kernel] = dict(calls=n, ms=mean(1), plain_ms=mean(2),
                           bound_ms=mean(3), bound_by=by,
                           device_ms=mean(7),
                           max_abs_err=max(r[5] for r in rows),
                           shapes=[r[6] + [r[0]] for r in rows])
    return out


def k3_warp_sweep(calls):
    """K3 at the single path's recorded calls with 1, 2, 4 and 8 warps per
    block forced (4 being the default): device ms per launch, weighted by
    the path's launches; each setting must give the same script and
    scalars."""
    from snap_rnaseq_tpu_torch.ops import kernels as kx
    recs = [r for r in calls.values() if r["kernel"] == "K3_lv_cigar"]
    cases = [(r["n"], r["fn"], on_card(r)) for r in recs]
    refs = [fn(**a) for _, fn, a in cases]
    n_all = sum(n for n, _, _ in cases)
    sweep = {}
    try:
        for w in (1, 2, 4, 8):
            kx.set_variant("lv_cigar", w)
            ms = 0.0
            for (n, fn, a), ref in zip(cases, refs):
                got = fn(**a)
                for f in K3_SCRIPT + ("log_prob",):
                    assert_same(f"K3 at {w} warps a block, {f}",
                                getattr(got, f), getattr(ref, f))
                ms += n * device_ms(lambda: fn(**a), 20)
            sweep[str(w)] = ms / n_all
    finally:
        kx.set_variant("lv_cigar", 0)
    log(f"K3 at the single path's {len(cases)} call shapes ("
        f"{sorted(a['pattern'].shape[0] for _, _, a in cases)} rows), "
        "device ms per launch by warps per block: " + json.dumps(sweep))
    return sweep


def k5_vs_k1(calls):
    """K5's recorded calls on RNA single under onehot, re-run on the same
    inputs by K5 and by K1, timed in turns (K5, K1, K1, K5); both give the
    same outputs, log-probabilities included.  Device ms per launch of
    each, per shape."""
    from snap_rnaseq_tpu_torch.ops import lv_cuda
    out = {}
    fields = ("distance", "e_final", "d_final", "net_indel", "log_prob")
    for rec in calls.values():
        if rec["kernel"] != "K5_lv_onehot":
            continue
        a = on_card(rec)
        runs = {"K5": lv_cuda.lv_lanes_onehot, "K1": lv_cuda.lv_lanes}
        ref = lv_cuda.lv_lanes(**a)
        ms = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            fn = runs[name]
            got = fn(**a)
            for f in fields:
                assert_same(f"{name} vs K1 {f}", getattr(got, f),
                            getattr(ref, f))
            ms[name].append(device_ms(lambda: fn(**a), 20))
        shape = call_shape(a)
        out[f"{shape[0]} rows x{rec['n']}"] = {
            k: sum(v) / len(v) for k, v in ms.items()}
    log("RNA single's K5 call shapes, device ms per launch (K5, and K1 on "
        "the same inputs): " + json.dumps(out))
    return out


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


def golden_paired_dataset(tmp):
    """tests/test_golden_paired_rna.py's genome (_build_ref, without the
    annotation) and paired dataset (_paired_dataset), rebuilt with the
    port's modules."""
    from snap_rnaseq_tpu_torch.index.genome import read_fasta_genome
    from snap_rnaseq_tpu_torch.utils.tables import (decode_bases,
                                                    reverse_complement_codes)
    rng = np.random.default_rng(77177)
    chr1 = decode_bases(rng.integers(0, 4, 60000, dtype=np.uint8))
    chr2 = decode_bases(rng.integers(0, 4, 30000, dtype=np.uint8))
    fa = os.path.join(tmp, "pref.fa")
    with open(fa, "wb") as f:
        f.write(b">chr1\n" + chr1 + b"\n>chr2\n" + chr2 + b"\n")
    g = read_fasta_genome(fa)
    rng = np.random.default_rng(424242)
    L = 100
    codes = np.asarray(g.codes)
    fq1, fq2 = os.path.join(tmp, "g_r1.fq"), os.path.join(tmp, "g_r2.fq")
    with open(fq1, "wb") as f0, open(fq2, "wb") as f1:
        n = 0
        while n < 48:
            ins = int(rng.integers(220, 420))
            piece = int(rng.integers(0, 2))
            base = int(g.piece_offsets[piece])
            plen = 60000 if piece == 0 else 30000
            s = base + int(rng.integers(0, plen - ins))
            frag = codes[s:s + ins]
            if (frag > 3).any():
                continue
            a = frag[:L].copy()
            b = reverse_complement_codes(frag[ins - L:].copy())
            for r in (a, b):
                for _ in range(int(rng.integers(0, 3))):
                    p = int(rng.integers(0, L))
                    r[p] = (r[p] + int(rng.integers(1, 4))) % 4
            f0.write(b"@gp%d/1\n" % n + decode_bases(a) + b"\n+\n"
                     + b"I" * L + b"\n")
            f1.write(b"@gp%d/2\n" % n + decode_bases(b) + b"\n+\n"
                     + b"I" * L + b"\n")
            n += 1
    return fa, fq1, fq2


def same_as_golden(out, golden_name):
    got = [l for l in open(out).read().splitlines() if not l.startswith("@PG")]
    want = open(os.path.join(ROOT, "tests", "golden",
                             golden_name)).read().splitlines()
    if got != want:
        bad = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
        raise AssertionError(f"{golden_name}: the SAM differs on the card "
                             f"({bad} lines)")
    return len(got)


# tests/test_golden_paired_rna.py _build_ref's annotation: (gene,
# transcript, chromosome, strand, 1-based inclusive exons)
GOLDEN_TRANSCRIPTS = (
    ("gA", "tA1", "chr1", "+", ((2001, 2600), (4001, 4700), (7001, 7800))),
    ("gA", "tA2", "chr1", "+", ((2001, 2600), (7001, 7800))),
    ("gB", "tB1", "chr2", "-", ((9001, 9700), (12001, 12800))))


def write_gtf(path, transcripts):
    """exon rows in the format of tests/test_golden_paired_rna.py."""
    rows = []
    for gid, tid, chrom, strand, exons in transcripts:
        for i, (s, e) in enumerate(exons):
            rows.append(f'{chrom}\tsrc\texon\t{s}\t{e}\t.\t{strand}\t.\t'
                        f'gene_id "{gid}"; transcript_id "{tid}"; '
                        f'exon_number "{i + 1}";')
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def golden_rna_reads(tmp, fa):
    """tests/test_golden_paired_rna.py _rna_dataset: reads cut from the
    spliced tA1 transcript, then genomic reads."""
    from snap_rnaseq_tpu_torch.index.genome import read_fasta_genome
    from snap_rnaseq_tpu_torch.utils.tables import (decode_bases,
                                                    reverse_complement_codes)
    g = read_fasta_genome(fa)
    rng = np.random.default_rng(515151)
    codes = np.asarray(g.codes)
    base = int(g.piece_offsets[0])
    tseq = np.concatenate([codes[base + s - 1: base + e]
                           for s, e in GOLDEN_TRANSCRIPTS[0][4]])
    L = 100
    path = os.path.join(tmp, "rna_reads.fq")
    with open(path, "wb") as f:
        for i in range(24):
            off = int(rng.integers(0, len(tseq) - L))
            r = tseq[off:off + L].copy()
            if i % 4 == 0:
                p = int(rng.integers(0, L))
                r[p] = (r[p] + int(rng.integers(1, 4))) % 4
            if i % 2:
                r = reverse_complement_codes(r)
            f.write(b"@rt%d\n" % i + decode_bases(r) + b"\n+\n" + b"I" * L
                    + b"\n")
        for i in range(12):
            piece = int(rng.integers(0, 2))
            pb = int(g.piece_offsets[piece])
            plen = 60000 if piece == 0 else 30000
            s = pb + int(rng.integers(0, plen - L))
            r = codes[s:s + L].copy()
            if (r > 3).any():
                continue
            f.write(b"@rg%d\n" % i + decode_bases(r) + b"\n+\n" + b"I" * L
                    + b"\n")
    return path


@contextlib.contextmanager
def lv_lanes_impl(impl):
    """SNAP_TPU_LV_LANES set to `impl` for the block (ops/lv.py reads it
    at each call), restored after."""
    old = os.environ.get("SNAP_TPU_LV_LANES")
    os.environ["SNAP_TPU_LV_LANES"] = impl
    try:
        yield
    finally:
        if old is None:
            del os.environ["SNAP_TPU_LV_LANES"]
        else:
            os.environ["SNAP_TPU_LV_LANES"] = old


def check_lanes_kernel(impl, launches, what):
    """The LV-lanes kernel the switch chose launched and the other did
    not."""
    on, off = (("K1_lv_lanes", "K5_lv_onehot") if impl == "bits"
               else ("K5_lv_onehot", "K1_lv_lanes"))
    if launches[on] <= 0 or launches[off] != 0:
        raise AssertionError(f"{what}, SNAP_TPU_LV_LANES={impl}: {on} "
                             f"launched {launches[on]} times, {off} "
                             f"{launches[off]}")


def golden_phase(tmp, device="cuda"):
    from snap_rnaseq_tpu_torch.ops import kernels as kx
    fa, fq = golden_dataset(tmp)
    idx, out = os.path.join(tmp, "gidx"), os.path.join(tmp, "golden.sam")
    run_cli(["index", fa, idx])
    run_cli(["single", idx, fq, "-o", out, "--device", device])
    n_single = same_as_golden(out, "single_100bp.sam")
    fa, fq1, fq2 = golden_paired_dataset(tmp)
    idx, out = os.path.join(tmp, "gpidx"), os.path.join(tmp, "golden_p.sam")
    run_cli(["index", fa, idx])
    run_cli(["paired", idx, fq1, fq2, "-o", out, "--device", device])
    n_paired = same_as_golden(out, "paired_100bp.sam")
    # the RNA golden on the same genome, under both LV-lanes kernels
    gtf, tidx = os.path.join(tmp, "ann.gtf"), os.path.join(tmp, "gtidx")
    write_gtf(gtf, GOLDEN_TRANSCRIPTS)
    run_cli(["transcriptome", gtf, fa, tidx])
    reads = golden_rna_reads(tmp, fa)
    n_rna = {}
    for impl in ("bits", "onehot"):
        out = os.path.join(tmp, f"golden_rna_{impl}.sam")
        with lv_lanes_impl(impl):
            kx.reset_launches()
            run_cli(["single", idx, tidx, gtf, reads, "-o", out, "--device",
                     device])
            check_lanes_kernel(impl, dict(kx.LAUNCHES), "RNA golden")
        n_rna[impl] = same_as_golden(out, "rna_single_100bp.sam")
    return n_single, n_paired, n_rna


# ---------------------------------------------------------------- phase 4

def mutate(seg, rng, indel_rate, L=READ_LEN):
    """A read of L bases from `seg` (L plus 8 spare bases, for a
    deletion): ~1% substitutions, then with probability `indel_rate` one
    1-3 base insertion or deletion in the middle."""
    seg = seg.copy()
    n_sub = rng.binomial(L, 0.01)
    if n_sub:
        p = rng.integers(0, L, n_sub)
        seg[p] = (seg[p] + rng.integers(1, 4, n_sub)) % 4
    if rng.random() < indel_rate:
        p, m = int(rng.integers(20, L - 20)), int(rng.integers(1, 4))
        seg = (np.delete(seg, np.arange(p, p + m)) if rng.random() < 0.5
               else np.insert(seg, p, rng.integers(0, 4, m)))
    return seg[:L].astype(np.uint8)


def simulate_reads(codes, n, rng, L=READ_LEN):
    """Reads of L bases (100 unless given): ~1% substitutions, 15% with a
    1-3 base indel, half reverse-complemented; returns (true 0-based
    start, rc, codes)."""
    G = codes.size
    starts = rng.integers(1000, G - L - 1000, n)
    out = []
    for i, s in enumerate(starts):
        r = mutate(codes[s:s + L + 8], rng, 0.15, L)
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


SINGLE_PATH = ("K1_lv_lanes", "K2_bitpar_packed", "K3_lv_cigar",
               "K6_rowwise_front", "K7_seed_lookup")
PAIRED_PATH = SINGLE_PATH + ("K2_bitpar_rescue",)
STRINGZ_PATH = ("K4_bitpar_rows",)


def same_build_on_cpu(argv, card_dir):
    """`argv` (an `index` or `transcriptome` command without its output
    directory) again with --device cpu: every file it writes must equal
    the card build's in `card_dir` byte for byte.  Returns its seconds."""
    cpu_dir = card_dir + "_cpu"
    t0 = time.time()
    run_cli([*argv, cpu_dir, "--device", "cpu"])
    cpu_s = time.time() - t0
    names = sorted(os.listdir(card_dir))
    if sorted(os.listdir(cpu_dir)) != names:
        raise AssertionError(f"{argv[0]}: card files {names}, cpu files "
                             f"{sorted(os.listdir(cpu_dir))}")
    for n in names:
        with open(os.path.join(card_dir, n), "rb") as a, \
                open(os.path.join(cpu_dir, n), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{argv[0]}: {n} differs between the "
                                     "card and --device cpu builds")
    return cpu_s


def real_index(tmp, n_bases):
    """The 64 Mb hg-like genome and its index, built once through the CLI
    on the card for both real-size runs, and again with --device cpu (the
    same files)."""
    from snap_rnaseq_tpu_torch.utils.synth_genome import hg_like_genome
    codes = hg_like_genome(n_bases, seed=0)
    fa = os.path.join(tmp, "hg_like.fa")
    write_fasta(fa, codes)
    idx = os.path.join(tmp, "idx")
    t0 = time.time()
    run_cli(["index", fa, idx])
    index_s = time.time() - t0
    cpu_s = same_build_on_cpu(["index", fa], idx)
    log(f"index: {n_bases} bases in {index_s:.3f} s on the card, "
        f"{cpu_s:.3f} s with --device cpu (files byte-identical)")
    return codes, idx, index_s


def counted_run(fn, path, what, device="cuda"):
    """fn() on the card with the launch counters zeroed just before and
    read just after; raises if a kernel of `path` did not launch.  The
    kernel calls of the run are recorded (recorded_calls).  Returns
    (fn's result, launches, calls, wall s, peak device bytes)."""
    import torch
    from snap_rnaseq_tpu_torch.ops import kernels as kx
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with recorded_calls() as calls:
        kx.reset_launches()                   # zero just before the run
        t0 = time.time()
        result = fn()
        if cuda:
            torch.cuda.synchronize()
        wall_s = time.time() - t0
        launches = dict(kx.LAUNCHES)          # read just after
    missing = [k for k in path if launches[k] <= 0]
    if cuda and missing:
        raise AssertionError(f"kernels not launched on the {what} path: "
                             f"{missing}")
    return (result, launches, calls, wall_s,
            torch.cuda.max_memory_allocated() if cuda else None)


def counted_cli(argv, path, device="cuda"):
    """One CLI run through counted_run; returns its stdout in place of
    fn's result."""
    return counted_run(lambda: run_cli(argv), path, argv[0], device)


def perf_row(perf):
    """(total reads, align seconds) from the CLI's -pf row."""
    _, total, _useful, align_s, *_ = open(perf).read().split("\t")[:5]
    return int(total), float(align_s)


def wait_line(stdout):
    # the pipeline's split of its wall time (utils/stats.py WaitProfile):
    # reader, waits on device results, SAM writing
    return next((l for l in stdout.splitlines()
                 if l.startswith("wait profile")), None)


def single_real_phase(tmp, codes, idx, index_s, n_reads, batch,
                      L=READ_LEN, engine=True):
    """`single -bs 1024 -pf` on simulated reads of L bases; then, with
    `engine`, the engine alone on the same reads."""
    from snap_rnaseq_tpu_torch.utils.tables import decode_bases
    rng = np.random.default_rng(20261016)
    # the id carries the true start; SAM POS is 1-based within the one
    # chromosome, so POS - 1 is directly comparable
    reads = simulate_reads(codes, n_reads, rng, L)
    fq = os.path.join(tmp, f"reads{L}.fq")
    with open(fq, "wb") as f:
        for i, (s, rc, r) in enumerate(reads):
            f.write(b"@r%d_%d_%d\n" % (i, s, rc) + decode_bases(r)
                    + b"\n+\n" + b"I" * L + b"\n")
    out = os.path.join(tmp, f"out{L}.sam")
    perf = os.path.join(tmp, f"perf{L}.tsv")
    stdout, launches, calls, wall_s, peak = counted_cli(
        ["single", idx, fq, "-o", out, "-bs", str(batch), "--device",
         "cuda", "-pf", perf], SINGLE_PATH)
    total, align_s = perf_row(perf)

    n_al = n_true = 0
    for line in open(out):
        if line.startswith("@"):
            continue
        f = line.split("\t", 4)
        if int(f[1]) & 4:
            continue
        n_al += 1
        _, s, _ = f[0].split("_")
        if abs(int(f[3]) - 1 - int(s)) <= 2 * L:
            n_true += 1
    res = dict(read_len=L, reads=total, align_s=align_s,
               reads_per_s=total / align_s, wall_s=wall_s,
               aligned_share=n_al / total, at_origin_share=n_true / total,
               index_build_s=index_s, peak_device_bytes=peak,
               launches=launches, wait_profile=wait_line(stdout))
    if engine:
        res["engine"], res["k7_cells"] = single_engine_phase(
            idx, np.stack([r for _, _, r in reads]), batch, codes)
    if res["at_origin_share"] < 0.8:
        raise AssertionError(f"only {res['at_origin_share']:.3f} of reads "
                             "placed at their origin")
    return res, calls


def paired_real_phase(tmp, codes, idx, index_s, n_pairs, batch,
                      L=READ_LEN, engine=True):
    """`paired -bs 1024 -pf` on wgsim-style pairs of L-base ends; each
    end's id carries both true starts.  With `engine`, the engine alone
    on the same pairs."""
    from snap_rnaseq_tpu_torch.utils.synth_genome import wgsim_pairs
    from snap_rnaseq_tpu_torch.utils.tables import decode_bases
    r0, q0, r1, q1, p0, p1 = wgsim_pairs(codes, n_pairs, L, seed=20261017)
    fq1 = os.path.join(tmp, f"p{L}_r1.fq")
    fq2 = os.path.join(tmp, f"p{L}_r2.fq")
    with open(fq1, "wb") as f0, open(fq2, "wb") as f1:
        for i in range(n_pairs):
            rid = b"@p%d_%d_%d" % (i, p0[i], p1[i])
            f0.write(rid + b"/1\n" + decode_bases(r0[i]) + b"\n+\n"
                     + q0[i].tobytes() + b"\n")
            f1.write(rid + b"/2\n" + decode_bases(r1[i]) + b"\n+\n"
                     + q1[i].tobytes() + b"\n")
    out = os.path.join(tmp, f"paired{L}.sam")
    perf = os.path.join(tmp, f"perf_p{L}.tsv")
    stdout, launches, calls, wall_s, peak = counted_cli(
        ["paired", idx, fq1, fq2, "-o", out, "-bs", str(batch), "--device",
         "cuda", "-pf", perf], PAIRED_PATH)
    total, align_s = perf_row(perf)

    n_al = [0, 0]
    n_true = 0
    for line in open(out):
        if line.startswith("@"):
            continue
        f = line.split("\t", 4)
        flag = int(f[1])
        if flag & 4:
            continue
        end = 0 if flag & 0x40 else 1
        n_al[end] += 1
        truth = int(f[0].split("_")[1 + end])
        if abs(int(f[3]) - 1 - truth) <= 2 * L:
            n_true += 1
    res = dict(read_len=L, pairs=total // 2, align_s=align_s,
               pairs_per_s=total / 2 / align_s, wall_s=wall_s,
               aligned_share_end0=n_al[0] / n_pairs,
               aligned_share_end1=n_al[1] / n_pairs,
               at_origin_share=n_true / (2 * n_pairs), index_build_s=index_s,
               peak_device_bytes=peak, launches=launches,
               wait_profile=wait_line(stdout))
    if engine:
        res["engine"] = paired_engine_phase(idx, r0, q0, r1, q1, batch)
    if res["at_origin_share"] < 0.8:
        raise AssertionError(f"only {res['at_origin_share']:.3f} of ends "
                             "placed at their origin")
    return res, calls


# ---------------------------------------------------------------- phase 4d

FLAT_PATH = ("K4_bitpar_rows", "K1_lv_lanes")
RESCUE_CORE = ("K1_lv_lanes", "K2_bitpar_packed", "K2_bitpar_rescue",
               "K6_rowwise_front")
BAM_PATH = RESCUE_CORE + ("K3_lv_cigar",)


def sam_body(lines):
    """The record lines of SAM text (bytes), header dropped."""
    return [l for l in lines if l and not l.startswith(b"@")]


def core_fields(line):
    """A SAM record's first 11 fields, the duplicate flag (0x400) cleared:
    what a BAM decoder (io/validate.py bam_to_sam_lines) gives back."""
    f = line.split(b"\t")[:11]
    f[1] = str(int(f[1]) & ~0x400).encode()
    return tuple(f)


def check_valid(path):
    """The port's validator (validate_sam, or validate_bam's checks on the
    BAM decoded once) finds no errors.  Returns the record lines."""
    from snap_rnaseq_tpu_torch.io import validate
    if path.endswith(".bam"):
        lines = list(validate.bam_to_sam_lines(path))
    else:
        lines = open(path, "rb").read().splitlines()
    errors = validate.validate_records(lines)
    if errors:
        raise AssertionError(f"{path}: {len(errors)} validation errors, "
                             f"first {errors[:3]}")
    return sam_body(lines)


def check_sorted(body):
    """Mapped records in nondecreasing (RNAME, POS) order, the one
    chromosome's records first."""
    keys = [(l.split(b"\t")[2], int(l.split(b"\t")[3])) for l in body
            if not int(l.split(b"\t")[1]) & 4]
    if keys != sorted(keys):
        raise AssertionError("sorted output out of coordinate order")


def placements(body):
    """read name -> the sorted (RNAME, POS, reverse strand, CIGAR) of its
    two records ('*' for an unaligned end)."""
    out = {}
    for l in body:
        f = l.split(b"\t")
        flag = int(f[1])
        p = (b"*",) if flag & 4 else (f[2], f[3], flag & 0x10, f[5])
        out.setdefault(f[0], []).append(p)
    return {k: sorted(v) for k, v in out.items()}


def matched_fastq(tmp, sam):
    """The pairs of an interleaved SAM as the port's matcher forms them
    (io/readers.py open_paired_read_supplier), written as two FASTQ files
    in that end order; returns their paths."""
    from snap_rnaseq_tpu_torch.io.readers import open_paired_read_supplier
    paths = [os.path.join(tmp, f"sw_r{e}.fq") for e in (1, 2)]
    with open(paths[0], "wb") as f0, open(paths[1], "wb") as f1:
        for a, b in open_paired_read_supplier(sam):
            for f, r in ((f0, a), (f1, b)):
                f.write(b"@" + r.rid + b"\n" + r.seq + b"\n+\n" + r.qual
                        + b"\n")
    return paths


def formats_phase(tmp, idx, paired, rna, batch, device="cuda"):
    """Phase 4d: the 4b pairs to `-o .sam.gz`, `-so -o .bam` and `-so -o
    .sam`, 4c's RNA reads to `-so -o .bam`, the sorted SAM back in as
    `paired`'s interleaved input and, as its reference, the same pairs as
    FASTQ in the matcher's end order; counters zeroed around each run,
    whose kernels must all launch.  Each output is held to 4b's or 4c's
    and passes the validator."""
    import gzip
    fq1, fq2 = (os.path.join(tmp, f"p{READ_LEN}_r{e}.fq") for e in (1, 2))
    ref = sam_body(open(os.path.join(tmp, f"paired{READ_LEN}.sam"),
                        "rb").read().splitlines())
    gtf, tidx = os.path.join(tmp, "real.gtf"), os.path.join(tmp, "tidx")
    out = {k: os.path.join(tmp, k) for k in
           ("p.sam.gz", "p.bam", "p.sam", "r.bam", "pin.sam", "sw.sam")}
    res = {}

    def run(name, argv, path, is_pairs=True):
        perf = os.path.join(tmp, f"{name}.tsv")
        _, launches, _, wall_s, _ = counted_cli(
            argv + ["-o", out[name], "-bs", str(batch), "--device", device,
                    "-pf", perf], path)
        total, align_s = perf_row(perf)
        rate = total / (2 if is_pairs else 1) / align_s
        base = (paired["pairs_per_s"] if is_pairs
                else rna["rna_single"]["reads_per_s"])
        res[name] = dict(rate=rate, baseline_rate=base, wall_s=wall_s,
                         launches=launches)
        log(f"formats {name}: {rate:.1f} {'pairs' if is_pairs else 'reads'}"
            f"/s (its plain-SAM run: {base:.1f}), {wall_s:.3f} s")

    run("p.sam.gz", ["paired", idx, fq1, fq2], RESCUE_CORE)
    run("p.bam", ["paired", idx, fq1, fq2, "-so"], BAM_PATH)
    run("p.sam", ["paired", idx, fq1, fq2, "-so"], RESCUE_CORE)
    run("r.bam", ["single", idx, tidx, gtf, os.path.join(tmp, "rna_reads.fq"),
                  "-so"], SINGLE_PATH, is_pairs=False)
    run("pin.sam", ["paired", idx, out["p.sam"]], RESCUE_CORE)
    run("sw.sam", ["paired", idx, *matched_fastq(tmp, out["p.sam"])],
        RESCUE_CORE)

    gz = gzip.decompress(open(out["p.sam.gz"], "rb").read())
    plain_gz = os.path.join(tmp, "p_gz.sam")
    open(plain_gz, "wb").write(gz)
    drop_pg = lambda lines: [l for l in lines if not l.startswith(b"@PG")]
    plain = open(os.path.join(tmp, f"paired{READ_LEN}.sam"), "rb").read()
    if drop_pg(gz.splitlines()) != drop_pg(plain.splitlines()):
        raise AssertionError("p.sam.gz differs from the plain SAM")
    check_valid(plain_gz)
    sorted_sam = check_valid(out["p.sam"])
    check_sorted(sorted_sam)
    if sorted(sorted_sam) != sorted(ref):
        raise AssertionError("-so SAM: not the plain SAM's records")
    bam = check_valid(out["p.bam"])
    check_sorted(bam)
    if sorted(map(core_fields, bam)) != sorted(map(core_fields, sorted_sam)):
        raise AssertionError("-so BAM: not the sorted SAM's records")
    if not os.path.exists(out["p.bam"] + ".bai"):
        raise AssertionError("-so BAM: no .bai")
    n_dup = sum(int(l.split(b"\t")[1]) & 0x400 > 0 for l in bam)

    rna_ref = sam_body(open(os.path.join(tmp, "rna_single.sam"),
                            "rb").read().splitlines())
    if sorted(map(core_fields, check_valid(out["r.bam"]))) != \
            sorted(map(core_fields, rna_ref)):
        raise AssertionError("RNA -so BAM: not RNA single's records")
    run_files = [n[len("rna_single."):] for n in os.listdir(tmp)
                 if n.startswith("rna_single.")
                 and not n.endswith((".sam", ".tsv"))]
    for suffix in run_files:
        a = open(os.path.join(tmp, "rna_single." + suffix), "rb").read()
        b = open(os.path.join(tmp, "r." + suffix), "rb").read()
        if a != b:
            raise AssertionError(f"RNA -so BAM run: {suffix} differs")

    # SAM input: the matcher pairs mates by name and hands them on as
    # (arriving, stored), so a pair's ends can trade places, and the
    # engine is not symmetric in its ends where candidates tie.  The run
    # must give the records of the same pairs read from FASTQ in that end
    # order (sw.sam); the pairs whose placements differ from 4b's are
    # counted
    pin = check_valid(out["pin.sam"])
    if sorted(pin) != sorted(sam_body(open(out["sw.sam"], "rb")
                                      .read().splitlines())):
        raise AssertionError("SAM input: not the records of the same pairs "
                             "read from FASTQ")
    got, want = placements(pin), placements(ref)
    if set(got) != set(want):
        raise AssertionError("SAM input: pairs lost or added")
    n_moved = sum(got[k] != v for k, v in want.items())
    res.update(sam_input_pairs_placed_unlike_fastq_order=n_moved, duplicates_flagged=n_dup, rna_run_files=len(run_files),
               pairs=len(want))
    return res


# ---------------------------------------------------------------- phase 4e

def fastq_codes(path, n):
    """The first n records of a FASTQ: (codes (n, L) u8, names)."""
    from snap_rnaseq_tpu_torch.utils.tables import encode_bases
    lines = open(path, "rb").read().splitlines()[:4 * n]
    names = [lines[i][1:] for i in range(0, len(lines), 4)]
    return np.stack([encode_bases(lines[i + 1])
                     for i in range(0, len(lines), 4)]), names


def same_tensors(what, got, want):
    """Two runs' result dicts: integers bit-identical, log-probabilities
    within TOL."""
    for k, v in want.items():
        check = logp_err if v.is_floating_point() else assert_same
        check(f"{what} {k}", got[k].cpu(), v.cpu())


def trace_result(text):
    """(status, score, mapq) of trace's result line."""
    f = text.strip().splitlines()[-1].split()
    return f[1], int(f[f.index("score") + 1]), int(f[f.index("mapq") + 1])


def origin(codes, name):
    """The genome bases a 4a read was cut from, on the read's strand (its
    name is r<i>_<start>_<rc>)."""
    _, s, rc = name.decode().split("_")
    seg = codes[int(s):int(s) + READ_LEN]
    return (3 - seg[::-1]) if int(rc) else seg


def flat_phase(tmp, idx, codes, batch, device="cuda"):
    """Phase 4e: one batch of 4a's reads through the flat phases (path
    `flat`, calls recorded; K4 and K1 must launch), again with the
    substitution fast path off (test_fast_sub.py's relations), 64 of them
    on the card and on the CPU (equal), then `trace` through the CLI on 16
    reads and a random one."""
    import torch
    from snap_rnaseq_tpu_torch.cli import _load_index_cached
    from snap_rnaseq_tpu_torch.models.single import (SingleAligner,
                                                     flat_align_batch)
    from snap_rnaseq_tpu_torch.ops import kernels as kx
    from snap_rnaseq_tpu_torch.utils.tables import decode_bases
    index = _load_index_cached(idx)
    reads, names = fastq_codes(os.path.join(tmp, f"reads{READ_LEN}.fq"),
                               batch)
    r = torch.from_numpy(reads)
    q = torch.full(reads.shape, ord("I"), dtype=torch.uint8)
    aligner = SingleAligner(index, device=device)
    flat_align_batch(aligner, r[:64], q[:64])            # warm
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    with recorded_calls() as calls:
        kx.reset_launches()
        t0 = time.time()
        u, sc, out = flat_align_batch(aligner, r, q)
        sync()
        wall_ms = 1e3 * (time.time() - t0)
        launches = dict(kx.LAUNCHES)
    missing = [k for k in FLAT_PATH if launches[k] <= 0]
    if device == "cuda" and missing:
        raise AssertionError(f"kernels not launched on the flat path: "
                             f"{missing}")

    os.environ["SNAP_TPU_FAST_SUB"] = "0"
    try:
        _, sc0, _ = flat_align_batch(aligner, r, q)
    finally:
        del os.environ["SNAP_TPU_FAST_SUB"]
    # The fast path against LV (test_fast_sub.py's relations, as far as
    # they hold): a candidate only one run scored is one the other run's
    # pooled LV budget dropped, so there are no more than its overflow.
    # Where both scored, LV's score is never above the closed form's (the
    # anchored substitution path is one of LV's paths); where it is below,
    # LV's path starts off the anchor (loc_adj moved), which the
    # prefilter's start-anchored distance cannot see (ROADMAP.md section
    # 3).  Those rows, the equal-score rows whose start moved, and the
    # rows whose logp differs (equal-cost indel ties, the JAX engine's
    # accepted deviation) are counted.
    ok_on, ok_off = sc["scored_ok"], sc0["scored_ok"]
    ok = ok_on & ok_off
    over_on, over_off = int(sc["score_overflow"]), int(sc0["score_overflow"])
    if int((ok_on & ~ok_off).sum()) > over_off or \
            int((ok_off & ~ok_on).sum()) > over_on:
        raise AssertionError("fast path on and off: scored_ok differs "
                             "beyond the LV budgets' overflow")
    lower = ok & (sc0["score"] < sc["score"])
    moved = ok & (sc0["loc_adj"] != sc["loc_adj"])
    if (ok & (sc0["score"] > sc["score"])).any() or (lower & ~moved).any():
        raise AssertionError("fast path on and off: LV above the closed "
                             "form, or below it at the anchor")
    n_lower, n_moved = int(lower.sum()), int((moved & ~lower).sum())
    n_logp = int(((sc["logp"] - sc0["logp"]).abs()[ok & ~lower]
                  > 2e-4).sum())
    n_fast = int(sc["n_fast"])
    if n_fast <= 0 or int(sc0["n_fast"]) != 0:
        raise AssertionError("SNAP_TPU_FAST_SUB did not switch the fast "
                             "path")

    sub = [flat_align_batch(a, r[:64], q[:64])
           for a in (aligner, SingleAligner(index, device="cpu"))]
    for part, got, want in zip(("u", "sc", "out"), *sub):
        same_tensors(f"flat phases card / CPU, {part}:", got, want)

    # trace on reads with and without an indel (those far from their
    # origin's bases), the result line held to the engine at the trace's
    # scoring (every slot scored) and its score to the default engine
    far = [int((reads[i] != origin(codes, n)).sum()) > 10
           for i, n in enumerate(names[:200])]
    pick = ([i for i, f in enumerate(far) if f][:4]
            + [i for i, f in enumerate(far) if not f][:12])
    exhaustive = SingleAligner(index, device=device,
                               score_budget_per_read=0, compact_per_read=0,
                               overflow_tier=False)
    sel = reads[pick]
    ql = np.full(sel.shape, ord("I"), np.uint8)
    want = exhaustive.align_batch(sel, ql)
    dflt = aligner.align_batch(sel, ql)
    n_mapq = 0
    t0 = time.time()
    for j, i in enumerate(pick):
        status, score, mapq = trace_result(run_cli(
            ["trace", idx, decode_bases(reads[i]).decode(), "--device",
             device]))
        exp = {1: "SingleHit", 2: "MultipleHits", 0: "NotFound"}[
            int(want["result"][j])]
        if (status, score, mapq) != (exp, int(want["score"][j]),
                                     int(want["mapq"][j])):
            raise AssertionError(f"trace of read {i}: {status} {score} "
                                 f"{mapq}, the engine {exp} "
                                 f"{int(want['score'][j])} "
                                 f"{int(want['mapq'][j])}")
        if score != int(dflt["score"][j]):
            raise AssertionError(f"trace of read {i}: score {score}, the "
                                 f"default engine {int(dflt['score'][j])}")
        n_mapq += mapq != int(dflt["mapq"][j])
    rand = np.random.default_rng(5).integers(0, 4, READ_LEN, dtype=np.uint8)
    status, _, _ = trace_result(run_cli(
        ["trace", idx, decode_bases(rand).decode(), "--device", device]))
    if status != "NotFound":
        raise AssertionError(f"trace of a random read: {status}")
    res = dict(reads=len(names), wall_ms=wall_ms, launches=launches,
               n_fast=n_fast, n_scored=int(ok_on.sum()),
               n_scored_fast_off=int(ok_off.sum()), logp_tie_rows=n_logp,
               lv_below_fast_rows=n_lower, tie_start_moved_rows=n_moved,
               score_overflow=over_on, score_overflow_fast_off=over_off,
               compact_overflow=int(out["compact_overflow"]),
               results=np.bincount(out["result"].cpu().numpy(),
                                   minlength=3).tolist(),
               traced=len(pick) + 1,
               traced_with_indel=sum(far[i] for i in pick),
               trace_mapq_not_default=n_mapq,
               trace_s=time.time() - t0)
    return res, calls


# ---------------------------------------------------------------- phase 4f

# every worker's batches launch K1 and K2; K3 (indel CIGARs) launches in
# a few of 4b's batches only (4 of 16), so it is required of the run
HOSTS_WORKER_PATH = ("K1_lv_lanes", "K2_bitpar_packed", "K6_rowwise_front")
HOSTS_PATH = HOSTS_WORKER_PATH + ("K3_lv_cigar",)
# the JAX package's keys of the `multihost:` dict
MERGED_KEYS = {"total_reads", "useful_reads", "single_hits", "multi_hits",
               "not_found", "aligned_as_pairs", "lv_calls", "local_wall_s",
               "host_id", "n_hosts"}


def worker_lines(text):
    """The `multihost worker:` JSON lines of a --hosts run, by host id."""
    rows = [json.loads(l.split(":", 1)[1]) for l in text.splitlines()
            if l.startswith("multihost worker:")]
    return sorted(rows, key=lambda w: w["host_id"])


def hosts_cli(argv, n_hosts, device="cuda"):
    """`argv --hosts n_hosts` through the CLI: (the merged `multihost:`
    dict, the workers' lines, the launcher's wall s).  Every worker must
    have run on `device` and, on a card, launched K1 and K2, and the
    workers together K3."""
    import ast
    err = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stderr(err):
        stdout = run_cli(argv + ["--hosts", str(n_hosts), "--device",
                                 device])
    wall_s = time.time() - t0
    line = next(l for l in stdout.splitlines() if l.startswith("multihost:"))
    merged = ast.literal_eval(line.split(":", 1)[1].strip())
    if set(merged) != MERGED_KEYS:
        raise AssertionError(f"multihost dict keys {sorted(merged)}")
    workers = worker_lines(err.getvalue())
    if [w["host_id"] for w in workers] != list(range(n_hosts)):
        raise AssertionError(f"{len(workers)} worker lines for {n_hosts} "
                             "hosts")
    for w in workers:
        missing = [k for k in HOSTS_WORKER_PATH if w["launches"][k] <= 0]
        if not w["device"].startswith(device) or (device == "cuda"
                                                  and missing):
            raise AssertionError(f"worker {w['host_id']} on {w['device']}, "
                                 f"kernels not launched: {missing}")
    missing = [k for k in HOSTS_PATH
               if sum(w["launches"][k] for w in workers) <= 0]
    if device == "cuda" and missing:
        raise AssertionError(f"kernels not launched by any worker: "
                             f"{missing}")
    return merged, workers, wall_s


def same_cuts(idx, inputs, n_hosts, batch, paired, device="cuda"):
    """The hosts' ranges aligned one after another in this process, each
    batch's score_overflow recorded: the one-process run over the same
    batch cuts as an n_hosts run.  Returns (SAM body, overflow per
    batch)."""
    from snap_rnaseq_tpu_torch.cli import _load_index_cached
    from snap_rnaseq_tpu_torch.io import range_split as rs
    from snap_rnaseq_tpu_torch.models.paired_pipeline import (
        PairedEndPipeline, PairedPipelineOptions)
    from snap_rnaseq_tpu_torch.models.pipeline import (PipelineOptions,
                                                       SingleEndPipeline)
    index = _load_index_cached(idx)
    pipe = (PairedEndPipeline(index, options=PairedPipelineOptions(
                batch_size=batch), device=device) if paired else
            SingleEndPipeline(index, options=PipelineOptions(
                batch_size=batch), device=device))
    overflow, real = [], pipe.aligner.align_batch_device

    def spy(*a):
        out = real(*a)
        overflow.append(int(out["score_overflow"]))
        return out
    pipe.aligner.align_batch_device = spy
    body = []
    if paired:
        ranges = rs.split_paired_fastq_ranges(*inputs, n_hosts)
    else:
        ranges = rs.split_fastq_ranges(inputs, n_hosts)
    for k, r in enumerate(ranges):
        out = f"{idx}.cuts{k}.sam"
        if paired:
            pipe.run(rs.read_paired_fastq_range(*inputs, *r), None, out)
        else:
            pipe.run(rs.read_fastq_range(inputs, *r), out)
        body += sam_body(open(out, "rb").read().splitlines())
    return body, overflow


def hosts_phase(tmp, idx, single, paired, batch, device="cuda"):
    """Phase 4f: 4b's pairs through `paired --hosts 1/2/4` and 4a's reads
    through `single --hosts 2`, each merged body held to the one-process
    body (or, if batch cuts change it, to a one-process run over the same
    cuts, the difference counted), the merged stats to the one-process
    stats; `paired --hosts 2 -so` held to 4d's sorted SAM.  --hosts 1 runs
    parallel/multihost.py run_host in this process (the CLI takes --hosts
    1 as a plain run): the workers' per-read route for N = 1."""
    import torch
    from snap_rnaseq_tpu_torch.parallel import multihost as mh
    fq = os.path.join(tmp, f"reads{READ_LEN}.fq")
    fq1, fq2 = (os.path.join(tmp, f"p{READ_LEN}_r{e}.fq") for e in (1, 2))
    body_of = lambda p: sam_body(open(p, "rb").read().splitlines())
    ref = {"paired": body_of(os.path.join(tmp, f"paired{READ_LEN}.sam")),
           "single": body_of(os.path.join(tmp, f"out{READ_LEN}.sam"))}
    res = dict(cpu_count=os.cpu_count(), runs={})

    def check_body(name, got, kind, n_hosts, inputs):
        if got == ref[kind]:
            return 0
        cuts, overflow = same_cuts(idx, inputs, n_hosts, batch,
                                   kind == "paired", device)
        n_diff = sum(a != b for a, b in zip(got, ref[kind])) + abs(
            len(got) - len(ref[kind]))
        log(f"hosts {name}: {n_diff} records differ from the one-process "
            f"run; score_overflow per batch over the same cuts: {overflow}")
        if got != cuts:
            raise AssertionError(f"hosts {name}: the merged SAM differs "
                                 "from one process over the same cuts")
        return n_diff

    # N = 1: run_host in this process, the workers' route
    out = os.path.join(tmp, "h1.sam")
    err = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stderr(err):
        one = mh.run_host(idx, (fq1, fq2), out, host_id=0, n_hosts=1,
                          paired=True, batch_size=batch, device=device)
    wall = time.time() - t0
    w1 = worker_lines(err.getvalue())
    n_pairs = one["total_reads"] // 2
    res["runs"]["paired_hosts1"] = dict(
        wall_s=wall, local_wall_s=[w["local_wall_s"] for w in w1],
        pairs_per_s_wall=n_pairs / wall,
        pairs_per_s_local=n_pairs / one["local_wall_s"],
        peak_device_bytes=[w["peak_device_bytes"] for w in w1],
        body_records_unlike_one_process=check_body(
            "paired_hosts1", body_of(out), "paired", 1, (fq1, fq2)))
    if one["total_reads"] != 2 * paired["pairs"]:
        raise AssertionError("--hosts 1: total reads unlike 4b's")

    for name, kind, n_hosts, argv in (
            ("paired_hosts2", "paired", 2, ["paired", idx, fq1, fq2]),
            ("paired_hosts4", "paired", 4, ["paired", idx, fq1, fq2]),
            ("single_hosts2", "single", 2, ["single", idx, fq]),
            ("paired_hosts2_so", "paired", 2, ["paired", idx, fq1, fq2,
                                               "-so"])):
        out = os.path.join(tmp, f"{name}.sam")
        merged, workers, wall = hosts_cli(
            argv + ["-o", out, "-bs", str(batch)], n_hosts, device)
        got = body_of(out)
        n = merged["total_reads"] // (2 if kind == "paired" else 1)
        if kind == "single":
            if merged["total_reads"] != single["reads"]:
                raise AssertionError(f"{name}: total reads unlike 4a's")
        elif (merged["total_reads"], merged["aligned_as_pairs"]) != (
                one["total_reads"], one["aligned_as_pairs"]):
            raise AssertionError(f"{name}: merged stats unlike one "
                                 "process's")
        if name.endswith("_so"):
            check_sorted(got)
            want = body_of(os.path.join(tmp, "p.sam"))     # 4d's -so SAM
            if sorted(got) != sorted(want):
                raise AssertionError(f"{name}: not the records of the "
                                     "one-process -so SAM")
            n_diff = 0
        else:
            n_diff = check_body(name, got, kind, n_hosts,
                                (fq1, fq2) if kind == "paired" else fq)
        unit = "pairs" if kind == "paired" else "reads"
        res["runs"][name] = {
            "wall_s": wall, f"{unit}_per_s_wall": n / wall,
            f"{unit}_per_s_local": n / max(w["local_wall_s"]
                                           for w in workers),
            "local_wall_s": [w["local_wall_s"] for w in workers],
            "peak_device_bytes": [w["peak_device_bytes"] for w in workers],
            "launches": [w["launches"] for w in workers],
            "score_overflow": [w["engine_counters"].get("score_overflow")
                               for w in workers],
            "body_records_unlike_one_process": n_diff}
        log(f"hosts {name}: launcher {wall:.3f} s, {n / wall:.1f} {unit}/s "
            f"(4a/4b: {single['reads_per_s'] if kind == 'single' else paired['pairs_per_s']:.1f}); "
            f"local_wall_s {res['runs'][name]['local_wall_s']}")
    if device == "cuda":
        torch.cuda.synchronize()
    return res


# ---------------------------------------------------------------- phase 4g

@contextlib.contextmanager
def seed_lookup(mode):
    """SNAP_TPU_LOOKUP set to `mode` for the aligners built inside."""
    old = os.environ.get("SNAP_TPU_LOOKUP")
    os.environ["SNAP_TPU_LOOKUP"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["SNAP_TPU_LOOKUP"]
        else:
            os.environ["SNAP_TPU_LOOKUP"] = old


def head_fastq(src, dst, n):
    with open(src, "rb") as f:
        lines = f.read().splitlines(keepends=True)[:4 * n]
    open(dst, "wb").writelines(lines)
    return dst


def longest_chain(aligner, reads):
    """The probe-chain lookup of one batch's seeds as one straggler
    block walked one probe a window: (probes of its longest chain, lanes
    left after the unrolled rounds).  The gathers are counted; one block
    of one-probe windows makes their number the longest chain's probes
    (results do not depend on the block size or the window)."""
    from snap_rnaseq_tpu_torch.ops import lookup as lk
    st = aligner.state
    positions, _ = aligner.schedule_for(reads.shape[1])
    packed = lk.pack_seeds(reads, positions, aligner.index.seed_len)
    sizes, real = [], lk._probe

    def counted(ht, base, idx, key):
        sizes.append(idx.numel())
        return real(ht, base, idx, key)
    lk._probe, window = counted, lk.PROBE_WINDOW
    lk.PROBE_WINDOW = 1
    try:
        lk.lookup_seeds(packed, st["ht_entries"], st["shard_start"],
                        st["shard_size"], rem=packed["valid"].numel())
    finally:
        lk._probe, lk.PROBE_WINDOW = real, window
    return len(sizes), (sizes[1 + lk.UNROLLED]
                        if len(sizes) > 1 + lk.UNROLLED else 0)


def probe_phase(tmp, idx, batch, n_batches=4, device="cuda"):
    """Phase 4g: DNA single, DNA paired and RNA single on n_batches x
    batch reads under SNAP_TPU_LOOKUP=probe (paths single_probe,
    paired_probe, rna_single_probe; calls recorded) and under the default
    cuckoo lookup: the SAMs must be identical (@PG aside, which names the
    output).  Then seed_phase alone under each lookup on 4a's reads (wall
    and device ms per batch: the probe chain's from torch.profiler, K7's
    from CUDA events), the longest probe chain, peak memory."""
    import torch
    from snap_rnaseq_tpu_torch.cli import _load_index_cached
    from snap_rnaseq_tpu_torch.models.single import (SingleAligner,
                                                     schedule_on, seed_phase)
    from snap_rnaseq_tpu_torch.ops import kernels as kx
    n = n_batches * batch
    fq = head_fastq(os.path.join(tmp, f"reads{READ_LEN}.fq"),
                    os.path.join(tmp, "g_single.fq"), n)
    fq1, fq2 = (head_fastq(os.path.join(tmp, f"p{READ_LEN}_r{e}.fq"),
                           os.path.join(tmp, f"g_r{e}.fq"), n)
                for e in (1, 2))
    rna_fq = head_fastq(os.path.join(tmp, "rna_reads.fq"),
                        os.path.join(tmp, "g_rna.fq"), n)
    gtf, tidx = os.path.join(tmp, "real.gtf"), os.path.join(tmp, "tidx")
    res, calls = {}, {}
    for name, argv, path in (
            ("single_probe", ["single", idx, fq], SINGLE_PATH),
            # 4 of 4b's 16 batches launch K3: these 4 may hold none
            ("paired_probe", ["paired", idx, fq1, fq2], RESCUE_CORE),
            ("rna_single_probe", ["single", idx, tidx, gtf, rna_fq],
             SINGLE_PATH)):
        sams, row = {}, {}
        for mode in ("cuckoo", "probe"):
            out = os.path.join(tmp, f"{name}_{mode}.sam")
            # K7 is the cuckoo layout's seed phase: it launches under
            # the cuckoo lookup only
            need = tuple(k for k in path if k != "K7_seed_lookup")
            if mode == "cuckoo":
                need += ("K7_seed_lookup",)
            with seed_lookup(mode):
                _, launches, c, wall_s, peak = counted_cli(
                    argv + ["-o", out, "-bs", str(batch), "--device",
                            device], need, device)
            if mode == "probe" and launches["K7_seed_lookup"]:
                raise AssertionError(f"{name}: K7 launched under the "
                                     "probe lookup")
            if mode == "probe":
                calls[name] = c
                row["launches"] = launches
            row[f"{mode}_wall_s"] = wall_s
            row[f"{mode}_peak_device_bytes"] = peak
            sams[mode] = [l for l in open(out, "rb").read().splitlines()
                          if not l.startswith(b"@PG")]
        if sams["probe"] != sams["cuckoo"]:
            raise AssertionError(f"{name}: the SAM under the probe lookup "
                                 "differs from the cuckoo lookup's")
        row["records"] = len(sam_body(sams["probe"]))
        res[name] = row
        log(f"probe {name}: {json.dumps(row)}")

    # seed_phase alone: the engine's first phase on 4a's reads
    index = _load_index_cached(idx)
    reads, _ = fastq_codes(os.path.join(tmp, f"reads{READ_LEN}.fq"),
                           6 * batch)
    batches = [torch.from_numpy(reads[i:i + batch]).to(device)
               for i in range(0, 6 * batch, batch)]
    for mode in ("cuckoo", "probe"):
        with seed_lookup(mode):
            al = SingleAligner(index, device=device)
        positions, _ = al.schedule_for(READ_LEN)
        st = al.state
        # the positions on the card once, as the engine holds them
        pos_t = schedule_on(positions, device)
        step = lambda b: seed_phase(b, tuple(positions), index.seed_len,
                                    st["overflow"], al.genome_size, st,
                                    schedule_t=pos_t)
        if device == "cuda" and mode == "probe":
            e = engine_phase(step, batches, batch)
            res[f"seed_phase_{mode}"] = dict(
                wall_ms_per_batch=e["wall_ms_per_batch"],
                device_busy_ms_per_batch=e["device_busy_ms_per_batch"],
                device_ops_per_batch=e["device_ops_per_batch"])
        elif device == "cuda":
            # the cuckoo seed phase is one K7 launch: torch.profiler at
            # times reports no device event for a window that holds only
            # K7's launches (2 of 14 such windows on an H100), so CUDA
            # events time it, over all the batches
            every = lambda: [step(b) for b in batches]
            k0 = kx.LAUNCHES["K7_seed_lookup"]
            every()
            k7 = (kx.LAUNCHES["K7_seed_lookup"] - k0) / len(batches)
            res[f"seed_phase_{mode}"] = dict(
                wall_ms_per_batch=time_ms(every, 4) / len(batches),
                device_busy_ms_per_batch=device_ms(every, 4) / len(batches),
                k7_launches_per_batch=k7)
        if mode == "probe":
            chains = [longest_chain(al, b) for b in batches]
            res["longest_probe_chain"] = max(c[0] for c in chains)
            res["stragglers_per_batch"] = [c[1] for c in chains]
        del al, st
    log("probe seed_phase: " + json.dumps(
        {k: v for k, v in res.items() if k not in calls}))
    return res, calls


# ---------------------------------------------------------------- phase 4h

DIST_HIST_PATH = ("K1_lv_lanes",)


def distance_hist_phase(tmp, idx, device="cuda"):
    """Phase 4h: tools/distance_hist.py on 4a's SAM on the card (path
    distance_hist: K1 at e_max 31 without qualities, calls recorded) and
    on the CPU; the histograms must be identical."""
    from snap_rnaseq_tpu_torch.tools.distance_hist import distance_hist
    sam = os.path.join(tmp, f"out{READ_LEN}.sam")
    hist, launches, calls, wall_s, _ = counted_run(
        lambda: distance_hist(idx, sam, device=device), DIST_HIST_PATH,
        "distance_hist", device)
    t0 = time.time()
    cpu = distance_hist(idx, sam, device="cpu")
    cpu_s = time.time() - t0
    if not np.array_equal(hist, cpu):
        raise AssertionError("distance_hist: the card's histogram differs "
                             "from the CPU's")
    res = dict(records=int(hist.sum()), hist=hist.tolist(), wall_s=wall_s,
               cpu_s=cpu_s, launches=launches)
    log(f"distance_hist: {json.dumps(res)}")
    return res, calls


# ---------------------------------------------------------------- phase 4i

MESH_SHAPES = ((1, 2), (1, 4), (2, 2))
MESH_CORE = ("K1_lv_lanes", "K2_bitpar_packed", "K6_rowwise_front")
# the per-read results both engines give (the mesh folds its scalar
# counters into per-read vectors; truncation counts differ by design)
SINGLE_KEYS = ("result", "loc", "direction", "score", "mapq", "log_pbest",
               "log_pall", "popular")
PAIRED_KEYS = ("pair_found", "pair_score", "pair_mapq", "pair_log_pall") + \
    tuple(f"{k}{e}" for e in (0, 1)
          for k in ("result", "loc", "dir", "score", "mapq"))


@contextlib.contextmanager
def shared_partitions(seconds):
    """parallel/sharded.py partition_index memoized for the aligners built
    inside: the meshes over one index with one n_index share its slices.
    Each partition's seconds and bytes (the slices' arrays) go to
    `seconds`, keyed by the index's genome size, n_index and lookup."""
    from snap_rnaseq_tpu_torch.parallel import sharded
    real, memo = sharded.partition_index, {}

    def memoized(index, n_idx, use_cuckoo=None):
        key = (id(index), n_idx, use_cuckoo)
        if key not in memo:
            t0 = time.time()
            memo[key] = real(index, n_idx, use_cuckoo)
            seconds[f"{index.genome_size} bases, n_index {n_idx}, "
                    f"{'cuckoo' if use_cuckoo else 'probe'}"] = dict(
                s=time.time() - t0, bytes=sum(
                    a.nbytes for a in memo[key].values()))
        return memo[key]
    sharded.partition_index = memoized
    try:
        yield
    finally:
        sharded.partition_index = real


class BatchSpy:
    """Keeps every batch an aligner is handed (copies) and its device
    outputs, for checks after a pipeline's run; stop() unhooks it."""

    def __init__(self, aligner):
        self.aligner, self.calls = aligner, []
        self.real = aligner.align_batch_device
        aligner.align_batch_device = self

    def __call__(self, *args):
        out = self.real(*args)
        self.calls.append(([a.clone() for a in args], out))
        return out

    def stop(self):
        del self.aligner.align_batch_device


def fastq_batches(path, n, batch):
    """The first n records of a FASTQ as (codes, ASCII quals) uint8
    tensor pairs of `batch` rows."""
    import torch
    from snap_rnaseq_tpu_torch.utils.tables import encode_bases
    lines = open(path, "rb").read().splitlines()[:4 * n]
    codes = np.stack([encode_bases(lines[i + 1])
                      for i in range(0, len(lines), 4)])
    quals = np.stack([np.frombuffer(lines[i + 3], np.uint8)
                      for i in range(0, len(lines), 4)])
    return [(torch.from_numpy(codes[i:i + batch]),
             torch.from_numpy(quals[i:i + batch]))
            for i in range(0, n, batch)]


def rows_unlike(got, want, keys):
    """Row indices where two engines' numpy results differ on `keys`
    (log-probabilities beyond TOL)."""
    bad = np.zeros(len(want[keys[0]]), bool)
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if w.dtype == np.float32:
            both_inf = np.isneginf(g) & np.isneginf(w)
            bad |= ~both_inf & ~(np.abs(g - w) <= TOL + TOL * np.abs(w))
        else:
            bad |= g != w
    return np.flatnonzero(bad)


def single_causes(got, want):
    """(score_overflow of the single-card engine, of the mesh (its largest
    data shard's), rows whose candidate list either engine truncated)."""
    return (int(want["score_overflow"]),
            int(got["score_overflow_vec"].max()),
            (want["truncated"] > 0) | (got["truncated"] > 0))


def paired_causes(got, want):
    # the mesh's paired outputs carry no score_overflow (as in the JAX
    # package); the single-card engine's is pooled over both ends
    return (int(want["score_overflow0"]), None,
            (want["truncated0"] > 0) | (want["truncated1"] > 0)
            | (got["truncated0"] > 0) | (got["truncated1"] > 0))


def engine_gap(name, results, keys, causes):
    """Per batch of (mesh, single-card engine) results, the rows that
    differ.  A row may differ only in a batch where an engine reports
    score_overflow (the batch-cut fault, ROADMAP.md section 3), or where
    its candidate list was truncated (the mesh keeps cand_per_read
    candidates per index shard, the single-card engine cand_per_read in
    all).  Returns (per batch {rows_unlike, score_overflow [single-card,
    mesh], truncated_rows_unlike}, the set of (batch, row) that
    differ)."""
    out, unlike = [], set()
    for b, (got, want) in enumerate(results):
        rows = rows_unlike(got, want, keys)
        ov_single, ov_mesh, truncated = causes(got, want)
        out.append(dict(rows_unlike=int(rows.size),
                        score_overflow=[ov_single, ov_mesh],
                        truncated_rows_unlike=int(truncated[rows].sum())))
        unlike |= {(b, int(r)) for r in rows}
        loose = rows[~truncated[rows]]
        if loose.size and not (ov_single or ov_mesh):
            raise AssertionError(
                f"{name}, batch {b}: rows {loose[:8].tolist()} differ from "
                "the single-card engine with no score_overflow reported "
                "and no candidate list truncated")
    return out, unlike


def mesh_engine_times(step, batches, per_batch, device):
    """Wall and device-busy ms per batch (engine_phase: one warm-up
    batch, the rest timed); not measured on the CPU."""
    if device != "cuda":
        return None
    e = engine_phase(step, batches, per_batch, n_warm=1,
                     n_timed=len(batches) - 1)
    return {k: e[k] for k in ("wall_ms_per_batch",
                              "device_busy_ms_per_batch",
                              "device_idle_share", "device_ops_per_batch",
                              "kernel_ms_per_batch")}


def mesh_phase(tmp, idx, batch, n_batches=4, device="cuda"):
    """Phase 4i: parallel/sharded.py's mesh with every coordinate on the
    card, on the 64 Mb index (paths mesh_single_<shape>, mesh_paired,
    mesh_paired_sam, mesh_rna_single; calls recorded)."""
    import torch
    from snap_rnaseq_tpu_torch.cli import _load_index_cached
    from snap_rnaseq_tpu_torch.index.hash_index import GenomeIndex
    from snap_rnaseq_tpu_torch.models.paired import PairedAligner
    from snap_rnaseq_tpu_torch.models.paired_pipeline import (
        PairedEndPipeline, PairedPipelineOptions)
    from snap_rnaseq_tpu_torch.models.pipeline import PipelineOptions
    from snap_rnaseq_tpu_torch.models.single import SingleAligner, fetch
    from snap_rnaseq_tpu_torch.parallel import sharded
    from snap_rnaseq_tpu_torch.rna.pipeline import RnaSingleEndPipeline
    index = _load_index_cached(idx)
    n = n_batches * batch
    on_dev = lambda b: tuple(a.to(device) for a in b)
    reads = [on_dev(b) for b in fastq_batches(
        os.path.join(tmp, f"reads{READ_LEN}.fq"), n, batch)]
    fq1, fq2 = (os.path.join(tmp, f"p{READ_LEN}_r{e}.fq") for e in (1, 2))
    pairs = [on_dev(a + b) for a, b in zip(fastq_batches(fq1, n, batch),
                                           fastq_batches(fq2, n, batch))]
    res, calls, part_s = dict(meshes={}, seconds={}), {}, {}
    t_phase = time.time()
    stamp = lambda step: res["seconds"].__setitem__(
        step, time.time() - t_phase)      # seconds into the phase

    def counted_batches(al, batches, path, name):
        outs, launches, c, wall_s, peak = counted_run(
            lambda: [fetch(al.align_batch_device(*b)) for b in batches],
            path, name, device)
        n_fwd = al.n_data * al.n_idx * len(batches) * (len(batches[0]) // 2)
        if device == "cuda" and (launches["K2_bitpar_packed"] != n_fwd
                                 or launches["K1_lv_lanes"] < n_fwd):
            raise AssertionError(
                f"{name}: K2 forward launched {launches['K2_bitpar_packed']}"
                f" times and K1 {launches['K1_lv_lanes']}, for {n_fwd} "
                "(data x index) coordinates and ends over the batches")
        calls[name] = c
        return outs, dict(launches=launches, wall_s=wall_s,
                          peak_device_bytes=peak,
                          launches_per_batch={k: v / len(batches) for k, v
                                              in launches.items()})

    single = SingleAligner(index, device=device)
    want = [fetch(single.align_batch_device(*b)) for b in reads]
    res["single_card_engine"] = mesh_engine_times(
        lambda b: fetch(single.align_batch_device(*b)), reads, batch,
        device)
    with shared_partitions(part_s):
        for shape in MESH_SHAPES:
            name = f"mesh_single_{shape[0]}x{shape[1]}"
            al = sharded.ShardedSingleAligner(
                index, sharded.make_mesh(*shape, device=device))
            got, row = counted_batches(al, reads, MESH_CORE, name)
            row["batches"], _ = engine_gap(name, zip(got, want),
                                           SINGLE_KEYS, single_causes)
            row["engine"] = mesh_engine_times(
                lambda b: fetch(al.align_batch_device(*b)), reads, batch,
                device)
            res["meshes"][name] = row
            log(f"mesh {name}: {json.dumps(row)}")
            stamp(name)
        mesh22, got22 = al, got

        # one batch under the probe-chain lookup (no layout built): the
        # cuckoo run's results; the found seeds (n_lookups) those of the
        # single-card engine under the same lookup, whose chains are cut
        # at MAX_PROBES (ops/lookup.py)
        with seed_lookup("probe"):
            probe = sharded.ShardedSingleAligner(
                index, sharded.make_mesh(2, 2, device=device))
            probe1 = SingleAligner(index, device=device)
        got = fetch(probe.align_batch_device(*reads[0]))
        if rows_unlike(got, got22[0], SINGLE_KEYS + ("truncated",)).size:
            raise AssertionError("mesh (2, 2): results under the probe "
                                 "lookup differ from the cuckoo lookup's")
        found = lambda o: int(o["n_lookups"][::batch // 2].sum())
        res["probe_n_lookups"] = dict(
            mesh_probe=found(got), mesh_cuckoo=found(got22[0]),
            single_card_probe=int(fetch(probe1.align_batch_device(
                *reads[0]))["n_lookups"]),
            single_card_cuckoo=int(want[0]["n_lookups"]))
        log(f"mesh probe batch, seeds found: {json.dumps(res['probe_n_lookups'])}")
        stamp("probe")
        if found(got) != res["probe_n_lookups"]["single_card_probe"]:
            raise AssertionError("mesh (2, 2) under the probe lookup: not "
                                 "the single-card engine's found seeds")
        del probe, probe1

        # pairs: the engine, then PairedEndPipeline over all of 4b's pairs
        paired = PairedAligner(index, device=device)
        want_p = [fetch(paired.align_batch_device(*b)) for b in pairs]
        res["paired_card_engine"] = mesh_engine_times(
            lambda b: fetch(paired.align_batch_device(*b)), pairs, batch,
            device)
        al = sharded.ShardedPairedAligner(
            index, sharded.make_mesh(1, 4, device=device))
        got_p, row = counted_batches(al, pairs, RESCUE_CORE, "mesh_paired")
        row["batches"], _ = engine_gap("mesh_paired", zip(got_p, want_p),
                                       PAIRED_KEYS, paired_causes)
        row["engine"] = mesh_engine_times(
            lambda b: fetch(al.align_batch_device(*b)), pairs, batch, device)
        res["meshes"]["mesh_paired"] = row
        log(f"mesh mesh_paired: {json.dumps(row)}")
        stamp("mesh_paired")

        out = os.path.join(tmp, "mesh_paired.sam")
        pipe = PairedEndPipeline(index, options=PairedPipelineOptions(
            batch_size=batch), aligner=al, device=device)
        spy = BatchSpy(al)
        _, launches, calls["mesh_paired_sam"], wall_s, peak = counted_run(
            lambda: pipe.run(fq1, fq2, out), BAM_PATH, "mesh_paired_sam",
            device)
        got_sam = sam_body(open(out, "rb").read().splitlines())
        ref_sam = sam_body(open(os.path.join(tmp, f"paired{READ_LEN}.sam"),
                                "rb").read().splitlines())
        row = dict(launches=launches, wall_s=wall_s, peak_device_bytes=peak,
                   pairs=len(ref_sam) // 2)
        if got_sam != ref_sam:
            # the pairs whose records differ must be pairs whose engine
            # results differ, each with its cause (the first call is the
            # pipeline's warm-up of batch 0)
            n_b = len(ref_sam) // 2 // batch
            gap, allowed = engine_gap("mesh_paired_sam", [
                (fetch(o), fetch(paired.align_batch_device(*a)))
                for a, o in spy.calls[len(spy.calls) - n_b:]],
                PAIRED_KEYS, paired_causes)
            unlike = {divmod(i // 2, batch) for i, (a, b) in
                      enumerate(zip(got_sam, ref_sam)) if a != b}
            if len(got_sam) != len(ref_sam) or not unlike <= allowed:
                raise AssertionError("mesh_paired_sam: records differ from "
                                     "4b's where the engines agree")
            row.update(pairs_unlike_4b=len(unlike), batches=gap)
        res["meshes"]["mesh_paired_sam"] = row
        log(f"mesh mesh_paired_sam: {json.dumps(row)}")
        stamp("mesh_paired_sam")
        del al, pipe, spy, paired

        # RNA single with mesh aligners for genome and transcriptome
        tidx, gtf = os.path.join(tmp, "tidx"), os.path.join(tmp, "real.gtf")
        rna_fq = head_fastq(os.path.join(tmp, "rna_reads.fq"),
                            os.path.join(tmp, "mesh_rna.fq"), n)
        opts = PipelineOptions(batch_size=batch)
        t_index = GenomeIndex.load(tidx)
        t_mesh = sharded.ShardedSingleAligner(
            t_index, sharded.make_mesh(2, 2, device=device))
        outs = {k: os.path.join(tmp, f"mesh_rna_{k}", "r.sam")
                for k in ("stock", "mesh")}
        for p in outs.values():
            os.makedirs(os.path.dirname(p))
        t0 = time.time()
        RnaSingleEndPipeline(idx, tidx, gtf, options=opts,
                             device=device).run(rna_fq, outs["stock"])
        stock_s = time.time() - t0
        spies = BatchSpy(mesh22), BatchSpy(t_mesh)
        _, launches, calls["mesh_rna_single"], wall_s, peak = counted_run(
            lambda: RnaSingleEndPipeline(
                idx, tidx, gtf, options=opts, device=device,
                g_aligner=mesh22, t_aligner=t_mesh).run(rna_fq,
                                                        outs["mesh"]),
            SINGLE_PATH, "mesh_rna_single", device)
        for spy in spies:
            spy.stop()
        row = dict(launches=launches, wall_s=wall_s, stock_wall_s=stock_s,
                   peak_device_bytes=peak)
        files = {k: sorted(os.listdir(os.path.dirname(p)))
                 for k, p in outs.items()}
        if files["mesh"] != files["stock"]:
            raise AssertionError("mesh_rna_single: not the stock run's files")
        text = {k: {f: [l for l in open(os.path.join(os.path.dirname(p), f),
                                         "rb").read().splitlines()
                        if not l.startswith(b"@PG")] for f in files[k]}
                for k, p in outs.items()}
        sam = {k: sam_body(t["r.sam"]) for k, t in text.items()}
        if sam["mesh"] != sam["stock"]:
            # a record may differ only for a read whose genome or
            # transcriptome results differ between the engines, each with
            # its cause (engine_gap); the run files then follow the SAM
            _, names = fastq_codes(rna_fq, n)
            at = {name: i for i, name in enumerate(names)}
            allowed = set()
            for spy, ref_al in ((spies[0], single),
                                (spies[1], SingleAligner(t_index,
                                                         device=device))):
                gap, unlike = engine_gap("mesh_rna_single", [
                    (fetch(o), fetch(ref_al.align_batch_device(*a)))
                    for a, o in spy.calls], SINGLE_KEYS, single_causes)
                allowed |= unlike
                row.setdefault("batches", []).append(gap)
            unlike = set()
            for a, b in zip(sam["mesh"], sam["stock"]):
                qname = a.split(b"\t", 1)[0]
                if qname != b.split(b"\t", 1)[0]:
                    raise AssertionError("mesh_rna_single: the records' "
                                         "order differs")
                if a != b:
                    unlike.add(divmod(at[qname], batch))
            if len(sam["mesh"]) != len(sam["stock"]) or not unlike <= allowed:
                raise AssertionError("mesh_rna_single: records differ from "
                                     "the stock run's where the engines "
                                     "agree")
            row["reads_unlike_stock"] = len(unlike)
        row["run_file_lines_unlike_stock"] = {
            f: sum(a != b for a, b in zip(text["mesh"][f], text["stock"][f]))
            + abs(len(text["mesh"][f]) - len(text["stock"][f]))
            for f in files["stock"] if f != "r.sam"}
        if sam["mesh"] == sam["stock"] and any(
                row["run_file_lines_unlike_stock"].values()):
            raise AssertionError("mesh_rna_single: the SAMs agree but the "
                                 "run files do not")
        res["meshes"]["mesh_rna_single"] = row
        log(f"mesh mesh_rna_single: {json.dumps(row)}")
        stamp("mesh_rna_single")
        del t_mesh, spies, single

        # the (2, 2) mesh on the card against the same mesh on the CPU
        cpu_mesh = sharded.make_mesh(2, 2, device="cpu")
        small = reads[0][0][:64], reads[0][1][:64]
        same_tensors("mesh (2, 2) single, card / CPU",
                     mesh22.align_batch_device(*small),
                     sharded.ShardedSingleAligner(
                         index, cpu_mesh).align_batch_device(*small))
        small_p = tuple(a[:64] for a in pairs[0])
        same_tensors("mesh (2, 2) paired, card / CPU",
                     sharded.ShardedPairedAligner(
                         index, sharded.make_mesh(2, 2, device=device))
                     .align_batch_device(*small_p),
                     sharded.ShardedPairedAligner(
                         index, cpu_mesh).align_batch_device(*small_p))
    stamp("card_vs_cpu")
    res["partition_index_s"] = part_s
    log("mesh: seconds into the phase at each step's end: "
        + json.dumps(res["seconds"]))
    log(f"mesh partition_index seconds: {json.dumps(part_s)}")
    return res, calls


# ---------------------------------------------------------------- phase 4j

LIFT_ALIGN = 512                   # BASES_PER_WORD x ROW_WORDS
BIG_OFFSET_B = 2_200_000_000       # tests/test_big_locations.py's offset
DEAD_U32 = 0xFFFFFFF0              # expand_phase's dead marker -16 (u32)
BIG_BATCHES, BIG_MESH_BATCHES, BIG_CPU_ROWS = 4, 2, 64


def lift_offsets(genome_size, overflow_len):
    """A: the genome's middle at 2^31; B: every location past 2^31; C:
    the top, genome size + overflow length 1 MiB below the dead marker.
    Each a multiple of 512 bases (whole rows of packed words)."""
    a = ((1 << 31) - genome_size // 2) // LIFT_ALIGN * LIFT_ALIGN
    c = (DEAD_U32 - (1 << 20) - genome_size - overflow_len) \
        // LIFT_ALIGN * LIFT_ALIGN
    return dict(A=a, B=BIG_OFFSET_B, C=c)


def lift_values(vals, base):
    """Hash values + base, but for the empty and invalid markers."""
    from snap_rnaseq_tpu_torch.constants import (INVALID_GENOME_LOCATION,
                                                 UNUSED_HASH_VALUE)
    v = np.array(vals, np.uint32)
    lift = (v != np.uint32(INVALID_GENOME_LOCATION)) & \
        (v != np.uint32(UNUSED_HASH_VALUE))
    np.add(v, np.uint32(base), out=v, where=lift)
    return v


def overflow_locations(ovf):
    """Which overflow entries are locations: the array is [count,
    loc...] runs, whose counts stay when the genome is lifted."""
    is_loc = np.ones(ovf.size, bool)
    pos = 0
    while pos < ovf.size:
        is_loc[pos] = False
        pos += 1 + int(ovf[pos])
    return is_loc


def lift_layout(layout, base):
    """A cuckoo layout with its values lifted: buckets [key x8 | shard x8
    | val1 x8 | val2 x8], stash rows [key, shard, val1, val2]; an entry
    is occupied where its shard is not the empty marker."""
    from snap_rnaseq_tpu_torch.constants import INVALID_GENOME_LOCATION
    out = {}
    for k, v in layout.items():
        v = np.asarray(v, np.uint32).copy()
        cap = 1 if k == "ck_stash" else 8
        occ = v[:, cap:2 * cap] != np.uint32(INVALID_GENOME_LOCATION)
        for c in (2, 3):
            cols = v[:, c * cap:(c + 1) * cap]
            cols[occ] = lift_values(cols[occ], base)
        out[k] = v
    return out


def lift_index(index, base, words, is_loc, layout=None):
    """`index` with its sequence placed at `base` (tests/test_big_locations
    .py _lift_index): base padding codes, then the old codes; hash values
    and overflow locations + base, counts kept; the packed words lifted as
    whole rows of `words` (the unlifted genome's); with `layout`, the
    cuckoo layout already lifted (memoized as cuckoo_layout_for does)."""
    from snap_rnaseq_tpu_torch.index.genome import Genome
    from snap_rnaseq_tpu_torch.index.hash_index import GenomeIndex
    from snap_rnaseq_tpu_torch.ops.genome_gather import BASES_PER_WORD
    g = index.genome
    old = np.asarray(g.codes)
    codes = np.full(base + old.size, 5, np.uint8)
    codes[base:] = old
    w = np.full(base // BASES_PER_WORD + words.size, 0x55555555, np.uint32)
    w[base // BASES_PER_WORD:] = words
    ovf = np.array(index.overflow, np.uint32)
    ovf[is_loc] += np.uint32(base)
    lifted = GenomeIndex(
        genome=Genome(codes=codes, piece_names=list(g.piece_names),
                      piece_offsets=np.asarray(g.piece_offsets) + base,
                      padding=g.padding, packed_4bit=w),
        seed_len=index.seed_len, ht_keys=index.ht_keys,
        ht_val1=lift_values(index.ht_val1, base),
        ht_val2=lift_values(index.ht_val2, base),
        shard_starts=index.shard_starts, overflow=ovf,
        shard_ovf_starts=index.shard_ovf_starts)
    if layout is not None:
        object.__setattr__(lifted, "_cuckoo_layout", layout)
    return lifted


def as_u32(a):
    """Engine locations (int32 bit patterns) as unsigned values."""
    return np.asarray(a).astype(np.int32).view(np.uint32).astype(np.int64)


def held_lifted(what, got, want, base, loc_keys):
    """One lifted engine batch against the unlifted engine's: every field
    equal (log-probabilities within TOL), locations + base (mod 2^32)
    where their result is mapped."""
    import torch
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        if k in loc_keys:
            m = np.asarray(want[loc_keys[k]]) != 0
            if not (np.array_equal(as_u32(g)[m], (as_u32(w)[m] + base)
                                   % (1 << 32))
                    and np.array_equal(g[~m], w[~m])):
                raise AssertionError(f"{what}: {k} is not the unlifted "
                                     "engine's + BASE")
        elif w.dtype == np.float32:
            logp_err(f"{what} {k}", torch.from_numpy(g), torch.from_numpy(w))
        elif not np.array_equal(g, w):
            raise AssertionError(f"{what}: {k} differs from the unlifted "
                                 "engine's")


def per_read_gap(what, got, want, outs, keys=("result", "loc")):
    """Per-read-route records (in read order) against the unlifted run's:
    each record that differs must belong to a read the lifted engine
    placed past 2^31 (the int32 location the route reads; ROADMAP.md
    section 3).  Returns (records unlike, reads placed past 2^31)."""
    res = np.concatenate([np.asarray(o[keys[0]]) for o in outs])
    loc = np.concatenate([as_u32(o[keys[1]]) for o in outs])
    past = (res != 0) & (loc >= 1 << 31)
    unlike = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if len(got) != len(want) or not all(past[i] for i in unlike):
        raise AssertionError(f"{what}: records differ from the unlifted "
                             "run's for reads placed below 2^31")
    return len(unlike), int(past.sum())


def close_failed_run(exc):
    """Close the writer thread of a pipeline run that raised `exc`, as the
    run's own close() would have done: until then it keeps its last drain,
    and with it the run's aligner, on the card.  The run's frames are the
    ones below the handler's (reading the handler's locals would pin
    them)."""
    import traceback
    for frame, _ in traceback.walk_tb(exc.__traceback__.tb_next):
        w = frame.f_locals.get("writer")
        if hasattr(w, "close"):
            with contextlib.suppress(type(exc)):
                w.close()


def big_phase(tmp, idx, batch, device="cuda"):
    """Phase 4j: the 64 Mb index lifted to offsets A, B and C; the
    engines, the host routes and the mesh there against the unlifted
    runs (paths single_big and paired_big at C, rna_big and
    mesh_single_big at B; calls recorded)."""
    import gc
    import struct
    import torch
    from snap_rnaseq_tpu_torch.cli import _load_index_cached
    from snap_rnaseq_tpu_torch.index.hash_index import (GenomeIndex,
                                                        cuckoo_layout_for)
    from snap_rnaseq_tpu_torch.models.paired import PairedAligner
    from snap_rnaseq_tpu_torch.models.paired_pipeline import (
        PairedEndPipeline, PairedPipelineOptions)
    from snap_rnaseq_tpu_torch.models.pipeline import (PipelineOptions,
                                                       SingleEndPipeline)
    from snap_rnaseq_tpu_torch.models.single import SingleAligner, fetch
    from snap_rnaseq_tpu_torch.ops.genome_gather import pack_genome_4bit
    from snap_rnaseq_tpu_torch.parallel import sharded
    from snap_rnaseq_tpu_torch.rna.pipeline import RnaSingleEndPipeline
    t_phase = time.time()
    index = _load_index_cached(idx)
    n = BIG_BATCHES * batch
    on_dev = lambda b: tuple(a.to(device) for a in b)
    rfq = os.path.join(tmp, f"reads{READ_LEN}.fq")
    reads = [on_dev(b) for b in fastq_batches(rfq, n, batch)]
    fq1, fq2 = (os.path.join(tmp, f"p{READ_LEN}_r{e}.fq") for e in (1, 2))
    pairs = [on_dev(a + b) for a, b in zip(fastq_batches(fq1, n, batch),
                                           fastq_batches(fq2, n, batch))]
    gs = index.genome_size
    offs = lift_offsets(gs, index.overflow.size)
    t0 = time.time()
    words = pack_genome_4bit(np.asarray(index.genome.codes))
    layout = cuckoo_layout_for(index)
    is_loc = overflow_locations(np.asarray(index.overflow))
    res = dict(offsets=offs, genome_size=gs,
               overflow_len=int(index.overflow.size),
               prepare_s=time.time() - t0, at={})
    calls, launches_by = {}, {}
    engine_times = lambda step, batches: mesh_engine_times(
        step, batches, batch, device)

    # the unlifted engines, the per-read runs to compare with, and the
    # transcriptome aligner shared by every RNA run
    single, paired = (SingleAligner(index, device=device),
                      PairedAligner(index, device=device))
    want_s = [fetch(single.align_batch_device(*b)) for b in reads]
    want_p = [fetch(paired.align_batch_device(*b)) for b in pairs]
    res["unlifted"] = dict(
        single=engine_times(lambda b: fetch(single.align_batch_device(*b)),
                            reads),
        paired=engine_times(lambda b: fetch(paired.align_batch_device(*b)),
                            pairs))
    single_fq = head_fastq(rfq, os.path.join(tmp, "big_reads.fq"), n)
    single_ref = sam_body(open(os.path.join(tmp, f"out{READ_LEN}.sam"),
                               "rb").read().splitlines())[:n]
    rna_fq = head_fastq(os.path.join(tmp, "rna_reads.fq"),
                        os.path.join(tmp, "big_rna.fq"), n)
    gtf = os.path.join(tmp, "real.gtf")
    t_index = GenomeIndex.load(os.path.join(tmp, "tidx"))
    t_al = SingleAligner(t_index, device=device)
    opts = PipelineOptions(batch_size=batch)

    def rna_run(g_index, g_al, name):
        d = os.path.join(tmp, f"big_rna_{name}")
        os.makedirs(d)
        out = os.path.join(d, "r.sam")
        RnaSingleEndPipeline(g_index, t_index, gtf, options=opts,
                             device=device, g_aligner=g_al,
                             t_aligner=t_al).run(rna_fq, out)
        text = {f: [l for l in open(os.path.join(d, f), "rb").read()
                    .splitlines() if not l.startswith(b"@PG")]
                for f in sorted(os.listdir(d))}
        return sam_body(text.pop("r.sam")), text
    stock, stock_files = rna_run(index, single, "stock")
    del single, paired
    res["seconds_to_unlifted"] = time.time() - t_phase

    for name in ("A", "B", "C"):
        base = offs[name]
        row = dict(base=base)
        t0 = time.time()
        lifted = lift_index(index, base, words, is_loc,
                            None if name == "A" else lift_layout(layout,
                                                                 base))
        row["lift_s"] = time.time() - t0
        row["host_genome_bytes"] = int(lifted.genome.codes.nbytes)
        row["packed_genome_bytes"] = int(lifted.genome.packed_4bit.nbytes)
        if name == "A":
            # the real functions on the lifted index, once: the layout of
            # the lifted values and the chunked packer over 2.1e9 bases
            t0 = time.time()
            built = cuckoo_layout_for(lifted)
            row["layout_s"] = time.time() - t0
            for k, v in lift_layout(layout, base).items():
                if not np.array_equal(built[k], v):
                    raise AssertionError(f"A: cuckoo_layout_for {k} is not "
                                         "the lifted layout")
            t0 = time.time()
            if not np.array_equal(pack_genome_4bit(lifted.genome.codes),
                                  lifted.genome.packed_4bit):
                raise AssertionError("A: pack_genome_4bit of the lifted "
                                     "codes is not the lifted words")
            row["pack_s"] = time.time() - t0
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            row["device_bytes_held_before"] = torch.cuda.memory_allocated()
        t0 = time.time()
        sal = SingleAligner(lifted, device=device)
        pal = PairedAligner(lifted, device=device)
        row["aligners_s"] = time.time() - t0
        for what, al, batches, want, path, keys in (
                ("single", sal, reads, want_s, MESH_CORE, {"loc": "result"}),
                ("paired", pal, pairs, want_p, RESCUE_CORE,
                 {"loc0": "result0", "loc1": "result1"})):
            got, launches, c, wall_s, _ = counted_run(
                lambda: [fetch(al.align_batch_device(*b)) for b in batches],
                path, f"{what}_big {name}", device)
            for i, (g, w) in enumerate(zip(got, want)):
                held_lifted(f"{what} at {name}, batch {i}", g, w, base, keys)
            if name == "C":
                calls[f"{what}_big"] = c
                launches_by[f"{what}_big"] = launches
            row[what] = dict(launches=launches, wall_s=wall_s,
                             engine=engine_times(
                                 lambda b: fetch(al.align_batch_device(*b)),
                                 batches))

        if name in ("A", "B"):
            # the bulk route: every pair of 4b to plain SAM, 4d's sorted
            # SAM; byte for byte the unlifted runs' records
            for kind, so, ref_name in (("sam", False, f"paired{READ_LEN}.sam"),
                                       ("so_sam", True, "p.sam")):
                out = os.path.join(tmp, f"big_{name}_{kind}.sam")
                _, launches, _, wall_s, _ = counted_run(
                    lambda: PairedEndPipeline(
                        lifted, options=PairedPipelineOptions(
                            batch_size=batch, sorted_output=so),
                        aligner=pal).run(fq1, fq2, out),
                    RESCUE_CORE if so else BAM_PATH, f"bulk {kind}", device)
                got = sam_body(open(out, "rb").read().splitlines())
                want = sam_body(open(os.path.join(tmp, ref_name), "rb")
                                .read().splitlines())
                if got != want:
                    raise AssertionError(f"{name}: the bulk route's {kind} "
                                         "differs from the unlifted run's")
                row[f"bulk_{kind}"] = dict(pairs=len(got) // 2,
                                           wall_s=wall_s, launches=launches)
            # the per-read route: -so BAM packs POS as int32 and raises on
            # a location past 2^31 read as int32 (shared fault)
            try:
                PairedEndPipeline(lifted, options=PairedPipelineOptions(
                    batch_size=batch, sorted_output=True),
                    aligner=pal).run(fq1, fq2,
                                     os.path.join(tmp, f"big_{name}.bam"))
                raise AssertionError(f"{name}: -so BAM ran to its end")
            except struct.error as e:
                row["so_bam"] = f"struct.error: {e}"
                close_failed_run(e)
            # DNA single and RNA single on the per-read route
            spy = BatchSpy(sal)
            out = os.path.join(tmp, f"big_{name}_single.sam")
            SingleEndPipeline(lifted, options=opts, aligner=sal).run(
                single_fq, out)
            spy.stop()
            got = sam_body(open(out, "rb").read().splitlines())
            unlike, past = per_read_gap(
                f"{name}: DNA single", got, single_ref,
                [fetch(o) for _, o in spy.calls])
            row["single_per_read"] = dict(records=len(got),
                                          records_unlike=unlike,
                                          reads_past_2_31=past)
            spy = BatchSpy(sal)
            (got, files), launches, c, wall_s, _ = counted_run(
                lambda: rna_run(lifted, sal, name), SINGLE_PATH,
                f"rna_big {name}", device)
            spy.stop()
            if name == "B":
                calls["rna_big"], launches_by["rna_big"] = c, launches
            order = lambda body: [l.split(b"\t", 1)[0] for l in body]
            if order(got) != order(stock):
                raise AssertionError(f"{name}: RNA single's records are "
                                     "not in the stock run's order")
            # one record a read: read i's record differs only if the
            # genome engine placed read i past 2^31
            unlike, past = per_read_gap(
                f"{name}: RNA single", got, stock,
                [fetch(o) for _, o in spy.calls])
            row["rna_single_per_read"] = dict(
                records=len(got), records_unlike=unlike,
                reads_genome_past_2_31=past, wall_s=wall_s,
                launches=launches,
                run_file_lines_unlike={
                    f: sum(a != b for a, b in zip(files[f], stock_files[f]))
                    + abs(len(files[f]) - len(stock_files[f]))
                    for f in stock_files})

        if name == "B":
            # the card against the CPU, and the (1, 2) mesh
            small = reads[0][0][:BIG_CPU_ROWS], reads[0][1][:BIG_CPU_ROWS]
            same_tensors("B: single, card / CPU",
                         sal.align_batch_device(*small),
                         SingleAligner(lifted, device="cpu")
                         .align_batch_device(*(a.cpu() for a in small)))
            small_p = tuple(a[:BIG_CPU_ROWS] for a in pairs[0])
            same_tensors("B: paired, card / CPU",
                         pal.align_batch_device(*small_p),
                         PairedAligner(lifted, device="cpu")
                         .align_batch_device(*(a.cpu() for a in small_p)))
            t0 = time.time()
            mesh = sharded.ShardedSingleAligner(
                lifted, sharded.make_mesh(1, 2, device=device))
            row["mesh_build_s"] = time.time() - t0
            mb = reads[:BIG_MESH_BATCHES]
            got, launches, c, wall_s, _ = counted_run(
                lambda: [fetch(mesh.align_batch_device(*b)) for b in mb],
                MESH_CORE, "mesh_single_big", device)
            calls["mesh_single_big"] = c
            launches_by["mesh_single_big"] = launches
            ref = [fetch(sal.align_batch_device(*b)) for b in mb]
            gap, _ = engine_gap("mesh_single_big", zip(got, ref),
                                SINGLE_KEYS, single_causes)
            row["mesh_1x2"] = dict(launches=launches, wall_s=wall_s,
                                   batches=gap, engine=engine_times(
                                       lambda b: fetch(
                                           mesh.align_batch_device(*b)),
                                       mb))
            del mesh
        if device == "cuda":
            row["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        res["at"][name] = row
        log(f"big {name}: {json.dumps(row)}")
        spy = None
        del sal, pal, al, lifted
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    res["phase_s"] = time.time() - t_phase
    return res, calls, launches_by


# ---------------------------------------------------------------- phase 4k

# HG_SCALE.json's table counts, which depend on the genome, the seed length
# and the load factor alone: the card's build must give them exactly
HG_EXACT = ("total_slots", "occupied_slots", "overflow_entries", "ht_bytes",
            "overflow_bytes")
HG_FLOORS = dict(recall0=0.97, recall1=0.97, pair_found_rate=0.99)
HG_COUNTS = ("pos0_ok", "pos1_ok", "pair_found", "both_pos_ok",
             "truncated0", "truncated1", "mapq_ge10_ok", "mapq_ge10")
HG_PATH = ("K1_lv_lanes", "K2_bitpar_packed", "K2_bitpar_rescue",
           "K6_rowwise_front")


def hg_genome(t_start):
    """A future of phase 4k's genome and its seconds, started when phase 2
    starts: 24 pieces made by worker processes on half the host's cores,
    so that the host-clock numbers of the phases it overlaps keep the
    other half; it logs when it ends, in seconds into the script."""
    from concurrent.futures import ThreadPoolExecutor
    from snap_rnaseq_tpu_torch.tools import hg_scale as hs

    def timed():
        t0 = time.time()
        genome = hs.synth_genome(
            workers=max(1, (os.cpu_count() or 2) // 2), log=None)
        done = time.time()
        log(f"hg genome made in {done - t0:.1f} s, {done - t_start:.1f} s "
            "into the script")
        return genome, done - t0
    pool = ThreadPoolExecutor(1)
    future = pool.submit(timed)
    pool.shutdown(wait=False)         # its one task still runs to its end
    return future


def hg_phase(genome_future, device="cuda"):
    """Phase 4k: tools/hg_scale.py at full size on the card.  The
    3,200,012,492-base genome (24 pieces, made by hg_genome), its seed-20
    index built on the card into 8 slices, held to HG_SCALE.json's table
    counts exactly; the
    lookup check (every sampled position among its seed's hits, the lists
    descending); 100,000 wgsim pairs through ShardedPairedAligner on a
    (1, 8) mesh on this card (path `hg`, counters zeroed just before and
    read just after, calls recorded), the statistics beside
    HG_ALIGN.json's, with recall and pair-rate floors; one batch's wall
    and busy ms; peak device bytes (build and align) under the card's
    memory; peak host RSS."""
    import gc
    import itertools
    import torch
    from snap_rnaseq_tpu_torch.tools import hg_scale as hs
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.time()
    res = {}
    with open(os.path.join(ROOT, "HG_SCALE.json")) as f:
        hg_scale = json.load(f)
    with open(os.path.join(ROOT, "HG_ALIGN.json")) as f:
        hg_align = json.load(f)
    t0 = time.time()
    genome, res["synth_s"] = genome_future.result()
    res["synth_wait_s"] = time.time() - t0
    log(f"hg: {genome.num_bases:,} bases in {res['synth_s']:.1f} s (made "
        f"beside phases 2-4j; {res['synth_wait_s']:.1f} s waited here)")
    with hs.PeakRSS() as rss:
        di, build = hs.build(genome, device, log=log)
        res["build"] = build
        log("hg build: " + json.dumps(build))
        res["hg_scale_json"] = {k: hg_scale[k] for k in (
            *HG_EXACT, "synth_s", "build_s", "build_bases_per_s", "host")}
        off = {k: [build[k], hg_scale[k]] for k in HG_EXACT
               if build[k] != hg_scale[k]}
        if off:
            raise AssertionError(f"hg tables unlike HG_SCALE.json: {off}")
        res["check"] = check = hs.check(di, log=log)
        if check["missing"] or not check["overflow_descending"]:
            raise AssertionError(f"hg lookup check failed: {check}")
        t0 = time.time()
        aligner = hs.make_aligner(di, device)
        res["aligner_s"] = time.time() - t0
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()   # build, check, aligner
        stats, launches, calls, res["align_run_s"], align_peak = counted_run(
            lambda: hs.align(aligner, genome, log=log), HG_PATH, "hg")
        res["align"] = stats
        res["launches"] = launches
        res["vs_hg_align_json"] = side = {
            k: [stats[k], hg_align[k]] for k in hg_align
            if k in stats and isinstance(hg_align[k], (int, float))}
        res["counts_apart_over_half_percent"] = {
            k: side[k] for k in HG_COUNTS
            if abs(side[k][0] - side[k][1]) > 0.005 * abs(side[k][1])}
        low = {k: stats[k] for k, v in HG_FLOORS.items() if stats[k] < v}
        if low:
            raise AssertionError(f"hg align under its floors {HG_FLOORS}: "
                                 f"{low}")
        batches = [b[1] for b in itertools.islice(
            hs.pair_batches(genome, hs.BATCH * 5), 5)]
        res["engine"] = engine_phase(lambda b: aligner.align_batch(*b),
                                     batches, hs.BATCH, n_warm=1, n_timed=2)
        peak = max(peak, align_peak, torch.cuda.max_memory_allocated())
    res["peak_device_bytes"] = peak
    res["peak_device_reserved_bytes"] = torch.cuda.max_memory_reserved()
    res["device_memory_bytes"] = torch.cuda.get_device_properties(
        0).total_memory
    if peak >= res["device_memory_bytes"]:
        raise AssertionError(f"hg peak device bytes {peak} past the card's "
                             f"{res['device_memory_bytes']}")
    res["peak_host_rss_bytes"] = rss.peak
    del aligner, di, genome, batches
    gc.collect()
    torch.cuda.empty_cache()
    res["phase_s"] = time.time() - t_phase
    return res, calls


# ---------------------------------------------------------------- phase 4l

# the bench tools' main paths: tools/bench.py's stages, engine_ab's
# configurations and phase_profile's flat phases at cand 128 and 64, with
# the kernels each must launch; the other stages (engine_ab's default and
# se, which bench_pe and the single-end engines' paths cover,
# phase_profile's paired phases, op_profile) run uncounted
SE_CORE = ("K1_lv_lanes", "K2_bitpar_packed", "K6_rowwise_front")
ONEHOT_RESCUE = ("K5_lv_onehot", "K2_bitpar_packed", "K2_bitpar_rescue",
                 "K6_rowwise_front")
TOOL_PATHS = {
    ("bench", "pe"): ("bench_pe", RESCUE_CORE),
    ("bench", "se"): ("bench_se", SE_CORE),
    ("bench", "sam"): ("bench_sam", BAM_PATH),
    ("ab", "norescue"): ("ab_norescue", SE_CORE),
    ("ab", "onehot"): ("ab_onehot", ONEHOT_RESCUE),
    ("ab", "b2048"): ("ab_b2048", RESCUE_CORE),
    ("ab", "cand128"): ("ab_cand128", RESCUE_CORE),
    ("profile128", "flat"): ("profile_flat", FLAT_PATH),
    ("profile64", "flat"): ("profile_flat64", FLAT_PATH),
}
# 4l's depth, cut to keep the script inside its time limit: the bench's
# windows (its default 5), engine_ab's (5) and phase_profile's calls (32);
# the width stays: batches of 1,024 pairs of 100 bases, the 64 Mb index
BENCH_WINDOWS = 3
AB_WINDOWS = 2
PROFILE_CALLS = 4
OP_PROFILE_BATCHES = 4


def host_op_us(n=20_000):
    """The host's microseconds a tiny eager operation on the card (n adds
    on 16 numbers, one synchronize), the threads alive and the objects the
    garbage collector tracks: read early and late in the script, they
    show whether the process's own state slows the engines' dispatch."""
    import gc
    import threading
    import torch
    x = torch.zeros(16, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(n):
        x = x + 1
    torch.cuda.synchronize()
    return dict(us_per_op=(time.time() - t0) * 1e6 / n,
                threads=threading.active_count(),
                gc_objects=len(gc.get_objects()))


def tools_phase(tmp, idx, device="cuda"):
    """Phase 4l: the bench tools on phase 4's index, which is bench.py's
    index exactly (hg_like_genome(64e6, seed=0) at seed length 20): bench
    (paired, single-end, FASTQ to SAM), engine_ab's configurations (all),
    phase_profile at cand 128 and 64, op_profile; at the depths above.
    One device copy of the index serves every tool.  Each stage on a path
    of TOOL_PATHS runs through counted_run.  Returns (the tools' output,
    {path: launches}, {path: calls})."""
    import torch
    from snap_rnaseq_tpu_torch.index.hash_index import GenomeIndex
    from snap_rnaseq_tpu_torch.models.paired import PairedAligner
    from snap_rnaseq_tpu_torch.tools import (bench, engine_ab, op_profile,
                                             phase_profile)
    launches, calls, secs = {}, {}, {}

    def stage_of(tool):
        def stage(name, fn):
            path = TOOL_PATHS.get((tool, name))
            if path is None:
                return fn()
            res, launches[path[0]], calls[path[0]], _, _ = counted_run(
                fn, path[1], path[0], device)
            return res
        return stage

    host = host_op_us()
    log(f"host before 4l: {json.dumps(host)}")
    t0 = time.time()
    index = GenomeIndex.load(idx)
    base = PairedAligner(index, device=device, cand_per_read=64)
    secs["load"] = time.time() - t0
    t0 = time.time()
    sam_dir = os.path.join(tmp, "bench_sam")
    b = bench.run(index, device=device, windows=BENCH_WINDOWS, base=base,
                  sam_dir=sam_dir, stage=stage_of("bench"),
                  index_source="phase 4's index")
    secs["bench"] = time.time() - t0
    x = b["extra"]
    n_reads = 2 * x["batch_pairs"] * 3
    if x["fraction_pairs_found"] < 0.95 or \
            x["single_end"]["fraction_aligned"] < 0.95:
        raise AssertionError(f"bench: pairs found {x['fraction_pairs_found']}"
                             f", single-end aligned "
                             f"{x['single_end']['fraction_aligned']}")
    n_sam = len(check_valid(os.path.join(sam_dir, "out.sam")))
    if n_sam != n_reads:
        raise AssertionError(f"bench SAM: {n_sam} records, {n_reads} reads")
    check_lanes_kernel("bits", launches["bench_pe"], "bench_pe")
    t0 = time.time()
    ab = [engine_ab.run_config(n, index, base, windows=AB_WINDOWS,
                               stage=stage_of("ab"))
          for n in engine_ab.ALL]
    secs["engine_ab"] = time.time() - t0
    check_lanes_kernel("onehot", launches["ab_onehot"], "ab_onehot")
    found = {l["config"]: l["found_share"] for l in ab}
    if found["onehot"] != found["default"] or min(found.values()) < 0.95:
        raise AssertionError(f"engine_ab found shares {found}")
    prof = {}
    for cpr in (128, 64):
        t0 = time.time()
        prof[cpr] = phase_profile.run(
            index, device=device, cand_per_read=cpr, calls=PROFILE_CALLS,
            base=base, stage=stage_of(f"profile{cpr}"))[0]
        secs[f"phase_profile{cpr}"] = time.time() - t0
    t0 = time.time()
    ops = op_profile.run(index, device=device, base=base,
                         n_batches=OP_PROFILE_BATCHES)
    secs["op_profile"] = time.time() - t0
    if abs(sum(ops["rollup"].values()) - ops["self_ms_per_batch"]) > 1e-6 * \
            ops["self_ms_per_batch"]:
        raise AssertionError("op_profile's categories do not sum to its "
                             "total")
    del base, index
    torch.cuda.empty_cache()
    return dict(bench=b, engine_ab=ab, phase_profile=prof, op_profile=ops,
                seconds=secs, sam_records=n_sam, host=host), launches, calls


# ---------------------------------------------------------------- phase 4c

RNA_GENES = 1300
ONEHOT_PATH = ("K5_lv_onehot", "K2_bitpar_packed", "K3_lv_cigar",
               "K6_rowwise_front")


def rna_annotation(n_bases, rng):
    """Genes at the density of the human GENCODE annotation scaled to the
    genome (about 20,000 protein-coding genes over 3.1 Gb: about 1,300
    over 64 Mb), one per 1/1300 of the chromosome, on both strands: 3-12
    exons of 80-400 bp with introns of 150-2,500 bp, and 2-6 isoforms per
    gene (about 4), each a subset of at least two of its gene's exons."""
    slot = n_bases // RNA_GENES
    transcripts = []
    for gi in range(RNA_GENES):
        n_ex = int(rng.integers(3, 13))
        lens = rng.integers(80, 401, n_ex)
        gaps = rng.integers(150, 2501, n_ex)
        gaps[0] = rng.integers(1000, 5000)
        starts = (gi * slot + np.cumsum(gaps)
                  + np.concatenate([[0], np.cumsum(lens[:-1])]))
        exons = [(int(a) + 1, int(a + n)) for a, n in zip(starts, lens)]
        strand = "+" if rng.random() < 0.5 else "-"
        for ti in range(int(rng.integers(2, 7))):
            keep = rng.random(n_ex) < 0.7
            if keep.sum() < 2:
                keep[[0, -1]] = True
            transcripts.append((f"G{gi}", f"T{gi}.{ti}", "ref", strand,
                                [e for e, k in zip(exons, keep) if k]))
    return transcripts


def spliced(codes, transcripts):
    """Each transcript's sequence and the 0-based genome position of each
    of its bases (the transcriptome's exons are in genome order)."""
    out = []
    for *_, exons in transcripts:
        pos = np.concatenate([np.arange(s - 1, e) for s, e in exons])
        out.append((codes[pos], pos))
    return out


def rna_single_reads(codes, tx, n, rng):
    """80% cut from transcripts (a random transcript of at least 108
    bases, a random offset, so many reads span a junction), 20% genomic;
    5% with a 1-3 base indel, half reverse-complemented.  Returns (true
    0-based genome start, spliced, codes)."""
    long_tx = [t for t in tx if t[0].size >= READ_LEN + 8]
    out = []
    for _ in range(n):
        if rng.random() < 0.8:
            seq, pos = long_tx[int(rng.integers(0, len(long_tx)))]
            o = int(rng.integers(0, seq.size - READ_LEN - 8 + 1))
            seg, start = seq[o:o + READ_LEN + 8], int(pos[o])
            spl = int(pos[o + READ_LEN - 1]) - start != READ_LEN - 1
        else:
            start = int(rng.integers(1000, codes.size - READ_LEN - 1000))
            seg, spl = codes[start:start + READ_LEN + 8], False
        r = mutate(seg, rng, 0.05)
        if rng.random() < 0.5:
            r = (3 - r[::-1]).astype(np.uint8)
        out.append((start, spl, r))
    return out


def rna_pairs(tx, n, rng):
    """FR pairs from transcript fragments of 200-400 bases: end 0 the
    fragment's first 100 bases, end 1 the reverse complement of its last
    100; ~1% substitutions, 5% of the ends with an indel.  Returns (true
    0-based genome start of each end, codes of each end)."""
    long_tx = [t for t in tx if t[0].size >= 208]
    out = []
    for _ in range(n):
        seq, pos = long_tx[int(rng.integers(0, len(long_tx)))]
        ins = int(rng.integers(200, min(400, seq.size - 8) + 1))
        o = int(rng.integers(0, seq.size - ins - 8 + 1))
        e0 = mutate(seq[o:o + READ_LEN + 8], rng, 0.05)
        b = o + ins - READ_LEN
        e1 = mutate(seq[b:b + READ_LEN + 8], rng, 0.05)
        out.append((int(pos[o]), int(pos[b]), e0,
                    (3 - e1[::-1]).astype(np.uint8)))
    return out


def sam_shares(path, truth_of, n_expected):
    """(aligned records, records with an N, records within two read
    lengths of their true start) over the SAM's records;
    truth_of(qname, flag) gives the true 0-based start."""
    n_al = n_n = n_true = 0
    for line in open(path):
        if line.startswith("@"):
            continue
        f = line.split("\t", 6)
        flag = int(f[1])
        if flag & 4:
            continue
        n_al += 1
        n_n += "N" in f[5]
        if abs(int(f[3]) - 1 - truth_of(f[0], flag)) <= 2 * READ_LEN:
            n_true += 1
    return n_al / n_expected, n_n / max(n_al, 1), n_true / n_expected


def sam_records(path):
    return [l for l in open(path) if not l.startswith("@PG")]


def rna_real_phase(tmp, codes, idx, index_s, n_reads, n_pairs, batch):
    """Phase 4c: the annotation, its transcriptome through the CLI, then
    RNA single (default and onehot) and RNA paired, counters zeroed and
    calls recorded around each run."""
    from snap_rnaseq_tpu_torch.utils.tables import decode_bases
    rng = np.random.default_rng(20261018)
    transcripts = rna_annotation(codes.size, rng)
    gtf = os.path.join(tmp, "real.gtf")
    write_gtf(gtf, transcripts)
    tidx = os.path.join(tmp, "tidx")
    t0 = time.time()
    argv = ["transcriptome", gtf, os.path.join(tmp, "hg_like.fa")]
    run_cli([*argv, tidx])
    tx_s = time.time() - t0
    cpu_s = same_build_on_cpu(argv, tidx)
    tx = spliced(codes, transcripts)
    log(f"transcriptome: {len(transcripts)} transcripts, "
        f"{sum(t[0].size for t in tx)} bases in {tx_s:.3f} s on the card, "
        f"{cpu_s:.3f} s with --device cpu (files byte-identical)")

    reads = rna_single_reads(codes, tx, n_reads, rng)
    fq = os.path.join(tmp, "rna_reads.fq")
    with open(fq, "wb") as f:
        for i, (s, spl, r) in enumerate(reads):
            f.write(b"@r%d_%d_%d\n" % (i, s, spl) + decode_bases(r)
                    + b"\n+\n" + b"I" * READ_LEN + b"\n")
    truth = lambda q, flag: int(q.split("_")[1])
    res, calls = {}, {}
    for name, impl, path in (("rna_single", "bits", SINGLE_PATH),
                             ("rna_single_onehot", "onehot", ONEHOT_PATH)):
        out = os.path.join(tmp, f"{name}.sam")
        perf = os.path.join(tmp, f"{name}.tsv")
        with lv_lanes_impl(impl):
            stdout, launches, calls[name], wall_s, peak = counted_cli(
                ["single", idx, tidx, gtf, fq, "-o", out, "-bs", str(batch),
                 "--device", "cuda", "-pf", perf], path)
        check_lanes_kernel(impl, launches, name)
        total, align_s = perf_row(perf)
        al, n_share, at = sam_shares(out, truth, total)
        res[name] = dict(reads=total, align_s=align_s,
                         reads_per_s=total / align_s, wall_s=wall_s,
                         aligned_share=al, spliced_record_share=n_share,
                         at_origin_share=at,
                         spliced_read_share=sum(r[1] for r in reads) / total,
                         index_build_s=index_s, transcriptome_build_s=tx_s,
                         peak_device_bytes=peak, launches=launches,
                         wait_profile=wait_line(stdout))
        if at < 0.8:
            raise AssertionError(f"{name}: only {at:.3f} of reads placed "
                                 "at their origin")
    if sam_records(os.path.join(tmp, "rna_single.sam")) != sam_records(
            os.path.join(tmp, "rna_single_onehot.sam")):
        raise AssertionError("RNA single: the SAM under onehot (K5) "
                             "differs from the default run's (K1)")

    pairs = rna_pairs(tx, n_pairs, rng)
    fq1, fq2 = (os.path.join(tmp, "rna_r1.fq"),
                os.path.join(tmp, "rna_r2.fq"))
    with open(fq1, "wb") as f0, open(fq2, "wb") as f1:
        for i, (t0_, t1_, a, b) in enumerate(pairs):
            rid = b"@q%d_%d_%d" % (i, t0_, t1_)
            f0.write(rid + b"/1\n" + decode_bases(a) + b"\n+\n"
                     + b"I" * READ_LEN + b"\n")
            f1.write(rid + b"/2\n" + decode_bases(b) + b"\n+\n"
                     + b"I" * READ_LEN + b"\n")
    out = os.path.join(tmp, "rna_paired.sam")
    perf = os.path.join(tmp, "rna_paired.tsv")
    stdout, launches, calls["rna_paired"], wall_s, peak = counted_cli(
        ["paired", idx, tidx, gtf, fq1, fq2, "-o", out, "-bs", str(batch),
         "--device", "cuda", "-pf", perf], PAIRED_PATH)
    total, align_s = perf_row(perf)
    truth = lambda q, flag: int(q.split("_")[1 + (0 if flag & 0x40 else 1)])
    al, n_share, at = sam_shares(out, truth, total)
    res["rna_paired"] = dict(
        pairs=total // 2, align_s=align_s, pairs_per_s=total / 2 / align_s,
        wall_s=wall_s, aligned_share=al, spliced_record_share=n_share,
        at_origin_share=at, index_build_s=index_s,
        transcriptome_build_s=tx_s, peak_device_bytes=peak,
        launches=launches, wait_profile=wait_line(stdout))
    if at < 0.8:
        raise AssertionError(f"rna_paired: only {at:.3f} of ends placed at "
                             "their origin")
    res["rna_paired"]["t_engine"] = rna_t_engine_phase(
        tidx, np.stack([p[2] for p in pairs]), batch)
    return res, calls


def rna_t_engine_phase(tidx, codes, batch):
    """RNA paired's transcriptome engine alone, as the pipeline builds it
    at the paired defaults and -tmh 1000 (2,000 candidate slots and 1,000
    multi-hits per read), on end 0 of the first six batches of pairs
    (engine_phase), with its peak device memory."""
    import torch
    from snap_rnaseq_tpu_torch.constants import PAIRED_DEFAULTS as d
    from snap_rnaseq_tpu_torch.index.hash_index import GenomeIndex
    from snap_rnaseq_tpu_torch.models.single import SingleAligner, fetch
    aligner = SingleAligner(
        GenomeIndex.load(tidx), device="cuda", max_k=d["max_dist"],
        max_hits=d["max_hits"], num_seeds=d["num_seeds"],
        cand_per_read=2000, max_hits_to_get=1000)
    quals = torch.full((batch, READ_LEN), ord("I"), dtype=torch.uint8,
                       device="cuda")
    batches = [codes[i * batch:(i + 1) * batch] for i in range(6)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = engine_phase(lambda b: fetch(aligner.align_batch_device(
        torch.from_numpy(b).cuda(), quals)), batches, batch)
    res["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    return res


def engine_phase(step, batches, per_batch, n_warm=2, n_timed=4):
    """An engine alone: `step(batch)` dispatches one batch and fetches its
    outputs, as the pipeline does.  After n_warm batches, n_timed batches
    are timed on the host's clock and the same n_timed again under
    torch.profiler (tools/measure.py device_profile), whose device events
    give the busy time (kernels and copies summed), the operation count
    and each kernel's time and events."""
    import torch
    from snap_rnaseq_tpu_torch.tools.measure import device_profile

    def run(group):
        for b in group:
            step(b)
        torch.cuda.synchronize()

    run(batches[:n_warm])
    timed = batches[n_warm:n_warm + n_timed]
    t0 = time.time()
    run(timed)
    wall_ms = (time.time() - t0) * 1e3 / n_timed
    prof = device_profile(lambda: run(timed), n_timed, torch.device("cuda"))
    busy_ms = prof["device_busy_ms"]
    return dict(batch=per_batch, wall_ms_per_batch=wall_ms,
                per_s=per_batch * 1e3 / wall_ms,
                device_busy_ms_per_batch=busy_ms,
                device_idle_share=1.0 - busy_ms / wall_ms,
                device_ops_per_batch=prof["device_ops"],
                kernel_ms_per_batch=prof["kernel_ms"],
                kernel_events_per_batch=prof["kernel_events"])


def single_engine_phase(idx, codes, batch, genome):
    """SingleAligner.align_batch_device + fetch on the first batches of
    the single-end reads; then K7 at the cells' batches on the same index
    (k7_cells)."""
    import torch
    from snap_rnaseq_tpu_torch.index.hash_index import GenomeIndex
    from snap_rnaseq_tpu_torch.models.single import SingleAligner, fetch
    aligner = SingleAligner(GenomeIndex.load(idx), device="cuda")
    quals = torch.full((batch, READ_LEN), ord("I"), dtype=torch.uint8,
                       device="cuda")
    batches = [codes[i * batch:(i + 1) * batch] for i in range(6)]
    res = engine_phase(lambda b: fetch(aligner.align_batch_device(
        torch.from_numpy(b).cuda(), quals)), batches, batch)
    return res, k7_cells(aligner, genome)


def paired_engine_phase(idx, r0, q0, r1, q1, batch):
    """PairedAligner.align_batch_device + fetch.  Every batch of the CLI
    run goes through once first (the first two are the warm-up), for the
    pair-found share and the rescued ends of the same pairs."""
    import torch
    from snap_rnaseq_tpu_torch.index.hash_index import GenomeIndex
    from snap_rnaseq_tpu_torch.models.paired import PairedAligner
    from snap_rnaseq_tpu_torch.models.single import fetch
    aligner = PairedAligner(GenomeIndex.load(idx), device="cuda")
    n = r0.shape[0] // batch
    batches = [tuple(torch.from_numpy(a[i * batch:(i + 1) * batch]).cuda()
                     for a in (r0, q0, r1, q1)) for i in range(n)]
    found = rescued0 = rescued1 = 0
    for b in batches:
        out = fetch(aligner.align_batch_device(*b))
        found += int(out["pair_found"].sum())
        rescued0 += int(out["n_rescued0"])
        rescued1 += int(out["n_rescued1"])
    res = engine_phase(lambda b: fetch(aligner.align_batch_device(*b)),
                       batches, batch)
    res.update(pair_found_share=found / (n * batch), n_rescued0=rescued0,
               n_rescued1=rescued1)
    return res


def stringz_phase(argv=()):
    """The stringz tool on the card (its defaults, or `argv`), counters
    zeroed just before and read just after, its kernel calls recorded."""
    from snap_rnaseq_tpu_torch.ops import kernels as kx
    from snap_rnaseq_tpu_torch.tools import stringz
    buf = io.StringIO()
    with recorded_calls() as calls:
        kx.reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = stringz.main(list(argv))
        launches = dict(kx.LAUNCHES)
    if rc != 0:
        raise RuntimeError(f"stringz returned {rc}")
    missing = [k for k in STRINGZ_PATH if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by stringz: {missing}")
    return buf.getvalue().splitlines(), launches, calls


# ---------------------------------------------------------------- build

def kernel_label(mangled):
    """lv_lanes_kernel<1>, bitpar_packed_kernel<4,1,1,1> from a mangled
    name (template arguments as numbers)."""
    import re
    m = re.search(r"\d([a-z_]+_kernel)(I(.*?)EE)?", mangled)
    if not m:
        return mangled
    if not m.group(2):
        return m.group(1)
    args = re.findall(r"L[a-z](\d+)E", m.group(3) + "E")
    return f"{m.group(1)}<{','.join(args)}>"


SASS_LIBS = ("bitpar_packed", "bitpar_packed_w5", "bitpar_rows", "lv_lanes",
             "lv_cigar", "lv_onehot")


def build_report(libs):
    """Logs each kernel's registers and spill bytes from the build
    (`-Xptxas -v`).  Returns a future of the SASS lines (sass_lines), made
    by a process of its own while phase 2 runs (the loop analysis is tens
    of seconds of Python), or None without cuobjdump."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from snap_rnaseq_tpu_torch.ops import kernels as kx
    from snap_rnaseq_tpu_torch.tools import sass_loops
    for name in kx.SOURCES:
        rows = {kernel_label(r["function"]): [
            r.get("registers"), r.get("spill_stores"), r.get("spill_loads")]
            for r in kx.ptxas_report(name)}
        log(f"ptxas {name} [registers, spill stores, spill loads]: "
            + json.dumps(rows))
    if sass_loops.cuobjdump() is None:
        log("sass: cuobjdump not found")
        return None
    pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    future = pool.submit(sass_lines, {n: libs[n] for n in SASS_LIBS})
    pool.shutdown(wait=False)         # its one task still runs to its end
    return future


def sass_lines(paths):
    """(lines, seconds): the SASS size of the innermost loops of K2 and K4
    (tools/sass_loops.py; W = 3-5, i.e. P = 65-160) and of every LV
    kernel instance (K1, K3, K5), for the libraries at `paths`."""
    from snap_rnaseq_tpu_torch.tools import sass_loops
    t0, lines = time.time(), []
    for name, so in paths.items():
        for fn, loops in sass_loops.report(so).items():
            label = kernel_label(fn)
            if name.startswith("lv") or any(
                    f"<{w}," in label for w in (3, 4, 5)):
                lines.append(
                    f"sass {label}: loop bodies [instructions, cycles an "
                    "iteration: chain, issue, issue with fast loads]: "
                    f"{[[n, *t] for n, _, *t in loops]}")
    return lines, time.time() - t0


def kernel_entry(name, source, replaces, by_path, at_path):
    """A kernel's entry of the kernels line: `by_path` over every path
    that launched it (every launch recorded, or this raises), and the
    top-level fields at the path where it loses the most."""
    by = {}
    for path, launches in by_path.items():
        n, c = launches[name], at_path[path].get(name)
        if n == 0 and c is None:
            continue
        if c is None or c["calls"] != n:
            raise AssertionError(f"{name}: {c['calls'] if c else 0} of the "
                                 f"{path} path's {n} launches were "
                                 "recorded")
        by[path] = dict(launches=n, device_ms=c["device_ms"],
                        bound_ms=c["bound_ms"],
                        lost_ms=n * (c["device_ms"] - c["bound_ms"]),
                        ms=c["ms"], plain_ms=c["plain_ms"],
                        max_abs_err=c["max_abs_err"], shapes=c["shapes"])
    path = max(by, key=lambda p: by[p]["lost_ms"])
    c = at_path[path][name]
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=by[path]["launches"], max_abs_err=c["max_abs_err"],
                ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                bound_by=c["bound_by"], library_ms=None,
                device_ms=c["device_ms"], path=path, shapes=c["shapes"],
                by_path=by)


def k7_entry(cells, by_path):
    """K7's entry of the kernels line: its launches by path (no call of it
    is recorded: each would copy the index's bucket tables) and its runs
    at the cells' batches (k7_cells); the top-level times are the single
    cell's."""
    top = cells[0]
    return dict(name="K7_seed_lookup", route="cuda",
                source="snap_rnaseq_tpu_torch/csrc/seed_lookup.cu",
                replaces="none: snap_rnaseq_tpu/models/single.py "
                "seed_phase with ops/lookup.py pack_seeds and "
                "lookup_seeds_cuckoo, fused by XLA",
                launches=sum(l.get("K7_seed_lookup", 0)
                             for l in by_path.values()),
                max_abs_err=0.0, device_ms=top["device_ms"],
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                plain_ms=top["plain_ms"], library_ms=None, path="cells",
                cells=cells,
                by_path={p: dict(launches=l["K7_seed_lookup"])
                         for p, l in by_path.items()
                         if l.get("K7_seed_lookup")})


# ---------------------------------------------------------------- main

def main():
    # the allocator grows segments in place (phase 4k frees and allocates
    # tens of GB in blocks of different sizes); set before CUDA starts
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this run needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from snap_rnaseq_tpu_torch.ops import kernels as kx
    from snap_rnaseq_tpu_torch.utils import stats

    t_start = time.time()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = smi_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.time()
    libs = kx.build_all()
    built = stats.totals()["spans"]
    log(f"build: {time.time() - t0:.3f} s for {len(kx.SOURCES)} libraries; "
        "seconds to each one's end: " + json.dumps(
            {k[len("kernels.build."):]: round(s, 1)
             for k, (_n, s) in built.items()
             if k.startswith("kernels.build.")}))
    sass = build_report(libs)
    log(f"peaks: {HBM_BYTES_PER_S:.4g} B/s HBM, {int32_ops_per_s():.4g} "
        "int32 op/s")

    hg_future = hg_genome(t_start)    # 4k's genome, made meanwhile
    rng = np.random.default_rng(7)
    checks = [check_k1(dev, rng), check_k1_rescue(dev, rng),
              check_k2(dev, rng), check_k2_rescue(dev, rng),
              check_k3(dev, rng), check_k4(dev, rng), check_k5(dev, rng),
              check_k6(dev, rng), check_long_reads(dev, rng),
              check_k7(dev, rng)]
    for c in checks:
        log(f"{c['name']}: {c['rows']} rows match the plain version, "
            f"max_abs_err {c['max_abs_err']}")
    if sass is not None:
        lines, sass_s = sass.result()
        for line in lines:
            log(line)
        log(f"sass: {sass_s:.1f} s in a process of its own")

    log(f"phases 1-2: {time.time() - t_start:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        n_single, n_paired, n_rna = golden_phase(tmp)
        log(f"golden: {n_single} single, {n_paired} paired and "
            f"{n_rna['bits']} / {n_rna['onehot']} RNA single (K1 / K5) SAM "
            "lines identical on the card")
        log(f"phase 3: {time.time() - t0:.1f} s")
        log(f"host after phase 3: {json.dumps(host_op_us())}")
        t0 = time.time()
        codes, idx, index_s = real_index(tmp, GENOME_BASES)
        log(f"phase 4 index: {time.time() - t0:.1f} s ({t0 - t_start:.1f} "
            f"to {time.time() - t_start:.1f} s into the script)")
        t0 = time.time()
        single, single_calls = single_real_phase(
            tmp, codes, idx, index_s, N_BATCHES * BATCH, BATCH)
        log("real size, single: " + json.dumps(single))
        paired, paired_calls = paired_real_phase(
            tmp, codes, idx, index_s, N_BATCHES * BATCH, BATCH)
        log("real size, paired: " + json.dumps(paired))
        log(f"phases 4a, 4b: {time.time() - t0:.1f} s")
        t0 = time.time()
        single150, single150_calls = single_real_phase(
            tmp, codes, idx, index_s, N_BATCHES_LONG * BATCH, BATCH,
            LONG_READ_LEN, engine=False)
        log("real size, single150: " + json.dumps(single150))
        paired150, paired150_calls = paired_real_phase(
            tmp, codes, idx, index_s, N_BATCHES_LONG * BATCH, BATCH,
            LONG_READ_LEN, engine=False)
        log("real size, paired150: " + json.dumps(paired150))
        log(f"phases 4a', 4b': {time.time() - t0:.1f} s")
        t0 = time.time()
        rna, rna_calls = rna_real_phase(tmp, codes, idx, index_s,
                                        N_BATCHES * BATCH, N_BATCHES * BATCH,
                                        BATCH)
        for name, r in rna.items():
            log(f"real size, {name}: " + json.dumps(r))
        log(f"phase 4c: {time.time() - t0:.1f} s")
        t0 = time.time()
        formats = formats_phase(tmp, idx, paired, rna, BATCH)
        log("real size, formats (4d): " + json.dumps(formats))
        log(f"phase 4d: {time.time() - t0:.1f} s")
        t0 = time.time()
        flat, flat_calls = flat_phase(tmp, idx, codes, BATCH)
        log("real size, flat (4e): " + json.dumps(flat))
        log(f"phase 4e: {time.time() - t0:.1f} s")
        t0 = time.time()
        hosts = hosts_phase(tmp, idx, single, paired, BATCH)
        log("real size, hosts (4f): " + json.dumps(hosts))
        log(f"phase 4f: {time.time() - t0:.1f} s")
        t0 = time.time()
        probe, probe_calls = probe_phase(tmp, idx, BATCH)
        log("real size, probe (4g): " + json.dumps(probe))
        log(f"phase 4g: {time.time() - t0:.1f} s")
        t0 = time.time()
        dhist, dhist_calls = distance_hist_phase(tmp, idx)
        log(f"phase 4h: {time.time() - t0:.1f} s")
        t0 = time.time()
        mesh, mesh_calls = mesh_phase(tmp, idx, BATCH)
        log("real size, mesh (4i): " + json.dumps(mesh))
        log(f"phase 4i: {time.time() - t0:.1f} s")
        t0 = time.time()
        big, big_calls, big_launches = big_phase(tmp, idx, BATCH)
        log("real size, big locations (4j): " + json.dumps(big))
        log(f"phase 4j: {time.time() - t0:.1f} s")
        t0 = time.time()
        tools, tools_launches, tools_calls = tools_phase(tmp, idx)
        for name, out in tools.items():
            log(f"bench tools (4l), {name}: " + json.dumps(out))
        log(f"bench tools (4l) launches: {json.dumps(tools_launches)}")
        log(f"phase 4l: {time.time() - t0:.1f} s")
    hg, hg_calls = hg_phase(hg_future)
    del hg_future                     # the genome's 3.2 GB
    log("human size (4k): " + json.dumps(hg))
    log(f"phase 4k: {hg['phase_s']:.1f} s")
    t0 = time.time()
    sz = {}
    for name, argv in (("stringz", []),
                       ("stringz150", ["-P", str(LONG_READ_LEN)])):
        lines, launches, calls = sz[name] = stringz_phase(argv)
        for line in lines:
            log(f"{name}: {line}")
        log(f"{name} launches: {json.dumps(launches)}")
    log(f"phase 5: {time.time() - t0:.1f} s")
    t0 = time.time()

    # phase 6: every kernel call shape of each main path, on its inputs
    by_path = dict(single=single["launches"], paired=paired["launches"],
                   single150=single150["launches"],
                   paired150=paired150["launches"], flat=flat["launches"],
                   distance_hist=dhist["launches"],
                   **{name: v[1] for name, v in sz.items()},
                   **{name: r["launches"] for name, r in rna.items()},
                   **{name: probe[name]["launches"] for name in probe_calls},
                   **{name: r["launches"]
                      for name, r in mesh["meshes"].items()}, **big_launches,
                   hg=hg["launches"], **tools_launches)
    at_path = {p: check_path_calls(p, c) for p, c in (
        ("single", single_calls), ("paired", paired_calls),
        ("single150", single150_calls), ("paired150", paired150_calls),
        ("flat", flat_calls), ("distance_hist", dhist_calls),
        *((name, v[2]) for name, v in sz.items()), *rna_calls.items(),
        *probe_calls.items(), *mesh_calls.items(), *big_calls.items(),
        ("hg", hg_calls), *tools_calls.items())}
    k3_warp_sweep(single_calls)
    k5_vs_k1(rna_calls["rna_single_onehot"])
    log(f"phase 6: {time.time() - t0:.1f} s")
    log(f"total: {time.time() - t_start:.1f} s")
    setup = stats.totals()["spans"]
    log("index set-up spans over the run (calls, s): " + json.dumps(
        {k: [n, round(sec, 3)] for k, (n, sec) in setup.items()
         if k.startswith("index.")}))

    kernels = [kernel_entry(name, source, replaces, by_path, at_path)
               for name, (source, replaces) in KERNEL_INFO.items()]
    kernels.append(k7_entry(single["k7_cells"], by_path))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
