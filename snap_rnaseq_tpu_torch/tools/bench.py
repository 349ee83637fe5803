"""Alignment throughput on one card at the JAX repo's bench.py operating
point: the counterpart of bench.py.

100-base paired-end reads against a 64 Mb genome with human-like repeat
structure (hg_like_genome(64e6, seed=0), seed length 20), three batches of
1,024 wgsim pairs (seeds 0-2) cycled for `--rounds` batches a window,
PairedAligner(index, cand_per_read=64).  Reads/s count two reads a pair
(the reference's own metric).  The paired rate is measured in `--windows`
windows and reported as the median with its min and max: host-clock
rates on the card's machine spread between calls.  Then one more window
under torch.profiler gives the device's busy ms a batch, its idle share,
its operations a batch and the kernels' ms.

Extras, as bench.py has them: a SingleAligner at cand_per_read=64 on the
paired aligner's device copy of the index (end 0 of the same batches),
and FASTQ to SAM: the same three batches written as a FASTQ pair and
aligned by PairedEndPipeline with the same aligner, in windows too, with
its wait profile.  The FASTQ carries the quality bytes the engine runs
were given (bench.py wrote them shifted by 33 more).

vs_baseline divides by BASELINE_MEASURED.json's figure: the reference
binary's single-core rate on the same genome and reads, scaled by 20 to
32 threads, on the JAX repo's bench host; it is not a card figure.

Prints one JSON line with bench.py's keys (metric, value, unit,
vs_baseline, extra); progress and the wait profile go to stderr.  Runs on
`--device` (default cuda; raises without a card) and catches no error: a
failure exits non-zero.

    python -m snap_rnaseq_tpu_torch.tools.bench [--index DIR | --cache DIR]
        [--rounds 10] [--windows 5] [--batch-pairs 1024] [--bases 64e6]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from . import measure as m

BASELINE_LABEL = ("BASELINE_MEASURED.json: the reference binary, one core of "
                  "the JAX repo's bench host, x 20 for 32 threads (its "
                  "manual's scaling); not a card figure")


def load_baseline(single: bool = False) -> float:
    """The reference's reads/s as bench.py:115-129 reads
    BASELINE_MEASURED.json: the paired figure, or the single-end one."""
    with open(os.path.join(m.REPO, "BASELINE_MEASURED.json")) as f:
        b = json.load(f)
    return float(b["reads_per_sec_32t_estimate" if single
                   else "paired_reads_per_sec_32t_estimate"])


def write_fastq(batches, d):
    """The batches as a FASTQ pair in `d` (ids b<batch>p<pair>/1 and /2)."""
    from ..utils.tables import decode_bases
    paths = (os.path.join(d, "r1.fq"), os.path.join(d, "r2.fq"))
    with open(paths[0], "wb") as f0, open(paths[1], "wb") as f1:
        for bi, b in enumerate(batches):
            r0, q0, r1, q1 = (x.cpu().numpy() for x in b)
            for i in range(r0.shape[0]):
                rid = b"@b%dp%d" % (bi, i)
                f0.write(rid + b"/1\n" + decode_bases(r0[i]) + b"\n+\n"
                         + q0[i].tobytes() + b"\n")
                f1.write(rid + b"/2\n" + decode_bases(r1[i]) + b"\n+\n"
                         + q1[i].tobytes() + b"\n")
    return paths


def sam_windows(index, paired, batches, batch_pairs, windows, d):
    """FASTQ pair -> SAM through PairedEndPipeline with `paired`, once per
    window; reads/s over each run's wall, and the wait profile of each."""
    from ..models.paired_pipeline import (PairedEndPipeline,
                                          PairedPipelineOptions)
    fq1, fq2 = write_fastq(batches, d)
    out = os.path.join(d, "out.sam")
    rates, waits = [], []
    before = m.launches()
    for _ in range(windows):
        pipe = PairedEndPipeline(
            index, options=PairedPipelineOptions(batch_size=batch_pairs),
            aligner=paired)
        t0 = time.time()
        stats = pipe.run(fq1, fq2, out)
        dt = time.time() - t0
        rates.append(stats.total_reads / dt)
        w = pipe.wait
        waits.append(dict(wall_s=dt, read_s=w.read_s, device_s=w.device_s,
                          write_s=w.write_s))
        m.log(f"bench: e2e profile: wall {dt:.2f}s reads "
              f"{stats.total_reads} device_s {w.device_s:.2f} write_s "
              f"{w.write_s:.2f} read_s {w.read_s:.2f}")
    return dict(reads_per_sec=m.spread(rates), wait=waits,
                launches_per_run=m.launches_since(before, windows))


def _rates(res, base):
    """A timed_windows result for the JSON line (the outputs dropped),
    with the baseline it is compared to."""
    r = {k: v for k, v in res.items() if k != "out"}
    r.update(baseline_reads_per_sec=base,
             vs_baseline=r["reads_per_sec"]["median"] / base)
    return r


def run(index, *, device="cuda", bases=m.GENOME_BASES,
        batch_pairs=m.BATCH_PAIRS, rounds=m.ROUNDS, windows=m.WINDOWS,
        sam_dir=None, base=None, stage=m.no_stage, index_s=None,
        index_source=None) -> dict:
    """The bench on a loaded index; returns the JSON line's dict.  `base`:
    a PairedAligner whose device copy of the index is used (else one is
    built).  Each measured part runs as stage(name, fn) with name "pe",
    "se" or "sam".  The FASTQ pair and the SAM are kept in `sam_dir` when
    it is given."""
    from ..models.paired import PairedAligner
    from ..models.single import resolve_device
    dev = resolve_device(device)
    m.reset_peak(dev)
    t0 = time.time()
    paired = (m.paired_on_state(base, cand_per_read=m.CAND_PER_READ)
              if base is not None else
              PairedAligner(index, device=dev,
                            cand_per_read=m.CAND_PER_READ))
    upload_s = time.time() - t0
    batches = m.pair_batches(index, bases, batch_pairs, dev)
    baseline = load_baseline()

    m.log("bench: paired")
    pe = stage("pe", lambda: m.timed_windows(
        lambda b: paired.align_batch_device(*b), batches, 2 * batch_pairs,
        rounds, windows, dev))
    found = float(pe["out"]["pair_found"].float().mean())
    extra = dict(
        device=m.device_info(dev), genome_bases=bases,
        seed_len=index.seed_len, batch_pairs=batch_pairs, rounds=rounds,
        windows=windows, cand_per_read=m.CAND_PER_READ,
        index_s=index_s, index_source=index_source, upload_s=upload_s,
        baseline_reads_per_sec=baseline, baseline_source=BASELINE_LABEL,
        fraction_pairs_found=found,
        timing=("wall time over synchronised windows of batches; the "
                "engine reads scalars back inside a batch, so batches do "
                "not queue ahead"),
        paired=_rates(pe, baseline))
    se_base = load_baseline(single=True)
    eng = m.single_on_state(paired, cand_per_read=m.CAND_PER_READ)
    m.log("bench: single-end")
    se = stage("se", lambda: m.timed_windows(
        lambda b: eng.align_batch_device(b[0], b[1]), batches, batch_pairs,
        rounds, windows, dev))
    extra["single_end"] = dict(
        _rates(se, se_base),
        fraction_aligned=float((se["out"]["result"] > 0).float().mean()))
    m.log("bench: FASTQ to SAM")
    with tempfile.TemporaryDirectory() as td:
        d = sam_dir or td
        os.makedirs(d, exist_ok=True)
        e2e = stage("sam", lambda: sam_windows(
            index, paired, batches, batch_pairs, windows, d))
    extra["end_to_end_reads_per_sec"] = e2e["reads_per_sec"]["median"]
    extra["end_to_end"] = e2e
    extra["peak_device_bytes"] = m.peak_bytes(dev)
    rps = pe["reads_per_sec"]["median"]
    return {
        "metric": "reads aligned/s/card (100 bp PE, "
                  f"{bases / 1e6:g} Mb hg-like genome, paired defaults, "
                  f"cand_per_read {m.CAND_PER_READ}; median of "
                  f"{windows} windows of {rounds} batches)",
        "value": rps, "unit": "reads/s", "vs_baseline": rps / baseline,
        "extra": extra}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bench")
    m.add_common_args(p)
    p.add_argument("--rounds", type=int, default=m.ROUNDS,
                   help="batches a window (bench.py's rounds)")
    p.add_argument("--windows", type=int, default=m.WINDOWS)
    a = p.parse_args(argv)
    from ..models.single import resolve_device
    dev = resolve_device(a.device)
    bases = int(a.bases)
    index, index_s, src = m.open_index(a.index, a.cache, bases, dev)
    m.log(f"bench: index {src} in {index_s:.1f} s")
    line = run(index, device=dev, bases=bases, batch_pairs=a.batch_pairs,
               rounds=a.rounds, windows=a.windows, index_s=index_s,
               index_source=src)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
