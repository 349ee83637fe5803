#!/usr/bin/env python3
"""RNA `single` of two checkouts of the port in turns on one card, with
the SAM writer's CIGAR flush and K3's wrapper timed in every run.

    python3 flush_ab.py ROOT_A ROOT_B [--rounds 3]

Makes chip_smoke.py's phase-4 RNA data once (the 64 Mb hg-like genome of
seed 0, its GENCODE-density annotation and 16 x 1024 RNA reads, from the
same seeds), builds the index and the transcriptome through this
checkout's CLI, then runs `single idx tidx anno.gtf reads.fq -bs 1024` on
the card in a fresh process per run, in the order A B B A per round.  Each
run builds its checkout's kernels before it starts (the build is not
timed) and prints one JSON line: reads/s and align seconds from the CLI's
`-pf` row, the pipeline's wait profile, and per CIGAR flush (io/sam.py's
call of ops/cigar.py compute_cigars) its rows and wall ms, and the wall
ms of the K3 wrapper inside it, the stream synchronised after the launch.
Last, a summary line per checkout.  Needs one NVIDIA card.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def child(root, argv):
    """One CLI run of checkout `root`'s port with the flush timed."""
    sys.path.insert(0, root)
    import torch
    import snap_rnaseq_tpu_torch.io.sam as sam
    from snap_rnaseq_tpu_torch import cli
    from snap_rnaseq_tpu_torch.ops import kernels, lv_cuda
    kernels.build_all()
    flushes, k3_ms = [], []
    real_flush, real_k3 = sam.compute_cigars, lv_cuda.lv_cigar

    def flush(pattern, *a, **kw):
        t0 = time.perf_counter()
        out = real_flush(pattern, *a, **kw)
        flushes.append([int(pattern.shape[0]),
                        (time.perf_counter() - t0) * 1e3])
        return out

    def k3(*a, **kw):
        t0 = time.perf_counter()
        out = real_k3(*a, **kw)
        torch.cuda.current_stream().synchronize()
        k3_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    sam.compute_cigars, lv_cuda.lv_cigar = flush, k3
    perf = argv[argv.index("-pf") + 1]
    rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli returned {rc}")
    total, align_s = (float(x) for x in open(perf).read().split("\t")[1:4:2])
    flush_ms = [f[1] for f in flushes]
    print("RUN " + json.dumps(dict(
        root=root, reads_per_s=total / align_s, align_s=align_s,
        flushes=len(flushes), flush_rows=sum(f[0] for f in flushes),
        flush_ms_total=sum(flush_ms),
        flush_ms_mean=sum(flush_ms) / max(len(flush_ms), 1),
        k3_ms_total=sum(k3_ms), k3_ms_mean=sum(k3_ms) / max(len(k3_ms), 1),
        per_flush=flushes, k3_ms=k3_ms)), flush=True)
    return 0


def main(root_a, root_b, rounds):
    sys.path.insert(0, HERE)
    import numpy as np
    import chip_smoke as cs
    from snap_rnaseq_tpu_torch.utils.tables import decode_bases
    cs.log(f"card: {cs.smi_line()}")
    runs = {root_a: [], root_b: []}
    with tempfile.TemporaryDirectory() as tmp:
        codes, idx, _ = cs.real_index(tmp, cs.GENOME_BASES)
        rng = np.random.default_rng(20261018)        # as rna_real_phase
        transcripts = cs.rna_annotation(codes.size, rng)
        gtf = os.path.join(tmp, "real.gtf")
        cs.write_gtf(gtf, transcripts)
        tidx = os.path.join(tmp, "tidx")
        cs.run_cli(["transcriptome", gtf, os.path.join(tmp, "hg_like.fa"),
                    tidx])
        reads = cs.rna_single_reads(codes, cs.spliced(codes, transcripts),
                                    cs.N_BATCHES * cs.BATCH, rng)
        fq = os.path.join(tmp, "rna_reads.fq")
        with open(fq, "wb") as f:
            for i, (s, spl, r) in enumerate(reads):
                f.write(b"@r%d_%d_%d\n" % (i, s, spl) + decode_bases(r)
                        + b"\n+\n" + b"I" * cs.READ_LEN + b"\n")
        for rnd in range(rounds):
            for n, root in enumerate((root_a, root_b, root_b, root_a)):
                perf = os.path.join(tmp, f"perf{rnd}_{n}.tsv")
                argv = ["single", idx, tidx, gtf, fq, "-o",
                        os.path.join(tmp, "out.sam"), "-bs", str(cs.BATCH),
                        "--device", "cuda", "-pf", perf]
                p = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--run",
                     root, *argv], capture_output=True, text=True, cwd=root)
                if p.returncode != 0:
                    raise RuntimeError(f"run of {root} failed:\n"
                                       f"{p.stderr[-4000:]}")
                out = p.stdout
                line = next(l for l in out.splitlines()
                            if l.startswith("RUN "))
                wait = next((l for l in out.splitlines()
                             if l.startswith("wait profile")), None)
                r = json.loads(line[4:])
                r["wait_profile"] = wait
                runs[root].append(r)
                cs.log(json.dumps(r))
    for root, rs in runs.items():
        cs.log("SUMMARY " + json.dumps(dict(
            root=root, reads_per_s=[r["reads_per_s"] for r in rs],
            flush_ms_total=[r["flush_ms_total"] for r in rs],
            k3_ms_total=[r["k3_ms_total"] for r in rs],
            k3_ms_mean=[r["k3_ms_mean"] for r in rs],
            wait_profile=[r["wait_profile"] for r in rs])))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--run"]:
        sys.exit(child(os.path.abspath(sys.argv[2]), sys.argv[3:]))
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--rounds", type=int, default=3)
    a = ap.parse_args()
    sys.exit(main(os.path.abspath(a.root_a), os.path.abspath(a.root_b),
                  a.rounds))
