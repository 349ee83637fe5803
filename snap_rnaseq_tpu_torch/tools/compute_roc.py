"""Offline MAPQ ROC from a SAM/BAM of wgsim-simulated reads.

Analog of reference apps/ComputeROC/ComputeROC.cpp:30-55+: re-derive each
read's true location from its wgsim-encoded id, count (total, errors) per
MAPQ bucket, print the cumulative ROC table.

Usage: python -m snap_rnaseq_tpu_torch.tools.compute_roc <index-dir> <in.sam|bam>
       [-E misalignThreshold]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def compute_roc(index_dir: str, path: str, misalign_threshold: int = 15):
    from ..index.genome import Genome
    from ..utils.wgsim import parse_wgsim_id
    genome = Genome.load(index_dir)
    counts = np.zeros(71, np.int64)
    errors = np.zeros(71, np.int64)
    for qname, flag, rname, pos, mapq in _records(path):
        if flag & 0x4 or rname == "*":
            continue
        try:
            low, high = parse_wgsim_id(qname, genome)
        except Exception:
            continue
        loc = genome.offset_of_piece(rname) + pos - 1
        m = max(0, min(70, mapq))
        counts[m] += 1
        if not (low - misalign_threshold <= loc <= high + misalign_threshold):
            errors[m] += 1
    return counts, errors


def _records(path):
    lower = path.lower()
    if lower.endswith(".bam"):
        from ..io.readers import bam_records
        for r in bam_records(path):
            rname = r["refs"][r["ref_id"]][0] if r["ref_id"] >= 0 else "*"
            yield r["qname"], r["flag"], rname, r["pos"] + 1, r["mapq"]
    else:
        for line in open(path, "rb"):
            if line.startswith(b"@"):
                continue
            f = line.split(b"\t")
            yield f[0], int(f[1]), f[2].decode(), int(f[3]), int(f[4])


def main(argv=None):
    p = argparse.ArgumentParser(prog="compute_roc")
    p.add_argument("index_dir")
    p.add_argument("alignments")
    p.add_argument("-E", dest="threshold", type=int, default=15)
    a = p.parse_args(argv)
    counts, errors = compute_roc(a.index_dir, a.alignments, a.threshold)
    print("mapq\tcount\terrors\tcumCount\tcumErrors\tcumErrorRate")
    cum_c = cum_e = 0
    for m in range(70, -1, -1):
        if counts[m] == 0:
            continue
        cum_c += int(counts[m])
        cum_e += int(errors[m])
        print(f"{m}\t{counts[m]}\t{errors[m]}\t{cum_c}\t{cum_e}\t"
              f"{cum_e / max(cum_c, 1):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
