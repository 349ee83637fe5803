"""Histogram of read <-> genome edit distances for aligned SAM/BAM records.

Port of snap_rnaseq_tpu/tools/distance_hist.py, the analog of reference
apps/DistanceHist/DistanceHist.cpp:10-40: for every mapped record,
recompute the banded edit distance of the (as-aligned) read against the
genome window at its reported position with the batched LV of ops/lv.py
(K1 on a card, at e_max = min(MAX_K, k + 1) and without qualities), and
print a distance histogram.

Usage: python -m snap_rnaseq_tpu_torch.tools.distance_hist <index-dir>
       <in.sam|bam> [-k maxDist] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..constants import MAX_K


def distance_hist(index_dir: str, path: str, k: int = MAX_K - 1,
                  batch: int = 512, device="cuda"):
    from ..index.genome import Genome
    from ..models.single import resolve_device
    from ..ops.lv import lv_distance
    from ..utils.tables import BASE_VALUE

    dev = resolve_device(device)
    genome = Genome.load(index_dir)
    hist = np.zeros(k + 2, np.int64)  # [-1] bucket at the end

    pats, texts = [], []

    def flush():
        nonlocal pats, texts
        if not pats:
            return
        P = max(len(p) for p in pats)
        B = len(pats)
        pat = np.zeros((B, P), np.uint8)
        txt = np.zeros((B, P + MAX_K), np.uint8)
        pl = np.zeros(B, np.int32)
        tl = np.zeros(B, np.int32)
        for i, (pc, tc) in enumerate(zip(pats, texts)):
            pat[i, :len(pc)] = pc
            txt[i, :len(tc)] = tc
            pl[i], tl[i] = len(pc), len(tc)
        to = lambda a: torch.from_numpy(a).to(dev)
        r = lv_distance(to(pat), to(pl), to(txt), to(tl),
                        to(np.full(B, k, np.int32)), None,
                        e_max=min(MAX_K, k + 1))
        for d in r.distance.cpu().numpy():
            hist[int(d) if d >= 0 else -1] += 1
        pats, texts = [], []

    for rec in _full_records(path):
        qname, flag, rname, pos, seq = rec
        if flag & 0x4 or rname == "*" or seq in (b"*", b""):
            continue
        codes = BASE_VALUE[np.frombuffer(seq, np.uint8)]
        loc = genome.offset_of_piece(rname) + pos - 1
        text = np.asarray(genome.codes[loc:loc + len(codes) + MAX_K])
        pats.append(codes)
        texts.append(text)
        if len(pats) >= batch:
            flush()
    flush()
    return hist


def _full_records(path):
    lower = path.lower()
    if lower.endswith(".bam"):
        from ..io.readers import bam_records
        for r in bam_records(path):
            rname = r["refs"][r["ref_id"]][0] if r["ref_id"] >= 0 else "*"
            yield r["qname"], r["flag"], rname, r["pos"] + 1, r["seq"]
    else:
        for line in open(path, "rb"):
            if line.startswith(b"@"):
                continue
            f = line.split(b"\t")
            yield f[0], int(f[1]), f[2].decode(), int(f[3]), f[9]


def main(argv=None):
    p = argparse.ArgumentParser(prog="distance_hist")
    p.add_argument("index_dir")
    p.add_argument("alignments")
    p.add_argument("-k", dest="k", type=int, default=MAX_K - 1)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch version)")
    a = p.parse_args(argv)
    hist = distance_hist(a.index_dir, a.alignments, a.k, device=a.device)
    print("distance\tcount")
    for d in range(a.k + 1):
        if hist[d]:
            print(f"{d}\t{hist[d]}")
    if hist[-1]:
        print(f">{a.k}\t{hist[-1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
