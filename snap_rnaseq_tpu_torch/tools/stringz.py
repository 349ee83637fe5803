"""Micro-benchmark of the string-distance kernels on random strings.

Port of snap_rnaseq_tpu/tools/stringz.py, the analog of reference
apps/stringz/stringz.cpp:1-40: time the edit-distance kernels standalone
on random pattern/text pairs (half of them with three substitutions) and
print pairs/s.  On a card the lines time K4 (bitpar over byte code rows)
and K1 (LV-lanes, no quality) at k = 16 and k = 7.

    python -m snap_rnaseq_tpu_torch.tools.stringz [-B 16384] [-P 100]
        [-k 16] [-r 5] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(prog="stringz")
    p.add_argument("-B", type=int, default=16384, help="batch size")
    p.add_argument("-P", type=int, default=100, help="string length")
    p.add_argument("-k", type=int, default=16, help="edit distance band")
    p.add_argument("-r", type=int, default=5, help="timed rounds")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions)")
    a = p.parse_args(argv)

    from ..models.single import resolve_device
    from ..ops.bitpar import bitpar_distance
    from ..ops.lv import lv_distance

    dev = resolve_device(a.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(0)
    B, P, k = a.B, a.P, a.k
    pat = rng.integers(0, 4, (B, P), dtype=np.uint8)
    text = np.zeros((B, P + 31), np.uint8)
    text[:, :P] = pat
    sel = rng.random(B) < 0.5
    for _ in range(3):
        idx = rng.integers(0, P, B)
        text[sel, idx[sel]] ^= 1
    to = lambda x: torch.from_numpy(x).to(dev)
    pat_t, text_t = to(pat), to(text)
    p_len = to(np.full(B, P, np.int32))
    t_len = to(np.full(B, P + 31, np.int32))
    kv = to(np.full(B, k, np.int32))
    k7 = kv.clamp_max(7)

    def bench(name, fn):
        fn()
        sync()
        t0 = time.time()
        for _ in range(a.r):
            fn()
        sync()
        dt = (time.time() - t0) / a.r
        print(f"{name:24s} {dt * 1e3:9.2f} ms   {B / dt / 1e6:8.2f} M pairs/s")

    bench("bitpar (whole-read)",
          lambda: bitpar_distance(pat_t, text_t, t_len, P=P))
    bench(f"landau-vishkin k={k}",
          lambda: lv_distance(pat_t, p_len, text_t, t_len, kv, None,
                              e_max=k).distance)
    bench("landau-vishkin k=7",
          lambda: lv_distance(pat_t, p_len, text_t, t_len, k7, None,
                              e_max=7).distance)
    return 0


if __name__ == "__main__":
    sys.exit(main())
