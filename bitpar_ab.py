#!/usr/bin/env python3
"""K2 and K4 of two checkouts of the port in turns on one card.

    python3 bitpar_ab.py ROOT_A ROOT_B [--rounds 2]

Builds each checkout's csrc/bitpar_packed.cu (K2 at 1-4 pattern words)
and csrc/bitpar_rows.cu (K4) with this checkout's nvcc flags, B's K2 at 5,
8 and 16 words (ops/kernels.py's flags for those libraries), and B's K4
once more at each other block size of 32, 64 and 128 rows (its source
with `kRows` replaced), all nvcc at once, into a temporary directory.
Prints each build's seconds, registers and spills (`-Xptxas -v`) and,
for the innermost loops of every K2 instance built and of K4 at W = 4 and
5, the SASS size and tools/sass_loops.py's cycles an iteration.  Then, on the same
inputs for every library, each check bit-identical to the plain version:

* in turns A B B A per round, device ms per launch (chip_smoke.device_ms):
  K4 at stringz's inputs (16,384 x 100 x 131, global start) and on the
  same rows with the text run on to 511 columns (one staged tile; the
  difference is 380 columns of the row's chain); K2 forward at
  DNA paired's prefilter shape (262,144 x 100 x 117, packed_off 16); K2's
  mate-rescue form at 4,096 x 100 x 1,084;
* B alone: K4 at stringz -P 100, 150 and 250 at each block size (at 250
  not 128, which needs more shared memory than a block has unasked); K2's
  rescue form at P = 100, 150, 250 and 512 over the window WLEN = 950 +
  P + 34 (the default spacing) at 1-32 chunks a row, beside the count
  ops/bitpar.py scan_chunks picks.

Prints one JSON line per measurement and a summary line.  Needs one
NVIDIA card and the CUDA toolkit.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROWS = (32, 64, 128)            # K4 block sizes timed
LONG_WORDS = (5, 8, 16)         # K2 libraries past 4 words: P 150, 250, 512


def build(libs, out_dir):
    """{label: (source, csrc dir, extra flags)} -> {label: (so path, ptxas
    text)}, one nvcc per library, all at once; prints each one's
    seconds."""
    from snap_rnaseq_tpu_torch.ops import kernels as kx
    procs, t0 = {}, time.time()
    for label, (src, inc, extra) in libs.items():
        so = os.path.join(out_dir, f"{label}.so")
        cmd = [kx._nvcc(), *kx.NVCC_FLAGS, *extra, "-I", inc, "-o", so, src]
        log = open(so + ".log", "w+")
        procs[label] = (subprocess.Popen(cmd, stdout=log,
                                         stderr=subprocess.STDOUT), so, log)
    out, secs = {}, {}
    while len(secs) < len(procs):
        for label, (p, so, log) in procs.items():
            if label not in secs and p.poll() is not None:
                secs[label] = round(time.time() - t0, 1)
                log.seek(0)
                text = log.read()
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc {label} failed:\n{text}")
                out[label] = (so, text)
        time.sleep(0.1)
    print("BUILD " + json.dumps(secs), flush=True)
    return out


def rows_variant(root_b, rows, tmp):
    """B's csrc copied with K4's kRows set to `rows`: (its bitpar_rows.cu,
    the copy, no extra flags)."""
    d = os.path.join(tmp, f"csrc_rows{rows}")
    shutil.copytree(os.path.join(root_b, "snap_rnaseq_tpu_torch", "csrc"), d,
                    ignore=shutil.ignore_patterns("_build"))
    path = os.path.join(d, "bitpar_rows.cu")
    src = open(path).read()
    new, n = re.subn(r"constexpr int kRows = \d+;",
                     f"constexpr int kRows = {rows};", src)
    if n != 1:
        raise RuntimeError("kRows not found in bitpar_rows.cu")
    open(path, "w").write(new)
    return path, d, []


class Lib:
    """One built library's launch function, bound as ops/kernels.py binds
    it."""

    def __init__(self, so, kind):
        from snap_rnaseq_tpu_torch.ops import kernels as kx
        fn_name, argtypes = kx._SIGNATURES[kind]
        self.fn = getattr(ctypes.CDLL(so), fn_name)
        self.fn.argtypes = argtypes
        self.fn.restype = ctypes.c_int

    def __call__(self, *args):
        err = self.fn(*args)
        if err != 0:
            raise RuntimeError(f"launch: CUDA error {err}")


def k4_call(lib, pat, text, tl, P, free_start=False, track_pos=False):
    import torch
    from snap_rnaseq_tpu_torch.ops import kernels as kx
    out = torch.empty(pat.shape[0], dtype=torch.int32, device="cuda")
    lib(kx.ptr(pat), P, kx.ptr(text), text.shape[1], kx.ptr(tl),
        int(free_start), int(track_pos), pat.shape[0], kx.ptr(out),
        kx.stream())
    return out


def k2_call(lib, pat, words, tl, P, TXT, off, rescue, geometry=None):
    """K2 forward (rescue=False) or in the mate rescue's form; the scan
    geometry is scan_chunks' unless given."""
    import torch
    from snap_rnaseq_tpu_torch.ops import bitpar
    from snap_rnaseq_tpu_torch.ops import kernels as kx
    B = pat.shape[0]
    chunk_len, warm, n = geometry or bitpar.scan_chunks(B, P, TXT, rescue)
    out = torch.empty(B, dtype=torch.int32, device="cuda")
    lib(kx.ptr(pat), P, kx.ptr(words), words.shape[1], kx.ptr(tl), TXT, off,
        int(rescue), int(rescue), int(rescue), chunk_len, warm, n, B,
        kx.ptr(out), kx.stream())
    return out


def k2_plain(pat, words, tl, P, TXT, off, rescue):
    from snap_rnaseq_tpu_torch.ops import bitpar
    text = bitpar.unpack_words(words)[:, off:off + TXT]
    return bitpar.bitpar_distance_plain(
        pat, text.flip(1) if rescue else text, tl, P=P, track_pos=rescue,
        free_start=rescue)


def same(name, got, want):
    import torch
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: {int((got != want).sum())} rows "
                             "differ from the plain version")


def report(label, so, ptxas):
    """Registers, spills and innermost SASS loops of a library's kernels
    (every K2 instance, K4 at W = 4 and 5)."""
    import chip_smoke as cs
    from snap_rnaseq_tpu_torch.ops import kernels as kx
    from snap_rnaseq_tpu_torch.tools import sass_loops
    regs = {cs.kernel_label(r["function"]): [
        r.get("registers"), r.get("spill_stores"), r.get("spill_loads")]
        for r in kx.parse_ptxas(ptxas)}
    keep = lambda lab: "rows" not in lab or "<4," in lab or "<5," in lab
    print("PTXAS " + json.dumps(dict(lib=label, kernels={
        k: v for k, v in regs.items() if keep(k)})), flush=True)
    if sass_loops.cuobjdump() is None:
        return
    # per innermost loop: instructions, and cycles an iteration (chain,
    # issue, issue with fast loads)
    loops = {cs.kernel_label(fn): [[n, *t] for n, _, *t in rows]
             for fn, rows in sass_loops.report(so).items()}
    print("SASS " + json.dumps(dict(lib=label, loops={
        k: v for k, v in loops.items() if keep(k)})), flush=True)


def main(root_a, root_b, rounds):
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    from snap_rnaseq_tpu_torch.ops import bitpar, u32
    from snap_rnaseq_tpu_torch.tools.stringz import random_pairs
    if not torch.cuda.is_available():
        print("bitpar_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    cs.log(f"card: {cs.smi_line()}")
    csrc = {r: os.path.join(r, "snap_rnaseq_tpu_torch", "csrc")
            for r in (root_a, root_b)}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {f"{side}_{k}": (os.path.join(csrc[root], f"bitpar_{k}.cu"),
                                csrc[root], [])
                for side, root in (("A", root_a), ("B", root_b))
                for k in ("packed", "rows")}
        for w in LONG_WORDS:
            libs[f"B_packed_w{w}"] = (libs["B_packed"][0], csrc[root_b],
                                      [f"-DBPK_WORDS={w}"])
        for rows in ROWS:
            libs[f"B_rows{rows}"] = rows_variant(root_b, rows, tmp)
        t0 = time.time()
        built = build(libs, tmp)
        cs.log(f"build: {time.time() - t0:.1f} s for {len(built)} libraries")
        for label, (so, text) in built.items():
            report(label, so, text)
        k2 = {lab: Lib(built[lab][0], "bitpar_packed")
              for lab in built if "packed" in lab}
        k4 = {lab: Lib(built[lab][0], "bitpar_rows")
              for lab in built if "rows" in lab}
        rng = np.random.default_rng(11)
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()

        def k4_case(P):
            pat, text = random_pairs(16_384, P)
            tl = np.full(16_384, P + 31, np.int32)
            return to(pat), to(text), to(tl)

        def k2_case(B, P, TXT, off, rescue):
            pats, words = cs.packed_cases(rng, B, P, TXT, off, rescue, rescue)
            return (to(pats), u32.from_numpy(words, "cuda"),
                    to(np.full(B, TXT, np.int32)))

        results = {}

        def timed(name, label, fn, want):
            same(f"{name} {label}", fn(), want)
            ms = cs.device_ms(fn, 50)
            results.setdefault(name, {}).setdefault(label, []).append(ms)
            print("TIME " + json.dumps(dict(case=name, lib=label, ms=ms)),
                  flush=True)

        # parent and change in turns
        pat, text, tl = k4_case(100)
        want_k4 = bitpar.bitpar_distance_plain(pat, text, tl, P=100)
        run_on = np.concatenate(
            [text.cpu().numpy(),
             rng.integers(0, 4, (16_384, 380), dtype=np.uint8)], axis=1)
        text511, tl511 = to(run_on), to(np.full(16_384, 511, np.int32))
        want_511 = bitpar.bitpar_distance_plain(pat, text511, tl511, P=100)
        fwd = k2_case(262_144, 100, 117, 16, False)
        want_fwd = k2_plain(*fwd, 100, 117, 16, False)
        res = k2_case(4096, 100, 1084, 0, True)
        want_res = k2_plain(*res, 100, 1084, 0, True)
        for _ in range(rounds):
            for side in ("A", "B", "B", "A"):
                timed("K4 stringz 16384x100x131", side,
                      lambda: k4_call(k4[f"{side}_rows"], pat, text, tl, 100),
                      want_k4)
                timed("K4 16384x100x511", side,
                      lambda: k4_call(k4[f"{side}_rows"], pat, text511,
                                      tl511, 100), want_511)
                timed("K2 forward 262144x100x117", side,
                      lambda: k2_call(k2[f"{side}_packed"], *fwd, 100, 117,
                                      16, False), want_fwd)
                timed("K2 rescue 4096x100x1084", side,
                      lambda: k2_call(k2[f"{side}_packed"], *res, 100, 1084,
                                      0, True), want_res)
        # the change alone: K4's block sizes and long reads
        for P in (100, 150, 250):
            case = (pat, text, tl) if P == 100 else k4_case(P)
            want = (want_k4 if P == 100 else
                    bitpar.bitpar_distance_plain(*case, P=P))
            # 128 rows at P = 250 would need 57 KB of shared memory, past
            # the 48 KB a block gets without opting in (32 rows: 14 KB)
            for label in tuple(f"B_rows{r}" for r in ROWS
                               if P < 250 or r < 128):
                timed(f"K4 stringz 16384x{P}x{P + 31}", label,
                      lambda: k4_call(k4[label], *case, P), want)
        # the rescue's chunk count at each read length
        for P in (100, 150, 250, 512):
            TXT = 950 + P + 34
            case = k2_case(4096, P, TXT, 0, True)
            want = k2_plain(*case, P, TXT, 0, True)
            chosen = bitpar.scan_chunks(4096, P, TXT, True)
            W = (P + 31) // 32
            lib = k2["B_packed" if W <= 4 else f"B_packed_w{W}"]
            for n in (1, 2, 4, 8, 16, 32):
                geo = (-(-TXT // n), 2 * P, n)
                timed(f"K2 rescue 4096x{P}x{TXT}", f"B {n} chunks",
                      lambda: k2_call(lib, *case, P, TXT, 0, True, geo),
                      want)
            print("CHOSEN " + json.dumps(dict(P=P, TXT=TXT, chunk_len=chosen[0],
                                              warm=chosen[1],
                                              n_chunks=chosen[2])),
                  flush=True)
    print("SUMMARY " + json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    sys.exit(main(os.path.abspath(a.root_a), os.path.abspath(a.root_b),
                  a.rounds))
