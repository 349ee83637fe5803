"""snap-rna command line of the PyTorch/CUDA port.

Port of snap_rnaseq_tpu/cli.py (reference apps/snap/Main.cpp:42-86 +
AlignerOptions.cpp), with the subcommands this port carries:

  index   <ref.fa> <index-dir> [-s seedLen] [-lf loadFactor]
  single  <genome-dir> <input>... -o out.sam [--device cuda|cpu]

Index directories are the JAX package's on-disk format, so either package
can read what the other wrote.  Flag names follow the reference
(AlignerOptions.cpp:94-165); -d and -h accept `n1:s:n2` ranges (Range.h:
29-56) and runs chain with a `,` argument (Main.cpp:63-80).

The engine runs on `--device`, CUDA by default; without a card that
raises rather than falling back.  Not yet ported (a clear error): the
`paired` and `transcriptome` commands, the RNA form of `single`
(genome-dir transcriptome-dir annotation input), `.bam`, `.gz` and sorted
(`-so`) output, and `--hosts`.

    python -m snap_rnaseq_tpu_torch.cli index ref.fa idx
    python -m snap_rnaseq_tpu_torch.cli single idx reads.fq -o out.sam
"""
from __future__ import annotations

import argparse
import itertools
import sys
import time

# index caching across chained runs (AlignerContext.cpp:42-47)
_INDEX_CACHE: dict[str, object] = {}


class NotPorted(SystemExit):
    """A feature of the JAX package's CLI that this port does not have yet."""

    def __init__(self, what: str):
        super().__init__(f"snap_rnaseq_tpu_torch: {what} is not yet ported "
                         "(use the JAX package, snap_rnaseq_tpu.cli)")


def _load_index_cached(directory: str):
    from .index.hash_index import GenomeIndex
    idx = _INDEX_CACHE.get(directory)
    if idx is None:
        idx = GenomeIndex.load(directory)
        _INDEX_CACHE[directory] = idx
    return idx


def _add_align_flags(p: argparse.ArgumentParser):
    from .constants import SINGLE_DEFAULTS as d
    p.add_argument("-o", dest="output", required=True,
                   help="output path (.sam)")
    p.add_argument("--device", dest="device", default="cuda",
                   help="torch device the engine runs on (default cuda; "
                        "cpu runs the plain PyTorch versions)")
    p.add_argument("-so", dest="sorted_output", action="store_true",
                   help="sort output by alignment location (not yet ported)")
    p.add_argument("-d", dest="max_dist", default=str(d["max_dist"]),
                   help="maximum edit distance (or range n1:s:n2)")
    p.add_argument("-n", dest="num_seeds", type=int, default=d["num_seeds"],
                   help="number of seeds to apply per read")
    p.add_argument("-sc", dest="seed_coverage", type=float, default=0.0,
                   help="seed coverage readLen/seedLen (exclusive with -n)")
    p.add_argument("-h", dest="max_hits", default=str(d["max_hits"]),
                   help="maximum hits per seed before it is skipped "
                        "(or range n1:s:n2)")
    p.add_argument("-c", dest="conf_diff", type=int, default=2,
                   help="confidence threshold")
    p.add_argument("-e", dest="compute_error", action="store_true",
                   help="compute error rate assuming wgsim-generated reads")
    p.add_argument("-x", dest="explore_popular", action="store_true",
                   help="explore some hits of overly popular seeds")
    p.add_argument("-f", dest="stop_on_first", action="store_true",
                   help="stop on first match within edit distance "
                        "(filtering mode)")
    p.add_argument("-F", dest="pass_filter", choices=["a", "s", "u"],
                   default="", help="filter output (a=aligned, s=single, "
                                    "u=unaligned)")
    p.add_argument("-D", dest="extra_search_depth", type=int, default=2)
    p.add_argument("-E", dest="misalign_threshold", type=int, default=15,
                   help="min distance from true location to count as error")
    p.add_argument("-M", dest="use_m", action="store_true",
                   help="use M in CIGAR instead of =/X")
    p.add_argument("-C", dest="clipping", default="++",
                   help="clipping: ++ front+back, x+ back only, +x front "
                        "only, xx none")
    p.add_argument("-rg", dest="read_group", default="FASTQ")
    p.add_argument("-fm", dest="min_phred", type=int, default=20)
    p.add_argument("-fp", dest="min_percent", type=float, default=90.0)
    p.add_argument("-fo", dest="phred_offset", type=int, default=33)
    p.add_argument("-pf", dest="perf_file", default=None,
                   help="append a run-speed TSV row to this file")
    p.add_argument("-S", dest="suppress", default="",
                   help="suppress sorted-BAM extras (accepted)")
    p.add_argument("-bs", dest="batch_size", type=int, default=256,
                   help="device batch size (reads per dispatch)")
    # accepted for compatibility with the reference surface
    # (AlignerOptions.cpp:252-346)
    p.add_argument("-t", dest="_threads", type=int, default=0)
    p.add_argument("-b", dest="_bind", action="store_true")
    p.add_argument("-P", dest="_no_prefetch", action="store_true")
    p.add_argument("--hp", dest="_no_hugepages", action="store_true")
    p.add_argument("-G", dest="_gap_penalty", type=int, default=0)
    p.add_argument("-a", dest="_deprecated_a", default=None)
    p.add_argument("--help", action="help")
    p.add_argument("--hosts", dest="n_hosts", type=int, default=1)


def _clip_mode(s: str) -> int:
    from .io.reads import CLIP_BACK, CLIP_FRONT, CLIP_FRONT_AND_BACK, NO_CLIPPING
    return {"++": CLIP_FRONT_AND_BACK, "x+": CLIP_BACK,
            "+x": CLIP_FRONT, "xx": NO_CLIPPING}.get(s, CLIP_FRONT_AND_BACK)


def _append_perf(path, label, stats):
    if not path:
        return
    with open(path, "a") as f:
        counters = " ".join(f"{k}={v}" for k, v in
                            sorted(stats.engine_counters.items()))
        f.write(f"{label}\t{stats.total_reads}\t{stats.useful_reads}\t"
                f"{stats.align_time:.3f}\t{stats.reads_per_second:.0f}\t"
                f"{counters}\n")


def _sweep(a):
    """(max_dist, max_hits) iteration grid (AlignerContext.cpp:357-369)."""
    from .utils.range_param import Range
    dist = Range.parse(a.max_dist)
    hits = Range.parse(a.max_hits)
    return list(itertools.product(hits.values(), dist.values()))


def cmd_index(argv):
    p = argparse.ArgumentParser(prog="snap-rna index", add_help=True)
    p.add_argument("fasta")
    p.add_argument("directory")
    p.add_argument("-s", dest="seed_len", type=int, default=20)
    p.add_argument("-lf", dest="load_factor", type=float, default=0.7)
    p.add_argument("-hg19", action="store_true",
                   help="accepted for reference compatibility")
    p.add_argument("-chunked", action="store_true",
                   help="memory-bounded build (bit-identical output)")
    a = p.parse_args(argv)
    from .index.genome import read_fasta_genome
    from .index.hash_index import build_index, build_index_chunked
    t0 = time.time()
    genome = read_fasta_genome(a.fasta)
    builder = build_index_chunked if a.chunked else build_index
    idx = builder(genome, a.seed_len, load_factor=a.load_factor, verbose=True)
    idx.save(a.directory)
    dt = time.time() - t0
    print(f"indexed {genome.num_bases:,} bases in {dt:.1f}s "
          f"({genome.num_bases / max(dt, 1e-9):,.0f} bases/s)")
    return 0


def _positional_split(args):
    """Split positionals from flags (reference-style fixed positionals)."""
    pos, rest = [], []
    i = 0
    while i < len(args):
        if args[i].startswith("-"):
            rest = args[i:]
            break
        pos.append(args[i])
        i += 1
    return pos, rest


def cmd_single(argv):
    pos, flags = _positional_split(argv)
    p = argparse.ArgumentParser(prog="snap-rna single", add_help=False)
    _add_align_flags(p)
    a = p.parse_args(flags)

    import os as _os

    from .models.pipeline import PipelineOptions, SingleEndPipeline

    if len(pos) >= 4 and _os.path.isdir(pos[1]):
        raise NotPorted("RNA alignment (single <genome-dir> "
                        "<transcriptome-dir> <annotation> ...)")
    if len(pos) < 2:
        print("usage: snap-rna single <genome-dir> <input>... -o out.sam",
              file=sys.stderr)
        return 2
    lower = a.output.lower()
    if lower.endswith(".bam"):
        raise NotPorted("BAM output")
    if lower.endswith(".gz"):
        raise NotPorted("gzip SAM output")
    if a.sorted_output:
        raise NotPorted("sorted output (-so)")
    if a.n_hosts > 1:
        raise NotPorted("multi-host alignment (--hosts)")
    genome_dir = pos[0]
    fastq = pos[1] if len(pos) == 2 else pos[1:]

    opt = PipelineOptions(batch_size=a.batch_size, use_m=a.use_m,
                          read_group=a.read_group,
                          clipping=_clip_mode(a.clipping),
                          compute_error=a.compute_error,
                          pass_filter=a.pass_filter,
                          misalign_threshold=a.misalign_threshold,
                          min_phred=a.min_phred,
                          min_percent_above_phred=a.min_percent,
                          phred_offset=a.phred_offset, suppress=a.suppress)
    cmdline = "snap-rna single " + " ".join(pos + flags)
    aligner_kw = dict(num_seeds=a.num_seeds, seed_coverage=a.seed_coverage,
                      extra_search_depth=a.extra_search_depth,
                      explore_popular=a.explore_popular,
                      stop_on_first=a.stop_on_first)
    for max_hits, max_dist in _sweep(a):
        pipe = SingleEndPipeline(_load_index_cached(genome_dir),
                                 options=opt, device=a.device,
                                 max_k=max_dist, max_hits=max_hits,
                                 **aligner_kw)
        stats = pipe.run(fastq, a.output, command_line=cmdline)
        print(stats.summary())
        print(pipe.wait.summary())
        if a.compute_error:
            print(stats.roc_table())
        _append_perf(a.perf_file, f"single d={max_dist} h={max_hits}", stats)
    return 0


def _not_ported(name):
    def handler(argv):
        raise NotPorted(f"the '{name}' command")
    return handler


def _split_runs(argv):
    """Comma-chained runs: `single idx a.fq -o a.sam , single idx ...`."""
    runs, cur = [], []
    for tok in argv:
        if tok == ",":
            runs.append(cur)
            cur = []
        else:
            cur.append(tok)
    runs.append(cur)
    return runs


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: snap-rna {index|single} ...", file=sys.stderr)
        return 2
    handlers = {"index": cmd_index, "single": cmd_single,
                "paired": _not_ported("paired"),
                "transcriptome": _not_ported("transcriptome"),
                "trace": _not_ported("trace")}
    for run in _split_runs(argv):
        if not run:
            continue
        cmd, rest = run[0], run[1:]
        handler = handlers.get(cmd)
        if handler is None:
            print(f"unknown subcommand {cmd!r}", file=sys.stderr)
            return 2
        rc = handler(rest)
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
