"""snap-rna command line of the PyTorch/CUDA port.

Port of snap_rnaseq_tpu/cli.py (reference apps/snap/Main.cpp:42-86 +
AlignerOptions.cpp), with the subcommands this port carries:

  index         <ref.fa> <index-dir> [-s seedLen] [-lf loadFactor]
  transcriptome <annotation.gtf> <ref.fa> <index-dir> [-s seedLen]
  single        <genome-dir> [<transcriptome-dir> <annotation>] <input>...
                -o out [-so] [-S id] [-ct contamination-dir]
                [--device cuda|cpu]
  paired        <genome-dir> [<transcriptome-dir> <annotation>] <r1> <r2>
                [<r1> <r2> ...] -o out [-so] [-S id]
                [-s minSpacing maxSpacing] [-fs] [-I] [-tmh depth]
                [-ct contamination-dir] [--device cuda|cpu]
  trace         <index-dir> <ACGT-read> [<phred33-quals>] [--device cuda|cpu]

Inputs may be FASTQ(.gz), SAM or BAM (`paired` takes one interleaved SAM
or BAM file); outputs .sam, .sam.gz or .bam, location-sorted with -so
(sorted BAM gets duplicate flags and a .bai unless -S d / -S i).

With a transcriptome directory and its annotation, `single` and `paired`
align RNA-seq reads against both indices and reconcile the hits
(rna/pipeline.py); without them they align DNA against the genome alone.
Index and transcriptome directories (and the annotation cache the
transcriptome command writes) are the JAX package's on-disk format, so
either package can read what the other wrote.  Flag names follow the
reference (AlignerOptions.cpp:94-165); -d and -h accept `n1:s:n2` ranges
(Range.h:29-56) and runs chain with a `,` argument (Main.cpp:63-80).

The engine runs on `--device`, CUDA by default; without a card that
raises rather than falling back.  SNAP_TPU_LV_LANES=onehot sends the LV
scoring to the second LV-lanes kernel (ops/lv.py).  `trace` prints one
read's pass through the flat phases (models/trace.py).  Not yet ported (a
clear error): `--hosts`.

    python -m snap_rnaseq_tpu_torch.cli index ref.fa idx
    python -m snap_rnaseq_tpu_torch.cli transcriptome anno.gtf ref.fa tidx
    python -m snap_rnaseq_tpu_torch.cli single idx reads.fq -o out.sam
    python -m snap_rnaseq_tpu_torch.cli single idx tidx anno.gtf reads.fq \
        -o rna.sam
    python -m snap_rnaseq_tpu_torch.cli paired idx tidx anno.gtf r1.fq r2.fq \
        -o rna.bam -so
    python -m snap_rnaseq_tpu_torch.cli trace idx ACGT... --device cpu
"""
from __future__ import annotations

import argparse
import itertools
import os
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


def _add_align_flags(p: argparse.ArgumentParser, paired: bool = False):
    from .constants import PAIRED_DEFAULTS, SINGLE_DEFAULTS
    d = PAIRED_DEFAULTS if paired else SINGLE_DEFAULTS
    p.add_argument("-o", dest="output", required=True,
                   help="output path (.sam, .sam.gz, or .bam)")
    p.add_argument("--device", dest="device", default="cuda",
                   help="torch device the engine runs on (default cuda; "
                        "cpu runs the plain PyTorch versions)")
    p.add_argument("-so", dest="sorted_output", action="store_true",
                   help="sort output by alignment location")
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
    p.add_argument("-ct", dest="contamination_dir", default=None,
                   help="contamination database directory (RNA forms)")
    p.add_argument("-pf", dest="perf_file", default=None,
                   help="append a run-speed TSV row to this file")
    p.add_argument("-S", dest="suppress", default="",
                   help="suppress sorted-BAM extras: i=index, d=duplicate "
                        "marking (e.g. -S id)")
    p.add_argument("-sm", dest="sort_memory_gb", type=float, default=0.0,
                   help="accepted for compatibility; sorting here streams "
                        "through a fixed-size spill buffer")
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
    if paired:
        p.add_argument("-s", dest="spacing", type=int, nargs=2,
                       default=[d["min_spacing"], d["max_spacing"]],
                       help="min and max spacing for paired ends")
        p.add_argument("-fs", dest="force_spacing", action="store_true",
                       help="force spacing to lie between min and max")
        p.add_argument("-tmh", dest="transcriptome_multi_hits", type=int,
                       default=1000,
                       help="transcriptome multi-hit depth per end "
                            "(reference maxHitsToGet, PairedAligner.cpp:584)")
        p.add_argument("-I", dest="ignore_mismatched_ids",
                       action="store_true",
                       help="don't require mate read IDs to match")


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


def cmd_transcriptome(argv):
    p = argparse.ArgumentParser(prog="snap-rna transcriptome")
    p.add_argument("gtf")
    p.add_argument("fasta")
    p.add_argument("directory")
    p.add_argument("-s", dest="seed_len", type=int, default=20)
    a = p.parse_args(argv)
    from .index.genome import read_fasta_genome
    from .index.hash_index import build_index
    from .rna.gtf import GTFReader
    from .rna.transcriptome import build_transcriptome_genome
    t0 = time.time()
    genome = read_fasta_genome(a.fasta)
    gtf = GTFReader.load(a.gtf)
    tgenome = build_transcriptome_genome(gtf, genome)
    idx = build_index(tgenome, a.seed_len)
    idx.save(a.directory)
    gtf.save_cache(a.directory)
    print(f"transcriptome: {tgenome.num_pieces} transcripts, "
          f"{tgenome.num_bases:,} bases in {time.time() - t0:.1f}s")
    return 0


def _is_index_dir(d):
    if not os.path.isdir(d):
        return False
    if os.path.exists(os.path.join(d, "index.json")):
        return True
    from .index.snap_format import is_snap_format_dir
    return is_snap_format_dir(d)


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


def _refuse_unported(a):
    if a.n_hosts > 1:
        raise NotPorted("multi-host alignment (--hosts)")


def cmd_single(argv):
    pos, flags = _positional_split(argv)
    p = argparse.ArgumentParser(prog="snap-rna single", add_help=False)
    _add_align_flags(p)
    a = p.parse_args(flags)

    from .models.pipeline import PipelineOptions, SingleEndPipeline

    if len(pos) >= 4 and _is_index_dir(pos[1]):
        genome_dir, transcriptome_dir, annotation = pos[:3]
        fastq = pos[3] if len(pos) == 4 else pos[3:]
    elif len(pos) >= 2:
        genome_dir = pos[0]
        transcriptome_dir = annotation = None
        fastq = pos[1] if len(pos) == 2 else pos[1:]
    else:
        print("usage: snap-rna single <genome-dir> "
              "[<transcriptome-dir> <annotation>] <input>... -o out.sam",
              file=sys.stderr)
        return 2
    _refuse_unported(a)

    opt = PipelineOptions(batch_size=a.batch_size, use_m=a.use_m,
                          read_group=a.read_group,
                          clipping=_clip_mode(a.clipping),
                          compute_error=a.compute_error,
                          sorted_output=a.sorted_output,
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
        if transcriptome_dir is None:
            pipe = SingleEndPipeline(_load_index_cached(genome_dir),
                                     options=opt, device=a.device,
                                     max_k=max_dist, max_hits=max_hits,
                                     **aligner_kw)
        else:
            from .rna.pipeline import RnaSingleEndPipeline
            pipe = RnaSingleEndPipeline(
                genome_dir, transcriptome_dir, annotation, options=opt,
                contamination_dir=a.contamination_dir, conf_diff=a.conf_diff,
                device=a.device, max_k=max_dist, max_hits=max_hits,
                **aligner_kw)
        stats = pipe.run(fastq, a.output, command_line=cmdline)
        print(stats.summary())
        print(pipe.wait.summary())
        if a.compute_error:
            print(stats.roc_table())
        _append_perf(a.perf_file, f"single d={max_dist} h={max_hits}", stats)
    return 0


def _split_inputs(inputs):
    """Input file list -> (fq1, fq2): one interleaved file, one r1/r2
    pair, or several consecutive pairs (the reference's 'FASTQ files must
    come in pairs' multi-input form)."""
    if len(inputs) == 1:
        return inputs[0], None
    if len(inputs) == 2:
        return inputs[0], inputs[1]
    if len(inputs) % 2:
        raise SystemExit("paired FASTQ inputs must come in pairs")
    return list(inputs[0::2]), list(inputs[1::2])


def cmd_paired(argv):
    pos, flags = _positional_split(argv)
    p = argparse.ArgumentParser(prog="snap-rna paired", add_help=False)
    _add_align_flags(p, paired=True)
    a = p.parse_args(flags)

    from .models.paired_pipeline import (PairedEndPipeline,
                                         PairedPipelineOptions)

    if len(pos) >= 4 and os.path.isdir(pos[1]):
        genome_dir, transcriptome_dir, annotation = pos[:3]
        inputs = pos[3:]
    elif len(pos) >= 2:
        genome_dir = pos[0]
        transcriptome_dir = annotation = None
        inputs = pos[1:]
    else:
        print("usage: snap-rna paired <genome-dir> "
              "[<transcriptome-dir> <annotation>] <r1> <r2> [...] "
              "-o out.sam", file=sys.stderr)
        return 2
    _refuse_unported(a)
    fq1, fq2 = _split_inputs(inputs)

    opt = PairedPipelineOptions(
        batch_size=a.batch_size, use_m=a.use_m, read_group=a.read_group,
        clipping=_clip_mode(a.clipping), compute_error=a.compute_error,
        min_spacing=a.spacing[0], max_spacing=a.spacing[1],
        sorted_output=a.sorted_output,
        pass_filter=a.pass_filter, misalign_threshold=a.misalign_threshold,
        min_phred=a.min_phred, min_percent_above_phred=a.min_percent,
        phred_offset=a.phred_offset, suppress=a.suppress,
        ignore_mismatched_ids=a.ignore_mismatched_ids)
    cmdline = "snap-rna paired " + " ".join(pos + flags)
    for max_hits, max_dist in _sweep(a):
        if transcriptome_dir is None:
            pipe = PairedEndPipeline(_load_index_cached(genome_dir),
                                     options=opt, device=a.device,
                                     max_k=max_dist, max_hits=max_hits,
                                     num_seeds=a.num_seeds,
                                     extra_search_depth=a.extra_search_depth,
                                     force_spacing=a.force_spacing)
        else:
            from .rna.pipeline import RnaPairedEndPipeline
            pipe = RnaPairedEndPipeline(
                genome_dir, transcriptome_dir, annotation, options=opt,
                contamination_dir=a.contamination_dir, conf_diff=a.conf_diff,
                transcriptome_multi_hits=a.transcriptome_multi_hits,
                force_spacing=a.force_spacing, device=a.device,
                max_k=max_dist, max_hits=max_hits, num_seeds=a.num_seeds,
                extra_search_depth=a.extra_search_depth)
        stats = pipe.run(fq1, fq2, a.output, command_line=cmdline)
        print(stats.summary())
        print(pipe.wait.summary())
        if a.compute_error:
            print(stats.roc_table())
        _append_perf(a.perf_file, f"paired d={max_dist} h={max_hits}", stats)
    return 0


def cmd_trace(argv):
    """Per-read trace (the _DumpAlignments analog, BaseAligner.cpp:622-631):
    snap-rna trace <index-dir> <ACGT-read> [<phred33-quals>]"""
    p = argparse.ArgumentParser(prog="snap-rna trace")
    p.add_argument("index_dir")
    p.add_argument("read", help="read as an ACGT string")
    p.add_argument("quals", nargs="?", default=None,
                   help="phred+33 quality string (default all 'I')")
    p.add_argument("--device", dest="device", default="cuda",
                   help="torch device the phases run on (default cuda)")
    a = p.parse_args(argv)
    import numpy as np

    from .models.single import SingleAligner
    from .models.trace import trace_read
    from .utils.tables import encode_bases
    codes = encode_bases(a.read.strip().upper().encode())
    quals = np.frombuffer((a.quals or "I" * len(a.read)).encode(), np.uint8)
    aligner = SingleAligner(_load_index_cached(a.index_dir), device=a.device)
    print(trace_read(aligner, codes, quals))
    return 0


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
        print("usage: snap-rna {index|transcriptome|single|paired|trace} "
              "...",
              file=sys.stderr)
        return 2
    handlers = {"index": cmd_index, "transcriptome": cmd_transcriptome,
                "single": cmd_single, "paired": cmd_paired,
                "trace": cmd_trace}
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
