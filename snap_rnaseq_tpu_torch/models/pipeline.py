"""Host pipelines: stream reads -> batch -> device engine -> SAM.

Analog of the per-thread loops in reference SingleAligner.cpp:241-303 and
the surrounding AlignerContext orchestration, restructured for a device:
instead of one read at a time through thread-local aligners, reads stream
into fixed-shape, same-length batches (double-buffered onto the device) and
results stream out through the batched SAM record builder.

Read-level filters mirror SingleAligner.cpp:246-257: clipped length < 50,
more Ns than max_dist, or failing the phred quality filter -> emitted
unmapped without touching the aligner.

Port of snap_rnaseq_tpu/models/pipeline.py: the engine and the CIGAR
kernel run on the aligner's device; the drain fetches each batch's result
dict with one grouped device-to-host copy (models/single.py fetch).
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from dataclasses import dataclass

import torch

from ..constants import DEFAULT_MIN_READ_LENGTH
from ..index.hash_index import GenomeIndex
from ..io.readers import open_multi_read_supplier, open_read_supplier
from ..io.reads import CLIP_FRONT_AND_BACK, clip_read, count_ns, make_batch, quality_filter
from ..io.sam import NOT_FOUND, passes_filter
from ..io.writers import make_output_and_builder
from ..utils.async_stages import OrderedWorker, PrefetchIterator
from ..utils.stats import AlignerStats, WaitProfile, span
from ..utils.wgsim import wgsim_misaligned
from .single import SingleAligner, SingleAlignerConfig, fetch


@dataclass
class PipelineOptions:
    batch_size: int = 256
    use_m: bool = False
    read_group: str | None = "FASTQ"
    clipping: int = CLIP_FRONT_AND_BACK
    min_read_length: int = DEFAULT_MIN_READ_LENGTH
    compute_error: bool = False          # -e: wgsim accuracy oracle
    misalign_threshold: int = 15         # -E
    sorted_output: bool = False          # -so
    pass_filter: str = ""                # -F: a/s/u output filter
    min_phred: int = 20                  # -fm
    min_percent_above_phred: float = 90.0  # -fp
    phred_offset: int = 33               # -fo
    suppress: str = ""                   # -S: i=bam index, d=dup marking

    def quality_ok(self, read) -> bool:
        return quality_filter(read, self.min_percent_above_phred,
                              self.min_phred, self.phred_offset)


class SingleEndPipeline:
    """Genome-only single-end alignment: FASTQ(.gz) -> SAM."""

    def __init__(self, index: GenomeIndex, aligner_config: SingleAlignerConfig | None = None,
                 options: PipelineOptions | None = None,
                 aligner: SingleAligner | None = None, device="cuda",
                 **aligner_overrides):
        self.index = index
        # aligner: reuse a device-resident engine
        self.aligner = aligner or SingleAligner(index, aligner_config,
                                                device=device,
                                                **aligner_overrides)
        self.opt = options or PipelineOptions()
        self.stats = AlignerStats()
        self.wait = WaitProfile()

    def run(self, fastq_path: str, out_path: str, command_line: str = "snap-rna-tpu"):
        opt = self.opt
        stats = self.stats
        maxk = self.aligner.cfg.max_k
        out, builder = make_output_and_builder(
            out_path, self.index.genome, sorted_output=opt.sorted_output,
            use_m=opt.use_m, read_group=opt.read_group,
            command_line=command_line,
            mark_duplicates="d" not in opt.suppress,
            build_index="i" not in opt.suppress,
            device=self.aligner.device)
        try:
            buckets: dict[int, list] = defaultdict(list)
            t0 = time.time()
            # three-stage async flow (utils/async_stages.py): reader thread
            # parses+clips+filters, main thread batches+dispatches, writer
            # thread fetches device results and writes records — the
            # ReadSupplierQueue / BufferedAsync analog
            writer = OrderedWorker(depth=4)

            def flush_bucket(length: int):
                reads = buckets.pop(length, [])
                if not reads:
                    return
                # fixed batch capacity -> one compiled kernel per read length
                batch = make_batch(reads, length, opt.batch_size)
                out_dev = self.aligner.align_batch_device(
                    torch.from_numpy(batch.codes),
                    torch.from_numpy(batch.quals))
                writer.submit(drain, reads, out_dev)

            def drain(reads, out_dev):
                with span("pipeline.device"):
                    res = fetch(out_dev)
                stats.lv_calls += int(res["n_lookups"])
                stats.popular_skipped += int(res["popular"].sum())
                stats.truncated_candidates += int((res["truncated"] > 0).sum())
                for c in ("n_lookups", "n_candidates", "n_unique_candidates",
                          "n_scored", "n_bucket2", "score_overflow"):
                    if c in res:
                        stats.count(c, res[c])
                for i, r in enumerate(reads):
                    result = int(res["result"][i])
                    loc = int(res["loc"][i])
                    direction = int(res["direction"][i])
                    mapq = int(res["mapq"][i])
                    was_error = False
                    if result != NOT_FOUND and opt.compute_error:
                        was_error = wgsim_misaligned(
                            r, loc, self.index.genome, opt.misalign_threshold)
                    if result == 1:
                        stats.single_hits += 1
                    elif result == 2:
                        stats.multi_hits += 1
                    else:
                        stats.not_found += 1
                    if result != NOT_FOUND:
                        stats.record_mapq(mapq, was_error)
                    if passes_filter(result, opt.pass_filter):
                        builder.add(r, result,
                                    loc if result != NOT_FOUND else -1,
                                    direction, mapq,
                                    score=int(res["score"][i]))
                with span("pipeline.write"):
                    builder.flush(out)

            if isinstance(fastq_path, (list, tuple)):
                supplier = open_multi_read_supplier(fastq_path)
            elif isinstance(fastq_path, (str, os.PathLike)):
                supplier = open_read_supplier(fastq_path)
            else:
                # pre-built read iterator
                supplier = fastq_path
            def emit_filtered(read):
                stats.not_found += 1
                if passes_filter(NOT_FOUND, opt.pass_filter):
                    builder.add(read, NOT_FOUND, -1, 0, 0)

            def read_stage():
                # runs on the reader thread: parse + clip + quality gates
                for read in supplier:
                    clip_read(read, opt.clipping)
                    bad = (read.data_length < opt.min_read_length
                           or count_ns(read) > maxk
                           or not opt.quality_ok(read))
                    yield bad, read

            n_total = n_useful = 0
            for bad, read in PrefetchIterator(read_stage()):
                n_total += 1
                if bad:
                    writer.submit(emit_filtered, read)
                    continue
                n_useful += 1
                L = read.data_length
                buckets[L].append(read)
                if len(buckets[L]) >= opt.batch_size:
                    flush_bucket(L)
            for L in list(buckets):
                flush_bucket(L)
            writer.close()
            stats.total_reads += n_total
            stats.useful_reads += n_useful
            builder.flush(out)
            stats.align_time = time.time() - t0
        finally:
            out.close()
        return stats
