"""Paired-end host pipeline: two FASTQs -> batches -> paired engine -> SAM.

Port of snap_rnaseq_tpu/models/paired_pipeline.py, the analog of
PairedAlignerContext::runIterationThread (PairedAligner.cpp:547-668)
without the RNA layer: per-pair quality filters, paired alignment with
chimeric fallback, SAM emission with mate fields/TLEN.

Two routes, with byte-identical records:
* bulk (plain/gz FASTQ pairs in, SAM text out): io/bulk.py scans records
  into (B, L) matrices, the main thread dispatches each block to the
  engine, and a writer thread fetches the results and emits the records
  vectorized.  Each batch's 14 result rows and scalar counters are stacked
  on the device and copied to the host once.
* per-read (everything else, and SNAP_TPU_BULK_IO=0): Read objects through
  a reader thread, the SamRecordBuilder on a writer thread.
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import DEFAULT_MIN_READ_LENGTH
from ..index.hash_index import GenomeIndex
from ..io.readers import open_paired_read_supplier
from ..io.reads import (CLIP_FRONT_AND_BACK, clip_read, count_ns, make_batch,
                        quality_filter)
from ..io.sam import NOT_FOUND, passes_filter
from ..io.writers import make_output_and_builder
from ..utils.async_stages import OrderedWorker, PrefetchIterator
from ..utils.stats import PairedAlignerStats, WaitProfile, each, span
from ..utils.wgsim import wgsim_misaligned
from .paired import PairedAligner, PairedAlignerConfig
from .single import fetch

# per-pair result rows and scalar counters fetched by the bulk path
PACK_KEYS = ("result0", "result1", "loc0", "loc1", "dir0", "dir1", "mapq0",
             "mapq1", "score0", "score1", "pair_found", "pair_score",
             "truncated0", "truncated1")
SCALAR_KEYS = ("n_lookups0", "n_lookups1", "n_candidates0", "n_candidates1",
               "n_scored0", "n_scored1", "score_overflow0",
               "score_overflow1", "n_lookups", "n_candidates", "n_scored",
               "score_overflow")


@dataclass
class PairedPipelineOptions:
    batch_size: int = 256
    use_m: bool = False
    read_group: str | None = "FASTQ"
    clipping: int = CLIP_FRONT_AND_BACK
    min_read_length: int = DEFAULT_MIN_READ_LENGTH
    compute_error: bool = False
    misalign_threshold: int = 15         # -E
    min_spacing: int = 50
    max_spacing: int = 1000
    sorted_output: bool = False          # -so
    pass_filter: str = ""                # -F
    min_phred: int = 20                  # -fm
    min_percent_above_phred: float = 90.0  # -fp
    phred_offset: int = 33               # -fo
    suppress: str = ""                   # -S: i=bam index, d=dup marking
    ignore_mismatched_ids: bool = False  # -I (PairedAligner.cpp:445)

    def quality_ok(self, read) -> bool:
        return quality_filter(read, self.min_percent_above_phred,
                              self.min_phred, self.phred_offset)


def _pack(out: dict) -> torch.Tensor:
    """One int32 vector: the (14, B) per-pair rows, flattened, then the
    scalar counters (-1 for a counter the engine does not emit)."""
    rows = torch.stack([out[k].to(torch.int32) for k in PACK_KEYS])
    minus1 = torch.full((), -1, dtype=torch.int32, device=rows.device)
    scal = torch.stack([out[k].to(torch.int32).reshape(()) if k in out
                        else minus1 for k in SCALAR_KEYS])
    return torch.cat([rows.reshape(-1), scal])


class PairedEndPipeline:
    def __init__(self, index: GenomeIndex,
                 config: PairedAlignerConfig | None = None,
                 options: PairedPipelineOptions | None = None,
                 aligner: PairedAligner | None = None, device="cuda",
                 **aligner_overrides):
        self.index = index
        self.opt = options or PairedPipelineOptions()
        # aligner: reuse a device-resident engine
        self.aligner = aligner or PairedAligner(
            index, config, device=device,
            min_spacing=self.opt.min_spacing,
            max_spacing=self.opt.max_spacing,
            **aligner_overrides)
        self.stats = PairedAlignerStats()
        self.wait = WaitProfile()

    def _dispatch(self, c0, q0, c1, q1):
        return self.aligner.align_batch_device(
            *(torch.from_numpy(np.ascontiguousarray(a))
              for a in (c0, q0, c1, q1)))

    def run(self, fq0, fq1, out_path: str, command_line: str = "snap-rna"):
        """FASTQ pair -> SAM/BAM.  Plain/gz FASTQ inputs with SAM-text
        output take the bulk path (io/bulk.py); everything else (SAM/BAM
        input, several file pairs, pre-built iterators) the per-read
        path."""
        if (isinstance(fq0, (str, os.PathLike)) and fq1 is not None
                and not isinstance(fq1, (list, tuple))
                and not str(fq0).lower().endswith((".sam", ".bam"))
                and not str(out_path).lower().endswith(".bam")
                and os.environ.get("SNAP_TPU_BULK_IO", "1") == "1"):
            return self._run_bulk(fq0, fq1, out_path, command_line)
        return self._run_legacy(fq0, fq1, out_path, command_line)

    def _run_bulk(self, fq0, fq1, out_path, command_line):
        from ..io.bulk import (BulkSamEmitter, build_end_block,
                               ids_match_vec, paired_record_blocks)
        opt = self.opt
        stats = self.stats
        maxk = self.aligner.cfg.max_k
        genome = self.index.genome
        out, builder = make_output_and_builder(
            out_path, genome, sorted_output=opt.sorted_output,
            use_m=opt.use_m, read_group=opt.read_group,
            command_line=command_line,
            mark_duplicates="d" not in opt.suppress,
            build_index="i" not in opt.suppress,
            device=self.aligner.device)
        emitter = BulkSamEmitter(genome, use_m=opt.use_m,
                                 read_group=opt.read_group,
                                 device=self.aligner.device)
        check_err = None
        if opt.compute_error:
            check_err = lambda r, loc: wgsim_misaligned(
                r, loc, genome, opt.misalign_threshold)
        try:
            writer = OrderedWorker(depth=4)
            B = opt.batch_size
            L_eng = None
            n_total = n_useful = 0
            overflow_pairs = []
            warmed = False
            t0 = time.time()            # reset after the warm-up batch

            def bulk_drain(b0, b1, bad, excl, packed):
                with span("pipeline.device"):
                    flat = packed.cpu().numpy()
                scal = flat[len(flat) - len(SCALAR_KEYS):]
                rows = flat[:len(flat) - len(SCALAR_KEYS)].reshape(
                    len(PACK_KEYS), -1)
                res = {k: rows[i] for i, k in enumerate(PACK_KEYS)}
                for i, k in enumerate(SCALAR_KEYS):
                    if scal[i] >= 0:
                        res[k] = scal[i]
                stats.truncated_candidates += int(
                    (res["truncated0"] > 0).sum()
                    + (res["truncated1"] > 0).sum())
                for c in ("n_lookups", "n_candidates", "n_scored",
                          "score_overflow"):
                    for e in ("0", "1", ""):
                        if c + e in res:
                            stats.count(c, res[c + e])
                with span("pipeline.write"):
                    emitter.emit_pairs(b0, b1, res, bad, out, stats,
                                       pass_filter=opt.pass_filter,
                                       compute_error=check_err,
                                       exclude=excl)

            def mk_end(buf, recs):
                return build_end_block(
                    buf, recs, L_eng, opt.min_read_length, maxk,
                    clipping=opt.clipping, min_phred=opt.min_phred,
                    min_percent=opt.min_percent_above_phred,
                    phred_offset=opt.phred_offset)

            for (buf0, recs0), (buf1, recs1) in each(
                    "pipeline.read", paired_record_blocks(fq0, fq1, B)):
                if L_eng is None:
                    L_eng = int(max(recs0[:, 3].max(), recs1[:, 3].max()))
                b0 = mk_end(buf0, recs0)
                b1 = mk_end(buf1, recs1)
                if not opt.ignore_mismatched_ids:
                    mm = ids_match_vec(b0, b1)
                    if not mm.all():
                        i = int(np.flatnonzero(~mm)[0])
                        r0i, r1i = b0.read_at(i), b1.read_at(i)
                        raise ValueError(
                            f"Unmatched read IDs {r0i.rid!r} and "
                            f"{r1i.rid!r}.  Use the -I option to ignore "
                            "this.")
                excl = None
                if len(b0.overflow) or len(b1.overflow):
                    # reads longer than the engine width: per-read path
                    ov = sorted(set(b0.overflow) | set(b1.overflow))
                    for i in ov:
                        overflow_pairs.append((b0.read_at(i),
                                               b1.read_at(i)))
                    excl = np.zeros(b0.n, bool)
                    excl[np.asarray(ov, np.int64)] = True
                bad = (~b0.useful & ~b1.useful) | ~b0.quality_ok
                n = b0.n
                n_total += 2 * n
                n_useful += int(np.where(
                    bad, 0, np.where(b0.useful & b1.useful, 2, 1)).sum())
                c0, q0, c1, q1 = b0.codes, b0.equals, b1.codes, b1.equals
                if n < B:       # pad to the batch shape
                    pad = ((0, B - n), (0, 0))
                    c0 = np.pad(c0, pad, constant_values=4)
                    c1 = np.pad(c1, pad, constant_values=4)
                    q0 = np.pad(q0, pad, constant_values=ord("!"))
                    q1 = np.pad(q1, pad, constant_values=ord("!"))
                if not warmed:
                    # the first dispatch builds and loads the kernels;
                    # keep it out of align_time, as the reference times
                    # alignment only (AlignerContext.cpp:382-393)
                    fetch(self._dispatch(c0, q0, c1, q1))
                    warmed = True
                    t0 = time.time()
                writer.submit(bulk_drain, b0, b1, bad, excl,
                              _pack(self._dispatch(c0, q0, c1, q1)))
            writer.close()
            stats.total_reads += n_total
            stats.useful_reads += n_useful
            if overflow_pairs:
                self._legacy_pairs(overflow_pairs, out, builder)
            builder.flush(out)
            stats.align_time = time.time() - t0
        finally:
            out.close()
        return stats

    def _emit_pair_records(self, builder, r0, r1, res0, loc0, dir0, mq0,
                           sc0, res1, loc1, dir1, mq1, sc1, paired,
                           pair_score):
        """Both records of one aligned pair + their stats."""
        opt = self.opt
        stats = self.stats
        emit = passes_filter(res0, opt.pass_filter) or \
            passes_filter(res1, opt.pass_filter)
        for r, res, loc, d, mq, sc, mate_read, mres, mloc, mdir, first in (
                (r0, res0, loc0, dir0, mq0, sc0, r1, res1, loc1, dir1, True),
                (r1, res1, loc1, dir1, mq1, sc1, r0, res0, loc0, dir0,
                 False)):
            if emit:
                builder.add(r, res, loc if res != NOT_FOUND else -1, d, mq,
                            score=sc,
                            mate=dict(result=mres,
                                      location=mloc if mres != NOT_FOUND
                                      else -1,
                                      direction=mdir, read=mate_read,
                                      first=first))
            if res == 1:
                stats.single_hits += 1
            elif res == 2:
                stats.multi_hits += 1
            else:
                stats.not_found += 1
            if res != NOT_FOUND:
                was_err = opt.compute_error and wgsim_misaligned(
                    r, loc, self.index.genome, opt.misalign_threshold)
                stats.record_mapq(mq, was_err)
        if paired:
            stats.aligned_as_pairs += 2
            stats.record_pair(loc1 - loc0, pair_score)

    def _emit_batch(self, builder, pairs, res):
        for i, (r0, r1) in enumerate(pairs):
            self._emit_pair_records(
                builder, r0, r1,
                int(res["result0"][i]), int(res["loc0"][i]),
                int(res["dir0"][i]), int(res["mapq0"][i]),
                int(res["score0"][i]),
                int(res["result1"][i]), int(res["loc1"][i]),
                int(res["dir1"][i]), int(res["mapq1"][i]),
                int(res["score1"][i]),
                bool(res["pair_found"][i]), int(res["pair_score"][i]))

    def _legacy_pairs(self, pairs, out, builder):
        """Per-read path for rare pairs the bulk path cannot batch (reads
        longer than the engine width)."""
        opt = self.opt
        buckets = defaultdict(list)
        for r0, r1 in pairs:
            L = max(r0.data_length, r1.data_length)
            buckets[L].append((r0, r1))
        for L, ps in buckets.items():
            for s in range(0, len(ps), opt.batch_size):
                chunk = ps[s:s + opt.batch_size]
                b0 = make_batch([p[0] for p in chunk], L, opt.batch_size)
                b1 = make_batch([p[1] for p in chunk], L, opt.batch_size)
                res = fetch(self._dispatch(b0.codes, b0.quals, b1.codes,
                                           b1.quals))
                self._emit_batch(builder, chunk, res)

    def _run_legacy(self, fq0, fq1, out_path, command_line: str = "snap-rna"):
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
            buckets = defaultdict(list)
            t0 = time.time()
            writer = OrderedWorker(depth=4)

            def flush_bucket(L):
                pairs = buckets.pop(L, [])
                if not pairs:
                    return
                b0 = make_batch([p[0] for p in pairs], L, opt.batch_size)
                b1 = make_batch([p[1] for p in pairs], L, opt.batch_size)
                writer.submit(drain, pairs,
                              self._dispatch(b0.codes, b0.quals, b1.codes,
                                             b1.quals))

            def drain(pairs, out_dev):
                with span("pipeline.device"):
                    res = fetch(out_dev)
                stats.truncated_candidates += int(
                    (res["truncated0"] > 0).sum()
                    + (res["truncated1"] > 0).sum())
                for c in ("n_lookups", "n_candidates", "n_scored",
                          "score_overflow"):
                    for e in ("0", "1", ""):
                        if c + e in res:
                            stats.count(c, res[c + e])
                self._emit_batch(builder, pairs, res)
                with span("pipeline.write"):
                    builder.flush(out)

            if isinstance(fq0, (str, os.PathLike)) or fq1 is not None:
                pair_iter = open_paired_read_supplier(
                    fq0, fq1, check_ids=not opt.ignore_mismatched_ids)
            else:
                pair_iter = fq0            # a pre-built (r0, r1) iterator

            def emit_filtered(r0, r1):
                stats.not_found += 2
                if passes_filter(NOT_FOUND, opt.pass_filter):
                    builder.add(r0, NOT_FOUND, -1, 0, 0,
                                mate=dict(result=NOT_FOUND, location=-1,
                                          direction=0, read=r1, first=True))
                    builder.add(r1, NOT_FOUND, -1, 0, 0,
                                mate=dict(result=NOT_FOUND, location=-1,
                                          direction=0, read=r0, first=False))

            def read_stage():
                # reader thread: parse + clip + quality gates.  The pair is
                # skipped only when BOTH ends are useless or the quality
                # gate fails ("maybe we can align the other",
                # PairedAligner.cpp:558-575).  The reference's quality gate
                # is literally (!quality0 || !quality0): read1's quality is
                # never consulted (reproduced for parity).
                for r0, r1 in pair_iter:
                    clip_read(r0, opt.clipping)
                    clip_read(r1, opt.clipping)
                    useful0 = (r0.data_length >= opt.min_read_length
                               and count_ns(r0) <= maxk)
                    useful1 = (r1.data_length >= opt.min_read_length
                               and count_ns(r1) <= maxk)
                    bad = ((not useful0 and not useful1)
                           or not opt.quality_ok(r0))
                    yield bad, useful0 and useful1, r0, r1

            n_total = n_useful = 0
            for bad, both_useful, r0, r1 in PrefetchIterator(read_stage()):
                n_total += 2
                if bad:
                    writer.submit(emit_filtered, r0, r1)
                    continue
                n_useful += 2 if both_useful else 1
                # a mixed-length pair is bucketed by the max, N-padded
                L = max(r0.data_length, r1.data_length)
                buckets[L].append((r0, r1))
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
