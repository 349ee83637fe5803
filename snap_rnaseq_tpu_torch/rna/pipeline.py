"""RNA-seq host pipelines: dual genome + transcriptome alignment.

Analog of the reference's RNA-mode per-thread loops:

* single-end: SingleAlignerContext::runIterationThread
  (SingleAligner.cpp:241-303) — transcriptome AlignRead + genome AlignRead
  -> AlignmentFilter::FilterSingle -> contamination fallback -> writeRead
  with splice-junction CIGAR rewriting;
* paired-end: PairedAlignerContext::runIterationThread
  (PairedAligner.cpp:547-668) — transcriptome multi-hit AlignRead per end +
  genome paired align -> AlignmentFilter::Filter -> contamination fallback
  -> forceSpacing fixup + MAPQ "cheese" -> writePair;
* run end: GTFReader::AnalyzeReadIntervals + WriteReadCounts +
  ContaminationFilter::Write (AlignerContext.cpp:125-132).

Port of snap_rnaseq_tpu/rna/pipeline.py.  The genome, transcriptome and
contamination aligners run on one torch device (`device=`, CUDA by
default; without a card that raises), unless the genome and transcriptome
aligners are given (`g_aligner=`, `t_aligner=`: the mesh aligners of
parallel/sharded.py, whose device is their first coordinate's); each
batch is copied to the aligners' device once and
each engine's result dict comes back with one grouped copy
(models/single.py fetch) on the writer thread.  The filter is the same
per-read host logic over the small candidate sets the device returns, with
the same insertion order (transcriptome hits, then genome hits).
"""
from __future__ import annotations

import os
import time
from collections import defaultdict

import numpy as np
import torch

from ..constants import DEFAULT_CONF_DIFF
from ..index.hash_index import GenomeIndex
from ..io.readers import open_paired_read_supplier, open_read_supplier
from ..io.reads import clip_read, count_ns, make_batch
from ..io.sam import NOT_FOUND, passes_filter
from ..io.writers import make_output_and_builder
from ..models.paired import PairedAligner
from ..models.paired_pipeline import PairedPipelineOptions
from ..models.pipeline import PipelineOptions
from ..models.single import SingleAligner, fetch, index_state
from ..utils.async_stages import OrderedWorker, PrefetchIterator
from ..utils.stats import AlignerStats, WaitProfile, span
from .contamination import ContaminationFilter
from .filter import (MULTIPLE_HITS, SINGLE_HIT, Alignment, AlignmentFilter,
                     BatchCharacterizer)
from .gtf import GTFReader
from .splice import insert_splice_junctions


def _output_prefix(out_path: str) -> str:
    base = os.path.basename(out_path)
    stem = base.rsplit(".", 1)[0] if "." in base else base
    return os.path.join(os.path.dirname(out_path) or ".", stem)


def _index(where) -> GenomeIndex:
    """An index, or the directory it loads from."""
    return where if isinstance(where, GenomeIndex) else \
        GenomeIndex.load(where)


class _RnaBase:
    def __init__(self, genome_dir, transcriptome_dir, annotation: str,
                 contamination_dir: str | None = None):
        # genome_dir / transcriptome_dir: a directory or a GenomeIndex
        self.genome_index = _index(genome_dir)
        self.transcriptome_index = _index(transcriptome_dir)
        self.gtf = GTFReader.load(annotation)
        self.contamination_index = (GenomeIndex.load(contamination_dir)
                                    if contamination_dir else None)
        self.c_filter = None
        self.wait = WaitProfile()

    def _make_splice_rewriter(self, tlocation: int):
        """Bind the transcript + transcript-space pos for the SAM writer."""
        tname, toff = self.transcriptome_index.genome.piece_at(tlocation)
        transcript = self.gtf.get_transcript(tname)
        tpos = toff + 1

        def rewrite(tokens):
            return insert_splice_junctions(transcript, tpos, tokens)
        return rewrite

    def _finish_run(self, prefix: str):
        self.gtf.analyze_read_intervals(prefix)
        self.gtf.write_read_counts(prefix)
        if self.c_filter is not None:
            self.c_filter.write(prefix)

    def _coord_map(self):
        """Lazy transcriptome->genome coordinate tensors (rna/t2g.py):
        built once per run, turns per-hit exon walks into array gathers."""
        m = getattr(self, "_t2g", None)
        if m is None:
            from .t2g import TranscriptomeCoordMap
            m = TranscriptomeCoordMap(self.gtf,
                                      self.transcriptome_index.genome)
            self._t2g = m
        return m

    def _fetch(self, *outs):
        """Device result dicts -> numpy, timed as the wait on the device."""
        with span("pipeline.device"):
            res = [fetch(o) for o in outs]
        return res


class RnaSingleEndPipeline(_RnaBase):
    def __init__(self, genome_dir, transcriptome_dir, annotation,
                 options: PipelineOptions | None = None,
                 contamination_dir: str | None = None,
                 conf_diff: int = DEFAULT_CONF_DIFF, device="cuda",
                 g_aligner=None, t_aligner=None, **aligner_overrides):
        super().__init__(genome_dir, transcriptome_dir, annotation,
                         contamination_dir)
        self.opt = options or PipelineOptions()
        self.conf_diff = conf_diff
        # injected aligners let the same pipeline run on a device mesh
        # (parallel/sharded.py's aligners share align_batch_device's
        # contract)
        self.g_aligner = g_aligner or SingleAligner(
            self.genome_index, device=device, **aligner_overrides)
        self.t_aligner = t_aligner or SingleAligner(
            self.transcriptome_index, device=device, **aligner_overrides)
        self.c_aligner = (SingleAligner(self.contamination_index,
                                        device=device)
                          if self.contamination_index else None)
        if self.c_aligner:
            self.c_filter = ContaminationFilter(self.contamination_index.genome)
        self.stats = AlignerStats()

    def run(self, fastq_path: str, out_path: str,
            command_line: str = "snap-rna"):
        opt, stats = self.opt, self.stats
        maxk = self.g_aligner.cfg.max_k
        genome = self.genome_index.genome
        tcodes = self.transcriptome_index.genome.codes
        dev = self.g_aligner.device
        prefix = _output_prefix(out_path)
        out, builder = make_output_and_builder(
            out_path, genome, sorted_output=opt.sorted_output,
            use_m=opt.use_m, read_group=opt.read_group,
            command_line=command_line,
            mark_duplicates="d" not in opt.suppress,
            build_index="i" not in opt.suppress, device=dev)
        try:
            buckets = defaultdict(list)
            t0 = time.time()

            writer = OrderedWorker(depth=4)

            def flush_bucket(L):
                reads = buckets.pop(L, [])
                if not reads:
                    return
                batch = make_batch(reads, L, opt.batch_size)
                # dispatch both aligners before materializing either result
                codes_d = torch.from_numpy(batch.codes).to(dev)
                quals_d = torch.from_numpy(batch.quals).to(dev)
                g_dev = self.g_aligner.align_batch_device(codes_d, quals_d)
                t_dev = self.t_aligner.align_batch_device(codes_d, quals_d)
                writer.submit(drain, reads, batch, g_dev, t_dev)

            def drain(reads, batch, g_dev, t_dev):
                g_res, t_res = self._fetch(g_dev, t_dev)
                c_res = None
                nb = len(reads)
                # batch-convert both hit streams up front (rna/t2g.py) —
                # see the paired drain for the semantics notes.  The
                # engines' loc is int32 in both packages (-1 = none).
                cmap = self._coord_map()
                rl = np.array([r.data_length for r in reads], np.int64)
                tloc = t_res["loc"][:nb].astype(np.int64)
                tconv = cmap.convert(tloc, rl)
                tscore = t_res["score"][:nb]
                tok = tconv["valid"] & (tscore >= 0) & (tscore <= maxk)
                poffs = np.asarray(genome.piece_offsets)
                gloc = g_res["loc"][:nb].astype(np.int64)
                gscore = g_res["score"][:nb]
                gok = (gloc >= 0) & (gloc < genome.num_bases) & \
                    (gscore >= 0) & (gscore <= maxk)
                gpidx = np.searchsorted(poffs, np.where(gok, gloc, 0),
                                        side="right") - 1
                gpos = gloc - poffs[gpidx] + 1
                for i, r in enumerate(reads):
                    filt = AlignmentFilter(
                        genome, self.transcriptome_index.genome, self.gtf,
                        0, 0, self.conf_diff, maxk,
                        self.genome_index.seed_len,
                        read_lens=(r.data_length, 0), read_ids=(r.rid, b""))
                    if tok[i]:
                        t = cmap.pieces[tconv["piece_no"][i]]
                        filt.add_prepared(Alignment(
                            location=int(tloc[i]),
                            direction=int(t_res["direction"][i]),
                            score=int(tscore[i]), mapq=int(t_res["mapq"][i]),
                            rname=cmap.chr_names[tconv["chr_no"][i]],
                            pos=int(tconv["pos"][i]),
                            pos_end=int(tconv["pos_end"][i]),
                            pos_original=int(tconv["pos_original"][i]),
                            transcript_id=t.transcript_id, gene_id=t.gene_id,
                            is_transcriptome=True), 0)
                    if gok[i]:
                        pos = int(gpos[i])
                        filt.add_prepared(Alignment(
                            location=int(gloc[i]),
                            direction=int(g_res["direction"][i]),
                            score=int(gscore[i]), mapq=int(g_res["mapq"][i]),
                            rname=genome.piece_names[gpidx[i]], pos=pos,
                            pos_end=pos + r.data_length - 1,
                            pos_original=pos, transcript_id="", gene_id="",
                            is_transcriptome=False), 0)
                    res = filt.filter_single()
                    if res.status == NOT_FOUND and self.c_aligner is not None:
                        if c_res is None:
                            c_res = self.c_aligner.align_batch(batch.codes,
                                                               batch.quals)
                        if int(c_res["result"][i]) != NOT_FOUND:
                            self.c_filter.add_alignment(int(c_res["loc"][i]))
                    splice = tsrc = None
                    if res.status != NOT_FOUND and res.is_transcriptome:
                        splice = self._make_splice_rewriter(res.tlocation)
                        tsrc = (tcodes, res.tlocation)
                    if passes_filter(res.status, opt.pass_filter):
                        builder.add(r, res.status,
                                    res.location if res.status != NOT_FOUND else -1,
                                    res.direction, res.mapq,
                                    splice_rewriter=splice, tsource=tsrc,
                                    score=res.score)
                    if res.status == SINGLE_HIT:
                        stats.single_hits += 1
                    elif res.status == MULTIPLE_HITS:
                        stats.multi_hits += 1
                    else:
                        stats.not_found += 1
                    if res.status != NOT_FOUND:
                        stats.record_mapq(res.mapq, False)
                with span("pipeline.write"):
                    builder.flush(out)

            def emit_filtered(read):
                stats.not_found += 1
                if passes_filter(NOT_FOUND, opt.pass_filter):
                    builder.add(read, NOT_FOUND, -1, 0, 0)

            def read_stage():
                for read in open_read_supplier(fastq_path):
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
                buckets[read.data_length].append(read)
                if len(buckets[read.data_length]) >= opt.batch_size:
                    flush_bucket(read.data_length)
            for L in list(buckets):
                flush_bucket(L)
            writer.close()
            stats.total_reads += n_total
            stats.useful_reads += n_useful
            builder.flush(out)
            stats.align_time = time.time() - t0
        finally:
            out.close()
        self._finish_run(prefix)
        return stats


class RnaPairedEndPipeline(_RnaBase):
    def __init__(self, genome_dir, transcriptome_dir, annotation,
                 options: PairedPipelineOptions | None = None,
                 contamination_dir: str | None = None,
                 conf_diff: int = DEFAULT_CONF_DIFF,
                 transcriptome_multi_hits: int = 1000,
                 force_spacing: bool = False, device="cuda",
                 g_aligner=None, t_aligner=None, **aligner_overrides):
        super().__init__(genome_dir, transcriptome_dir, annotation,
                         contamination_dir)
        self.opt = options or PairedPipelineOptions()
        self.conf_diff = conf_diff
        self.force_spacing = force_spacing
        self.g_aligner = g_aligner or PairedAligner(
            self.genome_index, device=device,
            min_spacing=self.opt.min_spacing,
            max_spacing=self.opt.max_spacing, **aligner_overrides)
        # transcriptome per-end aligner with multi-hit output at the
        # reference's depth: maxHitsToGet=1000 (PairedAligner.cpp:584-614).
        # The candidate budget scales with the requested depth, so paralog
        # families with hundreds of near-identical transcripts keep every
        # hit.  compact_per_read is set as the JAX package sets it; only
        # the flat back half (models/single.py compact_phase) reads it.
        t_over = dict(aligner_overrides)
        t_over.pop("max_hits_to_get", None)
        mh = transcriptome_multi_hits
        t_over.setdefault("cand_per_read", max(128, 2 * mh))
        t_over.setdefault("compact_per_read", max(32, mh))
        self.t_aligner = t_aligner or SingleAligner(
            self.transcriptome_index, device=device,
            max_hits_to_get=mh, **t_over)
        self.c_aligner = (PairedAligner(self.contamination_index,
                                        device=device)
                          if self.contamination_index else None)
        if self.c_aligner:
            self.c_filter = ContaminationFilter(self.contamination_index.genome)
        # device-side CharacterizeSeeds over the genome aligner's own index
        # tensors (rna/filter.py BatchCharacterizer); a mesh aligner holds
        # only index slices, so the characterizer gets the whole index on
        # the aligner's device
        state = getattr(self.g_aligner, "state", None)
        if state is None:
            state = index_state(self.genome_index, self.g_aligner.device)
        self._bchar = BatchCharacterizer(self.genome_index, state)
        self.stats = AlignerStats()

    def run(self, fq0: str, fq1: str, out_path: str,
            command_line: str = "snap-rna"):
        opt, stats = self.opt, self.stats
        maxk = self.g_aligner.cfg.max_k
        genome = self.genome_index.genome
        tcodes = self.transcriptome_index.genome.codes
        dev = self.g_aligner.device
        prefix = _output_prefix(out_path)
        out, builder = make_output_and_builder(
            out_path, genome, sorted_output=opt.sorted_output,
            use_m=opt.use_m, read_group=opt.read_group,
            command_line=command_line,
            mark_duplicates="d" not in opt.suppress,
            build_index="i" not in opt.suppress, device=dev)
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
                c0, q0, c1, q1 = (torch.from_numpy(a).to(dev) for a in (
                    b0.codes, b0.quals, b1.codes, b1.quals))
                g_dev = self.g_aligner.align_batch_device(c0, q0, c1, q1)
                t_dev0 = self.t_aligner.align_batch_device(c0, q0)
                t_dev1 = self.t_aligner.align_batch_device(c1, q1)
                char_rows = (self._bchar.characterize(b0.codes),
                             self._bchar.characterize(b1.codes))
                writer.submit(drain, pairs, b0, b1, g_dev, t_dev0, t_dev1,
                              char_rows)

            def drain(pairs, b0, b1, g_dev, t_dev0, t_dev1, char_rows):
                g_res, t_res0, t_res1 = self._fetch(g_dev, t_dev0, t_dev1)
                c_res = None
                nb = len(pairs)
                # ---- batch-convert ALL hits up front (rna/t2g.py): the
                # per-hit exon walks / piece bisects become array gathers;
                # the per-pair loop below only folds prepared Alignments
                # into the dedup maps (same insertion order: t-hits then
                # genome, so tie semantics are unchanged) ----
                cmap = self._coord_map()
                prep = []
                for e, tr in ((0, t_res0), (1, t_res1)):
                    rl = np.array([p[e].data_length for p in pairs],
                                  np.int64)
                    # mh_loc is uint32 in the JAX package (padded with
                    # INVALID_GENOME_LOCATION) and its int32 carrier here
                    mh_loc = tr["mh_loc"][:nb].view(np.uint32).astype(
                        np.int64)
                    K = mh_loc.shape[1]
                    conv = cmap.convert(mh_loc, rl[:, None])
                    score = tr["mh_score"][:nb]
                    ok = (conv["valid"]
                          & (np.arange(K)[None, :] < tr["mh_n"][:nb, None])
                          & (score >= 0) & (score <= maxk))
                    prep.append((conv, ok, score, tr["mh_dir"][:nb], mh_loc))
                # genome paired results: piece bisect for the whole batch
                g_prep = []
                poffs = np.asarray(genome.piece_offsets)
                for e in (0, 1):
                    loc = g_res[f"loc{e}"][:nb].astype(np.int64)
                    score = g_res[f"score{e}"][:nb]
                    okg = (loc >= 0) & (loc < genome.num_bases) & \
                        (score >= 0) & (score <= maxk)
                    pidx = np.searchsorted(poffs, np.where(okg, loc, 0),
                                           side="right") - 1
                    gpos = loc - poffs[pidx] + 1
                    g_prep.append((okg, pidx, gpos, loc, score))
                pieces = cmap.pieces
                chr_names = cmap.chr_names
                gpiece_names = genome.piece_names
                for i, (r0, r1) in enumerate(pairs):
                    filt = AlignmentFilter(
                        genome, self.transcriptome_index.genome, self.gtf,
                        opt.min_spacing, opt.max_spacing, self.conf_diff,
                        maxk, self.genome_index.seed_len,
                        read_lens=(r0.data_length, r1.data_length),
                        read_ids=(r0.rid, r1.rid),
                        characterizer=(
                            lambda e, _i=i: char_rows[e](_i)))
                    # transcriptome multi-hits per end (mapq 0, like the
                    # reference's multi-hit AddAlignment calls)
                    for e in (0, 1):
                        conv, okm, score, mdir, mh_loc = prep[e]
                        for j in np.nonzero(okm[i])[0]:
                            t = pieces[conv["piece_no"][i, j]]
                            filt.add_prepared(Alignment(
                                location=int(mh_loc[i, j]),
                                direction=int(mdir[i, j]),
                                score=int(score[i, j]), mapq=0,
                                rname=chr_names[conv["chr_no"][i, j]],
                                pos=int(conv["pos"][i, j]),
                                pos_end=int(conv["pos_end"][i, j]),
                                pos_original=int(conv["pos_original"][i, j]),
                                transcript_id=t.transcript_id,
                                gene_id=t.gene_id,
                                is_transcriptome=True), e)
                    # genome paired results
                    for e in (0, 1):
                        okg, pidx, gpos, loc, score = g_prep[e]
                        if not okg[i]:
                            continue
                        pos = int(gpos[i])
                        filt.add_prepared(Alignment(
                            location=int(loc[i]),
                            direction=int(g_res[f"dir{e}"][i]),
                            score=int(score[i]),
                            mapq=int(g_res[f"mapq{e}"][i]),
                            rname=gpiece_names[pidx[i]], pos=pos,
                            pos_end=pos + (r0, r1)[e].data_length - 1,
                            pos_original=pos, transcript_id="", gene_id="",
                            is_transcriptome=False), e)
                    pres = filt.filter_paired()
                    e0, e1 = pres.ends

                    if e0.status == NOT_FOUND and e1.status == NOT_FOUND \
                            and self.c_aligner is not None:
                        if c_res is None:
                            c_res = self.c_aligner.align_batch(
                                b0.codes, b0.quals, b1.codes, b1.quals)
                        if int(c_res["result0"][i]) != NOT_FOUND and \
                                int(c_res["result1"][i]) != NOT_FOUND:
                            self.c_filter.add_alignment(int(c_res["loc0"][i]))
                            self.c_filter.add_alignment(int(c_res["loc1"][i]))

                    if self.force_spacing and \
                            (e0.status == SINGLE_HIT) != (e1.status == SINGLE_HIT):
                        e0.status = e1.status = NOT_FOUND

                    # the reference's MAPQ "cheese" (PairedAligner.cpp:653-663)
                    if e0.score + e1.score >= 5:
                        if e0.mapq < 50:
                            e0.mapq //= 2
                        if e1.mapq < 50:
                            e1.mapq //= 2

                    emit = passes_filter(e0.status, opt.pass_filter) or \
                        passes_filter(e1.status, opt.pass_filter)
                    for r, e, m, first in ((r0, e0, e1, True),
                                           (r1, e1, e0, False)):
                        splice = tsrc = None
                        if e.status != NOT_FOUND and e.is_transcriptome:
                            splice = self._make_splice_rewriter(e.tlocation)
                            tsrc = (tcodes, e.tlocation)
                        if emit:
                            builder.add(
                                r, e.status,
                                e.location if e.status != NOT_FOUND else -1,
                                e.direction, e.mapq,
                                mate=dict(result=m.status,
                                          location=m.location if m.status != NOT_FOUND else -1,
                                          direction=m.direction,
                                          read=r1 if first else r0,
                                          first=first),
                                splice_rewriter=splice, tsource=tsrc,
                                score=e.score)
                        if e.status == SINGLE_HIT:
                            stats.single_hits += 1
                        elif e.status == MULTIPLE_HITS:
                            stats.multi_hits += 1
                        else:
                            stats.not_found += 1
                        if e.status != NOT_FOUND:
                            stats.record_mapq(e.mapq, False)
                    if pres.aligned_as_pair:
                        stats.aligned_as_pairs += 2
                with span("pipeline.write"):
                    builder.flush(out)

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
                for r0, r1 in open_paired_read_supplier(
                        fq0, fq1,
                        check_ids=not getattr(opt, 'ignore_mismatched_ids',
                                              False)):
                    clip_read(r0, opt.clipping)
                    clip_read(r1, opt.clipping)
                    bad = any(r.data_length < opt.min_read_length
                              or count_ns(r) > maxk or not opt.quality_ok(r)
                              for r in (r0, r1))
                    yield bad, r0, r1

            n_total = 0
            for bad, r0, r1 in PrefetchIterator(read_stage()):
                n_total += 2
                if bad:
                    writer.submit(emit_filtered, r0, r1)
                    continue
                stats.useful_reads += 2
                L = max(r0.data_length, r1.data_length)
                buckets[L].append((r0, r1))
                if len(buckets[L]) >= opt.batch_size:
                    flush_bucket(L)
            for L in list(buckets):
                flush_bucket(L)
            writer.close()
            stats.total_reads += n_total
            builder.flush(out)
            stats.align_time = time.time() - t0
        finally:
            out.close()
        self._finish_run(prefix)
        return stats
