"""Bulk (vectorized) FASTQ ingest and SAM emission for the paired e2e path.

Port of snap_rnaseq_tpu/io/bulk.py.  The reference reaches its reads/s
with C++ record scanning and per-thread SAM serialization (SNAPLib/FASTQ.cpp
record parser, SAM.cpp:820-975 getSAMData + ReadWriter buffers); the
per-Read-object Python path (io/fastq.py + io/sam.py) is correct but slow,
so the paired pipeline works on whole BATCHES as numpy matrices:

* ingest: the native record scanner (native/io_native.cpp fastq_scan)
  finds record offsets in big file chunks; sequences/qualities are
  gathered into (B, L) uint8 matrices with one fancy-index; clipping
  (Read.h clip()), N counting, the quality filter
  (SingleAligner.cpp:246-257) and the mate-ID check
  (PairedAligner.cpp:445) are vector ops over those matrices.
* emission: SAM fields (getSAMData analog) are computed as vectors, the
  dominant substitution-only CIGARs come from one batched genome-window
  compare (the closed form SamRecordBuilder.add documents), and only
  genuine indel rows go to the batched LV CIGAR path (ops/cigar.py: K3 on
  a card).  Line assembly is bytes %-formatting per record.

Byte-for-byte output parity with the SamRecordBuilder path is pinned by
tests/test_torch_paired.py (the same corpus through both paths).
"""
from __future__ import annotations

import numpy as np

from ..constants import INVALID_GENOME_LOCATION, MAX_K
from ..utils.tables import BASE_VALUE, COMPLEMENT
from .reads import Read
from .sam import (FLAG_ALL_ALIGNED, FLAG_FIRST_SEGMENT, FLAG_LAST_SEGMENT,
                  FLAG_NEXT_REVERSED, FLAG_NEXT_UNMAPPED, FLAG_PAIRED,
                  FLAG_REVERSE, FLAG_UNMAPPED, NOT_FOUND)

_HASH = ord("#")
_RC_CODE = np.array([3, 2, 1, 0, 4, 5] + [4] * 250, np.uint8)


# ---------------------------------------------------------------------------
# chunked FASTQ scanning
# ---------------------------------------------------------------------------

def scan_fastq_stream(path, chunk_bytes: int = 8 << 20):
    """Yield (buf: bytes, recs: int64[N,5]) chunks of complete records.

    recs columns: id_off, id_len, seq_off, seq_len, qual_off (native
    fastq_scan contract).  Handles .gz via streaming decompression.
    """
    from .. import native
    if str(path).endswith(".gz"):
        import zlib
        d = zlib.decompressobj(16 + zlib.MAX_WBITS)

        def chunks(f):
            while True:
                raw = f.read(chunk_bytes)
                if not raw:
                    tail = d.flush()
                    if tail:
                        yield tail
                    return
                out = d.decompress(raw)
                if out:
                    yield out
    else:
        def chunks(f):
            while True:
                raw = f.read(chunk_bytes)
                if not raw:
                    return
                yield raw
    with open(path, "rb") as f:
        carry = b""
        for chunk in chunks(f):
            buf = carry + chunk if carry else chunk
            recs, trailing = native.fastq_scan(buf)
            if len(recs):
                yield buf, recs
            carry = buf[trailing:]
        if carry.strip():
            raise ValueError(f"truncated FASTQ record at end of {path}")


class _RecordCursor:
    """Buffers scanned chunks so callers can take aligned record runs."""

    def __init__(self, path, chunk_bytes=8 << 20):
        self._it = scan_fastq_stream(path, chunk_bytes)
        self._buf = None
        self._recs = None
        self._pos = 0

    def available(self) -> int:
        if self._buf is None or self._pos >= len(self._recs):
            nxt = next(self._it, None)
            if nxt is None:
                return 0
            self._buf, self._recs = nxt
            self._pos = 0
        return len(self._recs) - self._pos

    def take(self, n: int):
        """(buf, recs[n0,5]) with n0 = min(n, contiguous available)."""
        avail = self.available()
        n0 = min(n, avail)
        recs = self._recs[self._pos:self._pos + n0]
        buf = self._buf
        self._pos += n0
        return buf, recs


def paired_record_blocks(path0, path1, block_pairs: int = 1024,
                         chunk_bytes: int = 8 << 20):
    """Yield ((buf0, recs0), (buf1, recs1)) with equal record counts.

    The lockstep walk is the PairedFASTQReader analog (FASTQ.h:97-134);
    unequal totals raise like read_paired_fastq does.
    """
    c0 = _RecordCursor(path0, chunk_bytes)
    c1 = _RecordCursor(path1, chunk_bytes)
    while True:
        a0, a1 = c0.available(), c1.available()
        if a0 == 0 or a1 == 0:
            if a0 != a1:
                raise ValueError(
                    "paired FASTQ files have different read counts")
            return
        n = min(block_pairs, a0, a1)
        yield c0.take(n), c1.take(n)


# ---------------------------------------------------------------------------
# block -> matrices
# ---------------------------------------------------------------------------

class EndBlock:
    """One end of a block of pairs as matrices (plus lazy Read objects)."""

    __slots__ = ("buf", "recs", "n", "seq", "qual", "seq_len", "clip_front",
                 "clip_back", "data_len", "n_count", "useful", "codes",
                 "equals", "overflow", "quality_ok")

    def read_at(self, i: int) -> Read:
        """Materialize one Read (slow/overflow path, rare)."""
        io_, il, so, sl, qo = (int(x) for x in self.recs[i])
        seq = bytes(self.seq[i, :sl])        # already uppercased
        r = Read(rid=self.buf[io_:io_ + il], seq=seq,
                 qual=self.buf[qo:qo + sl])
        r.clip_front = int(self.clip_front[i])
        r.clip_back = int(self.clip_back[i])
        return r

    def ids(self):
        buf = self.buf
        return [buf[int(o):int(o) + int(l)]
                for o, l in zip(self.recs[:, 0], self.recs[:, 1])]


def build_end_block(buf: bytes, recs: np.ndarray, L_eng: int,
                    min_read_length: int, max_k: int,
                    clipping: int = 3, min_phred: int = 20,
                    min_percent: float = 90.0,
                    phred_offset: int = 33) -> EndBlock:
    """Vectorized parse+clip+filter of one end (Read.h clip() semantics)."""
    from .reads import CLIP_BACK, CLIP_FRONT
    b = EndBlock()
    b.buf, b.recs = buf, recs
    n = b.n = len(recs)
    arr = np.frombuffer(buf, np.uint8)
    seq_off = recs[:, 2]
    seq_len = b.seq_len = recs[:, 3].astype(np.int32)
    qual_off = recs[:, 4]
    Lmax = int(seq_len.max()) if n else 0
    col = np.arange(Lmax, dtype=np.int64)
    lim = arr.shape[0] - 1
    seq = arr[np.minimum(seq_off[:, None] + col, lim)]
    if (seq >= 97).any():
        lower = (seq >= 97) & (seq <= 122)
        seq = np.where(lower, seq - 32, seq)      # read_fastq's .upper()
    b.seq = seq
    qual = arr[np.minimum(qual_off[:, None] + col, lim)]
    b.qual = qual
    uniform = bool((seq_len == Lmax).all())
    valid = None if uniform else col[None, :] < seq_len[:, None]

    # clipping (reads.clip_read): trailing then leading '#' quality runs,
    # reverted when fewer than 50 bases remain.  The '#'-free common case
    # skips the vector machinery entirely.
    ishash = qual == _HASH
    if clipping and ishash.any():
        nonhash = ~ishash if valid is None else ~ishash & valid
        last_nonhash = np.where(nonhash, col[None, :], -1).max(
            axis=1, initial=-1)
        first_nonhash = np.where(nonhash, col[None, :], Lmax).min(
            axis=1, initial=Lmax)
        back = (seq_len - 1 - last_nonhash).astype(np.int32) \
            if clipping & CLIP_BACK else np.zeros(n, np.int32)
        if clipping & CLIP_FRONT:
            front = np.minimum(first_nonhash,
                               seq_len - back).astype(np.int32)
        else:
            front = np.zeros(n, np.int32)
        revert = seq_len - front - back < 50
        front = np.where(revert, 0, front)
        back = np.where(revert, 0, back)
        no_clip = not (front.any() or back.any())
    else:
        front = back = np.zeros(n, np.int32)
        no_clip = True
    b.clip_front, b.clip_back = front, back
    dl = b.data_len = (seq_len - front - back).astype(np.int32)

    codes_full = np.minimum(BASE_VALUE[seq], 4)
    isn = codes_full >= 4
    if no_clip:
        b.n_count = (isn if valid is None else isn & valid).sum(
            axis=1).astype(np.int32)
    else:
        clipped = (col[None, :] >= front[:, None]) & \
            (col[None, :] < (seq_len - back)[:, None])
        b.n_count = (isn & clipped).sum(axis=1).astype(np.int32)
    b.useful = (dl >= min_read_length) & (b.n_count <= max_k)
    # reads.quality_filter over the FULL quality string
    qhi_m = qual >= phred_offset + min_phred
    qhi = (qhi_m if valid is None else qhi_m & valid).sum(axis=1)
    b.quality_ok = (qhi * 100.0 >= min_percent * seq_len) & (seq_len > 0)

    # engine matrices: clipped codes shifted to column 0, N/'!'-padded
    if no_clip and uniform and Lmax == L_eng:
        b.codes = codes_full
        b.equals = qual
    elif Lmax:
        ecol = np.arange(L_eng, dtype=np.int64)
        src = np.minimum(front[:, None] + ecol, max(Lmax - 1, 0))
        within = ecol[None, :] < np.minimum(dl, L_eng)[:, None]
        b.codes = np.where(within, np.take_along_axis(codes_full, src, 1),
                           np.uint8(4))
        b.equals = np.where(within, np.take_along_axis(qual, src, 1),
                            np.uint8(ord("!")))
    else:
        b.codes = np.full((n, L_eng), 4, np.uint8)
        b.equals = np.full((n, L_eng), ord("!"), np.uint8)
    b.overflow = np.flatnonzero(dl > L_eng)
    return b


def ids_match_vec(b0: EndBlock, b1: EndBlock) -> np.ndarray:
    """Vectorized readIdsMatch (readers.py:199): equal up to the first
    NUL/space/'/' of id0."""
    n = b0.n
    l0 = b0.recs[:, 1]
    l1 = b1.recs[:, 1]
    Imax = int(max(l0.max(initial=0), l1.max(initial=0))) + 1
    col = np.arange(Imax, dtype=np.int64)
    a0 = np.frombuffer(b0.buf, np.uint8)
    a1 = np.frombuffer(b1.buf, np.uint8)
    m0 = np.where(col[None, :] < l0[:, None],
                  a0[np.minimum(b0.recs[:, 0][:, None] + col,
                                a0.shape[0] - 1)], 0)
    m1 = np.where(col[None, :] < l1[:, None],
                  a1[np.minimum(b1.recs[:, 0][:, None] + col,
                                a1.shape[0] - 1)], 0)
    neq = m0 != m1
    stop = (m0 == 0) | (m0 == 0x20) | (m0 == 0x2F)
    d = np.where(neq.any(axis=1), neq.argmax(axis=1), Imax + 1)
    s = stop.argmax(axis=1)          # a 0 column always exists
    return d > s


# ---------------------------------------------------------------------------
# bulk SAM emission
# ---------------------------------------------------------------------------

def _pair_qnames(ids0: list, ids1: list) -> list:
    """QNAME per pair, replicating ReadWriter.cpp:154-162 truncation
    (including its lastChar0 typo — see SamRecordBuilder._fields)."""
    out = []
    for id0, id1 in zip(ids0, ids1):
        if (len(id0) == len(id1) and len(id0) > 2
                and id0[-2] == 0x2F and id1[-2] == 0x2F):
            c0, c1 = id0[-1], id1[-1]
            if c0 in (0x31, 0x32) and (c0 == 0x31 or c1 == 0x32) \
                    and c0 != c1:
                id0 = id0[:-2]
        i = id0.find(b" ")
        if i >= 0:
            id0 = id0[:i]
        i = id0.find(b"\t")
        if i >= 0:
            id0 = id0[:i]
        out.append(id0)
    return out


def _sub_cigar_bytes(dl: int, mism_pos: np.ndarray, use_m: bool,
                     pre: int, post: int) -> bytes:
    """Closed-form substitution-only CIGAR (emit_tokens straight==e branch)
    with soft clips."""
    parts = []
    if pre:
        parts.append(b"%dS" % pre)
    if use_m or mism_pos.size == 0:
        if dl:
            parts.append(b"%d%c" % (dl, ord("M") if use_m else ord("=")))
    else:
        prev = 0
        i = 0
        np_ = mism_pos.shape[0]
        while i < np_:
            p = int(mism_pos[i])
            if p > prev:
                parts.append(b"%d=" % (p - prev))
            run = 1
            while i + run < np_ and int(mism_pos[i + run]) == p + run:
                run += 1
            parts.append(b"%dX" % run)
            prev = p + run
            i += run
        if dl > prev:
            parts.append(b"%d=" % (dl - prev))
    if post:
        parts.append(b"%dS" % post)
    return b"".join(parts)


class BulkSamEmitter:
    """Vectorized paired SAM record emission (SAM.cpp:820-975 analog)."""

    def __init__(self, genome, use_m: bool = False,
                 read_group: str | None = "FASTQ", device="cuda"):
        self.genome = genome
        self.use_m = use_m
        self.device = device      # where the CIGAR kernel runs
        self.piece_names_b = [n.encode() for n in genome.piece_names]
        self.piece_offsets = genome.piece_offsets
        rg = (b"\tRG:Z:" + read_group.encode()) if read_group else b""
        self.tail_prefix = rg + b"\tPG:Z:SNAP\tNM:i:"
        self.gcodes = genome.codes

    # -- vector field computation ------------------------------------------

    def _cigars(self, blk: EndBlock, mapped, loc, direction, score):
        """CIGAR bytes + NM per mapped row: closed-form batch for
        substitution-only rows, LV kernel for the rest."""
        n = blk.n
        cig = [None] * n
        nm = np.full(n, -1, np.int64)
        rows = np.flatnonzero(mapped)
        if rows.size == 0:
            return cig, nm
        dl = blk.data_len[rows]
        L = int(dl.max())
        col = np.arange(L, dtype=np.int64)
        # pattern in alignment orientation: forward rows use the engine
        # codes; RC rows reverse-complement within data_len
        pat = blk.codes[rows][:, :L]
        isrc = direction[rows].astype(bool)
        if isrc.any():
            r = np.flatnonzero(isrc)
            dlr = dl[r]
            ridx = np.maximum(dlr[:, None] - 1 - col[None, :], 0)
            pat[r] = _RC_CODE[np.take_along_axis(pat[r], ridx, 1)]
        txt = self.gcodes[np.minimum(loc[rows][:, None] + col[None, :],
                                     self.gcodes.shape[0] - 1)]
        within = col[None, :] < dl[:, None]
        mism = (pat != txt) & within
        straight = mism.sum(axis=1)
        fast = straight == score[rows]
        # clip orientation (direction flips which clip leads)
        pre = np.where(isrc, blk.clip_back[rows], blk.clip_front[rows])
        post = np.where(isrc, blk.clip_front[rows], blk.clip_back[rows])

        fr = np.flatnonzero(fast)
        if fr.size:
            # mismatch positions, grouped by row; perfect rows share a
            # cached CIGAR per (data_len, clips) shape
            perfect = {}
            mr, mp = np.nonzero(mism[fr])
            bounds = np.searchsorted(mr, np.arange(fr.size + 1))
            rows_l = rows[fr].tolist()
            dl_l = dl[fr].tolist()
            pre_l = pre[fr].tolist()
            post_l = post[fr].tolist()
            st_l = straight[fr].tolist()
            for j in range(fr.size):
                i = rows_l[j]
                nm[i] = st_l[j]
                if st_l[j] == 0:
                    key = (dl_l[j], pre_l[j], post_l[j])
                    c = perfect.get(key)
                    if c is None:
                        c = perfect[key] = _sub_cigar_bytes(
                            dl_l[j], mp[:0], self.use_m,
                            pre_l[j], post_l[j])
                    cig[i] = c
                else:
                    cig[i] = _sub_cigar_bytes(
                        dl_l[j], mp[bounds[j]:bounds[j + 1]],
                        self.use_m, pre_l[j], post_l[j])
        sr = np.flatnonzero(~fast)
        if sr.size:
            from ..ops.cigar import compute_cigars, tokens_to_string
            # the rows as they are: pattern and text past each row's
            # data length never reach the DP or the emission
            pl = dl[sr].astype(np.int32)
            dist, toks = compute_cigars(pat[sr], pl, txt[sr], pl.copy(),
                                        use_m=self.use_m, k=MAX_K - 1,
                                        e_max=MAX_K, device=self.device)
            for j in range(sr.size):
                i_loc = sr[j]
                i = int(rows[i_loc])
                nm[i] = int(dist[j])
                if toks[j] is None:
                    continue
                full = []
                if pre[i_loc]:
                    full.append((int(pre[i_loc]), "S"))
                full += toks[j]
                if post[i_loc]:
                    full.append((int(post[i_loc]), "S"))
                cig[i] = tokens_to_string(full).encode()
        return cig, nm

    def _seq_qual_bytes(self, blk: EndBlock, direction):
        """Per-record SEQ/QUAL bytes; RC rows transformed in bulk."""
        n = blk.n
        Lmax = blk.seq.shape[1]
        seq = blk.seq
        qual = blk.qual
        rc = np.flatnonzero(direction)
        if rc.size:
            seq = seq.copy()
            qual = qual.copy()
            col = np.arange(Lmax, dtype=np.int64)
            sl = blk.seq_len[rc]
            ridx = np.maximum(sl[:, None] - 1 - col[None, :], 0)
            seq[rc] = COMPLEMENT[np.take_along_axis(blk.seq[rc], ridx, 1)]
            qual[rc] = np.take_along_axis(blk.qual[rc], ridx, 1)
        sb = seq.tobytes()
        qb = qual.tobytes()
        sl = blk.seq_len
        return ([sb[i * Lmax:i * Lmax + int(sl[i])] for i in range(n)],
                [qb[i * Lmax:i * Lmax + int(sl[i])] for i in range(n)])

    def emit_pairs(self, blk0: EndBlock, blk1: EndBlock, res: dict,
                   bad: np.ndarray, out, stats, pass_filter: str = "",
                   compute_error=None, exclude: np.ndarray = None) -> None:
        """Emit one block of pairs (record order: r0 then r1 per pair,
        input order) to `out` (RecordOutput or raw binary file).

        `exclude` rows are skipped entirely (no records, no stats) — the
        caller routes them through the per-read path instead."""
        n = blk0.n
        genome = self.genome
        r0 = np.asarray(res["result0"][:n]).astype(np.int64)
        r1 = np.asarray(res["result1"][:n]).astype(np.int64)
        # locations are uint32 bit patterns in int32 arrays (big-genome
        # mode past 2^31); the unmapped sentinel -1 maps to
        # INVALID_GENOME_LOCATION, which the mapped mask already rejects
        loc0 = np.asarray(res["loc0"][:n]).astype(
            np.int32).view(np.uint32).astype(np.int64)
        loc1 = np.asarray(res["loc1"][:n]).astype(
            np.int32).view(np.uint32).astype(np.int64)
        d0 = np.asarray(res["dir0"][:n]).astype(np.int64)
        d1 = np.asarray(res["dir1"][:n]).astype(np.int64)
        mq0 = np.asarray(res["mapq0"][:n]).astype(np.int64)
        mq1 = np.asarray(res["mapq1"][:n]).astype(np.int64)
        sc0 = np.asarray(res["score0"][:n]).astype(np.int64)
        sc1 = np.asarray(res["score1"][:n]).astype(np.int64)
        paired = np.asarray(res["pair_found"][:n]).astype(bool)
        pair_score = np.asarray(res["pair_score"][:n]).astype(np.int64)

        # reads the reference never aligns (both-useless / quality gate)
        # are forced unmapped (PairedAligner.cpp:555-575)
        if bad is not None and bad.any():
            r0 = np.where(bad, NOT_FOUND, r0)
            r1 = np.where(bad, NOT_FOUND, r1)
            paired = paired & ~bad
        keep = None if exclude is None or not exclude.any() else ~exclude
        if keep is not None:
            paired = paired & keep

        m0 = (r0 != NOT_FOUND) & (loc0 != -1) & \
            (loc0 != INVALID_GENOME_LOCATION)
        m1 = (r1 != NOT_FOUND) & (loc1 != -1) & \
            (loc1 != INVALID_GENOME_LOCATION)
        if keep is not None:
            m0 = m0 & keep
            m1 = m1 & keep
        d0 = np.where(m0, d0, 0)
        d1 = np.where(m1, d1, 0)
        mq0 = np.where(m0, np.clip(mq0, 0, 70), 0)
        mq1 = np.where(m1, np.clip(mq1, 0, 70), 0)

        pi0 = genome.piece_index_at(np.where(m0, loc0, 0))
        pi1 = genome.piece_index_at(np.where(m1, loc1, 0))
        pos0 = np.where(m0, loc0 - self.piece_offsets[pi0] + 1, 0)
        pos1 = np.where(m1, loc1 - self.piece_offsets[pi1] + 1, 0)

        # flags (getSAMData)
        f0 = np.full(n, FLAG_PAIRED | FLAG_FIRST_SEGMENT, np.int64)
        f1 = np.full(n, FLAG_PAIRED | FLAG_LAST_SEGMENT, np.int64)
        f0 += np.where(m0, np.where(d0 != 0, FLAG_REVERSE, 0), FLAG_UNMAPPED)
        f1 += np.where(m1, np.where(d1 != 0, FLAG_REVERSE, 0), FLAG_UNMAPPED)
        f0 += np.where(m1, np.where(d1 != 0, FLAG_NEXT_REVERSED, 0),
                       FLAG_NEXT_UNMAPPED)
        f1 += np.where(m0, np.where(d0 != 0, FLAG_NEXT_REVERSED, 0),
                       FLAG_NEXT_UNMAPPED)
        both = m0 & m1
        f0 += np.where(both, FLAG_ALL_ALIGNED, 0)
        f1 += np.where(both, FLAG_ALL_ALIGNED, 0)

        # TLEN for both-mapped same-piece pairs, from clip-adjusted spans
        cb0 = np.where(d0 != 0, blk0.clip_back, blk0.clip_front)
        ca0 = np.where(d0 != 0, blk0.clip_front, blk0.clip_back)
        cb1 = np.where(d1 != 0, blk1.clip_back, blk1.clip_front)
        ca1 = np.where(d1 != 0, blk1.clip_front, blk1.clip_back)
        start0 = loc0 - cb0
        end0 = loc0 + blk0.data_len + ca0
        start1 = loc1 - cb1
        end1 = loc1 + blk1.data_len + ca1
        same = both & (pi0 == pi1)
        tlen0 = np.where(same,
                         np.where(start0 < start1, end1 - start0,
                                  -(end0 - start1)), 0)
        tlen1 = np.where(same,
                         np.where(start1 < start0, end0 - start1,
                                  -(end1 - start0)), 0)

        cig0, nm0 = self._cigars(blk0, m0, loc0, d0, sc0)
        cig1, nm1 = self._cigars(blk1, m1, loc1, d1, sc1)
        seq0, qual0 = self._seq_qual_bytes(blk0, d0)
        seq1, qual1 = self._seq_qual_bytes(blk1, d1)
        qnames = _pair_qnames(blk0.ids(), blk1.ids())

        # stats (emit_pair parity)
        cnt = (lambda m: int(m.sum())) if keep is None else \
            (lambda m: int((m & keep).sum()))
        stats.single_hits += cnt(r0 == 1) + cnt(r1 == 1)
        stats.multi_hits += cnt(r0 == 2) + cnt(r1 == 2)
        stats.not_found += cnt(r0 == 0) + cnt(r1 == 0)
        hist = np.bincount(np.concatenate([mq0[m0], mq1[m1]]),
                           minlength=71)
        stats.mapq_histogram += hist[:71]
        stats.aligned_as_pairs += 2 * int(paired.sum())
        if paired.any():
            dist = np.abs(loc1[paired] - loc0[paired])
            # Histogram.add exponential bucket = bit_length (frexp exponent
            # is exact for ints < 2^53)
            bl = np.where(dist > 0,
                          np.frexp(dist.astype(np.float64))[1], 0)
            nb = stats.distance_histogram.n_buckets
            stats.distance_histogram.counts += np.bincount(
                np.clip(bl, 0, nb - 1), minlength=nb)[:nb]
            ns = stats.score_histogram.n_buckets
            stats.score_histogram.counts += np.bincount(
                np.clip(pair_score[paired], 0, ns - 1), minlength=ns)[:ns]
        if compute_error is not None:
            for i in np.flatnonzero(m0):
                if compute_error(blk0.read_at(i), int(loc0[i])):
                    stats.mapq_errors[mq0[i]] += 1
                    stats.errors += 1
            for i in np.flatnonzero(m1):
                if compute_error(blk1.read_at(i), int(loc1[i])):
                    stats.mapq_errors[mq1[i]] += 1
                    stats.errors += 1

        if pass_filter == "a":
            emit = (r0 != 0) | (r1 != 0)
        elif pass_filter == "s":
            emit = (r0 == 1) | (r1 == 1)
        elif pass_filter == "u":
            emit = (r0 == 0) | (r1 == 0)
        else:
            emit = np.ones(n, bool)
        if keep is not None:
            emit = emit & keep

        record_out = hasattr(out, "write_record")
        if record_out:
            # flat-location sort keys (_sort_key): own location, else
            # the mapped mate's, else unmapped-at-end
            from .writers import UNMAPPED_KEY
            key0 = np.where(m0, loc0, np.where(m1, loc1, UNMAPPED_KEY))
            key1 = np.where(m1, loc1, np.where(m0, loc0, UNMAPPED_KEY))
            key0l, key1l = key0.tolist(), key1.tolist()

        names = self.piece_names_b
        tailp = self.tail_prefix
        # python scalars once (numpy scalar indexing is the slow part)
        it = zip(qnames, emit.tolist(),
                 f0.tolist(), m0.tolist(), pi0.tolist(), pos0.tolist(),
                 mq0.tolist(), tlen0.tolist(), nm0.tolist(),
                 f1.tolist(), m1.tolist(), pi1.tolist(), pos1.tolist(),
                 mq1.tolist(), tlen1.tolist(), nm1.tolist())
        wr = out.write_record if record_out else None
        w = out.write
        for i, (qn, em, a_f, a_m, a_pi, a_pos, a_mq, a_tl, a_nm,
                b_f, b_m, b_pi, b_pos, b_mq, b_tl, b_nm) in enumerate(it):
            if not em:
                continue
            if a_m:
                rn0, p0 = names[a_pi], a_pos
            elif b_m:
                rn0, p0 = names[b_pi], b_pos
            else:
                rn0, p0 = b"*", 0
            if b_m:
                rn1, p1 = names[b_pi], b_pos
            elif a_m:
                rn1, p1 = names[a_pi], a_pos
            else:
                rn1, p1 = b"*", 0
            # RNEXT/PNEXT (getSAMData): mapped mate -> its piece/pos
            # ('=' when equal to RNAME); unmapped mate -> own RNAME/POS
            if b_m:
                rx0 = b"=" if names[b_pi] == rn0 else rn1
                px0 = p1
            else:
                rx0, px0 = (b"=" if rn0 != b"*" else b"*"), p0
            if a_m:
                rx1 = b"=" if names[a_pi] == rn1 else rn0
                px1 = p0
            else:
                rx1, px1 = (b"=" if rn1 != b"*" else b"*"), p1
            c0 = cig0[i] or b"*"
            c1 = cig1[i] or b"*"
            line0 = b"%b\t%d\t%b\t%d\t%d\t%b\t%b\t%d\t%d\t%b\t%b%b%d\n" % (
                qn, a_f, rn0, p0, a_mq, c0, rx0, px0, a_tl,
                seq0[i], qual0[i], tailp, a_nm)
            line1 = b"%b\t%d\t%b\t%d\t%d\t%b\t%b\t%d\t%d\t%b\t%b%b%d\n" % (
                qn, b_f, rn1, p1, b_mq, c1, rx1, px1, b_tl,
                seq1[i], qual1[i], tailp, b_nm)
            if record_out:
                wr(key0l[i], line0)
                wr(key1l[i], line1)
            else:
                w(line0)
                w(line1)
