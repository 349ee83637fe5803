"""Transcriptome genome construction from a GTF + genome.

Analog of reference GTFReader::BuildTranscriptome + GTFTranscript::WriteFASTA
(GTFReader.cpp:1840-1867, 1181-1210): one "chromosome" per transcript, its
sequence the concatenation of the transcript's exon substrings in genome
order (NO reverse-complementing for minus-strand transcripts — the reference
aligns both strands anyway).

Instead of writing transcriptome.fa and re-parsing it, we assemble the flat
code array directly (same layout as index/genome.py: [pad]{piece}[pad]...),
which feeds straight into build_index.  write_transcriptome_fasta() exists
for parity with the reference's on-disk artifact.
"""
from __future__ import annotations

import numpy as np

from ..constants import DEFAULT_CHROMOSOME_PADDING
from ..index.genome import Genome
from ..utils.tables import BASE_PAD
from .gtf import GTFReader


def build_transcriptome_genome(gtf: GTFReader, genome: Genome,
                               padding: int = DEFAULT_CHROMOSOME_PADDING) -> Genome:
    pad = np.full(padding, BASE_PAD, dtype=np.uint8)
    chunks: list[np.ndarray] = []
    names: list[str] = []
    offsets: list[int] = []
    total = 0
    for tid, t in gtf.transcripts.items():
        try:
            chr_off = genome.offset_of_piece(t.chr)
        except KeyError:
            # reference warns and skips transcripts on unknown chromosomes
            continue
        chunks.append(pad)
        total += padding
        names.append(tid)
        offsets.append(total)
        for start, length in zip(t.exon_starts, t.exon_lens):
            lo = chr_off + int(start) - 1
            seq = genome.codes[lo:lo + int(length)]
            chunks.append(np.asarray(seq, dtype=np.uint8))
            total += int(length)
    chunks.append(pad)
    if not names:
        raise ValueError("no transcripts found in annotation")
    return Genome(codes=np.concatenate(chunks), piece_names=names,
                  piece_offsets=np.asarray(offsets, dtype=np.int64),
                  padding=padding)


def write_transcriptome_fasta(gtf: GTFReader, genome: Genome, path: str):
    """Parity artifact: transcriptome.fa with one record per transcript."""
    from ..utils.tables import decode_bases
    with open(path, "wb") as f:
        for tid, t in gtf.transcripts.items():
            try:
                chr_off = genome.offset_of_piece(t.chr)
            except KeyError:
                continue
            parts = []
            for start, length in zip(t.exon_starts, t.exon_lens):
                lo = chr_off + int(start) - 1
                parts.append(decode_bases(genome.codes[lo:lo + int(length)]))
            f.write(b">" + tid.encode() + b"\n" + b"".join(parts) + b"\n")
