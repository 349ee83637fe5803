"""Splice-junction CIGAR rewriting: transcript space -> genome space.

Analog of LandauVishkinWithCigar::insertSpliceJunctions
(LandauVishkin.cpp:119-249): walk the transcript-space CIGAR tokens; ops that
consume transcript bases (M/=/X/D) are split at each intron crossed (via
GTFTranscript::Junctions) with an N op of the intron's length inserted; I and
S ops pass through; a junction exactly at the alignment start is skipped.
"""
from __future__ import annotations

from .gtf import GTFTranscript


def insert_splice_junctions(transcript: GTFTranscript, pos: int,
                            tokens: list[tuple[int, str]]) -> list[tuple[int, str]]:
    """tokens: [(count, op)] in transcript space; pos: 1-based transcript
    coordinate of the alignment start.  Returns genome-space tokens."""
    final: list[tuple[int, str]] = []
    prev = pos
    current = pos

    def push(count, op):
        if count > 0:
            final.append((int(count), op))

    for length, op in tokens:
        if op in ("I", "S"):
            push(length, op)
            continue
        current += length - 1
        junctions = transcript.junctions(prev, length)
        if junctions:
            remainder = length
            for jpos, intron in junctions:
                # read begins exactly on the junction: skip it
                if jpos == pos:
                    continue
                step = jpos - prev
                remainder -= step
                push(step, op)
                push(intron.length, "N")
                prev += step
            push(remainder, op)
        else:
            push(length, op)
        current += 1
        prev = current
    return final
