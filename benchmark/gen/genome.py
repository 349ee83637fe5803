"""The configurations' genomes, made from their own seeds by the kind
their `genome` entry names (benchmark/gen/genomes/<kind>.py).

Codes: A=0, G=1, C=2, T=3, padding 5 (matches nothing).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import lookup

PAD_CODE = 5


@dataclass
class Genome:
    codes: np.ndarray            # uint8, pieces with their padding
    piece_offsets: np.ndarray    # int64 start of each piece's bases
    piece_len: int               # bases of each piece
    padding: int

    @property
    def size(self) -> int:
        return int(self.codes.shape[0])

    @property
    def names(self) -> list:
        return [f"chr{c + 1}" for c in range(len(self.piece_offsets))]


def make_genome(spec: dict, workers: int | None = None) -> Genome:
    """The genome a configuration's `genome` entry states; a kind that
    makes its pieces in processes uses `workers` of them (default: one
    per core)."""
    return lookup.genome_kind(spec).make(spec, workers)
