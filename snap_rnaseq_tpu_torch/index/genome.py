"""The reference genome as one flat array of base codes.

TPU-native analog of reference SNAPLib/Genome.{h,cpp} + FASTA.cpp:

* the whole genome is ONE uint8 array of base codes (A=0,G=1,C=2,T=3,N=4,pad=5),
  chromosomes ("pieces") concatenated with `padding` lowercase-'n' sentinel
  bases before each piece and after the last (FASTA.cpp:67-126);
* genome Ns are stored as the distinct code 5 so they never match read Ns,
  mirroring the reference's N->'n' trick (FASTA.cpp:104-117);
* locations are uint32 offsets into the flat array; piece lookup is a
  searchsorted over piece start offsets (Genome.h:78-148).

Unlike the reference we keep the code array ready to ship to TPU HBM as-is:
candidate scoring gathers fixed-length windows straight out of it, and the
padding guarantees a window that starts inside a piece never silently reads
another piece's bases (padding never matches any read base).
"""
from __future__ import annotations

import bisect
import io
import json
import os
from dataclasses import dataclass, field

import numpy as np

from ..constants import DEFAULT_CHROMOSOME_PADDING
from ..utils.tables import BASE_PAD, BASE_VALUE, decode_bases


@dataclass
class Genome:
    codes: np.ndarray                       # uint8[n_bases], flat base codes
    piece_names: list[str]                  # chromosome names
    piece_offsets: np.ndarray               # int64[n_pieces], start of each piece
    padding: int = DEFAULT_CHROMOSOME_PADDING
    # the codes packed 4 bits a base (ops/genome_gather.py pack_genome_4bit)
    # when they are made apart from the codes; None: packed from the codes
    packed_4bit: np.ndarray | None = field(default=None, repr=False)
    _name_to_index: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.codes = np.ascontiguousarray(self.codes, dtype=np.uint8)
        self.piece_offsets = np.asarray(self.piece_offsets, dtype=np.int64)
        if not self._name_to_index:
            self._name_to_index = {n: i for i, n in enumerate(self.piece_names)}
        # plain-list copy for the scalar bisect fast path (piece_index_at is
        # called once per emitted record; numpy scalar searchsorted overhead
        # dominated the SAM write path)
        self._offsets_list = [int(x) for x in self.piece_offsets]

    @property
    def num_bases(self) -> int:
        return int(self.codes.shape[0])

    @property
    def num_pieces(self) -> int:
        return len(self.piece_names)

    def piece_index_at(self, location) -> np.ndarray:
        """Index of the piece containing each location (scalar or vector).

        A location inside the padding that precedes piece i+1 belongs to piece
        i, matching the reference's getPieceAtLocation semantics.
        """
        if isinstance(location, (int, np.integer)):
            idx = bisect.bisect_right(self._offsets_list, int(location)) - 1
            return min(max(idx, 0), self.num_pieces - 1)
        return np.clip(
            np.searchsorted(self.piece_offsets, np.asarray(location), side="right") - 1,
            0, self.num_pieces - 1)

    def piece_at(self, location: int) -> tuple[str, int]:
        """(piece name, 0-based offset within piece) for one location."""
        idx = int(self.piece_index_at(location))
        return self.piece_names[idx], int(location - self.piece_offsets[idx])

    def piece_end(self, piece_index) -> np.ndarray:
        """Exclusive end of each piece = next piece's start (or genome end).

        Reference getSubstring refuses windows that cross into the NEXT
        piece's beginningOffset (Genome.h:78-148); windows may extend into the
        trailing padding, which never matches read bases.
        """
        ends = np.append(self.piece_offsets[1:], self.num_bases)
        return ends[piece_index]

    def offset_of_piece(self, name: str) -> int:
        return int(self.piece_offsets[self._name_to_index[name]])

    def substring_codes(self, location: int, length: int) -> np.ndarray:
        return self.codes[location:location + length]

    def substring(self, location: int, length: int) -> bytes:
        return decode_bases(self.substring_codes(location, length))

    # ---------------- persistence (directory format) ----------------

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        meta = {
            "format": "snap-rnaseq-tpu-genome",
            "version": 1,
            "num_bases": self.num_bases,
            "padding": self.padding,
            "piece_names": self.piece_names,
            "piece_offsets": [int(x) for x in self.piece_offsets],
        }
        with open(os.path.join(directory, "genome.json"), "w") as f:
            json.dump(meta, f)
        self.codes.tofile(os.path.join(directory, "genome.codes"))

    @classmethod
    def load(cls, directory: str, mmap: bool = True) -> "Genome":
        with open(os.path.join(directory, "genome.json")) as f:
            meta = json.load(f)
        path = os.path.join(directory, "genome.codes")
        codes = (np.memmap(path, dtype=np.uint8, mode="r") if mmap
                 else np.fromfile(path, dtype=np.uint8))
        return cls(codes=np.asarray(codes),
                   piece_names=list(meta["piece_names"]),
                   piece_offsets=np.asarray(meta["piece_offsets"], dtype=np.int64),
                   padding=int(meta["padding"]))


def read_fasta_genome(path_or_file, padding: int = DEFAULT_CHROMOSOME_PADDING) -> Genome:
    """Parse a FASTA file into a Genome, reproducing the reference layout:
    [pad]{piece}[pad]{piece}...[pad] with `padding` 'n' codes (FASTA.cpp:67-126).

    Sequence is uppercased; N (or any non-ACGT letter) becomes genome-N
    (code 5, the never-matches sentinel), exactly like the reference, which
    maps genome Ns to lowercase 'n'.
    """
    own = False
    if isinstance(path_or_file, (str, os.PathLike)):
        f = open(path_or_file, "rb")
        own = True
    else:
        f = path_or_file
    try:
        names: list[str] = []
        offsets: list[int] = []
        chunks: list[np.ndarray] = []
        pad = np.full(padding, BASE_PAD, dtype=np.uint8)
        total = 0

        def push(arr: np.ndarray):
            nonlocal total
            chunks.append(arr)
            total += arr.shape[0]

        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if line.startswith(b">"):
                push(pad)
                name = line[1:].split(b" ")[0].split(b"\t")[0].decode()
                names.append(name)
                offsets.append(total)
            else:
                codes = BASE_VALUE[np.frombuffer(line, dtype=np.uint8)]
                # genome Ns (code 4 out of BASE_VALUE) become the pad/'n'
                # code 5 so they never match read Ns
                codes = np.where(codes >= 4, np.uint8(BASE_PAD), codes)
                push(codes)
        push(pad)
        if not names:
            raise ValueError("FASTA file contains no sequences")
        return Genome(codes=np.concatenate(chunks), piece_names=names,
                      piece_offsets=np.asarray(offsets, dtype=np.int64),
                      padding=padding)
    finally:
        if own:
            f.close()


def write_fasta(genome: Genome, path: str, line_width: int = 0) -> None:
    """AppendFASTAGenome analog: writes each piece (including its trailing
    padding region, which decodes to 'n') as one FASTA record."""
    with open(path, "wb") as f:
        for i, name in enumerate(genome.piece_names):
            start = int(genome.piece_offsets[i])
            end = int(genome.piece_end(i))
            f.write(b">" + name.encode() + b"\n")
            seq = decode_bases(genome.codes[start:end])
            if line_width:
                for j in range(0, len(seq), line_width):
                    f.write(seq[j:j + line_width] + b"\n")
            else:
                f.write(seq + b"\n")


def genome_from_codes(codes: np.ndarray, name: str = "ref",
                      padding: int = DEFAULT_CHROMOSOME_PADDING) -> Genome:
    """Build a single-piece Genome from raw base codes (test helper)."""
    pad = np.full(padding, BASE_PAD, dtype=np.uint8)
    flat = np.concatenate([pad, np.asarray(codes, dtype=np.uint8), pad])
    return Genome(codes=flat, piece_names=[name],
                  piece_offsets=np.asarray([padding], dtype=np.int64),
                  padding=padding)
