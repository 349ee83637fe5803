"""Contamination accounting.

Analog of reference SNAPLib/ContaminationFilter.{h,cpp}: reads whose only
alignment is to the contamination database (rRNA, adapters, ...) are counted
per contaminant piece and written to `<prefix>.contamination` at run end
(ContaminationFilter.h:36-77, called from AlignerContext.cpp:129-132).
"""
from __future__ import annotations

from ..index.genome import Genome


class ContaminationFilter:
    def __init__(self, contamination_genome: Genome, prefix: str = "output"):
        self.genome = contamination_genome
        self.prefix = prefix
        self.counts: dict[str, int] = {}

    def add_alignment(self, location: int):
        """Count one read aligned to the contaminant at `location`."""
        if location in (None, -1):
            return
        name, _ = self.genome.piece_at(int(location))
        self.counts[name] = self.counts.get(name, 0) + 1

    def write(self, prefix: str | None = None):
        path = (prefix or self.prefix) + ".contamination"
        with open(path, "w") as f:
            for name in sorted(self.counts):
                f.write(f"{name}\t{self.counts[name]}\n")
