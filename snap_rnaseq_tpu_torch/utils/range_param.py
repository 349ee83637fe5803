"""Range-valued CLI parameters: `n`, `n1:n2`, or `n1:s:n2`.

Analog of reference SNAPLib/Range.{h,cpp} (Range.h:29-56): inclusive
{start, step, end}; AlignerContext sweeps the (maxHits x maxDist) grid one
alignment iteration per combination (AlignerContext.cpp:357-369).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Range:
    start: int
    end: int
    step: int = 1

    @classmethod
    def parse(cls, text: str) -> "Range":
        parts = str(text).split(":")
        if len(parts) == 1:
            v = int(parts[0])
            return cls(v, v)
        if len(parts) == 2:
            return cls(int(parts[0]), int(parts[1]))
        if len(parts) == 3:
            return cls(int(parts[0]), int(parts[2]), int(parts[1]))
        raise ValueError(f"bad range {text!r} (want n, n1:n2, or n1:s:n2)")

    def values(self) -> list[int]:
        return list(range(self.start, self.end + 1, max(self.step, 1)))

    @property
    def is_single(self) -> bool:
        return self.start == self.end
