"""wgsim read-ID oracle: the built-in accuracy harness.

Analog of reference SNAPLib/WGsim.{h,cpp}: wgsim-simulated reads encode
their true origin in the ID as ``piece_begin_end_:otherStuff`` (piece names
may contain '_', other stuff may contain ':'); an alignment is "misaligned"
when it lands more than maxK away from the [low, high] truth interval
(WGsim.cpp:40-156).  Used by the -e flag and the ROC tooling.
"""
from __future__ import annotations


def parse_wgsim_id(rid: bytes, genome) -> tuple[int, int] | None:
    """Returns (low, high) 0-based whole-genome truth locations, or None."""
    s = rid.decode(errors="replace")
    colon = s.find(":")
    if colon < 0:
        return None
    # walk back three underscores from the first colon
    idx = []
    i = colon
    for _ in range(3):
        i = s.rfind("_", 0, i)
        if i < 0:
            return None
        idx.append(i)
    u1, u2, u3 = idx  # first=closest to colon
    try:
        offset1 = int(s[u3 + 1:].split("_")[0])
    except ValueError:
        return None
    if u1 == u2 + 1:
        offset2 = offset1
    else:
        try:
            offset2 = int(s[u2 + 1:].split("_")[0])
        except ValueError:
            return None
    piece = s[:u3]
    try:
        base = genome.offset_of_piece(piece)
    except KeyError:
        return None
    o1 = offset1 + base - 1
    o2 = offset2 + base - 1
    return min(o1, o2), max(o1, o2)


def wgsim_misaligned(read, location: int, genome, max_k: int) -> bool:
    truth = parse_wgsim_id(read.rid, genome)
    if truth is None:
        return False
    low, high = truth
    return location > high + max_k or location + max_k < low


def wgsim_id(piece_name: str, offset_in_piece: int, read_length: int,
             first_half: bool = True) -> bytes:
    """Generate a wgsim-style ID (WGsim.cpp:158-165), 1-based coordinates."""
    return (f"{piece_name}_{offset_in_piece + 1}_"
            f"{offset_in_piece + read_length}_0::0:0_2:0:a0_0/"
            f"{1 if first_half else 2}").encode()
