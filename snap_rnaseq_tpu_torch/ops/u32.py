"""uint32 arithmetic on int32 tensors.

The engine's hash, bit-parallel carries and big-genome locations are uint32
math.  torch has a `torch.uint32` dtype but no shifts, compares, sums or
`where` on it, so every u32 value in the port is CARRIED as the int32 with
the same bit pattern.  Wrapping add, subtract and multiply, AND/OR/XOR and
left shifts are bit-identical on that carrier; the operations that read the
sign bit are not, and live here:

  shr      logical right shift (arithmetic shift + mask)
  ult/ule  unsigned compares (sign-bit flip, then signed compare)
  ord32    the order-preserving u32 -> i32 map (models/single.py _loc_ord)
  to_i64   the unsigned value widened to int64 (sort keys, range reduce)

Host boundaries convert with from_numpy / to_numpy (uint32 <-> int32 views).
"""
from __future__ import annotations

import numpy as np
import torch

SIGN = -0x80000000           # int32 bit pattern of 0x80000000
MASK32 = 0xFFFFFFFF


def const(v: int) -> int:
    """A u32 constant as the Python int of its int32 bit pattern."""
    v = int(v) & MASK32
    return v - (1 << 32) if v >= (1 << 31) else v


def from_numpy(a, device=None) -> torch.Tensor:
    """numpy uint32 (or int32) array -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    a = a.astype(np.int32, copy=False)
    if not a.flags.writeable:          # e.g. a memory-mapped index array
        a = a.copy()
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> numpy uint32 with the same bits."""
    return t.detach().to("cpu", torch.int32).numpy().view(np.uint32)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of a u32 carried in int32."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def ord32(x: torch.Tensor) -> torch.Tensor:
    """Monotone u32 -> i32 map: a <u b  <=>  ord32(a) < ord32(b)."""
    return x ^ SIGN


def ult(a, b) -> torch.Tensor:
    """a < b as uint32."""
    return _ord_any(a) < _ord_any(b)


def ule(a, b) -> torch.Tensor:
    """a <= b as uint32."""
    return _ord_any(a) <= _ord_any(b)


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise uint32 minimum."""
    return torch.where(ult(a, b), a, b)


def to_i64(x: torch.Tensor) -> torch.Tensor:
    """The unsigned value of a u32 carried in int32, as int64."""
    return x.to(torch.int64) & MASK32


def from_i64(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 carrier of its low 32 bits (wraps)."""
    return (((x & MASK32) ^ (1 << 31)) - (1 << 31)).to(torch.int32)


def _ord_any(x):
    if isinstance(x, torch.Tensor):
        return x ^ SIGN
    return const(x) ^ SIGN
