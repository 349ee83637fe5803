"""Base-translation lookup tables (numpy), the analog of reference Tables.{h,cpp}.

All tables are 256-entry uint8 arrays indexed by ASCII byte value, so whole
reads/genomes translate with a single fancy-index: ``BASE_VALUE[ascii_arr]``.
"""
from __future__ import annotations

import numpy as np

from ..constants import BASE_A, BASE_C, BASE_G, BASE_N, BASE_PAD, BASE_T

# ASCII byte -> base code.  A=0, G=1, C=2, T=3 (complement == code ^ 3),
# N=4, genome-padding 'n'=5, everything else = N.  (Tables.cpp:36-49)
BASE_VALUE = np.full(256, BASE_N, dtype=np.uint8)
for _ch, _v in ((b"A", BASE_A), (b"G", BASE_G), (b"C", BASE_C), (b"T", BASE_T)):
    BASE_VALUE[_ch[0]] = _v
    BASE_VALUE[_ch.lower()[0]] = _v
BASE_VALUE[ord("n")] = BASE_PAD  # only produced by our own genome encoder

# base code -> ASCII byte
VALUE_BASE = np.frombuffer(b"AGCTNn", dtype=np.uint8).copy()

# ASCII byte -> ASCII complement byte (used when reverse-complementing text)
COMPLEMENT = np.arange(256, dtype=np.uint8)
for _a, _b in ((b"A", b"T"), (b"C", b"G"), (b"G", b"C"), (b"T", b"A"),
               (b"a", b"t"), (b"c", b"g"), (b"g", b"c"), (b"t", b"a")):
    COMPLEMENT[_a[0]] = _b[0]

IS_N = np.zeros(256, dtype=np.uint8)
IS_N[ord("N")] = 1
IS_N[ord("n")] = 1

# code-level complement: ACGT codes flip with ^3; N and pad map to themselves.
CODE_COMPLEMENT = np.array([3, 2, 1, 0, BASE_N, BASE_PAD], dtype=np.uint8)


def encode_bases(ascii_bytes: bytes | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 base codes."""
    arr = np.frombuffer(ascii_bytes, dtype=np.uint8) if isinstance(
        ascii_bytes, (bytes, bytearray)) else np.asarray(ascii_bytes, dtype=np.uint8)
    return BASE_VALUE[arr]


def decode_bases(codes: np.ndarray) -> bytes:
    """uint8 base codes -> ASCII bytes."""
    return VALUE_BASE[np.asarray(codes, dtype=np.uint8)].tobytes()


def reverse_complement_codes(codes: np.ndarray) -> np.ndarray:
    return CODE_COMPLEMENT[np.asarray(codes, dtype=np.uint8)][::-1].copy()
