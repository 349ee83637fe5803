"""Native I/O runtime bindings (ctypes over src/io_native.cpp).

The reference implements its I/O hot paths in C++ (GzipDataWriter,
GzipDataReader, FASTQ record scanning); this package compiles the same
functionality once per machine into a cached shared object and binds it with
ctypes.  Everything has a pure-Python/zlib fallback so the package works
without a toolchain.

API:
    available() -> bool
    bgzf_compress(data: bytes|ndarray, level=6, threads=4, eof=False) -> bytes
    bgzf_decompress(data, max_out=None) -> bytes
    fastq_scan(buf) -> (records int64[N,5], trailing_offset)
    encode_bases(ascii uint8[N]) -> uint8[N] codes
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "src", "io_native.cpp")
_LIB = None
_TRIED = False


def _build_and_load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        # the build caches beside the sources (listed in .gitignore)
        cache_dir = os.path.join(os.path.dirname(__file__), "_build")
        os.makedirs(cache_dir, exist_ok=True)
        so_path = os.path.join(cache_dir, f"io_native_{tag}.so")
        if not os.path.exists(so_path):
            tmp = so_path + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-o", tmp, _SRC, "-lz", "-lpthread"],
                check=True, capture_output=True)
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        lib.bgzf_compress.restype = ctypes.c_int64
        lib.bgzf_compress.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int]
        lib.bgzf_compress_bound.restype = ctypes.c_int64
        lib.bgzf_compress_bound.argtypes = [ctypes.c_int64]
        lib.bgzf_decompress.restype = ctypes.c_int64
        lib.bgzf_decompress.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                        ctypes.c_char_p, ctypes.c_int64]
        lib.fastq_scan.restype = ctypes.c_int64
        lib.fastq_scan.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_void_p]
        lib.encode_bases.restype = None
        lib.encode_bases.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_void_p]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def available() -> bool:
    return _build_and_load() is not None


# ---------------------------------------------------------------------------
# BGZF
# ---------------------------------------------------------------------------

BGZF_EOF = bytes([
    0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00, 0, 0, 0, 0,
    0, 0, 0, 0])

_BLOCK = 0x10000 - 256


def _bgzf_compress_py(data: bytes, level: int, eof: bool) -> bytes:
    import struct
    import zlib
    out = bytearray()
    for off in range(0, len(data), _BLOCK) or [0]:
        chunk = data[off:off + _BLOCK]
        if not chunk and len(data) > 0:
            break
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        body = co.compress(chunk) + co.flush()
        bsize = len(body) + 26
        out += b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
        out += struct.pack("<H", bsize - 1)
        out += body
        out += struct.pack("<II", zlib.crc32(chunk), len(chunk))
    if eof:
        out += BGZF_EOF
    return bytes(out)


def bgzf_compress(data, level: int = 6, threads: int = 4,
                  eof: bool = False) -> bytes:
    data = bytes(data)
    lib = _build_and_load()
    if lib is None:
        return _bgzf_compress_py(data, level, eof)
    bound = lib.bgzf_compress_bound(len(data))
    out = ctypes.create_string_buffer(int(bound))
    n = lib.bgzf_compress(data, len(data), out, level, threads, int(eof))
    if n < 0:
        return _bgzf_compress_py(data, level, eof)
    return out.raw[:n]


def bgzf_decompress(data, max_out: int | None = None) -> bytes:
    data = bytes(data)
    lib = _build_and_load()
    if lib is None:
        import gzip
        import io
        return gzip.GzipFile(fileobj=io.BytesIO(data)).read()
    cap = max_out or max(len(data) * 8, 1 << 20)
    while True:
        out = ctypes.create_string_buffer(int(cap))
        n = lib.bgzf_decompress(data, len(data), out, cap)
        if n == -2:
            cap *= 4
            continue
        if n < 0:
            import gzip
            import io
            return gzip.GzipFile(fileobj=io.BytesIO(data)).read()
        return out.raw[:n]


# ---------------------------------------------------------------------------
# FASTQ
# ---------------------------------------------------------------------------

def fastq_scan(buf: bytes):
    """Scan complete FASTQ records: returns (int64[N,5] of
    (id_off, id_len, seq_off, seq_len, qual_off), trailing_offset)."""
    lib = _build_and_load()
    max_rec = max(len(buf) // 8, 16)
    if lib is not None:
        rec = np.empty((max_rec, 5), np.int64)
        trailing = ctypes.c_int64(0)
        n = lib.fastq_scan(buf, len(buf),
                           rec.ctypes.data_as(ctypes.c_void_p), max_rec,
                           ctypes.byref(trailing))
        if n >= 0:
            return rec[:n], int(trailing.value)
    # python fallback
    recs = []
    pos = 0
    L = len(buf)
    while pos < L:
        start = pos
        nl1 = buf.find(b"\n", pos)
        if nl1 < 0 or buf[pos:pos + 1] != b"@":
            break
        nl2 = buf.find(b"\n", nl1 + 1)
        nl3 = buf.find(b"\n", nl2 + 1) if nl2 >= 0 else -1
        if nl2 < 0 or nl3 < 0:
            return np.asarray(recs, np.int64).reshape(-1, 5), start
        seq_off, seq_end = nl1 + 1, nl2
        if buf[seq_end - 1:seq_end] == b"\r":
            seq_end -= 1
        qual_off = nl3 + 1
        seq_len = seq_end - seq_off
        if qual_off + seq_len > L:
            return np.asarray(recs, np.int64).reshape(-1, 5), start
        id_end = nl1 - (1 if buf[nl1 - 1:nl1] == b"\r" else 0)
        recs.append((start + 1, id_end - start - 1, seq_off, seq_len, qual_off))
        pos = qual_off + seq_len
        if buf[pos:pos + 1] == b"\r":
            pos += 1
        if buf[pos:pos + 1] == b"\n":
            pos += 1
    return np.asarray(recs, np.int64).reshape(-1, 5), pos


def encode_bases(ascii_arr: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(ascii_arr, dtype=np.uint8)
    lib = _build_and_load()
    out = np.empty_like(arr)
    if lib is not None and arr.size:
        lib.encode_bases(arr.ctypes.data_as(ctypes.c_char_p), arr.size,
                         out.ctypes.data_as(ctypes.c_void_p))
        return out
    from ..utils.tables import BASE_VALUE
    return BASE_VALUE[arr]
