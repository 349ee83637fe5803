"""Build, load and count the hand-written CUDA kernels.

Each `csrc/*.cu` source is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, loaded with ctypes.  K2's source is
compiled 13 times: once for 1-4 pattern words (reads up to 128 bases) and
once for each word count from 5 to 16 (`-DBPK_WORDS=W`), so that its
largest instances compile side by side.  Libraries are built at first use
from the package's own sources into `csrc/_build/`, keyed by a hash of the
source, the shared headers and the flags, so an edited kernel is rebuilt
and an unchanged one is reused.  `build_all()` starts one nvcc per library
at once and waits for all of them.  Each build's compiler
output (`-Xptxas -v`: registers and spills per kernel) is kept beside its
library, and `ptxas_report(name)` reads it.

Nothing here is imported by a kernel-free code path: the wrappers call
`launcher(name)` only when they are handed a CUDA tensor.  It loads the
library once and binds its launch function to the C signature in
`_SIGNATURES` once.  `set_variant(name, v)` calls the setter a library
exports for measurement (`_SETTERS`: K3's warps per block), which forces
a launch variant until it is set back to 0.

Every wrapper adds one to `LAUNCHES[<kernel>]` where it launches its kernel
and nowhere else, so a run can show which kernels its main path reached.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

# source file per library; each exports C functions returning cudaError_t
SOURCES = {
    "lv_lanes": "lv_lanes.cu",           # K1
    "bitpar_packed": "bitpar_packed.cu",  # K2 (forward and rescue), W 1-4
    "lv_cigar": "lv_cigar.cu",           # K3
    "bitpar_rows": "bitpar_rows.cu",      # K4
    "lv_onehot": "lv_onehot.cu",         # K5
}


def k2_library(P: int) -> str:
    """K2's library for patterns of P bases: W = ceil(P / 32) words, one
    library for W = 1-4 and one per word count above."""
    W = (P + 31) // 32
    return "bitpar_packed" if W <= 4 else f"bitpar_packed_w{W}"


# K2 at W = 5-16 pattern words (P = 129-512)
_DEFINES = {k2_library(32 * w): [f"-DBPK_WORDS={w}"] for w in range(5, 17)}
SOURCES.update({name: "bitpar_packed.cu" for name in _DEFINES})
_HEADERS = ("lv_common.cuh", "lv_warp.cuh", "bitpar_common.cuh")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# launch function and argument types per library (see each source's
# extern "C" function): pointers and the stream as void*, sizes as int
_SIGNATURES = {
    "lv_lanes": ("lv_lanes_launch", [_P] * 8 + [_I] * 4 + [_F] * 4
                 + [_P] * 6),
    "bitpar_packed": ("bitpar_packed_launch",
                      [_P, _I, _P, _I, _P] + [_I] * 9 + [_P, _P]),
    "lv_cigar": ("lv_cigar_launch", [_P] * 7 + [_I] * 4 + [_F] * 4
                 + [_P] * 11),
    "bitpar_rows": ("bitpar_rows_launch", [_P, _I, _P, _I, _P] + [_I] * 3
                    + [_P, _P]),
    "lv_onehot": ("lv_onehot_launch", [_P] * 8 + [_I] * 4 + [_F] * 4
                  + [_P] * 6),
}

for _name in _DEFINES:
    _SIGNATURES[_name] = _SIGNATURES["bitpar_packed"]

# int(int) setters for measurement: force a launch variant (0: the
# kernel's own choice), return the previous one
_SETTERS = {"lv_cigar": "lv_cigar_set_warps"}     # K3 warps per block

# K2 counts its forward (prefilter) and its rescue launches apart
LAUNCHES = {"K1_lv_lanes": 0, "K2_bitpar_packed": 0, "K2_bitpar_rescue": 0,
            "K3_lv_cigar": 0, "K4_bitpar_rows": 0, "K5_lv_onehot": 0}
BUILD_SECONDS: dict = {}
_LOCK = threading.Lock()
_LAUNCHERS: dict = {}
_LIBS: dict = {}


def count_launch(name: str) -> None:
    with _LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ at first use and need the CUDA toolkit")
    return path


def _flags(name: str) -> list:
    return NVCC_FLAGS + _DEFINES.get(name, [])


def _so_path(name: str) -> str:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for f in (SOURCES[name],) + _HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def build_all(names=None) -> dict:
    """Compile every (or the named) library that is not built yet, all
    nvcc processes at once.  Returns {name: so_path}; raises with the
    compiler's output if any build fails.  BUILD_SECONDS[name] is each
    build's wall time from the common start to its nvcc's exit."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, paths, t0 = {}, {}, time.time()
    for name in names:
        so = _so_path(name)
        paths[name] = so
        if os.path.exists(so):
            continue
        tmp = f"{so}.tmp{os.getpid()}"
        cmd = [_nvcc(), *_flags(name), "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, SOURCES[name])]
        log = open(tmp + ".log", "wb+")       # ptxas -v's report
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), tmp, so,
                       log)
    errors = []
    while procs:
        for name, (p, tmp, so, log) in list(procs.items()):
            if p.poll() is None:
                continue
            del procs[name]
            BUILD_SECONDS[name] = time.time() - t0
            log.close()
            if p.returncode != 0:
                with open(tmp + ".log") as fh:
                    errors.append(f"nvcc {SOURCES[name]} failed:\n"
                                  + fh.read())
            else:
                os.replace(tmp + ".log", so + ".log")
                os.replace(tmp, so)
        time.sleep(0.05)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def ptxas_report(name: str) -> list:
    """Registers and spill bytes of each kernel in library `name`, from
    the `-Xptxas -v` output saved beside its build: a list of
    {"function", "registers", "spill_stores", "spill_loads"}."""
    with open(_so_path(name) + ".log") as fh:
        return parse_ptxas(fh.read())


def parse_ptxas(text: str) -> list:
    """ptxas_report's rows from the text of an `-Xptxas -v` build."""
    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return rows


def _library(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_all([name])[name])
        with _LOCK:
            lib = _LIBS.setdefault(name, lib)
    return lib


def launcher(name: str):
    """The launch function of library `name`, built, loaded and bound to
    its C signature at the first call and cached after."""
    with _LOCK:
        cached = _LAUNCHERS.get(name)
    if cached is not None:
        return cached
    fn_name, argtypes = _SIGNATURES[name]
    fn = getattr(_library(name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    with _LOCK:
        return _LAUNCHERS.setdefault(name, fn)


def set_variant(name: str, value: int) -> int:
    """Force library `name`'s launch variant through its setter in
    `_SETTERS` (0 restores the kernel's own choice); returns the previous
    setting.  For measurements that compare variants on the same inputs."""
    fn = getattr(_library(name), _SETTERS[name])
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(int(value))


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    """Wrapper-side argument checks: device, dtype, rank, contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
