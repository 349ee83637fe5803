"""Build, load and count the hand-written CUDA kernels.

Each `csrc/*.cu` source is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, loaded with ctypes.  Libraries are built
at first use from the package's own sources into `csrc/_build/`, keyed by
a hash of the source, the shared header and the flags, so an edited kernel
is rebuilt and an unchanged one is reused.  `build_all()` starts one nvcc
per source at once and waits for all of them.

Nothing here is imported by a kernel-free code path: the wrappers call
`launcher(name)` only when they are handed a CUDA tensor.  It loads the
library once and binds its launch function to the C signature in
`_SIGNATURES` once.

Every wrapper adds one to `LAUNCHES[<kernel>]` where it launches its kernel
and nowhere else, so a run can show which kernels its main path reached.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

# source file per library; each exports C functions returning cudaError_t
SOURCES = {
    "lv_lanes": "lv_lanes.cu",           # K1
    "bitpar_packed": "bitpar_packed.cu",  # K2
    "lv_cigar": "lv_cigar.cu",           # K3
}
_HEADERS = ("lv_common.cuh",)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# launch function and argument types per library (see each source's
# extern "C" function): pointers and the stream as void*, sizes as int
_SIGNATURES = {
    "lv_lanes": ("lv_lanes_launch", [_P] * 8 + [_I] * 4 + [_F] * 4
                 + [_P] * 6),
    "bitpar_packed": ("bitpar_packed_launch",
                      [_P, _I, _P, _I, _P, _I, _I, _I, _P, _P]),
    "lv_cigar": ("lv_cigar_launch", [_P] * 7 + [_I] * 4 + [_F] * 4
                 + [_P] * 11),
}

LAUNCHES = {"K1_lv_lanes": 0, "K2_bitpar_packed": 0, "K3_lv_cigar": 0}
_LOCK = threading.Lock()
_LAUNCHERS: dict = {}


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


def _so_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + _HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def build_all(names=None) -> dict:
    """Compile every (or the named) library that is not built yet, all
    nvcc processes at once.  Returns {name: so_path}; raises with the
    compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, paths = {}, {}
    for name in names:
        so = _so_path(name)
        paths[name] = so
        if os.path.exists(so):
            continue
        tmp = f"{so}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, so)
    errors = []
    for name, (p, tmp, so) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc {SOURCES[name]} failed:\n{out.decode()}")
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def launcher(name: str):
    """The launch function of library `name`, built, loaded and bound to
    its C signature at the first call and cached after."""
    with _LOCK:
        cached = _LAUNCHERS.get(name)
    if cached is not None:
        return cached
    so = build_all([name])[name]
    fn_name, argtypes = _SIGNATURES[name]
    fn = getattr(ctypes.CDLL(so), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    with _LOCK:
        return _LAUNCHERS.setdefault(name, fn)


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
