"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with nvcc for Hopper (``sm_90a``) into a shared
library with plain C entry points (one per kernel; a source may hold
several), loaded with ctypes. The build runs at
first use, from the sources in the checkout, into ``_build/`` (git-ignored);
all stale sources compile at once, one nvcc process each. Nothing here runs
at import time: the CPU tests import every module on a machine without
nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel name -> (source file, C entry point, ctypes argtypes); a source
# file is one library, whatever number of entry points it exports
_VP, _I64, _I32, _U32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_uint32
KERNELS = {
    "classic_word": (
        "classic_word.cu",
        "classic_word_launch",
        [_VP, _I64, _VP, _VP, _VP, _I64, _U32, _I32, _VP],
    ),
    "stream_probe": (
        "stream_probe.cu",
        "stream_probe_launch",
        [_VP, _I64, _VP, _VP, _VP, _VP, _VP, _VP, _I64, _I32, _I32, _I32,
         _I32, _I32, _VP],
    ),
    "stream_probe_raw": (
        "stream_probe.cu",
        "stream_probe_raw_launch",
        [_VP, _I64, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I64, _I32, _I32, _VP],
    ),
}
SOURCES = sorted({src for src, _fn, _args in KERNELS.values()})

_lock = threading.Lock()
_fns: dict[str, object] = {}
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report (registers, shared memory, spills) per source
build_log: dict[str, str] = {}


def _so_path(src: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{os.path.splitext(src)[0]}.so")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_all() -> float:
    """Compile every stale kernel library, all nvcc processes at once.
    Returns the wall seconds spent (0 when everything was fresh)."""
    with _lock:
        return _build_locked()


def _build_locked() -> float:
    t0 = time.time()
    stale = [
        src
        for src in SOURCES
        if not os.path.exists(_so_path(src))
        or os.path.getmtime(_so_path(src))
        < os.path.getmtime(os.path.join(CSRC, src))
    ]
    if not stale:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in stale:
        tmp = f"{_so_path(name)}.{os.getpid()}.tmp"
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", tmp, os.path.join(CSRC, name),
        ]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    failed = []
    for name, tmp, p in procs:
        out, err = p.communicate(timeout=900)
        build_log[name] = (out + err).strip()
        if p.returncode != 0:
            failed.append(f"{name}:\n{build_log[name]}")
            continue
        os.replace(tmp, _so_path(name))  # atomic: readers never see a partial file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.time() - t0


def kernel(name: str):
    """The ctypes entry point of kernel ``name``; its library is built on
    first use. The C function returns cudaGetLastError() after the
    launch."""
    fn = _fns.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _fns:
            _build_locked()
            src, entry, argtypes = KERNELS[name]
            if src not in _libs:
                _libs[src] = ctypes.CDLL(_so_path(src))
            fn = getattr(_libs[src], entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = fn
        return _fns[name]
