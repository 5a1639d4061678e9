"""ctypes bindings for the port's own copy of the native ingest library
(ingest.cpp).

The library is compiled on demand with g++ into this directory (C ABI +
ctypes keeps the build trivial). Every entry point has an exact numpy
fallback: `available()` gates the fast path, and sequences that the 2-bit
fast path cannot represent (lowercase bases, k > 32) are re-routed to the
numpy path by the callers, so results are identical either way. That
fallback is the reference's semantics on the host, not a device fallback.

Only the entry points that build and search call are bound here.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ingest.cpp")
_SO = os.path.join(_HERE, "libcoloridnative_torch.so")

_lib = None
_lock = threading.Lock()
_tried = False


def _compile() -> bool:
    # build into a temp name and rename: concurrent test workers may race
    # to build, and a reader must never map a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_HERE)
    os.close(fd)
    cmd = [
        "g++", "-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC",
        _SRC, "-o", tmp, "-lz",
    ]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:  # g++ missing etc.
        print(f"colorid_tpu_torch native build unavailable: {e}", file=sys.stderr)
        os.unlink(tmp)
        return False
    if r.returncode != 0:
        print(f"colorid_tpu_torch native build failed:\n{r.stderr}", file=sys.stderr)
        os.unlink(tmp)
        return False
    os.replace(tmp, _SO)
    return True


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _compile():
                return None
        lib = ctypes.CDLL(_SO)
        lib.ct_xxh3_rows.restype = None
        lib.ct_xxh3_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_void_p,
        ]
        lib.ct_xxh3_hash64.restype = None
        lib.ct_xxh3_hash64.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p,
        ]
        lib.ct_counter_new.restype = ctypes.c_void_p
        lib.ct_counter_new.argtypes = [ctypes.c_int32]
        lib.ct_counter_free.argtypes = [ctypes.c_void_p]
        lib.ct_counter_fallback.restype = ctypes.c_int32
        lib.ct_counter_fallback.argtypes = [ctypes.c_void_p]
        lib.ct_counter_add.restype = ctypes.c_int32
        lib.ct_counter_add.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.ct_counter_add_many.restype = ctypes.c_int32
        lib.ct_counter_add_many.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.ct_counter_unique.restype = ctypes.c_int64
        lib.ct_counter_unique.argtypes = [ctypes.c_void_p]
        lib.ct_counter_counts.restype = None
        lib.ct_counter_counts.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ct_counter_dump.restype = ctypes.c_int64
        lib.ct_counter_dump.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ct_counter_dump_packed.restype = ctypes.c_int64
        lib.ct_counter_dump_packed.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ct_count_fastq.restype = ctypes.c_void_p
        lib.ct_count_fastq.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def xxh3_rows(keys: np.ndarray, num_hash: int, bloom_size: int) -> np.ndarray:
    """Bloom rows [N, H] uint32 for ASCII key rows [N, k]."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    n, k = keys.shape
    out = np.empty((n, num_hash), dtype=np.uint32)
    lib.ct_xxh3_rows(
        keys.ctypes.data, n, k, num_hash, bloom_size, out.ctypes.data
    )
    return out


def xxh3_hash64(keys: np.ndarray, num_hash: int) -> np.ndarray:
    """Raw seeded digests [N, H] uint64 for ASCII key rows [N, k]."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    n, k = keys.shape
    out = np.empty((n, num_hash), dtype=np.uint64)
    lib.ct_xxh3_hash64(keys.ctypes.data, n, k, num_hash, out.ctypes.data)
    return out


class NativeCounter:
    """2-bit canonical k-mer/minimizer counter (k <= 32, uppercase ACGT)."""

    def __init__(self, k: int, m_size: int = 0):
        lib = _load()
        if lib is None or k > 32 or (m_size and m_size > 32):
            raise ValueError("native counter unavailable for these params")
        self._lib = lib
        self._h = lib.ct_counter_new(k)
        self.k = k
        self.m_size = m_size
        self.width = m_size if m_size else k

    def add(self, seq: np.ndarray, d: int = 1) -> bool:
        """Count one sequence; False => lowercase fallback needed."""
        seq = np.ascontiguousarray(seq, dtype=np.uint8)
        r = self._lib.ct_counter_add(
            self._h, seq.ctypes.data, len(seq), d, self.m_size
        )
        return r == 0

    def add_many(self, seqs: np.ndarray, d: int = 1) -> bool:
        """Count a [n, L] uint8 batch of equal-length sequences."""
        seqs = np.ascontiguousarray(seqs, dtype=np.uint8)
        n, L = seqs.shape
        r = self._lib.ct_counter_add_many(
            self._h, seqs.ctypes.data, n, L, d, self.m_size
        )
        return r == 0

    @property
    def fallback(self) -> bool:
        return bool(self._lib.ct_counter_fallback(self._h))

    def unique(self) -> int:
        return self._lib.ct_counter_unique(self._h)

    def counts(self) -> np.ndarray:
        n = self.unique()
        out = np.empty(n, dtype=np.int64)
        if n:
            self._lib.ct_counter_counts(self._h, out.ctypes.data)
        return out

    def dump(self, t: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Entries with count > t. Returns (keys [U, width], counts [U])."""
        n = self.unique()
        keys = np.empty((n, self.width), dtype=np.uint8)
        counts = np.empty(n, dtype=np.int64)
        u = self._lib.ct_counter_dump(
            self._h, t, self.width, keys.ctypes.data, counts.ctypes.data
        )
        return keys[:u], counts[:u]

    def dump_packed(self, t: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Entries with count > t as (lo, hi) uint32 pairs [U, 2] of the
        2-bit packed canonical k-mer (device-hash input) + counts."""
        n = self.unique()
        keys = np.empty(n, dtype=np.uint64)
        counts = np.empty(n, dtype=np.int64)
        u = self._lib.ct_counter_dump_packed(
            self._h, t, keys.ctypes.data, counts.ctypes.data
        )
        pairs = np.empty((u, 2), dtype=np.uint32)
        pairs[:, 0] = (keys[:u] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        pairs[:, 1] = (keys[:u] >> np.uint64(32)).astype(np.uint32)
        return pairs, counts[:u]

    def close(self) -> None:
        if self._h:
            self._lib.ct_counter_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def count_fastq(
    path1: str, path2: str | None, k: int, qual_offset: int, m_size: int = 0
) -> NativeCounter | None:
    """Whole-file (PE) fastq.gz counting in C++. None => use numpy path."""
    lib = _load()
    if lib is None or k > 32 or (m_size and m_size > 32):
        return None
    h = lib.ct_count_fastq(
        path1.encode(), (path2 or "").encode(), k, qual_offset, m_size
    )
    if not h:
        return None
    c = NativeCounter.__new__(NativeCounter)
    c._lib = lib
    c._h = h
    c.k = k
    c.m_size = m_size
    c.width = m_size if m_size else k
    if c.fallback:
        c.close()
        return None
    return c
