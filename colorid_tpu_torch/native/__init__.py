"""ctypes bindings for the port's own copy of the native ingest library
(ingest.cpp).

The library is compiled on demand with g++ into this directory (C ABI +
ctypes keeps the build trivial). Every entry point has an exact numpy
fallback: `available()` gates the fast path, and sequences that the 2-bit
fast path cannot represent (lowercase bases, k > 32) are re-routed to the
numpy path by the callers, so results are identical either way. That
fallback is the reference's semantics on the host, not a device fallback.

Bound: what build, search and read_id call.
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
        lib.ct_read_sets_packed.restype = ctypes.c_int64
        lib.ct_read_sets_packed.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32,
        ]
        lib.ct_read_sets.restype = ctypes.c_int64
        lib.ct_read_sets.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_uint64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32,
        ]
        lib.ct_read_rank_windows.restype = ctypes.c_int64
        lib.ct_read_rank_windows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.ct_fnv_ranks.restype = None
        lib.ct_fnv_ranks.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p,
        ]
        lib.ct_fnv_ranks_bytes.restype = None
        lib.ct_fnv_ranks_bytes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.ct_pack_valid.restype = None
        lib.ct_pack_valid.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ct_pack_valid_sel.restype = None
        lib.ct_pack_valid_sel.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.rs_open.restype = ctypes.c_void_p
        lib.rs_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32]
        lib.rs_close.argtypes = [ctypes.c_void_p]
        lib.rs_next_batch.restype = ctypes.c_int64
        lib.rs_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def pack_valid(seqs_concat: np.ndarray, seq_offs: np.ndarray, pack_len: int):
    """2-bit words [M, pack_len/16] + validity bitplane [M, pack_len/32]
    for concatenated byte sequences (the C twin of
    ops/extract.py::pack_reads_valid on a ragged batch). None if the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    seqs_concat = np.ascontiguousarray(seqs_concat, dtype=np.uint8)
    seq_offs = np.ascontiguousarray(seq_offs, dtype=np.int64)
    M = seq_offs.shape[0] - 1
    words = np.zeros((M, pack_len // 16), dtype=np.uint32)
    valid = np.zeros((M, pack_len // 32), dtype=np.uint32)
    lib.ct_pack_valid(
        seqs_concat.ctypes.data, seq_offs.ctypes.data, M, pack_len,
        words.ctypes.data, valid.ctypes.data,
    )
    return words, valid


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


def read_sets(
    seqs_concat: np.ndarray,
    seq_offs: np.ndarray,
    read_seq_counts: np.ndarray,
    k: int,
    d: int,
    m_size: int,
    num_hash: int,
    bloom_size: int,
    fnv_order: bool = True,
):
    """Per-read k-mer sets -> (rows [N,H], seg [N], pos [N], maplen [B]) or
    None when the native path can't handle the batch. With fnv_order (the
    default) ``pos`` carries the reference's FnvHashSet iteration rank; with
    fnv_order=False, first-occurrence rank."""
    lib = _load()
    if lib is None or k > 32 or (m_size and m_size > 32):
        return None
    seqs_concat = np.ascontiguousarray(seqs_concat, dtype=np.uint8)
    seq_offs = np.ascontiguousarray(seq_offs, dtype=np.int64)
    read_seq_counts = np.ascontiguousarray(read_seq_counts, dtype=np.int32)
    n_reads = len(read_seq_counts)
    lens = np.diff(seq_offs)
    cap = int(np.maximum(0, (lens - k) // d + 1).sum())
    rows = np.empty((max(cap, 1), num_hash), dtype=np.uint32)
    seg = np.empty(max(cap, 1), dtype=np.int32)
    pos = np.empty(max(cap, 1), dtype=np.int32)
    maplen = np.empty(n_reads, dtype=np.int32)
    total = lib.ct_read_sets(
        seqs_concat.ctypes.data, seq_offs.ctypes.data,
        read_seq_counts.ctypes.data, n_reads, k, d, m_size,
        num_hash, bloom_size,
        rows.ctypes.data, seg.ctypes.data, pos.ctypes.data,
        maplen.ctypes.data, cap, 1 if fnv_order else 0,
    )
    if total == -2:
        return None  # lowercase in batch: numpy path
    if total < 0:
        raise RuntimeError("ct_read_sets capacity underestimate")
    return rows[:total], seg[:total], pos[:total], maplen


def read_sets_packed(
    seqs_concat: np.ndarray,
    seq_offs: np.ndarray,
    read_seq_counts: np.ndarray,
    k: int,
    d: int,
    m_size: int,
    fnv_order: bool = True,
):
    """Per-read k-mer sets as raw 2-bit packed keys ->
    (packed [N, 2] uint32, seg [N] int16, pos [N] int16, maplen [B]) or None
    (lowercase / unsupported params -> caller uses the exact path).
    ``pos`` is the FnvHashSet iteration rank when fnv_order (default), else
    first-occurrence rank."""
    lib = _load()
    if lib is None or k > 32 or (m_size and m_size > 32):
        return None
    seqs_concat = np.ascontiguousarray(seqs_concat, dtype=np.uint8)
    seq_offs = np.ascontiguousarray(seq_offs, dtype=np.int64)
    read_seq_counts = np.ascontiguousarray(read_seq_counts, dtype=np.int32)
    n_reads = len(read_seq_counts)
    if n_reads > 32768:  # int16 read ids: 0..32767
        return None
    lens = np.diff(seq_offs)
    cap = int(np.maximum(0, (lens - k) // d + 1).sum())
    packed = np.empty(max(cap, 1), dtype=np.uint64)
    seg = np.empty(max(cap, 1), dtype=np.int16)
    pos = np.empty(max(cap, 1), dtype=np.int16)
    maplen = np.empty(n_reads, dtype=np.int32)
    total = lib.ct_read_sets_packed(
        seqs_concat.ctypes.data, seq_offs.ctypes.data,
        read_seq_counts.ctypes.data, n_reads, k, d, m_size,
        packed.ctypes.data, seg.ctypes.data, pos.ctypes.data,
        maplen.ctypes.data, cap, 1 if fnv_order else 0,
    )
    if total == -2:
        return None
    if total < 0:
        raise RuntimeError("ct_read_sets_packed capacity underestimate")
    pairs = np.empty((total, 2), dtype=np.uint32)
    pairs[:, 0] = (packed[:total] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    pairs[:, 1] = (packed[:total] >> np.uint64(32)).astype(np.uint32)
    return pairs, seg[:total], pos[:total], maplen


def fnv_ranks_packed(
    keys_u64: np.ndarray, bounds: np.ndarray, width: int
) -> np.ndarray | None:
    """FnvHashSet iteration ranks for 2-bit packed canonical k-mers.

    keys_u64 [N] are per-set unique keys in first-occurrence order with set
    boundaries at bounds [R+1]; returns int32 ranks [N] (iteration position
    within the owning set). None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    keys_u64 = np.ascontiguousarray(keys_u64, dtype=np.uint64)
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    ranks = np.empty(len(keys_u64), dtype=np.int32)
    lib.ct_fnv_ranks(
        keys_u64.ctypes.data, bounds.ctypes.data, len(bounds) - 1, width,
        ranks.ctypes.data,
    )
    return ranks


def fnv_ranks_bytes(keys: np.ndarray) -> np.ndarray | None:
    """FnvHashSet iteration ranks for one set of ASCII key rows [N, w] in
    first-occurrence order. None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    n, w = keys.shape
    ranks = np.empty(n, dtype=np.int32)
    lib.ct_fnv_ranks_bytes(keys.ctypes.data, n, w, ranks.ctypes.data)
    return ranks


class FastqReadStream:
    """C++ gz fastq streamer: decode + phred-mask + batch assembly in one
    pass. Yields (ids, seqs_concat, seq_offs, nseqs) batches."""

    def __init__(self, path1: str, path2: str | None, qual_offset: int,
                 batch: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native unavailable")
        self._lib = lib
        self._h = lib.rs_open(
            path1.encode(), (path2 or "").encode(), qual_offset
        )
        if not self._h:
            raise FileNotFoundError(path1 if path2 is None else f"{path1}/{path2}")
        self.batch = batch
        self.mates = 2 if path2 else 1
        self._seq_cap = batch * self.mates * 512
        self._id_cap = batch * 256

    def __iter__(self):
        b = self.batch
        while True:
            seq_buf = np.empty(self._seq_cap, dtype=np.uint8)
            seq_offs = np.zeros(b * self.mates + 1, dtype=np.int64)
            nseqs = np.empty(b, dtype=np.int32)
            id_buf = np.empty(self._id_cap, dtype=np.uint8)
            id_offs = np.zeros(b + 1, dtype=np.int64)
            n = self._lib.rs_next_batch(
                self._h, b,
                seq_buf.ctypes.data, self._seq_cap, seq_offs.ctypes.data,
                nseqs.ctypes.data,
                id_buf.ctypes.data, self._id_cap, id_offs.ctypes.data,
            )
            if n == -1:  # pathological read length: grow and retry
                self._seq_cap *= 4
                self._id_cap *= 4
                continue
            if n == 0:
                break
            total_seqs = int(nseqs[:n].sum())
            ids_raw = id_buf[: id_offs[n]].tobytes()
            ids = [
                ids_raw[id_offs[i] : id_offs[i + 1]].decode("utf-8", "replace")
                for i in range(n)
            ]
            yield ids, seq_buf, seq_offs[: total_seqs + 1], nseqs[:n]
            if n < b:
                break

    def close(self):
        if self._h:
            self._lib.rs_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_rank_windows(
    seqs_concat: np.ndarray,
    seq_offs: np.ndarray,
    read_seq_counts: np.ndarray,
    k: int,
    d: int,
    nw_stride: int,
    fnv_order: bool = True,
    pack_len: int | None = None,
):
    """Per-window set ranks [n_mates, nw_stride] int16 for the
    device-extraction read_id path (the device re-derives the k-mer windows
    from 2-bit packed mates; the host ships only this rank plane). -1 marks
    duplicate / skipped / padding windows. Returns (ranks, maplen [B]) or
    None when the native path can't handle the batch (lowercase, oversized
    sets, missing library). With pack_len=Lb the same pass also emits the
    2-bit packed mates (layout of ops/extract.py::pack_reads_any, rows
    padded to Lb bases) and the return gains a third element."""
    lib = _load()
    if lib is None or k > 32:
        return None
    seqs_concat = np.ascontiguousarray(seqs_concat, dtype=np.uint8)
    seq_offs = np.ascontiguousarray(seq_offs, dtype=np.int64)
    read_seq_counts = np.ascontiguousarray(read_seq_counts, dtype=np.int32)
    n_reads = len(read_seq_counts)
    n_mates = len(seq_offs) - 1
    ranks = np.full((max(n_mates, 1), nw_stride), -1, dtype=np.int16)
    maplen = np.zeros(max(n_reads, 1), dtype=np.int32)
    packed = None
    words = 0
    if pack_len is not None:
        words = (pack_len + 15) // 16
        packed = np.zeros((max(n_mates, 1), words), dtype=np.uint32)
    got = lib.ct_read_rank_windows(
        seqs_concat.ctypes.data, seq_offs.ctypes.data,
        read_seq_counts.ctypes.data, n_reads, k, d, nw_stride,
        1 if fnv_order else 0, ranks.ctypes.data, maplen.ctypes.data,
        packed.ctypes.data if packed is not None else None, words,
    )
    if got < 0:
        return None
    if packed is not None:
        return ranks[:n_mates], maplen[:n_reads], packed[:n_mates]
    return ranks[:n_mates], maplen[:n_reads]


def pack_valid_sel(
    buf: np.ndarray, starts: np.ndarray, lens: np.ndarray, pack_len: int
):
    """pack_valid over non-contiguous (start, len) slices of one buffer
    (the read_id raw-batch fast path). None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    M = starts.shape[0]
    words = np.zeros((M, pack_len // 16), dtype=np.uint32)
    valid = np.zeros((M, pack_len // 32), dtype=np.uint32)
    lib.ct_pack_valid_sel(
        buf.ctypes.data, starts.ctypes.data, lens.ctypes.data, M, pack_len,
        words.ctypes.data, valid.ctypes.data,
    )
    return words, valid
