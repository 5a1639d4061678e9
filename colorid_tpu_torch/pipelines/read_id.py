"""Per-read classification pipeline (reference: read_id_mt_pe.rs).

Semantics replicated:
- a read whose first mate is shorter than k is "too_short"/accept
  (read_id_mt_pe.rs:305-313); other mates are still k-merized when long
  enough (shorter ones are skipped — the reference would panic).
- per-read canonical k-mer SET iterated in the reference's FnvHashSet order
  (emulated — core/fnv.py documents the transcription; the C++ twin in
  native/ingest.cpp computes ranks inline during set building). Set order
  matters because of the break and the -B sample phase below.
  COLORID_FNV_ORDER=0 falls back to first-occurrence order.
- a k-mer with an absent Bloom row adds one `no_hits` pseudo-count and stops
  counting for the read's remaining k-mers (the `break` at
  read_id_mt_pe.rs:88-89/127-128/150-151).
- bitvector_sample B > 0: k-mers after the first B only count toward colors
  hit within the first B (search_index, read_id_mt_pe.rs:104-165).
- FP-aware majority poll (kmer_poll_plus, read_id_mt_pe.rs:187-251) with the
  binomial significance filter (not_fp_signicant, :168-181); tied top hits
  are joined in the reference's order (stable sort over FnvHashMap
  iteration order — reconstructed per tied read from the device's
  first-hit matrix, engine.readid_firsthit).

The per-read counting runs on device as one flattened segment-reduce batch
(ops/query.py::query_readid_batch); this layer only formats decisions.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Iterator

import numpy as np

from ..core.dna import to_bytes
from ..core.fastx import (
    stream_fasta_records,
    stream_fastq_pe_raw,
    stream_fastq_raw,
)
from ..core.kmers import kmer_set
from ..core.stats import false_prob, not_fp_significant_mask
from ..engine import QueryEngine
from .reports import read_counts_five_fields

Classification = tuple[str, str, int, int, str, int]


def fnv_order_enabled() -> bool:
    """Reference-parity FnvHashSet/FnvHashMap order emulation (default on;
    COLORID_FNV_ORDER=0 reverts to deterministic first-occurrence order)."""
    return os.environ.get("COLORID_FNV_ORDER", "1") != "0"


def _fnv_order_keys(keys: np.ndarray) -> np.ndarray:
    """Reorder a per-read unique k-mer array [n, w] (first-occurrence order)
    into FnvHashSet iteration order, so row index == iteration rank."""
    if keys.shape[0] <= 1:
        return keys
    from .. import native

    ranks = native.fnv_ranks_bytes(keys) if native.available() else None
    if ranks is None:
        from ..core.fnv import fnv1a64_batch, fnv_set_ranks

        ranks = fnv_set_ranks(fnv1a64_batch(keys))
    return keys[np.argsort(ranks)]


def _mask_batch(batch, qual_offset: int):
    """Vectorized phred masking over a whole batch: one numpy pass instead
    of per-read qual_mask calls (seq.rs:36-56 semantics: output length =
    qual length; sequence shorter than quality raises like the reference
    panics)."""
    if qual_offset == 0:
        return [(rid, list(seqs)) for rid, seqs, _quals in batch]
    cutoff = np.uint8(qual_offset + 33)
    parts_s: list[np.ndarray] = []
    parts_q: list[np.ndarray] = []
    lens: list[int] = []
    for _rid, seqs, quals in batch:
        for s, q in zip(seqs, quals):
            if len(s) < len(q):
                raise ValueError("sequence shorter than quality string")
            parts_s.append(s[: len(q)])
            parts_q.append(q)
            lens.append(len(q))
    if not parts_s:
        return [(rid, []) for rid, _s, _q in batch]
    big_s = np.concatenate(parts_s)
    big_q = np.concatenate(parts_q)
    masked = np.where(big_q < cutoff, np.uint8(ord("N")), big_s)
    views = np.split(masked, np.cumsum(lens)[:-1])
    out = []
    j = 0
    for rid, seqs, _quals in batch:
        out.append((rid, views[j : j + len(seqs)]))
        j += len(seqs)
    return out


_LOWER = np.zeros(256, dtype=bool)
for _c in b"acgt":
    _LOWER[_c] = True


def _split_lowercase(batch, todo_idx):
    """Indices whose reads contain lowercase acgt (the 2-bit fast path can't
    represent raw-byte canonical order for mixed case; such reads take the
    exact numpy path). Vectorized over the whole batch."""
    if isinstance(batch, _RawBatch) and not batch.any_lower():
        return todo_idx, []  # one pass over the raw buffer, no per-read work
    seqs = []
    counts = []
    for i in todo_idx:
        mates = batch[i][1]
        counts.append(len(mates))
        seqs.extend(mates)
    if not seqs:
        return todo_idx, []
    concat = np.concatenate(seqs)
    lower = _LOWER[concat]
    if not lower.any():
        return todo_idx, []
    offs = np.cumsum([len(s) for s in seqs])[:-1]
    per_seq = np.array(
        [seg.any() for seg in np.split(lower, offs)]
    )
    clean, dirty = [], []
    j = 0
    for i, nm in zip(todo_idx, counts):
        if per_seq[j : j + nm].any():
            dirty.append(i)
        else:
            clean.append(i)
        j += nm
    return clean, dirty


def _prepare_reads(batch, todo_idx, k, d, fnv):
    """Device-extraction fast path: 2-bit packed mates + the per-window set
    rank plane (native ct_read_rank_windows). The device re-derives every
    canonical k-mer window itself (ops/query.py::query_readid_reads_batch),
    so the host link carries ~2.3 bytes per window instead of 12 bytes per
    unique k-mer. Returns (mates_packed, mate_seg, lens, ranks, maplen, Lb)
    or None (lowercase / oversized / no native lib -> older paths)."""
    from .. import native

    if len(todo_idx) > 32768:  # int16 segment-id ceiling (max id = len-1)
        return None
    seqs = []
    nseqs = np.empty(len(todo_idx), dtype=np.int32)
    for j, i in enumerate(todo_idx):
        mates = batch[i][1]
        nseqs[j] = len(mates)
        seqs.extend(mates)
    M = len(seqs)
    if M == 0:
        return None
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    Lmax = int(lens.max())
    if Lmax < k or Lmax > 4096:
        return None
    Lb = max(64, -(-Lmax // 32) * 32)  # whole 32-base words, at least 64
    offs = np.zeros(M + 1, dtype=np.int64)
    offs[1:] = np.cumsum(lens)
    concat = np.concatenate(seqs)
    # one native pass emits both the rank plane and the 2-bit packed mates
    got = native.read_rank_windows(
        concat, offs, nseqs, k, d, Lb - k + 1, fnv_order=fnv, pack_len=Lb
    )
    if got is None:
        return None
    ranks, maplen, packed = got
    if maplen.size == 0 or int(maplen.max()) < 255:
        # uint8 rank plane (255 = none) halves the dominant H2D of the
        # reads path; per-read set sizes < 255 cover all short-read inputs
        ranks = np.where(ranks < 0, 255, ranks).astype(np.uint8)
    seg = np.repeat(
        np.arange(len(todo_idx), dtype=np.int16), nseqs
    )
    return packed, seg, lens.astype(np.int32), ranks, maplen, Lb


def _ranges(lens: np.ndarray) -> np.ndarray:
    """concat(arange(l) for l in lens), vectorized."""
    total = int(lens.sum())
    return np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens
    )


class _RawBatch:
    """The C++ fastq frontend's batch kept in its raw buffers: read ids
    plus ONE byte buffer with per-mate offsets. Quacks like the
    list-of-(id, [mate views]) batches everywhere (lazy __getitem__), but
    the hot classifier paths consume the buffers directly — per-read
    python work only happens for the reads that hit a fallback path."""

    __slots__ = ("ids", "buf", "offs", "nseqs", "_mate0")

    def __init__(self, ids, buf, offs, nseqs):
        self.ids = ids
        self.buf = buf
        self.offs = np.asarray(offs, dtype=np.int64)
        self.nseqs = np.asarray(nseqs, dtype=np.int64)
        m0 = np.zeros(len(ids) + 1, dtype=np.int64)
        np.cumsum(self.nseqs, out=m0[1:])
        self._mate0 = m0  # read i owns mates [m0[i], m0[i+1])

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        lo, hi = int(self._mate0[i]), int(self._mate0[i + 1])
        return (
            self.ids[i],
            [
                self.buf[self.offs[t] : self.offs[t + 1]]
                for t in range(lo, hi)
            ],
        )

    def __iter__(self):
        for i in range(len(self.ids)):
            yield self[i]

    def first_lens(self) -> np.ndarray:
        """Length of each read's first mate (0 for mate-less reads)."""
        f = np.minimum(self._mate0[:-1], self.offs.shape[0] - 2)
        return np.where(
            self.nseqs > 0, self.offs[f + 1] - self.offs[f], 0
        )

    def any_lower(self) -> bool:
        return bool(_LOWER[self.buf].any())

    def mates_sel(self, idx):
        """(starts, lens, nm) of the mates belonging to the given read
        indices; nm is the uniform mates-per-read or None if mixed."""
        idx = np.asarray(idx, dtype=np.int64)
        ns = self.nseqs[idx]
        nm = (
            int(ns[0]) if idx.size and (ns == ns[0]).all() else None
        )
        mates = np.repeat(self._mate0[idx], ns) + _ranges(ns)
        starts = self.offs[mates]
        return starts, self.offs[mates + 1] - starts, nm


def _read_id_of(batch, i):
    """Read id without materializing a _RawBatch row's mate views."""
    return batch.ids[i] if isinstance(batch, _RawBatch) else batch[i][0]


def _prepare_reads_orderfree(batch, todo_idx, k):
    """Host prep for the order-free classifier pass: pack mates to 2-bit
    words + a per-base validity plane, NO hashbrown rank replay (the device
    dedups each read's k-mer set itself). Returns (words, lens, valid_bits,
    nm, Lb) or None (non-uniform mate counts / oversized / empty), in which
    case the caller uses the exact-order machinery for the whole group."""
    from .. import native
    from ..ops.extract import pack_reads_valid

    if isinstance(batch, _RawBatch) and native.available():
        # raw fast path: pack straight from the frontend's byte buffer via
        # per-mate (start, len) slices — zero per-read python work
        starts, mlens, nm = batch.mates_sel(todo_idx)
        if nm is None or nm == 0 or mlens.size == 0:
            return None
        Lmax = int(mlens.max())
        if Lmax < k or Lmax > 4096:
            return None
        Lb = max(64, -(-Lmax // 32) * 32)
        got = native.pack_valid_sel(batch.buf, starts, mlens, Lb)
        if got is not None:
            return got[0], mlens.astype(np.int32), got[1], nm, Lb
    seqs = []
    nm = None
    for i in todo_idx:
        mates = batch[i][1]
        if nm is None:
            nm = len(mates)
        elif len(mates) != nm:
            return None
        seqs.extend(mates)
    if not seqs or nm == 0:
        return None
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    Lmax = int(lens.max())
    if Lmax < k or Lmax > 4096:
        return None
    Lb = max(64, -(-Lmax // 32) * 32)
    M = len(seqs)
    from .. import native

    if native.available():
        offs = np.zeros(M + 1, dtype=np.int64)
        offs[1:] = np.cumsum(lens)
        got = native.pack_valid(np.concatenate(seqs), offs, Lb)
        if got is not None:
            return got[0], lens.astype(np.int32), got[1], nm, Lb
    rect = np.full((M, Lb), ord("A"), dtype=np.uint8)
    flat = np.repeat(np.arange(M, dtype=np.int64) * Lb, lens) + _ranges(lens)
    rect.reshape(-1)[flat] = np.concatenate(seqs)
    words, vbits = pack_reads_valid(rect)
    return words, lens.astype(np.int32), vbits, nm, Lb


def _resolve_orderfree(
    batch, group, engine, rep0, p_false, fp_correct, start_sample, d, fnv,
    defer=False,
):
    """Exact report rows from the order-free pass: keep full counts for
    reads whose outcome provably cannot depend on FnvHashSet order; replay
    the exact hashbrown-order path for the rest. Returns (report [n, C+1],
    maplen [n], pending): with defer=True and a native replay available,
    the replay only DISPATCHES and pending = (unsafe_positions, fetch_fn,
    maplen_u) — the caller overlaps the device round trip with its
    decision math and patches the rows afterwards; otherwise pending is
    None and the rows are final.

    Order only enters through the break at the first absent k-mer and the
    first-B candidate set (colors hit within the first B distinct k-mers
    get their FULL count; others never enter the report map). With no
    absent k-mer, the poll outcome is a function of the significant
    colors' counts at the top tier and of report emptiness, so full counts
    are exact under EVERY order when:
    - every significant color with count == top_count has count
      > D - B (pigeonhole: any B of the D k-mers then contains one of its
      hits, so the whole top tier is in every possible candidate set;
      colors below the top tier cannot change name/support/n_top whether
      present or absent), and
    - fewer than B distinct k-mers are zero-hit-but-present (otherwise
      the first B k-mers could ALL be zero-hit, making the candidate set
      and hence the report empty -> "no_hits" instead of the full-count
      outcome).
    Reads with B == 0 only need the no-absent condition (no candidate
    phase exists). Tied-top reads keep their (exact) counts here; the
    existing tie fixup reconstructs the reference's name order."""
    C = engine.index.n_colors
    k = engine.index.k_size
    n = len(group)
    counts = rep0[:, :C].astype(np.int64)
    absent = rep0[:, C] > 0
    Dn = rep0[:, C + 1].astype(np.int64)
    zerohit = rep0[:, C + 2].astype(np.int64)
    unsafe = absent.copy()
    if start_sample > 0:
        nz_r, nz_c = np.nonzero(counts > 0)
        sig = np.zeros(counts.shape, dtype=bool)
        if nz_r.size:
            sig[nz_r, nz_c] = ~not_fp_significant_mask(
                Dn[nz_r], p_false[nz_c], counts[nz_r, nz_c], fp_correct
            )
        top_count = np.where(sig, counts, -1).max(
            axis=1, initial=-1
        )
        unsafe |= (top_count >= 0) & (top_count <= Dn - start_sample)
        unsafe |= (zerohit >= start_sample) & (
            counts.max(axis=1, initial=0) > 0
        )
    rep = np.zeros((n, C + 1), dtype=np.int32)
    rep[:, :C] = rep0[:, :C]
    ml = Dn.copy()
    if unsafe.any():
        uj = np.nonzero(unsafe)[0]
        sub = [group[j] for j in uj]
        pr = _prepare_reads(batch, sub, k, d, fnv)
        if pr is not None:
            mates, mseg, mlens, ranks, maplen, Lb = pr
            fetch = engine.readid_counts_reads_async(
                mates, mseg, mlens, ranks, len(sub), start_sample, k, Lb
            )
            if defer:
                return rep, ml, (uj, fetch, np.asarray(maplen))
            rep_u = fetch()
            ml_u = np.asarray(maplen)
        else:
            keys_list = [
                kmer_set(batch[i][1], k, d=d, minimizer=0) for i in sub
            ]
            if fnv:
                keys_list = [_fnv_order_keys(ks) for ks in keys_list]
            ml_u = np.array([ks.shape[0] for ks in keys_list])
            rep_u = engine.readid_counts(keys_list, start_sample)
        rep[uj] = rep_u
        ml[uj] = ml_u
    return rep, ml, None


def _prepare_native(batch, todo_idx, index, d, packed_ok):
    """Flattened per-read k-mer arrays via the C++ fast path.

    Returns ("packed", packed, seg16, pos16, maplen) when the device-hash
    path applies, ("rows", rows, seg, pos, maplen) otherwise, or None for
    the exact numpy fallback. Callers pass only lowercase-free reads."""
    from .. import native

    if not native.available():
        return None
    k, m = index.k_size, index.m_size
    if k > 32 or (m and m > 32):
        return None
    if index.bloom_size > 2**32:
        return None  # native row hasher emits uint32 rows; numpy path
    seqs = []
    nseqs = np.empty(len(todo_idx), dtype=np.int32)
    for j, i in enumerate(todo_idx):
        mates = batch[i][1]
        nseqs[j] = len(mates)
        seqs.extend(mates)
    offs = np.zeros(len(seqs) + 1, dtype=np.int64)
    offs[1:] = np.cumsum([len(s) for s in seqs])
    concat = (
        np.concatenate(seqs) if seqs else np.zeros(0, dtype=np.uint8)
    )
    width = m or k
    fnv = fnv_order_enabled()
    if packed_ok and 4 <= width <= 32 and len(todo_idx) <= 32768:
        got = native.read_sets_packed(concat, offs, nseqs, k, d, m, fnv_order=fnv)
        if got is not None:
            return ("packed",) + got
    if index.blocked:
        # the C++ rows fallback computes independent-row placement; blocked
        # indexes must go through the packed (device-hash) or python path
        return None
    got = native.read_sets(
        concat, offs, nseqs, k, d, m, index.num_hash, index.bloom_size,
        fnv_order=fnv,
    )
    return None if got is None else ("rows",) + got


def classify_batch(
    batch: list[tuple[str, list[np.ndarray]]],
    engine: QueryEngine,
    d: int,
    fp_correct: float,
    start_sample: int,
    threads: int = 1,
) -> list[Classification]:
    """Classify one batch of reads; returns 6-field rows for _reads.txt."""
    index = engine.index
    C = index.n_colors
    k = index.k_size
    m = index.m_size
    colors = index.colors
    p_false = np.array(
        [
            false_prob(
                float(index.bloom_size),
                float(index.num_hash),
                float(index.n_ref_kmers.get(colors[c], 0)),
            )
            for c in range(C)
        ]
    )
    out: list[Classification] = [None] * len(batch)  # type: ignore
    todo_idx: list[int] = []
    if isinstance(batch, _RawBatch):
        fl = batch.first_lens()
        ids = batch.ids
        for i in range(len(batch)):
            if fl[i] < k:
                out[i] = (ids[i], "too_short", 0, 0, "accept", 0)
            else:
                todo_idx.append(i)
    else:
        for i, (rid, seqs) in enumerate(batch):
            if len(seqs[0]) < k:
                out[i] = (rid, "too_short", 0, 0, "accept", 0)
                continue
            todo_idx.append(i)
    if not todo_idx:
        return out
    packed_ok = index.bloom_size < 2**31 and not getattr(
        index, "place_rpb", 0
    )  # shard-placed indexes: device hashing lives on the sharded engine
    # reads containing lowercase bases need the exact byte-order path;
    # everything else flows through the C++ fast path
    clean_idx, dirty_idx = _split_lowercase(batch, todo_idx)
    report_rows: dict[int, np.ndarray] = {}
    maplen_map: dict[int, int] = {}
    fnv = fnv_order_enabled()
    if dirty_idx:
        keys_list = [
            kmer_set(batch[i][1], k, d=d, minimizer=m) for i in dirty_idx
        ]
        if fnv:
            keys_list = [_fnv_order_keys(ks) for ks in keys_list]
        rep_d = engine.readid_counts(keys_list, start_sample)
        for j, i in enumerate(dirty_idx):
            report_rows[i] = rep_d[j]
            maplen_map[i] = keys_list[j].shape[0]
    # slice the batch so int16 segment ids suffice for the packed path
    report_parts = []
    maplen_parts = []
    GROUP = 32768  # int16 segment ids span 0..32767
    reads_path = (
        packed_ok
        and m == 0
        and 4 <= k <= 32
        and hasattr(engine, "readid_counts_reads")
        and os.environ.get("COLORID_RID_READS", "1") != "0"
    )
    # order-free fast path: skip the host hashbrown replay for reads whose
    # outcome provably cannot depend on set order (_resolve_orderfree)
    safe_path = (
        reads_path and os.environ.get("COLORID_RID_SAFE", "1") != "0"
    )
    groups = [
        clean_idx[g0 : g0 + GROUP]
        for g0 in range(0, len(clean_idx), GROUP)
    ]
    group_preps: list = []  # per-group prepared tuples, kept for tie fixup
    deferred: list = []  # (group, (unsafe_positions, fetch, maplen_u))
    pr_iter = None
    if reads_path and not safe_path and threads > 1 and len(groups) > 1:
        # prefetch group preparation (the C++ rank emulation releases the
        # GIL) so it overlaps the previous group's device round trip — the
        # reference's rayon pool (-t) mapped onto the prepare stage
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=min(threads, len(groups)))
        futs = [
            pool.submit(_prepare_reads, batch, g, k, d, fnv) for g in groups
        ]
        pr_iter = iter(futs)
    try:
        for group in groups:
            if safe_path:
                pr0 = _prepare_reads_orderfree(batch, group, k)
                if pr0 is not None:
                    words, mlens, vbits, nm, Lb = pr0
                    rep0 = engine.readid_counts_orderfree(
                        words, mlens, vbits, len(group), nm, k, Lb, d
                    )
                    rep, ml, pend = _resolve_orderfree(
                        batch, group, engine, rep0, p_false, fp_correct,
                        start_sample, d, fnv, defer=True,
                    )
                    if pend is not None:
                        # exact replay of the unsafe reads is IN FLIGHT;
                        # the decision math below overlaps it and the
                        # rows patch afterwards
                        deferred.append((len(report_parts), pend))
                    group_preps.append(None)
                    report_parts.append(rep)
                    maplen_parts.append(ml)
                    continue
            if reads_path:
                pr = (
                    next(pr_iter).result()
                    if pr_iter is not None
                    else _prepare_reads(batch, group, k, d, fnv)
                )
                if pr is not None:
                    mates, mseg, mlens, ranks, maplen, Lb = pr
                    rep = engine.readid_counts_reads(
                        mates, mseg, mlens, ranks, len(group), start_sample,
                        k, Lb,
                    )
                    group_preps.append(pr)
                    report_parts.append(rep)
                    maplen_parts.append(np.asarray(maplen))
                    continue
            group_preps.append(None)
            prepared = _prepare_native(batch, group, index, d, packed_ok)
            if prepared is not None and prepared[0] == "packed":
                _, packed, seg, pos, maplen = prepared
                rep = engine.readid_counts_packed(
                    packed, seg, pos, len(group), start_sample, m or k
                )
            elif prepared is not None:
                _, rows, seg, pos, maplen = prepared
                rep = engine.readid_counts_arrays(
                    rows, seg, pos, len(group), start_sample
                )
            else:
                keys_list = [
                    kmer_set(batch[i][1], k, d=d, minimizer=m) for i in group
                ]
                if fnv:
                    keys_list = [_fnv_order_keys(ks) for ks in keys_list]
                maplen = [keys.shape[0] for keys in keys_list]
                rep = engine.readid_counts(keys_list, start_sample)
            report_parts.append(rep)
            maplen_parts.append(np.asarray(maplen))
    finally:
        if pr_iter is not None:
            pool.shutdown(wait=False)
    for g, (rep, ml) in enumerate(zip(report_parts, maplen_parts)):
        for j, i in enumerate(clean_idx[g * GROUP : g * GROUP + rep.shape[0]]):
            report_rows[i] = rep[j]
            maplen_map[i] = int(ml[j])
    report = np.stack([report_rows[i] for i in todo_idx], axis=0)
    map_lens = np.array([maplen_map[i] for i in todo_idx])
    real = report[:, :C].astype(np.int64)
    noh = report[:, C].astype(np.int64)
    mlen = np.asarray(map_lens, dtype=np.int64)

    empty = (real.sum(axis=1) + noh) == 0  # report.is_empty()
    only_no_hits = (noh > 0) & (real.max(axis=1, initial=0) == 0)
    # the binomial test only matters where hits > 0 (zero-hit colors are
    # never significant) — ~10% of the matrix at typical panel sizes
    nz_r, nz_c = np.nonzero(real > 0)
    sig = np.zeros(real.shape, dtype=bool)
    if nz_r.size:
        sig[nz_r, nz_c] = ~not_fp_significant_mask(
            mlen[nz_r], p_false[nz_c], real[nz_r, nz_c], fp_correct
        )
    any_sig = sig.any(axis=1)
    top_count = np.where(sig, real, -1).max(axis=1)
    is_top = sig & (real == top_count[:, None])
    n_top = is_top.sum(axis=1)

    # row assembly: categories and the single-top index vectorize; only the
    # (rare) tied rows still touch numpy per read
    tie_js: list[int] = []
    cat = np.where(
        empty | only_no_hits, 0,
        np.where(~any_sig, 1, np.where(n_top == 1, 2, 3)),
    )
    cat_l = cat.tolist()
    ml_l = mlen.tolist()
    tc_l = top_count.tolist()
    ti_l = np.argmax(is_top, axis=1).tolist()
    for j, i in enumerate(todo_idx):
        rid = _read_id_of(batch, i)
        c = cat_l[j]
        if c == 2:
            out[i] = (rid, colors[ti_l[j]], tc_l[j], ml_l[j], "accept", 1)
        elif c == 0:
            out[i] = (rid, "no_hits", 0, ml_l[j], "accept", 0)
        elif c == 1:
            out[i] = (rid, "no_significant_hits", 0, ml_l[j], "reject", 0)
        else:
            tops = np.nonzero(is_top[j])[0]
            name = ",".join(colors[int(cc)] for cc in tops)
            out[i] = (rid, name, tc_l[j], ml_l[j], "reject", len(tops))
            tie_js.append(j)
    fh_job = None
    late_ties: list[int] = []
    if deferred:
        # the exact replays dispatched in _resolve_orderfree overlapped the
        # math and assembly above (which used order-free placeholders for
        # the unsafe rows). Dispatch the tie-fixup first-hit kernel for the
        # SAFE ties now too (their counts are final), so both round trips
        # fly while the rows patch below runs; then fetch, patch, and redo
        # just the unsafe rows.
        pos_of = {i: j for j, i in enumerate(todo_idx)}
        unsafe_jj = {
            pos_of[clean_idx[g * GROUP + int(jl)]]
            for g, (uj, _f, _m) in deferred
            for jl in uj
        }
        tie_js = [j for j in tie_js if j not in unsafe_jj]
        if tie_js and fnv:
            fh_job = _tie_fh_start(
                batch, todo_idx, tie_js, engine, d, start_sample,
                group_preps=group_preps, clean_idx=clean_idx,
                group_size=GROUP,
            )
        patched: list[int] = []
        for g, (uj, fetch, ml_u) in deferred:
            rep_u = fetch()
            for t, jl in enumerate(uj):
                i = clean_idx[g * GROUP + int(jl)]
                jj = pos_of[i]
                report_rows[i] = rep_u[t]
                real[jj] = rep_u[t][:C]
                noh[jj] = rep_u[t][C]
                mlen[jj] = int(ml_u[t])
                maplen_map[i] = int(ml_u[t])
                patched.append(jj)
        pj = np.asarray(patched, dtype=np.int64)
        sig[pj] = False
        nz_r2, nz_c2 = np.nonzero(real[pj] > 0)
        if nz_r2.size:
            sig[pj[nz_r2], nz_c2] = ~not_fp_significant_mask(
                mlen[pj[nz_r2]], p_false[nz_c2],
                real[pj[nz_r2], nz_c2], fp_correct,
            )
        top_count[pj] = np.where(sig[pj], real[pj], -1).max(
            axis=1, initial=-1
        )
        is_top[pj] = sig[pj] & (real[pj] == top_count[pj][:, None])
        n_top[pj] = is_top[pj].sum(axis=1)
        any_sig[pj] = sig[pj].any(axis=1)
        for jj in patched:
            i = todo_idx[jj]
            rid = _read_id_of(batch, i)
            L = int(mlen[jj])
            if (real[jj].sum() + noh[jj]) == 0 or (
                noh[jj] > 0 and real[jj].max(initial=0) == 0
            ):
                out[i] = (rid, "no_hits", 0, L, "accept", 0)
            elif not any_sig[jj]:
                out[i] = (rid, "no_significant_hits", 0, L, "reject", 0)
            elif n_top[jj] == 1:
                c = int(np.argmax(is_top[jj]))
                out[i] = (rid, colors[c], int(top_count[jj]), L, "accept", 1)
            else:
                tops = np.nonzero(is_top[jj])[0]
                name = ",".join(colors[int(cc)] for cc in tops)
                out[i] = (
                    rid, name, int(top_count[jj]), L, "reject", len(tops)
                )
                late_ties.append(jj)
    if tie_js and fnv:
        _fix_tie_order(
            batch, todo_idx, tie_js, engine, d, start_sample,
            real, noh, sig, top_count, mlen, out,
            group_preps=group_preps, clean_idx=clean_idx, group_size=GROUP,
            fh_job=fh_job,
        )
    if late_ties and fnv:
        # ties discovered among the replayed (unsafe) rows — rare
        _fix_tie_order(
            batch, todo_idx, late_ties, engine, d, start_sample,
            real, noh, sig, top_count, mlen, out,
            group_preps=group_preps, clean_idx=clean_idx, group_size=GROUP,
        )
    return out


def _gather_tie_prep(tie_batch_idx, group_preps, clean_idx, group_size):
    """Reuse classify_batch's per-group prepared arrays for the tied reads:
    select their mate rows instead of re-running the native prepare pass.
    Returns the same tuple shape as _prepare_reads, or None when any tied
    read wasn't on the prepared reads path (dirty read / fallback group) or
    the groups' padded lengths differ."""
    if not group_preps or len(tie_batch_idx) > 32768:  # int16 seg ceiling
        return None
    loc = {}  # batch index -> (group, local read position)
    for g in range(len(group_preps)):
        for p, i in enumerate(clean_idx[g * group_size : (g + 1) * group_size]):
            loc[i] = (g, p)
    rows_m, rows_r, rows_l, n_mates = [], [], [], []
    Lb = None
    for i in tie_batch_idx:
        gp = loc.get(i)
        if gp is None or group_preps[gp[0]] is None:
            return None
        mates, mseg, mlens, ranks, _maplen, gLb = group_preps[gp[0]]
        if Lb is None:
            Lb = gLb
        elif gLb != Lb:
            return None
        s = int(np.searchsorted(mseg, gp[1]))
        e = int(np.searchsorted(mseg, gp[1] + 1))
        rows_m.append(mates[s:e])
        rows_r.append(ranks[s:e])
        rows_l.append(mlens[s:e])
        n_mates.append(e - s)
    seg = np.repeat(
        np.arange(len(tie_batch_idx), dtype=np.int16),
        np.asarray(n_mates, dtype=np.int64),
    )
    # rank-plane dtype is chosen PER GROUP (uint8 with 255 = no-rank when
    # the group's map length allows, else int16 with -1); a raw concatenate
    # over mixed groups would promote uint8 255 markers into live rank-255
    # entries, so re-encode uint8 groups to the int16 marker first
    if len({r.dtype for r in rows_r}) > 1:
        rows_r = [
            np.where(r == 255, np.int16(-1), r.astype(np.int16))
            if r.dtype == np.uint8 else r.astype(np.int16)
            for r in rows_r
        ]
    return (
        np.concatenate(rows_m), seg, np.concatenate(rows_l),
        np.concatenate(rows_r), None, Lb,
    )


def _tie_fh_start(
    batch, todo_idx, tie_js, engine, d, start_sample,
    group_preps=None, clean_idx=None, group_size=0,
):
    """Prep + DISPATCH the first-hit kernel for the tied reads; returns a
    zero-arg fetch() -> fh matrix, or None when only the host-keys
    fallback applies (_fix_tie_order then computes fh inline). Splitting
    dispatch from fetch lets classify_batch overlap the round trip with
    the deferred-replay patch."""
    index = engine.index
    k, m = index.k_size, index.m_size
    if not (
        m == 0
        and 4 <= k <= 32
        and index.bloom_size < 2**31
        and not getattr(engine, "_custom_place", False)
        and hasattr(engine, "readid_firsthit_reads_async")
        and os.environ.get("COLORID_RID_READS", "1") != "0"
    ):
        return None
    # reuse the device-extraction machinery for just the tied reads —
    # no host k-mer work; the prepared group arrays are recycled when
    # available, else the native prepare pass re-runs on the subset
    tie_batch_idx = [todo_idx[j] for j in tie_js]
    pr = None
    if group_preps is not None:
        pr = _gather_tie_prep(
            tie_batch_idx, group_preps, clean_idx, group_size
        )
    if pr is None:
        pr = _prepare_reads(batch, tie_batch_idx, k, d, fnv_order_enabled())
    if pr is None:
        return None
    mates, mseg, mlens, ranks, _maplen, Lb = pr
    return engine.readid_firsthit_reads_async(
        mates, mseg, mlens, ranks, len(tie_js), start_sample, k, Lb
    )


def _fix_tie_order(
    batch, todo_idx, tie_js, engine, d, start_sample,
    real, noh, sig, top_count, mlen, out,
    group_preps=None, clean_idx=None, group_size=0, fh_job=None,
) -> None:
    """Rewrite tied-top reject rows so the comma-joined names follow the
    reference's order: kmer_poll_plus stable-sorts the report FnvHashMap's
    iteration order by count (read_id_mt_pe.rs:195-196), so ties keep map
    order. The map's insertion order is recovered from the device first-hit
    matrix; its iteration order via the hashbrown emulation (core/fnv.py).
    fh_job, when given, is an in-flight _tie_fh_start dispatch for exactly
    these tie_js."""
    from ..core.fnv import fnv_map_order_usize

    index = engine.index
    C = index.n_colors
    k, m = index.k_size, index.m_size
    colors = index.colors
    BIG = 2**30
    if fh_job is None:
        fh_job = _tie_fh_start(
            batch, todo_idx, tie_js, engine, d, start_sample,
            group_preps=group_preps, clean_idx=clean_idx,
            group_size=group_size,
        )
    fh = fh_job() if fh_job is not None else None
    if fh is None:
        keys_list = []
        for j in tie_js:
            keys = kmer_set(batch[todo_idx[j]][1], k, d=d, minimizer=m)
            keys_list.append(_fnv_order_keys(keys))
        fh = engine.readid_firsthit(keys_list, start_sample)
    for t, j in enumerate(tie_js):
        i = todo_idx[j]
        row_fh = fh[t]
        present = [c for c in range(C) if row_fh[c] < BIG]
        # insertion order: first phase-1 hit, ascending color within one
        # k-mer; no_hits (key value C) enters at the break, hence last
        ins = sorted(present, key=lambda c: (int(row_fh[c]), c))
        if row_fh[C] < BIG:
            ins.append(C)
        iter_keys = fnv_map_order_usize(ins)
        items = [
            (ky, int(real[j][ky]) if ky < C else int(noh[j]))
            for ky in iter_keys
        ]
        items.sort(key=lambda kv: -kv[1])  # stable: ties keep map order
        tops_in_order = [
            ky for ky, cnt in items
            if ky < C and sig[j][ky] and cnt == int(top_count[j])
        ]
        name = ",".join(colors[c] for c in tops_in_order)
        out[i] = (
            _read_id_of(batch, i), name, int(top_count[j]), int(mlen[j]),
            "reject", len(tops_in_order),
        )


def _run_stream(
    reads: Iterator,
    engine: QueryEngine,
    d: int,
    fp_correct: float,
    start_sample: int,
    b: int,
    prefix: str,
    what: str,
    qual_offset: int | None = None,
    threads: int = 1,
) -> int:
    t0 = time.time()
    read_count = 0
    batch: list = []
    with open(f"{prefix}_reads.txt", "w") as f:

        def flush() -> None:
            nonlocal read_count
            masked = (
                _mask_batch(batch, qual_offset)
                if qual_offset is not None
                else batch
            )
            c = classify_batch(
                masked, engine, d, fp_correct, start_sample, threads=threads
            )
            read_count += len(c)
            print(f"{read_count} {what} classified\r", end="", file=sys.stderr)
            for row in c:
                f.write("\t".join(str(x) for x in row) + "\n")
            batch.clear()

        for item in reads:
            batch.append(item)
            if len(batch) >= b:
                flush()
        flush()
    print(
        f"Classified {read_count} {what} in {int(time.time() - t0)} seconds",
        file=sys.stderr,
    )
    return read_count


def _run_stream_native(
    path1: str,
    path2: str | None,
    engine: QueryEngine,
    d: int,
    fp_correct: float,
    start_sample: int,
    b: int,
    prefix: str,
    what: str,
    qual_offset: int,
    threads: int = 1,
) -> int:
    """Streaming loop over the C++ fastq frontend (decode + mask + batch
    assembly off the Python heap)."""
    import queue as _queue

    from .. import native

    stream = native.FastqReadStream(path1, path2, qual_offset, b)
    t0 = time.time()
    read_count = 0

    # producer thread: gzip decode (C++, GIL released) + batch assembly run
    # ahead of the device round trips of the batch being classified — the
    # cross-batch half of the reference's rayon overlap (read_id_mt_pe.rs
    # streams while the pool classifies)
    q: _queue.Queue = _queue.Queue(maxsize=2)

    def _produce() -> None:
        try:
            for ids, seq_buf, seq_offs, nseqs in stream:
                # raw pass-through: classify_batch consumes the frontend's
                # buffers directly (_RawBatch); per-read tuple building
                # happens lazily only on fallback paths
                q.put(_RawBatch(list(ids), seq_buf, seq_offs, nseqs))
            q.put(None)
        except BaseException as e:  # surface decode errors in the consumer
            q.put(e)

    prod = threading.Thread(target=_produce, daemon=True)
    prod.start()
    with open(f"{prefix}_reads.txt", "w") as f:
        while True:
            batch = q.get()
            if batch is None:
                break
            if isinstance(batch, BaseException):
                raise batch
            c = classify_batch(
                batch, engine, d, fp_correct, start_sample, threads=threads
            )
            read_count += len(c)
            print(f"{read_count} {what} classified\r", end="", file=sys.stderr)
            for row in c:
                f.write("\t".join(str(x) for x in row) + "\n")
    print(
        f"Classified {read_count} {what} in {int(time.time() - t0)} seconds",
        file=sys.stderr,
    )
    return read_count


def per_read_stream_pe(
    files: list[str],
    engine: QueryEngine,
    d: int,
    fp_correct: float,
    b: int,
    prefix: str,
    qual_offset: int,
    start_sample: int,
    threads: int = 1,
) -> int:
    from .. import native

    if native.available():
        return _run_stream_native(
            files[0], files[1], engine, d, fp_correct, start_sample, b,
            prefix, "read pairs", qual_offset, threads=threads,
        )
    reads = (
        (rid, [s1, s2], [q1, q2])
        for rid, s1, q1, s2, q2 in stream_fastq_pe_raw(files[0], files[1])
    )
    return _run_stream(
        reads, engine, d, fp_correct, start_sample, b, prefix, "read pairs",
        qual_offset=qual_offset, threads=threads,
    )


def per_read_stream_se(
    files: list[str],
    engine: QueryEngine,
    d: int,
    fp_correct: float,
    b: int,
    prefix: str,
    qual_offset: int,
    start_sample: int,
    threads: int = 1,
) -> int:
    from .. import native

    if native.available():
        return _run_stream_native(
            files[0], None, engine, d, fp_correct, start_sample, b, prefix,
            "reads", qual_offset, threads=threads,
        )
    reads = (
        (rid, [s], [q]) for rid, s, q in stream_fastq_raw(files[0])
    )
    return _run_stream(
        reads, engine, d, fp_correct, start_sample, b, prefix, "reads",
        qual_offset=qual_offset, threads=threads,
    )


def stream_fasta(
    files: list[str],
    engine: QueryEngine,
    d: int,
    fp_correct: float,
    b: int,
    prefix: str,
    start_sample: int,
) -> int:
    """read_id on fasta input; sequences keep embedded newlines (reference
    quirk — k-mers never span fasta lines on this path)."""
    reads = (
        (rid, [to_bytes(seq)]) for rid, seq in stream_fasta_records(files[0])
    )
    return _run_stream(
        reads, engine, d, fp_correct, start_sample, b, prefix, "reads"
    )


def read_id(
    files: list[str],
    engine: QueryEngine,
    prefix: str,
    d: int = 1,
    fp_correct: float = 1e-3,
    b: int = 50000,
    qual_offset: int = 15,
    start_sample: int = 3,
    threads: int = 0,
) -> None:
    """Full read_id subcommand: classify + counts report (main.rs:704-868).
    threads: the reference's -t rayon pool size (0 = all cores), mapped onto
    the host prepare stage so it overlaps device round trips."""
    if threads <= 0:
        threads = os.cpu_count() or 1
    if files[0].endswith(".gz"):
        if len(files) > 1:
            per_read_stream_pe(
                files, engine, d, fp_correct, b, prefix, qual_offset,
                start_sample, threads=threads,
            )
        else:
            per_read_stream_se(
                files, engine, d, fp_correct, b, prefix, qual_offset,
                start_sample, threads=threads,
            )
    else:
        stream_fasta(files, engine, d, fp_correct, b, prefix, start_sample)
    read_counts_five_fields(f"{prefix}_reads.txt", prefix)
