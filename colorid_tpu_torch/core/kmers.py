"""Vectorized canonical k-merization and minimizers.

The reference slides a window of k over each sequence and its reverse
complement and keeps the lexicographically smaller of the two windows,
comparing the *raw* (possibly mixed-case) bytes and optionally uppercasing
the winner afterwards (kmer.rs:87-299). Minimizers take the lexicographic
minimum m-mer across the canonical window and its reverse complement, with
the quirk that the reverse-complement m-mer at window offset k-m (i.e. i=0)
is never examined because the loop starts at i=1 after initializing with the
forward prefix (kmer.rs:971-986).

Everything here is numpy over uint8 arrays; strings only exist at the
boundaries. These routines are the host-side feeder for the device query
kernels and are also the oracle the device pipelines are tested against.

Case matrix replicated from the reference (uppercase applied AFTER the
canonical comparison):
- fasta build/search path (`kmerize_vector`): skip_n=True, uppercase=True
- fastq paths (`kmers_from_fq_qual`, `kmers_fq_pe_qual`): skip_n=True,
  uppercase=False
- read_id per-read sets (`kmerize_vector_skip_n_set`): skip_n=True,
  uppercase=False
- perfect-search multifasta (`kmerize_string`): skip_n=False, uppercase=True
- minimizer read_id (`minimerize_vector_skip_n_set`): minimizer uppercased
- minimizer fastq counting (`kmers_fq_pe_minimizer_qual`): minimizer raw
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from .dna import COMP, GOOD, UPPER


def canonical_windows(
    seq: np.ndarray,
    k: int,
    d: int = 1,
    skip_n: bool = True,
    uppercase: bool = False,
) -> np.ndarray:
    """All canonical k-mer windows of one sequence, in positional order.

    Args:
      seq: uint8 [L] sequence bytes.
      k: k-mer length.
      d: downsample stride over window start positions (kmer.rs step_by(d)).
      skip_n: drop windows containing non-acgtACGT bytes (seq.rs:66-70).
      uppercase: uppercase the canonical winner (fasta-path semantics).

    Returns:
      uint8 [n, k] canonical windows (positional order, duplicates included).
    """
    L = len(seq)
    if L < k:
        return np.empty((0, k), dtype=np.uint8)
    rc = COMP[seq[::-1]]
    fwd = sliding_window_view(seq, k)[::d]
    # rc window for forward offset i is rc[L-(i+k) : L-i]
    rcw = sliding_window_view(rc, k)[::-1][::d]
    if skip_n:
        bad = (~GOOD[seq]).astype(np.int32)
        cs = np.concatenate([[0], np.cumsum(bad)])
        nbad = cs[k:] - cs[: L - k + 1]  # per window start
        keep = nbad[::d] == 0
        if not keep.all():
            fwd = fwd[keep]
            rcw = rcw[keep]
    if fwd.shape[0] == 0:
        return np.empty((0, k), dtype=np.uint8)
    diff = fwd != rcw
    first = diff.argmax(axis=1)
    rows = np.arange(fwd.shape[0])
    anyd = diff.any(axis=1)
    fwd_lt = np.where(anyd, fwd[rows, first] < rcw[rows, first], False)
    out = np.where(fwd_lt[:, None], fwd, rcw)
    if uppercase:
        out = UPPER[out]
    return out


def _pack_be_u64(rows: np.ndarray) -> np.ndarray:
    """Pack uint8 [n, m] rows into big-endian u64 words [n, W] preserving
    lexicographic order (equal-length keys, zero-padded at the end)."""
    n, m = rows.shape
    W = (m + 7) // 8
    padded = np.zeros((n, W * 8), dtype=np.uint8)
    padded[:, :m] = rows
    return padded.view(">u8").astype(np.uint64)


def _lex_less(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise lexicographic a < b over packed word rows [n, W]."""
    n, W = a.shape
    less = np.zeros(n, dtype=bool)
    decided = np.zeros(n, dtype=bool)
    for w in range(W):
        lt = ~decided & (a[:, w] < b[:, w])
        gt = ~decided & (a[:, w] > b[:, w])
        less |= lt
        decided |= lt | gt
    return less


def minimizers_of_windows(windows: np.ndarray, m: int) -> np.ndarray:
    """find_minimizer (kmer.rs:971-986) vectorized over canonical windows.

    Candidates: forward m-mers at offsets 0..k-m, reverse-complement m-mers
    at offsets 0..k-m-1 (the rc m-mer at offset k-m is skipped — reference
    loop starts at i=1).
    """
    n, k = windows.shape
    if m > k:
        raise ValueError(f"minimizer size {m} > k {k}")
    rc = COMP[windows[:, ::-1]]
    best_bytes = windows[:, :m].copy()
    best_words = _pack_be_u64(best_bytes)
    # forward offsets i=1..k-m ; rc windows r[k-(i+m):k-i] for i=1..k-m
    for i in range(1, k - m + 1):
        for cand in (windows[:, i : i + m], rc[:, k - i - m : k - i]):
            cw = _pack_be_u64(cand)
            lt = _lex_less(cw, best_words)
            if lt.any():
                best_words[lt] = cw[lt]
                best_bytes[lt] = cand[lt]
    return best_bytes


def unique_rows(
    rows: np.ndarray, order: str = "sorted"
) -> tuple[np.ndarray, np.ndarray]:
    """Deduplicate byte rows.

    Args:
      rows: uint8 [n, k].
      order: "sorted" (lexicographic, order-independent accumulation paths)
        or "first" (first-occurrence order, used where the reference's
        set-iteration order-dependent quirks need a deterministic stand-in).

    Returns:
      (uniq [U, k], counts [U]).
    """
    n, k = rows.shape
    if n == 0:
        return rows.reshape(0, k), np.zeros(0, dtype=np.int64)
    v = np.ascontiguousarray(rows).view(np.dtype((np.void, k))).ravel()
    if order == "sorted":
        u, counts = np.unique(v, return_counts=True)
        uniq = u.view(np.uint8).reshape(-1, k)
        return uniq, counts
    u, idx, counts = np.unique(v, return_index=True, return_counts=True)
    o = np.argsort(idx, kind="stable")
    uniq = u[o].view(np.uint8).reshape(-1, k)
    return uniq, counts[o]


def count_kmers(
    seqs: Iterable[np.ndarray],
    k: int,
    d: int = 1,
    skip_n: bool = True,
    uppercase: bool = False,
    minimizer: int = 0,
    uppercase_minimizer: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Canonical k-mer (or minimizer) counting over many sequences.

    Mirrors the accumulation of kmerize_vector / kmers_from_fq_qual /
    minimerize_vector_skip_n: sequences shorter than k are skipped.

    Returns (uniq [U, width], counts [U]) with width = minimizer or k,
    lexicographically sorted.
    """
    width = minimizer if minimizer else k
    chunks: list[np.ndarray] = []
    counts_chunks: list[np.ndarray] = []
    pending: list[np.ndarray] = []
    pending_rows = 0
    FLUSH = 4_000_000

    def flush() -> None:
        nonlocal pending_rows
        if not pending:
            return
        allw = np.concatenate(pending, axis=0)
        u, c = unique_rows(allw)
        chunks.append(u)
        counts_chunks.append(c)
        pending.clear()
        pending_rows = 0

    for seq in seqs:
        if len(seq) < k:
            continue
        w = canonical_windows(seq, k, d=d, skip_n=skip_n, uppercase=uppercase)
        if w.shape[0] == 0:
            continue
        if minimizer:
            w = minimizers_of_windows(w, minimizer)
            if uppercase_minimizer:
                w = UPPER[w]
        pending.append(w)
        pending_rows += w.shape[0]
        if pending_rows >= FLUSH:
            flush()
    flush()
    if not chunks:
        return np.empty((0, width), dtype=np.uint8), np.zeros(0, dtype=np.int64)
    if len(chunks) == 1:
        return chunks[0], counts_chunks[0]
    # merge partial unique sets
    allu = np.concatenate(chunks, axis=0)
    allc = np.concatenate(counts_chunks)
    v = np.ascontiguousarray(allu).view(np.dtype((np.void, width))).ravel()
    u, inv = np.unique(v, return_inverse=True)
    summed = np.zeros(len(u), dtype=np.int64)
    np.add.at(summed, inv, allc)
    return u.view(np.uint8).reshape(-1, width), summed


def kmer_set(
    seqs: Sequence[np.ndarray],
    k: int,
    d: int = 1,
    minimizer: int = 0,
) -> np.ndarray:
    """Per-read canonical k-mer set in first-occurrence order
    (kmerize_vector_skip_n_set / minimerize_vector_skip_n_set semantics:
    skip_n always on, no uppercase of k-mers, minimizers uppercased).

    Sequences shorter than k are skipped (the reference would panic; the
    caller has already emitted "too_short" based on the first mate).
    """
    width = minimizer if minimizer else k
    parts = []
    for seq in seqs:
        if len(seq) < k:
            continue
        w = canonical_windows(seq, k, d=d, skip_n=True, uppercase=False)
        if w.shape[0] == 0:
            continue
        if minimizer:
            w = UPPER[minimizers_of_windows(w, minimizer)]
        parts.append(w)
    if not parts:
        return np.empty((0, width), dtype=np.uint8)
    allw = np.concatenate(parts, axis=0)
    uniq, _ = unique_rows(allw, order="first")
    return uniq
