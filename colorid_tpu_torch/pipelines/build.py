"""Index construction pipeline (reference: build.rs).

Per accession: count canonical k-mers (or minimizers) from its sequence
files, frequency-filter (auto-cutoff for fastq when cutoff == -1; fasta is
unfiltered at -1, build.rs:86-91/202-207), hash every surviving k-mer
num_hash times, and set the corresponding Bloom rows in that accession's
color column of the dense bit-slice matrix. Colors are assigned by sorted
accession name (build.rs:221-230).

The reference's transpose step (build.rs:233-244: for every Bloom row, scan
all accession filters) disappears: the dense matrix IS the transposed
layout, built by a column-wise scatter-OR.

Input-type dispatch mirrors build.rs:54-99:
  two paths          -> paired fastq.gz (qual-masked, skip_n, raw case)
  one path *gz       -> single fastq.gz (qual-masked, skip_n, raw case)
  one path otherwise -> fasta (skip_n, uppercased)
Minimizer indexes use the build_multi_mini semantics (minimizer counting
before filtering; fasta minimizers uppercased, fastq minimizers raw —
kmer.rs:346 vs :746).

This port builds classic (reference-placement) and blocked (build
--blocked, ops/blocked.py) indexes on the host; the device scatter-OR build
and color-shard placement are not yet ported and raise NotImplementedError.
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

from ..core.cutoff import auto_cutoff, clean_counts
from ..core.fastx import read_fasta, stream_fastq, stream_fastq_pe
from ..core.kmers import count_kmers
from ..core.dna import to_bytes
from ..hashing.xxh3 import bloom_rows_batch
from ..index.bigsi import BigsiIndex


def _safe_name(acc: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]", "_", acc)


def tab_to_map(path: str) -> dict[str, list[str]]:
    """Manifest parser (build.rs:15-31): name<TAB>file[<TAB>file2]."""
    out: dict[str, list[str]] = {}
    with open(path) as f:
        for line in f:
            l = line.rstrip("\n").rstrip("\r")
            if not l:
                continue
            v = l.split("\t")
            if len(v) < 2:
                raise ValueError(f"manifest line has no file column: {l!r}")
            if len(v) == 2:
                out[v[0]] = [v[1]]
            else:
                out[v[0]] = [v[1], v[2]]
    return out


def _finish_native(nc, cutoff: int, is_fasta: bool):
    """Apply the reference's filter rules to a native counter and dump."""
    if cutoff == -1:
        if is_fasta:
            return nc.dump(0)  # fasta at -1 is unfiltered (build.rs:86-88)
        t = auto_cutoff(nc.counts())
        return nc.dump(t)
    return nc.dump(cutoff)


def _native_kmers(paths, k, quality, cutoff, m_size):
    """C++ fast path; None if unavailable or the input needs the exact
    (lowercase-preserving) numpy path."""
    from .. import native

    if not native.available() or k > 32 or (m_size and m_size > 32):
        return None
    if len(paths) == 2:
        nc = native.count_fastq(paths[0], paths[1], k, quality, m_size)
        return None if nc is None else _finish_native(nc, cutoff, False)
    if paths[0].endswith("gz"):
        nc = native.count_fastq(paths[0], None, k, quality, m_size)
        return None if nc is None else _finish_native(nc, cutoff, False)
    try:
        nc = native.NativeCounter(k, m_size)
    except ValueError:
        return None
    for s in read_fasta(paths[0]):
        if not nc.add(to_bytes(s)):
            return None  # lowercase: exact numpy path
    return _finish_native(nc, cutoff, True)


def accession_kmers(
    paths: list[str],
    k: int,
    quality: int,
    cutoff: int,
    m_size: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Counted + filtered k-mers (or minimizers) for one accession.

    Returns (keys [U, width], counts [U]); native path order is hash-table
    order, numpy path is sorted — callers never depend on order.
    """
    got = _native_kmers(paths, k, quality, cutoff, m_size)
    if got is not None:
        return got
    if len(paths) == 2:
        seqs = (
            s
            for _id, s1, s2 in stream_fastq_pe(paths[0], paths[1], quality)
            for s in (s1, s2)
        )
        keys, counts = count_kmers(
            seqs, k, skip_n=True, uppercase=False,
            minimizer=m_size, uppercase_minimizer=False,
        )
        is_fasta = False
    elif paths[0].endswith("gz"):
        seqs = (s for _id, s in stream_fastq(paths[0], quality))
        keys, counts = count_kmers(
            seqs, k, skip_n=True, uppercase=False,
            minimizer=m_size, uppercase_minimizer=False,
        )
        is_fasta = False
    else:
        seqs = (to_bytes(s) for s in read_fasta(paths[0]))
        keys, counts = count_kmers(
            seqs, k, skip_n=True, uppercase=True,
            minimizer=m_size, uppercase_minimizer=True,
        )
        is_fasta = True
    if cutoff == -1:
        if is_fasta:
            return keys, counts  # fasta at -1 is unfiltered (build.rs:86-88)
        t = auto_cutoff(counts)
        return clean_counts(keys, counts, t)
    return clean_counts(keys, counts, cutoff)


def _hash_rows(keys: np.ndarray, num_hash: int, bloom_size: int) -> np.ndarray:
    from .. import native

    # the native hasher emits uint32 rows: valid through 2^32 bits
    if keys.shape[0] and native.available() and bloom_size <= 2**32:
        return native.xxh3_rows(keys, num_hash, bloom_size)
    return bloom_rows_batch(keys, num_hash, bloom_size)


def build_index(
    ref_map: dict[str, list[str]],
    bloom_size: int,
    num_hash: int,
    k_size: int,
    m_size: int = 0,
    quality: int = 15,
    cutoff: int = -1,
    verbose: bool = True,
    device: bool = False,
    checkpoint_dir: str | None = None,
    blocked: bool = False,
    threads: int = 1,
    color_shards: int = 0,
) -> BigsiIndex:
    """Build the dense bit-slice index (build.rs:132-256 semantics) on the
    host, with a numpy scatter-OR per color column.

    checkpoint_dir enables per-accession resume (the reference has no
    partial build, SURVEY §5): each finished accession's Bloom bitmap
    (bloom_size/8 bytes) + k-mer count land in the directory, and an
    interrupted build skips completed accessions on rerun.
    """
    from ..trace import span

    if color_shards > 1:
        raise NotImplementedError(
            "shard-local blocked placement (build --color-shards) is not yet "
            "ported in colorid_tpu_torch (ROADMAP queue 1: sharded engines)"
        )
    if device:
        raise NotImplementedError(
            "the device scatter-OR build (build --device-build) is not yet "
            "ported in colorid_tpu_torch (ROADMAP queue 1: device build)"
        )
    accessions = sorted(ref_map.keys())
    C = len(accessions)
    W = (C + 31) // 32
    rpb = 0
    bver = 0
    if blocked:
        from ..ops.blocked import (
            blocked_rows_host,
            pad_bloom_size,
            rows_per_block,
            v2_supported,
            v3_supported,
        )

        wpad = 1 << (max(W, 1) - 1).bit_length()
        rpb = rows_per_block(wpad)
        bloom_size = pad_bloom_size(bloom_size)
        # value-addressed split-lane (v4: density-corrected block map)
        # whenever the key length and hash count permit (sorted probes hit
        # the matrix in block order, ops/stream_query.py); v2 split-lane as
        # the XXH3 fallback
        key_len = m_size if m_size else k_size
        if v3_supported(wpad, num_hash, key_len):
            bver = 4
        elif v2_supported(wpad, num_hash):
            bver = 2
        else:
            bver = 1
    n_ref_kmers: dict[str, int] = {}
    matrix = np.zeros((bloom_size, W), dtype=np.uint32)
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
    counted: dict[str, np.ndarray] = {}
    if threads > 1:
        # parallel per-accession counting (the reference's rayon par_iter,
        # build.rs:167-217); the C++ counter releases the GIL. Accessions
        # already covered by a checkpoint are skipped.
        from concurrent.futures import ThreadPoolExecutor

        todo = [
            acc
            for acc in accessions
            if not (
                checkpoint_dir
                and os.path.exists(
                    os.path.join(checkpoint_dir, _safe_name(acc) + ".bloom.npz")
                )
            )
        ]
        if verbose and todo:
            print(
                f"Inference of Bloom filters in parallel using {threads} "
                "threads.",
                file=sys.stderr,
            )

        def one(acc: str):
            keys, _ = accession_kmers(
                ref_map[acc], k_size, quality, cutoff, m_size
            )
            return acc, keys

        with ThreadPoolExecutor(max_workers=threads) as ex:
            for acc, keys in ex.map(one, todo):
                counted[acc] = keys
    for i, acc in enumerate(accessions):
        if verbose:
            print(f"Adding {acc} to index ({i + 1}/{C})", file=sys.stderr)
        bloom = None
        ck = (
            os.path.join(checkpoint_dir, _safe_name(acc) + ".bloom.npz")
            if checkpoint_dir
            else None
        )
        if ck and os.path.exists(ck):
            z = np.load(ck)
            if (
                int(z["bloom_size"]) == bloom_size
                and int(z["num_hash"]) == num_hash
                and int(z["k_size"]) == k_size
                and int(z["m_size"]) == m_size
            ):
                bloom = np.unpackbits(z["bits"], bitorder="little")[
                    :bloom_size
                ].astype(bool)
                n_ref_kmers[acc] = int(z["n_kmers"])
                if verbose:
                    print("  (resumed from checkpoint)", file=sys.stderr)
        if bloom is None:
            if acc in counted:
                keys = counted.pop(acc)
            else:
                with span(f"build:count:{acc}"):
                    keys, _counts = accession_kmers(
                        ref_map[acc], k_size, quality, cutoff, m_size
                    )
            n_ref_kmers[acc] = keys.shape[0]
            if keys.shape[0] == 0:
                rows = np.zeros((0, num_hash), dtype=np.int64)
            elif rpb:
                with span(f"build:hash:{acc}"):
                    rows = blocked_rows_host(
                        keys, num_hash, bloom_size, rpb, version=bver
                    )
            else:
                with span(f"build:hash:{acc}"):
                    rows = _hash_rows(keys, num_hash, bloom_size)
            bloom = np.zeros(bloom_size, dtype=bool)
            bloom[rows.ravel()] = True
            if ck:
                np.savez(
                    ck,
                    bits=np.packbits(bloom, bitorder="little"),
                    n_kmers=n_ref_kmers[acc],
                    bloom_size=bloom_size,
                    num_hash=num_hash,
                    k_size=k_size,
                    m_size=m_size,
                )
        matrix[:, i // 32] |= bloom.astype(np.uint32) << np.uint32(i % 32)
    return BigsiIndex(
        bloom_size=bloom_size,
        num_hash=num_hash,
        k_size=k_size,
        m_size=m_size,
        colors=accessions,
        n_ref_kmers=n_ref_kmers,
        matrix=matrix,
        blocked=bver,
    )
