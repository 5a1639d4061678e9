"""Search pipelines (reference: perfect_search.rs, batch_search_pe.rs).

All scoring runs through the device QueryEngine; this layer does input
counting/filtering, assembles the per-color report + unique-k-mer coverage
stats from the kernel outputs, and formats reference-identical TSV.

A ``.fastq.gz`` query counts its k-mers on the device (``engine.
search_reads``, ops/extract.py) unless COLORID_SEARCH_READS=0, the input
holds lowercase bases, or it spans more windows than
COLORID_SEARCH_READS_MAX_WIN; those take host counting
(``_count_query_kmers``) and ``search_keys``. Both give the same TSV.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.cutoff import auto_cutoff, clean_counts
from ..core.dna import to_bytes
from ..core.fastx import read_fasta, read_fasta_mf, stream_fastq, stream_fastq_pe
from ..core.kmers import canonical_windows, count_kmers, unique_rows
from ..engine import QueryEngine
from .reports import generate_report, generate_report_gene


def _count_query_kmers(
    file1: str,
    file2: str | None,
    k: int,
    qual_offset: int,
    filter_t: int,
    gene_search: bool,
):
    """Query k-mer counting + filtering (batch_search_pe.rs:24-39,106-120)."""
    from .. import native

    if native.available() and k <= 32:
        if file1.endswith("gz"):
            print(
                file1 if file2 is None else f"Paired end: {file1} {file2}",
                file=sys.stderr,
            )
            print("Counting k-mers, this may take a while!", file=sys.stderr)
            nc = native.count_fastq(file1, file2, k, qual_offset, 0)
            if nc is not None:
                t = auto_cutoff(nc.counts()) if filter_t < 0 else filter_t
                keys, counts = nc.dump(t)
                packed, _ = nc.dump_packed(t)
                return keys, counts, packed
        else:
            print(file1, file=sys.stderr)
            print("Counting k-mers, this may take a while!", file=sys.stderr)
            try:
                nc = native.NativeCounter(k)
            except ValueError:
                nc = None
            if nc is not None:
                ok = all(nc.add(to_bytes(s)) for s in read_fasta(file1))
                if ok:
                    if gene_search:
                        t = 0
                    elif filter_t < 0:
                        print("no gene search", file=sys.stderr)
                        t = auto_cutoff(nc.counts())
                    else:
                        t = filter_t
                    keys, counts = nc.dump(t)
                    packed, _ = nc.dump_packed(t)
                    return keys, counts, packed
    if file1.endswith("gz"):
        if file2 is None:
            print(file1, file=sys.stderr)
            print("Counting k-mers, this may take a while!", file=sys.stderr)
            seqs = (s for _id, s in stream_fastq(file1, qual_offset))
        else:
            print(f"Paired end: {file1} {file2}", file=sys.stderr)
            print("Counting k-mers, this may take a while!", file=sys.stderr)
            seqs = (
                s
                for _id, s1, s2 in stream_fastq_pe(file1, file2, qual_offset)
                for s in (s1, s2)
            )
        keys, counts = count_kmers(seqs, k, skip_n=True, uppercase=False)
        if filter_t < 0:
            t = auto_cutoff(counts)
            return clean_counts(keys, counts, t) + (None,)
        return clean_counts(keys, counts, filter_t) + (None,)
    print(file1, file=sys.stderr)
    print("Counting k-mers, this may take a while!", file=sys.stderr)
    seqs = (to_bytes(s) for s in read_fasta(file1))
    keys, counts = count_kmers(seqs, k, skip_n=True, uppercase=True)
    if gene_search:
        return clean_counts(keys, counts, 0) + (None,)
    if filter_t < 0:
        print("no gene search", file=sys.stderr)
        t = auto_cutoff(counts)
        return clean_counts(keys, counts, t) + (None,)
    return clean_counts(keys, counts, filter_t) + (None,)


def _device_count_search(file1, file2, engine, filter_t, qual_offset):
    """Fully device-resident fastq query: stream + quality-mask reads on
    host, ship 2-bit words + a per-base validity bitplane (~0.28 B/base),
    and let the device extract, count, auto-cutoff-filter and query — the
    reference's whole count-then-search flow (batch_search_pe.rs:24-83)
    without per-k-mer host work or traffic. Returns (SearchResult,
    n_filtered_kmers) or None to fall back to the host counting path
    (lowercase input, engine without device extraction, or an input beyond
    the single-device window budget)."""
    import os

    from ..core.fastx import stream_fastq, stream_fastq_pe
    from ..ops.extract import pack_reads_valid

    index = engine.index
    k = index.k_size
    if not (
        hasattr(engine, "search_reads")
        and 4 <= k <= 32
        and index.bloom_size < 2**31
        and os.environ.get("COLORID_SEARCH_READS", "1") != "0"
    ):
        return None
    print(
        file1 if file2 is None else f"Paired end: {file1} {file2}",
        file=sys.stderr,
    )
    print("Counting k-mers, this may take a while!", file=sys.stderr)
    if file2 is None:
        seqs = [s for _id, s in stream_fastq(file1, qual_offset)]
    else:
        seqs = [
            s
            for _id, s1, s2 in stream_fastq_pe(file1, file2, qual_offset)
            for s in (s1, s2)
        ]
    return device_count_search_seqs(seqs, engine, filter_t)


def device_count_search_seqs(seqs, engine, filter_t):
    """The device-resident count+filter+query flow over in-memory byte
    sequences (shared by the fastq path above and serve's /search bodies).
    Returns (SearchResult, n_filtered_kmers) or None to fall back."""
    import os

    from ..ops.extract import pack_reads_valid

    index = engine.index
    k = index.k_size
    if not (
        seqs
        and hasattr(engine, "search_reads")
        and 4 <= k <= 32
        and index.bloom_size < 2**31
        and not getattr(engine, "_custom_place", False)
        and os.environ.get("COLORID_SEARCH_READS", "1") != "0"
    ):
        return None
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    Lmax = int(lens.max())
    if Lmax < k or Lmax > 8192:
        return None
    Lb = max(64, -(-Lmax // 32) * 32)
    R = len(seqs)
    Rp = max(1 << (R - 1).bit_length(), 4096)
    budget = int(os.environ.get("COLORID_SEARCH_READS_MAX_WIN", 1 << 29))
    if Rp * (Lb - k + 1) > budget:
        return None  # host counting handles arbitrarily large inputs
    mb = np.zeros((Rp, Lb), dtype=np.uint8)
    for j, s in enumerate(seqs):
        mb[j, : len(s)] = s
    lower = np.zeros(256, dtype=bool)
    lower[[ord(c) for c in "acgt"]] = True
    if lower[mb].any():
        return None  # raw-byte canonical order is not 2-bit representable
    lens_p = np.zeros(Rp, dtype=np.int32)
    lens_p[:R] = lens
    words, vbits = pack_reads_valid(mb)
    if filter_t < 0:
        from ..core.cutoff import auto_cutoff_hist

        hist = engine.count_reads_histogram(
            words, lens_p, vbits, k=k, L=Lb
        )
        t = auto_cutoff_hist(hist)
    else:
        t = filter_t
    res, n_u = engine.search_reads(
        words, lens_p, vbits, k=k, L=Lb, filter_t=t
    )
    return res, n_u


def batch_search(
    files1: list[str],
    files2: list[str],
    engine: QueryEngine,
    filter_t: int = -1,
    cov: float = 0.35,
    gene_search: bool = False,
    qual_offset: int = 15,
) -> list[str]:
    """Inexact search (batch_search_pe.rs:9-179). Returns stdout TSV lines."""
    index = engine.index
    out_lines: list[str] = []
    for i, file1 in enumerate(files1):
        file2 = files2[i] if files2 else None
        res = None
        if file1.endswith("gz"):
            got = _device_count_search(
                file1, file2, engine, filter_t, qual_offset
            )
            if got is not None:
                res, num_kmers = got
        if res is None:
            keys, qcounts, packed = _count_query_kmers(
                file1, file2, index.k_size, qual_offset, filter_t, gene_search
            )
            num_kmers = keys.shape[0]
        print(f"{num_kmers} k-mers in query", file=sys.stderr)
        if res is None:
            res = engine.search_keys(
                keys, qcounts=qcounts, packed_all=packed, k=index.k_size
            )
        report = {
            index.colors[c]: int(res.counts[c])
            for c in range(index.n_colors)
            if res.counts[c] > 0
        }
        uniq_stats = {
            index.colors[c]: s for c, s in res.freq_stats().items()
        }
        if not gene_search:
            out_lines += generate_report(
                file1, report, uniq_stats, index.n_ref_kmers, num_kmers, cov
            )
        else:
            out_lines += generate_report_gene(file1, report, num_kmers, cov)
    return out_lines


def _perfect_one(
    label: str, keys: np.ndarray, engine: QueryEngine, out: list[str]
) -> None:
    index = engine.index
    n = keys.shape[0]
    print(f"{n} kmers in query", file=sys.stderr)
    res = engine.search_keys(keys)
    if not res.all_valid:
        print("No perfect hits!", file=sys.stderr)
        return
    bits = np.unpackbits(
        res.and_all.view(np.uint8), bitorder="little"
    )[: index.n_colors]
    hits = np.nonzero(bits)[0]
    print(f"{len(hits)} hits", file=sys.stderr)
    for c in hits:
        out.append(f"{label}\t{index.colors[int(c)]}\t{n}\t1.00")


def perfect_search(
    files: list[str], engine: QueryEngine, multi_fasta: bool = False
) -> list[str]:
    """Perfect-match search (perfect_search.rs:6-120)."""
    index = engine.index
    out: list[str] = []
    for file in files:
        if not multi_fasta:
            print("Counting k-mers, this may take a while!", file=sys.stderr)
            seqs = [to_bytes(s) for s in read_fasta(file)]
            keys, _ = count_kmers(seqs, index.k_size, skip_n=True, uppercase=True)
            if keys.shape[0] == 0:
                print(
                    "Warning! no kmers in query; maybe your kmer length is "
                    "larger than your query length?",
                    file=sys.stderr,
                )
                continue
            _perfect_one(file, keys, engine, out)
        else:
            labels, seqs = read_fasta_mf(file)
            for j, label in enumerate(labels):
                seq = to_bytes(seqs[j])
                if len(seq) < index.k_size:
                    out.append(
                        f"Warning! no kmers in query '{label}'; maybe your "
                        "kmer length is larger than your query length?"
                    )
                    continue
                # kmerize_string: skip_n OFF, uppercase ON (kmer.rs:271-299)
                w = canonical_windows(
                    seq, index.k_size, skip_n=False, uppercase=True
                )
                keys, _ = unique_rows(w)
                _perfect_one(label, keys, engine, out)
    return out
