"""FASTA/FASTQ ingestion replicating the reference's exact parsing quirks.

- ``read_fasta`` (kmer.rs:10-45): whole-file read; a line is a header if it
  contains '>' ANYWHERE; records are flushed when the next header is seen or
  when the last line of the file is processed. A trailing header line's
  pending sequence is still flushed; the header itself is dropped.
- ``read_fasta_mf`` (kmer.rs:47-84): same, also returning labels (everything
  after the first byte of each header line).
- ``stream_fastq`` / ``stream_fastq_pe`` (kmer.rs:429-824 line-cycle): 4-line
  cycle by line index (1-based): id at 1 mod 4, sequence at 2 mod 4, quality
  at 0 mod 4; '+' lines ignored; gzip streams may be multi-member
  (MultiGzDecoder semantics — Python gzip handles concatenated members).
  The paired iterator stops as soon as file2 is exhausted (None => break).
- ``stream_fasta_records`` (read_id_mt_pe.rs:450-527): the read_id fasta
  streamer keeps the raw line terminator inside the accumulated sequence, so
  k-mers never span fasta line boundaries there; replicated faithfully via
  keep_newlines=True.
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator

import numpy as np

from .dna import qual_mask, to_bytes


def _lines(path: str) -> list[str]:
    with open(path, "r") as f:
        contents = f.read()
    lines = contents.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    return [l[:-1] if l.endswith("\r") else l for l in lines]


def read_fasta(path: str) -> list[str]:
    """kmer.rs:10-45 semantics; returns concatenated record sequences."""
    out: list[str] = []
    sub: list[str] = []
    raw = _lines(path)
    n = len(raw)
    for i, line in enumerate(raw):
        if ">" in line:
            s = "".join(sub)
            if s:
                out.append(s)
            sub = []
        elif i == n - 1:
            sub.append(line)
            s = "".join(sub)
            if s:
                out.append(s)
        else:
            sub.append(line)
    return out


def read_fasta_mf(path: str) -> tuple[list[str], list[str]]:
    """kmer.rs:47-84 semantics; returns (labels, sequences)."""
    seqs: list[str] = []
    labels: list[str] = []
    sub: list[str] = []
    raw = _lines(path)
    n = len(raw)
    for i, line in enumerate(raw):
        if ">" in line:
            labels.append(line[1:])
            s = "".join(sub)
            if s:
                seqs.append(s)
            sub = []
        elif i == n - 1:
            sub.append(line)
            s = "".join(sub)
            if s:
                seqs.append(s)
        else:
            sub.append(line)
    return labels, seqs


def _open_maybe_gz(path: str) -> io.TextIOBase:
    if path.endswith("gz"):
        return io.TextIOWrapper(
            io.BufferedReader(gzip.open(path, "rb"), 1 << 20), encoding="utf-8"
        )
    return open(path, "r")


def stream_fastq(
    path: str, qual_offset: int = 0
) -> Iterator[tuple[str, np.ndarray]]:
    """Yield (id_line, masked_seq_bytes) per read from a (gzip) fastq."""
    with _open_maybe_gz(path) as f:
        rid = ""
        seq = ""
        for line_count, line in enumerate(f, start=1):
            l = line.rstrip("\n").rstrip("\r")
            m = line_count % 4
            if m == 1:
                rid = l
            elif m == 2:
                seq = l
            elif m == 0:
                yield rid, qual_mask(to_bytes(seq), to_bytes(l), qual_offset)


def stream_fastq_pe(
    path1: str, path2: str, qual_offset: int = 0
) -> Iterator[tuple[str, np.ndarray, np.ndarray]]:
    """Paired fastq streaming; id from file1; stops when file2 runs dry
    (kmers_fq_pe_qual / per_read_stream_pe semantics)."""
    with _open_maybe_gz(path1) as f1, _open_maybe_gz(path2) as f2:
        it2 = iter(f2)
        rid = ""
        seq1 = ""
        seq2 = ""
        line_count = 0
        for line in f1:
            line_count += 1
            l = line.rstrip("\n").rstrip("\r")
            l2_raw = next(it2, None)
            m = line_count % 4
            if m == 1:
                if l2_raw is None:
                    return
                rid = l
            elif m == 2:
                if l2_raw is None:
                    return
                seq1 = l
                seq2 = l2_raw.rstrip("\n").rstrip("\r")
            elif m == 0:
                if l2_raw is None:
                    return
                q2 = l2_raw.rstrip("\n").rstrip("\r")
                yield (
                    rid,
                    qual_mask(to_bytes(seq1), to_bytes(l), qual_offset),
                    qual_mask(to_bytes(seq2), to_bytes(q2), qual_offset),
                )


def stream_fastq_raw(
    path: str,
) -> Iterator[tuple[str, np.ndarray, np.ndarray]]:
    """(id, seq_bytes, qual_bytes) per read, unmasked — batch pipelines mask
    vectorized over whole batches instead of per read."""
    with _open_maybe_gz(path) as f:
        rid = ""
        seq = ""
        for line_count, line in enumerate(f, start=1):
            l = line.rstrip("\n").rstrip("\r")
            m = line_count % 4
            if m == 1:
                rid = l
            elif m == 2:
                seq = l
            elif m == 0:
                yield rid, to_bytes(seq), to_bytes(l)


def stream_fastq_pe_raw(
    path1: str, path2: str
) -> Iterator[tuple[str, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Paired unmasked streaming; id from file1; stops when file2 runs dry."""
    with _open_maybe_gz(path1) as f1, _open_maybe_gz(path2) as f2:
        it2 = iter(f2)
        rid = ""
        seq1 = ""
        seq2 = ""
        line_count = 0
        for line in f1:
            line_count += 1
            l = line.rstrip("\n").rstrip("\r")
            l2_raw = next(it2, None)
            if l2_raw is None:
                return
            m = line_count % 4
            if m == 1:
                rid = l
            elif m == 2:
                seq1 = l
                seq2 = l2_raw.rstrip("\n").rstrip("\r")
            elif m == 0:
                q2 = l2_raw.rstrip("\n").rstrip("\r")
                yield (
                    rid,
                    to_bytes(seq1),
                    to_bytes(l),
                    to_bytes(seq2),
                    to_bytes(q2),
                )


def stream_fastq_records(
    path: str,
) -> Iterator[tuple[str, str, str]]:
    """Raw (id, seq, qual) triples — used by read_filter to rewrite files."""
    with _open_maybe_gz(path) as f:
        rid = ""
        seq = ""
        for line_count, line in enumerate(f, start=1):
            l = line.rstrip("\n").rstrip("\r")
            m = line_count % 4
            if m == 1:
                rid = l
            elif m == 2:
                seq = l
            elif m == 0:
                yield rid, seq, l


def stream_fasta_records(path: str) -> Iterator[tuple[str, str]]:
    """read_id fasta streaming (read_id_mt_pe.rs:450-527): header = first
    line, then any '>' line; sequence keeps embedded newlines (quirk: k-mers
    never span fasta lines on this path); the record before a '>' line is
    emitted only if nonempty."""
    with open(path, "r") as f:
        rid = ""
        sub = ""
        first = True
        for line in f:
            if first:
                rid = line[:-1] if line.endswith("\n") else line
                first = False
                continue
            if ">" in line:
                if sub:
                    yield rid, sub
                    rid = line[:-1] if line.endswith("\n") else line
                    sub = ""
            else:
                sub += line
        yield rid, sub
