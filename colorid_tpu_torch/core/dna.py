"""Byte-level DNA primitives (lookup tables + revcomp/masking).

Behavior contracts (reference: the Rust colorid sources, src/):
- complement table matches ``switch_base`` (kmer.rs:847-863): acgtun/ACGTUN
  handled, anything else -> 'N'.
- "good base" set is exactly acgtACGT (seq.rs:59-64); k-mer windows containing
  any other byte are skipped by the ``skip_n`` pipelines.
- quality masking replaces bases whose phred byte < offset+33 with 'N'
  (seq.rs:36-56); offset 0 disables masking. Output length equals the quality
  string length (the reference iterates over qual chars); if the sequence is
  shorter than the quality string the reference panics -> we raise.
"""

from __future__ import annotations

import numpy as np

# complement LUT: switch_base semantics, default 'N'
COMP = np.full(256, ord("N"), dtype=np.uint8)
for a, b in [
    ("a", "t"), ("c", "g"), ("t", "a"), ("g", "c"), ("u", "a"), ("n", "n"),
    ("A", "T"), ("C", "G"), ("T", "A"), ("G", "C"), ("U", "A"), ("N", "N"),
]:
    COMP[ord(a)] = ord(b)

GOOD = np.zeros(256, dtype=bool)
for c in b"acgtACGT":
    GOOD[c] = True

UPPER = np.arange(256, dtype=np.uint8)
for c in range(ord("a"), ord("z") + 1):
    UPPER[c] = c - 32


def to_bytes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-8"), dtype=np.uint8)


def qual_mask(seq: np.ndarray, qual: np.ndarray, qual_offset: int) -> np.ndarray:
    """Phred-mask low-quality bases to 'N' (seq.rs:36-56).

    Iterates the reference's way: one output base per *quality* byte.
    """
    if qual_offset == 0:
        return seq
    if len(seq) < len(qual):
        raise ValueError("sequence shorter than quality string")
    cutoff = qual_offset + 33
    return np.where(qual[: len(qual)] < cutoff, np.uint8(ord("N")), seq[: len(qual)])


def to_str(a: np.ndarray) -> str:
    return a.tobytes().decode("utf-8")


def revcomp(seq: np.ndarray) -> np.ndarray:
    """Reverse complement of a uint8 sequence (kmer.rs:839-845)."""
    return COMP[seq[::-1]]


def revcomp_str(s: str) -> str:
    return to_str(revcomp(to_bytes(s)))
