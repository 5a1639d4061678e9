"""Standalone Bloom filter (API parity with simple_bloom.rs:7-38).

The index build uses vectorized scatter instead of this class; it exists for
API completeness and as an oracle in tests.
"""

from __future__ import annotations

import numpy as np

from ..hashing.xxh3 import xxh3_64


class BloomFilter:
    """m-bit Bloom filter with eta seeded-XXH3 hash functions."""

    def __init__(self, m: int, eta: int):
        self.bits = np.zeros(m, dtype=bool)
        self.num_hashes = eta

    def insert(self, value: str | bytes) -> None:
        data = value.encode() if isinstance(value, str) else value
        for i in range(self.num_hashes):
            self.bits[xxh3_64(data, i) % len(self.bits)] = True

    def contains(self, value: str | bytes) -> bool:
        data = value.encode() if isinstance(value, str) else value
        return all(
            self.bits[xxh3_64(data, i) % len(self.bits)]
            for i in range(self.num_hashes)
        )
