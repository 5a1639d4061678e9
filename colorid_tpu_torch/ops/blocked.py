"""Blocked ("turbo") Bloom layout: all num_hash rows of a k-mer live in one
512-byte block of the packed matrix, so the query fetches ONE block per
k-mer instead of num_hash.

Placement (not bit-compatible with the reference's independent rows — this
is an opt-in format, `build --blocked`):

    rpb      = 128 // wpad                rows per 512B block (power of two)
    n_blocks = bloom_size // rpb          bloom_size padded to a multiple
    h_i      = xxh3_64(kmer, seed=i)
    block    = h_0 % n_blocks
    off_0    = (h_0 >> 32) % rpb          high bits: independent of block
    off_i    = h_i % rpb                  (i >= 1)
    row_i    = block * rpb + off_i

The false-positive rate matches a classic blocked Bloom filter: marginally
higher than independent rows at equal size (per-block load variance); the
reporting pipelines keep using the reference's false_prob formula as the
significance approximation.

Version 3 ("sorted" / value-addressed, k <= 32) goes one step further: the
block address is a MONOTONE function of the canonical k-mer's 2-bit value
(a Lemire scaling map of the 62-bit value onto [0, n_blocks)), and the H
in-block offsets come from one murmur3 fmix64 finalizer instead of H
seeded XXH3 calls:

    v        = 2-bit canonical value (2k bits)
    block    = (v << (64 - 2k)) * n_blocks >> 64      -- monotone in v
    m        = fmix64(v)
    off_h    = h * grp + ((m >> (g_bits * h)) & (grp - 1))   (split-lane)

Monotone addressing means a batch sorted by k-mer value is ALSO sorted
by block, so the sorted-stream kernel (ops/stream_query.py) needs no second
sort, and the offset hash is a few dozen integer ops instead of a seeded
XXH3 per hash.

Version 4 corrects v3's load skew. CANONICAL k-mer values are NOT uniform:
canonical = min(v, rc(v)) with v and rc(v) near-independent uniforms, so
the value density is ~2(1-x) on [0, 1) — linearly falling to zero at the
top of the keyspace. Under v3's linear Lemire map that overloads low
blocks ~2x (worse FP) and leaves high blocks nearly empty (sparse probe
regions that blow the stream kernel's residual capacity). v4 routes the
value through the canonical CDF first:

    F(x)  = 1 - (1-x)^2                     (monotone, so sorting survives)
    block = floor(n_blocks * F(v / 2^2k))

making expected block loads uniform for near-uniform genomes (residual
content bias, e.g. GC skew, remains — same as any value-addressed map).
This is a quality trade documented for an already reference-incompatible
opt-in format.
"""

from __future__ import annotations

import numpy as np


def rows_per_block(wpad: int) -> int:
    return 128 // wpad


def pad_bloom_size(bloom_size: int) -> int:
    return ((bloom_size + 127) // 128) * 128


def v2_supported(wpad: int, num_hash: int) -> bool:
    """The split-lane (v2) placement needs a power-of-two hash count that
    divides the rows-per-block evenly (so each hash owns a lane group) with
    at least 2 candidate rows per hash — grp == 1 would make every k-mer in
    a block set the SAME rows (degenerate Bloom: FP = per-block collision
    probability). E.g. 1024 colors (wpad 32, rpb 4) supports split-lane for
    num_hash <= 2; num_hash 4 falls back to the v1 blocked placement."""
    rpb = rows_per_block(wpad)
    return (
        num_hash >= 1
        and (num_hash & (num_hash - 1)) == 0
        and num_hash * 2 <= rpb
    )


def v3_supported(wpad: int, num_hash: int, k: int) -> bool:
    """Value-addressed placement (v3 and the density-corrected v4)
    additionally needs the 2-bit value to fit one u64 (k <= 32; the same
    envelope as device hashing)."""
    return v2_supported(wpad, num_hash) and 4 <= k <= 32


_FMIX_C1 = np.uint64(0xFF51AFD7ED558CCD)
_FMIX_C2 = np.uint64(0xC4CEB9FE1A85EC53)


def fmix64(v: np.ndarray) -> np.ndarray:
    """murmur3 64-bit finalizer (numpy uint64, vectorized)."""
    v = v.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        v ^= v >> np.uint64(33)
        v *= _FMIX_C1
        v ^= v >> np.uint64(33)
        v *= _FMIX_C2
        v ^= v >> np.uint64(33)
    return v


def _mulhi64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """High 64 bits of a u64 x u64 product (vectorized, 32-bit halves)."""
    a = a.astype(np.uint64)
    b = b.astype(np.uint64)
    a_hi, a_lo = a >> np.uint64(32), a & np.uint64(0xFFFFFFFF)
    b_hi, b_lo = b >> np.uint64(32), b & np.uint64(0xFFFFFFFF)
    with np.errstate(over="ignore"):
        ll = a_lo * b_lo
        lh = a_lo * b_hi
        hl = a_hi * b_lo
        hh = a_hi * b_hi
        mid = (ll >> np.uint64(32)) + (lh & np.uint64(0xFFFFFFFF)) + (
            hl & np.uint64(0xFFFFFFFF)
        )
        return hh + (lh >> np.uint64(32)) + (hl >> np.uint64(32)) + (
            mid >> np.uint64(32)
        )


def v3_block_offsets(
    vals: np.ndarray, k: int, num_hash: int, bloom_size: int, rpb: int,
    version: int = 3,
) -> tuple[np.ndarray, np.ndarray]:
    """(block [N], offs [N, H]) of the value-addressed placements for u64
    2-bit values. version 3 = linear Lemire map; version 4 routes through
    the canonical-value CDF F(x) = 1-(1-x)^2 first (uniform expected block
    loads, module docstring)."""
    n_blocks = np.uint64(bloom_size // rpb)
    grp = rpb // num_hash
    g_bits = grp.bit_length() - 1
    x = vals.astype(np.uint64) << np.uint64(64 - 2 * k)
    if version == 4:
        # F(x) ~= (2^64-1 - mulhi(y, y)) / 2^64 with y = 2^64-1 - x:
        # monotone nondecreasing in x, and ~2x - x^2 to within 2^-32
        y = ~x
        x = ~_mulhi64(y, y)
    block = _mulhi64(x, np.broadcast_to(n_blocks, x.shape))
    m = fmix64(vals)
    offs = np.empty((vals.shape[0], num_hash), dtype=np.int64)
    for h in range(num_hash):
        bits = (m >> np.uint64(g_bits * h)) & np.uint64(grp - 1)
        offs[:, h] = (h * grp + bits).astype(np.int64)
    return block.astype(np.int64), offs


def pack_keys_u64(keys: np.ndarray) -> np.ndarray:
    """ASCII canonical k-mer rows [N, k] -> u64 2-bit values [N]."""
    code = np.zeros(256, dtype=np.uint8)
    code[ord("C")] = 1
    code[ord("G")] = 2
    code[ord("T")] = 3
    c = code[keys]
    val = np.zeros(keys.shape[0], dtype=np.uint64)
    for i in range(keys.shape[1]):
        val = (val << np.uint64(2)) | c[:, i].astype(np.uint64)
    return val


def _raw_hashes(keys: np.ndarray, num_hash: int) -> np.ndarray:
    from .. import native
    from ..hashing.xxh3 import xxh3_64_batch

    if keys.shape[0] and native.available():
        return native.xxh3_hash64(keys, num_hash)
    return np.stack(
        [xxh3_64_batch(keys, seed=i) for i in range(num_hash)], axis=1
    )


def blocked_rows_host(
    keys: np.ndarray,
    num_hash: int,
    bloom_size: int,
    rpb: int,
    version: int = 1,
) -> np.ndarray:
    """Row indices [N, H] for ASCII k-mer rows under the blocked layout.

    version 1: off_i = h_i % rpb (off_0 from the high hash bits).
    version 2 (split-lane): hash h's row confined to its own group of
    grp = rpb // H rows — off_h = h*grp + (h_h % grp) — so the query kernel
    can extract all H words with one fixed matrix contraction (a split-block
    Bloom filter; marginally different FP correlation than v1, same size).
    version 3 (value-addressed split-lane): block monotone in the k-mer
    value, offsets from fmix64 — see module docstring.
    version 4: v3 with the canonical-density-corrected block map.
    """
    n = keys.shape[0]
    if version in (3, 4):
        vals = pack_keys_u64(keys)
        block, offs = v3_block_offsets(
            vals, keys.shape[1], num_hash, bloom_size, rpb, version=version
        )
        return block[:, None] * np.int64(rpb) + offs
    h = _raw_hashes(keys, num_hash)
    nb = np.uint64(bloom_size // rpb)
    rpb64 = np.uint64(rpb)
    block = h[:, 0] % nb
    rows = np.empty((n, num_hash), dtype=np.int64)
    if version == 2:
        grp = np.uint64(rpb // num_hash)
        rows[:, 0] = (block * rpb64 + ((h[:, 0] >> np.uint64(32)) % grp)).astype(
            np.int64
        )
        for i in range(1, num_hash):
            rows[:, i] = (
                block * rpb64 + np.uint64(i) * grp + (h[:, i] % grp)
            ).astype(np.int64)
        return rows
    rows[:, 0] = (block * rpb64 + ((h[:, 0] >> np.uint64(32)) % rpb64)).astype(
        np.int64
    )
    for i in range(1, num_hash):
        rows[:, i] = (block * rpb64 + (h[:, i] % rpb64)).astype(np.int64)
    return rows
