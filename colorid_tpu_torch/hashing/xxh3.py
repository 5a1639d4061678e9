"""XXH3-64 (seeded) implemented from scratch, scalar and numpy-vectorized.

The BIGSI engine hashes every canonical k-mer ``num_hash`` times with
``xxh3_64(kmer_bytes, seed=i)`` and takes the result modulo ``bloom_size`` to
obtain Bloom-row indices (reference: src/simple_bloom.rs:19-26,
perfect_search.rs:28-29, batch_search_pe.rs:47-49, read_id_mt_pe.rs:77-79).

This module implements the finalized XXH3 specification (xxHash v0.8.x) for
inputs up to 240 bytes — k-mers are short fixed-length keys, so the long
(striped) path is never needed; we raise for len > 240.

``xxh3_64`` is the scalar hash of one key (core/bloom.py's BloomFilter).
``xxh3_64_batch`` hashes a batch of equal-length keys (shape [N, L]
uint8); it is the host-side hash engine behind ``bloom_rows_batch``, which
feeds the device query where the native library is missing or a key
cannot be 2-bit packed. tests/test_torch_hash.py holds it and the device
twin (ops/hash_torch.py) against the JAX package's hasher.
"""

from __future__ import annotations

import numpy as np

M64 = (1 << 64) - 1

P64_1 = 0x9E3779B185EBCA87
P64_2 = 0xC2B2AE3D27D4EB4F
P64_3 = 0x165667B19E3779F9
PMX1 = 0x165667919E3779F9  # XXH3 avalanche prime
PMX2 = 0x9FB21C651E98DF25  # rrmxmx prime

# The standard 192-byte kSecret of the finalized XXH3 spec.
KSECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e"
)


def _rd64(buf: bytes, off: int) -> int:
    return int.from_bytes(buf[off : off + 8], "little")


def _rd32(buf: bytes, off: int) -> int:
    return int.from_bytes(buf[off : off + 4], "little")


def _swap32(x: int) -> int:
    return int.from_bytes((x & 0xFFFFFFFF).to_bytes(4, "little"), "big")


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & M64


def _swap64(x: int) -> int:
    return int.from_bytes(x.to_bytes(8, "little"), "big")


def _mul128_fold64(a: int, b: int) -> int:
    p = a * b
    return (p & M64) ^ (p >> 64)


def _xxh64_avalanche(h: int) -> int:
    h &= M64
    h ^= h >> 33
    h = (h * P64_2) & M64
    h ^= h >> 29
    h = (h * P64_3) & M64
    h ^= h >> 32
    return h


def _xxh3_avalanche(h: int) -> int:
    h &= M64
    h ^= h >> 37
    h = (h * PMX1) & M64
    h ^= h >> 32
    return h


def _rrmxmx(h: int, length: int) -> int:
    h ^= _rotl64(h, 49) ^ _rotl64(h, 24)
    h = (h * PMX2) & M64
    h ^= (h >> 35) + length
    h &= M64
    h = (h * PMX2) & M64
    h ^= h >> 28
    return h


def _mix16(data: bytes, off: int, sec_off: int, seed: int) -> int:
    lo = _rd64(data, off) ^ ((_rd64(KSECRET, sec_off) + seed) & M64)
    hi = _rd64(data, off + 8) ^ ((_rd64(KSECRET, sec_off + 8) - seed) & M64)
    return _mul128_fold64(lo, hi)


def xxh3_64(data: bytes, seed: int = 0) -> int:
    """Scalar XXH3-64 with seed for inputs of length 0..240 bytes."""
    seed &= M64
    n = len(data)
    if n <= 16:
        if n > 8:  # 9..16
            flip1 = (_rd64(KSECRET, 24) ^ _rd64(KSECRET, 32)) + seed
            flip2 = (_rd64(KSECRET, 40) ^ _rd64(KSECRET, 48)) - seed
            in_lo = (_rd64(data, 0) ^ flip1) & M64
            in_hi = (_rd64(data, n - 8) ^ flip2) & M64
            acc = (
                n
                + _swap64(in_lo)
                + in_hi
                + _mul128_fold64(in_lo, in_hi)
            )
            return _xxh3_avalanche(acc)
        if n >= 4:  # 4..8
            seed ^= (_swap32(seed) << 32) & M64
            flip = ((_rd64(KSECRET, 8) ^ _rd64(KSECRET, 16)) - seed) & M64
            in1 = _rd32(data, 0)
            in2 = _rd32(data, n - 4)
            in64 = (in2 + (in1 << 32)) & M64
            return _rrmxmx(in64 ^ flip, n)
        if n > 0:  # 1..3
            c1, c2, c3 = data[0], data[n >> 1], data[n - 1]
            combined = (c1 << 16) | (c2 << 24) | c3 | (n << 8)
            flip = ((_rd32(KSECRET, 0) ^ _rd32(KSECRET, 4)) + seed) & M64
            return _xxh64_avalanche(combined ^ flip)
        # 0
        flip = _rd64(KSECRET, 56) ^ _rd64(KSECRET, 64)
        return _xxh64_avalanche(seed ^ flip)
    if n <= 128:  # 17..128
        acc = (n * P64_1) & M64
        if n > 32:
            if n > 64:
                if n > 96:
                    acc += _mix16(data, 48, 96, seed)
                    acc += _mix16(data, n - 64, 112, seed)
                acc += _mix16(data, 32, 64, seed)
                acc += _mix16(data, n - 48, 80, seed)
            acc += _mix16(data, 16, 32, seed)
            acc += _mix16(data, n - 32, 48, seed)
        acc += _mix16(data, 0, 0, seed)
        acc += _mix16(data, n - 16, 16, seed)
        return _xxh3_avalanche(acc)
    if n <= 240:  # 129..240
        acc = (n * P64_1) & M64
        nb_rounds = n // 16
        for i in range(8):
            acc += _mix16(data, 16 * i, 16 * i, seed)
        acc = _xxh3_avalanche(acc)
        for i in range(8, nb_rounds):
            acc += _mix16(data, 16 * i, 16 * (i - 8) + 3, seed)
        acc += _mix16(data, n - 16, 136 - 17, seed)
        return _xxh3_avalanche(acc)
    raise ValueError(
        f"xxh3_64: input length {n} > 240 unsupported (k-mer keys are short)"
    )


# ---------------------------------------------------------------------------
# numpy-vectorized batch implementation (equal-length keys)
# ---------------------------------------------------------------------------

_U64 = np.uint64


def _v_mul_fold64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise 128-bit multiply of two u64 arrays, folded (lo ^ hi)."""
    mask32 = _U64(0xFFFFFFFF)
    ah = a >> _U64(32)
    al = a & mask32
    bh = b >> _U64(32)
    bl = b & mask32
    lolo = al * bl
    hilo = ah * bl
    lohi = al * bh
    hihi = ah * bh
    cross = (lolo >> _U64(32)) + (hilo & mask32) + lohi
    upper = (hilo >> _U64(32)) + (cross >> _U64(32)) + hihi
    lower = (cross << _U64(32)) | (lolo & mask32)
    return lower ^ upper


def _v_xxh64_avalanche(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> _U64(33))
    h = h * _U64(P64_2)
    h = h ^ (h >> _U64(29))
    h = h * _U64(P64_3)
    h = h ^ (h >> _U64(32))
    return h


def _v_xxh3_avalanche(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> _U64(37))
    h = h * _U64(PMX1)
    h = h ^ (h >> _U64(32))
    return h


def _v_rotl64(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U64(r)) | (x >> _U64(64 - r))


def _v_rrmxmx(h: np.ndarray, length: int) -> np.ndarray:
    h = h ^ (_v_rotl64(h, 49) ^ _v_rotl64(h, 24))
    h = h * _U64(PMX2)
    h = h ^ ((h >> _U64(35)) + _U64(length))
    h = h * _U64(PMX2)
    h = h ^ (h >> _U64(28))
    return h


def _le64(view: np.ndarray, off: int) -> np.ndarray:
    """Read a little-endian u64 starting at byte offset ``off`` of each row.

    ``view`` is a [N, L] uint8 array. Unaligned-safe.
    """
    b = view[:, off : off + 8].astype(_U64)
    out = b[:, 0]
    for i in range(1, 8):
        out = out | (b[:, i] << _U64(8 * i))
    return out


def _le32(view: np.ndarray, off: int) -> np.ndarray:
    b = view[:, off : off + 4].astype(_U64)
    out = b[:, 0]
    for i in range(1, 4):
        out = out | (b[:, i] << _U64(8 * i))
    return out


def _v_mix16(view: np.ndarray, off: int, sec_off: int, seed: int) -> np.ndarray:
    sec_lo = _U64((_rd64(KSECRET, sec_off) + seed) & M64)
    sec_hi = _U64((_rd64(KSECRET, sec_off + 8) - seed) & M64)
    lo = _le64(view, off) ^ sec_lo
    hi = _le64(view, off + 8) ^ sec_hi
    return _v_mul_fold64(lo, hi)


def xxh3_64_batch(keys: np.ndarray, seed: int = 0) -> np.ndarray:
    """Vectorized XXH3-64 with seed over a batch of equal-length keys.

    Args:
      keys: uint8 array of shape [N, L]; each row is one key (e.g. the ASCII
        bytes of a canonical k-mer). 0 <= L <= 240.
      seed: u64 seed (the reference uses seeds 0..num_hash-1).

    Returns:
      uint64 array of shape [N] of XXH3-64 digests, bit-identical to
      ``xxhash.xxh3_64_intdigest``.
    """
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    if keys.ndim != 2:
        raise ValueError("keys must be [N, L] uint8")
    n_keys, n = keys.shape
    seed &= M64
    err = np.seterr(over="ignore")
    try:
        if n_keys == 0:
            return np.zeros(0, dtype=_U64)
        if n <= 16:
            if n > 8:
                flip1 = _U64(((_rd64(KSECRET, 24) ^ _rd64(KSECRET, 32)) + seed) & M64)
                flip2 = _U64(((_rd64(KSECRET, 40) ^ _rd64(KSECRET, 48)) - seed) & M64)
                in_lo = _le64(keys, 0) ^ flip1
                in_hi = _le64(keys, n - 8) ^ flip2
                swapped = in_lo.byteswap()
                acc = _U64(n) + swapped + in_hi + _v_mul_fold64(in_lo, in_hi)
                return _v_xxh3_avalanche(acc)
            if n >= 4:
                seed2 = (seed ^ ((_swap32(seed) << 32) & M64)) & M64
                flip = _U64(((_rd64(KSECRET, 8) ^ _rd64(KSECRET, 16)) - seed2) & M64)
                in1 = _le32(keys, 0)
                in2 = _le32(keys, n - 4)
                in64 = in2 + (in1 << _U64(32))
                return _v_rrmxmx(in64 ^ flip, n)
            if n > 0:
                c1 = keys[:, 0].astype(_U64)
                c2 = keys[:, n >> 1].astype(_U64)
                c3 = keys[:, n - 1].astype(_U64)
                combined = (c1 << _U64(16)) | (c2 << _U64(24)) | c3 | _U64(n << 8)
                flip = _U64(((_rd32(KSECRET, 0) ^ _rd32(KSECRET, 4)) + seed) & M64)
                return _v_xxh64_avalanche(combined ^ flip)
            flip = _U64(_rd64(KSECRET, 56) ^ _rd64(KSECRET, 64))
            h = _v_xxh64_avalanche(np.full(n_keys, _U64(seed)) ^ flip)
            return h
        if n <= 128:
            acc = np.full(n_keys, _U64((n * P64_1) & M64))
            if n > 32:
                if n > 64:
                    if n > 96:
                        acc = acc + _v_mix16(keys, 48, 96, seed)
                        acc = acc + _v_mix16(keys, n - 64, 112, seed)
                    acc = acc + _v_mix16(keys, 32, 64, seed)
                    acc = acc + _v_mix16(keys, n - 48, 80, seed)
                acc = acc + _v_mix16(keys, 16, 32, seed)
                acc = acc + _v_mix16(keys, n - 32, 48, seed)
            acc = acc + _v_mix16(keys, 0, 0, seed)
            acc = acc + _v_mix16(keys, n - 16, 16, seed)
            return _v_xxh3_avalanche(acc)
        if n <= 240:
            acc = np.full(n_keys, _U64((n * P64_1) & M64))
            nb_rounds = n // 16
            for i in range(8):
                acc = acc + _v_mix16(keys, 16 * i, 16 * i, seed)
            acc = _v_xxh3_avalanche(acc)
            for i in range(8, nb_rounds):
                acc = acc + _v_mix16(keys, 16 * i, 16 * (i - 8) + 3, seed)
            acc = acc + _v_mix16(keys, n - 16, 136 - 17, seed)
            return _v_xxh3_avalanche(acc)
        raise ValueError(f"xxh3_64_batch: length {n} > 240 unsupported")
    finally:
        np.seterr(**err)


def bloom_rows_batch(
    keys: np.ndarray, num_hash: int, bloom_size: int
) -> np.ndarray:
    """Bloom-row indices for a batch of canonical k-mers.

    Returns uint64 [N, num_hash]: ``xxh3_64(key, seed=i) % bloom_size`` for
    i in 0..num_hash-1, matching simple_bloom.rs:19-26.
    """
    n = keys.shape[0]
    out = np.empty((n, num_hash), dtype=np.uint64)
    for i in range(num_hash):
        out[:, i] = xxh3_64_batch(keys, seed=i) % _U64(bloom_size)
    return out
