"""Device-side hashing: canonical k-mers into Bloom rows with torch ops.
XXH3-64 for the classic rows and the blocked placements v1/v2, and the
value-addressed placements v3/v4 of ops/blocked.py (one fmix64, a 64-bit
square and a 64-bit product; no XXH3).

The host ships each canonical k-mer as its 2-bit packing (8 bytes) instead
of row indices (4 bytes x num_hash); the hash runs on the device as
elementwise tensor ops.

PyTorch has no unsigned 32/64-bit shift, add or remainder on every device,
and ``>>`` on a signed value is arithmetic. So a u64 value is a (lo, hi)
pair of 32-bit limbs, each carried in an ``int64`` tensor holding a value
in [0, 2^32). Every intermediate stays below 2^63 (products are taken over
16-bit halves), so no signed overflow ever happens, and results are masked
back to 32 bits after every shift, add and product. All secret-derived
constants are folded per seed on the host.

Supported: k in 4..32 (the 4-8, 9-16 and 17-128 XXH3 length classes over
ASCII ACGT bytes), bloom_size < 2^31. Callers fall back to host hashing
outside this envelope. Bit-exact against hashing/xxh3.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hashing.xxh3 import KSECRET, M64, P64_1, PMX1, PMX2, _rd64

M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def _c(x: int) -> tuple[int, int]:
    """Split a python u64 constant into (lo, hi) u32 python ints."""
    x &= M64
    return x & M32, x >> 32


# -- 64-bit ops over (lo, hi) limb pairs ------------------------------------
# a limb is an int64 tensor in [0, 2^32) or a python int in that range


def _xor64(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def _or64(a, b):
    return a[0] | b[0], a[1] | b[1]


def _add64(a, b):
    lo = a[0] + b[0]
    return lo & M32, (a[1] + b[1] + (lo >> 32)) & M32


def _shr64(a, n: int):
    lo, hi = a
    if n == 0:
        return a
    if n < 32:
        return ((lo >> n) | (hi << (32 - n))) & M32, hi >> n
    if n == 32:
        return hi, torch.zeros_like(hi)
    return hi >> (n - 32), torch.zeros_like(hi)


def _shl64(a, n: int):
    lo, hi = a
    if n == 0:
        return a
    if n < 32:
        return (lo << n) & M32, ((hi << n) | (lo >> (32 - n))) & M32
    if n == 32:
        return torch.zeros_like(lo), lo
    return torch.zeros_like(lo), (lo << (n - 32)) & M32


def _rotl64(a, n: int):
    return _or64(_shl64(a, n), _shr64(a, 64 - n))


def _mul32(a, b):
    """Full 32x32 -> 64 product as (lo, hi) limbs. ``a`` is a tensor, ``b``
    a tensor or python int; both in [0, 2^32). Each partial product is
    < 2^48, so int64 never overflows."""
    x = (a >> 16) * b
    y = (a & _M16) * b
    s = y + ((x & _M16) << 16)  # < 2^49
    return s & M32, (x >> 16) + (s >> 32)


def _mul64_full(a, b):
    """128-bit product limbs (w0..w3) of two u64 limb pairs."""
    alo, ahi = a
    blo, bhi = b
    p0l, p0h = _mul32(alo, blo)
    p1l, p1h = _mul32(alo, bhi)
    p2l, p2h = _mul32(ahi, blo)
    p3l, p3h = _mul32(ahi, bhi)
    s1 = p0h + p1l + p2l
    s2 = p1h + p2h + p3l + (s1 >> 32)
    w3 = (p3h + (s2 >> 32)) & M32
    return p0l, s1 & M32, s2 & M32, w3


def _mul64_fold(a, b):
    """(a * b) 128-bit product folded to 64 bits (lo ^ hi of the product)."""
    w0, w1, w2, w3 = _mul64_full(a, b)
    return w0 ^ w2, w1 ^ w3


def _mul64_fold_low(a, const):
    """Low 64 bits of a * const (const as a python (lo, hi) pair)."""
    alo, ahi = a
    p0l, p0h = _mul32(alo, const[0])
    p1l, _ = _mul32(alo, const[1])
    p2l, _ = _mul32(ahi, const[0])
    return p0l, (p0h + p1l + p2l) & M32


def _avalanche_xxh3(h):
    h = _xor64(h, _shr64(h, 37))
    h = _mul64_fold_low(h, _c(PMX1))
    return _xor64(h, _shr64(h, 32))


def _rrmxmx(h, length: int):
    h = _xor64(h, _xor64(_rotl64(h, 49), _rotl64(h, 24)))
    h = _mul64_fold_low(h, _c(PMX2))
    plus = _add64(_shr64(h, 35), (length, 0))
    h = _xor64(h, plus)
    h = _mul64_fold_low(h, _c(PMX2))
    return _xor64(h, _shr64(h, 28))


def _bswap64(a):
    lo, hi = a

    def bswap32(x):
        return (
            ((x & 0xFF) << 24)
            | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00)
            | (x >> 24)
        )

    return bswap32(hi), bswap32(lo)


# -- byte assembly ----------------------------------------------------------


def _limbs_from_packed(lo: torch.Tensor, hi: torch.Tensor, k: int) -> list:
    """ASCII byte stream of the k-mer as little-endian u32 limbs.

    lo/hi: int64 tensors in [0, 2^32), the 2-bit packing with base 0 at
    bits [2k-2, 2k-1] of the 64-bit value (native ingest layout). Returns
    ceil(k/4) limb tensors; bytes past k are zero."""
    lut = torch.tensor([65, 67, 71, 84], dtype=torch.int64, device=lo.device)
    limbs = []
    for j in range((k + 3) // 4):
        limb = torch.zeros_like(lo)
        for b in range(4):
            i = j * 4 + b  # byte index in the ASCII string
            if i >= k:
                break
            shift = 2 * (k - 1 - i)
            if shift >= 32:
                code = (hi >> (shift - 32)) & 3
            elif shift > 0:
                code = ((lo >> shift) | (hi << (32 - shift))) & 3
            else:
                code = lo & 3
            limb = limb | (lut[code] << (8 * b))
        limbs.append(limb)
    return limbs


def _rd32_limbs(limbs: list, off: int):
    """Little-endian u32 read at byte offset ``off`` of the limb stream
    (off + 3 < k, so an unaligned read spans two existing limbs)."""
    j, r = divmod(off, 4)
    if r == 0:
        return limbs[j]
    return ((limbs[j] >> (8 * r)) | (limbs[j + 1] << (32 - 8 * r))) & M32


def _rd64_limbs(limbs: list, off: int):
    return _rd32_limbs(limbs, off), _rd32_limbs(limbs, off + 4)


# -- the hash ----------------------------------------------------------------


def _mix16(limbs, off: int, sec_off: int, seed: int):
    a = _xor64(_rd64_limbs(limbs, off), _c(_rd64(KSECRET, sec_off) + seed))
    b = _xor64(_rd64_limbs(limbs, off + 8), _c(_rd64(KSECRET, sec_off + 8) - seed))
    return _mul64_fold(a, b)


def _xxh3_device(limbs: list, k: int, seed: int):
    """XXH3-64(ascii_kmer, seed) for fixed length k, one seed, as limbs."""
    if 17 <= k <= 32:
        lo0, hi0 = _c(k * P64_1)
        acc = (torch.full_like(limbs[0], lo0), torch.full_like(limbs[0], hi0))
        acc = _add64(acc, _mix16(limbs, 0, 0, seed))
        acc = _add64(acc, _mix16(limbs, k - 16, 16, seed))
        return _avalanche_xxh3(acc)
    if 9 <= k <= 16:
        f1 = _c((_rd64(KSECRET, 24) ^ _rd64(KSECRET, 32)) + seed)
        f2 = _c((_rd64(KSECRET, 40) ^ _rd64(KSECRET, 48)) - seed)
        in_lo = _xor64(_rd64_limbs(limbs, 0), f1)
        in_hi = _xor64(_rd64_limbs(limbs, k - 8), f2)
        acc = _add64(_bswap64(in_lo), (k, 0))
        acc = _add64(acc, in_hi)
        acc = _add64(acc, _mul64_fold(in_lo, in_hi))
        return _avalanche_xxh3(acc)
    if 4 <= k <= 8:
        swapped = int.from_bytes((seed & M32).to_bytes(4, "little"), "big")
        seed2 = (seed ^ (swapped << 32)) & M64
        flip = _c((_rd64(KSECRET, 8) ^ _rd64(KSECRET, 16)) - seed2)
        in1 = _rd32_limbs(limbs, 0)
        in2 = _rd32_limbs(limbs, k - 4)
        keyed = _xor64((in2, in1), flip)  # in2 + (in1 << 32)
        return _rrmxmx(keyed, k)
    raise ValueError(f"device xxh3 supports k in 4..32, got {k}")


def _mod_u64(h, m: int) -> torch.Tensor:
    """(hi * 2^32 + lo) mod m for 0 < m < 2^31, as int64.

    Takes the place of the JAX package's Barrett reduction, which exists
    because its device has no 64-bit integers: here (hi mod m) * (2^32 mod
    m) + lo < 2^62 + 2^32 fits int64, so two remainders give the exact
    value."""
    if not 0 < m < 2**31:
        raise ValueError("device modulo supports 0 < m < 2^31")
    lo, hi = h
    return ((hi % m) * ((1 << 32) % m) + lo) % m


def bloom_rows_device(
    packed: torch.Tensor, *, k: int, num_hash: int, bloom_size: int
) -> torch.Tensor:
    """packed [N, 2] int32 (bit view of the (lo, hi) uint32 2-bit k-mers)
    -> rows [N, num_hash] int32."""
    p = packed.to(torch.int64) & M32
    limbs = _limbs_from_packed(p[:, 0], p[:, 1], k)
    outs = [
        _mod_u64(_xxh3_device(limbs, k, seed), bloom_size).to(torch.int32)
        for seed in range(num_hash)
    ]
    return torch.stack(outs, dim=1)


# -- blocked placements (ops/blocked.py) on the device -----------------------

_FMIX_C1 = 0xFF51AFD7ED558CCD
_FMIX_C2 = 0xC4CEB9FE1A85EC53


def _fmix64_device(v):
    """murmur3 fmix64 over (lo, hi) limb pairs (ops/blocked.py::fmix64's
    device twin)."""
    v = _xor64(v, _shr64(v, 33))
    v = _mul64_fold_low(v, _c(_FMIX_C1))
    v = _xor64(v, _shr64(v, 33))
    v = _mul64_fold_low(v, _c(_FMIX_C2))
    return _xor64(v, _shr64(v, 33))


def _not64(a):
    return a[0] ^ M32, a[1] ^ M32


def _sqr64_hi(a):
    """High 64 bits of the 128-bit square of a (lo, hi) limb pair.

    a^2 = p0 + (p1 << 33) + (p3 << 64) with p0 = lo^2, p1 = lo*hi,
    p3 = hi^2. The limbs of the shifted p1 are l1..l3; each carry is the
    part of an unmasked int64 sum above bit 32."""
    alo, ahi = a
    _, p0h = _mul32(alo, alo)
    p1l, p1h = _mul32(alo, ahi)
    p3l, p3h = _mul32(ahi, ahi)
    l1 = (p1l << 1) & M32
    l2 = ((p1h << 1) | (p1l >> 31)) & M32
    l3 = p1h >> 31
    s2 = l2 + p3l + ((p0h + l1) >> 32)
    return s2 & M32, (l3 + p3h + (s2 >> 32)) & M32


def _v3_blkoff(lo, hi, k: int, num_hash: int, bloom_size: int, rpb: int,
               version: int = 3):
    """Value-addressed blocked placement from 2-bit packed k-mers (int64
    limbs lo, hi): block int64 [N] in [0, n_blocks), MONOTONE in the
    (hi, lo) value, and the per-hash in-block offsets, a list of H int64
    [N]. Twin of ops/blocked.py::v3_block_offsets; version 4 routes the
    value through the canonical CDF F(x) = 1-(1-x)^2 first."""
    n_blocks = bloom_size // rpb
    grp = rpb // num_hash
    g_bits = grp.bit_length() - 1
    x = _shl64((lo, hi), 64 - 2 * k)
    if version == 4:
        x = _not64(_sqr64_hi(_not64(x)))
    block = _mul64_full(x, _c(n_blocks))[2]  # (x * nb) >> 64 < nb < 2^31
    m = _fmix64_device((lo, hi))
    offs = [
        h * grp + (_shr64(m, g_bits * h)[0] & (grp - 1))
        for h in range(num_hash)
    ]
    return block, offs


def device_blkoff(packed: torch.Tensor, *, k: int, num_hash: int,
                  bloom_size: int, rpb: int, version: int = 1):
    """Blocked placement (ops/blocked.py) of packed [N, 2] int32 k-mers:
    block int64 [N] and the per-hash in-block row offsets, a list of H
    int64 [N]. Versions 1 and 2 hash with the device XXH3; 3 and 4 are
    value-addressed (no XXH3)."""
    p = packed.to(torch.int64) & M32
    lo, hi = p[:, 0], p[:, 1]
    if version in (3, 4):
        return _v3_blkoff(lo, hi, k, num_hash, bloom_size, rpb, version)
    limbs = _limbs_from_packed(lo, hi, k)
    hashes = [_xxh3_device(limbs, k, seed) for seed in range(num_hash)]
    block = _mod_u64(hashes[0], bloom_size // rpb)
    if version == 2:
        grp = rpb // num_hash
        offs = [hashes[0][1] & (grp - 1)]  # high limb: independent of block
        offs += [
            i * grp + (h[0] & (grp - 1)) for i, h in enumerate(hashes[1:], 1)
        ]
    else:
        offs = [hashes[0][1] & (rpb - 1)]
        offs += [h[0] & (rpb - 1) for h in hashes[1:]]
    return block, offs


def device_rows(packed: torch.Tensor, *, k: int, num_hash: int,
                bloom_size: int, rpb: int = 0, version: int = 1):
    """Bloom rows [N, H] int32 of packed k-mers: independent XXH3 rows
    (rpb == 0) or the blocked placement (rpb > 0, a power of two)."""
    if rpb == 0:
        return bloom_rows_device(
            packed, k=k, num_hash=num_hash, bloom_size=bloom_size
        )
    block, offs = device_blkoff(
        packed, k=k, num_hash=num_hash, bloom_size=bloom_size, rpb=rpb,
        version=version,
    )
    base = block * rpb
    return torch.stack([base + o for o in offs], dim=1).to(torch.int32)


def pack_keys_host(keys: np.ndarray) -> np.ndarray | None:
    """ASCII canonical k-mers [N, k] -> (lo, hi) uint32 [N, 2], or None when
    any byte is outside uppercase ACGT (caller uses host hashing then)."""
    n, k = keys.shape
    if k > 32:
        return None
    code = np.full(256, 255, dtype=np.uint8)
    code[ord("A")] = 0
    code[ord("C")] = 1
    code[ord("G")] = 2
    code[ord("T")] = 3
    c = code[keys]
    if (c == 255).any():
        return None
    val = np.zeros(n, dtype=np.uint64)
    for i in range(k):
        val = (val << np.uint64(2)) | c[:, i].astype(np.uint64)
    out = np.empty((n, 2), dtype=np.uint32)
    out[:, 0] = (val & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[:, 1] = (val >> np.uint64(32)).astype(np.uint32)
    return out
