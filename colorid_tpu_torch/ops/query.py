"""Device query ops: the gather -> AND -> per-color count hot loop.

Replaces the reference's per-k-mer row fetch + BitVec intersect + bit scan
(batch_search_pe.rs:45-83, perfect_search.rs:25-46). The bit-slice matrix
lives on the device as an int32 [Rb, 128] tensor, the bit view of the
uint32 words in the JAX package's 128-lane block layout
(pack_matrix_blocks), so both packages hand the same arrays to their public
functions. A query arrives either as 2-bit packed k-mers (hashed on device,
ops/hash_torch.py) or as precomputed row indices.

Absent-row semantics: the reference stores only rows with >= 1 set bit and
treats a missing row as "this k-mer cannot be in any color"
(batch_search_pe.rs:51-57 `continue`). Densely, absent == all-zero, and a
k-mer is `valid` iff all of its num_hash rows are nonzero.

The accumulators (stats, hist, over_col, over_freq) are updated IN PLACE
and returned, so callers keep the JAX package's call shape without paying
for a copy per chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from .hash_torch import M32, device_rows

FREQ_CAP = 1024  # per-color on-device frequency histogram width


def row_wpad(W: int) -> int:
    """Padded row width in words for a W-word row (pack_matrix_blocks'
    layout): next power of two up to one block, multiples of 128 beyond."""
    if W > 128:
        return 128 * (-(-W // 128))
    return 1 << (max(W, 1) - 1).bit_length()


def pack_matrix_blocks(matrix: np.ndarray) -> tuple[np.ndarray, int]:
    """Re-pack the [R, W] matrix into the [n_blocks, 128] uint32 block
    layout with the row width padded to ``row_wpad(W)`` words (a row's
    words never straddle a 128-word block; rows wider than one block span
    q = wpad // 128 consecutive blocks). Rows are padded to a multiple of
    128 blocks (min 512) so the classic stream kernel's 2-tile window always
    fits inside the matrix. Returns (blocks, wpad)."""
    R, W = matrix.shape
    wpad = row_wpad(W)
    n_rows = max(((R * wpad + 128 * 128 - 1) // (128 * 128)) * 128, 512)
    flat = np.zeros(n_rows * 128, dtype=np.uint32)
    if wpad == W:
        flat[: R * W] = np.ascontiguousarray(matrix).reshape(-1)
    else:
        view = flat[: R * wpad].reshape(R, wpad)
        view[:, :W] = matrix
    return flat.reshape(-1, 128), wpad


def _gather_rows(blocks2: torch.Tensor, rows: torch.Tensor, wpad: int):
    """vals[n, h, w] = matrix[rows[n, h], w] (int32 bit views).

    Row r's words sit at flat word offset r * wpad in both tiers: inside
    one 128-word block when wpad <= 128, and at the start of its q =
    wpad // 128 block-aligned blocks beyond that. Offsets are int64, so
    r * wpad never overflows."""
    N, H = rows.shape
    flat = blocks2.reshape(-1)
    base = rows.reshape(-1).to(torch.int64) * wpad
    if wpad == 1:
        return flat[base].reshape(N, H, 1)
    idx = base[:, None] + torch.arange(wpad, device=rows.device)
    return flat[idx].reshape(N, H, wpad)


def _gather_rows_blocked(blocks2, rows, wpad: int, rpb: int):
    """Blocked layout: the H rows of a k-mer share one block
    (ops/blocked.py), so one 512-byte block fetch serves all hashes and a
    gather along its lanes picks each row's words."""
    N, H = rows.shape
    r = rows.to(torch.int64)
    b = blocks2[r[:, 0] // rpb]  # [N, 128]
    lane0 = (r % rpb) * wpad  # [N, H]
    if wpad == 1:
        return b.gather(1, lane0).reshape(N, H, 1)
    lanes = lane0[:, :, None] + torch.arange(wpad, device=rows.device)
    return b.gather(1, lanes.reshape(N, H * wpad)).reshape(N, H, wpad)


def _and_present(blocks2, rows, wpad: int, rpb: int = 0):
    """AND over the hash axis + row presence. Returns (andw int32
    [N, wpad], present bool [N]). rpb > 0: blocked layout."""
    if rpb:
        g = _gather_rows_blocked(blocks2, rows, wpad, rpb)
    else:
        g = _gather_rows(blocks2, rows, wpad)
    present = (g != 0).any(dim=2).all(dim=1)
    andw = g[:, 0, :]
    for h in range(1, g.shape[1]):
        andw = andw & g[:, h, :]
    return andw, present


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> their int32 bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _accumulate_one(
    stats, hist, over_col, over_freq, blocks2, rows, mask, qcounts, wpad,
    base_idx, rpb=0, gidx=None,
):
    """qcounts: int32 frequencies clipped to 65535 by the caller. Values
    >= FREQ_CAP route to the overflow list, which records the k-mer's GLOBAL
    index (base_idx + local); the host resolves exact frequencies from its
    own copy."""
    andw, present = _and_present(blocks2, rows, wpad, rpb)
    return _accumulate_tail(
        stats, hist, over_col, over_freq, andw, present, mask, qcounts,
        wpad, base_idx, gidx,
    )


def _accumulate_tail(
    stats, hist, over_col, over_freq, andw, present, mask, qcounts, wpad,
    base_idx, gidx=None,
):
    """Shared epilogue over pre-gathered per-k-mer AND words: counts,
    uniq-hit detection, frequency histogram/overflow, global AND.

    stats int32 [C + wpad + 2] = (per-color counts, and-words, all-valid
    flag, n_over); hist int32 [C, FREQ_CAP]; over_col/over_freq int32
    [capO], ZERO beyond the n_over entries already written (the engine
    allocates them zeroed). andw int32 [N, wpad], present/mask bool [N],
    qcounts int32 [N].

    Nothing here waits for the device: the histogram and the overflow list
    are integer scatter-adds in which entries that do not count add 0 (at
    spread-out positions, to keep atomics uncontended). An overflow entry
    lands in a zero slot, so adding equals writing; entries past capO are
    dropped. The overflow list is compacted in k-mer order, so it equals
    the JAX package's element for element."""
    N = andw.shape[0]
    W = wpad
    C = stats.shape[0] - W - 2
    dev = andw.device
    valid = present & mask
    aw = andw.to(torch.int64) & M32  # [N, W] u32 values
    aw_v = torch.where(valid[:, None], aw, 0)
    # per-bit valid counts over all 32*W bits; the global AND of the valid
    # rows' words has bit b iff every valid row has it
    bit_counts = torch.stack(
        [((aw_v >> b) & 1).sum(dim=0) for b in range(32)], dim=1
    ).reshape(W * 32)  # [W*32], word-major = color order
    n_valid = valid.sum()
    and_bits = (bit_counts == n_valid).to(torch.int64).reshape(W, 32)
    and_b = (and_bits << torch.arange(32, device=dev)).sum(dim=1)  # [W]
    ok_b = (present | ~mask).all()

    # colors >= C are never set in a well-formed index; drop them anyway as
    # the JAX epilogue does (it slices the unpacked bits to [:, :C])
    lane_bit = torch.arange(W * 32, device=dev).reshape(W, 32)
    cmask = ((lane_bit < C).to(torch.int64) << torch.arange(32, device=dev)).sum(dim=1)
    aw_c = aw_v & cmask
    nhits = _popcount32(aw_c).sum(dim=1)
    uniq_mask = valid & (nhits == 1)
    # the uniq color: the one nonzero word's index * 32 + its bit position
    widx = (aw_c != 0).to(torch.int8).argmax(dim=1)
    word = aw_c.gather(1, widx[:, None])[:, 0]
    coloridx = widx * 32 + _popcount32((word - 1) & M32)

    qc = qcounts.to(torch.int64)
    spread = torch.arange(N, device=dev)
    small = uniq_mask & (qc < FREQ_CAP)
    qclip = qc.clamp(0, FREQ_CAP - 1)
    hidx = torch.where(small, coloridx * FREQ_CAP + qclip, spread % (C * FREQ_CAP))
    hist.view(-1).index_add_(0, hidx, small.to(hist.dtype))

    big = uniq_mask & (qc >= FREQ_CAP)
    n_over_before = stats[C + W + 1].to(torch.int64)
    capO = over_col.shape[0]
    if gidx is None:
        gidx = spread + base_idx
    to = n_over_before + torch.cumsum(big, dim=0) - 1
    keep = big & (to < capO)
    oidx = torch.where(keep, to, spread % capO)
    over_col.index_add_(0, oidx, torch.where(keep, coloridx, 0).to(over_col.dtype))
    over_freq.index_add_(
        0, oidx, torch.where(keep, gidx.to(torch.int64), 0).to(over_freq.dtype)
    )

    stats[:C] += bit_counts[:C].to(stats.dtype)
    stats[C : C + W] &= _to_i32(and_b)
    stats[C + W] *= ok_b.to(stats.dtype)
    stats[C + W + 1] += big.sum().to(stats.dtype)
    return stats, hist, over_col, over_freq


def _chunks(n: int, chunk: int):
    for start in range(0, n, chunk):
        yield start, min(start + chunk, n)


def query_accumulate_scan(
    stats, hist, over_col, over_freq, blocks2,
    rows: torch.Tensor,  # int32 [n, H]
    mask: torch.Tensor,  # bool [n]
    qcounts: torch.Tensor,  # int32 [n], clipped frequencies
    base0: int,  # global index of rows[0]
    *,
    wpad: int,
    chunk: int,
    rpb: int = 0,
):
    """Whole-query accumulation over fixed-size chunks (the chunk bounds
    the [chunk, H, wpad] gather's memory; the last chunk may be short)."""
    for s, e in _chunks(rows.shape[0], chunk):
        _accumulate_one(
            stats, hist, over_col, over_freq, blocks2, rows[s:e], mask[s:e],
            qcounts[s:e], wpad, base0 + s, rpb,
        )
    return stats, hist, over_col, over_freq


def query_accumulate_hash_scan(
    stats, hist, over_col, over_freq, blocks2,
    packed: torch.Tensor,  # int32 [n, 2] 2-bit packed canonical k-mers
    qcounts: torch.Tensor,  # int32 [n], clipped; 0 marks padding
    base0: int,  # global index of packed[0]
    *,
    wpad: int,
    chunk: int,
    k: int,
    num_hash: int,
    bloom_size: int,
    rpb: int = 0,
    bv: int = 1,
    exact: bool = False,
):
    """Device-side hashing (ops/hash_torch.py: XXH3 rows, or the blocked
    placement version ``bv`` when rpb > 0) + gather/AND/count accumulation;
    the host ships 8 bytes of packed k-mer + the frequency. With ``exact``
    the qcounts are full frequencies and overflow slots record the
    frequency itself instead of a global k-mer index."""
    for s, e in _chunks(packed.shape[0], chunk):
        rows = device_rows(
            packed[s:e], k=k, num_hash=num_hash, bloom_size=bloom_size,
            rpb=rpb, version=bv,
        )
        q = qcounts[s:e]
        _accumulate_one(
            stats, hist, over_col, over_freq, blocks2, rows, q > 0, q, wpad,
            base0 + s, rpb, gidx=q if exact else None,
        )
    return stats, hist, over_col, over_freq


def query_accumulate_hash_scan_exact(
    stats, hist, over_col, over_freq, blocks2, packed, qcounts, **kw
):
    """query_accumulate_hash_scan for device-resident queries (qcounts are
    EXACT frequencies): no host-side copy exists to resolve an overflow
    slot from a k-mer index, so it records the frequency."""
    return query_accumulate_hash_scan(
        stats, hist, over_col, over_freq, blocks2, packed, qcounts, 0,
        exact=True, **kw,
    )
