"""Device query ops: the gather -> AND -> per-color count hot loop.

Replaces the reference's per-k-mer row fetch + BitVec intersect + bit scan
(batch_search_pe.rs:45-83, perfect_search.rs:25-46). The bit-slice matrix
lives on the device as an int32 [Rb, 128] tensor, the bit view of the
uint32 words in the JAX package's 128-lane block layout
(pack_matrix_blocks), so both packages hand the same arrays to their public
functions. A query arrives either as 2-bit packed k-mers (hashed on device,
ops/hash_torch.py) or as precomputed row indices: int32, or int64 for an
index past int32 row addressing (bloom_size >= 2^31), which the gather's
int64 word offsets serve as they are. The *_wide functions take the JAX
package's (block, lane) split of such rows (split_rows_wide) and turn it
back into rows.

The read classifier (read_id) queries sit at the end of this module.

Absent-row semantics: the reference stores only rows with >= 1 set bit and
treats a missing row as "this k-mer cannot be in any color"
(batch_search_pe.rs:51-57 `continue`). Densely, absent == all-zero, and a
k-mer is `valid` iff all of its num_hash rows are nonzero.

The accumulators (stats, hist, over_col, over_freq) are updated IN PLACE
and returned, so callers keep the JAX package's call shape without paying
for a copy per chunk.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels
from .hash_torch import _KERNEL_CONSTS, M32, _to_i32, device_rows

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


def split_rows_wide(rows: np.ndarray, wpad: int):
    """Host-side split of int64 row indices [N, H] into the JAX package's
    (blk, lane0) int32 pair: row r's words start at lane lane0 of 128-word
    block blk. Valid while bloom_size * wpad < 2^38 (blk < 2^31)."""
    rpw = 128 // wpad
    blk = (rows // rpw).astype(np.int32)
    lane0 = ((rows % rpw) * np.int64(wpad)).astype(np.int32)
    return blk, lane0


def _unsplit_rows(blk: torch.Tensor, lane0: torch.Tensor, wpad: int):
    """The int64 rows of a (blk, lane0) split: blk * 128 + lane0 is the
    row's flat word offset r * wpad."""
    return (blk.to(torch.int64) * 128 + lane0) // wpad


def _and_over_hashes(g: torch.Tensor) -> torch.Tensor:
    """AND over the hash axis of gathered rows [N, H, W] -> [N, W]."""
    andw = g[:, 0]
    for h in range(1, g.shape[1]):
        andw = andw & g[:, h]
    return andw


def _and_present(blocks2, rows, wpad: int, rpb: int = 0):
    """AND over the hash axis + row presence. Returns (andw int32
    [N, wpad], present bool [N]). rpb > 0: blocked layout."""
    if rpb:
        g = _gather_rows_blocked(blocks2, rows, wpad, rpb)
    else:
        g = _gather_rows(blocks2, rows, wpad)
    return _and_over_hashes(g), (g != 0).any(dim=2).all(dim=1)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def new_accumulators(n_colors: int, wpad: int, capO: int, device):
    """Fresh (stats, hist, over_col, over_freq) for _accumulate_tail: zero
    counts, all-ones and-words, all-valid flag 1, n_over 0; empty histogram
    and zeroed overflow slots."""
    C = n_colors
    stats = torch.zeros(C + wpad + 2, dtype=torch.int32, device=device)
    stats[C : C + wpad] = -1  # and-words
    stats[C + wpad] = 1  # all-valid flag
    hist = torch.zeros((C, FREQ_CAP), dtype=torch.int32, device=device)
    oc_buf = torch.zeros(capO, dtype=torch.int32, device=device)
    of_buf = torch.zeros(capO, dtype=torch.int32, device=device)
    return stats, hist, oc_buf, of_buf


def _bit_counts(aw: torch.Tensor) -> torch.Tensor:
    """Per-bit sums over the rows of aw (int64 [N, W] u32 values): int64
    [W * 32], word-major, i.e. in color order."""
    return torch.stack(
        [((aw >> b) & 1).sum(dim=0) for b in range(32)], dim=1
    ).reshape(-1)


def _and_words(bit_counts: torch.Tensor, n_valid, W: int) -> torch.Tensor:
    """The AND over n_valid rows' words from their per-bit sums: bit b is
    set iff every row has it (all-ones when n_valid == 0). int64 [W]."""
    eq = (bit_counts.reshape(W, 32) == n_valid).to(torch.int64)
    return (eq << torch.arange(32, device=bit_counts.device)).sum(dim=1)


def _hits(aw: torch.Tensor):
    """(nhits, coloridx) per row of aw (int64 [N, W] u32 values): the set
    bits over all words, and the index of the lowest set bit of the first
    nonzero word (the hit color where nhits == 1; 0 where nhits == 0)."""
    nhits = _popcount32(aw).sum(dim=1)
    widx = (aw != 0).to(torch.int8).argmax(dim=1)
    word = aw.gather(1, widx[:, None])[:, 0]
    return nhits, widx * 32 + _popcount32(~word & (word - 1) & M32)


def query_batch(blocks2: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
                *, wpad: int, rpb: int = 0):
    """Score one batch of k-mers against the index: the single-batch step
    whose contract the sharded query_batch_colorshard / _rowshard share.

    rows int32 [N, H] Bloom rows per k-mer; mask bool [N] real-vs-padding.
    Returns (counts int32 [32 * wpad] per-color hits over the valid k-mers,
    uniq_color int32 [N] the color of a k-mer that hit exactly one, else
    -1, valid bool [N] all rows present and real, and_all int32 [wpad] the
    AND of the valid k-mers' words (all ones when none), all_valid bool
    0-d every real k-mer had all of its rows). rpb > 0: blocked layout."""
    andw, present = _and_present(blocks2, rows, wpad, rpb)
    valid = present & mask
    aw_v = torch.where(valid[:, None], andw.to(torch.int64) & M32, 0)
    counts = _bit_counts(aw_v)
    nhits, color = _hits(aw_v)
    uniq = torch.where(valid & (nhits == 1), color, -1).to(torch.int32)
    and_all = _to_i32(_and_words(counts, valid.sum(), wpad))
    return counts.to(torch.int32), uniq, valid, and_all, (present | ~mask).all()


def _accumulate_one(
    stats, hist, over_col, over_freq, blocks2, rows, mask, qcounts, wpad,
    base_idx, rpb=0, gidx=None,
):
    """The generic gather and the epilogue of one batch, in place on the
    accumulators (the contract of _accumulate_one_plain): rows int32 [N, H]
    (int64 past int32 row addressing), classic (rpb 0) or blocked (rpb rows
    a block, a power of two). qcounts: int32 frequencies clipped to 65535
    by the caller. Values >= FREQ_CAP route to the overflow list, which
    records the k-mer's GLOBAL index (base_idx + local), or gidx where
    given; the host resolves exact frequencies from its own copy.

    A CUDA tensor launches csrc/epilogue.cu's gather mode on the current
    stream: each k-mer's H rows are read from the matrix, ANDed and tested
    in the kernel, which then runs the AND-words pass; no gathered word or
    AND word is written. A CPU tensor takes the plain twin. Nothing here
    waits for the device. ``_accumulate_one.launches`` counts kernel
    launches (none for N = 0)."""
    dev = rows.device
    if dev.type == "cpu":
        return _accumulate_one_plain(
            stats, hist, over_col, over_freq, blocks2, rows, mask, qcounts, wpad,
            base_idx, rpb, gidx,
        )
    if dev.type != "cuda":
        raise ValueError(f"_accumulate_one: unsupported device {dev}")
    what = "_accumulate_one"
    if rows.dtype not in (torch.int32, torch.int64) or blocks2.dtype != torch.int32:
        raise TypeError(f"{what}: int32 or int64 rows and an int32 matrix")
    if blocks2.device != dev or not blocks2.is_contiguous():
        raise ValueError(f"{what}: the matrix must be contiguous on the rows' device")
    if rows.dim() != 2 or not 1 <= rows.shape[1] <= 32:
        raise ValueError(f"{what}: rows must be [N, H] with 1 <= H <= 32")
    if wpad < 1 or rpb < 0 or rpb & (rpb - 1):
        raise ValueError(f"{what}: wpad >= 1 and rpb 0 or a power of two")
    C = _check_epilogue(stats, hist, over_col, over_freq, dev, mask, qcounts, gidx, wpad, what)
    N, H = rows.shape
    if qcounts.shape != (N,):
        raise ValueError(f"{what}: mask, qcounts and gidx must be [N]")
    if N == 0:
        return stats, hist, over_col, over_freq
    rows, mask, qcounts = rows.contiguous(), mask.contiguous(), qcounts.contiguous()
    gidx = None if gidx is None else gidx.contiguous()
    scratch = _epilogue_scratch(N, dev)
    fn = kernels.kernel("epilogue_gather")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            rows.data_ptr(), int(rows.dtype == torch.int64), N, H, blocks2.data_ptr(),
            blocks2.numel(), wpad, rpb, mask.data_ptr(), qcounts.data_ptr(),
            None if gidx is None else gidx.data_ptr(), int(base_idx), C, stats.data_ptr(),
            hist.data_ptr(), over_col.data_ptr(), over_freq.data_ptr(), over_col.shape[0],
            scratch.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"epilogue kernel launch failed: CUDA error {err}")
    _accumulate_one.launches += 1
    return stats, hist, over_col, over_freq


_accumulate_one.launches = 0


def _accumulate_one_plain(
    stats, hist, over_col, over_freq, blocks2, rows, mask, qcounts, wpad,
    base_idx, rpb=0, gidx=None,
):
    """Plain PyTorch twin of _accumulate_one: the gather of each k-mer's H
    rows, their AND and presence (_and_present), then
    _accumulate_tail_plain."""
    andw, present = _and_present(blocks2, rows, wpad, rpb)
    return _accumulate_tail_plain(
        stats, hist, over_col, over_freq, andw, present, mask, qcounts,
        wpad, base_idx, gidx,
    )


def _accumulate_tail(
    stats, hist, over_col, over_freq, andw, present, mask, qcounts, wpad,
    base_idx, gidx=None,
):
    """Shared epilogue over pre-gathered per-k-mer AND words: counts,
    uniq-hit detection, frequency histogram/overflow, global AND (the
    contract of _accumulate_tail_plain), in place on the accumulators.

    A CUDA tensor launches csrc/epilogue.cu on the current stream; a CPU
    tensor takes the plain twin. Nothing here waits for the device.
    ``_accumulate_tail.launches`` counts kernel launches (none for N = 0)."""
    dev = andw.device
    if dev.type == "cpu":
        return _accumulate_tail_plain(
            stats, hist, over_col, over_freq, andw, present, mask, qcounts,
            wpad, base_idx, gidx,
        )
    if dev.type != "cuda":
        raise ValueError(f"_accumulate_tail: unsupported device {dev}")
    if andw.dim() != 2 or andw.shape[1] != wpad:
        raise ValueError(f"_accumulate_tail: andw must be [N, {wpad}]")
    if _epilogue(stats, hist, over_col, over_freq, andw, present, mask,
                 qcounts, base_idx, gidx, wpad, "_accumulate_tail"):
        _accumulate_tail.launches += 1
    return stats, hist, over_col, over_freq


_accumulate_tail.launches = 0


def _accumulate_sorted_words(
    stats, hist, over_col, over_freq, words_s, row_s, gidx_s, tb, reread, blocks2,
    mask, qcounts, base_idx, gidx=None, *, num_hash: int, tile_rows: int, nt: int,
):
    """_accumulate_tail over per-hash one-word rows (W = 1) that arrive in
    row order, as the classic stream's word kernel leaves them (the
    contract of _accumulate_sorted_words_plain). words_s, row_s int32 [P]
    and the sort's permutation gidx_s int64 [P] (probe gidx_s[j] belongs to
    k-mer gidx_s[j] // num_hash); tb int32 and reread bool [n_chunks], pc
    = P // n_chunks a power of two >= 4: chunk c read its words from rows
    [tb[c] * tile_rows, (tb[c] + nt) * tile_rows), and where reread[c] a
    probe outside that window reads its word again from blocks2. mask,
    qcounts, gidx [P // num_hash] in k-mer order.

    A CUDA tensor launches csrc/epilogue.cu's sorted-words mode: each
    probe's word ANDs into its k-mer's word in place (no un-sorted copy of
    the words is made), then the AND-words pass. A CPU tensor takes the
    plain twin. ``_accumulate_sorted_words.launches`` counts kernel
    launches (none for P = 0)."""
    dev = words_s.device
    if dev.type == "cpu":
        return _accumulate_sorted_words_plain(
            stats, hist, over_col, over_freq, words_s, row_s, gidx_s, tb, reread,
            blocks2, mask, qcounts, base_idx, gidx, num_hash=num_hash,
            tile_rows=tile_rows, nt=nt,
        )
    if dev.type != "cuda":
        raise ValueError(f"_accumulate_sorted_words: unsupported device {dev}")
    what = "_accumulate_sorted_words"
    P, H = words_s.shape[0], num_hash
    N = qcounts.shape[0]
    n_chunks = tb.shape[0]
    pc = P // n_chunks if n_chunks else 0
    if (words_s.dtype, row_s.dtype, gidx_s.dtype, tb.dtype, reread.dtype, blocks2.dtype) != (
        torch.int32, torch.int32, torch.int64, torch.int32, torch.bool, torch.int32
    ):
        raise TypeError(f"{what}: int32 words_s, row_s, tb, blocks2; int64 gidx_s; bool reread")
    plan = (words_s, row_s, gidx_s, tb, reread, blocks2)
    if any(t.device != dev for t in plan) or any(not t.is_contiguous() for t in plan):
        raise ValueError(f"{what}: the plan's tensors must be contiguous on one device")
    if (H < 1 or P != N * H or row_s.shape != (P,) or gidx_s.shape != (P,)
            or reread.shape != (n_chunks,) or pc * n_chunks != P
            or (P and (pc < 4 or pc & (pc - 1)))):
        raise ValueError(
            f"{what}: [P] words, rows and permutation for P = num_hash * N, and one tb "
            "and reread entry per chunk of a power-of-two >= 4 probes"
        )
    if any(t.data_ptr() % 16 for t in (words_s, row_s, gidx_s)):
        raise ValueError(f"{what}: words_s, row_s and gidx_s must be 16-byte aligned")
    C = _check_epilogue(stats, hist, over_col, over_freq, dev, mask, qcounts, gidx, 1, what)
    if P == 0:
        return stats, hist, over_col, over_freq
    mask, qcounts = mask.contiguous(), qcounts.contiguous()
    gidx = None if gidx is None else gidx.contiguous()
    acc = torch.empty(N, dtype=torch.int32, device=dev)
    present = torch.empty(N, dtype=torch.bool, device=dev)
    scratch = _epilogue_scratch(N, dev)
    fn = kernels.kernel("epilogue_sorted")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            words_s.data_ptr(), row_s.data_ptr(), gidx_s.data_ptr(), P, tb.data_ptr(),
            reread.data_ptr(), pc.bit_length() - 1, tile_rows, nt, blocks2.data_ptr(),
            blocks2.numel(), H, acc.data_ptr(), present.data_ptr(), mask.data_ptr(),
            qcounts.data_ptr(), None if gidx is None else gidx.data_ptr(), int(base_idx),
            C, stats.data_ptr(), hist.data_ptr(), over_col.data_ptr(),
            over_freq.data_ptr(), over_col.shape[0], scratch.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"epilogue kernel launch failed: CUDA error {err}")
    _accumulate_sorted_words.launches += 1
    return stats, hist, over_col, over_freq


_accumulate_sorted_words.launches = 0

EPI_TILE = 512  # rows per tile of csrc/epilogue.cu, at its narrowest


def _epilogue_scratch(N: int, dev) -> torch.Tensor:
    """csrc/epilogue.cu's scratch: two counters, a count per tile and a
    color a row."""
    return torch.empty(2 + -(-N // EPI_TILE) + N, dtype=torch.int32, device=dev)


def _check_epilogue(stats, hist, over_col, over_freq, dev, mask, qcounts, gidx,
                    W: int, what: str) -> int:
    """Check the accumulators and the per-k-mer inputs that every mode of
    csrc/epilogue.cu takes; returns the number of colors C."""
    accs = (stats, hist, over_col, over_freq)
    ins = [mask, qcounts] + ([] if gidx is None else [gidx])
    if any(t.device != dev for t in accs + tuple(ins)):
        raise ValueError(f"{what}: tensors on different devices")
    if any(t.dtype != torch.int32 for t in accs + (qcounts,)) or (
        gidx is not None and gidx.dtype != torch.int32
    ):
        raise TypeError(f"{what}: int32 frequencies, payloads and accumulators")
    if mask.dtype != torch.bool:
        raise TypeError(f"{what}: bool mask")
    if any(not t.is_contiguous() for t in accs):
        raise ValueError(f"{what}: the accumulators must be contiguous")
    C = stats.shape[0] - W - 2
    if (stats.dim() != 1 or not 0 <= C <= 32 * W or hist.shape != (C, FREQ_CAP)
            or over_col.dim() != 1 or over_freq.shape != over_col.shape):
        raise ValueError(f"{what}: accumulators out of shape for {C} colors, W {W}")
    if any(t.shape != qcounts.shape or t.dim() != 1 for t in ins):
        raise ValueError(f"{what}: mask, qcounts and gidx must be [N]")
    return C


def _epilogue(stats, hist, over_col, over_freq, andw, present, mask,
              qcounts, base_idx, gidx, W: int, what: str) -> bool:
    """Check the card's inputs and launch csrc/epilogue.cu's AND-words mode
    on AND words [N, W] with ``present``. Returns whether it launched
    (N > 0)."""
    dev = andw.device
    if andw.dtype != torch.int32 or present.dtype != torch.bool:
        raise TypeError(f"{what}: int32 AND words and bool present")
    if present.device != dev:
        raise ValueError(f"{what}: tensors on different devices")
    C = _check_epilogue(stats, hist, over_col, over_freq, dev, mask, qcounts, gidx, W, what)
    N = andw.shape[0]
    if qcounts.shape != (N,) or present.shape != (N,):
        raise ValueError(f"{what}: present, mask, qcounts and gidx must be [N]")
    if N == 0:
        return False
    andw, mask, qcounts = andw.contiguous(), mask.contiguous(), qcounts.contiguous()
    present = present.contiguous()
    gidx = None if gidx is None else gidx.contiguous()
    scratch = _epilogue_scratch(N, dev)
    fn = kernels.kernel("epilogue")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            andw.data_ptr(), present.data_ptr(), mask.data_ptr(), qcounts.data_ptr(),
            None if gidx is None else gidx.data_ptr(), int(base_idx), N, W, C,
            stats.data_ptr(), hist.data_ptr(), over_col.data_ptr(),
            over_freq.data_ptr(), over_col.shape[0], scratch.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"epilogue kernel launch failed: CUDA error {err}")
    return True


def _accumulate_sorted_words_plain(
    stats, hist, over_col, over_freq, words_s, row_s, gidx_s, tb, reread, blocks2,
    mask, qcounts, base_idx, gidx=None, *, num_hash: int, tile_rows: int, nt: int,
):
    """Plain PyTorch twin of _accumulate_sorted_words: the residual patch
    (a probe outside its chunk's window, in a chunk with reread, takes its
    word from the matrix), the un-sort to probe order by a scatter to the
    sort's permutation, then _accumulate_words_plain over each k-mer's
    num_hash words."""
    words_u = _patch_unsort_plain(words_s, row_s, gidx_s, tb, reread, blocks2,
                                  tile_rows=tile_rows, nt=nt)
    return _accumulate_words_plain(
        stats, hist, over_col, over_freq, words_u.view(-1, num_hash), mask,
        qcounts, base_idx, gidx,
    )


def _patch_unsort_plain(words_s, row_s, gidx_s, tb, reread, blocks2, *,
                        tile_rows: int, nt: int) -> torch.Tensor:
    """The sorted-words twin's first step: the words with the residual
    patch applied, back in probe order (int32 [P])."""
    n_chunks = tb.shape[0]
    if words_s.shape[0]:
        row = row_s.view(n_chunks, -1).to(torch.int64)
        lo = tb.to(torch.int64)[:, None] * tile_rows
        res = ((row < lo) | (row >= lo + nt * tile_rows)) & reread[:, None]
        fresh = blocks2.reshape(-1)[torch.where(res, row, 0)]
        words_s = torch.where(res, fresh, words_s.view(n_chunks, -1)).view(-1)
    words_u = torch.empty_like(words_s)
    words_u[gidx_s] = words_s
    return words_u


def _accumulate_words_plain(
    stats, hist, over_col, over_freq, wordsH, mask, qcounts, base_idx,
    gidx=None,
):
    """The AND of each k-mer's H one-word rows (wordsH int32 [N, H], in
    k-mer order) and its presence (every word nonzero), then
    _accumulate_tail_plain with W = 1."""
    andw = wordsH[:, 0]
    for h in range(1, wordsH.shape[1]):
        andw = andw & wordsH[:, h]
    present = (wordsH != 0).all(dim=1)
    return _accumulate_tail_plain(
        stats, hist, over_col, over_freq, andw[:, None], present, mask,
        qcounts, 1, base_idx, gidx,
    )


def _accumulate_tail_plain(
    stats, hist, over_col, over_freq, andw, present, mask, qcounts, wpad,
    base_idx, gidx=None,
):
    """Plain PyTorch twin of the epilogue kernel: counts, uniq-hit
    detection, frequency histogram/overflow, global AND.

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
    bit_counts = _bit_counts(aw_v)
    and_b = _and_words(bit_counts, valid.sum(), W)
    ok_b = (present | ~mask).all()

    # colors >= C are never set in a well-formed index; drop them anyway as
    # the JAX epilogue does (it slices the unpacked bits to [:, :C])
    lane_bit = torch.arange(W * 32, device=dev).reshape(W, 32)
    cmask = ((lane_bit < C).to(torch.int64) << torch.arange(32, device=dev)).sum(dim=1)
    aw_c = aw_v & cmask
    nhits, coloridx = _hits(aw_c)
    uniq_mask = valid & (nhits == 1)

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


def query_accumulate_scan_wide(
    stats, hist, over_col, over_freq, blocks2,
    blk: torch.Tensor,  # int32 [n, H] block index (split_rows_wide)
    lane0: torch.Tensor,  # int32 [n, H] first lane of the row's words
    mask: torch.Tensor,  # bool [n]
    qcounts: torch.Tensor,  # int32 [n], clipped frequencies
    base0: int,  # global index of blk[0]
    *,
    wpad: int,
    chunk: int,
):
    """query_accumulate_scan over the JAX package's (block, lane) split of
    rows past int32 addressing (bloom_size >= 2^31; split_rows_wide). The
    reference accepts any usize bloom size (src/main.rs:475-477,
    src/bigsi.rs:20-27); the engine passes such rows as int64 straight to
    query_accumulate_scan."""
    return query_accumulate_scan(
        stats, hist, over_col, over_freq, blocks2,
        _unsplit_rows(blk, lane0, wpad), mask, qcounts, base0,
        wpad=wpad, chunk=chunk,
    )


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


# -- read classifier (read_id hot loop) ---------------------------------------

PAD_POS = 2**30  # kmer_pos for padding slots: never counted
BIG = 2**30  # first-absent / first-hit position meaning "never"


def _unpack_bits(words: torch.Tensor, n_colors: int) -> torch.Tensor:
    """int32 [N, W] bit views -> int32 bits [N, n_colors] (LSB-first,
    color order). (x >> s) & 1 is bit s also where the view is negative."""
    N, W = words.shape
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(N, W * 32)[:, :n_colors]


def _decode_ranks(ranks: torch.Tensor):
    """Rank-plane decode for the reads-path queries: int16 uses -1 as the
    no-rank marker; uint8 (the halved-H2D encoding, pipelines/read_id.py)
    uses 255. Returns (rank int32, live bool)."""
    rk = ranks.to(torch.int32)
    if ranks.dtype == torch.uint8:
        return rk, rk != 255
    return rk, rk >= 0


def _seg_min(values: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Per-segment minimum of int32 values [N] or [N, C], BIG where a
    segment (a read) has none."""
    out = torch.full((n_seg,) + values.shape[1:], BIG, dtype=torch.int32,
                     device=values.device)
    idx = seg.to(torch.int64)
    if values.dim() == 2:
        idx = idx[:, None].expand(-1, values.shape[1])
    return out.scatter_reduce_(0, idx, values, "amin", include_self=True)


def _seg_sum(values: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Per-segment sum of int32 values [N, C] (integer, so exact)."""
    out = torch.zeros((n_seg,) + values.shape[1:], dtype=torch.int32,
                      device=values.device)
    return out.index_add_(0, seg.to(torch.int64), values)


# Kernel H (csrc/readid.cu): the read classifier's dispatches. Its modes, as
# readid_launches counts them: the order-free pass, the exact replay's
# counts and its first hits.
READID_MODES = ("orderfree", "replay", "firsthit")
readid_launches = dict.fromkeys(READID_MODES, 0)
READID_SET_SMEM = 1 << 17  # bytes of a read's hash set kept in shared memory
READID_SMEM = 200 * 1024  # dynamic shared memory a block of the order-free mode may take
READID_THREADS = 256  # csrc/readid.cu THREADS: a block of the order-free mode


def readid_orderfree_plan(R: int, WR: int, C: int, sms: int) -> dict:
    """Kernel H's order-free launch for R reads of WR keys and C colors on a
    card of ``sms`` SMs: a block of READID_THREADS threads a read (a window
    a thread, ``rounds`` rounds of them), its hash set of 2^``set_log2`` >=
    2 WR slots (8 bytes each) in shared memory, or past READID_SET_SMEM in
    device memory (``gset``: one set for each of ``grid`` resident blocks);
    ``cnt_global``: C int32 counts that do not fit beside the set live in
    the output row; ``smem``: a block's dynamic shared memory, the set
    (unless gset) and the counts (unless cnt_global)."""
    set_log2 = (2 * WR - 1).bit_length()
    gset = 8 << set_log2 > READID_SET_SMEM
    smem = 0 if gset else 8 << set_log2
    cnt_global = smem + 4 * C > READID_SMEM
    smem += 0 if cnt_global else 4 * C
    grid = min(R, 2 * sms) if gset else min(R, 1 << 20)
    return dict(set_log2=set_log2, gset=gset, cnt_global=cnt_global, smem=smem,
                grid=max(grid, 1), rounds=-(-WR // READID_THREADS))


def _check_matrix(blocks2, dev, wpad: int, rpb: int, num_colors: int, what: str) -> None:
    if blocks2.dtype != torch.int32 or blocks2.dim() != 2 or blocks2.shape[1] != 128:
        raise ValueError(f"{what}: blocks2 must be the int32 [Rb, 128] block matrix")
    if blocks2.device != dev or not blocks2.is_contiguous():
        raise ValueError(f"{what}: blocks2 must be contiguous on the queries' device")
    if wpad < 1 or not 0 <= num_colors <= 32 * wpad:
        raise ValueError(f"{what}: needs wpad >= 1 and 0 <= num_colors <= 32 * wpad")
    if rpb < 0 or rpb & (rpb - 1) or rpb * wpad > 128:
        raise ValueError(f"{what}: rpb must be 0 or a power of two with rpb * wpad <= 128")


def _check_orderfree(keys, blocks2, *, num_colors, wpad, k, num_hash, bloom_size,
                     rpb, bv) -> None:
    """What kernel H's order-free mode takes (raises where a CUDA call would
    break it)."""
    from .hash_torch import _check_placement

    what = "readid_orderfree"
    if keys.dtype != torch.int64 or keys.dim() != 2 or not keys.is_contiguous():
        raise ValueError(f"{what}: keys must be contiguous int64 [num_reads, WR]")
    if keys.shape[1] < 1 or 2 * keys.shape[1] > 1 << 30:
        raise ValueError(f"{what}: needs 1 <= WR <= 2^29 windows a read")
    _check_matrix(blocks2, keys.device, wpad, rpb, num_colors, what)
    _check_placement(keys.reshape(-1), k, num_hash, bloom_size, rpb, bv, False)
    if num_hash > 32:
        raise ValueError(f"{what}: at most 32 hashes")
    words = (bloom_size // rpb) * 128 if rpb else bloom_size * wpad
    if words > blocks2.numel():
        raise ValueError(f"{what}: bloom_size {bloom_size} rows exceed the matrix")


def readid_orderfree(keys: torch.Tensor, blocks2: torch.Tensor, *, num_colors: int,
                     wpad: int, k: int, num_hash: int, bloom_size: int, rpb: int = 0,
                     bv: int = 1) -> torch.Tensor:
    """Kernel H's order-free mode: per read (a row of keys, int64 [R, WR]
    sort keys of its windows, SENT_KEY where a window does not count) its
    distinct keys' per-color counts over the present k-mers, any absent,
    D and the zero-hit count: int32 [R, C + 3] (query_readid_orderfree_
    reads' contract).

    A CUDA tensor launches csrc/readid.cu (a block a read, as
    ``readid_orderfree_plan`` lays it out: a hash set of the keys, then
    placement, gather and counts of each distinct one) on the current
    stream; a CPU tensor takes the plain twin
    ``_orderfree_plain``. Launches count in ``readid_launches["orderfree"]``
    and ``readid_orderfree.launches``."""
    kw = dict(num_colors=num_colors, wpad=wpad, k=k, num_hash=num_hash,
              bloom_size=bloom_size, rpb=rpb, bv=bv)
    dev = keys.device
    if dev.type == "cpu":
        return _orderfree_plain(keys, blocks2, **kw)
    if dev.type != "cuda":
        raise ValueError(f"readid_orderfree: unsupported device {dev}")
    _check_orderfree(keys, blocks2, **kw)
    R, WR = keys.shape
    C = num_colors
    out = torch.empty((R, C + 3), dtype=torch.int32, device=dev)
    if R == 0:
        return out
    plan = readid_orderfree_plan(R, WR, C,
                                 torch.cuda.get_device_properties(dev).multi_processor_count)
    grid, set_log2 = plan["grid"], plan["set_log2"]
    gset = None
    if plan["gset"]:  # one set in device memory for each resident block
        gset = torch.empty(grid << set_log2, dtype=torch.int64, device=dev)
    fn = kernels.kernel("readid_orderfree")
    consts = (ctypes.c_uint64 * len(_KERNEL_CONSTS))(*_KERNEL_CONSTS)
    with torch.cuda.device(dev):
        err = fn(
            keys.data_ptr(), R, WR, set_log2, None if gset is None else gset.data_ptr(),
            grid, int(plan["cnt_global"]), plan["smem"], blocks2.data_ptr(), blocks2.numel(),
            wpad, C, out.data_ptr(), k, num_hash, bv if rpb else 0, bloom_size, rpb,
            ctypes.addressof(consts), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"readid kernel (order-free) launch failed: CUDA error {err}")
    readid_launches["orderfree"] += 1
    readid_orderfree.launches += 1
    return out


readid_orderfree.launches = 0


def _check_exact(blocks2, rows, seg_ids, kmer_pos, *, num_reads, num_colors, wpad,
                 rpb) -> None:
    """What kernel H's replay and first-hit modes take (raises where a CUDA
    call would break it)."""
    what = "readid_exact"
    if rows.dtype not in (torch.int32, torch.int64) or rows.dim() != 2 or rows.shape[1] < 1:
        raise ValueError(f"{what}: rows must be int32 or int64 [N, H]")
    if rows.shape[1] > 32:
        raise ValueError(f"{what}: at most 32 hashes")
    N = rows.shape[0]
    for name, t in (("seg_ids", seg_ids), ("kmer_pos", kmer_pos)):
        if t.dtype != torch.int32 or t.shape != (N,):
            raise ValueError(f"{what}: {name} must be int32 [N] beside rows [N, H]")
    if any(t.device != rows.device or not t.is_contiguous()
           for t in (rows, seg_ids, kmer_pos)):
        raise ValueError(f"{what}: rows, seg_ids and kmer_pos must be contiguous on one device")
    if num_reads < 0:
        raise ValueError(f"{what}: num_reads must be >= 0")
    _check_matrix(blocks2, rows.device, wpad, rpb, num_colors, what)


def readid_exact(blocks2: torch.Tensor, rows: torch.Tensor, seg_ids: torch.Tensor,
                 kmer_pos: torch.Tensor, *, num_reads: int, start_sample: int,
                 num_colors: int, wpad: int, rpb: int = 0,
                 firsthit: bool = False) -> torch.Tensor:
    """Kernel H's exact replay: per read, its counts and no_hits (int32
    [num_reads, C + 1], query_readid_batch's contract) or, with
    ``firsthit``, each color's first phase-1 hit and the first absent
    position (query_readid_firsthit's). rows int32 or int64 [N, H], seg_ids
    int32 [N] in [0, num_reads) in any order, kmer_pos int32 [N] (>= PAD_POS:
    padding).

    A CUDA tensor launches csrc/readid.cu on the current stream (an init
    launch, the first-absent pass, which gathers each k-mer's rows once
    into an AND-word scratch, then one counting pass, two with B > 0, on
    that scratch; all per-read reductions are integer atomics, aggregated
    in the warp); a CPU tensor takes the plain
    twin ``_readid_core_plain`` / ``_readid_firsthit_core_plain``. Launches
    count in ``readid_launches["replay"]`` / ``["firsthit"]`` and in
    ``readid_exact.launches``."""
    kw = dict(num_reads=num_reads, start_sample=start_sample, num_colors=num_colors,
              wpad=wpad, rpb=rpb)
    dev = rows.device
    if dev.type == "cpu":
        twin = _readid_firsthit_core_plain if firsthit else _readid_core_plain
        return twin(blocks2, rows, seg_ids, kmer_pos, **kw)
    if dev.type != "cuda":
        raise ValueError(f"readid_exact: unsupported device {dev}")
    _check_exact(blocks2, rows, seg_ids, kmer_pos, num_reads=num_reads,
                 num_colors=num_colors, wpad=wpad, rpb=rpb)
    C, R = num_colors, num_reads
    out = torch.empty((R, C + 1), dtype=torch.int32, device=dev)
    if R == 0:
        return out
    N, H = rows.shape
    andw = torch.empty((N, wpad), dtype=torch.int32, device=dev)  # the AND words
    fa = cand = None
    if not firsthit:
        fa = torch.empty(R, dtype=torch.int32, device=dev)
        if start_sample > 0:
            cand = torch.empty((R, wpad), dtype=torch.int32, device=dev)
    fn = kernels.kernel("readid_exact")
    with torch.cuda.device(dev):
        err = fn(
            rows.data_ptr(), int(rows.dtype == torch.int64), seg_ids.data_ptr(),
            kmer_pos.data_ptr(), N, H, blocks2.data_ptr(), blocks2.numel(), wpad, rpb, C,
            max(start_sample, 0), R, int(firsthit), out.data_ptr(),
            None if fa is None else fa.data_ptr(), None if cand is None else cand.data_ptr(),
            andw.data_ptr() if N else None, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"readid kernel (replay) launch failed: CUDA error {err}")
    readid_launches["firsthit" if firsthit else "replay"] += 1
    readid_exact.launches += 1
    return out


readid_exact.launches = 0


def _first_absent(present, seg_ids, kmer_pos, num_reads: int):
    """(first absent k-mer position per read (BIG = none), counted bool
    [N]): a k-mer counts when all its rows are present and it comes
    strictly before its read's first absent k-mer (the reference breaks
    out of the read's k-mer loop there)."""
    first_absent = _seg_min(torch.where(present, BIG, kmer_pos), seg_ids, num_reads)
    counted = present & (kmer_pos < first_absent[seg_ids.to(torch.int64)])
    return first_absent, counted


def query_readid_batch(
    blocks2: torch.Tensor,
    rows: torch.Tensor,
    seg_ids: torch.Tensor,
    kmer_pos: torch.Tensor,
    *,
    num_reads: int,
    start_sample: int,
    num_colors: int,
    wpad: int,
    rpb: int = 0,
):
    """Per-read hit-count matrix for the read classifier (read_id).

    Replicates search_index / search_index_classic (read_id_mt_pe.rs:66-165)
    over a flattened batch of reads:

    - k-mers of all reads are concatenated; ``seg_ids`` maps each k-mer to
      its read, ``kmer_pos`` is its insertion-order position within the read.
    - a k-mer with any absent row makes the read count one ``no_hits``
      pseudo-color AND stops counting for every later k-mer of that read
      (the reference `break`s out of the k-mer loop).
    - with start_sample B > 0, k-mers at positions >= B only count toward
      colors already hit by the first B k-mers (the candidate set).

    Args: rows int32 [N, H]; seg_ids int32 [N] read per k-mer; kmer_pos
    int32 [N] (PAD_POS marks padding). Returns int32 [num_reads, C+1]
    per-read per-color counts; column C is the no_hits pseudo-color.
    """
    return readid_exact(
        blocks2, rows, seg_ids, kmer_pos,
        num_reads=num_reads, start_sample=start_sample,
        num_colors=num_colors, wpad=wpad, rpb=rpb,
    )


def _readid_core_plain(
    blocks2, rows, seg_ids, kmer_pos, *, num_reads, start_sample,
    num_colors, wpad, rpb=0,
):
    """Plain PyTorch twin of kernel H's replay mode (``readid_exact``)."""
    andw, present = _and_present(blocks2, rows, wpad, rpb)
    bits = _unpack_bits(andw, num_colors)  # [N, C]
    first_absent, counted = _first_absent(present, seg_ids, kmer_pos, num_reads)
    report = _readid_report(bits, counted, seg_ids, kmer_pos, num_reads, start_sample)
    no_hits = (first_absent < BIG).to(torch.int32)[:, None]
    return torch.cat([report, no_hits], dim=1)


def _readid_report(bits, counted, seg_ids, kmer_pos, num_reads: int,
                   start_sample: int):
    """Per-read hit counts [num_reads, C] from the color bits [N, C] of
    the counted k-mers; with start_sample B > 0, k-mers at positions >= B
    count only toward colors the read's first B k-mers hit (the candidate
    set, a per-color fact: a color shard computes it from its own bits)."""
    cbits = bits * counted[:, None]
    if start_sample > 0:
        phase1 = cbits * (kmer_pos < start_sample)[:, None]
        # candidate set: colors hit within the first B k-mers
        cand = _seg_sum(phase1, seg_ids, num_reads).clamp_(max=1)
        phase2 = cbits * (kmer_pos >= start_sample)[:, None]
        contrib = phase1 + phase2 * cand[seg_ids.to(torch.int64)]
    else:
        contrib = cbits
    return _seg_sum(contrib, seg_ids, num_reads)


def query_readid_firsthit(
    blocks2: torch.Tensor,
    rows: torch.Tensor,
    seg_ids: torch.Tensor,
    kmer_pos: torch.Tensor,
    *,
    num_reads: int,
    start_sample: int,
    num_colors: int,
    wpad: int,
    rpb: int = 0,
):
    """First-hit k-mer position per (read, color): the insertion order of
    the reference's ``final_report`` FnvHashMap (read_id_mt_pe.rs:127-139:
    colors enter the map at their first phase-1/classic hit, ascending color
    within one k-mer; ``no_hits`` enters at the break). Column C carries the
    first-absent position. 2**30 where never hit. Used by the read_id tie
    fixup to reconstruct kmer_poll_plus's stable-sort order for tied top
    hits (read_id_mt_pe.rs:195-196)."""
    return readid_exact(
        blocks2, rows, seg_ids, kmer_pos,
        num_reads=num_reads, start_sample=start_sample,
        num_colors=num_colors, wpad=wpad, rpb=rpb, firsthit=True,
    )


def _readid_firsthit_core_plain(
    blocks2, rows, seg_ids, kmer_pos, *, num_reads, start_sample,
    num_colors, wpad, rpb=0,
):
    """Plain PyTorch twin of kernel H's first-hit mode (``readid_exact``
    with ``firsthit``)."""
    andw, present = _and_present(blocks2, rows, wpad, rpb)
    bits = _unpack_bits(andw, num_colors)
    first_absent, counted = _first_absent(present, seg_ids, kmer_pos, num_reads)
    fh = _firsthit_report(bits, counted, seg_ids, kmer_pos, num_reads, start_sample)
    return torch.cat([fh, first_absent[:, None]], dim=1)


def _firsthit_report(bits, counted, seg_ids, kmer_pos, num_reads: int,
                     start_sample: int):
    """First-hit position [num_reads, C] of each color (BIG = never) from
    the color bits [N, C] of the counted k-mers."""
    # only phase-1 hits insert report keys (phase 2 increments existing)
    ph1 = counted & (kmer_pos < start_sample) if start_sample > 0 else counted
    pos_hit = torch.where((bits > 0) & ph1[:, None], kmer_pos[:, None], BIG)
    return _seg_min(pos_hit, seg_ids, num_reads)


def query_readid_batch_wide(
    blocks2: torch.Tensor,
    blk: torch.Tensor,  # int32 [N, H] (split_rows_wide)
    lane0: torch.Tensor,  # int32 [N, H]
    seg_ids: torch.Tensor,
    kmer_pos: torch.Tensor,
    *,
    num_reads: int,
    start_sample: int,
    num_colors: int,
    wpad: int,
):
    """query_readid_batch over the (block, lane) split of rows past int32
    addressing (split_rows_wide)."""
    return query_readid_batch(
        blocks2, _unsplit_rows(blk, lane0, wpad), seg_ids, kmer_pos,
        num_reads=num_reads, start_sample=start_sample,
        num_colors=num_colors, wpad=wpad,
    )


def query_readid_firsthit_wide(
    blocks2: torch.Tensor,
    blk: torch.Tensor,
    lane0: torch.Tensor,
    seg_ids: torch.Tensor,
    kmer_pos: torch.Tensor,
    *,
    num_reads: int,
    start_sample: int,
    num_colors: int,
    wpad: int,
):
    """query_readid_firsthit over the (block, lane) split of rows past int32
    addressing (split_rows_wide)."""
    return query_readid_firsthit(
        blocks2, _unsplit_rows(blk, lane0, wpad), seg_ids, kmer_pos,
        num_reads=num_reads, start_sample=start_sample,
        num_colors=num_colors, wpad=wpad,
    )


def query_readid_hash_batch(
    blocks2: torch.Tensor,
    packed: torch.Tensor,  # int32 [N, 2] 2-bit packed canonical k-mers
    seg_ids16: torch.Tensor,  # int16 [N]
    kmer_pos16: torch.Tensor,  # int16 [N]; -1 marks padding
    *,
    num_reads: int,
    start_sample: int,
    num_colors: int,
    wpad: int,
    k: int,
    num_hash: int,
    bloom_size: int,
    rpb: int = 0,
    bv: int = 1,
):
    """query_readid_batch with device hashing: the host ships 12 B per
    k-mer (packed key + int16 seg/pos) instead of 24 B."""
    rows = device_rows(packed, k=k, num_hash=num_hash, bloom_size=bloom_size,
                       rpb=rpb, version=bv)
    p16 = kmer_pos16.to(torch.int32)
    return readid_exact(
        blocks2, rows, seg_ids16.to(torch.int32), torch.where(p16 < 0, PAD_POS, p16),
        num_reads=num_reads, start_sample=start_sample,
        num_colors=num_colors, wpad=wpad, rpb=rpb,
    )


def pad_rows(rows: np.ndarray, n_pad: int) -> np.ndarray:
    """Pad a row-index batch to a fixed shape with index 0 (harmless: padding
    is excluded via seg_ids/valid masks by callers)."""
    if rows.shape[0] == n_pad:
        return rows
    out = np.zeros((n_pad, rows.shape[1]), dtype=rows.dtype)
    out[: rows.shape[0]] = rows
    return out


def _reads_rows_seg_pos(mates_packed, mate_seg16, lens, ranks16, *, k, L,
                        num_hash, bloom_size, rpb, bv):
    """Rows, read ids and set ranks of every window of 2-bit packed mates
    (the reads path): a window counts where it fits the mate, its rank is
    live and the mate is not padding (mate_seg -1); else its position is
    PAD_POS."""
    from .extract import window_keys

    M = mates_packed.shape[0]
    NW = L - k + 1
    # every window's key: the read length L for all, no validity plane
    full = torch.full((M,), L, dtype=torch.int32, device=mates_packed.device)
    keys = window_keys(mates_packed, full, k=k, L=L)  # [M, NW]
    w_idx = torch.arange(NW, dtype=torch.int32, device=keys.device)[None, :]
    rk, rk_live = _decode_ranks(ranks16)
    live = (w_idx + k <= lens.to(torch.int32)[:, None]) & rk_live \
        & (mate_seg16 >= 0)[:, None]
    pos = torch.where(live, rk, PAD_POS).reshape(-1)
    seg = mate_seg16.to(torch.int32).clamp(min=0)
    seg = seg[:, None].expand(M, NW).reshape(-1)
    rows = device_rows(keys.reshape(-1), k=k, num_hash=num_hash,
                       bloom_size=bloom_size, rpb=rpb, version=bv)
    return rows, seg, pos


def query_readid_reads_batch(
    blocks2: torch.Tensor,
    mates_packed: torch.Tensor,  # int32 [M, ceil(L/16)] 2-bit mate words
    mate_seg16: torch.Tensor,  # int16 [M] read id per mate (-1 = padding)
    lens: torch.Tensor,  # int32 [M] true mate lengths
    ranks16: torch.Tensor,  # int16 (-1 = none) or uint8 (255 = none)
    #                         [M, L-k+1] per-window set rank plane
    *,
    num_reads: int,
    start_sample: int,
    num_colors: int,
    wpad: int,
    k: int,
    L: int,
    num_hash: int,
    bloom_size: int,
    rpb: int = 0,
    bv: int = 1,
):
    """query_readid_batch where the device re-derives every canonical k-mer
    window from 2-bit packed mates (ops/extract.py machinery): the host
    ships ~0.25 B per base plus a rank plane per window instead of 12 B per
    unique k-mer (native ct_read_rank_windows computes the ranks, the
    FnvHashSet iteration order the break/-B logic needs, and marks
    duplicate/skipped windows as no-rank, which become padding here)."""
    rows, seg, pos = _reads_rows_seg_pos(
        mates_packed, mate_seg16, lens, ranks16, k=k, L=L, num_hash=num_hash,
        bloom_size=bloom_size, rpb=rpb, bv=bv,
    )
    return readid_exact(
        blocks2, rows, seg, pos,
        num_reads=num_reads, start_sample=start_sample,
        num_colors=num_colors, wpad=wpad, rpb=rpb,
    )


def query_readid_orderfree_reads(
    blocks2: torch.Tensor,
    mates_packed: torch.Tensor,  # int32 [M, ceil(L/16)]; M = num_reads * nm
    lens: torch.Tensor,  # int32 [M] true mate lengths
    valid_bits: torch.Tensor,  # int32 [M, ceil(L/32)] per-base validity
    *,
    num_reads: int,
    num_colors: int,
    wpad: int,
    k: int,
    L: int,
    nm: int,  # mates per read (uniform)
    d: int,
    num_hash: int,
    bloom_size: int,
    rpb: int = 0,
    bv: int = 1,
):
    """ORDER-FREE read classifier pass: full per-read per-color counts with
    no break-on-absent and no -B candidate phase, plus the facts that decide
    whether the exact set-order replay is needed at all.

    The reference's per-read result depends on FnvHashSet iteration order
    only through (a) the break at the first absent k-mer
    (read_id_mt_pe.rs:88-89) and (b) the first-B candidate set
    (read_id_mt_pe.rs:115-139). pipelines/read_id.py::_resolve_orderfree
    decides from this pass's outputs whether ANY iteration order could
    change the outcome; only the reads that fail it replay the exact order.

    The per-read k-mer SET is recovered on device: kernel B's window keys
    (ops/extract.py::window_keys), then kernel H's order-free mode
    (``readid_orderfree``) dedups each read's keys, places, gathers and
    counts them.

    Returns int32 [num_reads, C + 3]: columns 0..C-1 = full counts,
    column C = 1 if any distinct k-mer had an absent row, column C+1 = D
    (distinct valid k-mer count), column C+2 = number of distinct k-mers
    whose rows are all present but whose AND hits no color (these can make
    the first-B candidate set empty under some orders).
    """
    from .extract import window_keys

    keys = window_keys(mates_packed, lens, valid_bits, k=k, L=L, d=d)
    return readid_orderfree(
        keys.reshape(num_reads, nm * (L - k + 1)), blocks2, num_colors=num_colors,
        wpad=wpad, k=k, num_hash=num_hash, bloom_size=bloom_size, rpb=rpb, bv=bv,
    )


def _orderfree_plain(keys, blocks2, *, num_colors, wpad, k, num_hash, bloom_size,
                     rpb=0, bv=1):
    """Plain PyTorch twin of kernel H's order-free mode (``readid_orderfree``):
    each read's keys sort (any exact dedupe gives the same outputs) and
    repeats and SENT keys are masked."""
    from .extract import SENT_KEY

    num_reads, WR = keys.shape
    s = torch.sort(keys, dim=1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    uniq = first & (s != SENT_KEY)
    rows = device_rows(s.reshape(-1), k=k, num_hash=num_hash,
                       bloom_size=bloom_size, rpb=rpb, version=bv)
    andw, present = _and_present(blocks2, rows, wpad, rpb)
    u = uniq.reshape(-1)
    counted = u & present
    bits = _unpack_bits(andw, num_colors)
    cbits = bits * counted[:, None]
    # windows are contiguous per read: a reshape-reduce, no segment scatter
    report = cbits.reshape(num_reads, WR, num_colors).sum(dim=1, dtype=torch.int32)
    absent = (u & ~present).reshape(num_reads, WR).any(dim=1)
    zerohit = (counted & (bits.sum(dim=1) == 0)).reshape(num_reads, WR).sum(
        dim=1, dtype=torch.int32
    )
    D = uniq.sum(dim=1, dtype=torch.int32)
    return torch.cat(
        [report, absent.to(torch.int32)[:, None], D[:, None], zerohit[:, None]],
        dim=1,
    )


def query_readid_firsthit_reads(
    blocks2: torch.Tensor,
    mates_packed: torch.Tensor,  # int32 [M, ceil(L/16)]
    mate_seg16: torch.Tensor,  # int16 [M]; -1 = padding
    lens: torch.Tensor,  # int32 [M]
    ranks16: torch.Tensor,  # int16 or uint8 [M, L-k+1]
    *,
    num_reads: int,
    start_sample: int,
    num_colors: int,
    wpad: int,
    k: int,
    L: int,
    num_hash: int,
    bloom_size: int,
    rpb: int = 0,
    bv: int = 1,
):
    """query_readid_firsthit with device-side window extraction (the
    reads-path twin of query_readid_reads_batch): feeds the read_id
    tie-order fixup without any host k-mer work."""
    rows, seg, pos = _reads_rows_seg_pos(
        mates_packed, mate_seg16, lens, ranks16, k=k, L=L, num_hash=num_hash,
        bloom_size=bloom_size, rpb=rpb, bv=bv,
    )
    return readid_exact(
        blocks2, rows, seg, pos,
        num_reads=num_reads, start_sample=start_sample,
        num_colors=num_colors, wpad=wpad, rpb=rpb, firsthit=True,
    )
