"""Sorted-probe streams: the classic (reference-placement) row stream and
the blocked (split-lane) probe stream.

Classic. The classic layout (simple_bloom.rs:19-26) places a k-mer's H rows
independently: row_i = xxh3_64_with_seed(kmer, i) % bloom_size. This path
flattens the H*P row probes, sorts them by row, pulls each probe's single
u32 row word through the classic word kernel (csrc/classic_word.cu), patches
the probes that fell outside their chunk's window, un-sorts the words back
to probe order and recombines each k-mer's H words with the shared
AND/count/histogram epilogue (ops/query.py::_accumulate_tail).

Blocked. The blocked layouts v2/v3/v4 (ops/blocked.py) keep a k-mer's H
rows in one 512-byte block, hash h in its own lane group. This path hashes
on the device to (block, H in-block offsets), sorts the probes by block,
and hands them to the probe kernel (csrc/stream_probe.cu), which gathers
each probe's rows, ANDs them and accumulates the per-color counts and the
uniq-hit frequency histogram; the plan around the kernel (chunk windows, a
chunk-granular residual pass through the generic gather, the overflow list
for frequencies the histogram does not cover) is the JAX package's, so all
accumulators agree with it field by field.

Sorting reorders probes, which is sound because every accumulated statistic
is permutation-invariant (blocked) or taken after the words are back in
probe order (classic).
"""

from __future__ import annotations

import torch

from . import kernels
from .hash_torch import M32, bloom_rows_device, device_blkoff
from .query import (
    FREQ_CAP,
    _accumulate_one,
    _accumulate_tail,
    _and_over_hashes,
    _and_words,
    _bit_counts,
    _gather_rows_blocked,
    _hits,
    _popcount32,
    _to_i32,
)

T = 128  # matrix tile rows (512-byte blocks)
# probes per kernel chunk: each chunk reads one NT_CL-tile window of the matrix
PC_CL = 4096
# residual chunk capacity (chunk-granular re-run of out-of-window probes);
# a batch with more residual chunks reports n_drop > 0 and the caller
# re-runs it through the generic gather
NCH_CL = 128
# padding unit of a stream batch: callers pad k-mer counts to a multiple
EPC_CL = 262144
NT_CL = 2  # tiles per chunk window


def _n_planes(n_colors: int) -> int:
    """Low bytes of a single-word row that can hold color bits."""
    return min(4, (n_colors + 7) // 8)


def _deoffset(planes: int) -> int:
    """The out-of-window word: the JAX kernel's sum over its gathered byte
    planes of the +128 de-offset corrections, as an int32 bit pattern."""
    v = sum(128 * (1 << (8 * p)) for p in range(planes))
    return v - (1 << 32) if v >= (1 << 31) else v


def _word_mask(planes: int) -> int:
    return 0xFFFFFFFF if planes >= 4 else (1 << (8 * planes)) - 1


def classic_words_plain(blocks2, row_s, tb, *, planes: int):
    """Plain PyTorch twin of the classic word kernel (same contract): for
    each sorted row probe, the matrix word at that row masked to its low
    8*planes bits when its block (row >> 7) lies in its chunk's NT_CL-tile
    window starting at block tb[chunk]*128, else the constant
    _deoffset(planes)."""
    base = tb.to(torch.int64).repeat_interleave(PC_CL) * T
    row = row_s.to(torch.int64)
    blk = row >> 7
    flat = blocks2.reshape(-1)
    inwin = (blk - base >= 0) & (blk - base < NT_CL * T) & (row < flat.shape[0])
    word = flat[torch.where(inwin, row, 0)]
    if planes < 4:
        word = word & _word_mask(planes)
    return torch.where(inwin, word, _deoffset(planes)).to(torch.int32)


def classic_words(blocks2, row_s, tb, *, planes: int):
    """Per sorted probe, its classic row word (int32 [P]).

    blocks2 int32 [Rb, 128] (the matrix, wpad == 1), row_s int32 [P] the
    probes' rows sorted ascending, P % PC_CL == 0, tb int32 [P // PC_CL]
    the first tile of each chunk's window. A CUDA tensor launches
    csrc/classic_word.cu (row_s must be 16-byte aligned); a CPU tensor
    takes the plain twin. ``classic_words.launches`` counts kernel
    launches."""
    P = row_s.shape[0]
    tensors = (blocks2, row_s, tb)
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError("classic_words takes int32 tensors")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("classic_words takes contiguous tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("classic_words: tensors on different devices")
    if blocks2.dim() != 2 or blocks2.shape[1] != 128:
        raise ValueError("classic_words: blocks2 must be [Rb, 128]")
    if row_s.dim() != 1 or P % PC_CL or tb.shape != (P // PC_CL,):
        raise ValueError(
            f"classic_words: P must be a multiple of {PC_CL} with one tb "
            "entry per chunk"
        )
    if not 1 <= planes <= 4:
        raise ValueError("classic_words: planes must be in 1..4")
    dev = row_s.device
    if dev.type == "cpu":
        return classic_words_plain(blocks2, row_s, tb, planes=planes)
    if dev.type != "cuda":
        raise ValueError(f"classic_words: unsupported device {dev}")
    if row_s.data_ptr() % 16:
        raise ValueError("classic_words: row_s must be 16-byte aligned")
    out = torch.empty(P, dtype=torch.int32, device=dev)
    fn = kernels.kernel("classic_word")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            blocks2.data_ptr(), blocks2.numel(), row_s.data_ptr(),
            tb.data_ptr(), out.data_ptr(), P, _word_mask(planes),
            _deoffset(planes), stream,
        )
    if err:
        raise RuntimeError(f"classic_word kernel launch failed: CUDA error {err}")
    classic_words.launches += 1
    return out


classic_words.launches = 0


def classic_plan(row_s: torch.Tensor, n_blocks: int):
    """The window plan for sorted int32 rows [P] (P % PC_CL == 0) over a
    matrix of n_blocks 128-word blocks: (tb, inwin2d) with tb the first
    tile of each chunk's window (clamped so the window stays inside the
    matrix) and inwin2d [P // PC_CL, PC_CL] the probes the kernel serves
    from that window."""
    return _window_plan(row_s, n_blocks, PC_CL, NT_CL, unit=T)


def _window_plan(keys: torch.Tensor, n_blocks: int, pc: int, nt: int,
                 unit: int = 1):
    """For sorted keys (block * unit + a lane below unit: blocks for the
    probe streams, rows for the classic one) cut into chunks of pc probes:
    tb int32 [P // pc], the first tile of each chunk's nt-tile window
    (clamped so the window stays inside the matrix), and inwin2d bool
    [P // pc, pc], the probes whose block lies in their chunk's window."""
    k2d = keys.view(-1, pc)
    tb = torch.clamp(k2d[:, 0] // (T * unit), 0, n_blocks // T - nt).to(torch.int32)
    return tb, k2d < (tb[:, None].to(torch.int64) + nt) * (T * unit)


def stream_accumulate_classic_exact(
    stats, hist, over_col, over_freq, blocks2,
    packed: torch.Tensor,  # int32 [P0, 2]; P0 % EPC_CL == 0
    qcounts: torch.Tensor,  # int32 [P0] FULL frequencies; 0 marks padding
    *,
    wpad: int,
    k: int,
    num_hash: int,
    bloom_size: int,
    n_colors: int,
):
    """Sorted-row-stream query for the classic layout in exact mode: the
    stats/hist/overflow contract of ops/query.py (overflow entries record
    the frequency itself). Supports wpad == 1 (<= 32 colors). Returns
    (stats, hist, over_col, over_freq, n_drop) with n_drop an int32 device
    scalar: nonzero means the residual chunk capacity was exceeded (sparse
    probe distributions) and the caller must re-run generically.

    Nothing here waits for the device. The epilogue runs once over the
    whole batch: every statistic accumulates in k-mer order, so that
    equals the JAX package's scan over EPC_CL segments."""
    if wpad != 1:
        raise ValueError("classic stream kernel supports wpad == 1")
    P0 = packed.shape[0]
    if P0 % EPC_CL:
        raise ValueError(f"stream batch must be padded to a multiple of {EPC_CL}")
    H = num_hash
    rows = bloom_rows_device(packed, k=k, num_hash=H, bloom_size=bloom_size)
    row_s, gidx_s = torch.sort(rows.reshape(-1))
    tb, inwin2d = classic_plan(row_s, blocks2.shape[0])
    n_chunks = tb.shape[0]
    words = classic_words(blocks2, row_s, tb, planes=_n_planes(n_colors))

    # chunk-granular residual patch: probes outside their chunk's window
    # live in a few low-density chunks; the first NCH_CL such chunks re-read
    # their words straight from the matrix. The chunk list comes from a
    # stable sort of the flags (no host round trip); padding entries of
    # the list point at chunks without residuals and write back unchanged.
    res2d = ~inwin2d
    chunk_res = res2d.sum(dim=1, dtype=torch.int32)
    has_res = chunk_res > 0
    covered = has_res & (torch.cumsum(has_res, dim=0) <= NCH_CL)
    n_drop = (chunk_res * (has_res & ~covered)).sum(dtype=torch.int32)
    cidx = torch.sort((~covered).to(torch.int8), stable=True).indices[:NCH_CL]
    w2 = words.view(n_chunks, PC_CL)
    fresh = blocks2.reshape(-1)[row_s.view(n_chunks, PC_CL)[cidx].to(torch.int64)]
    w2[cidx] = torch.where(res2d[cidx] & covered[cidx][:, None], fresh, w2[cidx])

    # un-sort to probe order by scattering to the sort permutation (the JAX
    # package sorts by the permutation instead; the result is identical),
    # then per-k-mer AND across the H words
    words_u = torch.empty_like(words)
    words_u[gidx_s] = words
    wordsH = words_u.view(P0, H)
    andw = wordsH[:, 0]
    for h in range(1, H):
        andw = andw & wordsH[:, h]
    present = (wordsH != 0).all(dim=1)
    _accumulate_tail(
        stats, hist, over_col, over_freq, andw[:, None], present,
        qcounts > 0, qcounts, 1, 0, gidx=qcounts,
    )
    return stats, hist, over_col, over_freq, n_drop


# --- blocked (split-lane) sorted-probe stream --------------------------------

PC = 2048  # probes per chunk: the unit of the window plan and of padding
HIST_W = 256  # probe-kernel histogram width for WIDE color counts
# per-block shared memory for the probe kernel's histogram band: 16 KB
# leaves room for several resident blocks of 256 threads on an SM and
# stays below the 48 KB a kernel takes without opting in
HIST_BAND_BYTES = 16 * 1024
RES_CAP = 256 * PC  # residual probe slots (overflow-append bound)
OVER_CAP = 1 << 18  # uniq-hit frequency-overflow entries per segment
# Clipped-frequency bits packed into the sort key: carrying min(freq,
# 2^QKEY_BITS - 1) in the key's low bits drops one payload array from the
# sort. Sound because within-block probe order is irrelevant and every
# consumer of the frequency either needs it only below FREQ_CAP or gets
# the exact value from the overflow payload.
QKEY_BITS = 11
QKEY_MASK = (1 << QKEY_BITS) - 1
STREAM_WPADS = (1, 2, 4, 8, 16, 32)  # kernel color capacity: 32 * wpad <= 1024
STREAM_HASHES = (1, 2, 4)


def _nt_win(wpad: int) -> int:
    """Tiles per chunk window (the JAX package's plan: 4 tiles for narrow
    rows, 2 for wide ones)."""
    return 4 if wpad <= 4 else 2


def _nch(wpad: int) -> int:
    """Residual chunk capacity: out-of-window probes re-run through the
    generic gather at chunk granularity, at most this many chunks."""
    return 128 if wpad <= 4 else 256


def _hist_w(n_colors: int) -> int:
    """Probe-kernel histogram width: the engine's full FREQ_CAP range for
    narrow color counts, HIST_W for wide ones (larger uniq-hit frequencies
    go to the overflow list)."""
    return 1024 if n_colors < 128 else HIST_W


def _hist_band(cp: int, hw: int) -> int:
    """The probe kernel's histogram band: each thread block keeps the cells
    of frequency q < hf of the [cp, hw] histogram in shared memory. hf is
    the largest power of two <= hw with cp * hf int32 within
    HIST_BAND_BYTES (at least 1)."""
    hf = 1
    while 2 * hf <= hw and cp * 2 * hf * 4 <= HIST_BAND_BYTES:
        hf *= 2
    return hf


def _hist_rows(n_colors: int) -> int:
    """Probe-kernel histogram rows (>= 32 * wpad, so every bit index of an
    and-word has a row)."""
    C = n_colors
    return 32 if C < 32 else ((C + 1 + 127) // 128) * 128


def _qc_in_key_ok(bloom_size: int, rpb: int) -> bool:
    """Static guard: the block index must fit the key's high bits."""
    n_blocks = (bloom_size + rpb - 1) // rpb
    return n_blocks <= (1 << (32 - QKEY_BITS))


def pack_offsets(offs: list) -> torch.Tensor:
    """Per-hash in-block offsets (int64, < 128) -> one int32 with 8 bits per
    hash (the probe kernel's ``off`` encoding; at most 4 hashes of 7 bits,
    so the value stays below 2^31)."""
    offp = offs[0]
    for h in range(1, len(offs)):
        offp = offp | (offs[h] << (8 * h))
    return offp.to(torch.int32)


def _probe_gather(blocks2, blk_s, off_s, num_hash: int, wpad: int):
    """Per probe, the AND over its H rows' words and which rows are
    nonzero: (andw int32 [P, W], nz bool [P, H]). A block outside the
    matrix, or an offset whose row would leave its block, reads as an
    all-zero row."""
    P = blk_s.shape[0]
    H, W = num_hash, wpad
    dev = blk_s.device
    blk = blk_s.to(torch.int64)
    inb = (blk >= 0) & (blk < blocks2.shape[0])
    b = blocks2[torch.where(inb, blk, 0)]  # [P, 128]
    off = off_s.to(torch.int64) & M32
    o = torch.stack([(off >> (8 * h)) & 0xFF for h in range(H)], dim=1)
    ok = inb[:, None] & (o * W + W <= 128)  # [P, H]
    lanes = (torch.where(ok, o, 0) * W)[:, :, None] + torch.arange(W, device=dev)
    g = b.gather(1, lanes.reshape(P, H * W)).reshape(P, H, W)
    g = torch.where(ok[:, :, None], g, 0)
    return _and_over_hashes(g), (g != 0).any(dim=2)


def stream_probe_plain(blocks2, blk_s, off_s, qc_s, counts, hist, *,
                       num_hash: int, wpad: int, n_colors: int):
    """Plain PyTorch twin of the probe kernel (same contract as
    ``stream_probe``)."""
    P = blk_s.shape[0]
    cp, hw = hist.shape
    dev = blk_s.device
    andw, nz = _probe_gather(blocks2, blk_s, off_s, num_hash, wpad)
    present = nz.all(dim=1)
    real = qc_s > 0
    aw = torch.where(real[:, None], andw.to(torch.int64) & M32, 0)  # [P, W]
    counts += _bit_counts(aw).to(counts.dtype)
    nhits, color = _hits(aw)
    valid = real & present
    hit = valid & (nhits == 1)
    qc = qc_s.to(torch.int64)
    small = hit & (qc < hw) & (color < cp)
    spread = torch.arange(P, device=dev) % (cp * hw)
    hist.view(-1).index_add_(
        0, torch.where(small, color * hw + qc, spread), small.to(hist.dtype)
    )
    return torch.where(hit, color, torch.where(valid, -1, -2)).to(torch.int32)


def _check_probe_args(name: str, tensors, num_hash: int, wpad: int):
    """What both probe kernels take: contiguous int32 tensors on one device,
    (blocks2 [Rb, 128], blk_s, off_s, qc_s [P] with P % PC == 0, ...)."""
    blocks2, blk_s, off_s, qc_s = tensors[:4]
    P = blk_s.shape[0]
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError(f"{name} takes int32 tensors")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    if blocks2.dim() != 2 or blocks2.shape[1] != 128:
        raise ValueError(f"{name}: blocks2 must be [Rb, 128]")
    if wpad not in STREAM_WPADS or num_hash not in STREAM_HASHES:
        raise ValueError(
            f"{name}: wpad must be one of {STREAM_WPADS} and num_hash "
            f"one of {STREAM_HASHES}; got wpad={wpad} num_hash={num_hash}"
        )
    if P % PC or off_s.shape != (P,) or qc_s.shape != (P,) or blk_s.dim() != 1:
        raise ValueError(
            f"{name}: blk_s, off_s and qc_s must be [P] with P a "
            f"multiple of {PC}"
        )


def _check_card_args(name: str, blocks2):
    """What both probe kernels take on the card besides: a CUDA tensor,
    and a matrix that is 16-byte aligned (rows load as 16-byte vectors)."""
    dev = blocks2.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if blocks2.data_ptr() % 16:
        raise ValueError(f"{name}: blocks2 must be 16-byte aligned")


def stream_probe(blocks2, blk_s, off_s, qc_s, counts, hist, *,
                 num_hash: int, wpad: int, n_colors: int):
    """Gather / AND / count for probes sorted by block; returns uniq int32
    [P] and adds into ``counts`` and ``hist``.

    blocks2 int32 [Rb, 128] (the matrix); blk_s int32 [P] block per probe;
    off_s int32 [P] the H in-block row offsets, 8 bits each
    (``pack_offsets``); qc_s int32 [P] frequency, 0 = padding or a probe
    that is not to be counted; P % PC == 0. Per probe with qc > 0:
    and_w = AND over h of the row at offset off_h (wpad words), present iff
    every row has a nonzero word, every set bit c of and_w adds 1 to
    counts[c] (int32 [32 * wpad]); uniq = the color of a present probe with
    exactly one set bit, -1 for any other present probe, -2 otherwise
    (absent row, or qc == 0); a unique hit with qc < hw adds 1 to
    hist[color, qc] (int32 [cp, hw] = [_hist_rows, _hist_w](n_colors)).

    A CUDA tensor launches csrc/stream_probe.cu (its normal-mode entry
    point, which loads rows as 16-byte vectors: blocks2 must be 16-byte
    aligned, and keeps the histogram's cells of qc < _hist_band(cp, hw) in
    shared memory); a CPU tensor takes the plain twin.
    ``stream_probe.launches`` counts kernel launches."""
    _check_probe_args("stream_probe", (blocks2, blk_s, off_s, qc_s, counts, hist),
                      num_hash, wpad)
    P = blk_s.shape[0]
    if counts.shape != (32 * wpad,) or hist.shape != (
        _hist_rows(n_colors), _hist_w(n_colors)
    ) or hist.shape[0] < 32 * wpad:
        raise ValueError(
            "stream_probe: counts must be [32 * wpad] and hist "
            "[_hist_rows(n_colors), _hist_w(n_colors)]"
        )
    kw = dict(num_hash=num_hash, wpad=wpad, n_colors=n_colors)
    dev = blk_s.device
    if dev.type == "cpu":
        return stream_probe_plain(blocks2, blk_s, off_s, qc_s, counts, hist, **kw)
    _check_card_args("stream_probe", blocks2)
    cp, hw = hist.shape
    uniq = torch.empty(P, dtype=torch.int32, device=dev)
    fn = kernels.kernel("stream_probe")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            blocks2.data_ptr(), blocks2.numel(), blk_s.data_ptr(),
            off_s.data_ptr(), qc_s.data_ptr(), uniq.data_ptr(),
            counts.data_ptr(), hist.data_ptr(), P, num_hash, wpad, cp, hw,
            _hist_band(cp, hw), stream,
        )
    if err:
        raise RuntimeError(f"stream_probe kernel launch failed: CUDA error {err}")
    stream_probe.launches += 1
    return uniq


stream_probe.launches = 0


def _raw_facts(aw: torch.Tensor, nz: torch.Tensor):
    """The raw kernel's per-probe outputs from masked AND words aw (int64
    [P, W] u32 values, zero where the probe does not count) and row
    presence nz (bool [P, H], masked likewise): (nhits, colorsum, presmask
    int32 [P], per-bit sums int64 [32 * W])."""
    W = aw.shape[1]
    dev = aw.device
    word0 = 32 * torch.arange(W, device=dev)
    colorsum = torch.zeros(aw.shape[0], dtype=torch.int64, device=dev)
    cols = []
    for b in range(32):
        bit = (aw >> b) & 1
        cols.append(bit.sum(dim=0))
        colorsum += (bit * (word0 + b)).sum(dim=1)
    nhits = _popcount32(aw).sum(dim=1)
    presmask = (nz.to(torch.int64) << torch.arange(nz.shape[1], device=dev)).sum(dim=1)
    i32 = torch.int32
    return (nhits.to(i32), colorsum.to(i32), presmask.to(i32),
            torch.stack(cols, dim=1).reshape(-1))


def stream_probe_raw_plain(blocks2, blk_s, off_s, qc_s, counts, *,
                           num_hash: int, wpad: int):
    """Plain PyTorch twin of the raw probe kernel (same contract as
    ``stream_probe_raw``)."""
    andw, nz = _probe_gather(blocks2, blk_s, off_s, num_hash, wpad)
    real = qc_s > 0
    aw = torch.where(real[:, None], andw.to(torch.int64) & M32, 0)
    nhits, colorsum, presmask, bits = _raw_facts(aw, nz & real[:, None])
    counts += bits.to(counts.dtype)
    return nhits, colorsum, presmask


def stream_probe_raw(blocks2, blk_s, off_s, qc_s, counts, *,
                     num_hash: int, wpad: int):
    """The probe kernel in raw mode, for ONE color shard's matrix slice:
    per-probe facts come out instead of being folded, because uniqueness
    and presence span all color shards. Returns (nhits, colorsum, presmask)
    int32 [P] and adds into ``counts``.

    Inputs as ``stream_probe``. Per probe with qc > 0: and_w = AND over h of
    the row at offset off_h; nhits = its set bits over the shard's
    32 * wpad colors; colorsum = the sum of their (shard-local) indices,
    i.e. the color where nhits == 1; presmask bit h is set iff row h has a
    nonzero word in this shard; every set bit c adds 1 to counts[c] (int32
    [32 * wpad]). A probe with qc == 0 gives three zeros and counts nothing.

    A CUDA tensor launches csrc/stream_probe.cu (its raw entry point, which
    loads rows as 16-byte vectors: blocks2 must be 16-byte aligned); a CPU
    tensor takes the plain twin. ``stream_probe_raw.launches`` counts
    kernel launches."""
    _check_probe_args("stream_probe_raw", (blocks2, blk_s, off_s, qc_s, counts),
                      num_hash, wpad)
    if counts.shape != (32 * wpad,):
        raise ValueError("stream_probe_raw: counts must be [32 * wpad]")
    P = blk_s.shape[0]
    dev = blk_s.device
    if dev.type == "cpu":
        return stream_probe_raw_plain(
            blocks2, blk_s, off_s, qc_s, counts, num_hash=num_hash, wpad=wpad
        )
    _check_card_args("stream_probe_raw", blocks2)
    nhits, colorsum, presmask = (
        torch.empty(P, dtype=torch.int32, device=dev) for _ in range(3)
    )
    fn = kernels.kernel("stream_probe_raw")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            blocks2.data_ptr(), blocks2.numel(), blk_s.data_ptr(),
            off_s.data_ptr(), qc_s.data_ptr(), nhits.data_ptr(),
            colorsum.data_ptr(), presmask.data_ptr(), counts.data_ptr(), P,
            num_hash, wpad, stream,
        )
    if err:
        raise RuntimeError(
            f"stream_probe_raw kernel launch failed: CUDA error {err}"
        )
    stream_probe_raw.launches += 1
    return nhits, colorsum, presmask


stream_probe_raw.launches = 0


def stream_plan(blk_s: torch.Tensor, n_blocks: int, wpad: int):
    """The window plan for sorted int32 blocks [P] (P % PC == 0) over a
    matrix of n_blocks blocks: (tb, inwin2d) as _window_plan gives them.
    The probe kernel serves the probes in their window; the rest go to the
    residual pass."""
    return _window_plan(blk_s, n_blocks, PC, _nt_win(wpad))


def _residual_chunks(inwin2d, qc2d, nch: int):
    """The chunk-granular residual plan: res2d bool [n_chunks, PC], the
    counted probes outside their chunk's window; cidx, the (at most nch)
    chunks that re-run through the generic gather, as a stable sort of the
    flags (no host round trip; its padding entries are chunks that are not
    covered); covered bool [n_chunks]; and n_drop, the residual probes of
    the chunks beyond the capacity (int32 scalar)."""
    res2d = (~inwin2d) & (qc2d > 0)
    chunk_res = res2d.sum(dim=1, dtype=torch.int32)
    has_res = chunk_res > 0
    covered = has_res & (torch.cumsum(has_res, dim=0) <= nch)
    n_drop = (chunk_res * (has_res & ~covered)).sum(dtype=torch.int32)
    cidx = torch.sort((~covered).to(torch.int8), stable=True).indices[:nch]
    return res2d, cidx, covered, n_drop


def _residual_rows(blk_s, off_s, cidx, num_hash: int, rpb: int):
    """Matrix rows [len(cidx) * PC, H] of the probes of chunks cidx."""
    rblk = blk_s.view(-1, PC)[cidx].reshape(-1)
    roff = off_s.view(-1, PC)[cidx].reshape(-1)
    return torch.stack(
        [rblk * rpb + ((roff >> (8 * h)) & 0xFF) for h in range(num_hash)],
        dim=1,
    )


def stream_raw_local(blocks2, blk_s, off_s, qc_s, *, wpad: int, num_hash: int,
                     rpb: int, n_colors: int):
    """Local raw stream pass over sorted probes for ONE matrix shard:
    returns (counts int32 [32 * wpad], nhits, colorsum, presmask int32 [P],
    n_drop int32 scalar). The raw probe kernel serves the probes inside
    their chunk's window; the out-of-window probes of the first _nch
    residual chunks get their per-probe facts OVERWRITTEN from the generic
    block gather and their bits ADDED to the counts, as _stream_core's
    residual pass does for the folded statistics. Nothing here waits for
    the device."""
    P = blk_s.shape[0]
    W = wpad
    dev = blk_s.device
    n_chunks = P // PC
    _tb, inwin2d = stream_plan(blk_s, blocks2.shape[0], W)
    qcw = torch.where(inwin2d.view(-1), qc_s, 0)
    counts = torch.zeros(32 * W, dtype=torch.int32, device=dev)
    nhits, colorsum, presmask = stream_probe_raw(
        blocks2, blk_s, off_s, qcw, counts, num_hash=num_hash, wpad=W
    )

    res2d, cidx, covered, n_drop = _residual_chunks(
        inwin2d, qc_s.view(n_chunks, PC), _nch(W)
    )
    live = res2d[cidx] & covered[cidx][:, None]  # [nch, PC]
    rows = _residual_rows(blk_s, off_s, cidx, num_hash, rpb)
    g = _gather_rows_blocked(blocks2, rows, W, rpb)  # [n, H, W]
    andw = _and_over_hashes(g)
    lv = live.reshape(-1)
    lane_bit = torch.arange(W * 32, device=dev).reshape(W, 32)
    cmask = ((lane_bit < n_colors).to(torch.int64)
             << torch.arange(32, device=dev)).sum(dim=1)
    aw = torch.where(lv[:, None], andw.to(torch.int64) & M32 & cmask, 0)
    nh_r, cs_r, pm_r, bits = _raw_facts(aw, (g != 0).any(dim=2) & lv[:, None])
    counts += bits.to(counts.dtype)
    for full, part in ((nhits, nh_r), (colorsum, cs_r), (presmask, pm_r)):
        f2 = full.view(n_chunks, PC)
        f2[cidx] = torch.where(live, part.view(-1, PC), f2[cidx])
    return counts, nhits, colorsum, presmask, n_drop


def _stream_core(
    stats, hist, over_col, over_freq, blocks2, blk_s, off_s, qc_s, gidx_s,
    *, wpad: int, num_hash: int, rpb: int, n_colors: int,
):
    """Shared sorted-probe body: probes already sorted by block (blk_s
    ascending), with packed offsets, frequencies (0 = padding) and an
    overflow payload per probe (a global k-mer index, or the exact
    frequency itself in exact mode). Runs the probe kernel over the probes
    inside their chunk's window, the out-of-window probes of the first
    _nch residual chunks through the generic gather, and merges into the
    accumulators IN PLACE; returns (..., n_drop), an int32 device scalar
    that is nonzero when a capacity was exceeded.

    Nothing here waits for the device: where the JAX package branches on a
    device value, this does the work unconditionally with masks."""
    P = blk_s.shape[0]
    C, W = n_colors, wpad
    dev = blk_s.device
    hw = _hist_w(C)
    nch = _nch(W)
    n_chunks = P // PC
    tb, inwin2d = stream_plan(blk_s, blocks2.shape[0], W)

    qcw = torch.where(inwin2d.view(-1), qc_s, 0)
    counts_out = torch.zeros(32 * W, dtype=torch.int32, device=dev)
    hist_out = torch.zeros((_hist_rows(C), hw), dtype=torch.int32, device=dev)
    uniq = stream_probe(
        blocks2, blk_s, off_s, qcw, counts_out, hist_out,
        num_hash=num_hash, wpad=W, n_colors=C,
    )

    # global AND and all-valid from the counts: bit c of the AND over valid
    # k-mers is 1 iff every one of the n_valid k-mers hit color c (all-ones
    # when n_valid == 0); ok iff every real k-mer was valid
    n_valid = (uniq > -2).sum()
    n_real = (qcw > 0).sum()
    and_b = _and_words(counts_out, n_valid, W)
    hist[:, :hw] += hist_out[:C]

    # uniq-hit frequencies the kernel histogram does not cover (>= hw): the
    # first OVER_CAP of them, in probe order, append at the running n_over
    n_over_before = stats[C + W + 1].to(torch.int64)
    big = (uniq >= 0) & (qc_s >= hw)
    n_big = big.sum()
    capO = over_col.shape[0]
    pos = torch.cumsum(big, dim=0) - 1
    to = n_over_before + pos
    keep = big & (pos < OVER_CAP) & (to < capO)
    spread = torch.arange(P, device=dev) % capO
    oidx = torch.where(keep, to, spread)
    over_col.index_add_(0, oidx, torch.where(keep, uniq, 0))
    over_freq.index_add_(0, oidx, torch.where(keep, gidx_s, 0))

    stats[:C] += counts_out[:C]
    # the running AND keeps what earlier segments found
    stats[C : C + W] &= _to_i32(and_b)
    stats[C + W] *= (n_valid == n_real).to(stats.dtype)
    stats[C + W + 1] += n_big.clamp(max=OVER_CAP).to(stats.dtype)

    # residual pass, chunk-granular: out-of-window probes live in a few
    # sparse chunks; the first nch such chunks re-run whole through the
    # generic gather with their in-window probes masked out. The chunk list
    # is a stable sort of the flags; its padding entries are masked too.
    qc2d = qc_s.view(n_chunks, PC)
    res2d, cidx, covered, n_drop_res = _residual_chunks(inwin2d, qc2d, nch)
    rvalid = (res2d[cidx] & covered[cidx][:, None]).reshape(-1)
    rows_res = _residual_rows(blk_s, off_s, cidx, num_hash, rpb)
    _accumulate_one(
        stats, hist, over_col, over_freq, blocks2, rows_res, rvalid,
        qc2d[cidx].reshape(-1) * rvalid, W, 0, rpb,
        gidx=gidx_s.view(n_chunks, PC)[cidx].reshape(-1),
    )
    n_drop = (n_big - OVER_CAP).clamp(min=0).to(torch.int32) + n_drop_res
    return stats, hist, over_col, over_freq, n_drop


def _check_stream_batch(packed, qcounts):
    if packed.dtype != torch.int32 or qcounts.dtype != torch.int32:
        raise TypeError("stream batch: int32 packed k-mers and frequencies")
    if packed.shape[0] % PC or qcounts.shape[0] != packed.shape[0]:
        raise ValueError(f"stream batch must be padded to a multiple of {PC}")


def stream_accumulate_hash(
    stats, hist, over_col, over_freq, blocks2,
    packed: torch.Tensor,  # int32 [P, 2]; P % PC == 0
    qcounts: torch.Tensor,  # int32 [P] clipped frequencies; 0 marks padding
    base0: int,  # global index of packed[0]
    *,
    wpad: int,
    k: int,
    num_hash: int,
    bloom_size: int,
    rpb: int,
    n_colors: int,
    bv: int = 2,
):
    """Drop-in replacement for query_accumulate_hash_scan on blocked
    v2/v3/v4 indexes: same in-place stats/hist/overflow contract (overflow
    entries record the global k-mer index), one probe-kernel launch per
    segment. Also returns n_drop: nonzero means the segment must be re-run
    on the generic path (overflow or residual capacity exceeded)."""
    _check_stream_batch(packed, qcounts)
    P = packed.shape[0]
    blk, offs = device_blkoff(
        packed, k=k, num_hash=num_hash, bloom_size=bloom_size, rpb=rpb,
        version=bv,
    )
    offp = pack_offsets(offs)
    if _qc_in_key_ok(bloom_size, rpb):
        # sort diet: min(freq, FREQ_CAP) rides in the key's low bits. The
        # key is int64: as a signed int32 it would mis-order blocks >= 2^20
        key = (blk << QKEY_BITS) | qcounts.clamp(max=FREQ_CAP).to(torch.int64)
        key_s, perm = torch.sort(key, stable=True)
        blk_s = (key_s >> QKEY_BITS).to(torch.int32)
        qc_s = (key_s & QKEY_MASK).to(torch.int32)
    else:
        blk_s, perm = torch.sort(blk.to(torch.int32), stable=True)
        qc_s = qcounts[perm]
    return _stream_core(
        stats, hist, over_col, over_freq, blocks2,
        blk_s, offp[perm], qc_s, (perm + base0).to(torch.int32),
        wpad=wpad, num_hash=num_hash, rpb=rpb, n_colors=n_colors,
    )


def stream_accumulate_hash_exact(
    stats, hist, over_col, over_freq, blocks2,
    packed: torch.Tensor,  # int32 [P, 2]; P % PC == 0
    qcounts: torch.Tensor,  # int32 [P] FULL frequencies; 0 marks padding
    *,
    wpad: int,
    k: int,
    num_hash: int,
    bloom_size: int,
    rpb: int,
    n_colors: int,
    bv: int = 2,
    qc_in_key: bool = False,
):
    """stream_accumulate_hash in exact mode: the overflow payload is the
    frequency itself, so the caller needs no host-side frequency
    resolution. Frequencies must be the real int32 counts (not clipped).

    qc_in_key=True packs the frequency into the sort key's low QKEY_BITS
    (one payload array fewer). The CALLER must guarantee every frequency
    < 2^QKEY_BITS (and the block-index guard _qc_in_key_ok holds); larger
    values would be clipped, in the overflow payload too."""
    _check_stream_batch(packed, qcounts)
    blk, offs = device_blkoff(
        packed, k=k, num_hash=num_hash, bloom_size=bloom_size, rpb=rpb,
        version=bv,
    )
    offp = pack_offsets(offs)
    if qc_in_key and _qc_in_key_ok(bloom_size, rpb):
        key = (blk << QKEY_BITS) | qcounts.clamp(0, QKEY_MASK).to(torch.int64)
        key_s, perm = torch.sort(key, stable=True)
        blk_s = (key_s >> QKEY_BITS).to(torch.int32)
        qc_s = (key_s & QKEY_MASK).to(torch.int32)
    else:
        blk_s, perm = torch.sort(blk.to(torch.int32), stable=True)
        qc_s = qcounts[perm]
    return _stream_core(
        stats, hist, over_col, over_freq, blocks2,
        blk_s, offp[perm], qc_s, qc_s,
        wpad=wpad, num_hash=num_hash, rpb=rpb, n_colors=n_colors,
    )
