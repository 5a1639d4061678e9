"""Sorted-probe streams: the classic (reference-placement) row stream and
the blocked (split-lane) probe stream.

Classic. The classic layout (simple_bloom.rs:19-26) places a k-mer's H rows
independently: row_i = xxh3_64_with_seed(kmer, i) % bloom_size. This path
flattens the H*P row probes, sorts them by row, pulls each probe's single
u32 row word through the classic word kernel (csrc/classic_word.cu), and
hands the words in row order to the shared AND/count/histogram epilogue
(ops/query.py::_accumulate_sorted_words, the kernel csrc/epilogue.cu),
which patches the probes that fell outside their chunk's window and ANDs
each word into its k-mer's word.

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
is permutation-invariant (blocked) or taken after each k-mer's words are
ANDed together, which no order of the probes changes (classic).
"""

from __future__ import annotations

import os

import torch

from . import kernels
from .hash_torch import M32, bloom_rows_device, device_blkoff, pack_offsets, placement_keyoff
from .query import (
    FREQ_CAP,
    _accumulate_one,
    _accumulate_sorted_words,
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


def classic_residuals(row_s: torch.Tensor, n_blocks: int):
    """classic_plan's tb and, per chunk, its probes outside the window
    (int32 [P // PC_CL]) without a per-probe mask: the rows of a chunk are
    sorted, so its in-window probes are those below the window's end, one
    binary search a chunk."""
    r2d = row_s.view(-1, PC_CL)
    tb = torch.clamp(r2d[:, 0] // (T * T), 0, n_blocks // T - NT_CL).to(torch.int32)
    # rows lie below bloom_size < 2^31 - 1, so clamping the end keeps the count
    end = torch.clamp((tb.to(torch.int64) + NT_CL) * (T * T), max=2**31 - 1)
    inwin = torch.searchsorted(r2d, end.to(torch.int32)[:, None])[:, 0]
    return tb, (PC_CL - inwin).to(torch.int32)


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


# --- kernel E (csrc/radix_sort.cu): the streams' key sort with its payloads --

SORT_DIGIT_BITS = 10  # kernel E's widest digit: 1,024 buckets a pass
SORT_MAX_OPS = 3  # operand streams a sort carries, the index included
SORT_MAX_KEYS = 2**30 - 1  # keys a sort takes: kernel E keeps a tile's counts in 30 bits
_SORT_TILE = 8192  # csrc/radix_sort.cu's keys a tile
_SORT_CHUNK = 4  # csrc/radix_sort.cu's tiles an upsweep block counts in order


def sort_passes(bits: int) -> list[int]:
    """Kernel E's digit widths, low digit first, for keys of ``bits`` bits:
    ceil(bits / SORT_DIGIT_BITS) digits as equal as they come, the first
    bits % n of them one bit wider (30: 10, 10, 10; 26: 9, 9, 8; 21: 7, 7,
    7; 31: 8, 8, 8, 7)."""
    n = -(-bits // SORT_DIGIT_BITS)
    q, r = divmod(bits, n)
    return [q + (i < r) for i in range(n)]


def key_bits(max_key: int) -> int:
    """The bits a sort of keys in [0, max_key] must look at (at least 1)."""
    return max(1, int(max_key).bit_length())


def blocked_key_bits(bloom_size: int, rpb: int, qbits: int) -> int:
    """Bits of the blocked stream's sort key: the block (below
    ceil(bloom_size / rpb)) above qbits bits of frequency; 30 at -s
    50,000,000, rpb 128, qbits 11."""
    n_blocks = -(-bloom_size // rpb)
    return key_bits(((n_blocks - 1) << qbits) | ((1 << qbits) - 1))


def classic_key_bits(bloom_size: int) -> int:
    """Bits of the classic stream's sort key, a row below bloom_size; 26 at
    -s 50,000,000."""
    return key_bits(bloom_size - 1)


def _check_sort_args(key, bits: int, operands, index: bool, base: int, index64: bool):
    name = "sort_payloads"
    if key.dtype != torch.int32 or key.dim() != 1 or not key.is_contiguous():
        raise TypeError(f"{name}: the key must be contiguous int32 [P]")
    P = key.shape[0]
    _check_i32(name, operands, key.device, P)
    if not 1 <= bits <= 31:
        raise ValueError(f"{name}: bits must be 1..31 (non-negative int32 keys)")
    if len(operands) + index > SORT_MAX_OPS:
        raise ValueError(f"{name}: at most {SORT_MAX_OPS} operands, the index included")
    if P > SORT_MAX_KEYS:
        raise ValueError(f"{name}: at most {SORT_MAX_KEYS} keys (a tile's counts are 30 bits)")
    if index64 and not (index and 0 <= base and base + P <= 2**31):
        raise ValueError(f"{name}: index64 takes the index with 0 <= base, base + P <= 2^31")


def sort_payloads_plain(key, bits: int, operands=(), *, index: bool = False, base: int = 0,
                        index64: bool = False):
    """Plain PyTorch twin of kernel E (same contract as ``sort_payloads``):
    the same LSD passes with the same digit widths (``sort_passes``), each
    the digit of every key, its stable order (a stable sort of the digit
    alone: the order of a counting sort) and the key and the operands
    gathered through it. Checks every key's range."""
    _check_sort_args(key, bits, operands, index, base, index64)
    if key.numel() and (int(key.min()) < 0 or int(key.max()) >> bits):
        raise ValueError(f"sort_payloads: a key outside [0, 2^{bits})")
    ops = list(operands)
    if index:
        ops.append((torch.arange(key.shape[0], device=key.device) + base).to(torch.int32))
    shift = 0
    for width in sort_passes(bits):
        order = torch.sort((key >> shift) & ((1 << width) - 1), stable=True).indices
        key = key[order]
        ops = [o[order] for o in ops]
        shift += width
    if index64:
        ops[-1] = ops[-1].to(torch.int64)
    return (key, *ops)


def _sort_scratch(P: int, bits: int) -> int:
    """int32 of kernel E's scratch for P keys of ``bits`` bits
    (csrc/radix_sort.cu's layout): four passes' histograms (1,024 buckets
    each) and tile counters (32 words each), a status word per tile and
    bucket of each later pass, then per bucket of the first pass a count for
    each tile of _SORT_TILE keys and each chunk of _SORT_CHUNK tiles."""
    n_tiles = -(-P // _SORT_TILE)
    first, *later = sort_passes(bits)
    return (4 * 1024 + 4 * 32 + sum(n_tiles << w for w in later)
            + ((n_tiles + -(-n_tiles // _SORT_CHUNK)) << first))


def sort_payloads(key, bits: int, operands=(), *, index: bool = False, base: int = 0,
                  index64: bool = False):
    """Stable sort of a non-negative int32 key [P] by its low ``bits``
    bits (every key below 2^bits), carrying int32 operands [P]: the JAX
    package's lax.sort((key, *operands), num_keys=1), made stable. Returns
    (key_s, *operands_s), and with ``index`` last the index_s of the
    generated operand base + i (int32, wrapping as uint32; int64 with
    ``index64``, which needs 0 <= base and base + P <= 2^31). At most
    SORT_MAX_OPS operands, the index included, and P <= SORT_MAX_KEYS. Equals
    torch.sort(key, stable=True) with the operands gathered through its
    permutation.

    A CUDA tensor launches csrc/radix_sort.cu (kernel E: one read of the
    keys for every pass's histogram and the first pass's tile counts, then
    one launch an LSD pass of ``sort_passes(bits)``, the later ones with a
    decoupled look-back; every launch fixed on the host, nothing waits for
    the device; the key's range is the caller's guarantee there); a CPU
    tensor takes the plain twin, which checks the range.
    ``sort_payloads.launches`` counts calls that launched it."""
    operands = tuple(operands)
    dev = key.device
    if dev.type == "cpu":
        return sort_payloads_plain(key, bits, operands, index=index, base=base,
                                   index64=index64)
    _check_sort_args(key, bits, operands, index, base, index64)
    if dev.type != "cuda":
        raise ValueError(f"sort_payloads: unsupported device {dev}")
    P = key.shape[0]
    n_ops = len(operands) + index
    two = P and len(sort_passes(bits)) > 1  # ping-pong buffers
    i32 = dict(dtype=torch.int32, device=dev)
    key_s = torch.empty(P, **i32)
    outs = [torch.empty(P, **i32) for _ in operands]
    if index:
        outs.append(torch.empty(P, dtype=torch.int64 if index64 else torch.int32, device=dev))
    key_tmp = torch.empty(P, **i32) if two else None
    op_tmp = torch.empty(n_ops * P, **i32) if two and n_ops else None
    scratch = torch.empty(_sort_scratch(P, bits), **i32)
    ins = list(operands) + [None] * (SORT_MAX_OPS - len(operands))
    pad = [None] * (SORT_MAX_OPS - n_ops)
    if P:
        _launch("sort_payloads", key, key_s, key_tmp, *ins, *outs, *pad, op_tmp, n_ops,
                n_ops - 1 if index else -1, int(base), int(index64), P, bits, scratch,
                scratch.numel())
        sort_payloads.launches += 1
    return (key_s, *outs)


sort_payloads.launches = 0


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
    equals the JAX package's scan over EPC_CL segments. For the same
    reason a batch of more than SORT_MAX_KEYS rows, more than kernel E
    sorts at once, runs as EPC_CL-aligned pieces of at most that many rows
    into the same accumulators, in order, their n_drop summed."""
    if wpad != 1:
        raise ValueError("classic stream kernel supports wpad == 1")
    P0 = packed.shape[0]
    if P0 % EPC_CL:
        raise ValueError(f"stream batch must be padded to a multiple of {EPC_CL}")
    H = num_hash
    step = SORT_MAX_KEYS // (H * EPC_CL) * EPC_CL
    if P0 > step:
        geo = dict(wpad=wpad, k=k, num_hash=H, bloom_size=bloom_size, n_colors=n_colors)
        n_drop = torch.zeros((), dtype=torch.int32, device=packed.device)
        for s in range(0, P0, step):
            n_drop += stream_accumulate_classic_exact(
                stats, hist, over_col, over_freq, blocks2, packed[s:s + step],
                qcounts[s:s + step], **geo)[4]
        return stats, hist, over_col, over_freq, n_drop
    rows = bloom_rows_device(packed, k=k, num_hash=H, bloom_size=bloom_size)
    # kernel E: the rows sorted with their probe index, widened to int64 for
    # the epilogue (the JAX package sorts (rows, gidx) the same way)
    row_s, gidx_s = sort_payloads(rows.reshape(-1), classic_key_bits(bloom_size), index=True,
                                  index64=True)
    tb, chunk_res = classic_residuals(row_s, blocks2.shape[0])
    words = classic_words(blocks2, row_s, tb, planes=_n_planes(n_colors))

    # chunk-granular residual patch: probes outside their chunk's window
    # live in a few low-density chunks; the first NCH_CL such chunks re-read
    # their words straight from the matrix, inside the epilogue kernel,
    # which also takes the words in row order and ANDs each into its
    # k-mer's word (the JAX package un-sorts them by a second sort first;
    # the result is identical)
    has_res = chunk_res > 0
    covered = has_res & (torch.cumsum(has_res, dim=0) <= NCH_CL)
    n_drop = (chunk_res * (has_res & ~covered)).sum(dtype=torch.int32)
    _accumulate_sorted_words(
        stats, hist, over_col, over_freq, words, row_s, gidx_s, tb, covered, blocks2,
        qcounts > 0, qcounts, 0, gidx=qcounts, num_hash=H, tile_rows=T * T, nt=NT_CL,
    )
    return stats, hist, over_col, over_freq, n_drop


# --- blocked (split-lane) sorted-probe stream --------------------------------

# probes per chunk: the unit of the window plan and of padding. Read once at
# import; COLORID_STREAM_PC overrides it for sweeps, as in the JAX package
# (the probe kernels take a positive multiple of 32)
PC = int(os.environ.get("COLORID_STREAM_PC", "2048"))
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
    """Static guard: every sort key block << QKEY_BITS | qc must be a
    non-negative int32, kernel E's key (n_blocks <= 2^20). Past it the
    stream sorts the block alone with the frequency as an operand; the JAX
    package's int64 keys take the frequency up to 2^21 blocks, and the
    answers are the same (the order inside a block is irrelevant)."""
    n_blocks = (bloom_size + rpb - 1) // rpb
    return n_blocks << QKEY_BITS <= 2**31


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
    if PC <= 0 or PC % 32:
        raise ValueError(
            f"{name}: COLORID_STREAM_PC={PC} is not a positive multiple of 32, "
            "which the probe kernels need"
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


def _residual_plan(chunk_res: torch.Tensor, nch: int):
    """From each chunk's residual probes (int32 [n_chunks]): covered bool
    [n_chunks], the first nch chunks that have some; n_drop, the residual
    probes of the chunks beyond them (int32 scalar); and cidx, the covered
    chunks first, as a stable sort of the flags cut to nch (no host round
    trip; its padding entries are chunks that are not covered)."""
    has_res = chunk_res > 0
    covered = has_res & (torch.cumsum(has_res, dim=0) <= nch)
    n_drop = (chunk_res * (has_res & ~covered)).sum(dtype=torch.int32)
    cidx = torch.sort((~covered).to(torch.int8), stable=True).indices[:nch]
    return covered, n_drop, cidx


def _residual_chunks(inwin2d, qc2d, nch: int):
    """The chunk-granular residual plan: res2d bool [n_chunks, PC], the
    counted probes outside their chunk's window, and ``_residual_plan``'s
    cidx, covered and n_drop."""
    res2d = (~inwin2d) & (qc2d > 0)
    covered, n_drop, cidx = _residual_plan(res2d.sum(dim=1, dtype=torch.int32), nch)
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


def _stream_core_plain(
    stats, hist, over_col, over_freq, blocks2, blk_s, off_s, qc_s, gidx_s,
    *, wpad: int, num_hash: int, rpb: int, n_colors: int,
):
    """Plain PyTorch twin of the sorted-probe body (same contract as
    ``_stream_core``), as tensor ops: the window plan, the probe kernel's
    twin, the merge, the overflow list and the residual pass through the
    generic gather, all of them over every probe. Nothing here waits for the
    device: where the JAX package branches on a device value, this does the
    work unconditionally with masks."""
    C, W = n_colors, wpad
    dev = blk_s.device
    hw = _hist_w(C)
    n_chunks = blk_s.shape[0] // PC
    tb, inwin2d = stream_plan(blk_s, blocks2.shape[0], W)

    qcw = torch.where(inwin2d.view(-1), qc_s, 0)
    counts_out = torch.zeros(32 * W, dtype=torch.int32, device=dev)
    hist_out = torch.zeros((_hist_rows(C), hw), dtype=torch.int32, device=dev)
    uniq = stream_probe(
        blocks2, blk_s, off_s, qcw, counts_out, hist_out,
        num_hash=num_hash, wpad=W, n_colors=C,
    )

    n_big = _merge_plain(stats, hist, over_col, over_freq, uniq, qc_s, gidx_s,
                         counts_out, hist_out, (qcw > 0).sum(), W)

    # residual pass, chunk-granular: out-of-window probes live in a few
    # sparse chunks; the first nch such chunks re-run whole through the
    # generic gather with their in-window probes masked out. The chunk list
    # is a stable sort of the flags; its padding entries are masked too.
    qc2d = qc_s.view(n_chunks, PC)
    res2d, cidx, covered, n_drop_res = _residual_chunks(inwin2d, qc2d, _nch(W))
    rvalid = (res2d[cidx] & covered[cidx][:, None]).reshape(-1)
    rows_res = _residual_rows(blk_s, off_s, cidx, num_hash, rpb)
    _accumulate_one(
        stats, hist, over_col, over_freq, blocks2, rows_res, rvalid,
        qc2d[cidx].reshape(-1) * rvalid, W, 0, rpb,
        gidx=gidx_s.view(n_chunks, PC)[cidx].reshape(-1),
    )
    n_drop = (n_big - OVER_CAP).clamp(min=0).to(torch.int32) + n_drop_res
    return stats, hist, over_col, over_freq, n_drop


# --- kernel D (csrc/stream_tail.cu): the plan, then the tail with the residual gather

_TAIL_TILE = 2048  # csrc/stream_tail.cu's probes a tile of the tail
_TAIL_HEAD = 8  # csrc/stream_tail.cu's counters at the head of the tail's scratch


def _check_i32(name: str, tensors, dev, P: int | None = None):
    """Contiguous int32 tensors on ``dev`` (and of length P where given)."""
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} takes int32 tensors")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if P is not None and t.shape != (P,):
            raise ValueError(f"{name}: the probe streams must be [P]")


def _check_aligned(name: str, tensors) -> None:
    """The [P] streams that a kernel loads as 16-byte vectors."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the probe streams must be 16-byte aligned")


def _launch(name: str, *args) -> None:
    """Launch kernel ``name``'s entry point with ``args`` (tensors as their
    pointers) and the current stream of the first tensor's device."""
    fn = kernels.kernel(name)
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        err = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def stream_chunk_plan_plain(n_blocks: int, wpad: int, *, blk_s=None, off_s=None,
                            qc_s=None, key_s=None, qbits: int = 0):
    """Plain PyTorch twin of kernel D1 (same contract as
    ``stream_chunk_plan``): the window plan, then ``_residual_plan``'s list
    cut to min(nch, n_chunks) slots, -1 past the covered chunks."""
    if key_s is not None:
        blk_s = key_s >> qbits
        qc_s = key_s & ((1 << qbits) - 1)
    _tb, inwin2d = stream_plan(blk_s, n_blocks, wpad)
    qc2d = qc_s.view(-1, PC)
    qcw = torch.where(inwin2d, qc2d, 0)
    chunk_res = (~inwin2d & (qc2d > 0)).sum(dim=1, dtype=torch.int32)
    covered, n_drop_res, order = _residual_plan(chunk_res, _nch(wpad))
    n_cov = covered.sum(dtype=torch.int32)
    slot = torch.arange(order.shape[0], device=order.device)
    cidx = torch.where(slot < n_cov, order, -1).to(torch.int32)
    meta = torch.stack([(qcw > 0).sum(dtype=torch.int32), n_cov, n_drop_res])
    return blk_s, off_s, qc_s, qcw.view(-1), cidx, meta


def stream_chunk_plan(n_blocks: int, wpad: int, *, blk_s=None, off_s=None, qc_s=None,
                      key_s=None, qbits: int = 0):
    """The window plan of a sorted probe stream over a matrix of n_blocks
    blocks, in chunks of PC probes, and its residual chunk list: (blk_s,
    off_s, qc_s, qcw int32 [P], cidx int32 [min(nch, P // PC)], meta int32
    [3]).

    Two ways in. The probes sorted already (blk_s, off_s, qc_s int32 [P],
    handed back as they are). Or the key sorted with its payloads (kernel
    E's output): key_s int32 [P], the block above the frequency in its low
    qbits (1..30), and off_s int32 [P] sorted with it; then blk_s and qc_s
    are the key's bits and off_s is handed back. Each chunk's window starts
    at tile tb = clamp(blk_s[c * PC] // T, 0, n_blocks // T - nt); qcw =
    qc_s where the probe's block lies in its chunk's window and 0
    elsewhere. cidx lists the first nch = _nch(wpad) chunks that have
    residual probes (outside the window, qc_s > 0), in chunk order, then -1;
    meta = (n_real, the probes with qcw > 0; n_cov, the chunks listed; the
    residual probes of the chunks past the list).

    A CUDA tensor launches csrc/stream_tail.cu's plan kernel (D1: one block
    a chunk, the list by a look-back over the chunks; the [P] streams must
    be 16-byte aligned); a CPU tensor takes the plain twin.
    ``stream_chunk_plan.launches`` counts kernel launches."""
    kw = dict(blk_s=blk_s, off_s=off_s, qc_s=qc_s, key_s=key_s, qbits=qbits)
    name = "stream_chunk_plan"
    if key_s is not None:
        P, dev = key_s.shape[0], key_s.device
        _check_i32(name, (key_s, off_s), dev, P)
        if not 1 <= qbits <= 30:
            raise ValueError(f"{name}: a key sorted with its payloads needs qbits 1..30")
    else:
        P, dev = blk_s.shape[0], blk_s.device
        _check_i32(name, (blk_s, off_s, qc_s), dev, P)
    if PC <= 0 or PC % 32 or P % PC:
        raise ValueError(f"{name}: P must be a multiple of PC={PC} (a multiple of 32)")
    if dev.type == "cpu":
        return stream_chunk_plan_plain(n_blocks, wpad, **kw)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    _check_aligned(name, (key_s,) if key_s is not None else (blk_s, qc_s))
    n_chunks, nch, nt = P // PC, _nch(wpad), _nt_win(wpad)
    n_slots = min(nch, n_chunks)
    # one buffer: qcw (and blk_s, qc_s from the key), then meta and a pad
    # word, the look-back's status words and cidx
    k = 3 if key_s is not None else 1
    buf = torch.empty(k * P + 4 + n_chunks + n_slots, dtype=torch.int32, device=dev)
    qcw = buf[:P]
    if key_s is not None:
        blk_s, qc_s = buf[P:2 * P], buf[2 * P:3 * P]
    _launch("stream_plan", key_s, qbits, blk_s, qc_s, qcw, P, PC, nt, n_blocks // T - nt, nch,
            n_slots, buf[k * P:])
    if P:
        stream_chunk_plan.launches += 1
    m = k * P
    return blk_s, off_s, qc_s, qcw, buf[m + 4 + n_chunks:], buf[m:m + 3]


stream_chunk_plan.launches = 0


def _merge_plain(stats, hist, over_col, over_freq, uniq, qc_s, gidx_s, counts_out,
                 hist_out, n_real, W: int):
    """The probe kernel's outputs merged into the accumulators in place
    (``stream_tail``'s statistics and overflow list); returns n_big."""
    P = uniq.shape[0]
    hw = hist_out.shape[1]
    C = hist.shape[0]
    # global AND and all-valid from the counts: bit c of the AND over valid
    # k-mers is 1 iff every one of the n_valid k-mers hit color c (all-ones
    # when n_valid == 0); ok iff every real k-mer was valid
    n_valid = (uniq > -2).sum()
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
    spread = torch.arange(P, device=uniq.device) % capO
    oidx = torch.where(keep, to, spread)
    over_col.index_add_(0, oidx, torch.where(keep, uniq, 0))
    over_freq.index_add_(0, oidx, torch.where(keep, gidx_s, 0))

    stats[:C] += counts_out[:C]
    # the running AND keeps what earlier segments found
    stats[C : C + W] &= _to_i32(and_b)
    stats[C + W] *= (n_valid == n_real).to(stats.dtype)
    stats[C + W + 1] += n_big.clamp(max=OVER_CAP).to(stats.dtype)
    return n_big


def stream_tail_plain(stats, hist, over_col, over_freq, blocks2, uniq, counts_out, hist_out,
                      blk_s, off_s, qc_s, qcw, gidx_s, cidx, meta, *, wpad: int,
                      num_hash: int, rpb: int, n_colors: int):
    """Plain PyTorch twin of kernel D2 (same contract as ``stream_tail``)."""
    n_big = _merge_plain(stats, hist, over_col, over_freq, uniq, qc_s, gidx_s, counts_out,
                         hist_out, meta[0], wpad)
    listed = torch.arange(cidx.shape[0], device=cidx.device) < meta[1]
    c = torch.where(listed, cidx, 0).to(torch.int64)
    qc2d = qc_s.view(-1, PC)[c]
    live = (listed[:, None] & (qc2d > 0) & (qcw.view(-1, PC)[c] == 0)).reshape(-1)
    g = _gather_rows_blocked(blocks2, _residual_rows(blk_s, off_s, c, num_hash, rpb), wpad, rpb)
    andw = torch.where(live[:, None], _and_over_hashes(g), 0)
    present = (g != 0).any(dim=2).all(dim=1) & live
    q = torch.where(live, qc2d.reshape(-1), 0)
    gidx = torch.where(live, gidx_s.view(-1, PC)[c].reshape(-1), 0)
    n_drop = (n_big - OVER_CAP).clamp(min=0).to(torch.int32) + meta[2]
    return andw, present, live, q, gidx, n_drop


def stream_tail(stats, hist, over_col, over_freq, blocks2, uniq, counts_out, hist_out,
                blk_s, off_s, qc_s, qcw, gidx_s, cidx, meta, *, wpad: int, num_hash: int,
                rpb: int, n_colors: int):
    """The probe stream's tail after the probe kernel, in place on the
    accumulators (stats int32 [C + W + 2], hist int32 [C, FREQ_CAP],
    over_col / over_freq int32 [capO]), and the residual pass's gather.

    The tail: hist[:, :hw] += hist_out[:C]; stats[:C] += counts_out[:C];
    the AND words (bit c set where counts_out[c] equals n_valid = #{uniq >
    -2}) ANDed into stats[C : C + W]; the all-valid flag times (n_valid ==
    n_real); the first OVER_CAP big probes (uniq >= 0 and qc_s >= hw), in
    probe order, added as (uniq, gidx_s) at slots n_over + rank below capO,
    and n_over += min(n_big, OVER_CAP).
    The gather: for each slot j < n_cov of the list cidx, the probes of
    chunk cidx[j] outside its window (qcw == 0) with qc_s > 0: the H rows of
    each (``_residual_rows``), their AND (int32 [W]) and presence (every
    row has a nonzero word) from the blocked gather.
    Returns the epilogue's AND-words inputs (andw int32 [n_slots * PC, W],
    present bool, mask bool, q int32, gidx int32 [n_slots * PC]: slot j's
    rows at [j * PC, (j + 1) * PC), mask set on those probes with their
    qc_s and gidx_s, every other row all zero) and n_drop = max(n_big -
    OVER_CAP, 0) + meta[2], an int32 device scalar.

    uniq int32 [P] and counts_out int32 [32 * W], hist_out int32 [cp, hw]
    from the probe kernel; blk_s, off_s, qc_s, qcw, cidx and meta
    (n_real, n_cov, the residual probes past the list) from
    ``stream_chunk_plan``; gidx_s int32 [P] the overflow payload; blocks2
    int32 [Rb, 128] the matrix. A CUDA tensor launches csrc/stream_tail.cu's
    tail (D2: one launch, a block a tile of probes and a thread a row of
    the list's capacity; uniq and qc_s must be 16-byte aligned); a CPU
    tensor takes the plain twin. ``stream_tail.launches`` counts kernel
    launches."""
    name = "stream_tail"
    dev = uniq.device
    P = uniq.shape[0]
    _check_i32(name, (uniq, blk_s, off_s, qc_s, qcw, gidx_s), dev, P)
    _check_i32(name, (blocks2, counts_out, hist_out, cidx, meta, stats, hist, over_col,
                      over_freq), dev)
    C, W = n_colors, wpad
    cp, hw = hist_out.shape
    if (stats.shape != (C + W + 2,) or hist.shape != (C, FREQ_CAP) or counts_out.shape
            != (32 * W,) or not C <= cp or not 1 <= hw <= FREQ_CAP or C > 32 * W
            or over_freq.shape != over_col.shape or P % PC or meta.shape != (3,)
            or cidx.shape != (min(_nch(W), P // PC),) or blocks2.dim() != 2
            or blocks2.shape[1] != 128 or num_hash not in STREAM_HASHES
            or W not in STREAM_WPADS or rpb * W > 128):
        raise ValueError(f"{name}: accumulators, kernel outputs or the plan out of shape")
    kw = dict(wpad=W, num_hash=num_hash, rpb=rpb, n_colors=C)
    args = (stats, hist, over_col, over_freq, blocks2, uniq, counts_out, hist_out, blk_s,
            off_s, qc_s, qcw, gidx_s, cidx, meta)
    if dev.type == "cpu":
        return stream_tail_plain(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    _check_aligned(name, (uniq, qc_s))
    N = cidx.shape[0] * PC
    n_tiles = max(1, -(-P // _TAIL_TILE))
    # andw, q, gidx, then n_drop, a pad word and the scratch (tickets, sums,
    # the look-back's status words); present and mask
    out32 = torch.empty(N * W + 2 * N + 2 + _TAIL_HEAD + n_tiles, dtype=torch.int32,
                        device=dev)
    out8 = torch.empty(2 * N, dtype=torch.bool, device=dev)
    _launch("stream_tail", uniq, qc_s, qcw, gidx_s, blk_s, off_s, P, hw, counts_out,
            hist_out, C, W, stats, hist, over_col, over_freq, over_col.shape[0], OVER_CAP,
            cidx, meta, cidx.shape[0], PC, num_hash, rpb, blocks2, blocks2.shape[0], out32,
            out8)
    stream_tail.launches += 1
    return (out32[:N * W].view(N, W), out8[:N], out8[N:], out32[N * W:N * W + N],
            out32[N * W + N:N * W + 2 * N], out32[N * W + 2 * N])


stream_tail.launches = 0


def _stream_core_kernels(
    stats, hist, over_col, over_freq, blocks2, plan, gidx_s,
    *, wpad: int, num_hash: int, rpb: int, n_colors: int,
):
    """The sorted-probe body through kernel D around the probe kernel:
    ``plan`` is stream_chunk_plan's output (D1), gidx_s the overflow payload
    (the index that kernel E sorted with the key, or qc_s in exact mode).
    The probe kernel over the window's probes, the tail with the residual
    gather of the listed chunks (D2) and the epilogue's AND-words mode
    (kernel C) over the list's capacity. On CPU tensors every wrapper takes
    its twin."""
    blk_s, off_s, qc_s, qcw, cidx, meta = plan
    C, W = n_colors, wpad
    cp, hw = _hist_rows(C), _hist_w(C)
    acc = torch.zeros(32 * W + cp * hw, dtype=torch.int32, device=blk_s.device)
    counts_out, hist_out = acc[: 32 * W], acc[32 * W :].view(cp, hw)
    uniq = stream_probe(
        blocks2, blk_s, off_s, qcw, counts_out, hist_out,
        num_hash=num_hash, wpad=W, n_colors=C,
    )
    andw, present, mask, q, gidx, n_drop = stream_tail(
        stats, hist, over_col, over_freq, blocks2, uniq, counts_out, hist_out, blk_s, off_s,
        qc_s, qcw, gidx_s, cidx, meta, wpad=W, num_hash=num_hash, rpb=rpb, n_colors=C,
    )
    _accumulate_tail(stats, hist, over_col, over_freq, andw, present, mask, q, W, 0,
                     gidx=gidx)
    return stats, hist, over_col, over_freq, n_drop


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

    CUDA tensors go through kernel D (``_stream_core_kernels``), CPU
    tensors through the twin ``_stream_core_plain``; both give the same
    accumulators bit for bit. Nothing here waits for the device."""
    kw = dict(wpad=wpad, num_hash=num_hash, rpb=rpb, n_colors=n_colors)
    if blk_s.device.type == "cpu":
        return _stream_core_plain(stats, hist, over_col, over_freq, blocks2, blk_s, off_s,
                                  qc_s, gidx_s, **kw)
    plan = stream_chunk_plan(blocks2.shape[0], wpad, blk_s=blk_s, off_s=off_s, qc_s=qc_s)
    return _stream_core_kernels(stats, hist, over_col, over_freq, blocks2, plan, gidx_s, **kw)


def _check_stream_batch(packed, qcounts):
    if packed.dtype != torch.int32 or qcounts.dtype != torch.int32:
        raise TypeError("stream batch: int32 packed k-mers and frequencies")
    if packed.shape[0] % PC or qcounts.shape[0] != packed.shape[0]:
        raise ValueError(f"stream batch must be padded to a multiple of {PC}")


def _sorted_probes_plain(packed, qcounts, *, qbits: int, qmin, qmax, k: int,
                         num_hash: int, bloom_size: int, rpb: int, bv: int):
    """The twin's packing and sort: (blk_s, off_s, qc_s, perm) of a stream
    batch, with min/max-clamped frequencies in the low qbits of an int64 key
    where qbits > 0, else sorted by block with the frequencies gathered."""
    blk, offs = device_blkoff(
        packed, k=k, num_hash=num_hash, bloom_size=bloom_size, rpb=rpb, version=bv,
    )
    offp = pack_offsets(offs)
    if qbits:
        # sort diet: the clipped frequency rides in the key's low bits
        key = (blk << qbits) | qcounts.clamp(qmin, qmax).to(torch.int64)
        key_s, perm = torch.sort(key, stable=True)
        blk_s = (key_s >> qbits).to(torch.int32)
        qc_s = (key_s & ((1 << qbits) - 1)).to(torch.int32)
    else:
        blk_s, perm = torch.sort(blk.to(torch.int32), stable=True)
        qc_s = qcounts[perm]
    return blk_s, offp[perm], qc_s, perm


def _stream_accumulate(stats, hist, over_col, over_freq, blocks2, packed, qcounts,
                       base0, *, qbits: int, qmin, qmax, wpad: int, k: int,
                       num_hash: int, bloom_size: int, rpb: int, n_colors: int, bv: int,
                       kernels_route: bool):
    """Both stream_accumulate_hash variants: base0 None is exact mode (the
    frequency is its own overflow payload). kernels_route: kernel A's packed
    mode, kernel E's sort of the int32 key with its payloads (the offsets;
    the frequencies where qbits == 0; the index from base0 where given),
    kernel D's plan on the sorted streams, then kernel D. Otherwise the
    twin's packing and ``_stream_core_plain``."""
    place = dict(k=k, num_hash=num_hash, bloom_size=bloom_size, rpb=rpb)
    core = dict(wpad=wpad, num_hash=num_hash, rpb=rpb, n_colors=n_colors)
    if not kernels_route:
        blk_s, off_s, qc_s, perm = _sorted_probes_plain(
            packed, qcounts, qbits=qbits, qmin=qmin, qmax=qmax, bv=bv, **place)
        gidx_s = qc_s if base0 is None else (perm + base0).to(torch.int32)
        return _stream_core_plain(stats, hist, over_col, over_freq, blocks2, blk_s,
                                  off_s, qc_s, gidx_s, **core)
    key, offp = placement_keyoff(
        packed, qcounts if qbits else None, version=bv, qbits=qbits, qmin=qmin,
        qmax=qmax, **place)
    ops = (offp,) if qbits else (offp, qcounts)
    out = sort_payloads(key, blocked_key_bits(bloom_size, rpb, qbits), ops,
                        index=base0 is not None, base=base0 or 0)
    n_blocks = blocks2.shape[0]
    if qbits:
        plan = stream_chunk_plan(n_blocks, wpad, key_s=out[0], off_s=out[1], qbits=qbits)
    else:
        plan = stream_chunk_plan(n_blocks, wpad, blk_s=out[0], off_s=out[1], qc_s=out[2])
    gidx_s = plan[2] if base0 is None else out[-1]
    return _stream_core_kernels(stats, hist, over_col, over_freq, blocks2, plan, gidx_s,
                                **core)


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
    on the generic path (overflow or residual capacity exceeded).

    On the card: kernel A's packed mode (the sort key and packed offsets),
    kernel E's sort of the int32 key with its payloads, kernel D and the
    probe kernel; CPU tensors take the twins' route."""
    _check_stream_batch(packed, qcounts)
    return _stream_accumulate(
        stats, hist, over_col, over_freq, blocks2, packed, qcounts, base0,
        qbits=QKEY_BITS if _qc_in_key_ok(bloom_size, rpb) else 0, qmin=None,
        qmax=FREQ_CAP, wpad=wpad, k=k, num_hash=num_hash, bloom_size=bloom_size,
        rpb=rpb, n_colors=n_colors, bv=bv, kernels_route=packed.device.type != "cpu",
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
    in_key = qc_in_key and _qc_in_key_ok(bloom_size, rpb)
    return _stream_accumulate(
        stats, hist, over_col, over_freq, blocks2, packed, qcounts, None,
        qbits=QKEY_BITS if in_key else 0, qmin=0, qmax=QKEY_MASK, wpad=wpad, k=k,
        num_hash=num_hash, bloom_size=bloom_size, rpb=rpb, n_colors=n_colors, bv=bv,
        kernels_route=packed.device.type != "cpu",
    )
