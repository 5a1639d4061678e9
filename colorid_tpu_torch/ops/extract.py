"""Device-side canonical k-mer extraction + counting from 2-bit packed reads.

The host ships reads as 2-bit base codes (16 bases per uint32 word, ~0.27
bytes/base) and the device does everything the reference's host-side k-mer
counting stage does (kmer.rs:87-299 canonical windows + kmer.rs:826-837
frequency filter): window extraction, forward/revcomp canonicalization
(A<C<G<T 2-bit ordering == byte-lexicographic ordering, kmer.rs:104),
sort-unique counting and the strictly-greater-than frequency filter. The
filtered unique k-mers never exist host-side: they feed the hash/gather/count
query (ops/query.py) device-resident.

Tensors carry the uint32 words as int32 bit views (as everywhere in the
port). Inside, every unsigned 32-bit quantity (a word, a (lo, hi) limb of a
64-bit k-mer value) is an int64 in [0, 2^32): torch has no unsigned shift,
add or compare on every device. The 64-bit canonical value sorts as ONE
int64 key, ``(hi - 2^31) * 2^32 + lo``: that offset keeps the signed order
equal to the unsigned (hi, lo) order also at k = 32, where a canonical value
can reach bit 63, and maps the all-ones sentinel (never canonical: the
canonical form of T^32 is A^32) to the largest int64.

Only uppercase ACGT reads take this path; callers route reads containing
lowercase bases to the exact host path (the same split the read_id frontend
does); bytes outside ACGT are handled by the validity bitplane.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .hash_torch import M32, _key_limbs, _to_i32

_CODE = np.full(256, 255, dtype=np.uint8)
_CODE[ord("A")] = 0
_CODE[ord("C")] = 1
_CODE[ord("G")] = 2
_CODE[ord("T")] = 3

SENT_KEY = 2**63 - 1  # the sort key of (lo, hi) = (0xFFFFFFFF, 0xFFFFFFFF)


def words_per_read(L: int) -> int:
    return (L + 15) // 16


def _pack_codes(codes: np.ndarray) -> np.ndarray:
    """Base codes [R, L] (0..3) -> 2-bit words [R, ceil(L/16)] uint32."""
    R, L = codes.shape
    Lw = words_per_read(L)
    cp = np.zeros((R, Lw * 16), dtype=np.uint32)
    cp[:, :L] = codes
    shifts = (2 * (15 - np.arange(16, dtype=np.uint32))).astype(np.uint32)
    return (cp.reshape(R, Lw, 16) << shifts).sum(axis=2, dtype=np.uint32)


def pack_reads(seqs: np.ndarray) -> np.ndarray | None:
    """ASCII reads [R, L] uint8 -> 2-bit words [R, ceil(L/16)] uint32.

    Base i of a read sits at bits [2*(15 - i%16), +2) of word i//16 (first
    base in the most significant bits). Returns None when any byte is
    outside uppercase ACGT (caller uses the exact host path then).
    """
    codes = _CODE[seqs]
    if (codes == 255).any():
        return None
    return _pack_codes(codes)


def pack_reads_masked(seqs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """pack_reads with per-read routing: returns (words [R, ceil(L/16)],
    clean bool [R]). Dirty reads (any byte outside uppercase ACGT) pack as
    all-A placeholders with clean[i] == False so callers can send only the
    clean rows through the device fast path and route the dirty minority to
    the exact host path (the reference skips only N-containing windows,
    kmer.rs:87-125, so a whole-batch reject would be needlessly coarse)."""
    codes = _CODE[seqs]
    clean = ~(codes == 255).any(axis=1)
    codes = np.where(clean[:, None], codes, np.uint8(0))
    return _pack_codes(codes), clean


def pack_reads_valid(seqs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """ASCII reads [R, L] -> (2-bit words [R, ceil(L/16)], per-base validity
    bitplane [R, ceil(L/32)] uint32, little-endian). Bytes outside uppercase
    ACGT pack as 'A' with their validity bit 0; the device skips windows
    touching an invalid base exactly like the reference skips N-containing
    windows (kmer.rs:87-125). ~0.03 extra bytes/base on the host link."""
    R, L = seqs.shape
    codes = _CODE[seqs]
    ok = codes != 255
    words = _pack_codes(np.where(ok, codes, np.uint8(0)))
    Lb = ((L + 31) // 32) * 32
    okp = np.zeros((R, Lb), dtype=np.uint8)
    okp[:, :L] = ok
    vbits = np.packbits(okp, axis=1, bitorder="little")
    return words, vbits.reshape(R, -1, 4).view(np.uint32)[:, :, 0].copy()


def pack_reads_any(seqs: np.ndarray) -> np.ndarray:
    """pack_reads for pre-screened batches: bytes outside uppercase ACGT
    pack as 'A' placeholders. Callers guarantee such windows are never
    counted (the read_id reads path marks them -1 in the rank plane, so the
    query treats them as padding, matching the reference's skip of
    N-containing windows, kmer.rs:87-125)."""
    codes = _CODE[seqs]
    return _pack_codes(np.where(codes == 255, np.uint8(0), codes))


def _window_valid_ok(valid_bits: torch.Tensor, L: int, k: int, NW: int):
    """bool [R, NW]: window w has all k bases valid (prefix sum over the
    unpacked per-base validity bitplane, int32 bit views [R, ceil(L/32)])."""
    R = valid_bits.shape[0]
    shifts = torch.arange(32, dtype=torch.int32, device=valid_bits.device)
    # (x >> s) & 1 is bit s also where the int32 view is negative
    vb = ((valid_bits[:, :, None] >> shifts) & 1).reshape(R, -1)[:, :L]
    c = torch.cumsum(1 - vb, dim=1, dtype=torch.int32)
    c = torch.cat([torch.zeros_like(c[:, :1]), c], dim=1)
    return (c[:, k:] - c[:, :NW]) == 0


def _unpack_codes(words: torch.Tensor, L: int) -> torch.Tensor:
    """[R, Lw] int32 words -> [R, L] int64 base codes (0..3)."""
    R, Lw = words.shape
    shifts = 2 * (15 - torch.arange(16, dtype=torch.int64, device=words.device))
    codes = ((words.to(torch.int64) & M32)[:, :, None] >> shifts) & 3
    return codes.reshape(R, Lw * 16)[:, :L]


def _window_limbs(codes: torch.Tensor, k: int, NW: int):
    """Canonical (lo, hi) limbs (int64 in [0, 2^32)) of every k-window of
    every read.

    Forward value = sum_j code[w+j] << 2*(k-1-j) (pack_keys_host layout);
    revcomp value = sum_j (3-code[w+j]) << 2*j. Canonical = the
    lexicographically smaller of the two (kmer.rs:104 string compare ==
    2-bit integer compare under A<C<G<T).
    """
    shape = (codes.shape[0], NW)
    f_lo, f_hi, r_lo, r_hi = (
        torch.zeros(shape, dtype=torch.int64, device=codes.device)
        for _ in range(4)
    )
    for j in range(k):
        c = codes[:, j : j + NW]
        s = 2 * (k - 1 - j)
        if s >= 32:
            f_hi.add_(c << (s - 32))
        else:
            f_lo.add_(c << s)
        t = 2 * j
        if t >= 32:
            r_hi.add_((3 - c) << (t - 32))
        else:
            r_lo.add_((3 - c) << t)
    fwd_le = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo <= r_lo))
    return torch.where(fwd_le, f_lo, r_lo), torch.where(fwd_le, f_hi, r_hi)


def _sort_key(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int64 key whose signed order is the unsigned (hi, lo) order."""
    return (hi - 2**31) * 2**32 + lo


def _window_keys(reads_packed, lens, valid_bits, k: int, L: int, d: int):
    """Sort keys [R, NW] of every canonical window; SENT_KEY where the
    window does not fit the read's true length, is off the stride d, or
    touches an invalid base. The plain twin of ``window_keys``' kernel."""
    NW = L - k + 1
    if NW <= 0:
        raise ValueError("L < k")
    lo, hi = _window_limbs(_unpack_codes(reads_packed, L), k, NW)
    w_idx = torch.arange(NW, dtype=torch.int32, device=lo.device)[None, :]
    valid = w_idx + k <= lens.to(torch.int32)[:, None]
    if d > 1:
        valid = valid & (w_idx % d == 0)
    if valid_bits is not None:
        valid = valid & _window_valid_ok(valid_bits, L, k, NW)
    return torch.where(valid, _sort_key(lo, hi), SENT_KEY)


def window_keys(reads_packed: torch.Tensor, lens: torch.Tensor,
                valid_bits: torch.Tensor | None = None, *, k: int, L: int,
                d: int = 1) -> torch.Tensor:
    """Sort keys int64 [R, L - k + 1] of every canonical k-window of 2-bit
    packed reads (``_window_keys``' contract): reads_packed int32 [R, Lw]
    (Lw * 16 >= L), lens [R] of any integer type (taken as int32),
    valid_bits int32 [R, Lv] (Lv * 32 >= L) or None; 1 <= k <= 32, d >= 1.

    A CUDA tensor launches csrc/window_keys.cu on the current stream; a CPU
    tensor takes the plain twin ``_window_keys``. ``window_keys.launches``
    counts kernel launches."""
    if lens.dtype.is_floating_point or lens.dtype.is_complex or lens.dtype == torch.bool:
        raise TypeError("window_keys takes integer lens")
    lens = lens.to(torch.int32).contiguous()
    tensors = [reads_packed, lens] + ([valid_bits] if valid_bits is not None else [])
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError("window_keys takes int32 words and validity bits")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("window_keys takes contiguous tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("window_keys: tensors on different devices")
    if not 1 <= k <= 32 or L < k or d < 1:
        raise ValueError(f"window_keys: needs 1 <= k <= 32, k <= L and d >= 1 "
                         f"(k={k}, L={L}, d={d})")
    R = reads_packed.shape[0] if reads_packed.dim() == 2 else -1
    if R < 0 or reads_packed.shape[1] * 16 < L or lens.shape != (R,) or (
        valid_bits is not None
        and (valid_bits.dim() != 2 or valid_bits.shape[0] != R
             or valid_bits.shape[1] * 32 < L)
    ):
        raise ValueError(
            "window_keys: reads_packed [R, >= ceil(L/16)], lens [R] and "
            "valid_bits [R, >= ceil(L/32)]"
        )
    dev = reads_packed.device
    if dev.type == "cpu":
        return _window_keys(reads_packed, lens, valid_bits, k, L, d)
    if dev.type != "cuda":
        raise ValueError(f"window_keys: unsupported device {dev}")
    out = torch.empty((R, L - k + 1), dtype=torch.int64, device=dev)
    if R == 0:
        return out
    fn = kernels.kernel("window_keys")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            reads_packed.data_ptr(), lens.data_ptr(),
            None if valid_bits is None else valid_bits.data_ptr(), out.data_ptr(),
            R, reads_packed.shape[1],
            0 if valid_bits is None else valid_bits.shape[1], L, k, d, stream,
        )
    if err:
        raise RuntimeError(f"window_keys kernel launch failed: CUDA error {err}")
    window_keys.launches += 1
    return out


window_keys.launches = 0


def _run_counts(s: torch.Tensor):
    """Over a sorted key vector: (new bool, count int64) with new marking
    the first slot of each run of equal keys and count its run length
    there (the next run's start minus its own), with no host round trip:
    runs are numbered by a running sum of the starts, each run's start is
    scattered to its number, and slots past the last run read N. (A
    reversed running minimum gives the same counts, but torch's scan with
    indices costs ~156 ms over 52 M keys on an H100.)"""
    N = s.shape[0]
    iota = torch.arange(N, device=s.device)
    new = torch.ones(N, dtype=torch.bool, device=s.device)
    new[1:] = s[1:] != s[:-1]
    run = torch.cumsum(new, dim=0) - 1
    start = torch.full((N + 2,), N, dtype=torch.int64, device=s.device)
    start.index_copy_(0, torch.where(new, run, N + 1), iota)  # N + 1: dump
    return new, start[run + 1] - iota


# Kernel F (csrc/run_counts.cu): run lengths, the -f filter and the
# compactions of the reads routes, over value-sorted keys. Its modes, and
# what each returns as (keys, q, n):
#   select: each run's total (its length, or the sum of its weights w) at
#     its start where kept, 0 elsewhere, after ``rounds`` pairwise selects:
#     s [P >> rounds] (s itself at 0 rounds), q int32, n_unique. The single
#     route's pairs (filter_t, rounds), chunk A's counts (filter_t 0) and
#     the merge's cross-chunk totals (w);
#   compact: extract_count's compaction: packed int32 [P, 2] (lo, hi) limbs
#     and q int32 [P], the kept runs first in key order, zero after,
#     n_unique;
#   partition: chunk A2's stable partition on w != 0: the first cap of the
#     live slots then the dead ones, each in key order, as s, w, and n_live.
RUN_COUNTS_MODES = {"select": 0, "compact": 1, "partition": 2}
RUN_TILE = 4096  # keys a tile of kernel F
_I64 = (-(2**63), 2**63 - 1)


def run_counts_plain(s: torch.Tensor, w: torch.Tensor | None = None, *, mode: str,
                     filter_t: int = 0, rounds: int = 0, cap: int = 0):
    """Plain PyTorch twin of kernel F (``run_counts``' contract): the port's
    torch code of each mode. A run of equal keys is kept where its key is
    not SENT_KEY and its total (its length, or the sum of its w) is
    > filter_t and > 0."""
    if mode == "partition":
        order = torch.sort((w == 0).to(torch.int8), stable=True).indices[:cap]
        return s[order], w[order], (w != 0).sum(dtype=torch.int32)
    new, count = _run_counts(s)
    if w is not None:
        # a run's total as a prefix-sum difference (the grand total is the
        # read set's window count, below 2^31 by search_reads' guard)
        cs = torch.cat([w.new_zeros(1, dtype=torch.int64),
                        torch.cumsum(w, dim=0, dtype=torch.int64)])
        iota = torch.arange(s.shape[0], device=s.device)
        count = cs[iota + count] - cs[iota]
    keep = new & (s != SENT_KEY) & (count > filter_t) & (count > 0)
    n_unique = keep.sum(dtype=torch.int32)
    if mode == "compact":
        N = s.shape[0]
        pos = torch.cumsum(keep, dim=0) - 1
        to = torch.where(keep, pos, N)  # slot N collects what is dropped
        lo, hi = _key_limbs(s)
        out = torch.zeros((N + 1, 2), dtype=torch.int32, device=s.device)
        out.index_copy_(0, to, torch.stack([_to_i32(lo), _to_i32(hi)], dim=1))
        qc = torch.zeros(N + 1, dtype=torch.int32, device=s.device)
        qc.index_copy_(0, to, count.to(torch.int32))
        return out[:N], qc[:N], n_unique
    qc = torch.where(keep, count, 0).to(torch.int32)
    # pairwise compaction: for filter_t >= 1 every kept group start is
    # followed by >= filter_t more identical slots, so two kept starts are
    # always > filter_t slots apart and a pair of adjacent slots holds at
    # most ONE kept probe; each round halves the stream with an element-wise
    # select. Round r is sound while 2^r <= filter_t + 1. A keptless pair
    # keeps the even slot's real sorted value, so the block stream stays
    # monotone for the probe kernel's tile windows.
    for _ in range(rounds):
        k2 = keep.view(-1, 2)
        pick = k2[:, 1]
        s = torch.where(pick, s.view(-1, 2)[:, 1], s.view(-1, 2)[:, 0])
        qc = torch.where(pick, qc.view(-1, 2)[:, 1], qc.view(-1, 2)[:, 0])
        keep = k2[:, 0] | pick
    return s, qc, n_unique


def run_counts(s: torch.Tensor, w: torch.Tensor | None = None, *, mode: str,
               filter_t: int = 0, rounds: int = 0, cap: int = 0):
    """Kernel F over the sorted int64 keys s [P]: (keys, q, n) of ``mode``
    (see RUN_COUNTS_MODES above). w int32 [P]: optional in select mode
    (without rounds), needed in partition mode, none in compact mode;
    rounds 0-3 in select mode only, P a multiple of 2^rounds; cap >= 0 in
    partition mode.

    A CUDA tensor launches csrc/run_counts.cu on the current stream (select:
    one launch after a memset of n_unique; compact: after a memset of the
    tiles' status words, one launch that reads the keys and places each
    tile by a look-back, then one that zeroes the tail from n_unique;
    partition: after the same memset, a count of the live slots from the
    weights alone, then the placing launch, which reads only the keys of
    the slots it writes below cap; nothing waits for the host); a CPU
    tensor takes the plain twin ``run_counts_plain``.
    ``run_counts.launches`` counts calls that launched it,
    ``run_counts.launches_by_mode`` the same by mode."""
    if mode not in RUN_COUNTS_MODES:
        raise ValueError(f"run_counts: unknown mode {mode!r}")
    if s.dtype != torch.int64 or s.dim() != 1 or not s.is_contiguous():
        raise ValueError("run_counts takes a contiguous int64 key vector")
    P = s.shape[0]
    if (w is None and mode == "partition") or (
            w is not None and mode != "partition" and (mode != "select" or rounds)):
        raise ValueError(f"run_counts: weights go with select mode (no rounds) and partition "
                         f"mode, not {mode} (rounds {rounds})")
    if w is not None and (w.dtype != torch.int32 or w.shape != (P,) or not w.is_contiguous()
                          or w.device != s.device):
        raise ValueError("run_counts takes contiguous int32 weights [P] on the keys' device")
    if not 0 <= rounds <= 3 or (rounds and mode != "select") or P % (1 << rounds):
        raise ValueError(f"run_counts: rounds {rounds} (0-3, select mode, P a multiple of "
                         f"2^rounds; P={P})")
    if mode == "partition" and cap < 0:
        raise ValueError("run_counts: cap >= 0")
    if P >= 2**31:
        raise ValueError(f"run_counts: {P} keys, beyond int32 counts")
    filter_t = min(max(int(filter_t), _I64[0]), _I64[1])
    dev = s.device
    if dev.type == "cpu":
        return run_counts_plain(s, w, mode=mode, filter_t=filter_t, rounds=rounds, cap=cap)
    if dev.type != "cuda":
        raise ValueError(f"run_counts: unsupported device {dev}")
    i64, i32 = dict(dtype=torch.int64, device=dev), dict(dtype=torch.int32, device=dev)
    n_out = min(cap, P) if mode == "partition" else P >> rounds
    out_s = pk = scratch = None
    if mode == "compact":
        keys = pk = torch.empty((P, 2), **i32)
    elif mode == "partition" or rounds:
        keys = out_s = torch.empty(n_out, **i64)
    else:
        keys = s  # the keys pass through
    q = torch.empty(n_out, **i32)
    n = torch.empty((), **i32)
    if P == 0:
        return keys, q, n.zero_()
    if mode in ("compact", "partition"):  # the look-back's status words (and partition's
        # live slots before each tile)
        scratch = torch.empty((1 + (mode == "partition")) * (-(-P // RUN_TILE)), **i64)
    ptr = [None if t is None else t.data_ptr() for t in (w, out_s, pk, scratch)]
    fn = kernels.kernel("run_counts")
    with torch.cuda.device(dev):
        err = fn(s.data_ptr(), ptr[0], P, RUN_COUNTS_MODES[mode], filter_t, rounds, cap,
                 ptr[1], q.data_ptr(), ptr[2], n.data_ptr(), ptr[3],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"run_counts kernel launch failed: CUDA error {err}")
    run_counts.launches += 1
    run_counts.launches_by_mode[mode] += 1
    return keys, q, n


run_counts.launches = 0
run_counts.launches_by_mode = dict.fromkeys(RUN_COUNTS_MODES, 0)


# Kernel G (csrc/value_sort.cu): the reads routes' value sort, a stable sort
# of the int64 sort keys over the low ``bits`` = 2k bits of key ^ 2^63, keys
# only or with one int32 payload: LSD radix passes, or at the merge sites a
# merge of the sorted runs the keys come in.
VALUE_SORT_DIGIT_BITS = 9  # the widest digit, 8-11 (sort_bench.py times them)
VALUE_SORT_STATUS32_KEYS = 2**30 - 1  # keys whose tile counts fit 32-bit status words
VALUE_SORT_TILE = 8192  # keys a tile of kernel G's passes
VALUE_SORT_MERGE_TILE = 4096  # output keys a tile of kernel G's merge rounds
_VALUE_SORT_CHUNK = 8  # tiles an upsweep block of kernel G counts in order
# the scratch's head: eight passes' histograms (2,048 buckets each) and
# tile counters (32 words each), then the stats words: the descents and
# SENT counts, 64 counts of keys by their low bits all ones, 8 passes' SENT
# tails, the descents' places, padded to 128 bytes so that the status words
# after them stay aligned
_VALUE_SORT_STATS_AT = 8 * 2048 + 8 * 32
_VALUE_SORT_STATS = -(-(2 + 64 + 8 + 256) // 32) * 32
_FLIP = -(2**63)  # the sign bit, as an int64
# The merge mode's path rule: device ms per million keys with an int32
# payload of the upsweep, an LSD pass and a merge round (sort_bench.py
# --value, H100 80GB HBM3 at 700 W; PERF.md), and the most rounds the
# kernel takes (its list of descents holds 255).
VALUE_SORT_UPSWEEP_MS = 0.00556
VALUE_SORT_PASS_MS = 0.01154
VALUE_SORT_ROUND_MS = 0.01076
VALUE_SORT_MAX_ROUNDS = 8


def value_sort_passes(bits: int) -> list[int]:
    """Kernel G's digit widths, low digit first, for ``bits`` bits:
    ceil(bits / VALUE_SORT_DIGIT_BITS) digits as equal as they come, the
    first bits % n of them one bit wider (62 at 9: 9, 9, 9, 9, 9, 9, 8)."""
    n = -(-bits // VALUE_SORT_DIGIT_BITS)
    q, r = divmod(bits, n)
    return [q + (i < r) for i in range(n)]


def value_sort_merge_max_rounds(bits: int) -> int:
    """The most merge rounds that cost less than the LSD path's upsweep and
    passes at ``bits`` bits (VALUE_SORT_*_MS), at most
    VALUE_SORT_MAX_ROUNDS: the device merges where the keys come as at most
    2 ** this many runs."""
    lsd = VALUE_SORT_UPSWEEP_MS + len(value_sort_passes(bits)) * VALUE_SORT_PASS_MS
    r = 0
    while r < VALUE_SORT_MAX_ROUNDS and (r + 1) * VALUE_SORT_ROUND_MS < lsd:
        r += 1
    return r


def value_sort_merge_rounds(runs: int, bits: int) -> int:
    """The device's path for ``runs`` >= 1 sorted runs under the merge hint:
    the merge rounds it runs (ceil(log2 runs), at least one: one run is
    copied through), or 0 where that is more than
    value_sort_merge_max_rounds(bits) and the LSD passes run."""
    rounds = max(1, (runs - 1).bit_length())
    return rounds if rounds <= value_sort_merge_max_rounds(bits) else 0


def _check_value_sort(key, payload, bits: int):
    if key.dtype != torch.int64 or key.dim() != 1 or not key.is_contiguous():
        raise TypeError("value_sort: the key must be contiguous int64 [P]")
    if payload is not None and (
        payload.dtype != torch.int32 or payload.shape != key.shape
        or not payload.is_contiguous() or payload.device != key.device
    ):
        raise ValueError("value_sort: the payload must be contiguous int32 [P] on the key's "
                         "device")
    if not 2 <= bits <= 64:
        raise ValueError(f"value_sort: bits must be 2..64 (2k), not {bits}")
    if key.shape[0] >= 2**31:
        raise ValueError(f"value_sort: {key.shape[0]} keys, beyond int32 places")


def _sort_bits(key: torch.Tensor, bits: int) -> torch.Tensor:
    """The sort's comparison key as an int64 whose signed order is the
    unsigned order of the low ``bits`` bits of key ^ 2^63 (at 64 bits, the
    key itself)."""
    return key if bits == 64 else (key ^ _FLIP) & ((1 << bits) - 1)


def value_sort_sent_tails(key: torch.Tensor, bits: int) -> list[int]:
    """The SENT keys (flipped low ``bits`` bits all ones) that each of
    kernel G's LSD passes leaves at the tail, csrc/value_sort.cu's rule:
    none for the first pass; for pass q > 0 all of them where no other key
    has its q low digits all ones (the passes before have then put every
    SENT key at the tail in input order, its final place), else none."""
    widths = value_sort_passes(bits)
    flipped = key ^ _FLIP
    lead = torch.zeros_like(key)  # low digits all ones, from the first
    run = torch.ones_like(key, dtype=torch.bool)
    shift = 0
    for w in widths:
        run &= ((flipped >> shift) & ((1 << w) - 1)) == (1 << w) - 1
        lead += run
        shift += w
    sent = lead == len(widths)
    n_sent = int(sent.sum())
    return [0] + [0 if bool((~sent & (lead >= q)).any()) else n_sent
                  for q in range(1, len(widths))]


def value_sort_runs(key: torch.Tensor, bits: int) -> int:
    """The sorted runs of ``key`` under the sort's comparison: one more than
    its descents (0 for no keys). A host read."""
    if key.numel() == 0:
        return 0
    c = _sort_bits(key, bits)
    return 1 + int((c[1:] < c[:-1]).sum())


def value_sort_plain(key: torch.Tensor, payload: torch.Tensor | None = None, *, bits: int):
    """Plain PyTorch twin of kernel G's LSD path (``value_sort``'s
    contract): the same passes with the same digit widths
    (``value_sort_passes``), each a stable sort of the digit of key ^ 2^63
    (taken with masks: torch has no unsigned 64-bit shift) with the key and
    the payload gathered through it.

    The key contract: keys are ``_sort_key`` values of canonical k-mers of
    length k, or SENT_KEY, and bits = 2k. No canonical value has all ones
    in its low 2k bits (the all-T k-mer's canonical form is all A), so under
    that contract the result equals torch.sort(key, stable=True) (with the
    payload gathered through its permutation), SENT_KEY last; at bits = 64
    it does for any keys."""
    _check_value_sort(key, payload, bits)
    flipped = key ^ _FLIP
    shift = 0
    for width in value_sort_passes(bits):
        order = torch.sort((flipped >> shift) & ((1 << width) - 1), stable=True).indices
        key, flipped = key[order], flipped[order]
        if payload is not None:
            payload = payload[order]
        shift += width
    return key if payload is None else (key, payload)


def value_merge_plain(key: torch.Tensor, payload: torch.Tensor | None = None, *, bits: int):
    """Plain PyTorch twin of kernel G's merge path: the runs found at the
    descents of the sort's comparison (``_sort_bits``), then rounds that
    merge runs 2j and 2j + 1 of the round before (a run without a partner
    copied through) until one is left. A round places each key of run A at
    its index + the keys of B that sort strictly below it, each key of B at
    its index + the keys of A that sort at or below it: the stable merge,
    ties to the earlier run. The same function as ``value_sort_plain`` for
    any keys."""
    _check_value_sort(key, payload, bits)
    c = _sort_bits(key, bits)
    cuts = [0, *(torch.nonzero(c[1:] < c[:-1]).flatten() + 1).tolist(), key.numel()]
    runs = [(c[a:b], key[a:b], None if payload is None else payload[a:b])
            for a, b in zip(cuts[:-1], cuts[1:])]
    while len(runs) > 1:
        merged = []
        for j in range(0, len(runs), 2):
            if j + 1 == len(runs):
                merged.append(runs[j])
                continue
            (ca, ka, pa), (cb, kb, pb) = runs[j], runs[j + 1]
            at_a = torch.arange(ca.numel(), device=c.device) + torch.searchsorted(cb, ca)
            at_b = torch.arange(cb.numel(), device=c.device) + torch.searchsorted(ca, cb,
                                                                                 right=True)
            out = []
            for x, y in ((ca, cb), (ka, kb)) + (() if pa is None else ((pa, pb),)):
                z = x.new_empty(x.numel() + y.numel())
                z[at_a], z[at_b] = x, y
                out.append(z)
            merged.append((out[0], out[1], out[2] if pa is not None else None))
        runs = merged
    _c, key, payload = runs[0]
    return key if payload is None else (key, payload)


def _value_sort_scratch(P: int, bits: int, wide: bool) -> int:
    """int32 of kernel G's scratch for P keys (csrc/value_sort.cu's layout):
    the head (histograms, tile counters, the stats words), a status word
    (two int32 where ``wide``) per tile and bucket of each later pass, then
    per bucket of the first pass a count for each tile and each chunk of
    _VALUE_SORT_CHUNK tiles."""
    n_tiles = -(-P // VALUE_SORT_TILE)
    first, *later = value_sort_passes(bits)
    return (_VALUE_SORT_STATS_AT + _VALUE_SORT_STATS
            + (1 + wide) * sum(n_tiles << w for w in later)
            + ((n_tiles + -(-n_tiles // _VALUE_SORT_CHUNK)) << first))


def value_sort(key: torch.Tensor, payload: torch.Tensor | None = None, *, bits: int,
               runs: bool = False):
    """Stable sort of the int64 sort keys [P] by the low ``bits`` bits of
    key ^ 2^63, with an optional int32 payload [P]: the JAX package's
    lax.sort((hi, lo), num_keys=2) and lax.sort((hi, lo, qc), num_keys=2)
    of the reads routes. Returns the sorted keys, or (keys, payload) with a
    payload; new tensors, the inputs are never written. bits = 2k, 2 to 64:
    under ``value_sort_plain``'s key contract the result equals
    torch.sort(key, stable=True) (and the payload gathered through it).
    ``runs``: the caller's hint that the keys come as a few sorted runs (the
    merge sites); the result is the same for any keys.

    A CUDA tensor launches csrc/value_sort.cu (kernel G: one read of the
    keys for every pass's histogram and the first pass's tile counts, then
    one launch an LSD pass of ``value_sort_passes(bits)``, the later ones
    with a decoupled look-back and without the SENT keys where
    ``value_sort_sent_tails`` says so; with ``runs``
    first one read of the keys that counts the runs and the merge rounds,
    the device taking the merge where ``value_sort_merge_rounds`` does;
    every launch fixed on the host, nothing waits for the device); a CPU
    tensor takes the plain twin ``value_sort_plain``, hint or not.
    ``value_sort.launches`` counts calls that launched it,
    ``value_sort.runs_launches`` those of them with the hint; with
    ``value_sort.keep_stats`` set, ``value_sort.last_stats`` gets what a
    card call counted (read with ``value_sort_stats``; a copy, one launch
    more)."""
    _check_value_sort(key, payload, bits)
    dev = key.device
    if dev.type == "cpu":
        return value_sort_plain(key, payload, bits=bits)
    if dev.type != "cuda":
        raise ValueError(f"value_sort: unsupported device {dev}")
    P = key.shape[0]
    key_s = torch.empty_like(key)
    pay_s = None if payload is None else torch.empty_like(payload)
    if P:
        max_rounds = value_sort_merge_max_rounds(bits) if runs else 0
        two = len(value_sort_passes(bits)) > 1 or max_rounds > 0  # ping-pong buffers
        key_tmp = torch.empty_like(key) if two else None
        pay_tmp = torch.empty_like(payload) if two and payload is not None else None
        wide = P > VALUE_SORT_STATUS32_KEYS
        scratch = torch.empty(_value_sort_scratch(P, bits, wide), dtype=torch.int32, device=dev)
        ptr = [None if t is None else t.data_ptr()
               for t in (key_tmp, payload, pay_s, pay_tmp)]
        fn = kernels.kernel("value_sort")
        with torch.cuda.device(dev):
            err = fn(key.data_ptr(), key_s.data_ptr(), ptr[0], ptr[1], ptr[2], ptr[3], P, bits,
                     VALUE_SORT_DIGIT_BITS, wide, max_rounds,
                     scratch.data_ptr(), scratch.numel(),
                     torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"value_sort kernel launch failed: CUDA error {err}")
        value_sort.launches += 1
        value_sort.runs_launches += runs
        if getattr(value_sort, "keep_stats", False):
            value_sort.last_stats = scratch[_VALUE_SORT_STATS_AT:][:74].clone()
    return key_s if payload is None else (key_s, pay_s)


def value_sort_stats(stats: torch.Tensor) -> dict:
    """What a card call of value_sort counted (``value_sort.last_stats``):
    the descents found (0 without the hint; at least 2 **
    value_sort_merge_max_rounds(bits) where the LSD path ran with it), the
    SENT keys and each LSD pass's SENT tail (value_sort_sent_tails; all 0
    where the merge ran)."""
    w = [int(x) for x in stats.cpu()]
    return dict(descents=w[0], sent=w[1], tails=w[66:74])


value_sort.launches = 0
value_sort.runs_launches = 0
value_sort.keep_stats = False
value_sort.last_stats = None


def extract_count(
    reads_packed: torch.Tensor,  # int32 [R, ceil(L/16)] (uint32 bit view)
    lens: torch.Tensor,  # int32 [R] true read lengths (<= L)
    valid_bits: torch.Tensor | None = None,  # int32 [R, ceil(L/32)] or None
    *,
    k: int,
    L: int,
    filter_t: int,
    d: int = 1,
):
    """Unique filtered canonical k-mers of a packed read batch, on device.

    Returns (packed [N, 2] int32 (bit view of the (lo, hi) uint32 limbs),
    qcounts int32 [N], n_unique int32 0-d tensor) with N = R * (L - k + 1):
    the first n_unique entries are the distinct canonical k-mers with count
    > filter_t (in sorted key order) and their exact counts; every later
    slot is zero, so qcounts == 0 there (the query's padding marker).
    Windows are taken at stride ``d`` (kmerize step_by) and only where the
    window fits the read's true length; counting replicates clean_map's
    strictly-greater filter (kmer.rs:826-837), in kernel F's compact mode.
    Nothing waits for the host.
    """
    s = value_sort(window_keys(reads_packed, lens, valid_bits, k=k, L=L, d=d).reshape(-1),
                   bits=2 * k)
    return run_counts(s, mode="compact", filter_t=filter_t)


def count_histogram(
    reads_packed: torch.Tensor,
    lens: torch.Tensor,
    valid_bits: torch.Tensor | None = None,
    *,
    k: int,
    L: int,
    d: int = 1,
    cap: int = 65536,
):
    """Histogram of per-unique-k-mer counts (for auto_cutoff, kmer.rs:866):
    hist[c] = number of distinct canonical k-mers seen exactly c times
    (c >= cap clips into the top bin), int32 [cap]. Device-side twin of the
    counting in extract_count so a search without -f can infer the cutoff
    from one small fetch before filtering; the run lengths come from kernel
    F's select mode with no filter (qc > 0 exactly at the runs that count)."""
    s = value_sort(window_keys(reads_packed, lens, valid_bits, k=k, L=L, d=d).reshape(-1),
                   bits=2 * k)
    _s, qc, _n = run_counts(s, mode="select")
    c = torch.where(qc > 0, qc.clamp(0, cap - 1), cap)
    hist = torch.zeros(cap + 1, dtype=torch.int32, device=s.device)
    hist.index_add_(0, c, torch.ones_like(c, dtype=torch.int32))
    return hist[:cap]
