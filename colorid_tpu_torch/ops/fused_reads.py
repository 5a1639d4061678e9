"""Fused reads -> results search for value-addressed (v3/v4) blocked indexes.

One call covers the whole query pipeline the reference runs host-side plus
its search loop (batch_search_pe.rs:28-93): 2-bit packed reads go in,
canonical k-mer windows come out of the packed words (ops/extract.py), ONE
sort by k-mer value groups duplicates for exact counting (clean_map's
strictly-greater filter, kmer.rs:826-837) AND, because the v3/v4 block
address is monotone in the k-mer value (ops/blocked.py), leaves the probe
stream in block order for the probe stream (ops/stream_query.py::
_stream_core and its CUDA kernel). No compaction scatter and no host round
trip between counting and querying.

The probe stream is the JAX package's slot for slot (colorid_tpu/ops/
fused_reads.py): _stream_core's window plan and residual chunks, and so the
overflow list's order and n_drop, follow the exact sequence of (k-mer,
frequency) slots it receives. A window sorts as one int64 key
(ops/extract.py::_sort_key) whose signed order is the unsigned (hi, lo)
order; SENT_KEY is the JAX package's all-ones sentinel.

Accumulators (stats, hist, over_col, over_freq) are updated IN PLACE, the
port's form of the JAX package's donated buffers. The probe kernel reads the
packed u32 words, so there is no byte-plane copy of the matrix.
"""

from __future__ import annotations

import torch

from .extract import SENT_KEY, _run_counts, window_keys
from .hash_torch import placement_keyoff
from .stream_query import PC, _stream_core


def _probe(stats, hist, over_col, over_freq, blocks2, s, qc, *, k: int,
           wpad: int, num_hash: int, bloom_size: int, rpb: int,
           n_colors: int, bv: int):
    """Value-addressed placement of the key-sorted slots s (int64 keys,
    block order by monotonicity; kernel A's packed mode: the block as its
    key and the packed offsets) and the exact-mode probe stream, with the
    frequency as its own overflow payload. Returns n_drop."""
    blk_s, off_s = placement_keyoff(s, None, k=k, num_hash=num_hash,
                                    bloom_size=bloom_size, rpb=rpb, version=bv)
    *_, n_drop = _stream_core(
        stats, hist, over_col, over_freq, blocks2, blk_s, off_s, qc, qc,
        wpad=wpad, num_hash=num_hash, rpb=rpb, n_colors=n_colors,
    )
    return n_drop


def _pad_sent(s: torch.Tensor, qc: torch.Tensor | None, unit: int):
    """Pad key slots with SENT_KEY (and frequencies with 0) to a multiple
    of unit."""
    pad = (-s.shape[0]) % unit
    if not pad:
        return s, qc
    s = torch.cat([s, s.new_full((pad,), SENT_KEY)])
    if qc is not None:
        qc = torch.cat([qc, qc.new_zeros(pad)])
    return s, qc


def fused_search_reads(
    stats, hist, over_col, over_freq,
    blocks2: torch.Tensor,  # int32 [Rb, 128] packed matrix (u32 bit view)
    reads_packed: torch.Tensor,  # int32 [R, ceil(L/16)] 2-bit read words
    lens: torch.Tensor,  # int32 [R] true read lengths
    valid_bits: torch.Tensor | None = None,  # int32 [R, ceil(L/32)] or None
    *,
    k: int,
    L: int,
    filter_t: int,
    d: int,
    wpad: int,
    num_hash: int,
    bloom_size: int,
    rpb: int,
    n_colors: int,
    bv: int = 3,
):
    """The single fused dispatch, in exact mode (overflow slots record the
    frequency itself). Updates the accumulators in place and returns
    (stats, hist, over_col, over_freq, n_drop, n_unique), the last two
    int32 device scalars. Nothing here waits for the device."""
    s = window_keys(reads_packed, lens, valid_bits, k=k, L=L, d=d).reshape(-1)
    # pairwise compaction rounds (below): each round halves the slot count,
    # so pad the stream so that the final length stays a multiple of PC
    rounds = min(3, (filter_t + 1).bit_length() - 1) if filter_t >= 1 else 0
    s, _ = _pad_sent(s, None, PC << rounds)
    # ONE sort: k-mer value order == block order (monotone addressing)
    s = torch.sort(s).values
    new, count = _run_counts(s)
    keep = new & (s != SENT_KEY) & (count > filter_t)
    n_unique = keep.sum(dtype=torch.int32)
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

    n_drop = _probe(
        stats, hist, over_col, over_freq, blocks2, s, qc, k=k, wpad=wpad,
        num_hash=num_hash, bloom_size=bloom_size, rpb=rpb, n_colors=n_colors,
        bv=bv,
    )
    return stats, hist, over_col, over_freq, n_drop, n_unique


# ---------------------------------------------------------------------------
# The chunked fused pipeline: no dispatch spans more than one read chunk's
# windows. Each chunk runs extract + sort + count (A) and compacts its
# unique k-mers with a stable sort of the liveness flag (A2); ONE merge (B)
# re-sorts the concatenated compacted streams, sums duplicate counts ACROSS
# chunks, applies the global strictly-greater frequency filter
# (kmer.rs:826-837: per-chunk filtering would drop k-mers whose occurrences
# straddle chunks) and feeds the probe stream.
# ---------------------------------------------------------------------------


def extract_sorted_counts(
    reads_packed: torch.Tensor,
    lens: torch.Tensor,
    valid_bits: torch.Tensor | None = None,
    *,
    k: int,
    L: int,
    d: int,
):
    """Dispatch A: the canonical windows of one read chunk, value-sorted,
    with per-group counts at group starts (qc == 0 elsewhere and for
    SENT_KEY). NO frequency filter: the counts are per-chunk partials.
    Returns (s int64 [R * NW] sorted keys, qc int32 [R * NW], n_unique
    int32 device scalar)."""
    s = torch.sort(
        window_keys(reads_packed, lens, valid_bits, k=k, L=L, d=d).reshape(-1)
    ).values
    new, count = _run_counts(s)
    keep = new & (s != SENT_KEY)
    return s, torch.where(keep, count, 0).to(torch.int32), keep.sum(dtype=torch.int32)


def compact_sorted(s: torch.Tensor, qc: torch.Tensor, *, cap: int):
    """Dispatch A2: the live entries (qc > 0) first, each part in key
    order, sliced to the first ``cap``. The input is already key-sorted, so
    a stable sort of the dead flag gives the JAX package's three-key
    (dead, hi, lo) order. Callers size cap from dispatch A's n_unique."""
    order = torch.sort((qc == 0).to(torch.int8), stable=True).indices[:cap]
    return s[order], qc[order]


def fused_merge_query(
    stats, hist, over_col, over_freq,
    blocks2: torch.Tensor,
    s_c: torch.Tensor,  # int64 [S, CAP] compacted per-chunk key streams
    qc_c: torch.Tensor,  # int32 [S, CAP] per-chunk partial counts (0 = dead)
    *,
    k: int,
    filter_t: int,
    wpad: int,
    num_hash: int,
    bloom_size: int,
    rpb: int,
    n_colors: int,
    bv: int = 4,
):
    """Dispatch B: merge-sort the chunk streams, sum each k-mer's counts
    across chunks, apply the GLOBAL strictly-greater filter, and run the
    probe stream. Same contract as fused_search_reads; the probe count is
    S * CAP padded to a multiple of PC."""
    s, qc = _pad_sent(s_c.reshape(-1), qc_c.reshape(-1), PC)
    s, perm = torch.sort(s)
    qc = qc[perm]
    new, count = _run_counts(s)
    # a group's total as a prefix-sum difference (the grand total is the
    # read set's window count, below 2^31 by search_reads' guard)
    cs = torch.cat([qc.new_zeros(1, dtype=torch.int64),
                    torch.cumsum(qc, dim=0, dtype=torch.int64)])
    iota = torch.arange(s.shape[0], device=s.device)
    total = cs[iota + count] - cs[iota]
    keep = new & (s != SENT_KEY) & (total > filter_t) & (total > 0)
    n_unique = keep.sum(dtype=torch.int32)
    qcm = torch.where(keep, total, 0).to(torch.int32)
    n_drop = _probe(
        stats, hist, over_col, over_freq, blocks2, s, qcm, k=k, wpad=wpad,
        num_hash=num_hash, bloom_size=bloom_size, rpb=rpb, n_colors=n_colors,
        bv=bv,
    )
    return stats, hist, over_col, over_freq, n_drop, n_unique
