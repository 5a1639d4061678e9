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

from .extract import SENT_KEY, run_counts, value_sort, window_keys
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
    # ONE sort: k-mer value order == block order (monotone addressing);
    # then kernel F's select mode: run counts, the filter and the pairwise
    # compaction (each round halves the stream; run_counts_plain says why
    # it is sound)
    s = value_sort(s, bits=2 * k)
    s, qc, n_unique = run_counts(s, mode="select", filter_t=filter_t, rounds=rounds)

    n_drop = _probe(
        stats, hist, over_col, over_freq, blocks2, s, qc, k=k, wpad=wpad,
        num_hash=num_hash, bloom_size=bloom_size, rpb=rpb, n_colors=n_colors,
        bv=bv,
    )
    return stats, hist, over_col, over_freq, n_drop, n_unique


# ---------------------------------------------------------------------------
# The chunked fused pipeline: no dispatch spans more than one read chunk's
# windows. Each chunk runs extract + sort + count (A) and compacts its
# unique k-mers with a stable partition on the liveness flag (A2); ONE merge (B)
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
    s = value_sort(window_keys(reads_packed, lens, valid_bits, k=k, L=L, d=d).reshape(-1),
                   bits=2 * k)
    return run_counts(s, mode="select")  # no filter: the counts are partials


def compact_sorted(s: torch.Tensor, qc: torch.Tensor, *, cap: int):
    """Dispatch A2: the live entries (qc > 0) first, each part in key
    order, sliced to the first ``cap``. The input is already key-sorted, so
    a stable partition on the dead flag (kernel F's partition mode) gives
    the JAX package's three-key (dead, hi, lo) order. Callers size cap from
    dispatch A's n_unique."""
    return run_counts(s, qc, mode="partition", cap=cap)[:2]


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
    # over all 64 bits: the chunk streams come from the caller, so their
    # keys are not known here to be canonical k-mers of 2k bits; each row
    # is two sorted runs (live slots, then dead slots), so kernel G merges
    s, qc = value_sort(s, qc, bits=64, runs=True)
    # kernel F's select mode with the counts as weights: each k-mer's
    # counts summed across chunks, then the global filter
    s, qcm, n_unique = run_counts(s, qc, mode="select", filter_t=filter_t)
    n_drop = _probe(
        stats, hist, over_col, over_freq, blocks2, s, qcm, k=k, wpad=wpad,
        num_hash=num_hash, bloom_size=bloom_size, rpb=rpb, n_colors=n_colors,
        bv=bv,
    )
    return stats, hist, over_col, over_freq, n_drop, n_unique
