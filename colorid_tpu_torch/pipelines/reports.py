"""Report generation (reference: reports.rs).

Output lines and thresholds replicate the reference byte-for-byte. The
search report row order and mode() ties use std HashMap with RandomState in
the reference — genuinely random across its own runs — so we emit those in
deterministic color order / smallest-value tie-break. The counts file
(read_counts_five_fields) however iterates a deterministic FnvHashMap in
the reference, so its row order is part of the bit-exact contract and is
emulated (COLORID_FNV_ORDER=0 reverts to sorted order).
"""

from __future__ import annotations

import os
from collections import Counter


def mode(numbers: list[float]) -> int:
    """reports.rs:65-77: mode of freqs cast to usize; ties -> smallest."""
    occ = Counter(int(v) for v in numbers)
    best = max(occ.values())
    return min(v for v, c in occ.items() if c == best)


def generate_report(
    query: str,
    report: dict[str, int],
    uniq_stats: dict[str, tuple[float, int, int]],
    n_ref_kmers: dict[str, int],
    num_kmers: int,
    cov: float,
) -> list[str]:
    """reports.rs:8-48: TSV `query n_kmers hit shared mean_cov mode n_uniq`,
    emitted when shared fraction (hits / n_ref_kmers[hit]) > cov.

    uniq_stats maps hit -> (mean, mode, n) of its uniq-hit k-mer frequency
    multiset (computed exactly on device, engine.SearchResult.freq_stats)."""
    lines = []
    for k, v in report.items():
        stats = uniq_stats.get(k)
        if stats:
            mean, modus, specific = stats
        else:
            mean, modus, specific = 0.0, 0, 0
        n = n_ref_kmers.get(k)
        if n is None:
            continue
        genome_cov = v / n
        if genome_cov > cov:
            lines.append(
                f"{query}\t{num_kmers}\t{k}\t{genome_cov:.2f}\t{mean:.2f}\t{modus}\t{specific}"
            )
    return lines


def generate_report_gene(
    query: str, report: dict[str, int], gene_kmer_size: int, cov: float
) -> list[str]:
    """reports.rs:50-62: `query hit n_kmers frac` when frac >= cov."""
    lines = []
    for k, v in report.items():
        gene_match = v / gene_kmer_size
        if gene_match >= cov:
            lines.append(f"{query}\t{k}\t{gene_kmer_size}\t{gene_match:.3f}")
    return lines


def read_counts_five_fields(reads_path: str, prefix: str) -> None:
    """reports.rs:98-120: aggregate `<prefix>_reads.txt` into
    `<prefix>_counts.txt`; non-accept rows land in the 'reject' bucket.
    Row order follows the reference's FnvHashMap iteration order (the
    Counter preserves insertion order = the map's insertion sequence)."""
    counts: Counter[str] = Counter()
    with open(reads_path) as f:
        for line in f:
            v = line.rstrip("\n").split("\t")
            if v[4] == "accept":
                counts[v[1]] += 1
            else:
                counts["reject"] += 1
    if os.environ.get("COLORID_FNV_ORDER", "1") != "0":
        from ..core.fnv import fnv_map_order_str

        keys = [
            kb.decode()
            for kb in fnv_map_order_str([s.encode() for s in counts])
        ]
    else:
        keys = sorted(counts)
    with open(f"{prefix}_counts.txt", "w") as out:
        for key in keys:
            out.write(f"{key}\t{counts[key]}\n")
