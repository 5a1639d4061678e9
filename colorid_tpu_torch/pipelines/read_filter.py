"""read_filter: extract reads by classification taxon (read_filter.rs).

Host-only pipeline (gzip in/out); no device work. Quirks preserved:
- the map keys on the first space-token of the reads.txt query column and
  matches when the classification CONTAINS the taxon substring
  (read_filter.rs:10-28); the "accept"-only check is commented out in the
  reference and stays off here.
- output names: {prefix}_{taxon with spaces->_}_R1.fq.gz / _R2.fq.gz (pe),
  {prefix}_{taxon}.fq.gz (se).
"""

from __future__ import annotations

import gzip
import sys

from ..core.fastx import stream_fastq_records


def tab_to_map(classification: str, query: str) -> dict[str, str]:
    out: dict[str, str] = {}
    with open(classification) as f:
        for line in f:
            v = line.rstrip("\n").split("\t")
            h = v[0].split(" ")
            if query in v[1]:
                out[h[0]] = v[1]
    return out


def _pairs(path1: str, path2: str):
    it2 = stream_fastq_records(path2)
    for rec1 in stream_fastq_records(path1):
        rec2 = next(it2, None)
        if rec2 is None:
            break
        yield rec1, rec2


def read_filter_pe(
    class_map: dict[str, str],
    filenames: list[str],
    query: str,
    prefix: str,
    exclude: bool,
) -> None:
    qc = query.replace(" ", "_")
    n = 0
    with gzip.open(f"{prefix}_{qc}_R1.fq.gz", "wt") as g1, gzip.open(
        f"{prefix}_{qc}_R2.fq.gz", "wt"
    ) as g2:
        for (h1, s1, q1), (h2, s2, q2) in _pairs(filenames[0], filenames[1]):
            key = h1.split(" ")[0]
            hit = key in class_map
            if hit != exclude:
                g1.write(f"{h1}\n{s1}\n+\n{q1}\n")
                g2.write(f"{h2}\n{s2}\n+\n{q2}\n")
                n += 1
    if exclude:
        print(
            f"Excluded {n} read pairs  with classification containing "
            f"'{query}' from output files",
            file=sys.stderr,
        )
    else:
        print(
            f"Wrote {n} read-pairs with classification containing "
            f"'{query}' to output files",
            file=sys.stderr,
        )


def read_filter_se(
    class_map: dict[str, str],
    filenames: list[str],
    query: str,
    prefix: str,
    exclude: bool,
) -> None:
    qc = query.replace(" ", "_")
    n = 0
    with gzip.open(f"{prefix}_{qc}.fq.gz", "wt") as g1:
        for h1, s1, q1 in stream_fastq_records(filenames[0]):
            key = h1.split(" ")[0]
            hit = key in class_map
            if hit != exclude:
                g1.write(f"{h1}\n{s1}\n+\n{q1}\n")
                n += 1
    if exclude:
        print(
            f"Excluded {n} read pairs  with classification containing "
            f"'{query}' from output files",
            file=sys.stderr,
        )
    else:
        print(
            f"Wrote {n} read-pairs with classification containing "
            f"'{query}' to output files",
            file=sys.stderr,
        )
