"""Benchmark of the port: queried k-mers/s through the BIGSI search hot loop
on one card.

    python -m colorid_tpu_torch.bench              # on the CUDA card
    python -m colorid_tpu_torch.bench --device cpu # the plain twins, small knobs

The counterpart of the JAX package's ``bench.py``, with its function names,
phases and JSON line. The timed span mirrors the reference's ``colorid
search`` span (batch_search_pe.rs:42-93, "Search: {} sec"), which starts
with the query k-mer count map already in host RAM:

- stream: packed query k-mers resident on the card, several exact-mode
  probe-stream dispatches (placement, sort, gather, AND, count) behind one
  stacked fetch, on the blocked v4 index;
- generic: the same k-mers as host arrays through ``search_keys`` on the
  generic gather (the host path);
- fused: 2-bit packed reads on the card, extraction, counting, the ``-f 1``
  filter and the probe stream in one dispatch (``ops/fused_reads.py``),
  over a prefix of the reads whose k-mers the host counts independently;
- classic: the reference-placement index, device-resident k-mers through
  the generic gather, then through the classic sorted-row stream;
- read_id: paired reads classified through ``pipelines/read_id.py``.

Independent paths must agree: the stream and the host path's generic
gather on the full k-mer set, stream and fused on the full read set (where
the fused run takes every read), the fused prefix and one stream dispatch
over the prefix's host-counted k-mers, the classic stream and the generic
gather. A mismatch leaves the mismatched rate out of the line and names it
under ``parity``.

The cell is ``chip_smoke.py``'s ``[main]`` cell, made from a seed: 21
random 3 Mbp genomes, 400,000 x 150 bp reads from the first 3 (half
reverse-complemented, 0.5 % substitutions), indexes at ``-k 31 -n 4 -s
50000000`` (the reference's isolate-ID defaults, README.md:59,
main.rs:475-477). The indexes are cached under ``BENCH_CACHE_DIR``
(default ``.bench_cache/``) as ``bench50M.bxi`` and
``bench50M_blocked.bxi``, each with a ``.cell.json`` stamp of the cell it
was built from; an index without it, or of another cell, is refused. Knobs for a small run: ``BENCH_BLOOM``,
``BENCH_MAX_GENOMES``, ``BENCH_GENOME_LEN``, ``BENCH_N_READS``,
``BENCH_RID_READS``, ``BENCH_FUSED_READS``, ``BENCH_STREAM_DISPATCHES``
and ``BENCH_FUSED_DISPATCHES``.

Baseline: the reference publishes no throughput numbers (BASELINE.md); an
estimate of 4 M queried k-mers/s for multithreaded Rust, vs_baseline =
value / 4e6.

Prints exactly one JSON line on stdout, and on stderr the card, each
phase's per-dispatch span and the launches of the fifteen kernel wrappers.
Exits 2 without a card unless ``--device cpu`` is given (no number), and 1
after the line when a phase failed or a parity check did not hold.
"""

from __future__ import annotations

import argparse
import gzip
import json
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

K, HASHES = 31, 4
SEED = 2026
N_SOURCES = 3  # the reads come from the first N_SOURCES genomes
READ_LEN, SUB_RATE = 150, 0.005
BASELINE_KMERS_PER_S = 4e6
RATES = ("stream", "fused", "classic", "generic")


def knob(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def cache_dir() -> str:
    """BENCH_CACHE_DIR, else .bench_cache/ at the checkout's root."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.environ.get("BENCH_CACHE_DIR") or os.path.join(root, ".bench_cache")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# the cell (made from a seed)


def synth_cell(seed: int, n_genomes: int, genome_len: int, n_sources: int, n_reads: int):
    """(genomes: n_genomes uint8 [genome_len] ACGT arrays, reads: uint8
    [n_reads, READ_LEN]) from numpy's default_rng(seed): reads from the
    first n_sources genomes, half reverse-complemented, SUB_RATE random
    substitutions. The same draws in the same order as chip_smoke.py's
    synth_inputs, so both give the same bytes."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, dtype=np.uint8)
    comp[acgt] = np.frombuffer(b"TGCA", dtype=np.uint8)
    genomes = [acgt[rng.integers(0, 4, genome_len)] for _ in range(n_genomes)]
    src = rng.integers(0, n_sources, n_reads)
    starts = rng.integers(0, genome_len - READ_LEN, n_reads)
    reads = np.stack(genomes[:n_sources])[src[:, None], starts[:, None] + np.arange(READ_LEN)]
    rc = rng.random(n_reads) < 0.5
    reads[rc] = comp[reads[rc][:, ::-1]]
    sub = rng.random(reads.shape) < SUB_RATE
    reads[sub] = acgt[rng.integers(0, 4, int(sub.sum()))]
    return genomes, reads


def write_panel(directory: str, genomes) -> str:
    """One fasta per genome (``genome00`` ..., 80 bases a line) and the
    build manifest; returns the manifest's path."""
    os.makedirs(directory, exist_ok=True)
    manifest = []
    for i, g in enumerate(genomes):
        name = f"genome{i:02d}"
        path = os.path.join(directory, f"{name}.fasta")
        n = len(g) // 80 * 80
        lines = g[:n].reshape(-1, 80)
        body = np.concatenate(
            [lines, np.full((lines.shape[0], 1), ord("\n"), dtype=np.uint8)], axis=1
        ).tobytes()
        with open(path, "wb") as f:
            f.write(f">{name}\n".encode() + body + g[n:].tobytes() + b"\n")
        manifest.append(f"{name}\t{path}\n")
    man = os.path.join(directory, "refs.txt")
    with open(man, "w") as f:
        f.writelines(manifest)
    return man


def cell_stamp(blocked: bool, n_genomes: int, genome_len: int, bloom: int) -> dict:
    """What an index of the cell is built from: the seed, the panel's size,
    the build's parameters and the index file's format."""
    from .index.bigsi import MAGIC

    return {"seed": SEED, "n_genomes": n_genomes, "genome_len": genome_len,
            "bloom": bloom, "k": K, "hashes": HASHES, "blocked": blocked,
            "format": MAGIC.decode()}


def write_stamp(path: str, stamp: dict) -> None:
    """Record beside the index at path the cell it was built from."""
    with open(path + ".cell.json", "w") as f:
        json.dump(stamp, f, sort_keys=True)


def build_or_load_index(blocked: bool, genomes):
    """The cell's classic or blocked index: loaded from the cache, or built
    with pipelines/build.py (as CLI ``build [--blocked] -k 31 -n 4 -s
    BLOOM``) and saved there with its cell stamp. A cached index whose stamp
    is missing or names another cell is refused."""
    from .index.bigsi import BigsiIndex
    from .pipelines.build import build_index, tab_to_map

    bloom = knob("BENCH_BLOOM", 50_000_000)
    stamp = cell_stamp(blocked, len(genomes), len(genomes[0]), bloom)
    cache = cache_dir()
    os.makedirs(cache, exist_ok=True)
    name = "bench50M_blocked.bxi" if blocked else "bench50M.bxi"
    path = os.path.join(cache, name)
    if os.path.exists(path):
        try:
            with open(path + ".cell.json") as f:
                cached = json.load(f)
        except FileNotFoundError:
            cached = None
        if cached != stamp:
            raise ValueError(f"{path} was built for {cached}, not this cell {stamp}; "
                             "remove it or set BENCH_CACHE_DIR")
        log(f"loading cached bench index {name}")
        index = BigsiIndex.load(path)
        if (index.bloom_size, index.n_colors, index.k_size, index.num_hash,
                bool(index.blocked)) != (bloom, len(genomes), K, HASHES, blocked):
            raise ValueError(f"{path} does not hold the index its stamp names")
        return index
    man = write_panel(os.path.join(cache, "genomes"), genomes)
    log(f"building {'blocked ' if blocked else ''}index over {len(genomes)} "
        f"genomes (k={K}, s={bloom}, n={HASHES})")
    t0 = time.time()
    index = build_index(tab_to_map(man), bloom, HASHES, K, verbose=False,
                        blocked=blocked, threads=8)
    log(f"build: {time.time() - t0:.1f}s")
    index.save(path)
    write_stamp(path, stamp)
    return index


def make_query_kmers(reads: np.ndarray):
    """The reads' ``-f 1`` query k-mers counted on the host: (keys ASCII
    [n, K], qcounts [n], packed uint32 [n, 2], in one order) and the reads
    as 2-bit words (the fused path's input)."""
    from .native import NativeCounter
    from .ops.extract import pack_reads

    nc = NativeCounter(K)
    if not nc.add_many(reads):
        raise RuntimeError("unexpected fallback counting the bench reads")
    keys, _ = nc.dump(1)  # -f 1: k-mers seen more than once
    packed, qcounts = nc.dump_packed(1)
    reads_packed = pack_reads(reads)
    if reads_packed is None:
        raise RuntimeError("bench reads unexpectedly dirty")
    return keys, qcounts, packed, reads_packed


# ---------------------------------------------------------------------------
# measured phases


def _trials(name: str, fn, n_trials: int, budget_s: float) -> float:
    """Best host-clock seconds of fn() over up to n_trials runs; fn ends in
    a fetch to the host, which waits for the card."""
    best = float("inf")
    deadline = time.time() + budget_s
    for trial in range(n_trials):
        t0 = time.time()
        fn()
        dt = time.time() - t0
        log(f"{name} trial {trial}: {dt:.3f}s")
        best = min(best, dt)
        if time.time() > deadline:
            log(f"{name}: trial budget exhausted")
            break
    return best


def same_result(a, b) -> bool:
    """Two SearchResults agree: counts, all_valid, and_all, the uniq-hit
    histogram and freq_stats(), the overflow list as a multiset."""
    return (
        np.array_equal(a.counts, b.counts)
        and a.all_valid == b.all_valid
        and np.array_equal(a.and_all, b.and_all)
        and np.array_equal(a.freq_hist, b.freq_hist)
        and a.freq_stats() == b.freq_stats()
        and sorted(zip(a.over_colors.tolist(), a.over_freqs.tolist()))
        == sorted(zip(b.over_colors.tolist(), b.over_freqs.tolist()))
    )


def _device_batch(packed: np.ndarray, qcounts: np.ndarray, P: int, device):
    """Packed k-mers and frequencies zero-padded to P (frequency 0 marks
    padding), as int32 tensors on the device, the copy finished."""
    n = packed.shape[0]
    pk = np.zeros((P, 2), dtype=np.uint32)
    pk[:n] = packed
    qc = np.zeros(P, dtype=np.int32)
    qc[:n] = np.maximum(qcounts, 1)
    pk_dev = torch.from_numpy(pk.view(np.int32)).to(device)
    qc_dev = torch.from_numpy(qc).to(device)
    if pk_dev.is_cuda:
        torch.cuda.synchronize()
    return pk_dev, qc_dev


def _stacked(dispatch, n_disp: int, finish):
    """n_disp dispatches queued back to back, ONE stacked fetch of their
    result vectors, each decoded; the last decoded answer, or None when
    one of them tripped its capacity guard."""
    outs = [dispatch() for _ in range(n_disp)]
    big = torch.stack([o[0] for o in outs]).cpu().numpy()
    res = None
    for i, o in enumerate(outs):
        res = finish(big[i], *o[1:])
        if res is None:
            return None
    return res


def phase_stream(engine, keys, qcounts, packed):
    """Device-resident packed k-mers through the blocked probe stream:
    (k-mers/s, SearchResult). A capacity trip fails the phase."""
    from .ops.stream_query import PC

    n = packed.shape[0]
    P = -(-n // PC) * PC
    pk_dev, qc_dev = _device_batch(packed, qcounts, P, engine.device)
    # steady-state span: several dispatches drain through the card's queue
    # back to back, and one stacked fetch returns all their accumulators,
    # as a streaming pipeline overlaps fetches with the next batch
    disp = knob("BENCH_STREAM_DISPATCHES", 12)
    # the host counted the k-mers, so the batch's largest frequency is
    # known; it lets the sort drop its frequency payload (QKEY_BITS)
    max_freq = int(np.maximum(qcounts, 1).max())
    holder = {}

    def run():
        holder["res"] = _stacked(
            lambda: engine.search_keys_dev_async(pk_dev, qc_dev, k=K, max_freq=max_freq),
            disp, engine.search_keys_dev_finish,
        )

    run()  # warm: first launches, allocator
    if holder["res"] is None:
        raise RuntimeError("stream residual/overflow capacity exceeded")
    best = _trials("stream", run, 3, 90)
    value = disp * n / best
    log(f"[stream] {value / 1e6:.2f} M k-mers/s ({disp} dispatches x {n} k-mers "
        f"in {best:.4f}s; {1e3 * best / disp:.3f} ms a dispatch)")
    return value, holder["res"]


def phase_generic(engine, keys, qcounts, packed):
    """Host arrays through search_keys on the generic gather of the same
    engine (the host path): (k-mers/s, SearchResult)."""
    qc = np.asarray(qcounts, dtype=np.int32)
    stream_state = engine._stream
    engine._stream = False
    holder = {}
    try:
        def run():
            holder["res"] = engine.search_keys(None, qcounts=qc, packed_all=packed, k=K)

        run()
        best = _trials("generic", run, 3, 90)
    finally:
        engine._stream = stream_state
    value = keys.shape[0] / best
    log(f"[generic] {value / 1e6:.2f} M k-mers/s ({keys.shape[0]} k-mers in "
        f"{best:.4f}s, host arrays in, SearchResult out)")
    return value, holder["res"]


def _prefix_kmers(reads_packed):
    """The ``-f 1`` k-mers of a read subset counted independently on the
    host (NativeCounter over the unpacked bases): (packed, qcounts)."""
    from .native import NativeCounter

    R, Lw = reads_packed.shape
    shifts = (2 * (15 - np.arange(16, dtype=np.uint32))).astype(np.uint32)
    codes = (
        (reads_packed[:, :, None] >> shifts) & np.uint32(3)
    ).reshape(R, Lw * 16)[:, :READ_LEN].astype(np.uint8)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)[codes]
    nc = NativeCounter(K)
    if not nc.add_many(np.ascontiguousarray(bases)):
        raise RuntimeError("unexpected fallback unpacking bench reads")
    return nc.dump_packed(1)


def phase_fused(engine, keys, reads_packed, stream_P: int):
    """The fused reads path over device-resident 2-bit reads: the first
    BENCH_FUSED_READS reads (200,000: 24.0 M windows, one fused dispatch
    under COLORID_FUSED_MAX_WINDOWS, 28,000,000 by default). Returns
    (k-mers/s, the full set's SearchResult or None, the prefix's parity:
    None when the full set was used, else whether one stream dispatch over
    the prefix's host-counted k-mers (padded to at least stream_P) gave
    the same SearchResult). Times the queued fused dispatches, or the synchronous
    search_reads span where the single dispatch is ineligible or its
    capacity guard trips, and logs which route it timed."""
    from .ops.stream_query import PC

    R = min(knob("BENCH_FUSED_READS", 200_000), reads_packed.shape[0])
    sub = reads_packed[:R]
    full = R == reads_packed.shape[0]
    if full:
        n_expected = keys.shape[0]
    else:
        pfx_packed, pfx_qc = _prefix_kmers(sub)
        n_expected = pfx_packed.shape[0]
    reads_dev = torch.from_numpy(np.ascontiguousarray(sub).view(np.int32)).to(engine.device)
    lens_dev = torch.full((R,), READ_LEN, dtype=torch.int32, device=engine.device)
    disp_async = knob("BENCH_FUSED_DISPATCHES", 4)
    holder = {}

    def run_async():
        holder["out"] = _stacked(
            lambda: engine.search_reads_fused_async(reads_dev, lens_dev, k=K, L=READ_LEN,
                                                    filter_t=1),
            disp_async, engine.search_reads_fused_finish,
        )

    def run_sync():
        holder["out"] = engine.search_reads(reads_dev, lens_dev, k=K, L=READ_LEN, filter_t=1)

    run, route, disp = run_async, "queued single fused dispatches", disp_async
    try:
        run()
    except ValueError as e:  # the single fused dispatch is ineligible
        log(f"fused async ineligible ({e})")
        holder["out"] = None
    if holder["out"] is None:  # ineligible, or a capacity trip in one dispatch
        run, route, disp = run_sync, "synchronous search_reads", 1
        run()
    log(f"fused route timed: {route}")
    res, n_u = holder["out"]
    if n_u != n_expected:  # device counting against host counting
        raise RuntimeError(f"device count mismatch: {n_u} != {n_expected}")
    best = _trials("reads", run, 3, 90)
    value = disp * n_u / best
    log(f"[fused] {value / 1e6:.2f} M k-mers/s ({R} reads, {disp} x {n_u} k-mers in "
        f"{best:.4f}s; {1e3 * best / disp:.3f} ms a dispatch; route: {route})")
    if full:
        return value, res, None
    # prefix cross-check: one stream dispatch over the independently
    # counted prefix k-mers must give the same SearchResult
    P = max(-(-n_expected // PC) * PC, stream_P)
    chk = engine.search_keys_dev(*_device_batch(pfx_packed, pfx_qc, P, engine.device), k=K)
    if chk is None:
        raise RuntimeError("prefix cross-check: stream capacity exceeded")
    same = same_result(chk, res)
    if same:
        log(f"parity check: fused prefix SearchResult matches the stream path "
            f"(total hits {int(chk.counts.sum())})")
    else:
        log(f"PARITY MISMATCH: fused prefix vs stream counts differ "
            f"({res.counts.tolist()} vs {chk.counts.tolist()})")
    return value, None, same


def classic_P(n: int, chunk: int) -> int:
    """The classic batch's padded length: n rounded up to a multiple of both
    the generic gather's chunk and the classic stream's EPC_CL."""
    from .ops.stream_query import EPC_CL

    unit = math.lcm(chunk, EPC_CL)
    return -(-n // unit) * unit


def phase_classic(keys, qcounts, packed, genomes, device):
    """The reference-placement (classic) index: device-resident packed
    k-mers through the generic gather (padded to classic_P), then through
    the classic sorted-row stream (the same buffers' prefix padded to
    EPC_CL). Returns (k-mers/s, {"generic": SearchResult, "stream":
    SearchResult}, whether the two agree); the stream's rate counts only
    when they do."""
    from .engine import QueryEngine
    from .ops.stream_query import EPC_CL

    index = build_or_load_index(False, genomes)
    engine = QueryEngine(index, chunk=1 << 20, device=device)
    n = packed.shape[0]
    P = classic_P(n, min(engine.chunk, 1 << 20))
    pk_dev, qc_dev = _device_batch(packed, qcounts, P, engine.device)
    # the stream takes a prefix of the same buffers, padded to EPC_CL only
    P_s = -(-n // EPC_CL) * EPC_CL
    pk_s, qc_s = pk_dev[:P_s], qc_dev[:P_s]
    disp = knob("BENCH_STREAM_DISPATCHES", 4)
    results = {}

    def make_run(name, dispatch):
        def run():
            results[name] = _stacked(dispatch, disp, engine.search_keys_dev_finish)
        return run

    run_g = make_run("generic", lambda: engine.search_keys_dev_generic_async(
        pk_dev, qc_dev, K, capO=P))
    run_g()
    best = _trials("classic-generic", run_g, 2, 60)
    value = disp * n / best
    log(f"[classic] generic {value / 1e6:.2f} M k-mers/s ({disp} dispatches x {n} "
        f"k-mers ({P} slots) in {best:.4f}s; {1e3 * best / disp:.3f} ms a dispatch)")
    run_s = make_run("stream", lambda: engine.search_keys_dev_classic_async(pk_s, qc_s, K))
    run_s()
    if results["stream"] is None:
        raise RuntimeError("classic stream residual capacity exceeded")
    same = same_result(results["stream"], results["generic"])
    if not same:
        log("PARITY MISMATCH: classic stream vs generic per-color counts "
            f"({results['stream'].counts.tolist()} vs {results['generic'].counts.tolist()}); "
            "keeping the generic number")
        return value, results, False
    log("parity check: classic stream and generic SearchResults identical")
    best_s = _trials("classic-stream", run_s, 3, 90)
    value_s = disp * n / best_s
    log(f"[classic] stream {value_s / 1e6:.2f} M k-mers/s ({disp} dispatches x {n} "
        f"k-mers ({P_s} slots) in {best_s:.4f}s; {1e3 * best_s / disp:.3f} ms a dispatch)")
    return max(value, value_s), results, True


def write_pairs(genomes, n_pairs: int, fq1: str, fq2: str) -> None:
    """n_pairs read pairs drawn as the JAX bench draws them
    (default_rng(7), 150 bp mates, insert 500, the second mate reverse
    complemented) from the genomes."""
    rng = np.random.default_rng(7)
    gs = [g.tobytes().decode() for g in genomes]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    with gzip.open(fq1, "wt") as f1, gzip.open(fq2, "wt") as f2:
        for i in range(n_pairs):
            g = gs[int(rng.integers(0, len(gs)))]
            s = int(rng.integers(0, len(g) - 500))
            r1 = g[s : s + 150]
            r2 = g[s + 350 : s + 500].encode().translate(comp)[::-1].decode()
            f1.write(f"@r{i}\n{r1}\n+\n{'I' * 150}\n")
            f2.write(f"@r{i}\n{r2}\n+\n{'I' * 150}\n")


def phase_read_id(engine, genomes) -> float:
    """read_id pairs/s on BENCH_RID_READS synthetic read pairs (the
    reference's hot path, read_id_mt_pe.rs:701-835): one warm run, then up
    to 10 trials."""
    from .pipelines.read_id import read_id

    n_pairs = knob("BENCH_RID_READS", 20_000)
    cache = cache_dir()
    fq1, fq2 = os.path.join(cache, "rid_r1.fq.gz"), os.path.join(cache, "rid_r2.fq.gz")
    write_pairs(genomes, n_pairs, fq1, fq2)
    out = os.path.join(cache, "rid_out")
    read_id([fq1, fq2], engine, prefix=out)  # warm
    dt = _trials("read_id", lambda: read_id([fq1, fq2], engine, prefix=out), 10, 60)
    log(f"[read_id] {n_pairs / dt:.0f} pairs/s ({n_pairs} pairs in {dt:.3f}s)")
    return n_pairs / dt


# ---------------------------------------------------------------------------


def emit_json(rates: dict, parity: list[str], device: str) -> None:
    """Print the ONE JSON line from the measured rates."""
    best = max(rates.get(k) or 0.0 for k in RATES)
    rec = {
        "metric": "queried_kmers_per_s_1chip",
        "value": round(best),
        "unit": "kmers/s",
        "vs_baseline": round(best / BASELINE_KMERS_PER_S, 3),
    }
    for k in RATES:
        if rates.get(k):
            rec[f"{k}_kmers_per_s"] = round(rates[k])
    if rates.get("read_id"):
        rec["read_id_pairs_per_s"] = round(rates["read_id"])
    if parity:
        rec["parity"] = "+".join(parity)
    rec["device"] = device
    print(json.dumps(rec), flush=True)


def kernel_wrappers():
    """The fifteen kernel wrappers, each with its launch count (the epilogue
    kernel has three: its AND-words mode, its gather mode (the generic
    gather) and the classic stream's sorted-words mode; the blocked
    stream's glue two: its plan, and its
    tail with the residual gather; the streams' key sort one; the reads
    routes' run counts one, for all its modes, and their value sort one;
    the read classifier's kernel two: its order-free pass, and its exact
    replay with the first hits)."""
    from .ops.extract import run_counts, value_sort, window_keys
    from .ops.hash_torch import placement
    from .ops.query import (
        _accumulate_one, _accumulate_sorted_words, _accumulate_tail, readid_exact,
        readid_orderfree,
    )
    from .ops.stream_query import (
        classic_words, sort_payloads, stream_chunk_plan, stream_probe, stream_probe_raw,
        stream_tail,
    )

    return (classic_words, stream_probe, stream_probe_raw, placement, window_keys,
            _accumulate_tail, _accumulate_one, _accumulate_sorted_words, stream_chunk_plan,
            stream_tail, sort_payloads, run_counts, value_sort, readid_orderfree, readid_exact)


# the kernels each phase must launch on the card (the wrappers' counts)
PHASE_KERNELS = {
    "stream": ("stream_probe", "placement", "_accumulate_tail", "stream_chunk_plan",
               "stream_tail", "sort_payloads"),
    "generic": ("placement", "_accumulate_one"),
    "fused": ("stream_probe", "placement", "window_keys", "_accumulate_tail",
              "stream_chunk_plan", "stream_tail", "run_counts", "value_sort"),
    "classic": ("classic_words", "placement", "_accumulate_one", "_accumulate_sorted_words",
                "sort_payloads"),
    "read_id": ("window_keys", "readid_orderfree"),
}


def card_line() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except OSError as e:
        return f"nvidia-smi failed: {e}"
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else (
        f"nvidia-smi failed: {r.stderr.strip()}")


def main(argv: list[str] | None = None) -> int:
    from .runtime import resolve_device

    ap = argparse.ArgumentParser(prog="python -m colorid_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    on_card = device.type == "cuda"
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    if on_card:
        log(f"card: {card_line()}; torch {torch.__version__} cuda {torch.version.cuda}")

    from .engine import QueryEngine

    t0 = time.time()
    genomes, reads = synth_cell(SEED, knob("BENCH_MAX_GENOMES", 21),
                                knob("BENCH_GENOME_LEN", 3_000_000), N_SOURCES,
                                knob("BENCH_N_READS", 400_000))
    keys, qcounts, packed, reads_packed = make_query_kmers(reads)
    log(f"query: {keys.shape[0]} filtered k-mers from {reads.shape[0]} reads of "
        f"{len(genomes)} x {len(genomes[0])} bp genomes in {time.time() - t0:.1f}s")
    bengine = QueryEngine(build_or_load_index(True, genomes), chunk=1 << 21, device=device)

    rates: dict[str, float] = {}
    parity: list[str] = []
    failed: list[str] = []
    wrappers = kernel_wrappers()
    totals = {kn.__name__: 0 for kn in wrappers}

    def phase(label: str, fn):
        before = [kn.launches for kn in wrappers]
        t0 = time.time()
        try:
            return fn()
        except Exception:
            log(f"{label} phase failed:\n{traceback.format_exc()}")
            failed.append(label)
            return None
        finally:
            used = {kn.__name__: kn.launches - b for kn, b in zip(wrappers, before)}
            for kname, v in used.items():
                totals[kname] += v
            log(f"[{label}] {time.time() - t0:.1f}s; kernel launches {used}")
            missing = [k for k in PHASE_KERNELS[label] if on_card and not used[k]]
            if missing and label not in failed:
                log(f"{label} phase launched no {missing} kernel on the card")
                failed.append(label)

    res_a = phase("stream", lambda: phase_stream(bengine, keys, qcounts, packed))
    res_g = phase("generic", lambda: phase_generic(bengine, keys, qcounts, packed))
    if res_g:
        rates["generic"] = res_g[0]
    if res_a and res_g and not same_result(res_a[1], res_g[1]):
        log("PARITY MISMATCH: stream and generic SearchResults differ "
            f"({res_a[1].counts.tolist()} vs {res_g[1].counts.tolist()})")
        parity.append("stream")
    elif res_a:
        if res_g:
            log("parity check: stream and generic SearchResults identical")
        rates["stream"] = res_a[0]
    from .ops.stream_query import PC

    stream_P = -(-packed.shape[0] // PC) * PC
    res_b = phase("fused", lambda: phase_fused(bengine, keys, reads_packed, stream_P))
    if res_b:
        value, full_res, same = res_b
        what = "fused_mismatch"  # the prefix cross-check's verdict
        if full_res is not None and res_a:
            what, same = "fused_full", same_result(res_a[1], full_res)
            log("parity check: stream and fused SearchResults identical" if same else
                "PARITY MISMATCH: stream and fused SearchResults differ "
                f"({res_a[1].counts.tolist()} vs {full_res.counts.tolist()})")
        if same is False:
            parity.append(what)
        else:
            rates["fused"] = value
    res_c = phase("classic", lambda: phase_classic(keys, qcounts, packed, genomes, device))
    if res_c:
        rates["classic"] = res_c[0]
        if not res_c[2]:
            parity.append("classic")
    rid = phase("read_id", lambda: phase_read_id(bengine, genomes))
    if rid:
        rates["read_id"] = rid
    log(f"[launches] {json.dumps(totals)}")
    f = next(kn for kn in wrappers if kn.__name__ == "run_counts")
    log(f"[launches by mode] run_counts {json.dumps(f.launches_by_mode)}")
    from .ops.query import readid_launches

    log(f"[launches by mode] readid {json.dumps(readid_launches)}")
    if not any(rates.get(k) for k in RATES):
        log("bench: no rate measured")
        return 1
    emit_json(rates, parity, name)
    if failed or parity:
        log(f"bench: failed phases {failed}, parity mismatches {parity}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
