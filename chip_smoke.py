#!/usr/bin/env python3
"""Smoke run of the PyTorch port (colorid_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare OTHER_ROOT

With --compare it measures this checkout against the one at OTHER_ROOT (for
example the parent commit, unpacked with git archive) on one cell, in the
turns other, this, this, other, each a fresh process: the [parity],
[kernel] sort (kernel E on both dispatches' own sort inputs), [panel]
(the 1,000-accession panel built from the seed in each turn), [reads],
[fused], [kernel] readid (with CLI read_id's files against --device cpu
by every route) and [mproc] phases below with their [profile] lines. It
prints no result line.

Phases, each printing its lines (any failure exits non-zero):

1. card: the card's name and power limit (nvidia-smi); build every CUDA
   kernel from csrc/ (set-up time).
2. kernel: each kernel (classic_word, stream_probe, stream_probe_raw, and
   the hand kernels for code that the JAX package leaves to XLA: placement
   and window_keys; the epilogue, the stream glue, the key sort, the
   reads routes' run counts and their value sort in phases 4-epilogue,
   4-stream_tail, 4-sort, 4c-run_counts and 4c-value_sort) against
   its plain PyTorch twin on the card at its main
   path's shapes (bitwise), with its time, the twin's, one PyTorch library
   call's where one computes the same function, and the least time the
   card could take (bound: bytes, or for the two hand kernels also the
   SASS instructions of their loop body at the card's issue rate);
   stream_probe_raw also on stream_probe's inputs, as the time of the
   gather that both share; placement and window_keys also across a grid
   of k, H, bloom_size, layout, stride and N bases; placement also in its
   packed mode (the blocked stream's sort key and packed offsets).
3. main path, twice, through the port's CLI at the bench configuration's
   size (21 synthetic ~3 Mbp genomes, -k 31 -n 4 -s 50000000; search -f 1
   on 400,000 x 150 bp reads from 3 of them, its k-mers counted on the card
   (the default route); search -s on one genome):
   a classic index (build) and a blocked one (build --blocked, layout v4,
   whose search -f 1 takes the fused reads path). Each path's kernel must
   have been launched while that path ran and while its search -f 1 ran,
   placement while search -f 1 and search -s ran, window_keys while
   search -f 1 ran (search -s counts its k-mers on the host),
   no stream batch may fall back, and the blocked TSV must be
   byte-identical with COLORID_STREAM=0; both searches of each index must
   end in the epilogue kernel (the classic stream in its sorted-words
   mode, the probe stream's residual pass in its AND-words mode), and
   search -f 1 must count its k-mers through kernel F (the counted route's
   compaction on the classic index, the chunked fused route on the
   blocked one).
4. parity, for each index: the same search_keys through the generic gather
   (COLORID_STREAM=0) must give an identical SearchResult; k-mers/s for
   both paths and for the device-resident dispatches, and one
   device-resident stream dispatch's device time by kernel (torch.profiler);
   on the classic index also the port bench's classic generic dispatch
   (the k-mers device-resident through search_keys_dev_generic_async),
   equal to search_keys, and its profile ([profile] generic classic W 1: no
   index, gather or reduction kernel: kernel C gathers);
   the probe kernel on the inputs that the blocked dispatch hands it, against
   its twin and timed alone ("real segment").
4-epilogue. The epilogue kernel against its twins, all four accumulators
   bitwise: in its sorted-words mode on the inputs that the device-resident
   classic dispatch hands it (8,650,752 k-mers, H 4, C 21: the words in row
   order, the rows, the sort's permutation, the window plan), in its
   AND-words mode on that batch's AND words and on synthetic batches (W 1
   / C 32 with hot histogram bins, W 8 / C 200, an overflow list from 1,000
   past capO), and in its gather mode (the generic gather: a k-mer's rows
   read, ANDed and tested in the kernel) on the calls of the port bench's
   classic generic dispatch (W 1; the AND-words mode also on their AND
   words); each one's time, its twin's and its bound, torch.take of the
   gather's row words as the gather mode's library call, and the main
   path's launches.
4-sort. Kernel E (the streams' key sort with its payloads) against its
   twin, bitwise, on the inputs that the device-resident dispatches hand
   it (the blocked batch's 30-bit key with its packed offsets, also with
   the generated index from a base; the classic batch's 26-bit rows with
   their index widened to int64) and on edge cases (all keys equal, keys
   descending, bits 1 and 31, P not a multiple of the tile, P 300, the
   blocks of a matrix past 2^20 blocks with three operands, and at
   2,097,152 keys the main cell's skew: a key with 10 % of the probes, four
   rows with 1 % each, every key's top bits equal, one pass); each
   dispatch's digit skew; E's time on each dispatch's batch beside its
   twin's, torch.sort's with the gathers (the library call) and the bound,
   each of its launches apart; and past 2^20 blocks, E's sort of the
   21-bit block with three operands beside torch.sort of the int64 key
   block << 11 | frequency with the gathers (the route it replaced there).
   The blocked and classic dispatches' [profile] lines must show no
   torch.sort radix kernel.
4-stream_tail. Kernel D (the blocked stream's plan with its residual
   chunk list, and its tail with the residual gather: two launches a
   batch) against its twins, bitwise, on the inputs that the
   device-resident blocked dispatch hands each entry point (9,437,184
   slots, the frequency in an int32 key that kernel E sorted with its
   payloads); the card's route against the twins' route on the card (all
   four accumulators and n_drop) on that batch, in clipped mode with the
   index carried by kernel E, without the frequency in the key as past
   2^20 blocks (three operands), with every frequency above the histogram (the overflow list
   past OVER_CAP and capO) and on a sparse batch (more residual chunks
   than nch); kernel A's packed mode on the dispatch's k-mers; the times
   of D1 and D2 and their twins', the byte bound beside the five-launch
   design's, the main path's launches (one plan and one tail a batch).
   The blocked dispatch's [profile] line must show no index kernel; it
   sums kernel D's kernels and gives the host's enqueue time of one
   dispatch.

4a. bench: python -m colorid_tpu_torch.bench in a subprocess on phase 3's
   two indexes (handed over in its cache under its names): rc 0, one JSON
   line with the stream, generic, fused, classic and read_id rates above 0,
   no parity key, the card's name; the bench itself fails a phase whose
   kernel was not launched (stream_probe, classic_word, placement,
   window_keys, the epilogue's two modes) and any parity check that does
   not hold.
4b. reads (the read classifier and device k-mer counting) on both indexes
   of phase 3: CLI read_id on 204,000 seeded read pairs (3 source genomes,
   2 % junk, N bases, first mates shorter than k, lowercase, duplicates):
   pairs/s, >= 95 % of the source pairs accepted for their genome, no junk
   pair accepted for a genome; on 5,000 pairs the card's _reads.txt and
   _counts.txt equal --device cpu's byte for byte; COLORID_RID_SAFE=0 and
   COLORID_RID_READS=0 give the default route's bytes; batch_id on two
   samples equals read_id on each; read_filter writes exactly the pairs
   that _reads.txt selects; CLI search -f 1 with device counting
   (COLORID_SEARCH_READS=1) equals host counting (=0) byte for byte;
   QueryEngine.search_reads on device-resident reads equals search_keys on
   host-counted k-mers; torch.profiler breakdowns of one search_reads call
   and of one order-free dispatch of 8,192 pairs, and read_id's wall-time
   split.
4c. fused: search_reads on those 400,000 device-resident reads (52 M
   windows) on the blocked index through the chunked fused route (the
   default above COLORID_FUSED_MAX_WINDOWS), the single fused dispatch and
   the counted route (extract_count, then the probe stream): the same
   answers, stream_probe launched and n_drop 0 on both fused routes,
   kernel F launched in each route; k-mers/s and a device breakdown of
   each (kernel F's kernels summed); search_reads_fused_async on
   two halves, one stacked fetch, equal to search_reads on each half.
4c-run_counts. Kernel F (the reads routes' run counts, -f filter and
   compactions) against its twin, bitwise, in each mode on the inputs that
   those routes hand it on the 400,000 reads: pairs in the single fused
   dispatch, counts, partition and totals in the chunked route, compact in
   the counted route; and on edge cases of them (a SENT run of 1,500,000
   slots, P not a multiple of its tile, every slot kept, thousands of
   tiles that keep nothing or hold no live slot, partition at caps from 0
   to P). Each mode's time a call, its twin's, its byte bound and the
   share of it reached, the phase's seconds, and the main path's
   launches by phase ([main]'s search -f 1 must launch it on both
   indexes).
4c-value_sort. Kernel G (the reads routes' value sort of the int64 keys
   over their 2k bits) against its twin, bitwise, on the keys those
   routes hand it on the 400,000 reads: the single fused dispatch's
   52,002,816, a chunk's and the merge's with the counts as payload in
   the chunked route, the counted route's. Each one's time, its twin's,
   torch.sort(stable) (+ the gather) as the library's, its byte bound,
   the single call's launches apart, the phase's seconds and the main
   path's launches by phase ([main]'s search -f 1 must launch it on both
   indexes). The [profile] fused lines sum G's kernels and must show no
   torch.sort radix kernel.
4d. serve: the HTTP server on the card (a thread of this process) on
   both indexes: /healthz and /info against the index; /search with 20,000
   of the reads (filter 1, 0, -1, gene) equal to host counting, launching
   stream_probe (v4, every body) and classic_word (classic, filter 0);
   /classify with 2,000 pairs equal to classify_batch on a CPU engine; 64
   concurrent 1-pair requests equal to a sequential run in fewer
   classify_batch calls; /search latency and /classify requests/s.
4e. panel: a classic index of 1,000 accessions at the main cell's -k 31
   -n 4 -s 50,000,000 built on the card from the seed (colors 0-20 the
   classic index's columns, each further color the Bloom column of
   3,000,000 seeded 31-mers, placed by kernel A and ORed in by the device
   build's scatter-OR; rows of 32 words, 6.4 GB): search_keys on the main
   query's host-counted k-mers, search_keys_dev_generic_async on them
   device-resident and search_reads on the 400,000 device-resident reads,
   all ending in kernel C's gather mode at W 32: the three equal each
   other, the twin route on the card and, on a prefix, a numpy oracle;
   colors 0-20 count what the classic index counted; k-mers/s, [profile]
   generic panel W 32, build, H2D and search seconds, max_memory_allocated,
   and the gather mode (and the AND-words mode at W 32) on the dispatch's
   own calls against the twin, timed, bounded and beside torch.take.
5. sharded paths on a logical mesh, every shard on the one card:
   - color layout at full width: a seeded 4,096-color, H = 2, k = 31, v4
     index of 4,194,304 rows placed for 4 color shards (2 GiB of matrix)
     on a (1, 4) mesh; 16,777,216 distinct k-mers through
     ShardedQueryEngine.search_keys must take the raw probe stream (one
     stream_probe_raw launch per shard, n_drop 0) and equal the same
     engine's generic path and the single-device QueryEngine;
   - the entry points: CLI build --blocked --color-shards 4 on 1,200
     synthetic 50 kbp genomes, CLI search on that index, and
     ShardedQueryEngine on the loaded index: the same report lines;
   - row layout: the blocked index of phase 3 on a (1, 4) row mesh: the
     probe stream per row shard equals the single-device results.
5c. mproc: ShardedQueryEngine on a (1, 4) row mesh whose shards live in
   two processes, two per rank (this script in --mproc-worker mode; gloo
   with both ranks on one card, NCCL with one card each where there are
   two or more): search_keys with the k-mers of phase 3's search -f 1 on
   the classic index and, through the generic gather (the JAX package's
   route across processes), on the v4 one; read_id of the reads cell's
   204,000 pairs (byte-identical to the single-device CLI's files);
   search_reads on its 400,000 reads; build_matrix_rowshard of the classic
   index's columns across the ranks and its search. Every output equal on
   both ranks and to the single-device engine; k-mers/s, pairs/s, the
   seconds in collectives and each rank's max_memory_allocated.
6. devbuild, on the phase-3 cell: CLI build --device-build -t 8 (the
   scatter-OR on the card, one per accession) and the host build back to
   back (host, device), each .bxi byte-identical to phase
   3's host build, and search -f 1 on a device-built one the same TSV
   through classic_word; then the row-sharded build (build_matrix_rowshard
   + pack_blocks_rowshard) of the index's row lists on a (1, 4) row mesh: its
   shards equal device_put_rowshard's, and ShardedQueryEngine(
   sharded_matrix=...) with no host matrix gives the host-matrix row
   engine's SearchResult and the single-device answers; the same from the
   blocked v4 index's columns, whose row shards stream (stream_probe).
7. wide: a classic index of two seeded 40 kbp genomes at -k 27 -n 2 -s
   3,000,000,000 (12 GB of matrix on the card), built with CLI build
   --device-build (which scatters on the host past 2^31 rows, as the JAX
   package does): search_keys equal to a numpy oracle through the wide
   route (the generic scan over int64 rows past 2^31); classify_batch, the
   search's counting path and CLI read_id on 2,000 pairs call their source
   genome through the wide routes; k-mers/s of the int64 scan beside
   query_accumulate_scan_wide on split rows and the int32 scan, pairs/s,
   host peak RSS and the card's max_memory_allocated.

Then one JSON line with the kernel table, the card line, and last
{"ok": true, "device": {...}}. Without a CUDA card, or outside a checkout
of the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
K, HASHES, BLOOM = 31, 4, 50_000_000
N_GENOMES, GENOME_LEN, N_SOURCES = 21, 3_000_000, 3
N_READS, READ_LEN, SUB_RATE = 400_000, 150, 0.005
SEED = 2026
DEVICE = "cuda"  # the CPU rehearsal of phases 3-4 sets "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over reps launches (CUDA events), after a
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


MARKER = "spin_kernel"  # torch.cuda._sleep's kernel: the edges of a trace
TRACE_PAD_S = 0.05  # idle host time on either side of a trace's calls
TRACE_LEAD = 32  # markers of ~1 ms before the calls: a trace loses its first records
TRACE_TAIL = 2  # markers after the calls


def _kernel_name(key: str) -> str:
    """A device event's name without namespace, template or arguments."""
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return key.split("<")[0].split("(")[0].split("::")[-1].strip() or key[:40]


def trace(fn, reps: int = 1, attempts: int = 3):
    """(torch.profiler trace, host-clock ms, gap) of reps calls of fn(),
    after a warm-up call. The calls sit between TRACE_LEAD launches of a
    marker kernel (MARKER) of about 1 ms each and TRACE_TAIL more, with
    TRACE_PAD_S of idle host time on either side inside the profiler's
    window. After a minute or two in one process the profiler loses a
    trace's first device records, a few ms of them (a run of 860 s
    recorded no kernel of some 1.5 ms traces; late in a run, the records
    of its first 60 ms, 50 of them idle): the leading markers take that
    loss. A trace without a marker on either side of its device
    events is taken again, up to ``attempts`` times; gap is "" for a
    complete trace, else what ``trace_gap`` says of the last. A trace
    that lost any marker is logged."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_PAD_S)
            for _ in range(TRACE_LEAD):
                torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
            for _ in range(TRACE_TAIL):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
        gap, lost = trace_gap(prof)
        if lost:
            log(f"[profile] a trace lost markers: {lost}")
        if not gap:
            break
    return prof, wall_ms, gap


def trace_gap(prof) -> tuple[str, str]:
    """(gap, lost): gap "" where the trace has a marker before its device
    events and one after them, else says so; lost "" where it kept every
    marker, else how many it kept on each side and where its device and
    host events lie (ms after the trace's start)."""
    import torch

    host, dev, marks = [], [], []
    for e in prof.events():
        span = (e.time_range.start / 1e3, e.time_range.end / 1e3)
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append(span)
        else:
            (marks if _kernel_name(e.name) == MARKER else dev).append(span)
    first = min((s for s, _ in dev), default=None)
    before = (sum(1 for s, _ in marks if s <= first) if dev
              else min(TRACE_LEAD, len(marks)))
    after = len(marks) - before
    if before == TRACE_LEAD and after == TRACE_TAIL:
        return "", ""
    where = lambda x: (f"{min(s for s, _ in x):.1f}-{max(e for _, e in x):.1f} ms" if x
                       else "none")  # noqa: E731
    lost = (f"{before} of {TRACE_LEAD} before the calls, {after} of {TRACE_TAIL} after; "
            f"device events {where(dev)}, host events {where(host)}")
    return ("" if before and after else f"trace incomplete: {lost}"), lost


def device_times(prof) -> dict:
    """A torch.profiler trace's device work by kernel: {name: [ms, count]},
    the name without namespace, template or arguments (the aten ops that
    launched the kernels repeat their time and are left out, and so is
    the marker kernel)."""
    import torch

    by: dict[str, list] = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        name = _kernel_name(e.key)
        if name == MARKER:
            continue
        acc = by.setdefault(name, [0.0, 0])
        acc[0] += us / 1e3
        acc[1] += e.count
    return by


def device_ms(fn, reps: int, kernels: tuple) -> tuple[float, str]:
    """(mean device ms a call of fn() keeps the card busy, its kernels and
    memsets summed, over a trace of reps calls; the trace's gap): unlike
    cuda_ms, not paced by the host where a call's host work takes longer
    than its device work. A trace whose count of the named kernels is not
    the same positive number for every call is taken again, up to three
    times, and then raises."""
    for _attempt in range(3):
        prof, _ms, gap = trace(fn, reps)
        by = device_times(prof)
        n = sum(by[k][1] for k in kernels if k in by)
        if n and n % reps == 0:
            return sum(ms for ms, _n in by.values()) / reps, gap
    raise AssertionError(f"device_ms: {n} launches of {kernels} in {reps} calls "
                         f"({gap or 'markers on both sides'})")


# -- phase 2: each kernel against its twin ---------------------------------------


def classic_kernel_phase(card: str) -> dict:
    import torch

    from colorid_tpu_torch.ops import stream_query as sq

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows_matrix = BLOOM  # 50,000,000 one-word rows -> [390625, 128] int32
    blocks2 = torch.randint(
        -(2**31), 2**31, (rows_matrix // 128, 128), generator=g,
        dtype=torch.int64, device=dev,
    ).to(torch.int32)
    # the main path's shapes: ~9M distinct k-mers x 4 hashes, padded to
    # EPC_CL k-mers, rows sorted ascending
    P = 35 * sq.EPC_CL * HASHES  # 36,700,160 probes
    row_s, _ = torch.sort(torch.randint(
        0, rows_matrix, (P,), generator=g, dtype=torch.int64, device=dev,
    ).to(torch.int32))
    # sparse: 64 chunks spread over the whole matrix leave probes outside
    # their chunk's window
    row_sparse, _ = torch.sort(torch.randint(
        0, rows_matrix, (64 * sq.PC_CL,), generator=g, dtype=torch.int64,
        device=dev,
    ).to(torch.int32))
    planes = sq._n_planes(N_GENOMES)
    errs = []
    for name, rs in (("dense", row_s), ("sparse", row_sparse)):
        tb, inwin2d = sq.classic_plan(rs, blocks2.shape[0])
        got = sq.classic_words(blocks2, rs, tb, planes=planes)
        want = sq.classic_words_plain(blocks2, rs, tb, planes=planes)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        n_out = int((~inwin2d).sum())
        log(f"[kernel] classic_word {name}: P={rs.shape[0]} out_of_window={n_out} "
            f"max_abs_err={err} bitwise_equal={bool(torch.equal(got, want))}")
        if not torch.equal(got, want):
            raise AssertionError(f"classic_word kernel != twin ({name})")
        if name == "sparse" and n_out == 0:
            raise AssertionError("sparse case left no out-of-window probes")
        errs.append(err)
    tb, inwin2d = sq.classic_plan(row_s, blocks2.shape[0])
    flat = blocks2.view(-1)
    rows64 = row_s.to(torch.int64)
    ms = cuda_ms(lambda: sq.classic_words(blocks2, row_s, tb, planes=planes), 20)
    plain_ms = cuda_ms(lambda: sq.classic_words_plain(blocks2, row_s, tb, planes=planes), 5)
    library_ms = cuda_ms(lambda: torch.take(flat, rows64), 20)
    n_bytes, n_sectors = classic_bytes(row_s, inwin2d, tb.numel())
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    old_bytes = classic_bytes_by_word(row_s, tb.numel())
    log(f"[kernel] classic_word P={P} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms(torch.take)={library_ms:.4f} bound_ms={bound_ms:.4f} "
        f"(bytes={n_bytes}, sectors={n_sectors}; counted as 12 bytes per probe and 4 "
        f"per distinct word instead: bytes={old_bytes} "
        f"bound_ms={old_bytes / HBM_BYTES_PER_S * 1e3:.4f}) on {card}")
    del blocks2, row_s, row_sparse, flat, rows64
    torch.cuda.empty_cache()
    return {
        "name": "classic_word",
        "route": "cuda",
        "source": "colorid_tpu_torch/csrc/classic_word.cu",
        "replaces": "colorid_tpu/ops/stream_query.py:719",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
    }


def _probe_inputs(g, n_blocks: int, P: int, C: int, num_hash: int, n_hot: int,
                  span=None):
    """Synthetic inputs of the probe kernel on the card: a block matrix in
    which most rows of block b hold just color b % n_hot (so that, as on
    the main path with its N_SOURCES source genomes, most probes are unique
    hits on a few colors with a few frequencies, and the same histogram
    cells take most of the traffic), and P probes sorted by block over
    ``span`` blocks with split-lane offsets and small frequencies."""
    import torch

    dev = torch.device("cuda")
    wpad = 1 << (((C + 31) // 32) - 1).bit_length()
    rpb = 128 // wpad
    rows = n_blocks * rpb
    color = (torch.arange(rows, device=dev) // rpb) % n_hot
    u = torch.rand(rows, generator=g, device=dev)
    m = torch.zeros((rows, wpad), dtype=torch.int64, device=dev)
    m.scatter_(1, (color // 32)[:, None], (1 << (color % 32))[:, None])
    m = torch.where((u < 0.95)[:, None], m, 0)  # 5 % absent rows
    noise = torch.randint(0, 2**32, (rows, wpad), generator=g, dtype=torch.int64, device=dev)
    noise &= torch.randint(0, 2**32, (rows, wpad), generator=g, dtype=torch.int64, device=dev)
    m = torch.where((u > 0.9)[:, None] & (u < 0.95)[:, None], m | noise, m)
    lane = torch.arange(wpad * 32, device=dev).view(wpad, 32)
    cmask = ((lane < C).to(torch.int64) << torch.arange(32, device=dev)).sum(dim=1)
    m &= cmask
    blocks2 = torch.where(m >= 2**31, m - 2**32, m).to(torch.int32).view(n_blocks, 128)
    span = span or n_blocks
    blk_s, _ = torch.sort(torch.randint(
        0, span, (P,), generator=g, dtype=torch.int64, device=dev).to(torch.int32))
    grp = rpb // num_hash
    off = torch.zeros(P, dtype=torch.int64, device=dev)
    for h in range(num_hash):
        o = h * grp + torch.randint(0, grp, (P,), generator=g, dtype=torch.int64, device=dev)
        off |= o << (8 * h)
    qc = torch.randint(0, 12, (P,), generator=g, dtype=torch.int64, device=dev)
    big = torch.rand(P, generator=g, device=dev) < 0.001
    qc = torch.where(big, qc + 1500, qc).to(torch.int32)  # a few beyond hw
    return blocks2, wpad, blk_s, off.to(torch.int32), qc


def probe_kernel_phase(card: str) -> dict:
    import torch

    from colorid_tpu_torch.ops import stream_query as sq

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    n_blocks = -(-BLOOM // 128 // 128) * 128  # as pack_matrix_blocks pads: 390,656
    P = 8 * (1 << 20)  # one streamed segment of the main path
    cases = (
        # name, colors, hit colors, probes, blocks the probes span
        ("dense", N_GENOMES, N_SOURCES, P, n_blocks),
        ("sparse", N_GENOMES, N_SOURCES, 64 * sq.PC, n_blocks),
        ("wide", 200, 200, 1 << 20, 48 * 1024),  # wpad 8, hw 256: correctness only
    )
    errs = []
    kept = None
    for name, C, n_hot, n_probes, span in cases:
        blocks2, wpad, blk_s, off_s, qc = _probe_inputs(
            g, n_blocks if name != "wide" else span, n_probes, C, HASHES, n_hot, span)
        kw = dict(num_hash=HASHES, wpad=wpad, n_colors=C)
        shape = (sq._hist_rows(C), sq._hist_w(C))
        outs = []
        for fn in (sq.stream_probe, sq.stream_probe_plain):
            counts = torch.zeros(32 * wpad, dtype=torch.int32, device=dev)
            hist = torch.zeros(shape, dtype=torch.int32, device=dev)
            outs.append((fn(blocks2, blk_s, off_s, qc, counts, hist, **kw), counts, hist))
        torch.cuda.synchronize()
        err = max(
            int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            for a, b in zip(*outs)
        )
        equal = all(torch.equal(a, b) for a, b in zip(*outs))
        uniq, counts, hist = outs[0]
        log(f"[kernel] stream_probe {name}: P={n_probes} C={C} wpad={wpad} "
            f"unique_hits={int((uniq >= 0).sum())} valid={int((uniq > -2).sum())} "
            f"hist_sum={int(hist.sum())} max_abs_err={err} bitwise_equal={equal}")
        if not equal:
            raise AssertionError(f"stream_probe kernel != twin ({name})")
        if int((uniq >= 0).sum()) == 0 or int(hist.sum()) == 0:
            raise AssertionError(f"stream_probe {name}: no unique hit to check")
        errs.append(err)
        if name == "dense":
            kept = (blocks2, wpad, blk_s, off_s, qc, kw, shape)
        del outs
    blocks2, wpad, blk_s, off_s, qc, kw, shape = kept
    counts = torch.zeros(32 * wpad, dtype=torch.int32, device=dev)
    hist = torch.zeros(shape, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: sq.stream_probe(blocks2, blk_s, off_s, qc, counts, hist, **kw), 20)
    plain_ms = cuda_ms(
        lambda: sq.stream_probe_plain(blocks2, blk_s, off_s, qc, counts, hist, **kw), 3)
    # the gather alone: the raw kernel does the same gather, AND and counts
    # and stores its facts unfolded (12 bytes a probe where this stores 4)
    raw_counts = torch.zeros(32 * wpad, dtype=torch.int32, device=dev)
    gather_ms = cuda_ms(lambda: sq.stream_probe_raw(
        blocks2, blk_s, off_s, qc, raw_counts, num_hash=HASHES, wpad=wpad), 20)
    # the bound: each probe's 12 bytes in and 4 out, the accumulators in and
    # out, and the sectors of the counted probes' rows
    n_bytes, n_sectors = probe_bytes(blk_s, off_s, qc, wpad, HASHES, 16,
                                     counts.numel() + hist.numel())
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[kernel] stream_probe P={P} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms=null (no single PyTorch call gathers, ANDs and counts) "
        f"bound_ms={bound_ms:.4f} (bytes={n_bytes}, sectors={n_sectors}); "
        f"histogram band hf={sq._hist_band(*shape)} of hw={shape[1]} on {card}")
    log(f"[kernel] stream_probe gather-only yardstick: stream_probe_raw on the same "
        f"inputs ms={gather_ms:.4f} (stream_probe {ms:.4f}) on {card}")
    del kept, blocks2, blk_s, off_s, qc
    torch.cuda.empty_cache()
    return {
        "name": "stream_probe",
        "route": "cuda",
        "source": "colorid_tpu_torch/csrc/stream_probe.cu",
        "replaces": "colorid_tpu/ops/stream_query.py:158",
        "launches": None,  # filled from the blocked main path's run
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "gather_only_ms": gather_ms,
    }


# -- the bytes each kernel's function must move, whatever implements it -------


def sectors(word_starts, words_per_row: int) -> int:
    """Distinct 32-byte sectors of the matrix covered by rows of
    words_per_row words (a power of two) that start at the given word
    indices. Rows are aligned to their width: one of <= 8 words lies in one
    sector, a wider one covers words_per_row // 8."""
    import torch

    return int(torch.unique(word_starts // 8).numel()) * max(words_per_row // 8, 1)


def classic_bytes(row_s, inwin, n_chunks: int) -> tuple[int, int]:
    """(bytes, sectors) of the classic word gather: each probe's 4-byte
    sorted row in and 4-byte word out, the chunks' tb, and the sectors of
    the one-word rows that the in-window probes read."""
    import torch

    n = sectors(row_s.to(torch.int64)[inwin.reshape(-1)], 1)
    return row_s.numel() * 8 + n_chunks * 4 + 32 * n, n


def classic_bytes_by_word(row_s, n_chunks: int) -> int:
    """The coarser count this bound replaced, printed beside it so that
    older figures stay comparable: 12 bytes per probe (block and lane in,
    word out), the chunks' tb, and 4 bytes per distinct row word."""
    distinct = int((row_s[1:] != row_s[:-1]).sum()) + 1
    return row_s.numel() * 12 + n_chunks * 4 + distinct * 4


def probe_bytes(blk_s, off_s, qc, wpad: int, num_hash: int, per_probe: int,
                acc_words: int) -> tuple[int, int]:
    """(bytes, sectors) of a blocked probe kernel: per_probe bytes of probe
    streams in and facts out for every probe, the int32 accumulators
    (acc_words of them) in and out, and the sectors of the rows that the
    counted probes (qc > 0) read: row h at word
    blk * 128 + ((off >> 8h) & 0xFF) * wpad."""
    import torch

    live = qc > 0
    base = blk_s.to(torch.int64)[live] * 128
    offs = off_s.to(torch.int64)[live]
    starts = torch.cat([base + ((offs >> (8 * h)) & 0xFF) * wpad for h in range(num_hash)])
    n = sectors(starts, wpad)
    return blk_s.numel() * per_probe + 32 * n + 2 * 4 * acc_words, n


def stream_tail_bytes(P: int, *, pc: int, n_slots: int, n_listed: int, W: int, C: int,
                      hw: int, key_bytes: int, n_res: int, res_sectors: int,
                      n_kept: int) -> int:
    """Bytes that kernel D (csrc/stream_tail.cu) must move for one stream
    batch of P probes in chunks of pc, each input read once and each output
    its consumers read written once; the look-back's status words and
    tickets are scratch and not counted.
    D1, the plan: from the key sorted with its payloads by kernel E
    (key_bytes > 0) the key read and blk_s, qc_s written (8); from probes
    sorted already (key_bytes 0) blk_s and qc_s read (8); then qcw (4) a
    probe; the list (4 a slot) and its three counts (12) written.
    D2, the tail: uniq and qc_s (8) a probe; the probe kernel's counts and
    histogram (4 (32 W + cp hw), cp >= C: counted as C) and the
    accumulators' histogram band read and written (8 C hw); the stats read
    and written; the plan's list and counts read (4 a slot, 12) and n_drop
    written (4); each kept overflow entry's payload read and its two slots
    read and written (20). The residual gather: per slot pc rows of andw,
    present, mask, q and gidx written (4 W + 10); per row of a listed chunk
    its qc_s and qcw read (8); per residual probe its block, offsets and
    payload (12) and the 32-byte sectors its rows touch (res_sectors)."""
    d1 = P * (key_bytes + 8 + 4) + 4 * n_slots + 12
    d2 = (8 * P + 4 * (32 * W + C * hw) + 8 * C * hw + 8 * (C + W + 2) + 4 * n_slots + 12
          + 4 + 20 * n_kept)
    gather = n_slots * pc * (4 * W + 10) + 8 * n_listed * pc + 12 * n_res + 32 * res_sectors
    return d1 + d2 + gather


def stream_tail_bytes_five_launches(P: int, *, pc: int, n_slots: int, n_listed: int, W: int,
                                    C: int, hw: int, key_bytes: int, n_res: int,
                                    res_sectors: int, n_kept: int) -> int:
    """The byte count of kernel D's earlier five-launch design, printed
    beside ``stream_tail_bytes`` so that the two bounds can be compared.
    D1 wrote tb, chunk_res and chunk_real (12 a chunk) and no list; D2 read
    the chunk counts (8 a chunk), wrote and read its tile counts (16 a tile
    of 2,048) and wrote the list (4 a slot); D3 read blk_s and qc_s (8) a
    row of a listed chunk and the offsets and payload (8) of a residual
    probe. The rest as ``stream_tail_bytes``, without the plan's counts and
    n_drop."""
    n_chunks, n_tiles = P // pc, -(-P // 2048)
    d1 = P * (key_bytes + 8 + 4) + 12 * n_chunks
    d2 = (8 * P + 4 * (32 * W + C * hw) + 8 * C * hw + 8 * (C + W + 2) + 8 * n_chunks
          + 16 * n_tiles + 4 * n_slots + 20 * n_kept)
    d3 = n_slots * pc * (4 * W + 10) + 8 * n_listed * pc + 8 * n_res + 32 * res_sectors
    return d1 + d2 + d3


def run_counts_bytes(P: int, *, mode: str, weights: bool = False, rounds: int = 0,
                     cap: int = 0) -> int:
    """The bytes kernel F's function must move, each input read once and
    each output written once: the weights (4 bytes a slot, where given, and
    always in partition mode) and the sorted keys (8 a slot; in partition
    mode only those of the min(cap, P) slots it writes, since liveness
    comes from the weights alone); out, by mode, select the keys and counts
    of P >> rounds slots (the counts alone at 0 rounds: the keys pass
    through), compact the limbs and counts of every slot (12, the zero tail
    included), partition 12 a slot up to cap; and the int32 n_unique."""
    n_out = min(cap, P) if mode == "partition" else P >> rounds
    reads = (8 * n_out if mode == "partition" else 8 * P) + (
        4 * P if weights or mode == "partition" else 0)
    writes = n_out * (4 if mode == "select" and not rounds else 12)
    return reads + writes + 4


def sort_bytes(P: int, *, n_operands: int, index: bool, index64: bool) -> int:
    """Bytes that kernel E (csrc/radix_sort.cu) must move to sort P keys:
    the key and each int32 operand read once (the index is generated, not
    read), the key, each operand and the index written once (8 bytes for
    an int64 index)."""
    return P * (4 + 4 * n_operands + 4 + 4 * n_operands + (8 if index64 else 4) * index)


def value_sort_bytes(P: int, *, payload: bool) -> int:
    """Bytes that kernel G (csrc/value_sort.cu) must move to sort P int64
    keys: each key read once and written once, and the int32 payload, where
    there is one, the same: 16 bytes a key, 24 with the payload."""
    return P * (16 + 8 * payload)


def readid_bytes(n_items: int, item_bytes: int, starts, wpad: int, n_reads: int,
                 out_cols: int) -> tuple[int, int]:
    """(bytes, sectors) that kernel H (csrc/readid.cu) must move: item_bytes
    of input for each of n_items (the order-free pass: a window's int64
    key; the replay: a k-mer's rows, read and position), the 32-byte
    sectors of the matrix rows of wpad words starting at ``starts`` (the H
    rows of every distinct valid k-mer, or of every k-mer that is not
    padding), and the int32 output of out_cols a read."""
    n = sectors(starts, wpad)
    return n_items * item_bytes + 32 * n + 4 * n_reads * out_cols, n


def synth_window_keys(P: int, k: int, device, seed: int = SEED):
    """P sort keys as the reads routes hand kernel G, made on ``device``
    from ``seed``: the canonical k-windows (ops/extract.py::window_keys) of
    reads of READ_LEN bases packed at 160, at seeded places of one seeded
    genome of 3 x GENOME_LEN bases (the cell's coverage: each k-mer about
    5 times), half of them reverse-complemented; SENT_KEY where a window
    runs past its read (10 of 130 at k 31, the cell's 8 %)."""
    import torch

    from colorid_tpu_torch.ops.extract import window_keys

    L = 160
    NW = L - k + 1
    R = -(-P // NW)
    g = torch.Generator(device=device).manual_seed(seed)
    genome = torch.randint(0, 4, (N_SOURCES * GENOME_LEN,), generator=g, device=device)
    start = torch.randint(0, genome.numel() - READ_LEN, (R,), generator=g, device=device)
    codes = genome[start[:, None] + torch.arange(READ_LEN, device=device)]
    rc = torch.rand(R, generator=g, device=device) < 0.5
    codes = torch.where(rc[:, None], 3 - codes.flip(1), codes)
    codes = torch.nn.functional.pad(codes, (0, L - READ_LEN))
    shifts = 2 * (15 - torch.arange(16, device=device))
    words = (codes.view(R, L // 16, 16) << shifts).sum(-1)  # in [0, 2^32)
    words = (words - ((words >> 31) << 32)).to(torch.int32)  # the uint32 bit view
    lens = torch.full((R,), READ_LEN, dtype=torch.int32, device=device)
    return window_keys(words, lens, k=k, L=L).reshape(-1)[:P].contiguous()


def synth_merge_keys(S: int, n_chunk: int, k: int, device, seed: int = SEED,
                     cap: int | None = None):
    """The chunked route's merge input as ops/fused_reads.py::
    fused_merge_query hands it to kernel G, made on ``device`` from
    ``seed``: S chunks of n_chunk window keys (synth_window_keys), each
    sorted with its run counts (extract_sorted_counts' kernels G and F) and
    partitioned to cap (compact_sorted: the live slots in key order, then
    the dead ones; by default the engine's cap, the power of two of at
    least 2^20 above the chunks' most distinct keys, a host read), the rows
    concatenated and padded with SENT to a multiple of the probe stream's
    PC. Returns (keys int64, counts int32): at most 2 S sorted runs."""
    import torch

    from colorid_tpu_torch.ops import fused_reads as fr
    from colorid_tpu_torch.ops.extract import run_counts, value_sort

    outs = []
    for c in range(S):
        s = value_sort(synth_window_keys(n_chunk, k, device, seed=seed + c), bits=2 * k)
        outs.append(run_counts(s, mode="select"))
    if cap is None:
        n_max = int(torch.stack([o[2] for o in outs]).max())
        cap = min(1 << max(20, max(n_max, 1).bit_length()), n_chunk)
    rows_s, rows_q = zip(*(fr.compact_sorted(s, qc, cap=cap) for s, qc, _n in outs))
    return fr._pad_sent(torch.cat(rows_s), torch.cat(rows_q), fr.PC)


def raw_kernel_phase(card: str) -> dict:
    """stream_probe_raw against its twin at the color-sharded path's shape
    (one shard: wpad 32, H 2, 16,777,216 probes sorted by block over
    1,048,576 blocks), on a narrow shape and on a sparse batch."""
    import torch

    from colorid_tpu_torch.ops import stream_query as sq

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    P = 1 << 24
    cases = (
        # name, colors, hashes, probes, blocks
        ("dense", 1024, 2, P, 1 << 20),
        ("sparse", 1024, 2, 1 << 20, 1 << 20),  # runs of qc == 0
        ("narrow", 200, 4, 1 << 20, 48 * 1024),  # wpad 8, H 4
    )
    errs = []
    kept = None
    for name, C, H, n_probes, n_blocks in cases:
        blocks2, wpad, blk_s, off_s, qc = _probe_inputs(
            g, n_blocks, n_probes, C, H, C, n_blocks)
        if name == "sparse":
            i = torch.arange(n_probes, device=dev)
            qc = torch.where((i // 4096 % 4 != 0) & (i % 5 == 0), qc, 0).to(torch.int32)
        kw = dict(num_hash=H, wpad=wpad)
        counts = torch.zeros(32 * wpad, dtype=torch.int32, device=dev)
        got = (*sq.stream_probe_raw(blocks2, blk_s, off_s, qc, counts, **kw), counts)
        # the twin in slices of 2^22 probes: its [P, 128] block gather is
        # 8.6 GB at the full shape
        want_counts = torch.zeros_like(counts)
        parts = [
            sq.stream_probe_raw_plain(
                blocks2, blk_s[a:a + (1 << 22)], off_s[a:a + (1 << 22)],
                qc[a:a + (1 << 22)], want_counts, **kw)
            for a in range(0, n_probes, 1 << 22)
        ]
        want = (*(torch.cat(x) for x in zip(*parts)), want_counts)
        torch.cuda.synchronize()
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                  for a, b in zip(got, want))
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        nh = got[0]
        log(f"[kernel] stream_probe_raw {name}: P={n_probes} C={C} H={H} wpad={wpad} "
            f"counted={int((qc > 0).sum())} single_hits={int((nh == 1).sum())} "
            f"multi_hits={int((nh > 1).sum())} counts_sum={int(counts.sum())} "
            f"max_abs_err={err} bitwise_equal={equal}")
        if not equal:
            raise AssertionError(f"stream_probe_raw kernel != twin ({name})")
        if int((nh == 1).sum()) == 0 or (H == 2 and int((nh > 1).sum()) == 0):
            raise AssertionError(f"stream_probe_raw {name}: nothing to check")
        errs.append(err)
        if name == "dense":
            kept = (blocks2, wpad, blk_s, off_s, qc, kw)
        del got, want, parts
    blocks2, wpad, blk_s, off_s, qc, kw = kept
    counts = torch.zeros(32 * wpad, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: sq.stream_probe_raw(blocks2, blk_s, off_s, qc, counts, **kw), 20)

    def twin():
        for a in range(0, P, 1 << 22):
            sq.stream_probe_raw_plain(
                blocks2, blk_s[a:a + (1 << 22)], off_s[a:a + (1 << 22)],
                qc[a:a + (1 << 22)], counts, **kw)

    plain_ms = cuda_ms(twin, 2)
    # the bound: each probe's 12 bytes in and 12 out, the counts in and out,
    # and the sectors of the counted probes' rows
    n_bytes, n_sectors = probe_bytes(blk_s, off_s, qc, wpad, 2, 24, counts.numel())
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[kernel] stream_probe_raw P={P} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms=null (no single PyTorch call gathers, ANDs and counts) "
        f"bound_ms={bound_ms:.4f} (bytes={n_bytes}, sectors={n_sectors}) on {card}")
    del kept, blocks2, blk_s, off_s, qc
    torch.cuda.empty_cache()
    return {
        "name": "stream_probe_raw",
        "route": "cuda",
        "source": "colorid_tpu_torch/csrc/stream_probe.cu",
        "replaces": "colorid_tpu/ops/stream_query.py:158",
        "launches": None,  # filled from the color-sharded path's run
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }


# -- hand kernels for code that XLA compiles in the JAX package ----------------

GRID_K = (4, 7, 8, 9, 15, 16, 17, 27, 31, 32)  # each XXH3 length class and its edges


def max_sm_mhz() -> float:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return float(r.stdout.strip().splitlines()[0])


def issue_ms(n_instr: float) -> float:
    """The least time the card takes to issue n_instr thread instructions:
    one warp instruction per clock on each of an SM's four schedulers, at
    the card's maximum SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n_instr / (sms * 4 * 32 * max_sm_mhz() * 1e6) * 1e3


def sass_loop_instructions(source: str, instance: str, outer: bool = False):
    """Instructions in the innermost loop (with ``outer``, the outermost:
    a loop over items whose body holds data-dependent inner loops, each
    counted once) of the kernel instance whose mangled name holds
    ``instance`` (cuobjdump -sass of the library built from ``source``):
    what a thread issues per item where the loop body is straight code.
    A loop is a backward branch, leaving out the branches that jump back
    over an unpredicated EXIT (the out-of-line slow paths of
    warp-synchronous calls, not loops). None where the toolkit has no
    cuobjdump."""
    import re

    from colorid_tpu_torch.ops import kernels

    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    r = subprocess.run([tool, "-sass", kernels._so_path(source)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        return None
    branches, exits, inside = [], [], False
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            inside = instance in m.group(1)
            continue
        if not inside:
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+EXIT\b", line)
        if m:
            exits.append(int(m.group(1), 16))
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+[^;]*\bBRA\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)", line)
        if m:
            branches.append((int(m.group(1), 16), int(m.group(2), 16)))
    spans = [(src - dst) // 16 + 1 for src, dst in branches
             if dst < src and not any(dst < e < src for e in exits)]
    if not spans:
        return None
    return max(spans) if outer else min(spans)


def _bound(n_bytes: int, n_items: int, instr,
           what: str = "SASS instructions") -> tuple[float, str, str]:
    """(bound_ms, bound_by, how) from the bytes moved and, where the count
    is known, the instructions issued (``what`` names the count)."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    if instr is None:
        return bytes_ms, "bytes", f"bytes={n_bytes} ({bytes_ms:.4f} ms); operations: not measured (no cuobjdump)"
    ops_ms = issue_ms(n_items * instr)
    how = (f"bytes={n_bytes} ({bytes_ms:.4f} ms); operations: {instr} {what} "
           f"per item x {n_items} ({ops_ms:.4f} ms)")
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", how


def _as_i32(x):
    """int64 values in [0, 2^32) -> their int32 bit pattern."""
    import torch

    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _rand_kmers(g, n: int, k: int):
    """Packed int32 [n, 2] (the (lo, hi) bit views) of n random 2k-bit
    k-mer values on the card."""
    import torch

    lo = torch.randint(0, 2 ** min(2 * k, 32), (n,), generator=g, dtype=torch.int64,
                       device="cuda")
    hi = torch.randint(0, 2 ** max(2 * k - 32, 0), (n,), generator=g, dtype=torch.int64,
                       device="cuda")
    return torch.stack([_as_i32(lo), _as_i32(hi)], dim=1)


def _key_of(packed):
    """The sort keys (ops/extract.py::_sort_key) of packed k-mers."""
    import torch

    from colorid_tpu_torch.ops.extract import _sort_key

    p = packed.to(torch.int64) & 0xFFFFFFFF
    return _sort_key(p[:, 0], p[:, 1])


def max_abs_diff(a, b) -> int:
    """The largest |a - b| over two integer tensors of one shape, exact
    (the differences of int64 keys can overflow int64, so the few that
    differ are taken as Python ints)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"kernel output {a.dtype} {tuple(a.shape)} against twin "
                             f"{b.dtype} {tuple(b.shape)}")
    ne = a != b
    if not bool(ne.any()):
        return 0
    return max(abs(x - y) for x, y in zip(a[ne].tolist(), b[ne].tolist()))


def placement_err(a, b) -> int:
    """max_abs_diff over placement's rows, its block and offsets, or its
    packed mode's key and packed offsets."""
    if isinstance(a, tuple):
        if not isinstance(a[1], list):
            return max(max_abs_diff(a[0], b[0]), max_abs_diff(a[1], b[1]))
        return max([max_abs_diff(a[0], b[0])] + [max_abs_diff(x, y) for x, y in zip(a[1], b[1])])
    return max_abs_diff(a, b)


def placement_kernel_phase(card: str) -> dict:
    """The placement kernel against its twin, bitwise: on the classic main
    path's batch (8,558,315 k-mers of -k 31 -n 4 -s 50000000, padded to
    the stream's EPC_CL), on the v4 batch (9,437,184 slots, 390,625 blocks
    of rpb 128, from packed k-mers and from sort keys), and across k, H,
    bloom_size, layout and output (a grid of 20,000 k-mers each); times of
    both main-path batches."""
    import torch

    from colorid_tpu_torch.ops import hash_torch as ht
    from colorid_tpu_torch.ops.stream_query import EPC_CL

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    n_live = 8_558_315
    P0 = -(-n_live // EPC_CL) * EPC_CL
    classic = torch.zeros((P0, 2), dtype=torch.int32, device="cuda")
    classic[:n_live] = _rand_kmers(g, n_live, K)
    P4 = 9 * (1 << 20)
    v4 = torch.zeros((P4, 2), dtype=torch.int32, device="cuda")
    v4[:n_live] = _rand_kmers(g, n_live, K)
    ckw = dict(k=K, num_hash=HASHES, bloom_size=BLOOM)
    vkw = dict(k=K, num_hash=HASHES, bloom_size=BLOOM, rpb=128, version=4, blkoff=True)
    # the packed mode as the device-resident v4 dispatch runs it: an int32
    # key with the exact frequency in its low 11 bits
    q4 = torch.zeros(P4, dtype=torch.int32, device="cuda")
    q4[:n_live] = torch.randint(1, 19, (n_live,), generator=g, device="cuda", dtype=torch.int32)
    kkw = dict(k=K, num_hash=HASHES, bloom_size=BLOOM, rpb=128, version=4, qbits=11, qmin=0,
               qmax=2047)
    n_checked, errs = 0, {}
    for what, src, kw in (("classic", classic, ckw), ("v4", v4, vkw),
                          ("v4 sort keys", _key_of(v4), vkw), ("v4 packed mode", v4, kkw)):
        if "qbits" in kw:
            got = ht.placement_keyoff(src, q4, **kw)
            want = ht.placement_keyoff_plain(src, q4, **kw)
        else:
            got, want = ht.placement(src, **kw), ht.placement_plain(src, **kw)
        errs[what] = placement_err(got, want)
        if errs[what]:
            raise AssertionError(f"placement kernel != twin ({what}): max_abs_err {errs[what]}")
        n_checked += 1
        del got, want
    errs["grid"] = 0
    # the grid: every length class, H, modulus, layout and output, from
    # packed k-mers and from sort keys with sentinels among them
    for k in GRID_K:
        pk = _rand_kmers(g, 20_000, k)
        sk = _key_of(pk)
        sk[::97] = 2**63 - 1
        for src in (pk, sk):
            for H in (1, 2, 4, 8):
                for bloom in (1_000_003, 2**31 - 1):
                    cases = [dict()] + [
                        dict(rpb=128, version=v, blkoff=b) for v in (1, 2, 3, 4)
                        for b in (False, True)
                    ]
                    for c in cases:
                        kw = dict(k=k, num_hash=H, bloom_size=bloom, **c)
                        err = placement_err(ht.placement(src, **kw),
                                            ht.placement_plain(src, **kw))
                        errs["grid"] = max(errs["grid"], err)
                        if err:
                            raise AssertionError(f"placement kernel != twin ({kw}): "
                                                 f"max_abs_err {err}")
                        n_checked += 1
                    # the packed mode: the block as the key, or with a
                    # clipped frequency in its low 11 bits where that key
                    # fits int32 (refused past 2^20 blocks)
                    qg = torch.randint(0, 3000, (src.shape[0],), generator=g, device="cuda",
                                       dtype=torch.int32)
                    for v in (1, 2, 3, 4) if H <= 4 else ():
                        for m in (dict(), dict(qbits=11, qmax=1024)):
                            kw = dict(k=k, num_hash=H, bloom_size=bloom, rpb=128, version=v, **m)
                            qq = qg if m else None
                            if m and -(-bloom // 128) << 11 > 2**31:
                                try:
                                    ht.placement_keyoff(src, qq, **kw)
                                except ValueError:
                                    n_checked += 1
                                    continue
                                raise AssertionError(f"placement packed mode took a key "
                                                     f"past int32 ({kw})")
                            err = placement_err(ht.placement_keyoff(src, qq, **kw),
                                                ht.placement_keyoff_plain(src, qq, **kw))
                            errs["grid"] = max(errs["grid"], err)
                            if err:
                                raise AssertionError(f"placement kernel != twin (packed "
                                                     f"mode, {kw}): max_abs_err {err}")
                            n_checked += 1
    log(f"[kernel] placement: bitwise equal to its twin (max_abs_err "
        f"{', '.join(f'{w} {e}' for w, e in errs.items())}) on the classic batch "
        f"(P={P0}, {n_live} k-mers, k {K}, H {HASHES}, bloom {BLOOM}), the v4 batch "
        f"(P={P4}, {BLOOM // 128} blocks of rpb 128; packed and sort keys) and a grid "
        f"of k {list(GRID_K)} x H 1/2/4/8 x bloom 1,000,003 / 2^31-1 x classic, v1-v4 "
        f"rows and block/offsets x packed / sort keys, and the packed mode (v4 dispatch's "
        f"int32 key with an exact frequency; the grid's v1-v4 at H <= 4, the key as the "
        f"block or with a clipped frequency, refused past 2^20 blocks): {n_checked} cases "
        f"on {card}")
    out = {}
    for what, src, kw, instance, out_bytes in (
        ("classic", classic, ckw, "placement_kernelILi2ELi4ELi0E", 4 * HASHES),
        ("v4", v4, vkw, "placement_kernelILi7ELi4ELi1E", 8 * (HASHES + 1)),
        ("v4 packed mode", v4, kkw, "placement_kernelILi7ELi4ELi2E", 4 + 4 + 4),
    ):
        if "qbits" in kw:
            ms = cuda_ms(lambda: ht.placement_keyoff(src, q4, **kw), 20)
            plain_ms = cuda_ms(lambda: ht.placement_keyoff_plain(src, q4, **kw), 3)
        else:
            ms = cuda_ms(lambda: ht.placement(src, **kw), 20)
            plain_ms = cuda_ms(lambda: ht.placement_plain(src, **kw), 3)
        n = src.shape[0]
        instr = sass_loop_instructions("placement.cu", instance)
        bound_ms, bound_by, how = _bound(n * (8 + out_bytes), n, instr)
        log(f"[kernel] placement {what} P={n} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms=null (no single PyTorch call hashes or places k-mers) "
            f"bound_ms={bound_ms:.4f} bound_by={bound_by} ({how}) on {card}")
        out[what] = (ms, plain_ms, bound_ms, bound_by)
    del classic, v4, q4
    torch.cuda.empty_cache()
    ms, plain_ms, bound_ms, bound_by = out["classic"]
    return {
        "name": "placement",
        "route": "cuda",
        "source": "colorid_tpu_torch/csrc/placement.cu",
        "replaces": "colorid_tpu/ops/hash_jax.py:438",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max(errs.values()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "v4_ms": out["v4"][0],
        "v4_plain_ms": out["v4"][1],
        "v4_bound_ms": out["v4"][2],
        "packed_ms": out["v4 packed mode"][0],
        "packed_plain_ms": out["v4 packed mode"][1],
        "packed_bound_ms": out["v4 packed mode"][2],
        "packed_bound_by": out["v4 packed mode"][3],
        "packed_max_abs_err": errs["v4 packed mode"],
    }


def _rand_reads(g, R: int, L: int, n_len: int, p_n: float):
    """R random reads of true length n_len in words of padded length L on
    the card, a fraction p_n of their bases N: (words int32 [R, ceil(L/16)],
    lens int32 [R], validity bits int32 [R, ceil(L/32)]), as
    ops/extract.py::pack_reads_valid packs them."""
    import torch

    codes = torch.randint(0, 4, (R, L), generator=g, dtype=torch.int64, device="cuda")
    ok = torch.rand((R, L), generator=g, device="cuda") >= p_n
    ok[:, n_len:] = False
    codes = torch.where(ok, codes, 0)
    Lw, Lv = -(-L // 16), -(-L // 32)
    cw = torch.zeros((R, Lw * 16), dtype=torch.int64, device="cuda")
    cw[:, :L] = codes
    shifts = 2 * (15 - torch.arange(16, device="cuda"))
    words = (cw.view(R, Lw, 16) << shifts).sum(dim=2)
    ov = torch.zeros((R, Lv * 32), dtype=torch.int64, device="cuda")
    ov[:, :L] = ok.to(torch.int64)
    vbits = (ov.view(R, Lv, 32) << torch.arange(32, device="cuda")).sum(dim=2)
    lens = torch.full((R,), n_len, dtype=torch.int32, device="cuda")
    return _as_i32(words), lens, _as_i32(vbits)


def window_keys_kernel_phase(card: str) -> dict:
    """The window-key kernel against its twin, bitwise: on the reads cell's
    shape (400,000 reads of 150 bp in words of 160 bases, k 31: 52,000,000
    windows, with the validity bitplane and 0.1 % N bases) and on a grid of
    k, stride d, read length and bitplane (2,000 reads each, N bases, true
    lengths down to 1); its time there."""
    import torch

    from colorid_tpu_torch.ops import extract as te

    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    L = max(64, -(-READ_LEN // 32) * 32)  # the reads path's padded length: 160
    words, lens, vbits = _rand_reads(g, N_READS, L, READ_LEN, 0.001)
    kw = dict(k=K, L=L, d=1)
    got = te.window_keys(words, lens, vbits, **kw)
    want = te._window_keys(words, lens, vbits, K, L, 1)
    errs = {"cell": max_abs_diff(got, want), "grid": 0}
    if errs["cell"]:
        raise AssertionError(f"window_keys kernel != twin (the reads cell): max_abs_err "
                             f"{errs['cell']}")
    n_sent = int((got == te.SENT_KEY).sum())
    del got, want
    n_checked = 1
    for k in GRID_K:
        for Lg in (33, 150, 160):
            if Lg < k:
                continue
            w, ln, vb = _rand_reads(g, 2000, Lg, Lg, 0.01)
            ln = torch.randint(1, Lg + 1, (2000,), generator=g, dtype=torch.int32, device="cuda")
            for d in (1, 3):
                for v in (vb, None):
                    err = max_abs_diff(te.window_keys(w, ln, v, k=k, L=Lg, d=d),
                                       te._window_keys(w, ln, v, k, Lg, d))
                    errs["grid"] = max(errs["grid"], err)
                    if err:
                        raise AssertionError(f"window_keys kernel != twin (k={k} L={Lg} "
                                             f"d={d}): max_abs_err {err}")
                    n_checked += 1
    ms = cuda_ms(lambda: te.window_keys(words, lens, vbits, **kw), 20)
    plain_ms = cuda_ms(lambda: te._window_keys(words, lens, vbits, K, L, 1), 3)
    n_win = N_READS * (L - K + 1)
    n_bytes = 4 * (words.numel() + lens.numel() + vbits.numel()) + 8 * n_win
    instr = sass_loop_instructions("window_keys.cu", "window_keys_kernelILb1ELb0E")
    bound_ms, bound_by, how = _bound(n_bytes, n_win, instr)
    log(f"[kernel] window_keys: bitwise equal to its twin (max_abs_err cell "
        f"{errs['cell']}, grid {errs['grid']}) on {N_READS} reads x {L} "
        f"({n_win} windows, {n_sent} of them SENT_KEY) and on a grid of k {list(GRID_K)} "
        f"x L 33/150/160 x d 1/3 x with/without the bitplane: {n_checked} cases on {card}")
    log(f"[kernel] window_keys windows={n_win} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms=null (no single PyTorch call extracts canonical windows) "
        f"bound_ms={bound_ms:.4f} bound_by={bound_by} ({how}) on {card}")
    del words, lens, vbits
    torch.cuda.empty_cache()
    return {
        "name": "window_keys",
        "route": "cuda",
        "source": "colorid_tpu_torch/csrc/window_keys.cu",
        "replaces": "colorid_tpu/ops/extract.py:151",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max(errs.values()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


# -- phase 3: the main paths through the CLI ----------------------------------


def synth_inputs(tmp: str):
    """The [main] cell, colorid_tpu_torch.bench.synth_cell at this script's
    sizes from SEED: N_GENOMES random genomes as fasta with a manifest
    (bench.write_panel) and a .fastq.gz of reads drawn from the first
    N_SOURCES genomes, half reverse-complemented, with SUB_RATE random
    substitutions."""
    from colorid_tpu_torch.bench import synth_cell, write_panel

    genomes, reads = synth_cell(SEED, N_GENOMES, GENOME_LEN, N_SOURCES, N_READS)
    man = write_panel(tmp, genomes)
    L = reads.shape[1]
    qual = "I" * L
    fq = os.path.join(tmp, "reads.fastq.gz")
    seqs = reads.tobytes().decode()
    with gzip.open(fq, "wt", compresslevel=1) as f:
        f.write("".join(
            f"@read{j}\n{seqs[j * L:(j + 1) * L]}\n+\n{qual}\n" for j in range(N_READS)
        ))
    return man, fq, [f"genome{i:02d}" for i in range(N_SOURCES)]


def cli(argv: list[str]) -> list[str]:
    from colorid_tpu_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


def _check_tsv(tsv, perfect, sources, what: str) -> list:
    rows = [l.split("\t") for l in tsv if "\t" in l]
    top = [r[2] for r in sorted(rows, key=lambda r: -float(r[3]))[:N_SOURCES]]
    for line in tsv:
        log(f"[main] {what} tsv {line}")
    for line in perfect:
        log(f"[main] {what} perfect {line}")
    if sorted(top) != sorted(sources) or len(rows) < N_SOURCES:
        raise AssertionError(f"top rows {top} are not the source genomes {sources}")
    if not any(l.split("\t")[1] == "genome01" for l in perfect if "\t" in l):
        raise AssertionError("perfect search did not report its own genome")
    return rows


def _searches(tmp: str, bxi: str, fq: str, kernels):
    """search -f 1 on the reads (the default route: k-mers counted on the
    card, QueryEngine.search_reads) and search -s on one genome, timed;
    also, per wrapper of ``kernels`` (each with a count), its launches
    while each of the two ran: {name: (search -f 1, search -s)}."""
    before = [kn.launches for kn in kernels]
    t0 = time.time()
    tsv = cli(["search", "-b", bxi, "-q", fq, "-f", "1", "--device", DEVICE])
    t_search = time.time() - t0
    mid = [kn.launches for kn in kernels]
    t0 = time.time()
    perfect = cli(["search", "-b", bxi, "-s", "--device", DEVICE,
                   "-q", os.path.join(tmp, "genome01.fasta")])
    t_perfect = time.time() - t0
    used = {kn.__name__: (m - b, kn.launches - m) for kn, b, m in zip(kernels, before, mid)}
    return tsv, perfect, t_search, t_perfect, used


def _new_kernels():
    """The wrappers of the hand kernels for code that XLA compiles in the
    JAX package (each with a count): placement, window keys, and the
    epilogue's three modes (AND words, the classic stream's sorted words,
    the generic gather)."""
    from colorid_tpu_torch.ops import query as tq
    from colorid_tpu_torch.ops.extract import window_keys
    from colorid_tpu_torch.ops.hash_torch import placement

    return (placement, window_keys, tq._accumulate_tail, tq._accumulate_sorted_words,
            tq._accumulate_one)


def _glue_kernels():
    """The wrappers of kernel D, the blocked stream's glue: its plan, tail
    and residual gather, of kernel E, the streams' key sort, of kernel F,
    the reads routes' run counts, and of kernel G, their value sort (each
    with a count)."""
    from colorid_tpu_torch.ops import stream_query as sq

    te = _f_modules()[0]
    return tuple(getattr(sq, n) for n in TAIL_WRAPPERS + ("sort_payloads",)) + (
        te.run_counts, te.value_sort)


# the epilogue mode each main path ends in: the classic stream's sorted
# words, the probe stream's residual pass through the generic gather
EPILOGUE_OF = {"classic": "_accumulate_sorted_words", "blocked": "_accumulate_tail"}


def _check_new_kernels(used: dict, what: str) -> None:
    """On the card, search -f 1 must have placed its k-mers and extracted
    its windows through the kernels, and search -s (k-mers counted on the
    host, as the reference does) placed its k-mers through the kernel; both
    searches must have ended in the epilogue kernel. Kernel E sorts both
    classic searches' rows and the blocked search -s's keys (the blocked
    search -f 1 takes the fused route, whose keys arrive sorted). Kernel F
    counts search -f 1's k-mers: the counted route's compaction on the
    classic index, the chunked fused route's counts, partition and merge on
    the blocked one. Kernel G sorts search -f 1's windows on both (the
    counted route's, the chunked fused route's chunks and merge)."""
    if DEVICE != "cuda":
        return
    glue = TAIL_WRAPPERS if what == "blocked" else ()
    sorted_ = used["sort_payloads"] if what == "classic" else used["sort_payloads"][1:]
    if (min(used["placement"]) == 0 or used["window_keys"][0] == 0
            or min(used[EPILOGUE_OF[what]]) == 0 or any(min(used[n]) == 0 for n in glue)
            or min(sorted_) == 0 or used["run_counts"][0] == 0 or used["value_sort"][0] == 0):
        raise AssertionError(
            f"{what}: search -f 1 and search -s did not run through the placement, "
            f"window-key, epilogue, sort, run-count, value-sort"
            f"{' and stream glue' if glue else ''} kernels "
            f"(launches in (search -f 1, search -s): {used})"
        )
    if glue and used["stream_chunk_plan"] != used["stream_tail"]:
        raise AssertionError(f"{what}: kernel D's plan and tail launched "
                             f"{used['stream_chunk_plan']} and {used['stream_tail']} times: "
                             "one each a stream batch")


def classic_path_phase(tmp: str, inputs, card: str):
    """build -> search over a classic index; returns (index file, launches
    of the classic word kernel while the path ran, the build's seconds,
    search -f 1's TSV)."""
    from colorid_tpu_torch.ops import stream_query as sq

    man, fq, sources = inputs
    prefix = os.path.join(tmp, "panel")
    # observe every classic stream batch (search_reads' and search_keys'):
    # n_drop > 0 means its residual capacity tripped and the engine re-ran
    # it through the generic gather
    batches = []
    stream_fn = sq.stream_accumulate_classic_exact

    def observed(*a, **kw):
        out = stream_fn(*a, **kw)
        batches.append((a[5].shape[0], out[4]))
        return out

    sq.stream_accumulate_classic_exact = observed
    sq.classic_words.launches = 0
    try:
        t0 = time.time()
        cli(["build", "-k", str(K), "-n", str(HASHES), "-s", str(BLOOM),
             "-b", prefix, "-r", man, "-t", "8"])
        t_build = time.time() - t0
        tsv, perfect, t_search, t_perfect, used = _searches(
            tmp, prefix + ".bxi", fq, (sq.classic_words, *_new_kernels(), sq.sort_payloads,
                                       _f_modules()[0].run_counts, _f_modules()[0].value_sort))
    finally:
        sq.stream_accumulate_classic_exact = stream_fn
    launches = sq.classic_words.launches
    reads_launches = used["classic_words"][0]
    sizes = [n for n, _ in batches]
    n_drop = sum(int(nd) for _, nd in batches)
    rows = _check_tsv(tsv, perfect, sources, "classic")
    log(f"[main] classic: build {t_build:.1f}s; search -f 1 {t_search:.1f}s "
        f"({rows[0][1]} k-mers, counted on the device; classic_word launches "
        f"{reads_launches}); search -s {t_perfect:.1f}s; classic_word "
        f"launches={launches}; stream batches={sizes} n_drop={n_drop}; launches in "
        f"(search -f 1, search -s): placement {used['placement']}, window_keys "
        f"{used['window_keys']}, epilogue {used['_accumulate_sorted_words']} "
        f"(sorted-words mode), sort {used['sort_payloads']}, run counts "
        f"{used['run_counts']}, value sort {used['value_sort']} on {card}")
    _check_new_kernels(used, "classic")
    if DEVICE == "cuda" and (launches == 0 or reads_launches == 0):
        raise AssertionError(
            "the main path did not run search -f 1 and search -s through the "
            f"classic kernel (launches={launches}, search -f 1: {reads_launches})"
        )
    if len(batches) < 2 or n_drop:
        raise AssertionError(
            f"a classic search fell back to the generic gather (batches={sizes}, "
            f"n_drop={n_drop})"
        )
    return prefix + ".bxi", launches, t_build, tsv


def blocked_path_phase(tmp: str, inputs, card: str):
    """build --blocked -> search over the blocked (v4) index; returns
    (index file, launches of the probe kernel while the path ran)."""
    from colorid_tpu_torch.index.bigsi import BigsiIndex
    from colorid_tpu_torch.ops import fused_reads as fr
    from colorid_tpu_torch.ops import stream_query as sq

    man, fq, sources = inputs
    prefix = os.path.join(tmp, "turbo")
    # observe every probe-stream dispatch (search -f 1's fused reads
    # pipeline, search_keys' segments): its probe slots (the merge's S x
    # cap for the chunked fused route) and its n_drop (nonzero means the
    # engine re-ran the query on another route)
    segments = []
    owners = (  # (module, function, the dispatch's size from its arguments)
        (sq, "stream_accumulate_hash", lambda a: a[5].shape[0]),
        (sq, "stream_accumulate_hash_exact", lambda a: a[5].shape[0]),
        (fr, "fused_search_reads", lambda a: f"fused {a[5].shape[0]} reads"),
        (fr, "fused_merge_query", lambda a: f"merge {a[5].numel()} slots"),
    )
    saved = [getattr(o, n) for o, n, _ in owners]

    def observer(fn, size):
        def observed(*a, **kw):
            out = fn(*a, **kw)
            segments.append((size(a), out[4]))
            return out
        return observed

    for (o, n, size), fn in zip(owners, saved):
        setattr(o, n, observer(fn, size))
    sq.stream_probe.launches = 0
    try:
        t0 = time.time()
        cli(["build", "--blocked", "-k", str(K), "-n", str(HASHES), "-s", str(BLOOM),
             "-b", prefix, "-r", man, "-t", "8"])
        t_build = time.time() - t0
        tsv, perfect, t_search, t_perfect, used = _searches(
            tmp, prefix + ".bxi", fq, (sq.stream_probe, *_new_kernels(), *_glue_kernels()))
    finally:
        for (o, n, _), fn in zip(owners, saved):
            setattr(o, n, fn)
    launches = sq.stream_probe.launches
    reads_launches = used["stream_probe"][0]
    sizes = [n for n, _ in segments]
    n_drop = sum(int(nd) for _, nd in segments)
    index = BigsiIndex.load(prefix + ".bxi")
    rows = _check_tsv(tsv, perfect, sources, "blocked")
    log(f"[main] blocked: layout v{index.blocked}, bloom {index.bloom_size}; "
        f"build --blocked {t_build:.1f}s; search -f 1 {t_search:.1f}s "
        f"({rows[0][1]} k-mers, counted on the device; stream_probe launches "
        f"{reads_launches}); search -s {t_perfect:.1f}s; stream_probe "
        f"launches={launches}; streamed segments={sizes} n_drop={n_drop}; launches in "
        f"(search -f 1, search -s): placement {used['placement']}, window_keys "
        f"{used['window_keys']}, epilogue {used['_accumulate_tail']} (residual pass), "
        f"stream glue (plan, tail) {used['stream_chunk_plan']}, {used['stream_tail']}, "
        f"sort {used['sort_payloads']}, run counts {used['run_counts']}, value sort "
        f"{used['value_sort']} on {card}")
    _check_new_kernels(used, "blocked")
    if index.blocked != 4:
        raise AssertionError(f"build --blocked chose layout {index.blocked}, not v4")
    if len(segments) < 2 or n_drop or (
        DEVICE == "cuda" and (launches < 2 or reads_launches == 0)
    ):
        raise AssertionError(
            "the blocked main path did not run every search through the probe "
            f"kernel (launches={launches}, search -f 1: {reads_launches}, "
            f"segments={sizes}, n_drop={n_drop})"
        )
    # the same searches with the stream off: byte-identical TSV
    os.environ["COLORID_STREAM"] = "0"
    try:
        tsv0, perfect0, *_ = _searches(tmp, prefix + ".bxi", fq, (sq.stream_probe,))
    finally:
        os.environ.pop("COLORID_STREAM")
    if tsv0 != tsv or perfect0 != perfect or sq.stream_probe.launches != launches:
        raise AssertionError("COLORID_STREAM=0 changed the blocked search's TSV")
    log("[main] blocked: TSV byte-identical with COLORID_STREAM=0")
    return prefix + ".bxi", launches


# -- phase 4: stream vs generic parity and rates ----------------------------


def classic_parity_phase(bxi: str, fq: str, card: str, strict: bool = True) -> dict:
    """The classic index: search_keys through the classic stream against
    the generic gather, the device-resident stream dispatch against both,
    their rates, and the profile of one device-resident dispatch (which
    must launch no torch.sort radix kernel where ``strict``: kernel E sorts
    the rows; --compare's turns of an older checkout are not strict); then
    the port bench's classic generic dispatch (the same k-mers device-
    resident through search_keys_dev_generic_async, padded to its classic_P)
    against search_keys, and its profile ([profile] generic: no index,
    gather or reduction kernel where ``strict``: kernel C gathers).
    Returns {"stream": that stream dispatch, "generic": the generic one
    (functions of no arguments), "query": (keys, qcounts, packed),
    "result": the generic SearchResult}."""
    import numpy as np
    import torch

    from colorid_tpu_torch.bench import classic_P, same_result
    from colorid_tpu_torch.engine import QueryEngine
    from colorid_tpu_torch.index.bigsi import BigsiIndex
    from colorid_tpu_torch.ops.stream_query import EPC_CL
    from colorid_tpu_torch.pipelines.search import _count_query_kmers

    with contextlib.redirect_stderr(io.StringIO()):
        keys, qcounts, packed = _count_query_kmers(fq, None, K, 15, 1, False)
    n = keys.shape[0]
    index = BigsiIndex.load(bxi)
    stream_eng = QueryEngine(index, device=DEVICE)
    if not stream_eng._use_stream_classic(n, K):
        raise AssertionError("the density gate did not pick the classic stream")
    rates = {}
    results = {}
    os.environ["COLORID_STREAM"] = "0"
    generic_eng = QueryEngine(index, device=DEVICE)
    os.environ.pop("COLORID_STREAM")
    for name, eng in (("stream", stream_eng), ("generic", generic_eng),
                      ("generic", generic_eng), ("stream", stream_eng)):
        sync()
        t0 = time.time()
        res = eng.search_keys(keys, qcounts=qcounts, packed_all=packed, k=K)
        dt = time.time() - t0
        rates.setdefault(name, []).append(n / dt)
        results[name] = res
    if not same_result(results["stream"], results["generic"]):
        raise AssertionError("stream and generic SearchResults differ")
    # device-resident stream dispatches (inputs already on the card)
    P0 = -(-n // EPC_CL) * EPC_CL
    pk = np.zeros((P0, 2), dtype=np.uint32)
    pk[:n] = packed
    qc = np.zeros(P0, dtype=np.int32)
    qc[:n] = np.maximum(qcounts, 1)
    pk_dev = torch.from_numpy(pk.view(np.int32)).to(DEVICE)
    qc_dev = torch.from_numpy(qc).to(DEVICE)
    out = stream_eng.search_keys_dev_classic_async(pk_dev, qc_dev, K)
    dev_res = stream_eng.search_keys_dev_finish(out[0].cpu().numpy(), *out[1:])
    if dev_res is None or not same_result(dev_res, results["generic"]):
        raise AssertionError("device-resident stream result differs (or dropped)")
    reps = 5
    sync()
    t0 = time.time()
    outs = [stream_eng.search_keys_dev_classic_async(pk_dev, qc_dev, K) for _ in range(reps)]
    vecs = torch.stack([o[0] for o in outs]).cpu().numpy()
    dt = (time.time() - t0) / reps
    if (vecs[:, index.n_colors + stream_eng.wpad + 2] != 0).any():
        raise AssertionError("device-resident stream dispatch dropped probes")
    log(f"[parity] classic: SearchResult identical (stream vs generic vs device-resident); "
        f"n_kmers={n}; k-mers/s: stream={max(rates['stream']):.0f} "
        f"generic={max(rates['generic']):.0f} device_resident_stream={n / dt:.0f} "
        f"(best of 2 host-clock runs incl. H2D+fetch; device-resident mean of "
        f"{reps}) on {card}")
    dispatch = lambda: stream_eng.search_keys_dev_classic_async(pk_dev, qc_dev, K)[0]  # noqa: E731
    if DEVICE == "cuda":
        profile_dispatch(dispatch, "classic", card, forbid_like=("RadixSort",) if strict else ())
    # the port bench's classic generic dispatch: the same buffers padded to
    # a multiple of the generic chunk, through the generic gather (W 1)
    P = classic_P(n, min(stream_eng.chunk, 1 << 20))
    pk_g = torch.cat([pk_dev, pk_dev.new_zeros((P - P0, 2))])
    qc_g = torch.cat([qc_dev, qc_dev.new_zeros(P - P0)])
    generic = lambda: stream_eng.search_keys_dev_generic_async(pk_g, qc_g, K, capO=P)  # noqa: E731
    gen_res = stream_eng.search_keys_dev_finish(*_fetched(generic()))
    if not same_result(gen_res, results["generic"]):
        raise AssertionError("the device-resident generic dispatch != search_keys")
    if DEVICE == "cuda":
        profile_dispatch(lambda: generic()[0], "generic classic W 1", card, label="generic",
                         forbid_like=GENERIC_FORBID if strict else ())
    return {"stream": dispatch, "generic": lambda: generic()[0],
            "query": (keys, qcounts, packed), "result": results["generic"]}


# kernels the generic gather's dispatches must not run since kernel C's
# gather mode: torch's indexed gathers and scatters and its reductions
GENERIC_FORBID = ("index", "gather", "reduce_kernel")


def _fetched(out):
    """A search_keys_dev*_async tuple with its vector fetched to the host."""
    return (out[0].cpu().numpy(),) + tuple(out[1:])


def blocked_parity_phase(bxi: str, fq: str, card: str, strict: bool = True):
    """The blocked index: search_keys with the probe stream against the
    generic gather, the two device-resident dispatches against both, their
    rates, and the profile of one device-resident stream dispatch (which
    must launch no index kernel and no torch.sort radix kernel where
    ``strict``: kernels D and E replaced them;
    --compare's turns of an older checkout are not strict). On the card also
    the probe kernel on the real segment's inputs (see real_segment).
    Returns (its ms there or None on the CPU, the device-resident stream
    dispatch)."""
    import numpy as np
    import torch

    from colorid_tpu_torch.bench import same_result
    from colorid_tpu_torch.engine import QueryEngine
    from colorid_tpu_torch.index.bigsi import BigsiIndex
    from colorid_tpu_torch.ops.stream_query import QKEY_MASK
    from colorid_tpu_torch.pipelines.search import _count_query_kmers

    with contextlib.redirect_stderr(io.StringIO()):
        keys, qcounts, packed = _count_query_kmers(fq, None, K, 15, 1, False)
    n = keys.shape[0]
    index = BigsiIndex.load(bxi)
    stream_eng = QueryEngine(index, device=DEVICE)
    seg = 8 * min(stream_eng.chunk, 1 << 20)
    gate = [stream_eng._use_stream(min(seg, n - s)) for s in range(0, n, seg)]
    if not stream_eng._stream or not gate[0]:
        raise AssertionError("the density gate did not pick the probe stream")
    os.environ["COLORID_STREAM"] = "0"
    generic_eng = QueryEngine(index, device=DEVICE)
    os.environ.pop("COLORID_STREAM")
    rates, results = {}, {}
    for name, eng in (("stream", stream_eng), ("generic", generic_eng),
                      ("generic", generic_eng), ("stream", stream_eng)):
        sync()
        t0 = time.time()
        res = eng.search_keys(keys, qcounts=qcounts, packed_all=packed, k=K)
        rates.setdefault(name, []).append(n / (time.time() - t0))
        results[name] = res
    if not same_result(results["stream"], results["generic"]):
        raise AssertionError("blocked: stream and generic SearchResults differ")
    # device-resident dispatches: inputs already on the card, padded to the
    # generic dispatch's chunk (a multiple of the stream's)
    unit = min(stream_eng.chunk, 1 << 20)
    P = -(-n // unit) * unit
    pk = np.zeros((P, 2), dtype=np.uint32)
    pk[:n] = packed
    qc = np.zeros(P, dtype=np.int32)
    qc[:n] = np.maximum(qcounts, 1)
    pk_dev = torch.from_numpy(pk.view(np.int32)).to(DEVICE)
    qc_dev = torch.from_numpy(qc).to(DEVICE)
    max_freq = int(qc.max())
    in_key = max_freq <= QKEY_MASK
    dispatches = {
        "stream": lambda: stream_eng.search_keys_dev_async(
            pk_dev, qc_dev, K, max_freq=max_freq),
        "generic": lambda: stream_eng.search_keys_dev_generic_async(pk_dev, qc_dev, K),
    }
    slot = index.n_colors + stream_eng.wpad + 2
    reps = 5
    dev_rates = {}
    for name in ("stream", "generic", "generic", "stream"):
        out = dispatches[name]()
        res = stream_eng.search_keys_dev_finish(out[0].cpu().numpy(), *out[1:])
        if res is None or not same_result(res, results["generic"]):
            raise AssertionError(f"blocked: device-resident {name} differs (or dropped)")
        sync()
        t0 = time.time()
        outs = [dispatches[name]() for _ in range(reps)]
        vecs = torch.stack([o[0] for o in outs]).cpu().numpy()
        dev_rates.setdefault(name, []).append(n / ((time.time() - t0) / reps))
        if (vecs[:, slot] != 0).any():
            raise AssertionError(f"blocked: device-resident {name} dispatch dropped probes")
        del outs
    log(f"[parity] blocked: SearchResult identical (stream vs generic, host path and "
        f"device-resident); n_kmers={n}; streamed segments per search={sum(gate)} "
        f"of {len(gate)}; k-mers/s: stream={max(rates['stream']):.0f} "
        f"generic={max(rates['generic']):.0f} "
        f"device_resident_stream={max(dev_rates['stream']):.0f} "
        f"device_resident_generic={max(dev_rates['generic']):.0f} "
        f"(best of 2 host-clock runs each; device-resident: mean of {reps} "
        f"dispatches of {P} slots, max_freq={max_freq} in_key={in_key}) on {card}")
    if DEVICE != "cuda":
        return None, dispatches["stream"]
    profile_dispatch(lambda: dispatches["stream"]()[0], "blocked", card,
                     forbid=("index_elementwise_kernel", "indexFuncLargeIndex") if strict else (),
                     forbid_like=("RadixSort",) if strict else (), enqueue=True)
    return real_segment(dispatches["stream"], card), dispatches["stream"]


def real_segment(dispatch, card: str) -> float:
    """The probe kernel on the inputs that the device-resident blocked
    dispatch hands it (the real query's sorted, windowed probes): kernel
    against twin bitwise, and the kernel's time alone."""
    import torch

    from colorid_tpu_torch.ops import stream_query as sq

    kernel = sq.stream_probe
    calls = []

    def observed(*a, **kw):
        calls.append((a, kw))
        return kernel(*a, **kw)

    # the kernel counts its launches on the module's name, the observer now
    observed.launches = kernel.launches
    sq.stream_probe = observed
    try:
        dispatch()
        torch.cuda.synchronize()
    finally:
        sq.stream_probe = kernel
        kernel.launches = observed.launches
    a, kw = max(calls, key=lambda c: c[0][1].numel())
    blocks2, blk_s, off_s, qc, counts, hist = a
    outs = []
    for fn in (sq.stream_probe, sq.stream_probe_plain):
        acc = (torch.zeros_like(counts), torch.zeros_like(hist))
        outs.append((fn(blocks2, blk_s, off_s, qc, *acc, **kw), *acc))
    torch.cuda.synchronize()
    equal = all(torch.equal(x, y) for x, y in zip(*outs))
    uniq, _counts, h = outs[0]
    q_hit = qc[uniq >= 0]
    if not q_hit.numel():
        raise AssertionError("the real segment has no unique hit to check")
    acc = (torch.zeros_like(counts), torch.zeros_like(hist))
    ms = cuda_ms(lambda: sq.stream_probe(blocks2, blk_s, off_s, qc, *acc, **kw), 20)
    log(f"[kernel] stream_probe real segment: P={blk_s.numel()} (of {len(calls)} "
        f"segment(s) in the dispatch) counted={int((qc > 0).sum())} "
        f"unique_hits={int(q_hit.numel())} frequencies {int(q_hit.min())}-{int(q_hit.max())} "
        f"on {int((h > 0).sum())} histogram cells; bitwise_equal={equal} ms={ms:.4f} "
        f"on {card}")
    if not equal:
        raise AssertionError("stream_probe kernel != twin on the real segment")
    return ms


# -- phase 4-epilogue: the epilogue kernel on the classic dispatch's inputs ----

EPI_N = 1 << 23  # rows of the synthetic one-word AND-words case


def _epi_accs(C: int, W: int, capO: int, n_over: int = 0):
    """Fresh accumulators on the card (ops/query.py::new_accumulators) with
    n_over entries already in the overflow list."""
    import torch

    from colorid_tpu_torch.ops.query import new_accumulators

    accs = new_accumulators(C, W, capO, DEVICE)
    m = min(n_over, capO)
    accs[0][C + W + 1] = n_over
    accs[2][:m] = torch.arange(m, device=DEVICE, dtype=torch.int32) % max(C, 1)
    accs[3][:m] = torch.arange(m, device=DEVICE, dtype=torch.int32) + 5000
    return accs


def _epi_andw_case(g, N: int, C: int, W: int, hot: bool):
    """Synthetic AND-words inputs on the card: 60 % one-color rows (on 3
    colors where ``hot``), 20 % empty, 20 % with about one in eight colors;
    bits at and above C in a third of the rows; present 90 %, mask 95 %;
    frequencies 1-18 with 0.5 % at or above FREQ_CAP (hot: the unique hits
    pile onto a few histogram bins) or 1-40 with 5 %. Returns (andw int32
    [N, W], present, mask, q)."""
    import torch

    def rnd(shape, hi=2**32):
        return torch.randint(0, hi, shape, generator=g, dtype=torch.int64, device=DEVICE)

    kind = rnd((N,), 10)
    col = rnd((N,), 3 if hot else C)
    words = torch.arange(W, device=DEVICE)
    lane = torch.arange(32 * W, device=DEVICE).view(W, 32)
    cmask = ((lane < C).to(torch.int64) << torch.arange(32, device=DEVICE)).sum(dim=1)
    one = torch.where((col // 32)[:, None] == words, (1 << (col % 32))[:, None], 0)
    x = torch.where((kind < 6)[:, None], one, 0)
    x = torch.where((kind >= 8)[:, None], rnd((N, W)) & rnd((N, W)) & rnd((N, W)) & cmask, x)
    x |= torch.where((rnd((N,), 3) == 0)[:, None], rnd((N, W)) & ~cmask & 0xFFFFFFFF, 0)
    q = rnd((N,), 19 if hot else 41).clamp(min=1)
    big = rnd((N,), 1000) < (5 if hot else 50)
    q = torch.where(big, rnd((N,), 5000) + 1024, q).to(torch.int32)
    return _as_i32(x), rnd((N,), 10) < 9, rnd((N,), 20) < 19, q


def _epi_compare(what: str, kernel, twin, accs, args, kw) -> int:
    """The kernel and its twin on copies of the same accumulators: every
    accumulator bitwise equal. Returns the max |kernel - twin|."""
    import torch

    got = kernel(*[a.clone() for a in accs], *args, **kw)
    want = twin(*[a.clone() for a in accs], *args, **kw)
    sync()
    err = max(max_abs_diff(x, y) for x, y in zip(got, want))
    n_over = int(want[0][-1])
    log(f"[kernel] epilogue {what}: stats, hist, over_col, over_freq bitwise_equal="
        f"{err == 0} max_abs_err={err}; n_over {int(accs[0][-1])} -> {n_over} of capO "
        f"{accs[2].numel()}; histogram {int(want[1].sum() - accs[1].sum())} unique hits "
        f"on {int((want[1] != accs[1]).sum())} bins")
    if err:
        raise AssertionError(f"epilogue kernel != twin ({what}): max_abs_err {err}")
    return err


def _row_ops(W: int, H: int = 0) -> int:
    """The integer operations that a row of W words needs at the least,
    whatever the kernel: per word a popcount (the row's number of colors)
    and a carry-save add into the counts' bit planes (an XOR and an AND);
    in the gather mode (H > 0) also the AND over its H rows' words (H - 1)
    and the nonzero test of each (H, for presence)."""
    return W * (3 + max(2 * H - 1, 0))


def _epi_row_bound(N: int, W: int, n_kept: int, C: int) -> tuple[float, str, str]:
    """The AND-words pass's bound over N rows of W words: each row's words,
    present, mask and frequency read once, the accumulators read and
    written, the overflow entries written; the operations those the
    function needs (_row_ops)."""
    n_bytes = N * (4 * W + 6) + 2 * 4 * (C + W + 2 + C * 1024) + 8 * n_kept
    return _bound(n_bytes, N, _row_ops(W), "integer operations (the least a row needs)")


def gather_bytes(rows, mask, wpad: int, rpb: int, C: int, n_kept: int) -> tuple[int, int]:
    """(bytes, sectors) that kernel C's gather mode must move for rows [N,
    H]: each k-mer's mask and frequency (5 bytes), the rows of every real
    k-mer (4 or 8 bytes a row), the 32-byte sectors of their rows' words
    (sectors() over the starts that kernel H's gather reads too, each
    sector once), the accumulators read and written, and the overflow
    entries written."""
    live = rows[mask]
    n = sectors(_readid_starts(live, rpb, wpad), wpad)
    n_bytes = (5 * rows.shape[0] + live.numel() * rows.element_size() + 32 * n
               + 2 * 4 * (C + wpad + 2 + C * 1024) + 8 * n_kept)
    return n_bytes, n


@contextlib.contextmanager
def gather_replaced(make):
    """ops/query.py::_accumulate_one replaced by make(the real one) while
    the block runs. The replacement carries the real one's launch count
    (the wrapper counts through its module's name) and hands it back."""
    from colorid_tpu_torch.ops import query as tq

    real = tq._accumulate_one
    stand_in = make(real)
    stand_in.launches = real.launches
    tq._accumulate_one = stand_in
    try:
        yield
    finally:
        tq._accumulate_one = real
        real.launches = stand_in.launches


def _gather_calls(dispatch) -> list:
    """The arguments of each _accumulate_one call of one dispatch (the
    generic gather's chunks, in order): [(args, kwargs)]."""
    calls = []

    def observer(real):
        def observed(*a, **kw):
            calls.append((a, kw))
            return real(*a, **kw)
        return observed

    with gather_replaced(observer):
        dispatch()
        sync()
    if not calls:
        raise AssertionError("the dispatch made no _accumulate_one call")
    return calls


def gather_kernel_rows(what: str, calls, card: str) -> dict:
    """Kernel C's gather mode on a dispatch's own _accumulate_one calls
    (every chunk, in order, from fresh accumulators): all four
    accumulators bitwise equal to _accumulate_one_plain's on the card;
    the calls' summed device ms (device_ms: a trace of 3 batches), the
    twin's (CUDA events), the byte bound
    (gather_bytes, each chunk's sectors) beside the operations that a
    k-mer needs at the least (_row_ops), and torch.take of the same word offsets (the
    H rows' wpad words of every k-mer, a chunk at a time: the nearest
    single PyTorch call, which gathers only). Then the AND-words mode alone
    on the same batches' AND words and presence (the twin's _and_present):
    its device ms, twin ms and bound. Returns the numbers."""
    import torch

    from colorid_tpu_torch.ops import query as tq

    a0 = calls[0][0]  # (stats, hist, over_col, over_freq, blocks2, rows, mask, q, wpad,
    blocks2, wpad, rpb = a0[4], a0[8], a0[10]  # base_idx, rpb): the scans' call
    C, capO = a0[0].numel() - wpad - 2, a0[2].numel()
    H, rows64 = a0[5].shape[1], a0[5].dtype == torch.int64
    N = sum(a[5].shape[0] for a, _kw in calls)

    def run(fn, accs):
        for a, kw in calls:
            fn(*accs, *a[4:], **kw)
        return accs

    got = run(tq._accumulate_one, _epi_accs(C, wpad, capO))
    want = run(tq._accumulate_one_plain, _epi_accs(C, wpad, capO))
    sync()
    err = max(max_abs_diff(x, y) for x, y in zip(got, want))
    n_kept = min(int(want[0][-1]), capO)
    log(f"[kernel] epilogue gather mode {what}: {len(calls)} calls, N={N} k-mers, H {H}, "
        f"wpad {wpad}, rpb {rpb}, {'int64' if rows64 else 'int32'} rows, C {C}: stats, hist, "
        f"over_col, over_freq bitwise_equal={err == 0} max_abs_err={err}; n_over "
        f"{int(want[0][-1])} of capO {capO}; {int(want[0][:C].sum())} color hits")
    if err:
        raise AssertionError(f"gather mode != twin ({what}): max_abs_err {err}")
    del got, want
    accs = _epi_accs(C, wpad, capO)
    # device time (a trace): a chunk's call is short beside the host's
    # enqueue, so CUDA events around a batch would time the host
    k1 = ("epilogue_w1_kernel" if wpad == 1 else "epilogue_wide_kernel",)
    ms = device_ms(lambda: run(tq._accumulate_one, accs), 3, k1)[0] if DEVICE == "cuda" else 0.0
    plain_ms = cuda_ms(lambda: run(tq._accumulate_one_plain, accs), 1)
    n_bytes = n_sec = 0
    take_ms = 0.0
    flat = blocks2.reshape(-1)
    lanes = torch.arange(wpad, device=flat.device)
    for a, _kw in calls:
        rows, mask = a[5], a[6]
        b, n = gather_bytes(rows, mask, wpad, rpb, C, 0)
        n_bytes += b
        n_sec += n
        offs = (_readid_starts(rows, rpb, wpad)[:, None] + lanes).reshape(-1)
        take_ms += cuda_ms(lambda: torch.take(flat, offs), 3)
        del offs
    n_bytes += 8 * n_kept
    bound_ms, bound_by, how = _bound(n_bytes, N, _row_ops(wpad, H),
                                     "integer operations (the least a k-mer needs)")
    log(f"[kernel] epilogue gather mode {what} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={take_ms:.4f} (torch.take of the {N * H * wpad} row words, a chunk at a "
        f"time) bound_ms={bound_ms:.4f} bound_by={bound_by} ({how}; {n_sec} distinct 32-byte "
        f"sectors of the rows) on {card}")
    # the row pass alone: the AND-words mode on the same batches' AND words
    row_calls = []
    for a, kw in calls:
        andw, present = tq._and_present(blocks2, a[5], wpad, rpb)
        row_calls.append((andw, present, a[6], a[7], wpad, a[9], kw.get("gidx")))

    def run_rows(fn, accs):
        for andw, present, m, q, w, base, g in row_calls:
            fn(*accs, andw, present, m, q, w, base, gidx=g)
        return accs

    got = run_rows(tq._accumulate_tail, _epi_accs(C, wpad, capO))
    want = run_rows(tq._accumulate_tail_plain, _epi_accs(C, wpad, capO))
    sync()
    row_err = max(max_abs_diff(x, y) for x, y in zip(got, want))
    if row_err:
        raise AssertionError(f"AND-words mode != twin ({what}): max_abs_err {row_err}")
    accs = _epi_accs(C, wpad, capO)
    row_ms = device_ms(lambda: run_rows(tq._accumulate_tail, accs), 3, k1)[0] if DEVICE == "cuda" else 0.0
    row_plain = cuda_ms(lambda: run_rows(tq._accumulate_tail_plain, accs), 1)
    row_bound = _epi_row_bound(N, wpad, n_kept, C)
    log(f"[kernel] epilogue AND-words row pass {what} (the same batches' AND words, N={N} W "
        f"{wpad} C {C}) bitwise_equal=True ms={row_ms:.4f} plain_ms={row_plain:.4f} "
        f"bound_ms={row_bound[0]:.4f} bound_by={row_bound[1]} ({row_bound[2]}) on {card}")
    del row_calls, got, want
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": take_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err, "n_kmers": N, "wpad": wpad,
            "row_pass_ms": row_ms, "row_pass_plain_ms": row_plain,
            "row_pass_bound_ms": row_bound[0]}


def epilogue_kernel_phase(classic: dict, main_launches: int, card: str) -> tuple[dict, dict]:
    """The epilogue kernel against its twins, bitwise on all four
    accumulators: in the sorted-words mode on the inputs that the
    device-resident classic dispatch hands it (the [main] cell's 8,650,752
    k-mers, H 4, C 21: the word kernel's 34,603,008 words in row order, the
    rows, the sort's permutation, the window plan, its real frequencies);
    in the AND-words mode on that batch's AND words (the row pass alone), at
    W 1 / C 32 with hot histogram bins, at W 8 / C 200 and with an overflow
    list that starts at 1,000 and runs past capO; in the gather mode on the
    calls of the port bench's classic generic dispatch (W 1, 9 chunks of
    1,048,576 k-mers; gather_kernel_rows). Times, the twins' and the bounds
    of each. Returns the sorted-words mode's row of the kernel table and
    the gather mode's numbers (the [panel] phase adds its W 32 ones)."""
    import torch

    from colorid_tpu_torch.ops import query as tq
    from colorid_tpu_torch.ops import stream_query as sq

    t0 = time.time()
    calls = []
    real = sq._accumulate_sorted_words

    def observed(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    sq._accumulate_sorted_words = observed
    try:
        classic["stream"]()
        sync()
    finally:
        sq._accumulate_sorted_words = real
    a, kw = calls[-1]
    stats, _hist, over_col, _of = a[:4]
    args = a[4:]
    words_s, row_s, gidx_s, tb, reread, blocks2, mask, q, _base = args
    P, N, H = words_s.numel(), q.numel(), kw["num_hash"]
    C = stats.numel() - 3  # stats is [C + W + 2] with W 1
    capO = over_col.numel()
    errs = []
    accs = _epi_accs(C, 1, capO)
    errs.append(_epi_compare(
        f"classic dispatch (sorted-words mode, P={P} probes, N={N} k-mers, H {H}, C {C}, "
        f"{int(reread.sum())} re-read chunks of {tb.numel()})",
        tq._accumulate_sorted_words, tq._accumulate_sorted_words_plain, accs, args, kw))
    ms = cuda_ms(lambda: tq._accumulate_sorted_words(*accs, *args, **kw), 20)
    plain_ms = cuda_ms(lambda: tq._accumulate_sorted_words_plain(*accs, *args, **kw), 3)
    after = tq._accumulate_sorted_words(*_epi_accs(C, 1, capO), *args, **kw)
    n_kept = min(int(after[0][-1]), capO)
    _tb, inwin2d = sq.classic_plan(row_s, blocks2.shape[0])
    reread_rows = row_s.view(tb.numel(), -1)[~inwin2d & reread[:, None]]
    n_bytes = (16 * P + 32 * sectors(reread_rows.to(torch.int64), 1) + 5 * tb.numel()
               + 2 * 5 * N + 5 * N + 2 * 4 * (C + 3 + C * 1024) + 8 * n_kept)
    i_sorted = sass_loop_instructions("epilogue.cu", "epilogue_sorted_kernelILi2E")
    i_row = sass_loop_instructions("epilogue.cu", "epilogue_w1_kernelILi0E", outer=True)
    # instructions per 4 probes: the first pass's per 4 probes, the row
    # pass's per 4 k-mers (N = P / H of them)
    instr = None if i_sorted is None or i_row is None else round(i_sorted + i_row * N / P, 2)
    bound_ms, bound_by, how = _bound(n_bytes, P // 4, instr)
    log(f"[kernel] epilogue classic sorted-words P={P} N={N} H={H} C={C} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms=null (no single PyTorch call computes the "
        f"epilogue) bound_ms={bound_ms:.4f} bound_by={bound_by} ({how}; per 4 probes: "
        f"the first pass's loop {i_sorted} and the row pass's tile loop {i_row} per 4 "
        f"k-mers, weighted) launches on the main path={main_launches} on {card}")

    # the row pass alone: the AND-words mode on this batch's AND words
    wordsH = tq._patch_unsort_plain(*args[:6], tile_rows=kw["tile_rows"],
                                    nt=kw["nt"]).view(N, H)
    andw = wordsH[:, :1].clone()
    for h in range(1, H):
        andw &= wordsH[:, h:h + 1]
    present = (wordsH != 0).all(dim=1)
    del wordsH
    row_args = (andw, present, mask, q, 1, 0)
    row_kw = {"gidx": kw.get("gidx")}
    errs.append(_epi_compare(f"classic dispatch's AND words (AND-words mode, N={N}, C {C})",
                             tq._accumulate_tail, tq._accumulate_tail_plain, accs, row_args,
                             row_kw))
    row_ms = cuda_ms(lambda: tq._accumulate_tail(*accs, *row_args, **row_kw), 20)
    row_plain = cuda_ms(lambda: tq._accumulate_tail_plain(*accs, *row_args, **row_kw), 3)
    row_bound, row_by, row_how = _epi_row_bound(N, 1, n_kept, C)
    log(f"[kernel] epilogue AND-words row pass on the classic batch N={N} W 1 C {C} "
        f"ms={row_ms:.4f} plain_ms={row_plain:.4f} bound_ms={row_bound:.4f} "
        f"bound_by={row_by} ({row_how}; per row) on {card}")
    del andw, present, row_args

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    times = {}
    for what, N2, C2, W2, hot, n_over, cap in (
        ("AND words W 1 C 32 hot bins", EPI_N, 32, 1, True, 0, capO),
        ("AND words W 8 C 200", 1 << 21, 200, 8, False, 0, capO),
        ("AND words W 1 C 21 overflow from 1,000 past capO", 1 << 20, 21, 1, False, 1000,
         11_000),
    ):
        andw, present, msk, q2 = _epi_andw_case(g, N2, C2, W2, hot)
        accs2 = _epi_accs(C2, W2, cap, n_over)
        args2 = (andw, present, msk, q2, W2, 7_000_000)
        errs.append(_epi_compare(f"{what} (N={N2})", tq._accumulate_tail,
                                 tq._accumulate_tail_plain, accs2, args2, {}))
        if n_over:
            after2 = tq._accumulate_tail(*[x.clone() for x in accs2], *args2)
            if int(after2[0][-1]) <= cap:
                raise AssertionError("the overflow case did not run past capO")
            continue
        kept = min(int(tq._accumulate_tail(*[x.clone() for x in accs2], *args2)[0][-1]), cap)
        times[what] = (cuda_ms(lambda: tq._accumulate_tail(*accs2, *args2), 20),
                       cuda_ms(lambda: tq._accumulate_tail_plain(*accs2, *args2), 3),
                       _epi_row_bound(N2, W2, kept, C2))
        del andw, present, msk, q2, accs2
    log("[kernel] epilogue AND-words times: " + "; ".join(
        f"{w}: ms={k:.4f} plain_ms={p:.4f} bound_ms={b[0]:.4f} bound_by={b[1]} ({b[2]})"
        for w, (k, p, b) in times.items()) + f" on {card}")
    del accs, after, calls, a, args
    gather = gather_kernel_rows("on the classic generic dispatch (W 1)",
                                _gather_calls(classic["generic"]), card)
    log(f"[kernel] epilogue phase took {time.time() - t0:.1f}s")
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return {
        "name": "epilogue",
        "route": "cuda",
        "source": "colorid_tpu_torch/csrc/epilogue.cu",
        "replaces": "colorid_tpu/ops/query.py:319",
        "launches": main_launches,
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, gather


def gather_row(classic: dict, panel: dict, launches: int) -> dict:
    """The kernel table's row of kernel C's gather mode: the classic generic
    dispatch's numbers (W 1) and, under panel_*, the [panel] dispatch's (W
    32)."""
    row = {
        "name": "epilogue_gather",
        "route": "cuda",
        "source": "colorid_tpu_torch/csrc/epilogue.cu",
        "replaces": "colorid_tpu/ops/query.py:304",
        "launches": launches,
        "max_abs_err": max(classic["max_abs_err"], panel["max_abs_err"]),
    }
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
        row[key] = classic[key]
    for key in ("ms", "plain_ms", "bound_ms", "library_ms", "row_pass_ms", "row_pass_bound_ms",
                "row_pass_plain_ms"):
        row["panel_" + key] = panel[key]
    for key in ("row_pass_ms", "row_pass_bound_ms"):
        row[key] = classic[key]
    return row


# -- phase 4e: a 1,000-accession classic panel (kernel C's gather mode at W 32) --

PANEL_COLORS = 1000  # accessions: colors 0-20 the [main] classic index's own
PANEL_KMERS = 3_000_000  # seeded random 31-mers a further accession: a 3 Mbp genome's worth
PANEL_ORACLE = 262_144  # k-mers held against the numpy oracle


def panel_index(classic_bxi: str):
    """A classic index of PANEL_COLORS accessions at the [main] cell's -k 31
    -n 4 -s 50,000,000 (rows of 32 words: 6.4 GB), built on DEVICE from the
    seed: colors 0-20 are the [main] classic index's columns bit for bit;
    each further color is the Bloom column of PANEL_KMERS seeded random
    31-mers, placed by kernel A (device_rows) and ORed in by the device
    build's scatter_or_column; handed over through
    convert.index_from_arrays. Returns (the panel's BigsiIndex, the [main]
    index)."""
    import numpy as np
    import torch

    from colorid_tpu_torch import convert
    from colorid_tpu_torch.index.bigsi import BigsiIndex
    from colorid_tpu_torch.ops.build_ops import scatter_or_column
    from colorid_tpu_torch.ops.hash_torch import device_rows

    base = BigsiIndex.load(classic_bxi)
    R, H, C0 = base.bloom_size, base.num_hash, base.n_colors
    mat = torch.zeros((R, (PANEL_COLORS + 31) // 32), dtype=torch.int32, device=DEVICE)
    mat[:, 0] = torch.from_numpy(base.matrix[:, 0].copy().view(np.int32)).to(DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    for c in range(C0, PANEL_COLORS):
        v = torch.randint(0, 4**K, (PANEL_KMERS,), generator=g, device=DEVICE)
        packed = torch.stack([_as_i32(v & 0xFFFFFFFF), _as_i32(v >> 32)], dim=1)
        rows = device_rows(packed, k=K, num_hash=H, bloom_size=R)
        scatter_or_column(mat[:, c // 32], rows.reshape(-1), c % 32)
    matrix = mat.cpu().numpy().view(np.uint32)
    del mat
    names = list(base.colors) + [f"p{c:04d}" for c in range(C0, PANEL_COLORS)]
    index = convert.index_from_arrays(
        matrix, bloom_size=R, num_hash=H, k_size=K, colors=names,
        n_ref_kmers=dict(base.n_ref_kmers, **{n: PANEL_KMERS for n in names[C0:]}))
    return index, base


def panel_oracle(matrix, keys, qcounts, num_hash: int, C: int):
    """The SearchResult fields of k-mers keys [n, k] (frequencies qcounts)
    over a classic host matrix uint32 [R, W], from numpy alone: (counts,
    all_valid, and_all, the uniq-hit histogram [C, 1024], the overflow list
    sorted)."""
    import numpy as np

    from colorid_tpu_torch.hashing.xxh3 import bloom_rows_batch

    rows = bloom_rows_batch(keys, num_hash, matrix.shape[0]).astype(np.int64)
    vals = matrix[rows]  # [n, H, W]
    andw = np.bitwise_and.reduce(vals, axis=1)
    present = (vals != 0).any(axis=2).all(axis=1)
    bits = np.unpackbits(andw.view(np.uint8), axis=1, bitorder="little")[:, :C].astype(bool)
    counts = (bits & present[:, None]).sum(axis=0)
    and_all = (np.bitwise_and.reduce(andw[present], axis=0) if present.any()
               else np.full(matrix.shape[1], 0xFFFFFFFF, dtype=np.uint32))
    uniq = present & (bits.sum(axis=1) == 1)
    col = bits.argmax(axis=1)
    hist = np.zeros((C, 1024), dtype=np.int64)
    small = uniq & (qcounts < 1024)
    np.add.at(hist, (col[small], qcounts[small]), 1)
    big = uniq & (qcounts >= 1024)
    return counts, bool(present.all()), and_all, hist, sorted(zip(col[big].tolist(),
                                                                   qcounts[big].tolist()))


def _oracle_holds(res, want) -> bool:
    import numpy as np

    counts, all_valid, and_all, hist, over = want
    return (np.array_equal(res.counts, counts) and res.all_valid == all_valid
            and np.array_equal(res.and_all, and_all) and np.array_equal(res.freq_hist, hist)
            and sorted(zip(res.over_colors.tolist(), res.over_freqs.tolist())) == over)


def panel_phase(classic: dict, classic_bxi: str, reads: dict, card: str, strict: bool = True,
                measure: bool = True) -> tuple[int, dict | None]:
    """[panel]: the [main] cell's query through the engine's entry points on
    a 1,000-accession classic panel (panel_index: wpad 32, 6.4 GB on the
    card; the classic stream takes only wpad 1, so every route ends in the
    generic gather at W 32): search_keys on the 8.56 M host-counted k-mers
    of search -f 1 (host arrays), search_keys_dev_generic_async on the same
    k-mers device-resident, and search_reads on the 400,000 device-resident
    reads (the counted route). The three SearchResults equal each other
    (search_reads' overflow list in its own k-mer order), the twin route
    (_accumulate_one_plain in place of the kernel) on the card, and on a
    prefix of PANEL_ORACLE k-mers a numpy oracle over the host matrix;
    colors 0-20 count what the [main] classic index's search_keys counted.
    k-mers/s of each entry point, [profile] generic of one device-resident
    dispatch, the build's, H2D's and searches' seconds and
    max_memory_allocated. Where ``strict``, the dispatch must run no index,
    gather or reduction kernel (--compare's turns of an older checkout,
    whose generic gather is torch's, are not strict, and have no twin route
    to check). With ``measure``, kernel C's gather mode on the dispatch's
    own calls (gather_kernel_rows). Frees the panel. Returns (the gather
    mode's launches in the three entry points, its numbers or None)."""
    import numpy as np
    import torch

    from colorid_tpu_torch.bench import same_result
    from colorid_tpu_torch.engine import QueryEngine
    from colorid_tpu_torch.ops import query as tq
    from colorid_tpu_torch.ops.query import row_wpad

    t_phase = time.time()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    index, base = panel_index(classic_bxi)
    t_build = time.time() - t0
    t0 = time.time()
    eng = QueryEngine(index, device=DEVICE)
    sync()
    t_h2d = time.time() - t0
    C, C0 = index.n_colors, base.n_colors
    if eng.wpad != row_wpad(index.words_per_row) or eng._stream_classic or eng._wide:
        raise AssertionError(f"the panel is not a classic wpad 32 index (wpad {eng.wpad})")
    keys, qcounts, packed = classic["query"]
    n = keys.shape[0]
    pk_dev = torch.from_numpy(packed.view(np.int32)).to(DEVICE)
    qc_dev = torch.from_numpy(np.maximum(qcounts, 1).astype(np.int32)).to(DEVICE)
    capO = -(-n // 1024) * 1024
    words, lens, vbits = reads["dev"]

    def dispatch():
        return eng.search_keys_dev_generic_async(pk_dev, qc_dev, K, capO=capO)

    entries = {
        "search_keys": lambda: eng.search_keys(keys, qcounts=qcounts, packed_all=packed, k=K),
        "search_keys_dev_generic_async": lambda: eng.search_keys_dev_finish(
            *_fetched(dispatch())),
        "search_reads": lambda: eng.search_reads(words, lens, vbits, k=K, L=reads["L"],
                                                 filter_t=1),
    }
    got, secs = {}, {}
    launches = getattr(tq._accumulate_one, "launches", 0)
    for name, fn in entries.items():
        sync()
        t0 = time.time()
        got[name] = fn()
        sync()
        secs[name] = time.time() - t0
    launches = getattr(tq._accumulate_one, "launches", 0) - launches
    res_reads, n_u = got.pop("search_reads")
    res = got["search_keys"]
    if not same_result(got["search_keys_dev_generic_async"], res):
        raise AssertionError("[panel] device-resident generic != search_keys")
    if n_u != n or not same_result(res_reads, res):
        raise AssertionError(f"[panel] search_reads != search_keys ({n_u} of {n} k-mers)")
    if not np.array_equal(res.counts[:C0], classic["result"].counts):
        raise AssertionError("[panel] colors 0-20 differ from the [main] classic index's counts")
    # the twin route on the card: the same entry points with the plain twin
    if strict:
        def twin_of(_real):
            return lambda *a, **kw: tq._accumulate_one_plain(*a, **kw)

        with gather_replaced(twin_of):
            twin = {name: fn() for name, fn in entries.items()}
        if not (same_result(twin["search_keys"], res)
                and same_result(twin["search_keys_dev_generic_async"], res)
                and same_result(twin["search_reads"][0], res_reads)):
            raise AssertionError("[panel] the kernel's route != the twin route on the card")
        del twin
    # a prefix against the numpy oracle over the host matrix
    P = min(PANEL_ORACLE, n)
    want = panel_oracle(index.matrix, keys[:P], np.maximum(qcounts[:P], 1), index.num_hash, C)
    pre_keys = eng.search_keys(keys[:P], qcounts=qcounts[:P], packed_all=packed[:P], k=K)
    pre_dev = eng.search_keys_dev_finish(*_fetched(eng.search_keys_dev_generic_async(
        pk_dev[:P], qc_dev[:P], K, capO=-(-P // 1024) * 1024)))
    if not (_oracle_holds(pre_keys, want) and _oracle_holds(pre_dev, want)):
        raise AssertionError("[panel] the prefix != the numpy oracle")
    rates = {name: n / sec for name, sec in secs.items()}
    reps = 3
    sync()
    t0 = time.time()
    vecs = torch.stack([dispatch()[0] for _ in range(reps)]).cpu()
    rates["search_keys_dev_generic_async (queued)"] = reps * n / (time.time() - t0)
    del vecs
    peak = torch.cuda.max_memory_allocated() / 2**30 if DEVICE == "cuda" else 0.0
    log(f"[panel] {C} colors (0-{C0 - 1} the [main] classic index's, {C - C0} of "
        f"{PANEL_KMERS} seeded 31-mers each), -k {K} -n {index.num_hash} -s {index.bloom_size}, "
        f"wpad {eng.wpad} ({index.bloom_size * eng.wpad * 4 / 1e9:.1f} GB): build "
        f"{t_build:.1f}s, H2D {t_h2d:.1f}s; {n} k-mers: SearchResults identical (search_keys, "
        f"search_keys_dev_generic_async; search_reads {n_u} k-mers), "
        f"{'equal to the twin route on the card, ' if strict else ''}"
        f"the first {P} to the numpy oracle, colors 0-{C0 - 1} to the [main] "
        f"classic index's counts; search seconds "
        + ", ".join(f"{k} {v:.2f}s" for k, v in secs.items())
        + "; k-mers/s " + ", ".join(f"{k} {v:.0f}" for k, v in rates.items())
        + f"; gather-mode launches {launches}; max_memory_allocated {peak:.1f} GiB on {card}")
    numbers = None
    if DEVICE == "cuda":
        profile_dispatch(lambda: dispatch()[0], "generic panel W 32", card, label="generic",
                         forbid_like=GENERIC_FORBID if strict else ())
    if measure:
        numbers = gather_kernel_rows("on the panel dispatch (W 32)",
                                     _gather_calls(lambda: dispatch()[0]), card)
    del eng, index, base, pk_dev, qc_dev, entries, got
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    log(f"[panel] phase took {time.time() - t_phase:.1f}s")
    return launches, numbers


# -- phase 4-stream_tail: kernel D on the blocked dispatch's inputs -----------

TAIL_WRAPPERS = ("stream_chunk_plan", "stream_tail")
SPARSE_CHUNKS = 300  # chunks of the sparse batch: more residual chunks than nch


def _clone(x):
    import torch

    return x.clone() if torch.is_tensor(x) else x


def _outputs_err(got, want) -> int:
    """max_abs_diff over two tuples of outputs (None where both have none)."""
    errs = []
    for x, y in zip(got, want):
        if x is None or y is None:
            if (x is None) != (y is None):
                raise AssertionError("a kernel output is missing on one side")
            continue
        errs.append(max_abs_diff(x, y))
    return max(errs)


def stream_tail_kernel_phase(blocked_dispatch, main_launches: int, card: str) -> dict:
    """Kernel D (csrc/stream_tail.cu) against its twins, bitwise: each entry
    point (the plan D1 from the sorted key with the residual chunk list,
    the tail D2 with the four accumulators and the residual gather) on the
    inputs that the device-resident blocked dispatch hands it (the real
    blocked segment, 9,437,184 slots, the frequency in an int32 key that
    kernel E sorted with its payloads), and one launch of each a batch in
    that dispatch; and the card's route (kernel A's packed mode, the key
    sort, kernel D, the probe kernel, the epilogue) against the twins'
    route (_stream_core_plain) on the card, all four accumulators and
    n_drop: on that batch, on it in clipped mode with a global index (the
    frequency in the key: kernel E carries the index; the frequency out of
    the key, as past 2^20 blocks: kernel E's three operands), with every
    frequency raised by 1,024
    (every unique hit big: more than OVER_CAP, from an overflow list 1,000
    slots below capO) and on a sparse batch (its first SPARSE_CHUNKS
    chunks' k-mers over the whole matrix: more residual chunks than nch,
    n_drop > 0); and kernel A's packed mode against its twin on the
    dispatch's k-mers. The times of D1 and D2 and of their twins on the
    real batch, and their bound (stream_tail_bytes, beside the five-launch
    design's count; D1's loop for the operations)."""
    import torch

    from colorid_tpu_torch.ops import hash_torch as ht
    from colorid_tpu_torch.ops import stream_query as sq

    t0 = time.time()
    seen: dict = {}
    names = TAIL_WRAPPERS + ("stream_accumulate_hash_exact", "_stream_core_kernels")
    reals = {n: getattr(sq, n) for n in names}
    batches = []

    def observer(name):
        def observed(*a, **kw):
            if name == "_stream_core_kernels":
                batches.append(a[5][0].numel())
            else:
                seen[name] = ([_clone(x) for x in a], {k: _clone(v) for k, v in kw.items()})
            return reals[name](*a, **kw)

        # each wrapper counts its launches on the module's name, the observer now
        observed.launches = getattr(reals[name], "launches", 0)
        return observed

    for n in names:
        setattr(sq, n, observer(n))
    try:
        blocked_dispatch()
        sync()
    finally:
        for n in names:
            if n in TAIL_WRAPPERS:
                launched = getattr(sq, n).launches - reals[n].launches
                if DEVICE == "cuda" and launched != len(batches):
                    raise AssertionError(f"{n}: {launched} launches for {len(batches)} stream "
                                         "batches in the blocked dispatch; one a batch")
                reals[n].launches = getattr(sq, n).launches
            setattr(sq, n, reals[n])
    errs, outs, ms, plain_ms, span_ms, host_us, gaps = {}, {}, {}, {}, {}, {}, {}
    for n in TAIL_WRAPPERS:
        a, kw = seen[n]
        twin = getattr(sq, n + "_plain")
        pair = []
        for fn in (reals[n], twin):
            args = [_clone(x) for x in a]
            res = fn(*args, **kw)
            pair.append(list(res) + (args[:4] if n == "stream_tail" else []))
        sync()
        errs[n] = _outputs_err(*pair)
        outs[n] = pair[0]
        if errs[n]:
            raise AssertionError(f"{n} kernel != twin on the real segment: max_abs_err {errs[n]}")
        args = [_clone(x) for x in a]
        ms[n], gaps[n] = device_ms(lambda: reals[n](*args, **kw), 20,
                                   tuple(k + "_kernel" for k in D_KERNELS))
        span_ms[n] = cuda_ms(lambda: reals[n](*args, **kw), 20)
        host_us[n] = enqueue_us(lambda: reals[n](*args, **kw))[0]
        plain_ms[n] = cuda_ms(lambda: twin(*args, **kw), 3)

    # the bound from this batch's inputs: D1 on kernel E's sorted key (or
    # on probes sorted already)
    pa, pkw = seen["stream_chunk_plan"]
    key_s = pkw.get("key_s")
    P = (key_s if key_s is not None else pkw["blk_s"]).numel()
    ta, tkw = seen["stream_tail"]
    stats0, over_col = ta[0], ta[2]
    C, W = tkw["n_colors"], tkw["wpad"]
    hw = ta[7].shape[1]
    capO = over_col.numel()
    cidx, meta = outs["stream_chunk_plan"][4], outs["stream_chunk_plan"][5]
    n_cov = int(meta[1])
    stats1 = outs["stream_tail"][6]
    before, after = int(stats0[C + W + 1]), int(stats1[C + W + 1])
    n_kept = max(0, min(after, capO) - min(before, capO))
    mask = outs["stream_tail"][2]
    c = cidx[:n_cov].to(torch.int64)
    rows = (torch.arange(sq.PC, device=c.device) + c[:, None] * sq.PC).reshape(-1)
    live_rows = rows[mask[: n_cov * sq.PC]]
    blk_l = ta[8][live_rows].to(torch.int64)
    off_l = ta[9][live_rows].to(torch.int64)
    starts = torch.cat([blk_l * 128 + ((off_l >> (8 * h)) & 0xFF) * W
                        for h in range(tkw["num_hash"])])
    n_res = int(mask.sum())
    counts = dict(pc=sq.PC, n_slots=cidx.numel(), n_listed=n_cov, W=W, C=C, hw=hw,
                  key_bytes=0 if key_s is None else key_s.element_size(), n_res=n_res,
                  res_sectors=sectors(starts, W) if n_res else 0, n_kept=n_kept)
    n_bytes = stream_tail_bytes(P, **counts)
    old_bytes = stream_tail_bytes_five_launches(P, **counts)
    # D1's largest loop, whose body takes 4 probes (16-byte accesses)
    instr = sass_loop_instructions("stream_tail.cu", "plan_kernel", outer=True)
    bound_ms, bound_by, how = _bound(n_bytes, P // 4, instr)
    total, total_plain = sum(ms.values()), sum(plain_ms.values())
    how_in = ("probes sorted already" if key_s is None else
              f"key {key_s.dtype}, qbits {pkw['qbits']}, sorted with its payloads")
    log(f"[kernel] stream_tail real segment: P={P} ({P // sq.PC} chunks, {how_in}), "
        f"{len(batches)} batch(es) in the dispatch, 2 launches each (plan, tail); "
        f"{n_cov} residual chunks listed of {cidx.numel()} slots, {n_res} residual probes, "
        f"{n_kept} overflow entries kept; "
        f"bitwise_equal=True for plan (streams, list, counts) and tail (stats, hist, "
        f"over_col, over_freq, residual rows, n_drop) (max_abs_err {max(errs.values())}); "
        f"ms plan={ms['stream_chunk_plan']:.4f} tail={ms['stream_tail']:.4f} "
        f"total={total:.4f} (device time a call, memsets included: torch.profiler over 20 "
        f"calls; {'; '.join(g for g in gaps.values() if g) or 'traces complete'}); span "
        f"of 20 calls back to back (CUDA events, host-paced where a call's host "
        f"work outlasts its kernels) plan={span_ms['stream_chunk_plan']:.4f} "
        f"tail={span_ms['stream_tail']:.4f}; host us a call plan="
        f"{host_us['stream_chunk_plan']:.1f} tail={host_us['stream_tail']:.1f} (median of 20); "
        f"plain_ms plan={plain_ms['stream_chunk_plan']:.4f} "
        f"tail={plain_ms['stream_tail']:.4f} total={total_plain:.4f}; library_ms=null (no "
        f"single PyTorch call computes the plan, the tail or the gather) bound_ms="
        f"{bound_ms:.4f} bound_by={bound_by} ({how}: items of 4 probes in D1's loop); the "
        f"five-launch design's count on this batch {old_bytes} bytes = "
        f"{old_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; "
        f"launches on the main path={main_launches} on {card}")
    del outs, seen["stream_chunk_plan"], seen["stream_tail"]

    # the whole route against the twins' route on the card
    pa, pkw = seen["stream_accumulate_hash_exact"]
    stats, hist, over_col, over_freq, blocks2, packed, qcounts = pa[:7]
    geo = {k: v for k, v in pkw.items() if k != "qc_in_key"}
    in_key = pkw["qc_in_key"] and sq._qc_in_key_ok(geo["bloom_size"], geo["rpb"])
    # kernel A's packed mode on the dispatch's own k-mers, as the route ran it
    kkw = dict(k=geo["k"], num_hash=geo["num_hash"], bloom_size=geo["bloom_size"],
               rpb=geo["rpb"], version=geo["bv"], qbits=sq.QKEY_BITS if in_key else 0,
               qmin=0, qmax=sq.QKEY_MASK)
    qq = qcounts if in_key else None
    got = ht.placement_keyoff(packed, qq, **kkw)
    errs["placement_keyoff"] = placement_err(got, ht.placement_keyoff_plain(packed, qq, **kkw))
    sync()
    log(f"[kernel] stream_tail placement packed mode on the dispatch's {packed.shape[0]} "
        f"k-mers (key {got[0].dtype}, qbits {kkw['qbits']}): bitwise_equal="
        f"{errs['placement_keyoff'] == 0} max_abs_err {errs['placement_keyoff']}")
    if errs["placement_keyoff"]:
        raise AssertionError("placement packed mode != twin on the blocked dispatch's k-mers")
    del got
    P = packed.shape[0]
    n_sp = SPARSE_CHUNKS * sq.PC
    cases = (
        ("the dispatch's batch", packed, qcounts, 0, None, in_key),
        ("clipped mode, global index (kernel E carries the index)", packed,
         qcounts.clamp(max=65535), 0, 7_000_000, True),
        ("clipped mode, the frequency not in the key, as past 2^20 blocks (kernel E's "
         "three operands)", packed, qcounts.clamp(max=65535), 0, 7_000_000, False),
        ("every frequency + 1,024 (big past OVER_CAP), overflow list from capO - 1,000",
         packed, torch.where(qcounts > 0, qcounts + 1024, 0), capO - 1000, None, False),
        (f"sparse: {n_sp} slots over the whole matrix", packed[:n_sp].contiguous(),
         qcounts[:n_sp].contiguous(), 0, None, in_key),
    )
    drops = []
    for what, pk, q, n_over, base0, qkey in cases:
        got = []
        for route in (True, False):
            acc = _epi_accs(C, W, capO, n_over)
            got.append(sq._stream_accumulate(
                *acc, blocks2, pk, q, base0, qbits=sq.QKEY_BITS if qkey else 0,
                qmin=None if base0 is not None else 0,
                qmax=sq.FREQ_CAP if base0 is not None else sq.QKEY_MASK,
                kernels_route=route, **geo))
        sync()
        err = max(max_abs_diff(x, y) for x, y in zip(*got))
        nd = int(got[0][4])
        drops.append(nd)
        log(f"[kernel] stream_tail route {what}: stats, hist, over_col, over_freq, n_drop "
            f"bitwise_equal={err == 0} (card's route vs twins' route) n_over "
            f"{n_over} -> {int(got[0][0][C + W + 1])} of capO {capO}, n_drop {nd}")
        if err:
            raise AssertionError(f"stream_tail route != twins' route ({what}): {err}")
        errs[what] = err
    if DEVICE == "cuda" and (drops[0] or not drops[3] or not drops[4]):
        raise AssertionError(f"stream_tail: n_drop {drops}: the real batch must drop "
                             "nothing, the big and the sparse batch must")
    log(f"[kernel] stream_tail phase took {time.time() - t0:.1f}s")
    del seen, pa, stats, hist, over_col, over_freq, blocks2, packed, qcounts
    torch.cuda.empty_cache()
    return {
        "name": "stream_tail",
        "route": "cuda",
        "source": "colorid_tpu_torch/csrc/stream_tail.cu",
        "replaces": "colorid_tpu/ops/stream_query.py:895",
        "launches": main_launches,
        "max_abs_err": max(errs.values()),
        "ms": total,
        "plain_ms": total_plain,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "plan_ms": ms["stream_chunk_plan"],
        "tail_ms": ms["stream_tail"],
        "span_ms": sum(span_ms.values()),
        "bound_ms_five_launch_count": old_bytes / HBM_BYTES_PER_S * 1e3,
    }


# -- phase 4-sort: kernel E on both dispatches' inputs ------------------------

SORT_EDGE_P = 1 << 20  # keys of each synthetic edge case of [kernel] sort


def _sort_args(a, kw):
    """A sort_payloads call's (key, bits, operands, keywords)."""
    kw = dict(kw)
    ops = tuple(a[2]) if len(a) > 2 else tuple(kw.pop("operands", ()))
    return a[0], a[1], ops, kw


def _sort_capture(classic_dispatch, blocked_dispatch) -> dict:
    """The sort_payloads calls (key, bits, operands, keywords) that the
    blocked and the classic device-resident dispatch make, each run once;
    the launches of the wrapper kept as they were counted."""
    from colorid_tpu_torch.ops import stream_query as sq

    real = sq.sort_payloads
    seen = {}

    def observer(what):
        def observed(*a, **kw):
            seen[what] = _sort_args(a, kw)
            return real(*a, **kw)

        observed.launches = real.launches  # the wrapper counts on its module name
        return observed

    for what, dispatch in (("blocked", blocked_dispatch), ("classic", classic_dispatch)):
        sq.sort_payloads = observer(what)
        try:
            dispatch()
            sync()
        finally:
            real.launches = sq.sort_payloads.launches
            sq.sort_payloads = real
        if what not in seen:
            raise AssertionError(f"the {what} dispatch did not sort with kernel E")
    return seen


def _sort_library(key, ops, kw):
    """torch.sort(stable) of the key with the operands and the index
    gathered through its permutation: the library call E stands beside."""
    import torch

    key_s, perm = torch.sort(key, stable=True)
    out = [key_s] + [o[perm] for o in ops]
    if kw.get("index"):
        out.append(perm + kw.get("base", 0) if kw.get("index64")
                   else (perm + kw.get("base", 0)).to(torch.int32))
    return out


def _launch_ms(fn) -> list:
    """The device kernels of one call of fn, in launch order: [(name, ms)]
    ([] where the trace lost device events or has none)."""
    import torch

    prof, _ms, gap = trace(fn)
    if gap:
        return []
    out = []
    for e in prof.events():
        name = _kernel_name(e.name)
        if e.device_type != torch.autograd.DeviceType.CUDA or name == MARKER:
            continue
        out.append((e.time_range.start, name, e.time_range.elapsed_us() / 1e3))
    return [(n, ms) for _, n, ms in sorted(out)]


def sort_turn_phase(classic_dispatch, blocked_dispatch, card: str) -> None:
    """--compare's [kernel] sort: kernel E of the turn's checkout on the
    blocked and the classic dispatch's own sort inputs, bitwise against its
    twin, and its time beside torch.sort's with the gathers."""
    from colorid_tpu_torch.ops import stream_query as sq

    seen = _sort_capture(classic_dispatch, blocked_dispatch)
    for what in ("blocked", "classic"):
        key, bits, ops, kw = seen[what]
        err = max(max_abs_diff(x, y) for x, y in zip(sq.sort_payloads(key, bits, ops, **kw),
                                                      sq.sort_payloads_plain(key, bits, ops,
                                                                             **kw)))
        if err:
            raise AssertionError(f"sort kernel != twin ({what} dispatch): max_abs_err {err}")
        ms = cuda_ms(lambda: sq.sort_payloads(key, bits, ops, **kw), 20)
        lib = cuda_ms(lambda: _sort_library(key, ops, kw), 20)
        log(f"[kernel] sort {what} dispatch: P={key.numel()} bits {bits} passes "
            f"{sq.sort_passes(bits)} bitwise_equal=True ms={ms:.4f} library_ms={lib:.4f} on "
            f"{card}")


def _digit_stats(key, bits: int) -> str:
    """Per pass of the sort's plan, the largest digit's share of the
    probes; and the most frequent key's."""
    import torch

    from colorid_tpu_torch.ops import stream_query as sq

    parts, shift = [], 0
    for w in sq.sort_passes(bits):
        c = torch.bincount(((key >> shift) & ((1 << w) - 1)).to(torch.int64), minlength=1 << w)
        parts.append(f"{w} bits: largest digit {int(c.max())} "
                     f"({100 * int(c.max()) / key.numel():.2f} %)")
        shift += w
    _vals, counts = torch.unique(key, return_counts=True)
    top = int(counts.max())
    return (f"{'; '.join(parts)}; most frequent key {top} probes "
            f"({100 * top / key.numel():.2f} %)")


def sort_kernel_phase(classic_dispatch, blocked_dispatch, main_launches: int,
                      card: str) -> dict:
    """Kernel E (csrc/radix_sort.cu) against its twin, bitwise, on the
    inputs that the device-resident dispatches hand it: the blocked batch's
    key (the frequency in its low bits, 30 bits) with its packed offsets,
    the same with the generated index from base0 7,000,000, the classic
    batch's rows (26 bits) with their index widened to int64, each with
    its digits' skew (the largest digit of each pass, the most frequent
    key: the padding); and on edge cases: all keys equal, keys descending,
    bits 1 and 31, P not a multiple of the tile, a P of a few hundred, the
    blocked batch's blocks times 3 (past 2^20 blocks, 21 bits, where the
    frequency leaves the key) with three operands, and at 2,097,152 keys
    the main cell's skew: a key with 10 % of the probes, four 26-bit rows
    with 1 % each (index int64), every key's top bits equal, and bits <=
    10 (one pass). The time of E, of its twin and of torch.sort(stable)
    with the operands gathered through its permutation (the library call)
    on each dispatch's batch, each of E's launches apart (torch.profiler,
    in launch order), and the bound (sort_bytes: the bytes bind; the
    operations are a few integer instructions a key a pass, which the SASS
    of a straight-line kernel with its branches does not count); on the
    blocks past 2^20, E beside torch.sort of the int64 key block << 11 |
    frequency with the offsets and the index gathered through its
    permutation (the route that geometry took before E)."""
    import torch

    from colorid_tpu_torch.ops import stream_query as sq

    t0 = time.time()
    real = sq.sort_payloads
    seen = _sort_capture(classic_dispatch, blocked_dispatch)
    for what in ("blocked", "classic"):
        key, bits = seen[what][:2]
        log(f"[kernel] sort {what} dispatch's digits: P={key.numel()} bits {bits}, passes "
            f"{sq.sort_passes(bits)}: {_digit_stats(key, bits)} on {card}")

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    n = SORT_EDGE_P

    def rand(P, hi, lo=0):
        return torch.randint(lo, hi, (P,), generator=g, device=DEVICE, dtype=torch.int32)

    bkey, bbits, bops, bkw = seen["blocked"]
    ckey, cbits, cops, ckw = seen["classic"]
    cases = [
        ("blocked dispatch (exact mode: key + packed offsets)", bkey, bbits, bops, bkw),
        ("blocked dispatch with the index from base0 7,000,000", bkey, bbits, bops,
         dict(index=True, base=7_000_000)),
        ("classic dispatch (rows + index as int64)", ckey, cbits, cops, ckw),
        ("all keys equal", torch.full((n,), 12345, dtype=torch.int32, device=DEVICE), 30,
         (rand(n, 2**31 - 1, -(2**31)),), dict(index=True)),
        ("keys descending", (2**21 - 1) - torch.arange(n, dtype=torch.int32, device=DEVICE),
         21, (), dict(index=True, index64=True)),
        ("bits 1", rand(n, 2), 1, (rand(n, 2**31 - 1),), dict(index=True)),
        ("bits 31", rand(n, 2**31 - 1), 31, (rand(n, 2**31 - 1),), {}),
        ("P not a multiple of the tile", rand(n + 1234, 2**26), 26, (),
         dict(index=True, index64=True)),
        ("a P of 300", rand(300, 2**20), 20, (rand(300, 100), rand(300, 100)),
         dict(index=True, base=11)),
    ]
    # the main cell's skew at 2 * SORT_EDGE_P keys
    m = 2 * n
    hot = rand(m, 2**30)
    hot[torch.randperm(m, generator=g, device=DEVICE)[:m // 10]] = 987_654_321
    rows = rand(m, 2**26)
    rows[torch.randperm(m, generator=g, device=DEVICE)[:4 * (m // 100)]] = rand(
        4, 2**26).repeat_interleave(m // 100)
    cases += [
        ("a key with 10 % of the probes", hot, 30, (rand(m, 2**31 - 1, -(2**31)),),
         dict(index=True)),
        ("four rows with 1 % each", rows, 26, (), dict(index=True, index64=True)),
        ("every key's top bits equal", rand(m, 2**22) + (3 << 27), 30,
         (rand(m, 2**31 - 1, -(2**31)),), {}),
        ("bits 8, one pass", rand(m, 2**8), 8, (rand(m, 2**31 - 1),),
         dict(index=True, index64=True)),
    ]
    del hot, rows
    blk = ((bkey >> sq.QKEY_BITS) * 3).contiguous()  # past 2^20 blocks
    bqc = (bkey & sq.QKEY_MASK).contiguous()
    cases.append(("the blocked batch's blocks times 3 (past 2^20 blocks, qbits 0) with three "
                  "operands", blk, sq.key_bits(int(blk.max())), (bops[0], bqc),
                  dict(index=True, base=7_000_000)))
    errs = []
    for what, key, bits, ops, kw in cases:
        before = real.launches
        got = real(key, bits, ops, **kw)
        want = sq.sort_payloads_plain(key, bits, ops, **kw)
        sync()
        err = max(max_abs_diff(x, y) for x, y in zip(got, want))
        errs.append(err)
        log(f"[kernel] sort {what}: P={key.numel()} bits {bits} ({len(sq.sort_passes(bits))} "
            f"passes), {len(ops)} operands, index {kw.get('index', False)}"
            f"{' int64' if kw.get('index64') else ''}: bitwise_equal={err == 0} "
            f"launched={real.launches - before}")
        if err or (DEVICE == "cuda" and real.launches != before + 1):
            raise AssertionError(f"sort kernel != twin ({what}): max_abs_err {err}")
        del got, want

    times = {}
    for name, (what, key, bits, ops, kw) in zip(("blocked", "blocked_index", "classic"),
                                                 cases[:3]):
        P = key.numel()
        ms = cuda_ms(lambda: real(key, bits, ops, **kw), 20)
        plain = cuda_ms(lambda: sq.sort_payloads_plain(key, bits, ops, **kw), 3)
        lib = cuda_ms(lambda: _sort_library(key, ops, kw), 20)
        stages = _launch_ms(lambda: real(key, bits, ops, **kw))
        log(f"[kernel] sort {what}: each launch in order, ms: "
            + ("; ".join(f"{k} {t:.4f}" for k, t in stages) or "not measured (no complete "
               "trace)") + f" on {card}")
        n_bytes = sort_bytes(P, n_operands=len(ops), index=kw.get("index", False),
                             index64=kw.get("index64", False))
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        times[name] = (ms, plain, lib, bound_ms, "bytes")
        log(f"[kernel] sort {what}: P={P} bits {bits} ms={ms:.4f} plain_ms={plain:.4f} "
            f"library_ms={lib:.4f} (torch.sort(stable) + the operands gathered through its "
            f"permutation) bound_ms={bound_ms:.4f} bound_by=bytes (bytes={n_bytes}, each "
            f"input read once and each output written once; operations not counted) "
            f"launches on the main path={main_launches} on {card}")

    # past 2^20 blocks: E on the block alone with three operands, beside
    # torch.sort of the int64 key with the frequency in it and the gathers
    what, key, bits, ops, kw = cases[-1]
    key64 = (key.to(torch.int64) << sq.QKEY_BITS) | bqc

    def int64_route():
        key_s, perm = torch.sort(key64, stable=True)
        return key_s, ops[0][perm], (perm + kw["base"]).to(torch.int32)

    ms = cuda_ms(lambda: real(key, bits, ops, **kw), 20)
    sort64 = cuda_ms(lambda: torch.sort(key64, stable=True), 20)
    route64 = cuda_ms(int64_route, 20)
    n_bytes = sort_bytes(key.numel(), n_operands=len(ops), index=True, index64=False)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    times["wide"] = (ms, route64, sort64, bound_ms)
    log(f"[kernel] sort past 2^20 blocks: P={key.numel()} bits {bits}, max block "
        f"{int(key.max())}: kernel E with the offsets, the frequencies and the index "
        f"ms={ms:.4f}; torch.sort(int64 key block << 11 | frequency, stable) ms={sort64:.4f}, "
        f"with the offsets and the index gathered through its permutation ms={route64:.4f}; "
        f"E's bound_ms={bound_ms:.4f} bound_by=bytes (bytes={n_bytes}) on {card}")
    del key64
    log(f"[kernel] sort phase took {time.time() - t0:.1f}s")
    del seen, cases, bkey, bops, ckey, blk, bqc, key, ops
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    ms, plain, lib, bound_ms, bound_by = times["blocked"]
    row = {
        "name": "sort_payloads",
        "route": "cuda",
        "source": "colorid_tpu_torch/csrc/radix_sort.cu",
        "replaces": "colorid_tpu/ops/stream_query.py:623",
        "launches": main_launches,
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib,
    }
    for name in ("blocked_index", "classic"):
        for key, v in zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"),
                          times[name]):
            row[f"{name}_{key}"] = v
    for key, v in zip(("ms", "int64_route_ms", "int64_sort_ms", "bound_ms"), times["wide"]):
        row[f"wide_{key}"] = v
    return row


# -- phase 4a: the port's bench on this cell ----------------------------------

BENCH_TIMEOUT = 600  # seconds for the bench's subprocess
BENCH_RATES = ("stream", "generic", "fused", "classic")


def bench_phase(tmp: str, classic_bxi: str, blocked_bxi: str, card: str) -> dict:
    """python -m colorid_tpu_torch.bench in a subprocess on the card, its
    cache holding phase 3's two indexes under the bench's names (the same
    bytes as its own build of this cell), each stamped with this script's
    cell, so none is built twice: rc 0, one JSON line with every rate above
    0, no parity key, this card's name, the fused rate timed on queued
    single fused dispatches. Returns the kernel wrappers' launches in the
    bench's run, and under "run_counts_by_mode" kernel F's by mode (all
    of them made in the bench's phases)."""
    import torch

    from colorid_tpu_torch.bench import cell_stamp, write_stamp

    cache = os.path.join(tmp, "bench_cache")
    os.makedirs(cache)
    for bxi, name, blocked in ((classic_bxi, "bench50M.bxi", False),
                               (blocked_bxi, "bench50M_blocked.bxi", True)):
        os.symlink(bxi, os.path.join(cache, name))
        write_stamp(os.path.join(cache, name),
                    cell_stamp(blocked, N_GENOMES, GENOME_LEN, BLOOM))
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "colorid_tpu_torch.bench", "--device", DEVICE], cwd=HERE,
        env=dict(os.environ, BENCH_CACHE_DIR=cache), capture_output=True, text=True,
        timeout=BENCH_TIMEOUT,
    )
    dt = time.time() - t0
    launches = by_mode = h_by_mode = None
    for line in r.stderr.splitlines():
        if line.startswith("[launches] "):
            launches = json.loads(line.split(" ", 1)[1])
        if line.startswith("[launches by mode] run_counts "):
            by_mode = json.loads(line.split(" ", 4)[4])
        if line.startswith("[launches by mode] readid "):
            h_by_mode = json.loads(line.split(" ", 4)[4])
        if line.startswith(("[", "card:", "query:", "loading", "building", "parity", "PARITY",
                            "fused route")):
            log(f"[bench] | {line}")
    lines = [l for l in r.stdout.splitlines() if l.strip()]
    if (r.returncode != 0 or len(lines) != 1 or launches is None or by_mode is None
            or h_by_mode is None):
        print(r.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"[bench] rc {r.returncode}, stdout {lines}")
    if sum(by_mode.values()) != launches["run_counts"]:
        raise AssertionError(f"[bench] kernel F launched {by_mode} by mode, "
                             f"{launches['run_counts']} in the phases")
    launches["run_counts_by_mode"] = by_mode
    launches["readid_by_mode"] = h_by_mode
    rec = json.loads(lines[0])
    want = torch.cuda.get_device_name(0) if DEVICE == "cuda" else "cpu"
    rates = [rec.get(f"{k}_kmers_per_s", 0) for k in BENCH_RATES] + [
        rec.get("read_id_pairs_per_s", 0)]
    if min(rates) <= 0 or "parity" in rec or rec.get("device") != want:
        raise AssertionError(f"[bench] line out of contract: {lines[0]}")
    if "fused route timed: queued single fused dispatches" not in r.stderr:
        raise AssertionError("[bench] the fused rate was not timed on queued single "
                             "fused dispatches")
    log(f"[bench] {lines[0]} in {dt:.1f}s on {card}")
    return launches


# -- phase 4b: the reads path (read classifier, device k-mer counting) --------

N_PAIRS, INSERT, N_CHECK, N_ROUTES, N_PROFILE = 200_000, 500, 5_000, 20_000, 8_192


def _genome(path: str):
    """The bases of a one-record fasta written by synth_inputs."""
    import numpy as np

    raw = np.fromfile(path, dtype=np.uint8)
    body = raw[raw.tobytes().index(b"\n") + 1:]
    return body[body != ord("\n")]


def synth_pairs(tmp: str):
    """Seeded paired-end reads for read_id: N_PAIRS pairs of READ_LEN bp from
    the first N_SOURCES genomes (insert INSERT, mate 2 reverse-complemented,
    SUB_RATE substitutions), 2 % more pairs of random junk, then 1 % of the
    pairs with an N, 0.5 % whose first mate is cut below k (too_short), 20
    with a lowercase stretch and 1 % exact duplicates of another pair, all
    in a random order. Returns (mates [n, 2, READ_LEN] uint8, per pair the
    source genome (-1 junk), its first mate's length, a lowercase flag)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 6)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, dtype=np.uint8)
    comp[acgt] = np.frombuffer(b"TGCA", dtype=np.uint8)
    gs = np.stack([_genome(os.path.join(tmp, f"genome{i:02d}.fasta"))
                   for i in range(N_SOURCES)])
    n = N_PAIRS + N_PAIRS // 50
    src = rng.integers(0, N_SOURCES, n)
    src[N_PAIRS:] = -1
    starts = rng.integers(0, GENOME_LEN - INSERT, n)[:, None]
    span = np.arange(READ_LEN)
    g = src.clip(0)[:, None]
    mates = np.stack([gs[g, starts + span], comp[gs[g, starts + INSERT - READ_LEN + span][:, ::-1]]], axis=1)
    junk = src < 0
    mates[junk] = acgt[rng.integers(0, 4, (int(junk.sum()), 2, READ_LEN))]
    sub = rng.random(mates.shape) < SUB_RATE
    mates[sub] = acgt[rng.integers(0, 4, int(sub.sum()))]
    with_n = rng.choice(n, n // 100, replace=False)
    mates[with_n, 0, rng.integers(0, READ_LEN, with_n.size)] = ord("N")
    dup = rng.choice(np.arange(1, n), n // 100, replace=False)
    mates[dup], src[dup] = mates[dup - 1], src[dup - 1]
    lower = np.zeros(n, dtype=bool)
    lower[rng.choice(n, 20, replace=False)] = True
    mates[lower, 1, 40:60] += 32
    len1 = np.full(n, READ_LEN)
    len1[rng.choice(n, n // 200, replace=False)] = K - 11
    order = rng.permutation(n)
    return mates[order], src[order], len1[order], lower[order]


def write_pairs(prefix: str, mates, len1, sel) -> list[str]:
    """The selected pairs as prefix_R1/_R2.fastq.gz (ids pair<j>)."""
    paths = [f"{prefix}_R1.fastq.gz", f"{prefix}_R2.fastq.gz"]
    qual = "I" * READ_LEN
    for m, path in enumerate(paths):
        rows = mates[sel, m].tobytes().decode()
        lens = len1[sel] if m == 0 else [READ_LEN] * len(sel)
        with gzip.open(path, "wt", compresslevel=1) as f:
            f.write("".join(
                f"@pair{j}\n{rows[i * READ_LEN:i * READ_LEN + ln]}\n+\n{qual[:ln]}\n"
                for i, (j, ln) in enumerate(zip(sel, lens))
            ))
    return paths


def read_id_bytes(bxi: str, files: list[str], prefix: str, device: str | None = None,
                  env: dict | None = None):
    """CLI read_id (on DEVICE unless ``device`` is given); returns
    (_reads.txt bytes, _counts.txt bytes, seconds)."""
    device = device or DEVICE
    for key, value in (env or {}).items():
        os.environ[key] = value
    try:
        t0 = time.time()
        with contextlib.redirect_stderr(io.StringIO()):
            cli(["read_id", "-b", bxi, "-q", *files, "-n", prefix, "--device", device])
        dt = time.time() - t0
    finally:
        for key in env or {}:
            os.environ.pop(key)
    with open(prefix + "_reads.txt", "rb") as f, open(prefix + "_counts.txt", "rb") as g:
        return f.read(), g.read(), dt


@contextlib.contextmanager
def read_id_split():
    """Where read_id's wall time goes: seconds inside classify_batch, in
    the host preparation of reads (native 2-bit packing, rank emulation,
    k-mer sets), in the engine's read classifier calls (dispatch and the
    fetch that waits for the card), and what is left of classify_batch
    (the decision math). Observers wrap the functions for the run."""
    from colorid_tpu_torch.engine import QueryEngine
    from colorid_tpu_torch.pipelines import read_id as rid

    acc = {"classify": 0.0, "prepare": 0.0, "device": 0.0}
    depth = dict.fromkeys(acc, 0)  # only the outermost call of a kind counts
    saved = []

    def timed(owner, name, key, returns_fetch=False):
        fn = getattr(owner, name)

        def wrapped(*a, **kw):
            if depth[key]:
                return fn(*a, **kw)
            depth[key] += 1
            t0 = time.time()
            try:
                out = fn(*a, **kw)
            finally:
                depth[key] -= 1
                acc[key] += time.time() - t0
            if returns_fetch:
                def fetch(out=out):
                    t1 = time.time()
                    try:
                        return out()
                    finally:
                        acc[key] += time.time() - t1
                return fetch
            return out

        saved.append((owner, name, fn))
        setattr(owner, name, wrapped)

    timed(rid, "classify_batch", "classify")
    for name in ("_prepare_reads", "_prepare_reads_orderfree", "_prepare_native", "kmer_set"):
        timed(rid, name, "prepare")
    for name in ("readid_counts_orderfree", "readid_counts_packed", "readid_counts_arrays",
                 "readid_counts", "readid_firsthit"):
        timed(QueryEngine, name, "device")
    for name in ("readid_counts_reads_async", "readid_firsthit_reads_async"):
        timed(QueryEngine, name, "device", returns_fetch=True)
    try:
        yield acc
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def _check_calls(reads_txt: bytes, src, len1, what: str) -> float:
    """Share of the source pairs (not junk, first mate >= k) called accept
    for their own genome; raises if a junk pair is accepted for a genome."""
    rows = [l.split("\t") for l in reads_txt.decode().splitlines()]
    if len(rows) != len(src):
        raise AssertionError(f"{what}: {len(rows)} rows for {len(src)} pairs")
    ok = n_src = 0
    for (_rid, call, _c, _m, status, _n), s, ln in zip(rows, src, len1):
        if s < 0:
            if status == "accept" and call.startswith("genome"):
                raise AssertionError(f"{what}: a junk pair was accepted for {call}")
        elif ln >= K:
            n_src += 1
            ok += status == "accept" and call == f"genome{s:02d}"
    return ok / n_src


def pack_fastq(fq: str):
    """The reads of a FASTQ as the reads path takes them: (sequences, their
    padded length L, (words uint32 [R, L/16], lens int32 [R], validity bits
    uint32 [R, L/32]))."""
    import numpy as np

    from colorid_tpu_torch.core.fastx import stream_fastq
    from colorid_tpu_torch.ops.extract import pack_reads_valid

    seqs = [s for _id, s in stream_fastq(fq, 15)]
    L = max(64, -(-max(len(s) for s in seqs) // 32) * 32)
    rb = np.zeros((len(seqs), L), dtype=np.uint8)
    for j, s in enumerate(seqs):
        rb[j, : len(s)] = s
    words, vbits = pack_reads_valid(rb)
    return seqs, L, (words, np.array([len(s) for s in seqs], dtype=np.int32), vbits)


def on_device(arrays) -> list:
    """Host arrays on DEVICE, uint32 as its int32 bit view."""
    import numpy as np
    import torch

    return [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(DEVICE)
            for a in arrays]


def search_reads_phase(name: str, bxi: str, dev, L: int, query, mates, card: str):
    """QueryEngine.search_reads on device-resident reads (dev: words, lens,
    validity bits) against search_keys on their host-counted k-mers (query:
    keys, qcounts, packed): k-mers/s (best of 2, one fetch each) and, on the
    card, the device breakdown of one call and of one order-free read_id
    dispatch of the first N_PROFILE pairs of mates. Returns the answer."""
    import numpy as np
    import torch

    from colorid_tpu_torch.bench import same_result
    from colorid_tpu_torch.engine import QueryEngine
    from colorid_tpu_torch.index.bigsi import BigsiIndex
    from colorid_tpu_torch.ops import stream_query as sq
    from colorid_tpu_torch.ops import query as qmod
    from colorid_tpu_torch.ops.extract import pack_reads_valid
    from colorid_tpu_torch.ops.query import query_readid_orderfree_reads

    keys, qcounts, packed = query
    eng = QueryEngine(BigsiIndex.load(bxi), device=DEVICE)
    want = eng.search_keys(keys, qcounts=qcounts, packed_all=packed, k=K)
    kernel = sq.classic_words if name == "classic" else sq.stream_probe
    before = kernel.launches
    rates = []
    for _ in range(2):
        sync()
        t0 = time.time()
        got, n_u = eng.search_reads(*dev, k=K, L=L, filter_t=1)
        rates.append(n_u / (time.time() - t0))
    launches = kernel.launches - before
    if n_u != keys.shape[0] or not same_result(got, want):
        raise AssertionError(f"{name}: search_reads != search_keys on host-counted k-mers")
    if DEVICE == "cuda" and launches < 2:
        raise AssertionError(f"{name}: search_reads did not launch {kernel.__name__}")
    R = dev[0].shape[0]
    log(f"[reads] {name}: search_reads on {R} device-resident reads ({R * (L - K + 1)} "
        f"windows) == search_keys on {n_u} host-counted k-mers; {max(rates):.0f} k-mers/s "
        f"(best of 2, one fetch each; {kernel.__name__} launches {launches}) on {card}")
    if DEVICE == "cuda":
        profile_dispatch(
            lambda: eng.search_reads(*dev, k=K, L=L, filter_t=1)[1],
            f"search_reads {name}", card, label="search_reads",
        )
        # one order-free dispatch of N_PROFILE pairs, inputs on the card
        pw, pv = pack_reads_valid(mates[:N_PROFILE].reshape(-1, READ_LEN))
        pl = torch.full((2 * N_PROFILE,), READ_LEN, dtype=torch.int32, device=DEVICE)
        pw, pv = (torch.from_numpy(a.view(np.int32)).to(DEVICE) for a in (pw, pv))
        geo = eng._reads_geometry(K, 160)
        log(f"[profile] readid {name}: {N_PROFILE} pairs, "
            f"{2 * N_PROFILE * (160 - K + 1)} windows")
        profile_dispatch(
            lambda: query_readid_orderfree_reads(
                eng.blocks2, pw, pl, pv, num_reads=N_PROFILE, nm=2, d=1, **geo),
            f"readid {name}", card, label="order-free",
            forbid_like=READID_FORBID if hasattr(qmod, "readid_orderfree") else (),
        )
    del eng
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return got, n_u


def reads_phase(tmp: str, inputs, classic_bxi: str, blocked_bxi: str, card: str) -> dict:
    """Returns what the fused, serve and sharded reads phases reuse: the
    reads on the card (words, lens, validity bits) and their padded length
    L, the reads as host byte arrays, the read pairs with their first
    mates' lengths, the pair files with each pair's source genome, and the
    blocked index's read_id outputs with its pairs/s and classify_batch
    seconds."""
    import numpy as np

    from colorid_tpu_torch.pipelines.search import _count_query_kmers

    t0 = time.time()
    mates, src, len1, lower = synth_pairs(tmp)
    n = len(src)
    d = os.path.join(tmp, "pairs")
    os.makedirs(d)
    full = write_pairs(os.path.join(d, "all"), mates, len1, np.arange(n))
    check = write_pairs(os.path.join(d, "check"), mates, len1, np.arange(N_CHECK))
    routes = write_pairs(os.path.join(d, "routes"), mates, len1, np.arange(N_ROUTES))
    log(f"[reads] {n} pairs ({int((src < 0).sum())} junk, {int((len1 < K).sum())} "
        f"first mates below k, {int(lower.sum())} with lowercase) written in "
        f"{time.time() - t0:.1f}s")
    from colorid_tpu_torch.ops import query as q

    single = {}  # per index: CLI pairs/s and classify_batch seconds
    for name, bxi in (("classic", classic_bxi), ("blocked", blocked_bxi)):
        h0 = dict(q.readid_launches)
        with read_id_split() as split:
            reads, _counts, dt = read_id_bytes(bxi, full, os.path.join(d, f"{name}_all"))
        h_used = {m: q.readid_launches[m] - h0[m] for m in h0}
        single[name] = (n / dt, split["classify"])
        share = _check_calls(reads, src, len1, name)
        rest = split["classify"] - split["prepare"] - split["device"]
        log(f"[reads] {name} read_id: {n} pairs in {dt:.2f}s of CLI wall time (index "
            f"load included) = {n / dt:.0f} pairs/s; "
            f"{share:.4f} of the source pairs accepted for their genome, no junk pair "
            f"accepted; wall split: classify_batch {split['classify']:.2f}s (host "
            f"preparation {split['prepare']:.2f}s, engine calls with their fetches "
            f"{split['device']:.2f}s, decision math {rest:.2f}s), outside it (index "
            f"load, FASTQ decode wait, output files) {dt - split['classify']:.2f}s on {card}")
        if share < 0.95:
            raise AssertionError(f"{name}: only {share:.4f} of the source pairs accepted")
        got = read_id_bytes(bxi, check, os.path.join(d, f"{name}_card"))
        want = read_id_bytes(bxi, check, os.path.join(d, f"{name}_cpu"), device="cpu")
        if got[:2] != want[:2]:
            raise AssertionError(f"{name}: the card's read_id files differ from the CPU's")
        base = read_id_bytes(bxi, routes, os.path.join(d, f"{name}_routes"))
        route_s, h_env = [], {}
        for env in ({"COLORID_RID_SAFE": "0"}, {"COLORID_RID_READS": "0"}):
            h1 = dict(q.readid_launches)
            other = read_id_bytes(bxi, routes, os.path.join(d, f"{name}_env"), env=env)
            if other[:2] != base[:2]:
                raise AssertionError(f"{name}: {env} changed read_id's files")
            route_s.append(other[2])
            h_env[next(iter(env))] = {m: q.readid_launches[m] - h1[m] for m in h1}
        log(f"[reads] {name}: kernel H launches by mode in CLI read_id: {h_used} on {n} "
            f"pairs (default route), {h_env} on {N_ROUTES} pairs on {card}")
        replays = sum(c["replay"] for c in [h_used, *h_env.values()])
        if DEVICE == "cuda" and (not h_used["orderfree"] or not replays):
            raise AssertionError(f"{name}: CLI read_id did not launch kernel H in both modes "
                                 f"(the order-free pass, the replay): {h_used}, {h_env}")
        log(f"[reads] {name}: _reads.txt and _counts.txt byte-identical, card vs "
            f"--device cpu on {N_CHECK} pairs ({got[2]:.2f}s vs {want[2]:.2f}s) and "
            f"default vs COLORID_RID_SAFE=0 vs COLORID_RID_READS=0 on {N_ROUTES} pairs "
            f"({base[2]:.2f}s, {route_s[0]:.2f}s, {route_s[1]:.2f}s) on {card}")
    # batch_id on two samples (paired, single-end) against read_id on each
    se = os.path.join(d, "se_reads")
    se_bytes = read_id_bytes(classic_bxi, check[:1], se)
    man = os.path.join(d, "samples.txt")
    with open(man, "w") as f:
        f.write(f"pe\t{routes[0]}\t{routes[1]}\nse\t{check[0]}\n")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            cli(["batch_id", "-b", classic_bxi, "-q", man, "-T", "tag", "--device", DEVICE])
    finally:
        os.chdir(cwd)
    for sample, want in (("pe", os.path.join(d, "classic_routes")), ("se", se)):
        for suffix in ("_reads.txt", "_counts.txt"):
            with open(os.path.join(d, f"{sample}_tag{suffix}"), "rb") as f, \
                    open(want + suffix, "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"batch_id {sample}{suffix} != read_id's")
    # read_filter: the pairs whose call names genome01
    reads_txt = os.path.join(d, "classic_routes_reads.txt")
    with open(reads_txt) as f:
        hit = [l.split("\t")[0] for l in f if "genome01" in l.split("\t")[1]]
    with contextlib.redirect_stderr(io.StringIO()):
        cli(["read_filter", "-c", reads_txt, "-f", *routes, "-t", "genome01",
             "-p", os.path.join(d, "filtered")])
    for m in (1, 2):
        with gzip.open(os.path.join(d, f"filtered_genome01_R{m}.fq.gz"), "rt") as f:
            ids = f.read().splitlines()[::4]
        if [i.split(" ")[0] for i in ids] != hit:
            raise AssertionError(f"read_filter R{m} records != the _reads.txt rows")
    log(f"[reads] batch_id (2 samples) equals read_id on each; read_filter wrote the "
        f"{len(hit)} pairs that _reads.txt calls genome01, in order, on {card}")

    # device k-mer counting: CLI search -f 1, and search_reads vs search_keys
    fq = inputs[1]
    with contextlib.redirect_stderr(io.StringIO()):
        query = _count_query_kmers(fq, None, K, 15, 1, False)
    seqs, L, packed_reads = pack_fastq(fq)
    dev = on_device(packed_reads)
    for name, bxi in (("classic", classic_bxi), ("blocked", blocked_bxi)):
        secs, tsvs = [], []
        for flag in ("1", "0"):
            os.environ["COLORID_SEARCH_READS"] = flag
            try:
                t0 = time.time()
                tsvs.append(cli(["search", "-b", bxi, "-q", fq, "-f", "1", "--device", DEVICE]))
                secs.append(time.time() - t0)
            finally:
                os.environ.pop("COLORID_SEARCH_READS")
        if tsvs[0] != tsvs[1] or not tsvs[0]:
            raise AssertionError(f"{name}: search -f 1 TSV differs with device counting")
        log(f"[reads] {name}: CLI search -f 1 TSV byte-identical, device counting "
            f"{secs[0]:.2f}s vs host counting {secs[1]:.2f}s on {card}")
        search_reads_phase(name, bxi, dev, L, query, mates, card)
    return {"dev": dev, "L": L, "seqs": seqs, "mates": mates, "len1": len1,
            "pairs": full, "src": src, "blocked_all": os.path.join(d, "blocked_all"),
            "single": single["blocked"], "check": check, "dir": d}


# -- phase 4b-readid: kernel H, the read classifier's dispatches -----------------

H_KERNELS = ("readid_orderfree", "readid_init", "readid_absent", "readid_count")
# library kernels that kernel H takes off the read classifier's dispatches: the
# per-read sort, the row gather and the per-read reductions and scatters
READID_FORBID = ("RadixSort", "gather", "reduce_kernel", "scatter", "index_elementwise",
                 "indexFunc")
READID_GEO = ("num_colors", "wpad", "k", "num_hash", "bloom_size", "rpb", "bv")


def _readid_starts(rows, rpb: int, wpad: int):
    """The word starts of rows [N, H] as kernel H reads them: classic r *
    wpad; blocked the block of hash 0's row, lanes (r % rpb) * wpad."""
    import torch

    r = rows.to(torch.int64)
    if not rpb:
        return (r * wpad).reshape(-1)
    return ((r[:, :1] // rpb) * 128 + (r % rpb) * wpad).reshape(-1)


def _orderfree_bound(keys, geo: dict, instr) -> tuple:
    """(bound_ms, bound_by, how, distinct k-mers) of kernel H's order-free
    mode on keys [R, WR]: each key read once, the sectors of the rows of
    every distinct valid k-mer, the output; XXH3's SASS instructions a
    distinct k-mer of a read (kernel A's loop body)."""
    import torch

    from colorid_tpu_torch.ops.extract import SENT_KEY
    from colorid_tpu_torch.ops.hash_torch import device_rows

    R, WR = keys.shape
    s = torch.sort(keys, dim=1).values
    uniq = s != SENT_KEY
    uniq[:, 1:] &= s[:, 1:] != s[:, :-1]
    n_distinct = int(uniq.sum())
    rows = device_rows(torch.unique(s[uniq]), k=geo["k"], num_hash=geo["num_hash"],
                       bloom_size=geo["bloom_size"], rpb=geo["rpb"], version=geo["bv"])
    n_bytes, _n = readid_bytes(R * WR, 8, _readid_starts(rows, geo["rpb"], geo["wpad"]),
                               geo["wpad"], R, geo["num_colors"] + 3)
    return _bound(n_bytes, n_distinct, instr) + (n_distinct,)


def _exact_bound(rows, pos, geo: dict) -> float:
    """Kernel H's replay: each k-mer's rows, read and position read once,
    the sectors of the rows of every k-mer that is not padding, the
    output (bytes; no XXH3 here)."""
    from colorid_tpu_torch.ops.query import BIG

    live = pos < BIG
    n_bytes, _n = readid_bytes(rows.shape[0], rows.shape[1] * rows.element_size() + 8,
                               _readid_starts(rows[live], geo["rpb"], geo["wpad"]),
                               geo["wpad"], geo["num_reads"], geo["num_colors"] + 1)
    return n_bytes / HBM_BYTES_PER_S * 1e3


def readid_registers(build_log: str) -> list[str]:
    """Kernel H's kernels from nvcc's -Xptxas -v report of csrc/readid.cu:
    registers, shared memory and spills of each, the order-free mode's
    instances at the read classifier's dispatch (classic and v4, H 4) on
    their own, the rest as ranges."""
    both = ptxas_summary([build_log])
    mine = ptxas_summary([build_log], keep=("readid_orderfree_kernel",))
    return ([e for e in mine if e.startswith(("readid_orderfree_kernel<2,4> ",
                                              "readid_orderfree_kernel<7,4> "))]
            + [e for e in both if e.startswith("readid_")])


def _readid_edge_mates(mates, L: int, nm: int, n_reads: int, seed: int):
    """ASCII mates [n_reads * nm, L] and lengths for the order-free edge
    cases: from the seeded pairs where they are long enough (random bases
    past them), read 0 with no window, read 1 mates below k, read 2 all N,
    read 3 a homopolymer, read 4 mates alike."""
    import numpy as np

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = acgt[rng.integers(0, 4, (n_reads * nm, L))]
    flat = mates[:n_reads * nm // 2].reshape(-1, READ_LEN)
    out[:flat.shape[0], :min(L, READ_LEN)] = flat[:, :min(L, READ_LEN)]
    lens = np.full(n_reads * nm, L, dtype=np.int32)
    lens[:nm], lens[nm:2 * nm] = 0, K - 1
    out[2 * nm:3 * nm], out[3 * nm:4 * nm] = ord("N"), ord("A")
    out[4 * nm + 1] = out[4 * nm]
    return out, lens


def _readid_keys(seqs, lens, L: int, nm: int):
    """Kernel B's window keys [R, nm * (L - K + 1)] of ASCII mates, on the
    card, as query_readid_orderfree_reads hands them to kernel H."""
    import numpy as np
    import torch

    from colorid_tpu_torch.ops.extract import pack_reads_valid, window_keys

    w, vb = pack_reads_valid(seqs)
    w, vb = (torch.from_numpy(a.view(np.int32)).to(DEVICE) for a in (w, vb))
    keys = window_keys(w, torch.from_numpy(lens).to(DEVICE), vb, k=K, L=L, d=1)
    return keys.reshape(-1, nm * (L - K + 1))


def _capture_replay(bxi: str, files: list, prefix: str) -> dict:
    """The arguments of the first replay and first-hit dispatch of CLI
    read_id on ``files`` with COLORID_RID_SAFE=0 (every read replayed):
    {"replay" | "firsthit": (args, kwargs)}, tensors cloned."""
    from colorid_tpu_torch.ops import query as q

    seen: dict = {}
    real = {"replay": q.query_readid_reads_batch, "firsthit": q.query_readid_firsthit_reads}

    def observer(mode):
        def observed(*args, **kw):
            seen.setdefault(mode, (tuple(a.clone() for a in args), dict(kw)))
            return real[mode](*args, **kw)
        return observed

    q.query_readid_reads_batch = observer("replay")
    q.query_readid_firsthit_reads = observer("firsthit")
    try:
        read_id_bytes(bxi, files, prefix, env={"COLORID_RID_SAFE": "0"})
    finally:
        q.query_readid_reads_batch = real["replay"]
        q.query_readid_firsthit_reads = real["firsthit"]
    if "replay" not in seen:
        raise AssertionError("[kernel] readid: CLI read_id made no replay dispatch")
    return seen


def readid_kernel_phase(classic_bxi: str, blocked_bxi: str, reads: dict, card: str) -> dict:
    """Kernel H (csrc/readid.cu) against its twins, bitwise, on both
    indexes: the order-free mode on the [reads] dispatch's own keys (the
    first N_PROFILE pairs, as `[profile] readid` runs them), those keys
    shuffled within each read, and edge reads (no window, mates below k,
    all N, a homopolymer, mates alike; mates of 4,096 bp, two a read (the
    widest the route admits) and three (the hash set in device memory));
    the replay and first-hit modes on the rows, reads and positions of CLI
    read_id's first replay dispatch (COLORID_RID_SAFE=0 on the N_CHECK
    pairs), at B 0, 3 and the CLI's, shuffled, with padding k-mers on read
    0 mid-batch and as int64 rows. Each mode's time (CUDA events, 20 calls),
    its twin's (3 calls), its bound (readid_bytes; the order-free mode also
    XXH3's instructions), and a [profile] line of one replay dispatch and
    one first-hit dispatch (query_readid_reads_batch and _firsthit_reads on
    the captured inputs), which must show no sort, gather, reduction or
    scatter kernel. Launches made here are taken off H's count again."""
    import numpy as np
    import torch

    from colorid_tpu_torch.engine import QueryEngine
    from colorid_tpu_torch.index.bigsi import BigsiIndex
    from colorid_tpu_torch.ops import kernels, query as q

    t0 = time.time()
    counts0 = dict(q.readid_launches)
    mates = reads["mates"]
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    if DEVICE == "cuda":
        regs = readid_registers(kernels.build_log.get("readid.cu", ""))
        log(f"[kernel] readid ptxas: {' | '.join(regs) or 'not built in this process'} "
            f"on {card}")
    errs, rows = {}, {}
    for name, bxi in (("classic", classic_bxi), ("blocked", blocked_bxi)):
        eng = QueryEngine(BigsiIndex.load(bxi), device=DEVICE)
        b2, geo = eng.blocks2, eng._reads_geometry(K, 160)
        of = {n: geo[n] for n in READID_GEO}
        keys = _readid_keys(mates[:N_PROFILE].reshape(-1, READ_LEN),
                            np.full(2 * N_PROFILE, READ_LEN, dtype=np.int32), 160, 2)
        perm = torch.argsort(torch.rand(keys.shape, generator=g, device=DEVICE), dim=1)
        cases = [("dispatch", keys), ("dispatch shuffled", keys.gather(1, perm).contiguous())]
        for L, nm, n in ((160, 2, 64), (4096, 2, 64), (4096, 3, 300)):
            seqs, lens = _readid_edge_mates(mates, L, nm, n, SEED + L + nm)
            cases.append((f"edge L {L} nm {nm}", _readid_keys(seqs, lens, L, nm)))
        for case, kk in cases:
            got = q.readid_orderfree(kk, b2, **of)
            errs[f"{name} orderfree {case}"] = max_abs_diff(got, q._orderfree_plain(kk, b2, **of))
        if max(errs.values()):
            raise AssertionError(f"[kernel] readid {name}: kernel != twin: {errs}")
        instance = "placement_kernelILi2ELi4ELi0E" if not geo["rpb"] else "placement_kernelILi7ELi4ELi0E"
        bound_ms, bound_by, how, n_distinct = _orderfree_bound(
            keys, of, sass_loop_instructions("placement.cu", instance))
        if DEVICE == "cuda":
            ms = cuda_ms(lambda: q.readid_orderfree(keys, b2, **of), 20)
            plain = cuda_ms(lambda: q._orderfree_plain(keys, b2, **of), 3)
            stages = _launch_ms(lambda: q.readid_orderfree(keys, b2, **of))
        else:
            ms = plain = 0.0
            stages = []
        rows[f"{name} orderfree"] = dict(ms=ms, plain_ms=plain, bound_ms=bound_ms,
                                         bound_by=bound_by)
        log(f"[kernel] readid {name} order-free ({N_PROFILE} pairs' own keys: "
            f"{keys.numel()} windows, {n_distinct} distinct k-mers of a read; and "
            f"{len(cases) - 1} more cases: {', '.join(c for c, _ in cases[1:])}): "
            f"bitwise_equal=True; ms={ms:.4f} plain_ms={plain:.4f} library_ms=null (no "
            f"PyTorch call dedups, gathers and counts per read) bound_ms={bound_ms:.4f} "
            f"bound_by={bound_by} ({how})"
            f"{'; launches ' + ', '.join(f'{n} {t:.4f}' for n, t in stages) if stages else ''}"
            f" on {card}")
        del cases, keys
        # the replay and first hit on CLI read_id's own replay dispatch
        seen = _capture_replay(bxi, reads["check"], os.path.join(reads["dir"], f"h_{name}"))
        args, kw = seen["replay"]
        geo = {n: kw[n] for n in ("num_reads", "num_colors", "wpad", "rpb")}
        r, s, p = q._reads_rows_seg_pos(*args[1:], k=kw["k"], L=kw["L"], num_hash=kw["num_hash"],
                                        bloom_size=kw["bloom_size"], rpb=kw["rpb"], bv=kw["bv"])
        perm = torch.randperm(s.numel(), generator=g, device=DEVICE)
        pad = p.clone()
        mid = torch.arange(p.numel() // 3, p.numel() // 3 + 1000, device=DEVICE)
        pad[mid] = q.PAD_POS
        spad = s.clone()
        spad[mid] = 0
        ecases = [("dispatch", (r, s, p)), ("shuffled", (r[perm].contiguous(), s[perm], p[perm])),
                  ("padding on read 0", (r, spad, pad)), ("int64 rows", (r.to(torch.int64), s, p))]
        for B in sorted({0, 3, kw["start_sample"]}):
            for case, (rr, ss, pp) in ecases if B == kw["start_sample"] else ecases[:1]:
                for firsthit, twin in ((False, q._readid_core_plain),
                                       (True, q._readid_firsthit_core_plain)):
                    ekw = dict(geo, start_sample=B)
                    got = q.readid_exact(b2, rr, ss, pp, **ekw, firsthit=firsthit)
                    errs[f"{name} {'firsthit' if firsthit else 'replay'} B {B} {case}"] = \
                        max_abs_diff(got, twin(b2, rr, ss, pp, **ekw))
        if max(errs.values()):
            raise AssertionError(f"[kernel] readid {name}: kernel != twin: {errs}")
        ekw = dict(geo, start_sample=kw["start_sample"])
        bound = _exact_bound(r, p, geo)
        for mode, firsthit, twin in (("replay", False, q._readid_core_plain),
                                     ("firsthit", True, q._readid_firsthit_core_plain)):
            if DEVICE == "cuda":
                ms = cuda_ms(lambda: q.readid_exact(b2, r, s, p, **ekw, firsthit=firsthit), 20)
                plain = cuda_ms(lambda: twin(b2, r, s, p, **ekw), 3)
                stages = _launch_ms(lambda: q.readid_exact(b2, r, s, p, **ekw, firsthit=firsthit))
            else:
                ms = plain = 0.0
                stages = []
            rows[f"{name} {mode}"] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by="bytes")
            log(f"[kernel] readid {name} {mode} (CLI read_id's first replay dispatch: "
                f"N={r.shape[0]} k-mers, {int((p < q.BIG).sum())} not padding, "
                f"{geo['num_reads']} reads, H {r.shape[1]}, B {kw['start_sample']}; and B 0 / 3, "
                f"shuffled, padding on read 0, int64 rows): bitwise_equal=True; ms={ms:.4f} "
                f"plain_ms={plain:.4f} library_ms=null bound_ms={bound:.4f} bound_by=bytes"
                f"{'; launches ' + ', '.join(f'{n} {t:.4f}' for n, t in stages) if stages else ''}"
                f" on {card}")
        if DEVICE == "cuda":
            for mode, fn in (("replay", q.query_readid_reads_batch),
                             ("firsthit", q.query_readid_firsthit_reads)):
                fargs, fkw = seen.get(mode, seen["replay"])
                whose = "its own" if mode in seen else "the replay dispatch's"
                log(f"[profile] readid {mode} {name}: {fargs[1].shape[0]} mates of "
                    f"{fkw['num_reads']} reads, B {fkw['start_sample']} ({whose} inputs)")
                profile_dispatch(lambda: fn(*fargs, **fkw), f"readid {mode} {name}", card,
                                 label=mode, forbid_like=READID_FORBID)
        del eng, seen, args, r, s, p, ecases
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    q.readid_launches.update(counts0)
    secs = time.time() - t0
    log(f"[kernel] readid phase took {secs:.1f}s on {card}")
    first = rows["classic orderfree"]
    return {
        "name": "readid",
        "route": "cuda",
        "source": "colorid_tpu_torch/csrc/readid.cu",
        "replaces": "colorid_tpu/ops/query.py:937",
        "launches": None,
        "max_abs_err": max(errs.values()),
        "ms": first["ms"],
        "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"],
        "library_ms": None,
        "by_call": rows,
        "phase_s": secs,
    }


# -- phase 4c: the fused reads path and the HTTP server -----------------------

N_SERVE_READS, N_SERVE_PAIRS, N_CONCURRENT = 20_000, 2_000, 64


def same_answers_reads(a, b) -> bool:
    """Two search_reads answers agree in counts, all_valid, and_all,
    freq_stats() and n_unique, the overflow list as a multiset (its order
    follows each route's own probe stream)."""
    import numpy as np

    (ra, na), (rb, nb) = a, b
    return (
        na == nb
        and np.array_equal(ra.counts, rb.counts)
        and ra.all_valid == rb.all_valid
        and np.array_equal(ra.and_all, rb.and_all)
        and ra.freq_stats() == rb.freq_stats()
        and sorted(zip(ra.over_colors.tolist(), ra.over_freqs.tolist()))
        == sorted(zip(rb.over_colors.tolist(), rb.over_freqs.tolist()))
    )


def fused_phase(blocked_bxi: str, reads: dict, card: str) -> int:
    """search_reads on the device-resident reads through the chunked fused
    route (the default above COLORID_FUSED_MAX_WINDOWS), the single fused
    dispatch (the guard raised above the window count) and the counted
    route (extract_count, then the probe stream): the same answers, each
    fused dispatch with n_drop 0 and stream_probe launched; k-mers/s and a
    device breakdown of each; search_reads_fused_async on two halves,
    fetched in one stacked copy, equal to search_reads on each half.
    Returns the probe kernel's launches on the fused routes."""
    import numpy as np
    import torch

    from colorid_tpu_torch.bench import same_result
    from colorid_tpu_torch.engine import QueryEngine
    from colorid_tpu_torch.index.bigsi import BigsiIndex
    from colorid_tpu_torch.ops import fused_reads as fr
    from colorid_tpu_torch.ops import stream_query as sq

    dev, L = reads["dev"], reads["L"]
    R = dev[0].shape[0]
    n_windows = R * (L - K + 1)
    eng = QueryEngine(BigsiIndex.load(blocked_bxi), device=DEVICE)
    dispatches = []  # (fused function, its n_drop) per call
    saved = fr.fused_search_reads, fr.fused_merge_query

    def observer(fn):
        def observed(*a, **kw):
            out = fn(*a, **kw)
            dispatches.append((fn.__name__, out[4]))
            return out
        return observed

    def default():
        return eng.search_reads(*dev, k=K, L=L, filter_t=1)

    def counted():
        return eng._search_reads_counted(*dev, k=K, L=L, filter_t=1, d=1)

    routes, fused_launches = {}, 0
    te = _f_modules()[0]
    has_f = hasattr(te, "run_counts")  # an older checkout under --compare has no kernel F
    has_g = hasattr(te, "value_sort")  # nor kernel G
    fr.fused_search_reads, fr.fused_merge_query = map(observer, saved)
    try:
        for name, fn, max_w, want in (
            ("chunked", default, None, "fused_merge_query"),
            ("single", default, str(n_windows), "fused_search_reads"),
            ("counted", counted, None, None),
        ):
            before = os.environ.get("COLORID_FUSED_MAX_WINDOWS")
            if max_w:
                os.environ["COLORID_FUSED_MAX_WINDOWS"] = max_w
            try:
                dispatches.clear()
                sq.stream_probe.launches = 0
                f_before = te.run_counts.launches if has_f else 0
                secs = []
                for _ in range(3):
                    sync()
                    t0 = time.time()
                    out = fn()
                    secs.append(time.time() - t0)
                launches = sq.stream_probe.launches
                f_launches = te.run_counts.launches - f_before if has_f else None
                fused_launches += launches if want else 0
                seen = [(f, int(nd)) for f, nd in dispatches]
                if seen != ([(want, 0)] * 3 if want else []):
                    raise AssertionError(f"[fused] {name}: dispatches {seen}")
                if DEVICE == "cuda" and launches < 3:
                    raise AssertionError(f"[fused] {name}: stream_probe launched {launches} times")
                if DEVICE == "cuda" and has_f and f_launches < 3:
                    raise AssertionError(f"[fused] {name}: kernel F launched {f_launches} times")
                log(f"[fused] {name} route: {out[1]} k-mers from {n_windows} windows of "
                    f"{R} device-resident reads, {out[1] / min(secs):.0f} k-mers/s (best of "
                    f"3, one fetch each: {', '.join(f'{t:.4f}' for t in secs)} s); "
                    f"stream_probe launches {launches} in 3 calls; run_counts (kernel F) "
                    f"launches {'none: not in this checkout' if f_launches is None else f_launches} "
                    f"in 3 calls; "
                    f"dispatches {seen[:1]} x{len(seen)} on {card}")
                if DEVICE == "cuda":
                    # with kernel G in the checkout no torch.sort runs on the route
                    profile_dispatch(lambda: fn()[1], f"fused {name}", card,
                                     label=f"{name} search_reads",
                                     forbid_like=("RadixSort",) if has_g else ())
            finally:
                if max_w and before is None:
                    os.environ.pop("COLORID_FUSED_MAX_WINDOWS")
                elif max_w:
                    os.environ["COLORID_FUSED_MAX_WINDOWS"] = before
            routes[name] = out
    finally:
        fr.fused_search_reads, fr.fused_merge_query = saved
    if out[1] == 0 or not all(same_answers_reads(routes["chunked"], r) for r in routes.values()):
        raise AssertionError("[fused] the three routes' answers differ")
    log(f"[fused] chunked == single == counted: counts, all_valid, and_all, freq_stats, "
        f"{out[1]} k-mers, {len(out[0].over_colors)} overflow entries (as a multiset) "
        f"on {card}")

    # the async half: two dispatches queued, one stacked fetch
    h = R // 2
    halves = [tuple(t[:h] for t in dev), tuple(t[h:] for t in dev)]
    sq.stream_probe.launches = 0
    sync()
    t0 = time.time()
    outs = [eng.search_reads_fused_async(*hv, k=K, L=L, filter_t=1) for hv in halves]
    host = torch.stack([o[0] for o in outs]).cpu().numpy()
    got = [eng.search_reads_fused_finish(row, *o[1:]) for row, o in zip(host, outs)]
    dt = time.time() - t0
    async_launches = sq.stream_probe.launches
    for g, hv in zip(got, halves):
        want = eng.search_reads(*hv, k=K, L=L, filter_t=1)
        if g is None or g[1] != want[1] or not same_result(g[0], want[0]) or not (
            np.array_equal(g[0].over_colors, want[0].over_colors)
            and np.array_equal(g[0].over_freqs, want[0].over_freqs)
        ):
            raise AssertionError("[fused] search_reads_fused_async != search_reads on a half")
    if DEVICE == "cuda" and async_launches != 2:
        raise AssertionError(f"[fused] async: stream_probe launched {async_launches} times")
    log(f"[fused] search_reads_fused_async on 2 x {h} reads, one stacked fetch, equals "
        f"search_reads on each half; {(got[0][1] + got[1][1]) / dt:.0f} k-mers/s; "
        f"stream_probe launches {async_launches} on {card}")
    del eng
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return fused_launches + async_launches


# kernel F's kernels in this checkout and, for --compare's turns of the parent,
# PR 19's summary, scan and write kernels of compact and partition modes
F_KERNELS = ("run_counts_select", "run_counts_compact", "run_counts_zero", "run_counts_live",
             "run_counts_partition", "run_counts_summary", "run_counts_scan",
             "run_counts_write")
F_CALLS = ("pairs", "counts", "partition", "totals", "compact")  # pairs first: the row's ms
F_ROUTE_OF = {"pairs": "single", "counts": "chunked", "partition": "chunked",
              "totals": "chunked", "compact": "counted"}


def _f_call(w, kw) -> str:
    """Which of the routes' calls of kernel F (F_CALLS) these arguments
    make: in select mode, the merge's totals carry weights, the single
    route's pairs a filter and chunk A's counts neither."""
    if kw["mode"] != "select":
        return kw["mode"]
    return "totals" if w is not None else "pairs" if kw.get("filter_t") else "counts"


def _f_modules():
    """The modules through whose names the reads routes call kernel F."""
    from colorid_tpu_torch.ops import extract as te
    from colorid_tpu_torch.ops import fused_reads as fr

    return te, fr


def run_counts_kernel_phase(blocked_bxi: str, reads: dict, card: str) -> dict:
    """Kernel F (csrc/run_counts.cu) against its twin run_counts_plain,
    bitwise, in each of the routes' calls (F_CALLS) on the [fused] cell's
    own sorted keys: the arguments of its first such call in search_reads
    on the 400,000 device-resident reads through the single fused dispatch
    (pairs: select mode with the filter), the chunked route (counts: select
    with no filter; partition; totals: select with weights) and the counted
    route (compact); then on edge cases of them (a SENT run of 1,500,000
    slots, P not a multiple of the tile; compact with every slot kept and
    with the first 90 % of the keys kept nowhere; partition at caps from 0
    to P, and with no live slot in the first 90 % of the chunk). Each
    call's time (CUDA events
    over 20 calls back to back), its twin's (CUDA events, 3 calls), its
    byte bound (run_counts_bytes) and the phase's seconds; F's device time
    by kernel comes from counts_bench.py (this late in the script
    torch.profiler has lost F's kernels). Launches made here are taken off
    F's count again; the caller fills in the row's launches on the main
    path."""
    import torch

    from colorid_tpu_torch.engine import QueryEngine
    from colorid_tpu_torch.index.bigsi import BigsiIndex

    t0 = time.time()
    te, fr = _f_modules()
    real, count0 = te.run_counts, te.run_counts.launches
    modes0 = dict(real.launches_by_mode)
    seen: dict = {}

    def observed(s, w=None, **kw):
        seen.setdefault(_f_call(w, kw), (s.clone(), None if w is None else w.clone(), dict(kw)))
        return real(s, w, **kw)

    # the wrapper counts its launches on the module's name
    observed.launches, observed.launches_by_mode = count0, real.launches_by_mode

    dev, L = reads["dev"], reads["L"]
    n_windows = dev[0].shape[0] * (L - K + 1)
    eng = QueryEngine(BigsiIndex.load(blocked_bxi), device=DEVICE)
    te.run_counts = fr.run_counts = observed
    before = os.environ.get("COLORID_FUSED_MAX_WINDOWS")
    try:
        eng.search_reads(*dev, k=K, L=L, filter_t=1)  # chunked
        os.environ["COLORID_FUSED_MAX_WINDOWS"] = str(n_windows)
        try:
            eng.search_reads(*dev, k=K, L=L, filter_t=1)  # single
        finally:
            if before is None:
                os.environ.pop("COLORID_FUSED_MAX_WINDOWS", None)
            else:
                os.environ["COLORID_FUSED_MAX_WINDOWS"] = before
        eng._search_reads_counted(*dev, k=K, L=L, filter_t=1, d=1)
        sync()
    finally:
        te.run_counts = fr.run_counts = real
    del eng
    if sorted(seen) != sorted(F_CALLS):
        raise AssertionError(f"[kernel] run_counts: the routes made the calls {sorted(seen)}")
    rows, errs = {}, {}
    for call in F_CALLS:
        s, w, kw = seen[call]
        kw = dict(kw)
        mode = kw.pop("mode")
        got = real(s, w, mode=mode, **kw)
        want = te.run_counts_plain(s, w, mode=mode, **kw)
        sync()
        errs[call] = _outputs_err(got, want)
        if errs[call]:
            raise AssertionError(f"[kernel] run_counts {call}: kernel != twin, max_abs_err "
                                 f"{errs[call]}")
        P = s.numel()
        bound = run_counts_bytes(P, mode=mode, weights=w is not None,
                                 rounds=kw.get("rounds", 0),
                                 cap=kw.get("cap", 0)) / HBM_BYTES_PER_S * 1e3
        if DEVICE == "cuda":
            ms = cuda_ms(lambda: real(s, w, mode=mode, **kw), 20)
            plain = cuda_ms(lambda: te.run_counts_plain(s, w, mode=mode, **kw), 3)
        else:
            ms = plain = 0.0
        rows[call] = dict(P=P, ms=ms, plain_ms=plain, bound_ms=bound, n=int(got[2]))
        log(f"[kernel] run_counts {call} ({F_ROUTE_OF[call]} route's own input: {mode} mode, "
            f"P={P}, {', '.join(f'{k}={v}' for k, v in kw.items()) or 'no filter'}, w "
            f"{'int32' if w is not None else 'none'}): bitwise_equal=True (keys, counts, "
            f"n={int(got[2])}); ms={ms:.4f} (a call, "
            f"{'one launch and a memset' if mode == 'select' else 'two launches and a memset'}"
            f": CUDA events over 20 calls back to back, device-bound: a call's host work is "
            f"shorter than its kernels) plain_ms={plain:.4f} library_ms=null bound_ms="
            f"{bound:.4f} bound_by=bytes ({ms and bound / ms:.2f} of the bound) on {card}")
        del got, want
    # edge cases on the card's inputs: the SENT run past 1,048,576 slots, P
    # not a multiple of the tile; compact with every slot kept (no zero
    # tail) and with the first 90 % of the keys distinct (runs of 1: thousands
    # of tiles that keep nothing at -f 1, a long look-back); partition at
    # caps from 0 to P, and with no live slot in the first 90 % of the chunk
    s, w, kw = seen["pairs"]
    s_sent = s.clone()
    s_sent[-1_500_000:] = te.SENT_KEY
    cut = (s.numel() // te.RUN_TILE - 1) * te.RUN_TILE + 8
    distinct = torch.unique(s[s != te.SENT_KEY])
    late = s.clone()
    m = late.numel() * 9 // 10
    late[:m] = late[m] - m + torch.arange(m, device=s.device)  # below late[m], distinct
    pc, pw, pkw = seen["partition"]
    n_live = int((pw != 0).sum())
    pw_late = pw.clone()
    pw_late[:pw.numel() * 9 // 10] = 0
    compact = dict(mode="compact", filter_t=1)
    edges = (("SENT run of 1,500,000 slots", "pairs", s_sent, None, kw),
             ("SENT run of 1,500,000 slots", "compact", s_sent, None, compact),
             (f"P={cut}, not a multiple of the tile", "pairs", s[:cut], None, kw),
             (f"P={cut}, not a multiple of the tile", "totals", s[:cut].contiguous(),
              torch.ones(cut, dtype=torch.int32, device=s.device),
              dict(mode="select", filter_t=2)),
             (f"every slot kept (P={distinct.numel()}, no zero tail)", "compact", distinct, None,
              dict(mode="compact", filter_t=0)),
             ("the first 90 % of the keys kept nowhere", "compact", late, None, compact),
             *((f"cap {cap} (n_live {n_live})", "partition", pc, pw, dict(mode="partition", cap=cap))
               for cap in (0, n_live // 3, n_live, pc.numel())),
             ("no live slot in the first 90 %", "partition", pc, pw_late,
              dict(mode="partition", cap=pkw["cap"])))
    for what, call, es, ew, ekw in edges:
        err = _outputs_err(real(es, ew, **ekw), te.run_counts_plain(es, ew, **ekw))
        sync()
        errs[f"{call} {what}"] = err
        log(f"[kernel] run_counts {call}, {what}: bitwise_equal={err == 0}")
        if err:
            raise AssertionError(f"[kernel] run_counts {call} on {what}: max_abs_err {err}")
    te.run_counts.launches = count0
    te.run_counts.launches_by_mode.update(modes0)
    secs = time.time() - t0
    log(f"[kernel] run_counts phase took {secs:.1f}s on {card}")
    del seen, s, w, s_sent, distinct, late, pc, pw, pw_late
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    first = rows["pairs"]
    return {
        "name": "run_counts",
        "route": "cuda",
        "source": "colorid_tpu_torch/csrc/run_counts.cu",
        "replaces": "colorid_tpu/ops/fused_reads.py:97",
        "launches": None,
        "max_abs_err": max(errs.values()),
        "ms": first["ms"],
        "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "by_mode": rows,
        "phase_s": secs,
    }


# kernel G's kernels; the sorts it takes the place of on the reads routes
G_KERNELS = ("vsort_upsweep", "vsort_bases", "vsort_chunk_scan", "vsort_pass", "vsort_runs",
             "vsort_merge", "vsort_tail")
G_CALLS = ("single", "chunk", "merge", "counted")  # single first: the row's ms


def value_sort_kernel_phase(blocked_bxi: str, reads: dict, card: str) -> dict:
    """Kernel G (csrc/value_sort.cu) against its twin value_sort_plain,
    bitwise, on the [fused] cell's own keys: the arguments of its first
    call in search_reads on the 400,000 device-resident reads through the
    single fused dispatch (52,002,816 keys), the chunked route (a chunk's
    keys; the merge's keys with the counts as payload) and the counted
    route (extract_count's windows). Each call's time (CUDA events over 20
    calls back to back), its twin's (3 calls), torch.sort(stable) (+ the
    payload's gather) as the library's, its byte bound (value_sort_bytes);
    the path the device took (the merge's rounds and the runs found, or
    the LSD passes and the SENT keys they skipped; fails unless the merge
    call, which comes with the runs hint, merged); the single and the merge
    call's launches apart (torch.profiler), and what the hint costs where
    it does not pay: the single call's keys with the hint (the LSD path
    after the runs read and the empty merge launches) beside without.
    Launches made here are taken off G's count again; the caller fills in
    the row's launches on the main path."""
    import torch

    from colorid_tpu_torch.engine import QueryEngine
    from colorid_tpu_torch.index.bigsi import BigsiIndex

    t0 = time.time()
    te, fr = _f_modules()
    real, count0, runs0 = te.value_sort, te.value_sort.launches, te.value_sort.runs_launches
    seen: dict = {}
    route = [""]

    def observed(key, payload=None, *, bits, runs=False):
        call = "merge" if payload is not None else route[0]
        seen.setdefault(call, (key.clone(), None if payload is None else payload.clone(), bits,
                               runs))
        return real(key, payload, bits=bits, runs=runs)

    observed.launches = count0  # the wrapper counts its launches on the module's name
    observed.runs_launches = runs0
    observed.keep_stats = False
    dev, L = reads["dev"], reads["L"]
    n_windows = dev[0].shape[0] * (L - K + 1)
    eng = QueryEngine(BigsiIndex.load(blocked_bxi), device=DEVICE)
    te.value_sort = fr.value_sort = observed
    before = os.environ.get("COLORID_FUSED_MAX_WINDOWS")
    try:
        route[0] = "chunk"
        eng.search_reads(*dev, k=K, L=L, filter_t=1)
        os.environ["COLORID_FUSED_MAX_WINDOWS"] = str(n_windows)
        route[0] = "single"
        try:
            eng.search_reads(*dev, k=K, L=L, filter_t=1)
        finally:
            if before is None:
                os.environ.pop("COLORID_FUSED_MAX_WINDOWS", None)
            else:
                os.environ["COLORID_FUSED_MAX_WINDOWS"] = before
        route[0] = "counted"
        eng._search_reads_counted(*dev, k=K, L=L, filter_t=1, d=1)
        sync()
    finally:
        te.value_sort = fr.value_sort = real
    del eng
    if sorted(seen) != sorted(G_CALLS):
        raise AssertionError(f"[kernel] value_sort: the routes made the calls {sorted(seen)}")
    rows, errs = {}, {}
    for call in G_CALLS:
        key, pay, bits, runs = seen[call]
        if (call == "merge") != runs:
            raise AssertionError(f"[kernel] value_sort {call}: the runs hint is {runs}")
        real.keep_stats = True  # a card call keeps its counts: the path it took
        try:
            got = real(key, pay, bits=bits, runs=runs)
            counted = te.value_sort_stats(real.last_stats) if key.is_cuda else None
        finally:
            real.keep_stats, real.last_stats = False, None
        n_sent = int((key == te.SENT_KEY).sum())
        want = te.value_sort_plain(key, pay, bits=bits)
        sync()
        errs[call] = _outputs_err(got if pay is not None else (got,),
                                  want if pay is not None else (want,))
        if runs:  # the merge path's own twin too
            merged = te.value_merge_plain(key, pay, bits=bits)
            errs[call] = max(errs[call], _outputs_err(got if pay is not None else (got,),
                                                      merged if pay is not None else (merged,)))
            del merged
        if errs[call]:
            raise AssertionError(f"[kernel] value_sort {call}: kernel != twin, max_abs_err "
                                 f"{errs[call]}")
        del got, want
        if counted is None:  # a CPU tensor takes the LSD twin: no path to read
            desc, tails, rounds = 0, [], 0
            path = "not read (the CPU twin)"
        else:
            desc, tails = counted["descents"], counted["tails"]
            rounds = te.value_sort_merge_rounds(desc + 1, bits) if runs else 0
            if rounds:
                path = (f"merge: {rounds} round{'s' * (rounds > 1)} over {desc + 1} runs found "
                        f"(at most {2 ** te.value_sort_merge_max_rounds(bits)} merge)")
            else:
                skip = [q for q, tail in enumerate(tails) if tail]
                rule = te.value_sort_sent_tails(key, bits)
                if tails[:len(rule)] != rule:
                    raise AssertionError(f"[kernel] value_sort {call}: SENT tails {tails} "
                                         f"against the rule's {rule}")
                path = (f"LSD passes {te.value_sort_passes(bits)}, {n_sent} SENT keys, left at "
                        f"the tail by passes {skip or 'none'}"
                        f"{f' ({desc} descents or more: no merge)' if runs else ''}")
            if call == "merge" and not rounds:
                raise AssertionError(f"[kernel] value_sort merge: the chunked route's merge "
                                     f"took the LSD path ({desc} descents)")
        P = key.numel()
        bound = value_sort_bytes(P, payload=pay is not None) / HBM_BYTES_PER_S * 1e3
        stages = []
        extra = ""
        if DEVICE == "cuda":
            ms = cuda_ms(lambda: real(key, pay, bits=bits, runs=runs), 20)
            plain = cuda_ms(lambda: te.value_sort_plain(key, pay, bits=bits), 3)

            def library():
                key_s, perm = torch.sort(key, stable=True)
                return key_s if pay is None else (key_s, pay[perm])

            lib = cuda_ms(library, 20)
            if call in ("single", "merge"):
                stages = _launch_ms(lambda: real(key, pay, bits=bits, runs=runs))
            if call == "merge":
                idle = [t for n, t in stages if n.startswith(("vsort_upsweep", "vsort_bases",
                                                              "vsort_chunk_scan", "vsort_pass",
                                                              "vsort_tail"))]
                extra = (f"; the LSD launches that exit on the device's choice x{len(idle)} "
                         f"{sum(idle):.4f} ms")
            if call == "single":
                hinted = cuda_ms(lambda: real(key, pay, bits=bits, runs=True), 20)
                idle = [t for n, t in _launch_ms(lambda: real(key, pay, bits=bits, runs=True))
                        if n.startswith(("vsort_runs", "vsort_merge"))]
                extra = (f"; with the runs hint (LSD taken) {hinted:.4f} ms: the runs read and "
                         f"the empty merge launches x{len(idle)} {sum(idle):.4f} ms")
        else:
            ms = plain = lib = 0.0
        rows[call] = dict(P=P, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                          path=None if counted is None else "merge" if rounds else "lsd",
                          runs=desc + 1 if runs and counted is not None else None,
                          rounds=rounds, sent=n_sent, sent_tails=tails)
        log(f"[kernel] value_sort {call} ({call if call != 'merge' else 'chunked'} route's own "
            f"keys: P={P}, bits={bits}, {'the runs hint, ' if runs else ''}"
            f"{'an int32 payload' if pay is not None else 'keys only'}, "
            f"{n_sent} SENT): path {path}; "
            f"bitwise_equal=True; ms={ms:.4f} (CUDA events over 20 calls back to back) "
            f"plain_ms={plain:.4f} library_ms={lib:.4f} (torch.sort(stable)"
            f"{' + the gather' if pay is not None else ''}) bound_ms={bound:.4f} "
            f"bound_by=bytes ({ms and bound / ms:.2f} of the bound)"
            f"{'; launches ' + ', '.join(f'{n} {t:.4f}' for n, t in stages) if stages else ''}"
            f"{extra} on {card}")
    te.value_sort.launches = count0
    te.value_sort.runs_launches = runs0
    secs = time.time() - t0
    log(f"[kernel] value_sort phase took {secs:.1f}s on {card}")
    del seen
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    first = rows["single"]
    return {
        "name": "value_sort",
        "route": "cuda",
        "source": "colorid_tpu_torch/csrc/value_sort.cu",
        "replaces": "colorid_tpu/ops/fused_reads.py:97",
        "launches": None,
        "max_abs_err": max(errs.values()),
        "ms": first["ms"],
        "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"],
        "bound_by": "bytes",
        "library_ms": first["library_ms"],
        "by_call": rows,
        "phase_s": secs,
    }


def _http(url: str, payload=None):
    """GET (payload None) or POST JSON; a reply other than 200 raises."""
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise AssertionError(f"{url}: HTTP {r.status}")
        return json.loads(r.read())


def serve_phase(classic_bxi: str, blocked_bxi: str, reads: dict, card: str):
    """The HTTP server (colorid_tpu_torch/serve.py) on the card, in a thread
    of this process, on each phase-3 index: /healthz and /info against the
    index; /search with N_SERVE_READS reads (filter 1, 0, -1, gene; p_shared
    0.01, so that the report has rows at this coverage) equal to
    the same body counted on the host (COLORID_SEARCH_READS=0), the probe
    kernel launched by every default-route body on the v4 index and the
    classic word kernel by the filter 0 body on the classic one; /classify
    with N_SERVE_PAIRS pairs in one request equal to classify_batch on a
    CPU engine; N_CONCURRENT concurrent 1-pair requests equal to a
    sequential run, in fewer classify_batch calls than requests. Any reply
    but 200 fails. Returns the launches (classic_word, stream_probe) of the
    default-route /search bodies."""
    import statistics
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from colorid_tpu_torch import serve
    from colorid_tpu_torch.core.dna import to_bytes
    from colorid_tpu_torch.engine import QueryEngine
    from colorid_tpu_torch.index.bigsi import BigsiIndex
    from colorid_tpu_torch.ops import stream_query as sq
    from colorid_tpu_torch.pipelines import read_id as rid

    seqs = [s.tobytes().decode() for s in reads["seqs"][:N_SERVE_READS]]
    mates, len1 = reads["mates"], reads["len1"]
    pairs = [
        {"id": f"pair{j}",
         "seqs": [mates[j, 0, : len1[j]].tobytes().decode(), mates[j, 1].tobytes().decode()]}
        for j in range(N_SERVE_PAIRS + N_CONCURRENT)
    ]
    one_each = [{"reads": [p]} for p in pairs[N_SERVE_PAIRS:]]
    calls = []
    real = rid.classify_batch

    def counting(batch, *a, **kw):
        calls.append(len(batch))
        return real(batch, *a, **kw)

    rid.classify_batch = counting  # the batcher's worker binds it when it starts
    launches = []
    try:
        for name, bxi, kernel in (("classic", classic_bxi, sq.classic_words),
                                  ("blocked", blocked_bxi, sq.stream_probe)):
            t0 = time.time()
            srv = serve.make_server(bxi, 0, device=DEVICE)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            t_start = time.time() - t0
            try:
                index = serve._State.engine.index
                h = _http(url + "/healthz")
                want_h = {"ok": True, "bloom_size": index.bloom_size, "num_hash": index.num_hash,
                          "k_size": index.k_size, "m_size": index.m_size,
                          "n_colors": index.n_colors}
                info = _http(url + "/info")["accessions"]
                if h != want_h or [a["accession"] for a in info] != sorted(index.colors) or any(
                    a["n_kmers"] != index.n_ref_kmers.get(a["accession"], 0) for a in info
                ):
                    raise AssertionError(f"[serve] {name}: /healthz or /info disagree with the index")
                # /search: each body on the default route (k-mers counted on
                # the card), then counted on the host
                n_launch, parts = 0, []
                for label, body in (("filter 1", {"filter": 1}), ("filter 0", {"filter": 0}),
                                    ("filter -1", {"filter": -1}), ("gene", {"gene": True})):
                    payload = dict(body, sequences=seqs, p_shared=0.01)
                    kernel.launches = 0
                    t0 = time.time()
                    out = _http(url + "/search", payload)
                    dt = time.time() - t0
                    used = kernel.launches
                    n_launch += used
                    os.environ["COLORID_SEARCH_READS"] = "0"
                    try:
                        host = _http(url + "/search", payload)
                    finally:
                        os.environ.pop("COLORID_SEARCH_READS")
                    if out != host or not out["rows"]:
                        diff = [(a, b) for a, b in zip(out["rows"], host["rows"]) if a != b]
                        raise AssertionError(
                            f"[serve] {name} /search {label}: device counting != host "
                            f"counting ({out['num_kmers']} vs {host['num_kmers']} k-mers, "
                            f"{len(out['rows'])} vs {len(host['rows'])} rows, first "
                            f"difference {diff[:1]})")
                    need = name == "blocked" or label == "filter 0"
                    if DEVICE == "cuda" and need and used == 0:
                        raise AssertionError(f"[serve] {name} /search {label}: "
                                             f"{kernel.__name__} not launched")
                    parts.append(f"{label} {out['num_kmers']} k-mers {dt * 1e3:.1f} ms "
                                 f"{kernel.__name__} x{used}")
                lat = []
                for _ in range(5):
                    kernel.launches = 0
                    t0 = time.time()
                    _http(url + "/search", {"filter": 1, "sequences": seqs, "p_shared": 0.01})
                    lat.append(time.time() - t0)
                    n_launch += kernel.launches
                launches.append(n_launch)
                log(f"[serve] {name}: up in {t_start:.1f}s (kernels built, warmed); /healthz, "
                    f"/info == the index; /search on {len(seqs)} reads == host counting: "
                    f"{'; '.join(parts)}; filter 1 median {statistics.median(lat) * 1e3:.1f} "
                    f"ms over 5 ({', '.join(f'{t * 1e3:.1f}' for t in lat)}) on {card}")
                # /classify: one request of N_SERVE_PAIRS pairs against the CPU
                t0 = time.time()
                got = _http(url + "/classify", {"reads": pairs[:N_SERVE_PAIRS]})["rows"]
                dt = time.time() - t0
                cpu = QueryEngine(BigsiIndex.load(bxi), device="cpu")
                batch = [(p["id"], [to_bytes(x) for x in p["seqs"]]) for p in pairs[:N_SERVE_PAIRS]]
                want = [dict(zip(("id", "classification", "support", "total", "status", "n_top"), r))
                        for r in real(batch, cpu, d=1, fp_correct=1e-3, start_sample=3)]
                del cpu
                if got != json.loads(json.dumps(want)):
                    raise AssertionError(f"[serve] {name} /classify != classify_batch on the CPU")
                sequential = [_http(url + "/classify", p)["rows"] for p in one_each]
                calls.clear()
                t0 = time.time()
                with ThreadPoolExecutor(max_workers=N_CONCURRENT) as ex:
                    concurrent = list(ex.map(lambda p: _http(url + "/classify", p)["rows"],
                                             one_each))
                dt_c = time.time() - t0
                if (concurrent != sequential or sum(calls) != N_CONCURRENT
                        or len(calls) >= N_CONCURRENT):
                    raise AssertionError(f"[serve] {name}: concurrent /classify != sequential "
                                         f"or not coalesced (classify_batch calls {calls})")
                accepted = sum(r["status"] == "accept" for r in got)
                log(f"[serve] {name}: /classify of {N_SERVE_PAIRS} pairs in one request "
                    f"{dt:.2f}s = {N_SERVE_PAIRS / dt:.0f} pairs/s ({accepted} accepted), == "
                    f"classify_batch on a CPU engine; {N_CONCURRENT} concurrent 1-pair "
                    f"requests == sequential, {N_CONCURRENT / dt_c:.1f} requests/s in "
                    f"{len(calls)} classify_batch calls on {card}")
            finally:
                srv.shutdown()
                srv.server_close()
                serve._State.engine = None
                if DEVICE == "cuda":
                    torch.cuda.empty_cache()
    finally:
        rid.classify_batch = real
    return launches[0], launches[1]


# -- phase 5: the sharded paths on a logical mesh -----------------------------

WIDE_COLORS, WIDE_ROWS, WIDE_SHARDS, WIDE_HASHES = 4096, 4_194_304, 4, 2
WIDE_KMERS = 1 << 24
PANEL_GENOMES, PANEL_LEN, PANEL_BLOOM, PANEL_READS = 1200, 50_000, 2_000_000, 20_000
TIE_LEN, TIE_READS = 10_000, 500


def same_answers(a, b) -> bool:
    """What a streamed, a generic and a single-device result share (their
    overflow lists differ in order, and their histograms in layout)."""
    import numpy as np

    return (
        np.array_equal(a.counts, b.counts)
        and a.all_valid == b.all_valid
        and np.array_equal(a.and_all, b.and_all)
        and a.freq_stats() == b.freq_stats()
    )


def wide_index():
    """A seeded 4,096-color v4 index placed for 4 color shards (place_rpb 4:
    1,024-color shards of wpad 32): a fifth of the words nonzero with about
    4 bits each, 6 % of the rows absent. Drawn on DEVICE (torch's generator
    from the seed) in row slabs, and copied to the host matrix."""
    import numpy as np
    import torch

    from colorid_tpu_torch import convert
    from colorid_tpu_torch.ops.blocked import rows_per_block
    from colorid_tpu_torch.ops.hash_torch import _to_i32
    from colorid_tpu_torch.ops.query import row_wpad

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    W = WIDE_COLORS // 32
    place = rows_per_block(row_wpad(W // WIDE_SHARDS))
    matrix = np.empty((WIDE_ROWS, W), dtype=np.uint32)
    slab = min(1 << 19, WIDE_ROWS)
    for a in range(0, WIDE_ROWS, slab):
        w = torch.randint(0, 2**32, (3, slab, W), generator=g, device=DEVICE)
        live = torch.randint(0, 5, (slab, W), generator=g, device=DEVICE) == 0
        words = torch.where(live, w[0] & w[1] & w[2], 0)
        matrix[a:a + slab] = _to_i32(words).cpu().numpy().view(np.uint32)
    absent = torch.randint(0, WIDE_ROWS, (WIDE_ROWS // 16,), generator=g, device=DEVICE)
    matrix[absent.cpu().numpy()] = 0
    names = [f"c{i}" for i in range(WIDE_COLORS)]
    return convert.index_from_arrays(
        matrix, bloom_size=WIDE_ROWS, num_hash=WIDE_HASHES, k_size=K, colors=names,
        n_ref_kmers={n: 100 for n in names}, blocked=4, place_rpb=place,
    )


def wide_query():
    """WIDE_KMERS distinct canonical 31-mers as ASCII rows with
    frequencies, 0.2 % of them >= 1024, drawn on DEVICE from the seed.
    Canonical values have the density that the v4 block map flattens: 16
    probes per block here."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    v = torch.randint(0, 4**K, (WIDE_KMERS + (1 << 16),), generator=g, device=DEVICE)
    x = ~v & (4**K - 1)
    rc = torch.zeros_like(x)
    for _ in range(K):
        rc = (rc << 2) | (x & 3)
        x = x >> 2
    vals = torch.unique(torch.minimum(v, rc))
    vals = vals[torch.randperm(vals.numel(), generator=g, device=DEVICE)][:WIDE_KMERS]
    if vals.numel() != WIDE_KMERS:
        raise AssertionError("too few distinct k-mers drawn")
    shifts = 2 * torch.arange(K - 1, -1, -1, device=DEVICE)
    acgt = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=DEVICE)
    keys = acgt[(vals[:, None] >> shifts) & 3].cpu().numpy()
    qc = torch.randint(1, 60, (WIDE_KMERS,), generator=g, device=DEVICE, dtype=torch.int32)
    big = torch.rand(WIDE_KMERS, generator=g, device=DEVICE) < 0.002
    qc[big] = torch.randint(1024, 50_000, (int(big.sum()),), generator=g, device=DEVICE,
                            dtype=torch.int32)
    return keys, qc.cpu().numpy()


def colorshard_phase(card: str) -> int:
    """The color-sharded path at full width; returns the raw kernel's
    launches while ShardedQueryEngine.search_keys ran."""
    import numpy as np
    import torch

    from colorid_tpu_torch import QueryEngine, ShardedQueryEngine
    from colorid_tpu_torch.ops import stream_query as sq
    from colorid_tpu_torch.parallel import engine as peng
    from colorid_tpu_torch.parallel.sharded import make_mesh

    t0 = time.time()
    index = wide_index()
    keys, qc = wide_query()
    n = keys.shape[0]
    t_inputs = time.time() - t0
    t0 = time.time()
    eng = ShardedQueryEngine(
        index, mesh=make_mesh(1, WIDE_SHARDS, "color", devices=[DEVICE]))
    sync()
    t_put = time.time() - t0
    log(f"[color] index: {index.n_colors} colors, {index.bloom_size} rows, H {index.num_hash}, "
        f"v{index.blocked}, place_rpb {index.place_rpb}, {index.matrix.nbytes} bytes; "
        f"{WIDE_SHARDS} shards of wpad {eng.wpad} ({eng.mat[0].numel() * 4} bytes each) on "
        f"{eng.mat[0].device}; {n} distinct k-mers; inputs {t_inputs:.1f}s, shards packed "
        f"and placed {t_put:.1f}s")
    if not eng._stream or eng.wpad != 32 or index.place_rpb != 4:
        raise AssertionError("the mesh's shards do not match the index's placement")

    # observe the stream's outcome (None means n_drop > 0, a generic rerun)
    # and where the search spends its time: the host steps of
    # _try_stream_keys (packing, placement, then the argsort and gathers up
    # to the dispatch), then the dispatch (H2D, 4 shards, the fetch) and
    # its assembly
    outcomes, marks, probes = [], {}, []
    finish = eng._stream_colorshard_finish
    steps = {name: getattr(peng, name) for name in ("pack_keys_u64", "v3_block_offsets")}

    def stamped(name):
        def wrapped(*a, **kw):
            t0 = time.time()
            out = steps[name](*a, **kw)
            marks[name] = (t0, time.time())
            return out
        return wrapped

    def observed(*a):
        probes.append(a)
        t0 = time.time()
        res = finish(*a)
        sync()
        marks["dispatch"] = (t0, time.time())
        outcomes.append(res is not None)
        return res

    eng._stream_colorshard_finish = observed
    for name in steps:
        setattr(peng, name, stamped(name))
    sq.stream_probe_raw.launches = 0
    sync()
    try:
        t0 = time.time()
        res_stream = eng.search_keys(keys, qcounts=qc)
        sync()
        t_stream = time.time() - t0
    finally:
        eng._stream_colorshard_finish = finish
        for name, fn in steps.items():
            setattr(peng, name, fn)
    launches = sq.stream_probe_raw.launches
    if outcomes != [True] or (DEVICE == "cuda" and launches != WIDE_SHARDS):
        raise AssertionError(
            f"the color-sharded search did not take the stream (outcomes={outcomes}, "
            f"stream_probe_raw launches={launches}, want {WIDE_SHARDS})")
    t_pack = marks["pack_keys_u64"][1] - marks["pack_keys_u64"][0]
    t_place = marks["v3_block_offsets"][1] - marks["v3_block_offsets"][0]
    t_sort = marks["dispatch"][0] - marks["v3_block_offsets"][1]
    t_dispatch = marks["dispatch"][1] - marks["dispatch"][0]
    blk_s, offp_s, qc_s = probes[0][:3]
    blk2d = blk_s.reshape(-1, sq.PC)
    tb = np.clip(blk2d[:, 0] // 128, 0, index.bloom_size // eng.rpb // 128 - 2)
    outside = blk2d - tb[:, None] * 128 >= 256
    log(f"[color] one streamed search of {n} k-mers: host pack {t_pack:.2f}s, placement "
        f"{t_place:.2f}s, argsort+gather {t_sort:.2f}s, dispatch+assembly {t_dispatch:.2f}s "
        f"(of {t_stream:.2f}s through search_keys); residual probes "
        f"{int(outside.sum())} in {int(outside.any(axis=1).sum())} of {blk2d.shape[0]} "
        f"chunks (capacity {sq._nch(eng.wpad)}), n_drop 0 on {card}")
    if DEVICE == "cuda":
        profile_dispatch(
            lambda: finish(blk_s, offp_s, qc_s, WIDE_HASHES, eng.rpb), "color", card)
    del probes, blk_s, offp_s, qc_s, blk2d, outside

    before = sq.stream_probe_raw.launches
    os.environ["COLORID_STREAM"] = "0"
    try:
        sync()
        t0 = time.time()
        res_generic = eng.search_keys(keys, qcounts=qc)
        sync()
        t_generic = time.time() - t0
    finally:
        os.environ.pop("COLORID_STREAM")
    if sq.stream_probe_raw.launches != before:
        raise AssertionError("COLORID_STREAM=0 launched the raw kernel")
    del eng
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    single = QueryEngine(index, device=DEVICE)
    if not single._custom_place or single._stream:
        raise AssertionError("the single-device engine did not take the recorded placement")
    sync()
    t0 = time.time()
    res_single = single.search_keys(keys, qcounts=qc)
    sync()
    t_single = time.time() - t0
    stats = res_single.freq_stats()
    for name, res in (("generic sharded", res_generic), ("single-device", res_single)):
        if not same_answers(res_stream, res):
            raise AssertionError(f"color-sharded stream != {name} result")
    if not stats or int(res_single.counts.sum()) == 0 or not len(res_single.over_colors):
        raise AssertionError("the wide query has no unique hits or overflow to compare")
    log(f"[color] counts, all_valid, and_all, freq_stats identical: streamed sharded == generic "
        f"sharded == single-device (counts sum {int(res_single.counts.sum())}, all_valid "
        f"{res_single.all_valid}, {len(stats)} colors with unique hits, "
        f"{len(res_single.over_colors)} frequencies >= 1024); k-mers/s, host arrays in: "
        f"streamed sharded={n / t_stream:.0f} generic sharded={n / t_generic:.0f} "
        f"single-device generic={n / t_single:.0f}; stream_probe_raw launches={launches} on {card}")
    return launches


def entry_points_phase(tmp: str, card: str) -> dict:
    """build --blocked --color-shards 4 -> search through the CLI, and the
    sharded engine on the loaded index: the same report lines. Returns the
    index's path, the reads' FASTQ and the panel's genomes."""
    import numpy as np

    from colorid_tpu_torch import BigsiIndex, QueryEngine, ShardedQueryEngine
    from colorid_tpu_torch.ops import stream_query as sq
    from colorid_tpu_torch.parallel.sharded import make_mesh
    from colorid_tpu_torch.pipelines.reports import generate_report
    from colorid_tpu_torch.pipelines.search import _count_query_kmers

    rng = np.random.default_rng(SEED + 5)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, dtype=np.uint8)
    comp[acgt] = np.frombuffer(b"TGCA", dtype=np.uint8)
    d = os.path.join(tmp, "panel1200")
    os.makedirs(d)
    genomes = acgt[rng.integers(0, 4, (PANEL_GENOMES, PANEL_LEN))]
    # the last genome repeats the first one's first TIE_LEN bases: reads
    # from there tie between a color of the first shard and one of the last
    genomes[-1, :TIE_LEN] = genomes[0, :TIE_LEN]
    manifest = []
    for i, g in enumerate(genomes):
        path = os.path.join(d, f"g{i:04d}.fasta")
        with open(path, "wb") as f:
            f.write(f">g{i:04d}\n".encode() + g.tobytes() + b"\n")
        manifest.append(f"g{i:04d}\t{path}\n")
    man = os.path.join(d, "refs.txt")
    with open(man, "w") as f:
        f.writelines(manifest)
    sources = [f"g{i:04d}" for i in (7, 640, 1100)]  # one in each of 3 color shards
    src = rng.integers(0, 3, PANEL_READS)
    starts = rng.integers(0, PANEL_LEN - READ_LEN, PANEL_READS)
    reads = genomes[[7, 640, 1100]][src[:, None], starts[:, None] + np.arange(READ_LEN)]
    rc = rng.random(PANEL_READS) < 0.5
    reads[rc] = comp[reads[rc][:, ::-1]]
    seqs = reads.tobytes().decode()
    fq = os.path.join(d, "reads.fastq.gz")
    qual = "I" * READ_LEN
    with gzip.open(fq, "wt", compresslevel=1) as f:
        f.write("".join(
            f"@r{j}\n{seqs[j * READ_LEN:(j + 1) * READ_LEN]}\n+\n{qual}\n"
            for j in range(PANEL_READS)))
    prefix = os.path.join(d, "wide")
    quiet = io.StringIO()  # the build names every accession on stderr
    t0 = time.time()
    with contextlib.redirect_stderr(quiet):
        cli(["build", "--blocked", "--color-shards", str(WIDE_SHARDS), "-k", str(K),
             "-n", str(WIDE_HASHES), "-s", str(PANEL_BLOOM), "-b", prefix, "-r", man,
             "-t", "8"])
    t_build = time.time() - t0
    t0 = time.time()
    with contextlib.redirect_stderr(quiet):
        tsv = cli(["search", "-b", prefix + ".bxi", "-q", fq, "-f", "1", "--device", DEVICE])
    t_search = time.time() - t0
    rows = [l.split("\t") for l in tsv if "\t" in l]
    for line in tsv[:6]:
        log(f"[entry] tsv {line}")
    if sorted(r[2] for r in rows[:3]) != sorted(sources):
        raise AssertionError(f"top rows {[r[2] for r in rows[:3]]} are not {sources}")

    index = BigsiIndex.load(prefix + ".bxi")
    W = index.words_per_row
    if index.blocked != 4 or index.place_rpb != 128 // 16 or W != 38:
        raise AssertionError(
            f"build --color-shards wrote blocked={index.blocked} "
            f"place_rpb={index.place_rpb} words={W}")
    with contextlib.redirect_stderr(quiet):
        keys, qcounts, _packed = _count_query_kmers(fq, None, K, 15, 1, False)
    eng = ShardedQueryEngine(
        index, mesh=make_mesh(1, WIDE_SHARDS, "color", devices=[DEVICE]))
    before = sq.stream_probe_raw.launches
    streamed = eng._try_stream_keys(keys, qcounts)
    raw_launches = sq.stream_probe_raw.launches - before
    res = eng.search_keys(keys, qcounts=qcounts)
    single = QueryEngine(index, device=DEVICE).search_keys(keys, qcounts=qcounts)
    if not eng._stream or not same_answers(res, single):
        raise AssertionError("sharded engine != single-device engine on the built index")
    if streamed is not None and not same_answers(streamed, single):
        raise AssertionError("the streamed sharded result differs")
    report = {index.colors[c]: int(res.counts[c])
              for c in range(index.n_colors) if res.counts[c] > 0}
    uniq = {index.colors[c]: st for c, st in res.freq_stats().items()}
    lines = generate_report(fq, report, uniq, index.n_ref_kmers, keys.shape[0], 0.35)
    if lines != tsv:
        raise AssertionError("the sharded engine's report differs from the CLI's TSV")
    log(f"[entry] build --blocked --color-shards {WIDE_SHARDS}: {PANEL_GENOMES} genomes x "
        f"{PANEL_LEN} bp, -k {K} -n {WIDE_HASHES} -s {PANEL_BLOOM} -> v{index.blocked}, "
        f"place_rpb {index.place_rpb}, {W} words per row, shards of wpad {eng.wpad}: "
        f"{t_build:.1f}s; CLI search -f 1 ({PANEL_READS} reads, {keys.shape[0]} k-mers, "
        f"generic gather with the recorded placement) {t_search:.1f}s; "
        f"ShardedQueryEngine on the loaded index: report lines identical to the CLI's "
        f"({len(tsv)} lines), stream "
        f"{'taken' if streamed is not None else 'dropped to the generic path (sparse probes)'}"
        f", stream_probe_raw launches={raw_launches} on {card}")
    return {"bxi": prefix + ".bxi", "fq": fq, "genomes": genomes}


def rowshard_phase(bxi: str, fq: str, card: str) -> int:
    """The blocked index of phase 3 on a (1, 4) row mesh; returns the probe
    kernel's launches while the sharded search ran."""
    from colorid_tpu_torch import BigsiIndex, QueryEngine, ShardedQueryEngine
    from colorid_tpu_torch.ops import stream_query as sq
    from colorid_tpu_torch.parallel.sharded import make_mesh
    from colorid_tpu_torch.pipelines.search import _count_query_kmers

    with contextlib.redirect_stderr(io.StringIO()):
        keys, qcounts, packed = _count_query_kmers(fq, None, K, 15, 1, False)
    n = keys.shape[0]
    index = BigsiIndex.load(bxi)
    eng = ShardedQueryEngine(
        index, layout="row", mesh=make_mesh(1, 4, "row", devices=[DEVICE]))
    if not eng._stream:
        raise AssertionError("the row mesh is not stream-eligible")
    sq.stream_probe.launches = 0
    sync()
    t0 = time.time()
    streamed = eng._try_stream_keys(keys, qcounts)
    sync()
    t_stream = time.time() - t0
    launches = sq.stream_probe.launches
    if streamed is None or (DEVICE == "cuda" and launches != 4):
        raise AssertionError(
            f"the row-sharded search did not stream (stream_probe launches={launches})")
    os.environ["COLORID_STREAM"] = "0"
    try:
        t0 = time.time()
        generic = eng.search_keys(keys, qcounts=qcounts)
        sync()
        t_generic = time.time() - t0
        single_generic = QueryEngine(index, device=DEVICE).search_keys(
            keys, qcounts=qcounts, packed_all=packed, k=K)
    finally:
        os.environ.pop("COLORID_STREAM")
    single_stream = QueryEngine(index, device=DEVICE).search_keys(
        keys, qcounts=qcounts, packed_all=packed, k=K)
    for name, res in (("generic row-sharded", generic), ("single-device stream", single_stream),
                      ("single-device generic", single_generic)):
        if not same_answers(streamed, res):
            raise AssertionError(f"row-sharded stream != {name} result")
    log(f"[row] (1, 4) row mesh on {eng.mat[0].device}: {eng.Rl} rows per shard, "
        f"{eng.Rl // eng.rpb} blocks; {n} k-mers: streamed == generic row-sharded == "
        f"single-device stream == single-device generic; k-mers/s, host arrays in: "
        f"streamed={n / t_stream:.0f} generic row-sharded={n / t_generic:.0f}; "
        f"stream_probe launches={launches} on {card}")
    return launches


# -- phase 5b: the sharded read classifier and sharded device extraction -------

SHREADS_MESH = (2, 4)


@contextlib.contextmanager
def sharded_outputs(timed: bool = False):
    """(seen, secs): the device types of every tensor that
    parallel/sharded.py's read classifier, extraction, hashing and generic
    query return while the block runs, by function (observers wrap them for
    the block); with ``timed`` each call is synchronised before and after
    and secs adds up its seconds by function (a split that gives up the
    overlap of host and card, so its sum exceeds an untimed call's)."""
    from colorid_tpu_torch.parallel import sharded

    names = [n for n in dir(sharded) if n.startswith(
        ("readid_batch_", "readid_firsthit_", "extract_merge_", "hash_packed_", "query_batch_"))]
    saved = {n: getattr(sharded, n) for n in names}
    seen: dict[str, set] = {}
    secs: dict[str, float] = {}

    def watched(name, fn):
        def wrapped(*a, **kw):
            if timed:
                sync()
                t0 = time.time()
            out = fn(*a, **kw)
            if timed:
                sync()
                secs[name] = secs.get(name, 0.0) + time.time() - t0
            for t in out if isinstance(out, tuple) else (out,):
                seen.setdefault(name, set()).add(t.device.type)
            return out
        return wrapped

    for n in names:
        setattr(sharded, n, watched(n, saved[n]))
    try:
        yield seen, secs
    finally:
        for n in names:
            setattr(sharded, n, saved[n])


def _on_device(seen: dict, want: tuple, what: str) -> None:
    """Every watched output on DEVICE, and each function of ``want`` called."""
    missing = [n for n in want if n not in seen]
    off = {n: d for n, d in seen.items() if d != {DEVICE}}
    if missing or off:
        raise AssertionError(f"{what}: not called {missing}, outputs off {DEVICE}: {off}")


def _count_calls(engine, names) -> dict:
    """Counts the calls of the engine's methods ``names`` from now on."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(engine, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        setattr(engine, name, counted)
    return calls


def _files(prefix: str) -> list[bytes]:
    out = []
    for suffix in ("_reads.txt", "_counts.txt"):
        with open(prefix + suffix, "rb") as f:
            out.append(f.read())
    return out


def shreads_phase(blocked_bxi: str, reads: dict, panel: dict, card: str) -> None:
    """The sharded read classifier and sharded device extraction on
    (2, 4) meshes, every shard on the one card: read_id through a row mesh
    over the blocked index (the packed route) against the single-device
    CLI's files of the reads phase; read_id of the panel's reads through a
    color mesh over the shard-placed index (the arrays route and the
    first-hit fixup) against a single-device engine's; search_reads on
    both meshes against the single-device answers."""
    import numpy as np
    import torch

    from colorid_tpu_torch import BigsiIndex, QueryEngine, ShardedQueryEngine
    from colorid_tpu_torch.core.fastx import stream_fastq
    from colorid_tpu_torch.ops.extract import pack_reads
    from colorid_tpu_torch.parallel.sharded import make_mesh
    from colorid_tpu_torch.pipelines import read_id as rid
    from colorid_tpu_torch.pipelines.search import _count_query_kmers

    t_phase = time.time()
    nd, nm = SHREADS_MESH
    d = os.path.dirname(reads["blocked_all"])
    quiet = io.StringIO()
    routes = ("readid_counts_packed", "readid_counts_arrays", "readid_firsthit")
    rid_fns = ("readid_batch_rowshard_packed",)

    # (a) read_id on the reads cell's pairs through a row mesh
    index = BigsiIndex.load(blocked_bxi)
    row = ShardedQueryEngine(index, layout="row", mesh=make_mesh(nd, nm, "row", devices=[DEVICE]))
    if {m.device.type for m in row.mat} != {DEVICE} or not row.rpb:
        raise AssertionError("the row mesh's shards are not on the card or gather row by row")
    calls = _count_calls(row, routes)
    prefix = os.path.join(d, "sharded_row")
    with sharded_outputs() as (seen, _), read_id_split() as split:
        t0 = time.time()
        with contextlib.redirect_stderr(quiet):
            rid.read_id(reads["pairs"], row, prefix)
        dt = time.time() - t0
    _on_device(seen, rid_fns, "sharded read_id (row mesh)")
    if _files(prefix) != _files(reads["blocked_all"]):
        raise AssertionError("the row mesh's read_id files differ from the single-device CLI's")
    if not calls["readid_counts_packed"]:
        raise AssertionError(f"the row mesh's read_id did not take the packed route: {calls}")
    n = len(reads["src"])
    rate1, classify1 = reads["single"]
    log(f"[shreads] {SHREADS_MESH} row mesh over the blocked index ({nm} row shards of "
        f"{row.Rl} rows on {row.mat[0].device}, blocked gather rpb {row.rpb}): read_id on "
        f"{n} pairs: _reads.txt and _counts.txt byte-identical to the single-device CLI's; "
        f"{n / dt:.0f} pairs/s ({dt:.2f}s in-process, classify_batch {split['classify']:.2f}s; "
        f"calls {calls}) against the single-device CLI's {rate1:.0f} pairs/s (index load "
        f"included; classify_batch {classify1:.2f}s) on {card}")

    # (c) search_reads on the device-resident reads through the row mesh
    words, lens = reads["dev"][:2]
    L = reads["L"]
    single = QueryEngine(index, device=DEVICE)
    t_single, t_row = [], []
    for _ in range(2):
        sync()
        t0 = time.time()
        want = single.search_reads(words, lens, k=K, L=L, filter_t=1)
        sync()
        t_single.append(time.time() - t0)
    with sharded_outputs() as (seen, _):
        for _ in range(2):
            sync()
            t0 = time.time()
            got = row.search_reads(words, lens, k=K, L=L, filter_t=1)
            sync()
            t_row.append(time.time() - t0)
    _on_device(seen, ("extract_merge_datashard", "hash_packed_datashard",
                      "query_batch_rowshard"), "sharded search_reads (row mesh)")
    n_u = got[1]
    if n_u != want[1] or not same_answers(got[0], want[0]):
        raise AssertionError("the row mesh's search_reads differs from the single-device one")
    # where a sharded call spends its time: each sharded step synchronised,
    # and what is left (the host's padding, the n_owned and uniq-color
    # fetches, the uniq-hit statistics of _finish)
    with sharded_outputs(timed=True) as (_, secs):
        sync()
        t0 = time.time()
        row.search_reads(words, lens, k=K, L=L, filter_t=1)
        sync()
        t_split = time.time() - t0
    log(f"[shreads] search_reads -f 1 on {words.shape[0]} device-resident reads "
        f"({words.shape[0] * (L - K + 1)} windows) through the row mesh: counts, all_valid, "
        f"and_all, freq_stats and n_u ({n_u}) equal to the single-device search_reads; "
        f"k-mers/s (best of 2): sharded {n_u / min(t_row):.0f} ({min(t_row):.3f}s), "
        f"single-device {n_u / min(t_single):.0f} ({min(t_single):.3f}s); one sharded call "
        f"split, each step synchronised: "
        + ", ".join(f"{name} {sec:.3f}s" for name, sec in secs.items())
        + f", the host's part {t_split - sum(secs.values()):.3f}s of {t_split:.3f}s on {card}")
    if DEVICE == "cuda":
        profile_dispatch(lambda: row.search_reads(words, lens, k=K, L=L, filter_t=1)[1],
                         "shreads row mesh", card, label="sharded search_reads")
    del row, single, index
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    # (b) read_id of the panel's reads (and reads from the shared region,
    # which tie) through a color mesh over the shard-placed index
    pidx = BigsiIndex.load(panel["bxi"])
    col = ShardedQueryEngine(pidx, mesh=make_mesh(nd, nm, "color", devices=[DEVICE]))
    if {m.device.type for m in col.mat} != {DEVICE} or not pidx.place_rpb:
        raise AssertionError("the color mesh's shards are not on the card")
    with contextlib.redirect_stderr(quiet):
        seqs = np.stack([s for _id, s in stream_fastq(panel["fq"], 15)])
    rng = np.random.default_rng(SEED + 7)
    starts = rng.integers(0, TIE_LEN - READ_LEN, TIE_READS)
    tied = panel["genomes"][0][starts[:, None] + np.arange(READ_LEN)]
    fq = os.path.join(d, "panel_ties.fastq.gz")
    qual = "I" * READ_LEN
    with gzip.open(fq, "wt", compresslevel=1) as f:
        f.write("".join(f"@r{j}\n{r.tobytes().decode()}\n+\n{qual}\n"
                        for j, r in enumerate(np.concatenate([seqs, tied]))))
    single = QueryEngine(pidx, device=DEVICE)
    t0 = time.time()
    with contextlib.redirect_stderr(quiet):
        rid.read_id([fq], single, os.path.join(d, "panel_single"))
    t_single = time.time() - t0
    calls = _count_calls(col, routes)
    with sharded_outputs() as (seen, _):
        t0 = time.time()
        with contextlib.redirect_stderr(quiet):
            rid.read_id([fq], col, os.path.join(d, "panel_sharded"))
        t_col = time.time() - t0
    _on_device(seen, ("readid_batch_colorshard", "readid_firsthit_colorshard"),
               "sharded read_id (color mesh)")
    got_files = _files(os.path.join(d, "panel_sharded"))
    if got_files != _files(os.path.join(d, "panel_single")):
        raise AssertionError("the color mesh's read_id files differ from the single-device one's")
    if not calls["readid_counts_arrays"] or not calls["readid_firsthit"]:
        raise AssertionError(f"the color mesh's read_id missed a route: {calls}")
    rows = [l.split("\t") for l in got_files[0].decode().splitlines()]
    n_ties = sum(1 for r in rows if r[4] == "reject" and int(r[5]) > 1)
    n_r = len(rows)
    log(f"[shreads] {SHREADS_MESH} color mesh over the shard-placed index ({pidx.n_colors} "
        f"colors, place_rpb {pidx.place_rpb}, {nm} shards of wpad {col.wpad}): read_id on "
        f"{n_r} reads ({TIE_READS} from the region two colors share; {n_ties} tied calls "
        f"reordered by the first-hit fixup): files byte-identical to the single-device "
        f"engine's; calls {calls}; {n_r / t_col:.0f} reads/s sharded ({t_col:.2f}s), "
        f"{n_r / t_single:.0f} single-device ({t_single:.2f}s) on {card}")

    # (c) search_reads on the panel's reads through the color mesh against
    # the single-device engine on host-counted k-mers (its device hashing
    # refuses a shard-placed index)
    with contextlib.redirect_stderr(quiet):
        keys, qcounts, _packed = _count_query_kmers(panel["fq"], None, K, 15, 1, False)
    want = single.search_keys(keys, qcounts=qcounts)
    pw = torch.from_numpy(pack_reads(seqs).view(np.int32)).to(DEVICE)
    pl = torch.full((seqs.shape[0],), seqs.shape[1], dtype=torch.int32, device=DEVICE)
    with sharded_outputs() as (seen, _):
        sync()
        t0 = time.time()
        got, n_u = col.search_reads(pw, pl, k=K, L=seqs.shape[1], filter_t=1)
        sync()
        t_col = time.time() - t0
    _on_device(seen, ("extract_merge_datashard", "hash_packed_datashard",
                      "query_batch_colorshard"), "sharded search_reads (color mesh)")
    if n_u != keys.shape[0] or not same_answers(got, want):
        raise AssertionError("the color mesh's search_reads differs from search_keys")
    log(f"[shreads] search_reads -f 1 on the panel's {seqs.shape[0]} reads through the color "
        f"mesh: equal to the single-device search_keys on {n_u} host-counted k-mers; "
        f"{n_u / t_col:.0f} k-mers/s ({t_col:.3f}s); phase {time.time() - t_phase:.1f}s "
        f"on {card}")
    del col, single
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def dist_phase(card: str) -> None:
    """parallel/distributed.py on the card: a process group of this one
    process (two NCCL ranks cannot share one card) over TCP on localhost,
    one all_reduce on the card, and the group torn down."""
    import socket

    import torch
    import torch.distributed as dist

    from colorid_tpu_torch.parallel import distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.time()
    distributed.initialize(f"127.0.0.1:{port}", num_processes=1, process_id=0,
                           backend=None if DEVICE == "cuda" else "gloo")
    try:
        backend, size = dist.get_backend(), dist.get_world_size()
        multi = distributed.is_multi_process()
        x = torch.arange(1 << 20, dtype=torch.float32, device=DEVICE)
        dist.all_reduce(x)
        sync()
        same = bool(torch.equal(x, torch.arange(1 << 20, dtype=torch.float32, device=DEVICE)))
    finally:
        dist.destroy_process_group()
    if not same or size != 1 or multi or x.device.type != DEVICE or distributed.is_multi_process():
        raise AssertionError(f"[dist] all_reduce over one rank: equal={same} size={size}")
    log(f"[dist] distributed.initialize over tcp://127.0.0.1:{port}: backend {backend}, world "
        f"size {size}, is_multi_process {multi}; all_reduce of 2^20 float32 on "
        f"{x.device} unchanged; group destroyed; {time.time() - t0:.1f}s on {card}")


# -- phase 5c: the row mesh across processes -----------------------------------

MPROC_TIMEOUT = 900  # seconds for both ranks of the [mproc] phase


RESULT_FIELDS = ("counts", "all_valid", "and_all", "freq_hist", "over_colors", "over_freqs")


def _result_arrays(prefix: str, res) -> dict:
    import numpy as np

    return {f"{prefix}.{f}": np.asarray(getattr(res, f)) for f in RESULT_FIELDS}


def _result_of(out: dict, prefix: str):
    from colorid_tpu_torch.engine import SearchResult

    return SearchResult(*(out[f"{prefix}.{f}"] for f in RESULT_FIELDS))


def mproc_worker(argv: list[str]) -> int:
    """One rank of the [mproc] phase (chip_smoke.py --mproc-worker RANK
    HOST:PORT DIR DEVICE BACKEND ROOT): a (1, 4) row mesh of two shards per
    rank over DIR's classic.bxi and blocked.bxi with the package of the
    checkout at ROOT, every route of the phase timed, its outputs, seconds,
    collective seconds (all_and and all_sum, the row merges' collectives,
    each synchronised) and the card's max_memory_allocated saved to
    DIR/rank<RANK>.npz. Prints no result line."""
    sys.path.insert(0, argv[5])
    import numpy as np
    import torch

    from colorid_tpu_torch import BigsiIndex, ShardedQueryEngine
    from colorid_tpu_torch.ops import build_ops
    from colorid_tpu_torch.ops.query import row_wpad
    from colorid_tpu_torch.parallel import distributed
    from colorid_tpu_torch.parallel.sharded import make_mesh
    from colorid_tpu_torch.pipelines import read_id as rid

    global DEVICE
    rank, coord, d, device, backend = int(argv[0]), argv[1], argv[2], argv[3], argv[4]
    DEVICE = torch.device(device).type
    if DEVICE == "cuda":
        torch.cuda.set_device(torch.device(device))
        torch.cuda.reset_peak_memory_stats()
    distributed.initialize(coord, num_processes=2, process_id=rank, backend=backend)
    coll = [0.0, 0]

    def timed(fn):
        def wrapped(t):
            sync()
            t0 = time.time()
            out = fn(t)
            sync()
            coll[0] += time.time() - t0
            coll[1] += 1
            return out
        return wrapped

    distributed.all_and = timed(distributed.all_and)
    distributed.all_sum = timed(distributed.all_sum)
    out: dict = {}

    def step(name, fn):
        c0, n0 = coll
        sync()
        t0 = time.time()
        res = fn()
        sync()
        out[f"{name}.secs"] = np.array(time.time() - t0)
        out[f"{name}.coll"] = np.array([coll[0] - c0, coll[1] - n0])
        return res

    try:
        q = np.load(os.path.join(d, "query.npz"))
        keys, qcounts = q["keys"], q["qcounts"]
        mesh = make_mesh(1, 4, "row", devices=[device, device])
        for kind in ("classic", "blocked"):
            index = BigsiIndex.load(os.path.join(d, f"{kind}.bxi"))
            eng = ShardedQueryEngine(index, mesh=mesh, layout="row")
            out[f"{kind}.held"] = np.array([m is not None for m in eng.mat])
            out[f"{kind}.stream"] = np.array(eng._stream)
            res = step(f"{kind}.search_keys", lambda: eng.search_keys(keys, qcounts=qcounts))
            out.update(_result_arrays(f"{kind}.search_keys", res))
        # eng is the v4 index's engine from here on
        prefix = os.path.join(d, f"rank{rank}")
        with contextlib.redirect_stderr(io.StringIO()):
            step("read_id", lambda: rid.read_id(list(q["pairs"]), eng, prefix))
        words = torch.from_numpy(q["words"]).to(device)
        lens = torch.from_numpy(q["lens"]).to(device)
        L = int(q["L"])
        for i in range(2):
            res, n_u = step(f"search_reads{i}", lambda: eng.search_reads(
                words, lens, k=K, L=L, filter_t=1))
        out.update(_result_arrays("search_reads", res))
        out["search_reads.n_u"] = np.array(n_u)
        del eng, words, lens
        index = BigsiIndex.load(os.path.join(d, "classic.bxi"))
        meta = dataclasses.replace(index, matrix=None)
        cols = _columns(index)

        def born():
            shards, Rl = build_ops.build_matrix_rowshard(
                cols, index.bloom_size, mesh, row_multiple=ShardedQueryEngine.row_multiple(meta))
            blocks = build_ops.pack_blocks_rowshard(
                shards, mesh=mesh, Rl=Rl, W=index.words_per_row)
            return ShardedQueryEngine(meta, mesh=mesh, layout="row",
                                      sharded_matrix=(blocks, row_wpad(index.words_per_row), Rl))

        eng = step("born.build", born)
        res = step("born.search_keys", lambda: eng.search_keys(keys, qcounts=qcounts))
        out.update(_result_arrays("born.search_keys", res))
        out["born.held"] = np.array([m is not None for m in eng.mat])
        out["home"] = np.array(str(mesh.home))
        out["max_memory_allocated"] = np.array(
            torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    return 0


def mproc_phase(tmp: str, fq: str, classic_bxi: str, blocked_bxi: str, shr: dict,
                card: str, root: str = HERE) -> None:
    """ShardedQueryEngine on a (1, 4) row mesh whose shards live in two
    processes (two per rank: this script in --mproc-worker mode, gloo with
    both ranks on one card, NCCL with one card each where there are two or
    more): search_keys on the classic index and, through the generic
    gather, on the v4 one with the k-mers of search -f 1; read_id of the
    reads cell's pairs (byte-identical to the single-device CLI's files);
    search_reads on its 400,000 reads; the row-sharded build of the
    classic index's columns and its search. Every output equal on both
    ranks and to the single-device engine. The ranks run the package of
    the checkout at root."""
    import socket

    import numpy as np
    import torch

    from colorid_tpu_torch import BigsiIndex, QueryEngine
    from colorid_tpu_torch.pipelines.search import _count_query_kmers

    t_phase = time.time()
    d = os.path.join(tmp, "mproc")
    os.makedirs(d)
    with contextlib.redirect_stderr(io.StringIO()):
        keys, qcounts, packed = _count_query_kmers(fq, None, K, 15, 1, False)
    words, lens = (x.cpu().numpy() for x in shr["dev"][:2])
    np.savez(os.path.join(d, "query.npz"), keys=keys, qcounts=qcounts, words=words,
             lens=lens, L=np.array(shr["L"]), pairs=np.array(shr["pairs"]))
    for kind, bxi in (("classic", classic_bxi), ("blocked", blocked_bxi)):
        os.symlink(bxi, os.path.join(d, f"{kind}.bxi"))
    cards = torch.cuda.device_count() if DEVICE == "cuda" else 0
    backend = "nccl" if cards >= 2 else "gloo"
    devs = [f"cuda:{r}" if cards >= 2 else ("cuda:0" if DEVICE == "cuda" else "cpu")
            for r in range(2)]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    t0 = time.time()
    logs = [open(os.path.join(d, f"rank{r}.log"), "w+") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mproc-worker", str(r), coord, d,
         devs[r], backend, root], stdout=logs[r], stderr=subprocess.STDOUT,
        cwd=HERE) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=max(MPROC_TIMEOUT - (time.time() - t0), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tails = []
        for f in logs:
            f.seek(0)
            tails.append(f.read()[-3000:])
            f.close()
    t_ranks = time.time() - t0
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"[mproc] a rank failed (exit codes "
                             f"{[p.returncode for p in procs]}):\n" + "\n".join(tails))
    a, b = (dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(2))
    for key in a:
        if not key.endswith((".secs", ".coll", ".held", "max_memory_allocated", "home")) \
                and not np.array_equal(a[key], b[key]):
            raise AssertionError(f"[mproc] rank 1's {key} differs from rank 0's")
    held = [a["classic.held"].tolist(), b["classic.held"].tolist()]
    if held != [[True, True, False, False], [False, False, True, True]] or \
            a["blocked.stream"] or a["born.held"].tolist() != held[0]:
        raise AssertionError(f"[mproc] shards held {held}, v4 stream {a['blocked.stream']}")
    for kind, bxi in (("classic", classic_bxi), ("blocked", blocked_bxi)):
        want = QueryEngine(BigsiIndex.load(bxi), device=DEVICE).search_keys(
            keys, qcounts=qcounts, packed_all=packed, k=K)
        if not same_answers(_result_of(a, f"{kind}.search_keys"), want):
            raise AssertionError(f"[mproc] {kind} search_keys != the single-device engine's")
        if kind == "classic" and not same_answers(_result_of(a, "born.search_keys"), want):
            raise AssertionError("[mproc] the born-sharded search != the single-device engine's")
        if kind == "blocked":
            single = QueryEngine(BigsiIndex.load(bxi), device=DEVICE)
            sr = single.search_reads(*shr["dev"][:2], k=K, L=shr["L"], filter_t=1)
            if int(a["search_reads.n_u"]) != sr[1] or not same_answers(
                    _result_of(a, "search_reads"), sr[0]):
                raise AssertionError("[mproc] search_reads != the single-device engine's")
            del single
    want_files = _files(shr["blocked_all"])
    for r in range(2):
        if _files(os.path.join(d, f"rank{r}")) != want_files:
            raise AssertionError(f"[mproc] rank {r}'s read_id files differ from the "
                                 "single-device CLI's")
    n, n_pairs, n_u = keys.shape[0], len(shr["src"]), int(a["search_reads.n_u"])

    def timing(out, name, count, unit):
        secs, (cs, calls) = float(out[f"{name}.secs"]), out[f"{name}.coll"]
        return f"{count / secs:.0f} {unit} ({secs:.2f}s, collectives {cs:.3f}s in {int(calls)})"

    for r, out in enumerate((a, b)):
        sr = min((f"search_reads{i}" for i in range(2)), key=lambda k: float(out[k + ".secs"]))
        log(f"[mproc] rank {r} ({backend}, shards {[i for i, h in enumerate(held[r]) if h]} on "
            f"{out['home']}): search_keys classic {timing(out, 'classic.search_keys', n, 'k-mers/s')}"
            f", v4 (generic) {timing(out, 'blocked.search_keys', n, 'k-mers/s')}; read_id "
            f"{timing(out, 'read_id', n_pairs, 'pairs/s')}; search_reads -f 1 (best of 2) "
            f"{timing(out, sr, n_u, 'k-mers/s')}; born-sharded build "
            f"{float(out['born.build.secs']):.2f}s, its search "
            f"{timing(out, 'born.search_keys', n, 'k-mers/s')}; max_memory_allocated "
            f"{int(out['max_memory_allocated'])} B on {card}")
    log(f"[mproc] two ranks, (1, 4) row mesh over {backend} ({devs[0]}, {devs[1]}): "
        f"search_keys on {n} k-mers (classic and v4), read_id on {n_pairs} pairs, "
        f"search_reads on {words.shape[0]} reads ({n_u} k-mers), the born-sharded build "
        f"and its search: every output equal on both ranks and to the single-device engine, "
        f"read_id files byte-identical to the single-device CLI's, v4 through the generic "
        f"gather; ranks {t_ranks:.1f}s (start-up included), phase "
        f"{time.time() - t_phase:.1f}s on {card}")


# -- phase 6: index construction on the card ----------------------------------

ROWSHARD_KMERS = 1 << 20  # the born-sharded engines' query (of ~8.6 M k-mers)


def born_sharded(what: str, index, row_lists, keys, qcounts, card: str) -> int:
    """build_matrix_rowshard + pack_blocks_rowshard from an index's row
    lists on a (1, 4) row mesh of the card: the shards must equal
    device_put_rowshard of the host matrix (the host-matrix engine's), and
    ShardedQueryEngine(sharded_matrix=...) with no host matrix must give
    the host-matrix row engine's SearchResult and the single-device
    engine's answers. Returns the probe kernel's launches in the
    born-sharded engine's search."""
    import dataclasses

    import numpy as np
    import torch

    from colorid_tpu_torch import QueryEngine, ShardedQueryEngine
    from colorid_tpu_torch.bench import same_result
    from colorid_tpu_torch.ops import build_ops
    from colorid_tpu_torch.ops import stream_query as sq
    from colorid_tpu_torch.parallel.sharded import make_mesh

    mesh = make_mesh(1, 4, "row", devices=[DEVICE])
    meta = dataclasses.replace(index, matrix=None)
    mult = ShardedQueryEngine.row_multiple(meta)
    sync()
    t0 = time.time()
    shards, Rl = build_ops.build_matrix_rowshard(
        row_lists, index.bloom_size, mesh, row_multiple=mult)
    blocks = build_ops.pack_blocks_rowshard(shards, mesh=mesh, Rl=Rl, W=index.words_per_row)
    sync()
    t_build = time.time() - t0
    del shards
    hosted = ShardedQueryEngine(index, mesh=mesh, layout="row")
    if hosted.Rl != Rl or not all(torch.equal(a, b) for a, b in zip(blocks, hosted.mat)):
        raise AssertionError(f"{what}: the born-sharded blocks != device_put_rowshard's")
    born = ShardedQueryEngine(meta, mesh=mesh, layout="row",
                              sharded_matrix=(blocks, hosted.wpad, Rl))
    if (born._stream, born.rpb) != (hosted._stream, hosted.rpb):
        raise AssertionError(f"{what}: the born-sharded engine chose another path")
    sq.stream_probe.launches = 0
    sync()
    t0 = time.time()
    res = born.search_keys(keys, qcounts=qcounts)
    sync()
    t_search = time.time() - t0
    launches = sq.stream_probe.launches
    if born._stream and DEVICE == "cuda" and launches != 4:
        raise AssertionError(f"{what}: the born-sharded row shards did not stream "
                             f"(stream_probe launches={launches})")
    res_host = hosted.search_keys(keys, qcounts=qcounts)
    single = QueryEngine(index, device=DEVICE).search_keys(keys, qcounts=qcounts)
    if not same_result(res, res_host) or not same_answers(res, single):
        raise AssertionError(f"{what}: born-sharded SearchResult != host-matrix / single-device")
    if int(res.counts.sum()) == 0 or not res.freq_stats():
        raise AssertionError(f"{what}: the born-sharded query has no hits to compare")
    log(f"[devbuild] {what}: build_matrix_rowshard + pack_blocks_rowshard on a (1, 4) row "
        f"mesh of {blocks[0].device}: {Rl} rows per shard (multiple of {mult}) in "
        f"{t_build:.2f}s, shards == device_put_rowshard of the host matrix; "
        f"ShardedQueryEngine(sharded_matrix=...) with no host matrix, "
        f"{'the probe stream per row shard' if born._stream else 'the generic gather'}: "
        f"{keys.shape[0]} k-mers in {t_search:.2f}s, SearchResult == host-matrix row "
        f"engine's, answers == single-device (counts sum {int(res.counts.sum())}, "
        f"{len(res.freq_stats())} colors with unique hits); stream_probe launches="
        f"{launches} on {card}")
    return launches if born._stream else 0


def _columns(index) -> list:
    """Each color's Bloom rows (int32) from an index's host matrix: the row
    lists a build of that index scatters."""
    import numpy as np

    m = np.asarray(index.matrix)
    return [np.nonzero((m[:, c // 32] >> np.uint32(c % 32)) & np.uint32(1))[0].astype(np.int32)
            for c in range(index.n_colors)]


def devbuild_phase(tmp: str, inputs, classic, blocked_bxi: str, card: str):
    """CLI build --device-build of phase 3's classic index against the host
    build, timed back to back, host then device (each .bxi byte-identical to phase 3's host build; search -f 1 on a
    device-built one gives the same TSV through the classic kernel), then
    the row-sharded build from the index's row lists (classic) and from the
    blocked v4 index's. Returns (classic_word launches in the device-built
    index's search -f 1, stream_probe launches of the born-sharded v4
    engine)."""
    from colorid_tpu_torch import BigsiIndex
    from colorid_tpu_torch.ops import build_ops
    from colorid_tpu_torch.ops import stream_query as sq
    from colorid_tpu_torch.pipelines.search import _count_query_kmers

    man, fq, _sources = inputs
    host_bxi, t_main, host_tsv = classic
    with open(host_bxi, "rb") as f:
        want = f.read()
    # the device builds' scatter-ORs: rows per call and their seconds
    scattered, scatter = [], []
    real = build_ops.scatter_or_column

    def observed(acc, rows, bit):
        sync()
        t0 = time.time()
        out = real(acc, rows, bit)
        sync()
        scatter.append(time.time() - t0)
        scattered.append(int(rows.shape[0]))
        return out

    secs = {"host": [], "device": []}
    load = os.getloadavg()[0]
    build_ops.scatter_or_column = observed
    try:
        for i, who in enumerate(("host", "device")):
            prefix = os.path.join(tmp, f"{who}panel{i}")
            flags = ["--device-build", "--device", DEVICE] if who == "device" else []
            t0 = time.time()
            with contextlib.redirect_stderr(io.StringIO()):
                cli(["build", *flags, "-k", str(K), "-n", str(HASHES), "-s", str(BLOOM),
                     "-b", prefix, "-r", man, "-t", "8"])
            secs[who].append(time.time() - t0)
            with open(prefix + ".bxi", "rb") as g:
                if g.read() != want:
                    raise AssertionError(f"build {i + 1} ({who}) wrote another .bxi than "
                                         "phase 3's host build")
            if who == "host":
                os.remove(prefix + ".bxi")
    finally:
        build_ops.scatter_or_column = real
    if len(scattered) != N_GENOMES:
        raise AssertionError(f"build --device-build ran {len(scattered)} scatter-ORs on the "
                             f"device, not one per accession")
    dev_bxi = os.path.join(tmp, "devicepanel1.bxi")
    sq.classic_words.launches = 0
    t0 = time.time()
    tsv = cli(["search", "-b", dev_bxi, "-q", fq, "-f", "1", "--device", DEVICE])
    t_search = time.time() - t0
    launches = sq.classic_words.launches
    if tsv != host_tsv:
        raise AssertionError("search -f 1 on the device-built index gave another TSV")
    if DEVICE == "cuda" and launches == 0:
        raise AssertionError("search -f 1 on the device-built index did not launch classic_word")
    ratio = sum(secs["device"]) / sum(secs["host"])
    log(f"[devbuild] CLI build -t 8, back to back (host, device; load average "
        f"{load:.2f} before): host {secs['host'][0]:.2f}s, --device-build "
        f"{secs['device'][0]:.2f}s (device / host {ratio:.3f}; scatter-OR on the {DEVICE} "
        f"{sum(scatter):.3f}s for {N_GENOMES} accessions, {sum(scattered)} hashed rows); "
        f"phase 3's host build, "
        f"first and cold, {t_main:.2f}s; every .bxi byte-identical to phase 3's; search -f 1 "
        f"on the device-built index {t_search:.1f}s, TSV identical, classic_word "
        f"launches={launches} on {card}")

    with contextlib.redirect_stderr(io.StringIO()):
        keys, qcounts, _packed = _count_query_kmers(fq, None, K, 15, 1, False)
    keys, qcounts = keys[:ROWSHARD_KMERS], qcounts[:ROWSHARD_KMERS]
    classic_index = BigsiIndex.load(host_bxi)
    born_sharded("classic", classic_index, _columns(classic_index), keys, qcounts, card)
    del classic_index
    index = BigsiIndex.load(blocked_bxi)
    probe = born_sharded("blocked v4", index, _columns(index), keys, qcounts, card)
    return launches, probe


# -- phase 7: an index past int32 row addressing -------------------------------

WIDE_BLOOM, WIDE_K, WIDE_H, WIDE_LEN, WIDE_PAIRS = 3_000_000_000, 27, 2, 40_000, 2000
WIDE_RATE_KMERS = 1 << 22


def wide_phase(tmp: str, card: str) -> None:
    """A classic index of two seeded 40 kbp genomes at -k 27 -n 2 -s
    3,000,000,000 (tests/test_wide_bloom.py's parameters; 12 GB of matrix
    on the card). Built with CLI build --device-build, which the JAX
    package's rule sends to the host scatter past 2^31 rows, and written in
    the reference's sparse bincode format (the dense CXI file would be 12
    GB on disk). search_keys must equal a numpy oracle over the host matrix
    through the wide route (query_accumulate_scan over int64 rows past
    2^31); classify_batch, search -f 1's counting path and CLI read_id on
    2,000 pairs go through the wide routes (query_readid_batch over int64
    rows) and call their source genome."""
    import resource

    import numpy as np
    import torch

    import colorid_tpu_torch.engine as engine_mod
    from colorid_tpu_torch import BigsiIndex, QueryEngine, native
    from colorid_tpu_torch.hashing.xxh3 import bloom_rows_batch
    from colorid_tpu_torch.ops import query as q
    from colorid_tpu_torch.pipelines.read_id import classify_batch
    from colorid_tpu_torch.pipelines.search import batch_search

    rng = np.random.default_rng(SEED + 7)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, dtype=np.uint8)
    comp[acgt] = np.frombuffer(b"TGCA", dtype=np.uint8)
    d = os.path.join(tmp, "wide")
    os.makedirs(d)
    genomes = acgt[rng.integers(0, 4, (2, WIDE_LEN))]
    with open(os.path.join(d, "refs.txt"), "w") as man:
        for i, g in enumerate(genomes):
            path = os.path.join(d, f"wide{i}.fasta")
            with open(path, "wb") as f:
                f.write(f">wide{i}\n".encode() + g.tobytes() + b"\n")
            man.write(f"wide{i}\t{path}\n")
    prefix = os.path.join(d, "wide")
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    err = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stderr(err):
        cli(["build", "--device-build", "--device", DEVICE, "--ref-format", "-k",
             str(WIDE_K), "-n", str(WIDE_H), "-s", str(WIDE_BLOOM), "-b", prefix,
             "-r", os.path.join(d, "refs.txt"), "-t", "2"])
    t_build = time.time() - t0
    rule = [l for l in err.getvalue().splitlines() if "2^31" in l]
    if not rule:
        raise AssertionError("the wide build did not name the host-scatter rule")
    t0 = time.time()
    index = BigsiIndex.load(prefix + ".bxi")
    engine = QueryEngine(index, chunk=1 << 20, device=DEVICE)
    sync()
    t_load = time.time() - t0
    if not engine._wide or engine._stream_classic or index.matrix.shape[0] != WIDE_BLOOM:
        raise AssertionError("the 3e9-row index did not take the wide route")

    # the wide route: the generic scan and read_id batches over int64 rows;
    # a call counts only where its rows pass 2^31 - 1 somewhere
    calls = {"scan": 0, "readid": 0, "firsthit": 0}
    patched = [(engine_mod, "query_accumulate_scan", "scan", 5),
               (q, "query_readid_batch", "readid", 1),
               (q, "query_readid_firsthit", "firsthit", 1)]
    saved = [getattr(o, n) for o, n, _, _ in patched]

    def counted(fn, key, at):
        def wrapped(*a, **kw):
            rows = a[at]
            if rows.dtype != torch.int64:
                raise AssertionError(f"{fn.__name__} got {rows.dtype} rows on the wide index")
            calls[key] += 1
            calls[key + "_past"] = calls.get(key + "_past", 0) + int(
                rows.numel() > 0 and int(rows.max()) >= 2**31)
            return fn(*a, **kw)
        return wrapped

    for (o, n, key, at), fn in zip(patched, saved):
        setattr(o, n, counted(fn, key, at))
    try:
        # search_keys on the k-mers of 20 x 500 bp reads against a numpy
        # oracle over the host matrix (tests/test_wide_bloom.py's check)
        nc = native.NativeCounter(WIDE_K)
        if not nc.add_many(np.ascontiguousarray(genomes[1][: 20 * 500].reshape(20, 500))):
            raise AssertionError("the native counter refused the reads")
        keys, qcounts = nc.dump(0)
        qcounts = np.maximum(qcounts, 1).astype(np.int32)
        res = engine.search_keys(keys, qcounts=qcounts)
        n_scan, n_past = calls["scan"], calls.get("scan_past", 0)
        rows = bloom_rows_batch(keys, WIDE_H, WIDE_BLOOM)
        vals = index.matrix[rows.reshape(-1), 0].reshape(rows.shape)
        andw = vals[:, 0] & vals[:, 1]
        present = (vals != 0).all(axis=1)
        bits = (andw[:, None] >> np.arange(2, dtype=np.uint32)) & 1
        want = (bits * present[:, None]).sum(axis=0)
        uniq = present & (bits.sum(axis=1) == 1)
        fs = res.freq_stats()
        if (not np.array_equal(res.counts, want) or res.all_valid != bool(present.all())
                or [fs[c][2] if c in fs else 0 for c in range(2)]
                != [int((uniq & (bits[:, c] == 1)).sum()) for c in range(2)]):
            raise AssertionError("the wide search != the numpy oracle")
        if n_scan == 0 or n_past == 0 or rows.max() < 2**31:
            raise AssertionError("the wide search did not scan int64 rows past 2^31")

        # the classifier on 8 reads of one genome, search -f 1's counting
        # path on the pairs' first mates, and the device-resident scans
        g = genomes[1]
        batch = [(f"@r{i}", [g[1000 + i * 700: 1150 + i * 700].copy()]) for i in range(8)]
        called = classify_batch(batch, engine, 1, 1e-3, 3)
        if not calls.get("readid_past") or not all(r[1] == "wide1" and r[4] == "accept"
                                                   for r in called):
            raise AssertionError(f"classify_batch on the wide index: {called}, "
                                 f"wide read_id calls {calls['readid']}")
        pairs = WIDE_PAIRS
        src = rng.integers(0, 2, pairs)
        starts = rng.integers(0, WIDE_LEN - 400, pairs)[:, None]
        span = np.arange(READ_LEN)
        mates = np.stack([genomes[src[:, None], starts + span],
                          comp[genomes[src[:, None], starts + 400 - READ_LEN + span][:, ::-1]]],
                         axis=1)
        files = write_pairs(os.path.join(d, "pairs"), mates, np.full(pairs, READ_LEN),
                            np.arange(pairs))
        before = calls["scan"]
        with contextlib.redirect_stderr(io.StringIO()):
            tsv = batch_search(files[:1], [], engine, filter_t=0, cov=0.35,
                               gene_search=False, qual_offset=15)
        top = tsv[0].split("\t")[2] if tsv else None
        if calls["scan"] == before or top not in ("wide0", "wide1") or len(tsv) != 2:
            raise AssertionError(f"search -f 0 on the wide index: {tsv}")
        rate = wide_rates(engine)
    finally:
        for (o, n, _, _), fn in zip(patched, saved):
            setattr(o, n, fn)
    dev_peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    del engine, index
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    # CLI read_id: the index loaded anew, int64 rows hashed on the host, the
    # read_id batches on the card
    before = dict(calls)
    for (o, n, key, at), fn in zip(patched, saved):
        setattr(o, n, counted(fn, key, at))
    try:
        reads_txt, _counts, t_rid = read_id_bytes(prefix + ".bxi", files,
                                                  os.path.join(d, "rid"))
    finally:
        for (o, n, _, _), fn in zip(patched, saved):
            setattr(o, n, fn)
    lines = [l.split("\t") for l in reads_txt.decode().splitlines()]
    ok = sum(r[1] == f"wide{s}" and r[4] == "accept" for r, s in zip(lines, src))
    if len(lines) != pairs or ok < 0.95 * pairs or any(
            r[1] not in ("wide0", "wide1", "no_hits") for r in lines):
        raise AssertionError(f"CLI read_id on the wide index: {ok} of {len(lines)} "
                             "pairs called accept for their genome")
    if calls.get("readid_past", 0) == before.get("readid_past", 0):
        raise AssertionError("CLI read_id did not run read_id batches over rows past 2^31")
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    log(f"[wide] build --device-build --ref-format -k {WIDE_K} -n {WIDE_H} -s {WIDE_BLOOM} "
        f"on 2 x {WIDE_LEN} bp: {t_build:.1f}s ({rule[0].strip()}); loaded and placed "
        f"({WIDE_BLOOM * 4} bytes of matrix) in {t_load:.1f}s; search_keys on "
        f"{keys.shape[0]} k-mers == numpy oracle (counts {res.counts.tolist()}, rows up to "
        f"{int(rows.max())}) through query_accumulate_scan over int64 rows ({n_scan} "
        f"calls, {n_past} with rows past 2^31); classify_batch: 8 of 8 reads "
        f"accept wide1 ({calls['readid']} int64 read_id batches); search -f 0 top row {top}; "
        f"{rate} on {card}")
    log(f"[wide] CLI read_id on {pairs} pairs: {t_rid:.1f}s with the index load "
        f"({pairs / t_rid:.0f} pairs/s), {ok} of {pairs} accept for their genome, "
        f"int64 read_id batches={calls['readid'] - before['readid']} "
        f"firsthit={calls['firsthit'] - before['firsthit']}; memory: host peak RSS "
        f"{host_peak} bytes (the process so far), card max_memory_allocated {dev_peak} "
        f"bytes on {card}")


def wide_rates(engine) -> str:
    """k-mers/s of the wide route on the 3e9-row matrix: the generic scan
    over int64 rows device-resident and through search_keys (int64 rows
    from the host), the JAX-signature adapter query_accumulate_scan_wide
    over the same rows split into (block, lane), and the generic scan over
    int32 rows on the same matrix's first 2^31 rows."""
    import numpy as np
    import torch

    from colorid_tpu_torch.ops import query as q

    rng = np.random.default_rng(SEED + 8)
    n = WIDE_RATE_KMERS
    rows = rng.integers(0, WIDE_BLOOM, (n, WIDE_H))
    qc = rng.integers(1, 60, n).astype(np.int32)
    wide = engine._to_dev(rows)
    blk, lane0 = (engine._to_dev(a) for a in q.split_rows_wide(rows, engine.wpad))
    narrow = engine._to_dev((rows % 2**31).astype(np.int32))
    mask = torch.ones(n, dtype=torch.bool, device=engine.device)
    qc_d = engine._to_dev(qc)
    acc = engine._new_accumulators(1 << 16)
    geo = dict(wpad=engine.wpad, chunk=1 << 20)
    runs = {
        "int64": lambda: q.query_accumulate_scan(*acc, engine.blocks2, wide, mask, qc_d, 0,
                                                 **geo),
        "split": lambda: q.query_accumulate_scan_wide(*acc, engine.blocks2, blk, lane0, mask,
                                                      qc_d, 0, **geo),
        "int32": lambda: q.query_accumulate_scan(*acc, engine.blocks2, narrow, mask, qc_d, 0,
                                                 **geo),
    }
    ms = {}
    for name, fn in runs.items():
        if DEVICE == "cuda":
            ms[name] = cuda_ms(fn, 3)
        else:
            t0 = time.time()
            fn()
            ms[name] = (time.time() - t0) * 1e3
    sync()
    t0 = time.time()
    engine.search_keys(None, qcounts=qc, rows_all=rows)
    t_host = time.time() - t0
    return (f"{n} k-mers x {WIDE_H} rows, device-resident: generic scan on int64 rows (the "
            f"wide route) {n / ms['int64'] * 1e3:.0f} k-mers/s ({ms['int64']:.2f} ms), "
            f"query_accumulate_scan_wide on split rows {n / ms['split'] * 1e3:.0f} k-mers/s "
            f"({ms['split']:.2f} ms), generic scan on int32 rows below 2^31 "
            f"{n / ms['int32'] * 1e3:.0f} k-mers/s ({ms['int32']:.2f} ms); search_keys with "
            f"host int64 rows {n / t_host:.0f} k-mers/s")


def ptxas_summary(logs, keep: tuple = ()) -> list[str]:
    """One entry per compiled kernel instance from nvcc's -Xptxas -v
    reports: its name with template arguments (stream_probe_kernel<1,4> is
    W = 1, H = 4; placement_kernel<2,4,0> is path 2, H = 4, rows),
    registers, static shared memory and spills; a kernel of more than eight
    instances as one entry with their ranges, unless named in ``keep``."""
    import re

    out, name, spill = [], None, ""
    for line in (l for log in logs for l in log.splitlines()):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # the identifier runs from the last digit of its length prefix
            k = re.search(r"([A-Za-z_]+_kernel)(?:I((?:L[ib]n?\d+E)+)E)?", m.group(1))
            vals = [v.replace("n", "-")
                    for v in re.findall(r"L[ib](n?\d+)E", k.group(2) or "")] if k else []
            name = (k.group(1) + (f"<{','.join(vals)}>" if vals else "")) if k else m.group(1)
        elif "spill" in line:
            spill = "no spills" if re.search(r"\b0 bytes spill stores, 0 bytes spill loads",
                                             line) else line.strip()
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((name, int(regs.group(1)) if regs else -1,
                        int(smem.group(1)) if smem else 0, spill))
            name, spill = None, ""
    by_base: dict[str, list] = {}
    for entry in out:
        by_base.setdefault(entry[0].split("<")[0], []).append(entry)
    lines = []
    for base, entries in by_base.items():
        if len(entries) > 8 and base not in keep:
            regs = [e[1] for e in entries]
            spills = sorted({e[3] for e in entries})
            lines.append(f"{base} {len(entries)} instances {min(regs)}-{max(regs)} registers "
                         f"{max(e[2] for e in entries)} B smem {'; '.join(spills)}")
        else:
            lines += [f"{n} {r} registers {sm} B smem {sp}" for n, r, sm, sp in entries]
    return lines


# kernel D's kernels by name: the two-launch design's plan and tail, and the
# earlier five-launch design's plan, three tail kernels and residual gather
D_KERNELS = ("plan", "tail", "tail_count", "tail_overflow", "tail_finish", "residual")


def enqueue_us(fn, reps: int = 20) -> tuple[float, float]:
    """(median, min) microseconds of host clock that one call of ``fn``
    takes to return, each call on an idle card (synchronised before):
    the host's work to enqueue a dispatch that waits for nothing."""
    import statistics

    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times), min(times)


def profile_dispatch(fn, what: str, card: str, label: str = "stream",
                     forbid: tuple = (), forbid_like: tuple = (),
                     enqueue: bool = False) -> None:
    """Where one dispatch (a stream dispatch unless ``label`` says other)
    spends its device time:
    torch.profiler's per-kernel device totals, kernel D's kernels summed,
    and the device's idle share of the dispatch's host-clock span; with
    ``enqueue``, the host clock that one dispatch takes to enqueue
    (``enqueue_us``). Fails if a kernel named in ``forbid``, or whose name
    holds a string of ``forbid_like``, ran in it."""
    host = ""
    if enqueue:
        med, low = enqueue_us(fn)
        host = f"host enqueue of one dispatch {med:.1f} us (median of 20; min {low:.1f}); "
    prof, wall_ms, gap = trace(fn)
    by_name = device_times(prof)
    if not by_name:
        log(f"[profile] {what}: no device time in the trace: not measured on {card}")
        return
    rows = sorted(((ms, n, name) for name, (ms, n) in by_name.items()), reverse=True)
    dev_ms = sum(ms for ms, _, _ in rows)
    top = "; ".join(f"{name} x{n}={ms:.2f}ms" for ms, n, name in rows[:8])
    ours = "; ".join(
        f"{name} x{n}={ms:.3f}ms" for ms, n, name in rows if name.endswith("_kernel")
        and name.split("_kernel")[0] in (
            "classic_word", "stream_probe", "stream_probe_raw", "placement", "window_keys",
            "epilogue", "epilogue_w1", "epilogue_wide", "epilogue_sorted", "epilogue_overflow",
            *D_KERNELS, "sort_upsweep",
            "sort_bases", "sort_chunk_scan", "sort_pass", *F_KERNELS, *G_KERNELS, *H_KERNELS)
    )
    f = [(ms, n) for ms, n, name in rows if name.removesuffix("_kernel") in F_KERNELS
         and name.endswith("_kernel")]
    d = [(ms, n) for ms, n, name in rows if name.removesuffix("_kernel") in D_KERNELS
         and name.endswith("_kernel")]
    g = [(ms, n) for ms, n, name in rows if name.removesuffix("_kernel") in G_KERNELS
         and name.endswith("_kernel")]
    h = [(ms, n) for ms, n, name in rows if name.removesuffix("_kernel") in H_KERNELS
         and name.endswith("_kernel")]
    ew = [(ms, n) for ms, n, name in rows if "elementwise" in name]
    sort = [(ms, n) for ms, n, name in rows if "RadixSort" in name]
    ix = [(ms, n) for ms, n, name in rows if name.startswith("index")]
    log(f"[profile] {what}: one {label} dispatch: device {dev_ms:.2f} ms of "
        f"{wall_ms:.2f} ms host-clock span (idle share "
        f"{max(0.0, 1 - dev_ms / wall_ms):.3f}); element-wise launches "
        f"x{sum(n for _, n in ew)}={sum(ms for ms, _ in ew):.2f}ms; index kernels (gathers "
        f"and scatters) x{sum(n for _, n in ix)}={sum(ms for ms, _ in ix):.3f}ms; radix sort "
        f"passes x{sum(n for _, n in sort)}={sum(ms for ms, _ in sort):.3f}ms; "
        f"kernel D x{sum(n for _, n in d)}={sum(ms for ms, _ in d):.4f}ms; "
        f"kernel F x{sum(n for _, n in f)}={sum(ms for ms, _ in f):.4f}ms; "
        f"kernel G x{sum(n for _, n in g)}={sum(ms for ms, _ in g):.4f}ms; "
        f"kernel H x{sum(n for _, n in h)}={sum(ms for ms, _ in h):.4f}ms; {host}"
        f"top kernels: {top}; "
        f"the port's own: {ours or 'none'}; {gap or 'trace complete (markers on both sides)'} on "
        f"{card}")
    ran = [f"{name} x{n}" for ms, n, name in rows
           if name in forbid or any(f in name for f in forbid_like)]
    if ran:
        raise AssertionError(f"[profile] {what}: {ran} ran in the dispatch")


# -- --compare: two checkouts in turns on one card ------------------------------

TURNS = ("other", "this", "this", "other")  # the other checkout first and last
TURN_TIMEOUT = MPROC_TIMEOUT + 600  # seconds for one turn, its [mproc] ranks included


def compare_cell(tmp: str) -> dict:
    """What --compare measures, made once with this checkout's package
    under tmp: phase 3's inputs and its classic and blocked (v4) indexes,
    the 400,000 reads packed as the reads path takes them, the reads cell's
    204,000 pairs as files with the blocked index's single-device read_id
    files, the first N_CHECK pairs as files with both indexes' read_id
    files on the CPU, and the first N_PROFILE pairs' mates."""
    import numpy as np

    man, fq, _sources = synth_inputs(tmp)
    cell = {"fq": fq}
    for name, extra in (("classic", []), ("blocked", ["--blocked"])):
        prefix = os.path.join(tmp, name)
        cli(["build", *extra, "-k", str(K), "-n", str(HASHES), "-s", str(BLOOM),
             "-b", prefix, "-r", man, "-t", "8"])
        cell[name] = prefix + ".bxi"
    _seqs, cell["L"], reads = pack_fastq(fq)
    mates, src, len1, _lower = synth_pairs(tmp)
    cell["pairs"] = write_pairs(os.path.join(tmp, "all"), mates, len1, np.arange(len(src)))
    cell["blocked_all"] = os.path.join(tmp, "blocked_all")
    read_id_bytes(cell["blocked"], cell["pairs"], cell["blocked_all"])
    cell["check"] = write_pairs(os.path.join(tmp, "check"), mates, len1, np.arange(N_CHECK))
    for name in ("classic", "blocked"):
        cell[f"{name}_check_cpu"] = os.path.join(tmp, f"{name}_check_cpu")
        read_id_bytes(cell[name], cell["check"], cell[f"{name}_check_cpu"], device="cpu")
    for key, a in (("words", reads[0]), ("lens", reads[1]), ("vbits", reads[2]),
                   ("mates", mates[:N_PROFILE]), ("src", src)):
        np.save(os.path.join(tmp, key + ".npy"), a)
    return cell


def compare_turn(root: str, tmp: str) -> int:
    """One turn of --compare (chip_smoke.py --compare-turn ROOT DIR): the
    package of the checkout at ROOT, first on sys.path, on DIR's cell:
    the parity phases of both indexes ([parity], [profile] classic and
    blocked, [profile] generic classic W 1), kernel E on both dispatches'
    sort inputs ([kernel] sort), the 1,000-accession panel built from the
    seed ([panel], [profile] generic panel W 32), search_reads and one
    order-free read_id dispatch on each
    ([reads], [profile]), the fused phase ([fused]), the read classifier
    (readid_turn_phase) and the [mproc] phase, each with its own checks.
    Prints the search_reads answers on a line of their own."""
    sys.path.insert(0, root)
    import hashlib

    import numpy as np
    import torch

    import colorid_tpu_torch
    from colorid_tpu_torch.ops import kernels
    from colorid_tpu_torch.pipelines.search import _count_query_kmers

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(colorid_tpu_torch.__file__)))
    if pkg_root != os.path.abspath(root):
        raise RuntimeError(f"the package came from {pkg_root}, not {root}")
    card = card_line() if DEVICE == "cuda" else "cpu"
    if DEVICE == "cuda":
        kernels.build_all()
    with open(os.path.join(tmp, "cell.json")) as f:
        cell = json.load(f)
    a = {key: np.load(os.path.join(tmp, key + ".npy"))
         for key in ("words", "lens", "vbits", "mates", "src")}
    dev = on_device((a["words"], a["lens"], a["vbits"]))
    strict = os.path.abspath(root) == HERE
    classic = classic_parity_phase(cell["classic"], cell["fq"], card, strict=strict)
    _seg, blocked_dispatch = blocked_parity_phase(cell["blocked"], cell["fq"], card,
                                                  strict=strict)
    sort_turn_phase(classic["stream"], blocked_dispatch, card)
    del blocked_dispatch
    panel_phase(classic, cell["classic"], {"dev": dev, "L": cell["L"]}, card, strict=strict,
                measure=False)
    del classic
    with contextlib.redirect_stderr(io.StringIO()):
        query = _count_query_kmers(cell["fq"], None, K, 15, 1, False)
    answers = {}
    for name in ("classic", "blocked"):
        got, n_u = search_reads_phase(name, cell[name], dev, cell["L"], query, a["mates"], card)
        answers[name] = [int(n_u), hashlib.sha256(
            got.counts.tobytes() + got.freq_hist.tobytes()).hexdigest()]
    fused_phase(cell["blocked"], {"dev": dev, "L": cell["L"]}, card)
    readid_turn_phase(cell, a["mates"], tempfile.mkdtemp(dir=tmp), card)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    shr = {"dev": dev[:2], "L": cell["L"], "pairs": cell["pairs"], "src": a["src"],
           "blocked_all": cell["blocked_all"]}
    turn_dir = tempfile.mkdtemp(dir=tmp)
    mproc_phase(turn_dir, cell["fq"], cell["classic"], cell["blocked"], shr, card, root=root)
    print("ANSWERS " + json.dumps(answers), flush=True)
    return 0


def readid_turn_phase(cell: dict, mates, d: str, card: str) -> None:
    """--compare's read classifier on the turn's package: kernel H's phase
    ([kernel] readid, [profile] readid replay / firsthit), then CLI read_id
    on the cell's N_CHECK pairs, byte-identical to the cell's --device cpu
    files on both indexes by the default route, with COLORID_RID_SAFE=0
    and with COLORID_RID_READS=0."""
    readid_kernel_phase(cell["classic"], cell["blocked"],
                        {"mates": mates, "check": cell["check"], "dir": d}, card)
    for name in ("classic", "blocked"):
        cpu = cell[f"{name}_check_cpu"]
        with open(cpu + "_reads.txt", "rb") as f, open(cpu + "_counts.txt", "rb") as g:
            want = (f.read(), g.read())
        for env in (None, {"COLORID_RID_SAFE": "0"}, {"COLORID_RID_READS": "0"}):
            got = read_id_bytes(cell[name], cell["check"], os.path.join(d, f"{name}_rid"),
                                env=env)
            if got[:2] != want:
                raise AssertionError(f"{name}: read_id files with {env} differ from the CPU's")
        log(f"[reads] {name}: CLI read_id _reads.txt and _counts.txt byte-identical to "
            f"--device cpu on {N_CHECK} pairs by the default route, COLORID_RID_SAFE=0 and "
            f"COLORID_RID_READS=0 on {card}")


def compare(other: str) -> int:
    """chip_smoke.py --compare OTHER_ROOT: this checkout against another
    (for example the parent commit, unpacked with git archive), in the
    turns TURNS on one card. The cell is made once (compare_cell); each turn
    is a fresh process of compare_turn with that turn's package. Every
    turn's checks must hold and its search_reads answers must be the same
    in every turn. Prints each turn's lines; no result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    other = os.path.abspath(other)
    if not os.path.isdir(os.path.join(other, "colorid_tpu_torch")):
        print(f"chip_smoke: {other} holds no colorid_tpu_torch", file=sys.stderr)
        return 2
    card = card_line()
    roots = {"this": HERE, "other": other}
    answers = []
    tmp = tempfile.mkdtemp(prefix="colorid_compare_")
    try:
        t0 = time.time()
        cell = compare_cell(tmp)
        with open(os.path.join(tmp, "cell.json"), "w") as f:
            json.dump(cell, f)
        log(f"[compare] cell made in {time.time() - t0:.1f}s; turns {list(TURNS)}; "
            f"this = {HERE}, other = {other} on {card}")
        for i, label in enumerate(TURNS, 1):
            t0 = time.time()
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--compare-turn", roots[label], tmp],
                capture_output=True, text=True, timeout=TURN_TIMEOUT, cwd=HERE)
            for line in r.stdout.splitlines():
                if line.startswith("ANSWERS "):
                    answers.append(json.loads(line[len("ANSWERS "):]))
                else:
                    log(f"[turn {i} {label}] {line}")
            if r.returncode != 0:
                print(r.stderr[-4000:], file=sys.stderr)
                return 1
            log(f"[compare] turn {i} {label} took {time.time() - t0:.1f}s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = len(answers) == len(TURNS) and all(x == answers[0] for x in answers)
    log(f"[compare] search_reads answers identical in every turn: {same}")
    return 0 if same else 1


PHASE_S: dict[str, float] = {}  # seconds per phase of this run


@contextlib.contextmanager
def phase(name: str):
    t0 = time.time()
    try:
        yield
    finally:
        PHASE_S[name] = PHASE_S.get(name, 0.0) + time.time() - t0


def main() -> int:
    if sys.argv[1:2] == ["--mproc-worker"]:
        return mproc_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--compare-turn"]:
        return compare_turn(*sys.argv[2:4])
    if sys.argv[1:2] == ["--compare"] and len(sys.argv) == 3:
        return compare(sys.argv[2])
    if sys.argv[1:]:
        print(__doc__.split("Phases,")[0], file=sys.stderr)
        return 2
    t_script = time.time()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    try:
        from colorid_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: the colorid_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2

    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    kernels.build_all()
    log(f"[card] kernels built in {time.time() - t0:.1f}s (set-up); "
        f"ptxas: {' | '.join(ptxas_summary(kernels.build_log.values()))}")
    with phase("kernel"):
        classic_row = classic_kernel_phase(card)
        probe_row = probe_kernel_phase(card)
        raw_row = raw_kernel_phase(card)
        placement_row = placement_kernel_phase(card)
        window_row = window_keys_kernel_phase(card)
    tmp = tempfile.mkdtemp(prefix="colorid_smoke_")
    try:
        with phase("main"):
            t0 = time.time()
            inputs = synth_inputs(tmp)
            log(f"[main] synthetic inputs: {N_GENOMES} x {GENOME_LEN} bp genomes, "
                f"{N_READS} x {READ_LEN} bp reads in {time.time() - t0:.1f}s")
            placement, window_keys, tail, sorted_words, gather = _new_kernels()
            placement.launches = window_keys.launches = tail.launches = 0
            sorted_words.launches = gather.launches = 0
            glue = _glue_kernels()
            for kn in glue:
                kn.launches = 0
            te = _f_modules()[0]
            f_modes = te.run_counts.launches_by_mode
            f_modes.update(dict.fromkeys(f_modes, 0))
            from colorid_tpu_torch.ops import query as qmod

            h_modes = qmod.readid_launches
            h_modes.update(dict.fromkeys(h_modes, 0))
            classic_bxi, classic_row["launches"], t_build, classic_tsv = classic_path_phase(
                tmp, inputs, card)
            blocked_bxi, probe_row["launches"] = blocked_path_phase(tmp, inputs, card)
            placement_row["launches"] = placement.launches
            window_row["launches"] = window_keys.launches
            epilogue_launches = tail.launches + sorted_words.launches
            gather_main = gather.launches
            glue_launches = {kn.__name__: kn.launches for kn in glue}
            f_main = dict(f_modes)
            g_main, g_runs_main = te.value_sort.launches, te.value_sort.runs_launches
            h_main = dict(h_modes)
        with phase("parity"):
            classic = classic_parity_phase(classic_bxi, inputs[1], card)
            probe_row["real_segment_ms"], blocked_dispatch = blocked_parity_phase(
                blocked_bxi, inputs[1], card)
        with phase("sort"):
            sort_row = sort_kernel_phase(classic["stream"], blocked_dispatch,
                                         glue_launches["sort_payloads"], card)
        with phase("epilogue"):
            epilogue_row, gather_w1 = epilogue_kernel_phase(classic, epilogue_launches, card)
        classic = {key: classic[key] for key in ("query", "result")}
        with phase("stream_tail"):
            tail_row = stream_tail_kernel_phase(blocked_dispatch, glue_launches["stream_tail"],
                                                card)
        del blocked_dispatch
        with phase("bench"):
            benched = bench_phase(tmp, classic_bxi, blocked_bxi, card)
        for row, name in ((classic_row, "classic_words"), (probe_row, "stream_probe"),
                          (placement_row, "placement"), (window_row, "window_keys")):
            row["launches"] += benched[name]
        epilogue_row["launches"] += (benched["_accumulate_tail"]
                                     + benched["_accumulate_sorted_words"])
        gather_later = gather.launches
        tail_row["launches"] += benched["stream_tail"]
        sort_row["launches"] += benched["sort_payloads"]
        tail_row["plan_launches"] = (glue_launches["stream_chunk_plan"]
                                     + benched["stream_chunk_plan"])
        f_later = dict(f_modes)
        g_later, g_runs_later = te.value_sort.launches, te.value_sort.runs_launches
        h_later = dict(h_modes)
        with phase("reads"):
            reads = reads_phase(tmp, inputs, classic_bxi, blocked_bxi, card)
        with phase("readid"):
            h_row = readid_kernel_phase(classic_bxi, blocked_bxi, reads, card)
        with phase("fused"):
            probe_row["launches"] += fused_phase(blocked_bxi, reads, card)
        with phase("run_counts"):
            counts_row = run_counts_kernel_phase(blocked_bxi, reads, card)
        with phase("value_sort"):
            g_row = value_sort_kernel_phase(blocked_bxi, reads, card)
        with phase("serve"):
            served = serve_phase(classic_bxi, blocked_bxi, reads, card)
        gather_reads = gather.launches - gather_later
        with phase("panel"):
            panel_launches, gather_w32 = panel_phase(classic, classic_bxi, reads, card)
        del classic
        # kernel C's gather mode on the main path, as its wrapper counts them
        # in [main], in the port bench's process, in [reads]..[serve] and in
        # [panel]'s three entry points
        g_parts = {"main": gather_main, "bench": benched["_accumulate_one"],
                   "reads+fused+serve": gather_reads, "panel": panel_launches}
        gather_row_ = gather_row(gather_w1, gather_w32, sum(g_parts.values()))
        log(f"[kernel] epilogue gather mode launches on the main path "
            f"{gather_row_['launches']} ({g_parts}) on {card}")
        # kernel F on the main path by mode, as its wrapper counts them in
        # [main], in the port bench's process and in [reads]..[serve]
        f_by_phase = {"main": f_main, "bench": benched["run_counts_by_mode"],
                      "reads+fused+serve": {m: f_modes[m] - f_later[m] for m in f_modes}}
        by_mode = {m: sum(c[m] for c in f_by_phase.values()) for m in f_modes}
        counts_row["launches"] = sum(by_mode.values())
        counts_row["launches_by_phase"] = {k: sum(c.values()) for k, c in f_by_phase.items()}
        counts_row["launches_by_mode"] = by_mode
        log(f"[kernel] run_counts launches on the main path {counts_row['launches']} "
            f"({f_by_phase}) on {card}")
        # kernel G on the main path, as its wrapper counts them in [main], in
        # the port bench's process and in [reads]..[serve]
        g_by_phase = {"main": g_main, "bench": benched["value_sort"],
                      "reads+fused+serve": te.value_sort.launches - g_later}
        g_row["launches"] = sum(g_by_phase.values())
        g_row["launches_by_phase"] = g_by_phase
        # with the runs hint: the merge sites' calls (the port bench's fused
        # phase runs the single route only, so none there)
        g_runs = g_runs_main + te.value_sort.runs_launches - g_runs_later
        g_row["launches_by_hint"] = {"runs hint (merge sites)": g_runs,
                                     "no hint (LSD passes)": g_row["launches"] - g_runs}
        log(f"[kernel] value_sort launches on the main path {g_row['launches']} "
            f"({g_by_phase}; {g_row['launches_by_hint']}) on {card}")
        # kernel H on the main path by mode, as its wrappers count them in
        # [main], in the port bench's process and in [reads]..[serve]
        h_by_phase = {"main": h_main, "bench": benched["readid_by_mode"],
                      "reads+fused+serve": {m: h_modes[m] - h_later[m] for m in h_modes}}
        h_row["launches_by_mode"] = {m: sum(c[m] for c in h_by_phase.values())
                                     for m in h_modes}
        h_row["launches"] = sum(h_row["launches_by_mode"].values())
        h_row["launches_by_phase"] = {k: sum(c.values()) for k, c in h_by_phase.items()}
        log(f"[kernel] readid launches on the main path {h_row['launches']} "
            f"({h_by_phase}) on {card}")
        classic_row["launches"] += served[0]
        probe_row["launches"] += served[1]
        shr = {key: reads[key] for key in ("pairs", "src", "blocked_all", "single", "L")}
        shr["dev"] = reads["dev"][:2]
        del reads
        with phase("row"):
            probe_row["launches"] += rowshard_phase(blocked_bxi, inputs[1], card)
        torch.cuda.empty_cache()
        with phase("color"):
            raw_row["launches"] = colorshard_phase(card)
        with phase("entry"):
            panel = entry_points_phase(tmp, card)
        with phase("shreads"):
            shreads_phase(blocked_bxi, shr, panel, card)
        del panel
        with phase("dist"):
            dist_phase(card)
        with phase("mproc"):
            mproc_phase(tmp, inputs[1], classic_bxi, blocked_bxi, shr, card)
        del shr
        with phase("devbuild"):
            built = devbuild_phase(tmp, inputs, (classic_bxi, t_build, classic_tsv),
                                   blocked_bxi, card)
        classic_row["launches"] += built[0]
        probe_row["launches"] += built[1]
        with phase("wide"):
            wide_phase(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("[time] " + ", ".join(f"{name} {sec:.1f}s" for name, sec in PHASE_S.items())
        + f"; whole script {time.time() - t_script:.1f}s on {card}")
    print(json.dumps({"kernels": [classic_row, probe_row, raw_row, placement_row, window_row,
                                  epilogue_row, gather_row_, tail_row, sort_row, counts_row,
                                  g_row, h_row]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
