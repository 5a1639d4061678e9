#!/usr/bin/env python3
"""Smoke run of the PyTorch port (colorid_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its lines (any failure exits non-zero):

1. card: the card's name and power limit (nvidia-smi); build every CUDA
   kernel from csrc/ (set-up time).
2. kernel: each kernel (classic_word, stream_probe, stream_probe_raw)
   against its plain PyTorch twin on the card at its main path's shapes
   (bitwise), with its time, the twin's, one PyTorch library call's where
   one computes the same function, and the least time the card could take
   (bound); stream_probe_raw also on stream_probe's inputs, as the time of
   the gather that both share.
3. main path, twice, through the port's CLI at the bench configuration's
   size (21 synthetic ~3 Mbp genomes, -k 31 -n 4 -s 50000000; search -f 1
   on 400,000 x 150 bp reads from 3 of them; search -s on one genome):
   a classic index (build) and a blocked one (build --blocked, layout v4).
   Each path's kernel must have been launched while that path ran, no
   stream batch may fall back, and the blocked TSV must be byte-identical
   with COLORID_STREAM=0.
4. parity, for each index: the same search_keys through the generic gather
   (COLORID_STREAM=0) must give an identical SearchResult; k-mers/s for
   both paths and for the device-resident dispatches, and one
   device-resident stream dispatch's device time by kernel (torch.profiler);
   the probe kernel on the inputs that the blocked dispatch hands it, against
   its twin and timed alone ("real segment").

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

Then one JSON line with the kernel table, the card line, and last
{"ok": true, "device": {...}}. Without a CUDA card, or outside a checkout
of the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
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


# -- phase 3: the main paths through the CLI ----------------------------------


def synth_inputs(tmp: str):
    """21 random genomes (fasta) + a manifest + a .fastq.gz of reads drawn
    from the first N_SOURCES genomes, half reverse-complemented, with
    SUB_RATE random substitutions. All from one numpy seed."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, dtype=np.uint8)
    comp[acgt] = np.frombuffer(b"TGCA", dtype=np.uint8)
    genomes, manifest = [], []
    for i in range(N_GENOMES):
        g = acgt[rng.integers(0, 4, GENOME_LEN)]
        genomes.append(g)
        path = os.path.join(tmp, f"genome{i:02d}.fasta")
        lines = g[: GENOME_LEN // 80 * 80].reshape(-1, 80)
        body = np.concatenate(
            [lines, np.full((lines.shape[0], 1), ord("\n"), dtype=np.uint8)], axis=1
        ).tobytes()
        with open(path, "wb") as f:
            f.write(f">genome{i:02d}\n".encode() + body + g[GENOME_LEN // 80 * 80:].tobytes() + b"\n")
        manifest.append(f"genome{i:02d}\t{path}\n")
    man = os.path.join(tmp, "refs.txt")
    with open(man, "w") as f:
        f.writelines(manifest)
    src = rng.integers(0, N_SOURCES, N_READS)
    starts = rng.integers(0, GENOME_LEN - READ_LEN, N_READS)
    stack = np.stack(genomes[:N_SOURCES])
    reads = stack[src[:, None], starts[:, None] + np.arange(READ_LEN)]
    rc = rng.random(N_READS) < 0.5
    reads[rc] = comp[reads[rc][:, ::-1]]
    sub = rng.random(reads.shape) < SUB_RATE
    reads[sub] = acgt[rng.integers(0, 4, int(sub.sum()))]
    qual = "I" * READ_LEN
    fq = os.path.join(tmp, "reads.fastq.gz")
    seqs = reads.tobytes().decode()
    with gzip.open(fq, "wt", compresslevel=1) as f:
        f.write("".join(
            f"@read{j}\n{seqs[j * READ_LEN:(j + 1) * READ_LEN]}\n+\n{qual}\n"
            for j in range(N_READS)
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


def _searches(tmp: str, bxi: str, fq: str):
    """search -f 1 on the reads and search -s on one genome, timed."""
    t0 = time.time()
    tsv = cli(["search", "-b", bxi, "-q", fq, "-f", "1", "--device", DEVICE])
    t_search = time.time() - t0
    t0 = time.time()
    perfect = cli(["search", "-b", bxi, "-s", "--device", DEVICE,
                   "-q", os.path.join(tmp, "genome01.fasta")])
    return tsv, perfect, t_search, time.time() - t0


def classic_path_phase(tmp: str, inputs, card: str):
    """build -> search over a classic index; returns (index file, launches
    of the classic word kernel while the path ran)."""
    from colorid_tpu_torch.engine import QueryEngine
    from colorid_tpu_torch.ops import stream_query as sq

    man, fq, sources = inputs
    prefix = os.path.join(tmp, "panel")
    # observe every classic stream batch: None means its residual capacity
    # tripped and search_keys re-ran it through the generic gather
    outcomes = []
    stream_fn = QueryEngine._search_keys_classic_stream

    def observed(self, *a, **kw):
        res = stream_fn(self, *a, **kw)
        outcomes.append(res is not None)
        return res

    QueryEngine._search_keys_classic_stream = observed
    sq.classic_words.launches = 0
    try:
        t0 = time.time()
        cli(["build", "-k", str(K), "-n", str(HASHES), "-s", str(BLOOM),
             "-b", prefix, "-r", man, "-t", "8"])
        t_build = time.time() - t0
        tsv, perfect, t_search, t_perfect = _searches(tmp, prefix + ".bxi", fq)
    finally:
        QueryEngine._search_keys_classic_stream = stream_fn
    launches = sq.classic_words.launches
    rows = _check_tsv(tsv, perfect, sources, "classic")
    log(f"[main] classic: build {t_build:.1f}s; search -f 1 {t_search:.1f}s "
        f"({rows[0][1]} k-mers); search -s {t_perfect:.1f}s; "
        f"classic_word launches={launches}; stream batches={len(outcomes)} "
        f"fallbacks={outcomes.count(False)} on {card}")
    if (DEVICE == "cuda" and launches == 0) or len(outcomes) < 2 or not all(outcomes):
        raise AssertionError(
            "the main path did not run every search through the classic kernel "
            f"(launches={launches}, stream outcomes={outcomes})"
        )
    return prefix + ".bxi", launches


def blocked_path_phase(tmp: str, inputs, card: str):
    """build --blocked -> search over the blocked (v4) index; returns
    (index file, launches of the probe kernel while the path ran)."""
    from colorid_tpu_torch.index.bigsi import BigsiIndex
    from colorid_tpu_torch.ops import stream_query as sq

    man, fq, sources = inputs
    prefix = os.path.join(tmp, "turbo")
    # observe every streamed segment: its size and its n_drop (nonzero means
    # search_keys re-ran the query through the generic gather)
    segments = []
    stream_fn = sq.stream_accumulate_hash

    def observed(*a, **kw):
        out = stream_fn(*a, **kw)
        segments.append((a[5].shape[0], out[4]))
        return out

    sq.stream_accumulate_hash = observed
    sq.stream_probe.launches = 0
    try:
        t0 = time.time()
        cli(["build", "--blocked", "-k", str(K), "-n", str(HASHES), "-s", str(BLOOM),
             "-b", prefix, "-r", man, "-t", "8"])
        t_build = time.time() - t0
        tsv, perfect, t_search, t_perfect = _searches(tmp, prefix + ".bxi", fq)
    finally:
        sq.stream_accumulate_hash = stream_fn
    launches = sq.stream_probe.launches
    sizes = [n for n, _ in segments]
    n_drop = sum(int(nd) for _, nd in segments)
    index = BigsiIndex.load(prefix + ".bxi")
    rows = _check_tsv(tsv, perfect, sources, "blocked")
    log(f"[main] blocked: layout v{index.blocked}, bloom {index.bloom_size}; "
        f"build --blocked {t_build:.1f}s; search -f 1 {t_search:.1f}s "
        f"({rows[0][1]} k-mers); search -s {t_perfect:.1f}s; stream_probe "
        f"launches={launches}; streamed segments={sizes} n_drop={n_drop} on {card}")
    if index.blocked != 4:
        raise AssertionError(f"build --blocked chose layout {index.blocked}, not v4")
    if len(segments) < 2 or n_drop or (DEVICE == "cuda" and launches < 2):
        raise AssertionError(
            "the blocked main path did not run every search through the probe "
            f"kernel (launches={launches}, segments={sizes}, n_drop={n_drop})"
        )
    # the same searches with the stream off: byte-identical TSV
    os.environ["COLORID_STREAM"] = "0"
    try:
        tsv0, perfect0, _, _ = _searches(tmp, prefix + ".bxi", fq)
    finally:
        os.environ.pop("COLORID_STREAM")
    if tsv0 != tsv or perfect0 != perfect or sq.stream_probe.launches != launches:
        raise AssertionError("COLORID_STREAM=0 changed the blocked search's TSV")
    log("[main] blocked: TSV byte-identical with COLORID_STREAM=0")
    return prefix + ".bxi", launches


# -- phase 4: stream vs generic parity and rates ----------------------------


def same_result(a, b) -> bool:
    import numpy as np

    return (
        np.array_equal(a.counts, b.counts)
        and np.array_equal(a.and_all, b.and_all)
        and a.all_valid == b.all_valid
        and np.array_equal(a.freq_hist, b.freq_hist)
        and a.freq_stats() == b.freq_stats()
        and sorted(zip(a.over_colors.tolist(), a.over_freqs.tolist()))
        == sorted(zip(b.over_colors.tolist(), b.over_freqs.tolist()))
    )


def classic_parity_phase(bxi: str, fq: str, card: str) -> None:
    import numpy as np
    import torch

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
    if DEVICE == "cuda":
        profile_dispatch(
            lambda: stream_eng.search_keys_dev_classic_async(pk_dev, qc_dev, K)[0],
            "classic", card,
        )


def blocked_parity_phase(bxi: str, fq: str, card: str):
    """The blocked index: search_keys with the probe stream against the
    generic gather, the two device-resident dispatches against both, their
    rates, and the profile of one device-resident stream dispatch. On the
    card also the probe kernel on the real segment's inputs (see
    real_segment); returns its ms there, or None on the CPU."""
    import numpy as np
    import torch

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
        return None
    profile_dispatch(lambda: dispatches["stream"]()[0], "blocked", card)
    return real_segment(dispatches["stream"], card)


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


# -- phase 5: the sharded paths on a logical mesh -----------------------------

WIDE_COLORS, WIDE_ROWS, WIDE_SHARDS, WIDE_HASHES = 4096, 4_194_304, 4, 2
WIDE_KMERS = 1 << 24
PANEL_GENOMES, PANEL_LEN, PANEL_BLOOM, PANEL_READS = 1200, 50_000, 2_000_000, 20_000


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
    4 bits each, 6 % of the rows absent. Made in row slabs to bound host
    memory."""
    import numpy as np

    from colorid_tpu_torch import convert
    from colorid_tpu_torch.ops.blocked import rows_per_block
    from colorid_tpu_torch.ops.query import row_wpad

    rng = np.random.default_rng(SEED + 3)
    W = WIDE_COLORS // 32
    place = rows_per_block(row_wpad(W // WIDE_SHARDS))
    matrix = np.empty((WIDE_ROWS, W), dtype=np.uint32)
    slab = min(1 << 19, WIDE_ROWS)
    for a in range(0, WIDE_ROWS, slab):
        w = rng.integers(0, 2**32, (3, slab, W), dtype=np.uint32)
        live = rng.integers(0, 5, (slab, W), dtype=np.uint8) == 0
        matrix[a:a + slab] = np.where(live, w[0] & w[1] & w[2], np.uint32(0))
    matrix[rng.integers(0, WIDE_ROWS, WIDE_ROWS // 16)] = 0
    names = [f"c{i}" for i in range(WIDE_COLORS)]
    return convert.index_from_arrays(
        matrix, bloom_size=WIDE_ROWS, num_hash=WIDE_HASHES, k_size=K, colors=names,
        n_ref_kmers={n: 100 for n in names}, blocked=4, place_rpb=place,
    )


def wide_query():
    """WIDE_KMERS distinct canonical 31-mers as ASCII rows with
    frequencies, 0.2 % of them >= 1024. Canonical values have the density
    that the v4 block map flattens: 16 probes per block here."""
    import numpy as np

    rng = np.random.default_rng(SEED + 4)
    v = rng.integers(0, 4**K, WIDE_KMERS + (1 << 16), dtype=np.uint64)
    x = ~v & np.uint64(4**K - 1)
    rc = np.zeros_like(x)
    for _ in range(K):
        rc = (rc << np.uint64(2)) | (x & np.uint64(3))
        x >>= np.uint64(2)
    vals = rng.permutation(np.unique(np.minimum(v, rc)))[:WIDE_KMERS]
    if vals.shape[0] != WIDE_KMERS:
        raise AssertionError("too few distinct k-mers drawn")
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    keys = np.empty((WIDE_KMERS, K), dtype=np.uint8)
    for i in range(K):
        keys[:, i] = acgt[((vals >> np.uint64(2 * (K - 1 - i))) & np.uint64(3)).astype(np.intp)]
    qc = rng.integers(1, 60, WIDE_KMERS).astype(np.int32)
    big = rng.random(WIDE_KMERS) < 0.002
    qc[big] = rng.integers(1024, 50_000, int(big.sum()))
    return keys, qc


def colorshard_phase(card: str) -> int:
    """The color-sharded path at full width; returns the raw kernel's
    launches while ShardedQueryEngine.search_keys ran."""
    import numpy as np
    import torch

    from colorid_tpu_torch import QueryEngine, ShardedQueryEngine
    from colorid_tpu_torch.ops import stream_query as sq
    from colorid_tpu_torch.ops.blocked import pack_keys_u64, v3_block_offsets
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

    # observe the stream's outcome: None means n_drop > 0 (a generic rerun)
    outcomes = []
    finish = eng._stream_colorshard_finish

    def observed(*a):
        res = finish(*a)
        outcomes.append(res is not None)
        return res

    eng._stream_colorshard_finish = observed
    sq.stream_probe_raw.launches = 0
    sync()
    t0 = time.time()
    res_stream = eng.search_keys(keys, qcounts=qc)
    sync()
    t_stream = time.time() - t0
    launches = sq.stream_probe_raw.launches
    eng._stream_colorshard_finish = finish
    if outcomes != [True] or (DEVICE == "cuda" and launches != WIDE_SHARDS):
        raise AssertionError(
            f"the color-sharded search did not take the stream (outcomes={outcomes}, "
            f"stream_probe_raw launches={launches}, want {WIDE_SHARDS})")

    # where one streamed search spends its time: the host steps of
    # _try_stream_keys, then the dispatch (H2D, 4 shards, the fetch)
    t0 = time.time()
    vals = pack_keys_u64(keys)
    t_pack = time.time() - t0
    t0 = time.time()
    blk, offs = v3_block_offsets(vals, K, WIDE_HASHES, index.bloom_size, eng.rpb, version=4)
    offp = offs[:, 0].astype(np.uint32) | (offs[:, 1].astype(np.uint32) << np.uint32(8))
    t_place = time.time() - t0
    t0 = time.time()
    order = np.argsort(blk, kind="stable")
    blk_s, offp_s, qc_s = blk[order].astype(np.int32), offp[order], qc[order]
    t_sort = time.time() - t0
    blk2d = blk_s.reshape(-1, sq.PC)
    tb = np.clip(blk2d[:, 0] // 128, 0, index.bloom_size // eng.rpb // 128 - 2)
    outside = blk2d - tb[:, None] * 128 >= 256
    sync()
    t0 = time.time()
    res_again = finish(blk_s, offp_s, qc_s, WIDE_HASHES, eng.rpb)
    sync()
    t_dispatch = time.time() - t0
    if res_again is None or not same_answers(res_again, res_stream):
        raise AssertionError("the timed dispatch differs from the search")
    log(f"[color] one streamed search of {n} k-mers: host pack {t_pack:.2f}s, placement "
        f"{t_place:.2f}s, argsort+gather {t_sort:.2f}s, dispatch+assembly {t_dispatch:.2f}s "
        f"(of {t_stream:.2f}s through search_keys); residual probes "
        f"{int(outside.sum())} in {int(outside.any(axis=1).sum())} of {blk2d.shape[0]} "
        f"chunks (capacity {sq._nch(eng.wpad)}), n_drop 0 on {card}")
    if DEVICE == "cuda":
        profile_dispatch(
            lambda: finish(blk_s, offp_s, qc_s, WIDE_HASHES, eng.rpb), "color", card)
    del vals, blk, offs, offp, order, blk_s, offp_s, qc_s, blk2d, outside

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


def entry_points_phase(tmp: str, card: str) -> None:
    """build --blocked --color-shards 4 -> search through the CLI, and the
    sharded engine on the loaded index: the same report lines."""
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


def ptxas_summary(logs) -> list[str]:
    """One entry per compiled kernel instance from nvcc's -Xptxas -v
    reports: its name with template arguments (stream_probe_kernel<1,4> is
    W = 1, H = 4), registers, static shared memory and spills."""
    import re

    out, name, spill = [], None, ""
    for line in (l for log in logs for l in log.splitlines()):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # the identifier runs from the last digit of its length prefix
            k = re.search(r"([A-Za-z_]+_kernel)(?:I((?:Li-?\d+E)+)E)?", m.group(1))
            vals = re.findall(r"Li(-?\d+)E", k.group(2) or "") if k else []
            name = (k.group(1) + (f"<{','.join(vals)}>" if vals else "")) if k else m.group(1)
        elif "spill" in line:
            spill = "no spills" if re.search(r"\b0 bytes spill stores, 0 bytes spill loads",
                                             line) else line.strip()
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name} {regs.group(1) if regs else '?'} registers "
                       f"{smem.group(1) if smem else 0} B smem {spill}")
            name, spill = None, ""
    return out


def profile_dispatch(fn, what: str, card: str) -> None:
    """Where one stream dispatch spends its device time:
    torch.profiler's per-kernel device totals, and the device's idle share
    of the dispatch's host-clock span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # device kernels only (the aten ops that launched them repeat their
    # time), grouped by the kernel's name without namespace or template
    by_name: dict[str, list] = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        key = e.key.removeprefix("void ").replace("(anonymous namespace)::", "")
        name = key.split("<")[0].split("(")[0].split("::")[-1].strip() or e.key[:40]
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += us / 1e3
        acc[1] += e.count
    if not by_name:
        log(f"[profile] {what}: no device time in the trace: not measured on {card}")
        return
    rows = sorted(((ms, n, name) for name, (ms, n) in by_name.items()), reverse=True)
    dev_ms = sum(ms for ms, _, _ in rows)
    top = "; ".join(f"{name} x{n}={ms:.2f}ms" for ms, n, name in rows[:8])
    ours = "; ".join(
        f"{name} x{n}={ms:.3f}ms" for ms, n, name in rows if name.endswith("_kernel")
        and name.split("_kernel")[0] in ("classic_word", "stream_probe", "stream_probe_raw")
    )
    log(f"[profile] {what}: one stream dispatch: device {dev_ms:.2f} ms of "
        f"{wall_ms:.2f} ms host-clock span (idle share "
        f"{max(0.0, 1 - dev_ms / wall_ms):.3f}); top kernels: {top}; "
        f"the port's own: {ours or 'none'} on {card}")


def main() -> int:
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
    classic_row = classic_kernel_phase(card)
    probe_row = probe_kernel_phase(card)
    raw_row = raw_kernel_phase(card)
    tmp = tempfile.mkdtemp(prefix="colorid_smoke_")
    try:
        t0 = time.time()
        inputs = synth_inputs(tmp)
        log(f"[main] synthetic inputs: {N_GENOMES} x {GENOME_LEN} bp genomes, "
            f"{N_READS} x {READ_LEN} bp reads in {time.time() - t0:.1f}s")
        classic_bxi, classic_row["launches"] = classic_path_phase(tmp, inputs, card)
        blocked_bxi, probe_row["launches"] = blocked_path_phase(tmp, inputs, card)
        classic_parity_phase(classic_bxi, inputs[1], card)
        probe_row["real_segment_ms"] = blocked_parity_phase(blocked_bxi, inputs[1], card)
        probe_row["launches"] += rowshard_phase(blocked_bxi, inputs[1], card)
        torch.cuda.empty_cache()
        raw_row["launches"] = colorshard_phase(card)
        entry_points_phase(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"kernels": [classic_row, probe_row, raw_row]}))
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
