"""Kernel H (colorid_tpu_torch/csrc/readid.cu, the read classifier's
dispatches) alone on the card, at the shapes of chip_smoke.py's [reads]
cell, on seeded synthetic inputs:

- an index of 50,000,000 rows (the cell's -s), classic (one int32 word a
  row) and blocked v4 (390,625 blocks of 128 rows), C 21 (matrix below:
  the reads' three source genomes placed k-mer by k-mer, 18 more colors
  at random);
- the order-free mode on 8,192 pairs of 2 x 150 bp mates packed at 160
  (2,129,920 window keys, 10 SENT of 130 a mate), cut from seeded places
  of one seeded genome of 3 x 3 Mbp, half of them reverse-complemented
  (chip_smoke.synth_window_keys);
- the replay (B 3) and the first hit on the first 5,000 of those reads:
  every window's rows (kernel A), its read, and a seeded rank in 0..259
  within the read as its position (PAD_POS for SENT windows), in read
  order, as the reads route lays them out.

Mode "gather" (not run by default) is a probe of the card's memory
system, not of H: torch.take of the matrix words that the order-free
mode's H rows of every valid window address, in the kernel's order (one
random 32-byte sector each), the same indices sorted, and the same indices
folded into the first 32 MB of the matrix (L2-resident), each with its
rate in sectors a second.

Each mode prints one JSON line: H's device time a call (a torch.profiler
trace of 5 calls between markers, chip_smoke.py::trace: every kernel of
the call, summed and apart), the span of 20 calls by CUDA events, the
byte bound (chip_smoke.py::_orderfree_bound and _exact_bound) and a digest of the output (equal
across checkouts when both are right). The card's name and power limit and
the kernel library's ptxas report (chip_smoke.readid_registers) come
first:

    python3 readid_bench.py [--root DIR] [--modes orderfree,replay,firsthit,gather]

DIR: another checkout whose colorid_tpu_torch to time (the parent, or a
copy with a candidate's csrc/readid.cu, for turns in one call); --modes:
the modes to time (orderfree, replay and firsthit by default). Exits 2
without a card."""

import hashlib
import json
import os
import sys

import chip_smoke as cs

SEED = 2026
PAIRS, REPLAY_READS, B = 8192, 5000, 3
BLOOM, C = 50_000_000, 21
REPS = 20


def matrix(torch, dev, rpb: int):
    """blocks2 int32 [Rb, 128] of an index like the cell's, classic (rpb 0)
    or v4: colors 0-2 the reads' source genomes (chip_smoke.
    synth_window_keys' genome in thirds), every k-mer of each set at its H
    rows; colors 3-20 other genomes, each bit set in 21 % of the rows at
    random (a 3 Mbp genome's fill of 50,000,000 rows at H 4). A read's
    present k-mers hit its genome's color, and 1.4 % of the rows are
    zero."""
    from colorid_tpu_torch.ops.extract import SENT_KEY, window_keys
    from colorid_tpu_torch.ops.hash_torch import device_rows

    g = torch.Generator(device=dev).manual_seed(SEED)  # synth_window_keys' genome
    genome = torch.randint(0, 4, (cs.N_SOURCES * cs.GENOME_LEN,), generator=g, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    w = torch.zeros(BLOOM, dtype=torch.int32, device=dev)
    for c in range(cs.N_SOURCES, C):
        w |= (torch.rand(BLOOM, generator=g, device=dev) < 0.21).to(torch.int32) << c
    L, NW = 160, 160 - 31 + 1
    shifts = 2 * (15 - torch.arange(16, device=dev))
    for c in range(cs.N_SOURCES):  # every k-mer of genome c: chunks of L bases, NW apart
        part = genome[c * cs.GENOME_LEN:(c + 1) * cs.GENOME_LEN]
        starts = torch.arange(0, part.numel() - L + 1, NW, device=dev)
        codes = part[starts[:, None] + torch.arange(L, device=dev)]
        words = (codes.view(-1, L // 16, 16) << shifts).sum(-1)
        words = (words - ((words >> 31) << 32)).to(torch.int32)
        lens = torch.full((starts.numel(),), L, dtype=torch.int32, device=dev)
        keys = window_keys(words, lens, k=31, L=L).reshape(-1)
        rows = device_rows(keys[keys != SENT_KEY], k=31, num_hash=4, bloom_size=BLOOM,
                           rpb=rpb, version=4)
        at = cs._readid_starts(rows, rpb, 1)
        w[at] |= 1 << c
    return w.view(-1, 128)


def inputs(torch, dev, rpb: int):
    """(order-free keys int64 [PAIRS, 260], the replay's (rows, seg, pos))."""
    from colorid_tpu_torch.ops.extract import SENT_KEY
    from colorid_tpu_torch.ops.hash_torch import device_rows
    from colorid_tpu_torch.ops.query import PAD_POS

    keys = cs.synth_window_keys(PAIRS * 260, 31, dev, SEED).view(PAIRS, 260)
    sub = keys[:REPLAY_READS].reshape(-1)
    rows = device_rows(sub, k=31, num_hash=4, bloom_size=BLOOM, rpb=rpb, version=4)
    seg = torch.arange(REPLAY_READS, device=dev, dtype=torch.int32).repeat_interleave(260)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    rank = torch.argsort(torch.rand(REPLAY_READS, 260, generator=g, device=dev), dim=1)
    pos = torch.where(sub == SENT_KEY, PAD_POS, rank.reshape(-1)).to(torch.int32)
    return keys.contiguous(), (rows, seg, pos)


def gather_probe(torch, b2, keys, rpb: int) -> dict:
    """ms of torch.take over the words of the H rows of every valid window
    key (as kernel H's order-free mode addresses them): in the keys' order,
    sorted, and folded into the matrix's first 2^23 words (32 MB)."""
    from colorid_tpu_torch.ops.extract import SENT_KEY
    from colorid_tpu_torch.ops.hash_torch import device_rows

    flat = keys.reshape(-1)
    rows = device_rows(flat[flat != SENT_KEY], k=31, num_hash=4, bloom_size=BLOOM, rpb=rpb,
                       version=4)
    idx = cs._readid_starts(rows, rpb, 1)
    words = b2.reshape(-1)
    out = {"sectors": idx.numel()}
    for name, ix in (("random", idx), ("sorted", idx.sort().values),
                     ("l2_resident", idx & ((1 << 23) - 1))):
        ms = cs.cuda_ms(lambda: torch.take(words, ix), REPS)
        out[name] = {"ms": round(ms, 4), "g_sectors_per_s": round(idx.numel() / ms / 1e6, 2)}
    return out


def main(argv) -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    modes = ("orderfree", "replay", "firsthit")
    opts = dict(zip(argv[::2], argv[1::2]))
    if len(argv) % 2 or set(opts) - {"--root", "--modes"}:
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(opts.get("--root", root))
    modes = tuple(opts.get("--modes", ",".join(modes)).split(","))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("readid_bench: no CUDA card", file=sys.stderr)
        return 2
    from colorid_tpu_torch.ops import kernels
    from colorid_tpu_torch.ops import query as q

    print(f"card: {cs.card_line()} ({root})", flush=True)
    print(f"build {kernels.build_all():.1f}s", flush=True)
    print("ptxas " + " | ".join(cs.readid_registers(kernels.build_log.get("readid.cu", ""))),
          flush=True)
    dev = torch.device("cuda")
    for name, rpb in (("classic", 0), ("v4", 128)):
        b2 = matrix(torch, dev, rpb)
        keys, (rows, seg, pos) = inputs(torch, dev, rpb)
        of = dict(num_colors=C, wpad=1, k=31, num_hash=4, bloom_size=BLOOM, rpb=rpb, bv=4)
        ekw = dict(num_reads=REPLAY_READS, start_sample=B, num_colors=C, wpad=1, rpb=rpb)
        exact_bound = cs._exact_bound(rows, pos, ekw)
        calls = [
            ("orderfree", lambda: q.readid_orderfree(keys, b2, **of),
             cs._orderfree_bound(keys, of, None)[0]),
            ("replay", lambda: q.readid_exact(b2, rows, seg, pos, **ekw), exact_bound),
            ("firsthit", lambda: q.readid_exact(b2, rows, seg, pos, **ekw, firsthit=True),
             exact_bound),
        ]
        if "gather" in modes:
            print(json.dumps({"index": name, "mode": "gather",
                              **gather_probe(torch, b2, keys, rpb)}), flush=True)
        for mode, call, bound_ms in calls:
            if mode not in modes:
                continue
            out = call()
            torch.cuda.synchronize()
            digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
            span = cs.cuda_ms(call, REPS)
            prof, _ms, gap = cs.trace(call, 5)
            by = {k: [t / 5, n / 5] for k, (t, n) in cs.device_times(prof).items()}
            print(json.dumps({
                "index": name, "mode": mode,
                "kernel_h_ms": round(sum(v[0] for v in by.values()), 4),
                "span_ms": round(span, 4),
                "bound_ms": round(bound_ms, 4),
                "kernels_ms": {k: [round(v[0], 4), v[1]] for k, v in sorted(by.items())},
                "digest": digest[:16], "trace": gap or "complete",
            }), flush=True)
        del b2, keys, rows, seg, pos
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
