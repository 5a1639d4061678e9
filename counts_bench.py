"""Kernel F (colorid_tpu_torch/csrc/run_counts.cu, the reads routes' run
counts, -f filter and compactions) alone on the card, at the shape of
chip_smoke.py's [fused] cell, on seeded synthetic keys:

- 400,000 reads x 130 windows (52,000,000 slots), 48,000,000 of them drawn
  from 9,500,000 distinct signed keys (the cell's three 3 Mbp genomes at
  about 5x, each k-mer a run of 1 and up), the other 4,000,000 SENT (windows
  past a read's 150 bases), sorted;
- pairs: the single route's select mode at -f 1 (one round, P padded with
  SENT to a multiple of 4,096);
- counts and partition: chunk A (select mode, no filter) and A2 of the
  chunked route (its two chunks of 26,000,000; the cap the engine takes: a
  power of two over the chunk's live count);
- totals: the merge's select mode with weights over both chunks' compacted
  streams, -f 1;
- compact: the counted route's extract_count at -f 1 on all 52,000,000.

Each call prints one JSON line: F's device time a call (a torch.profiler
trace of 5 calls between two markers, chip_smoke.py::trace: the calls'
kernels and memsets, whatever their names in the checkout timed, summed
and apart, and whether the trace kept markers on both sides of its
calls), the span of
20 calls by CUDA events, the host clock one call takes to enqueue on an
idle card (median of 20), the byte bound (chip_smoke.py::run_counts_bytes)
and a digest of the outputs (equal across checkouts when both are right). The card's name
and power limit and the kernel library's ptxas report come first:

    python3 counts_bench.py [--root DIR]

DIR: another checkout whose colorid_tpu_torch to time (the parent, or a
copy with a candidate's csrc/run_counts.cu, for turns in one call; outputs
equal by digest across them). Exits 2 without a card."""

import hashlib
import json
import os
import sys

import chip_smoke as cs

SEED = 2026
R, NW, VALID, DISTINCT = 400_000, 130, 120, 9_500_000
REPS = 20


def cell_keys(torch, dev):
    """The sorted keys of the cell's 52,000,000 windows, int64 [P]."""
    from colorid_tpu_torch.ops.extract import SENT_KEY

    g = torch.Generator(device=dev).manual_seed(SEED)
    pool = torch.randint(-(2**62), 2**62, (DISTINCT,), generator=g, device=dev)
    n = R * VALID
    keys = pool[torch.randint(0, DISTINCT, (n,), generator=g, device=dev)]
    keys = torch.cat([keys, torch.full((R * NW - n,), SENT_KEY, device=dev)])
    return torch.sort(keys).values


def calls(torch, s):
    """(the route's call, the call, its arguments for the bound) of each of
    chip_smoke.F_CALLS on the cell's keys s."""
    from colorid_tpu_torch.ops.extract import SENT_KEY, run_counts

    P = s.numel()
    pad = (-P) % 4096
    sp = torch.cat([s, s.new_full((pad,), SENT_KEY)])
    # two chunks of the reads, each over the whole key range
    half = P // 2
    g = torch.Generator(device=s.device).manual_seed(SEED + 1)
    perm = torch.randperm(P, generator=g, device=s.device)
    counted = [run_counts(torch.sort(s[perm[i * half:(i + 1) * half]]).values, mode="select")
               for i in range(2)]
    chunk, qc = counted[0][:2]
    cap = min(1 << max(20, max(int(c[2]) for c in counted).bit_length()), half)
    comps = [run_counts(c[0], c[1], mode="partition", cap=cap) for c in counted]
    ms, perm = torch.sort(torch.cat([c[0] for c in comps]))
    mq = torch.cat([c[1] for c in comps])[perm].contiguous()
    return [
        ("pairs", lambda: run_counts(sp, mode="select", filter_t=1, rounds=1),
         dict(P=sp.numel(), mode="select", rounds=1)),
        ("counts", lambda: run_counts(chunk, mode="select"), dict(P=half, mode="select")),
        ("partition", lambda: run_counts(chunk, qc, mode="partition", cap=cap),
         dict(P=half, mode="partition", cap=cap)),
        ("totals", lambda: run_counts(ms, mq, mode="select", filter_t=1),
         dict(P=ms.numel(), mode="select", weights=True)),
        ("compact", lambda: run_counts(s, mode="compact", filter_t=1),
         dict(P=P, mode="compact")),
    ]


def main(argv) -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    if argv[:1] == ["--root"] and len(argv) == 2:
        root = os.path.abspath(argv[1])
    elif argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("counts_bench: no CUDA card", file=sys.stderr)
        return 2
    from colorid_tpu_torch.ops import kernels

    print(f"card: {cs.card_line()} ({root})", flush=True)
    print(f"build {kernels.build_all():.1f}s", flush=True)
    for line in kernels.build_log.get("run_counts.cu", "").splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print("ptxas " + line.strip(), flush=True)
    dev = torch.device("cuda")
    s = cell_keys(torch, dev)
    for name, call, bound_args in calls(torch, s):
        out = call()
        torch.cuda.synchronize()
        digest = hashlib.sha256(b"".join(x.cpu().numpy().tobytes() for x in out)).hexdigest()
        span = cs.cuda_ms(call, REPS)
        host_us = cs.enqueue_us(call, REPS)[0]
        prof, _ms, gap = cs.trace(call, 5)
        by = {k: [t / 5, n / 5] for k, (t, n) in cs.device_times(prof).items()}
        n_bytes = cs.run_counts_bytes(**bound_args)
        print(json.dumps({
            "call": name, "mode": bound_args["mode"], "P": bound_args["P"], "n": int(out[2]),
            "kernel_f_ms": round(sum(v[0] for v in by.values()), 4),
            "kernel_f_launches": sum(v[1] for v in by.values()),
            "bound_ms": round(n_bytes / cs.HBM_BYTES_PER_S * 1e3, 4),
            "span_ms": round(span, 4),
            "kernels_ms": {k: [round(v[0], 4), v[1]] for k, v in sorted(by.items())},
            "host_enqueue_us": round(host_us, 1), "digest": digest[:16],
            "trace": gap or "complete",
        }), flush=True)
        del out
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
