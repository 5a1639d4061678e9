"""Kernel E (colorid_tpu_torch/csrc/radix_sort.cu, the streams' key sort
with its payloads) alone on the card, at the shapes of chip_smoke.py's
main cell, on seeded synthetic keys with that cell's skew:

- blocked: 9,437,184 probes, the key block << 11 | frequency of 30 bits
  (blocks uniform below 390,625, frequencies 1 + a geometric draw), one
  int32 operand (the packed offsets); 960,000 of them one padding key;
- classic: 34,603,008 rows below 50,000,000 (26 bits), the index widened
  to int64; 4 padding rows of 92,437 probes each;
- wide: the blocked batch's blocks times 3 (21 bits, past 2^20 blocks)
  with the offsets, the frequencies and the index.

Each case is checked bitwise against torch.sort(stable) with the operands
gathered through its permutation, timed with CUDA events (mean of 20
calls) beside that library call, and its device time split by launch
(torch.profiler, in launch order). One JSON line per case, the card's
name and power limit and the kernel library's ptxas report first:

    python3 sort_bench.py [--root DIR]

DIR: another checkout whose colorid_tpu_torch to time (the parent, for
turns in one call). Exits 2 without a card."""

import json
import os
import sys

import chip_smoke as cs

SEED = 2026
P_BLOCKED, P_CLASSIC = 9_437_184, 34_603_008
N_BLOCKS, BLOOM = 390_625, 50_000_000
PAD_BLOCKED, PAD_ROWS, PAD_PER_ROW = 960_000, 4, 92_437
REPS = 20


def cases(torch, dev):
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand(P, lo, hi):
        return torch.randint(lo, hi, (P,), generator=g, device=dev, dtype=torch.int32)

    blk = rand(P_BLOCKED, 0, N_BLOCKS)
    u = torch.rand(P_BLOCKED, generator=g, device=dev).clamp_min(1e-9)
    freq = (1 + torch.floor(torch.log(u) / torch.log(torch.tensor(0.5, device=dev)))).clamp(
        max=2047).to(torch.int32)
    key = (blk << 11) | freq
    key[torch.randperm(P_BLOCKED, generator=g, device=dev)[:PAD_BLOCKED]] = int(key[0])
    offp = rand(P_BLOCKED, -(2**31), 2**31 - 1)
    rows = rand(P_CLASSIC, 0, BLOOM)
    hot = torch.randperm(P_CLASSIC, generator=g, device=dev)[:PAD_ROWS * PAD_PER_ROW]
    rows[hot] = rand(PAD_ROWS, 0, BLOOM).repeat_interleave(PAD_PER_ROW)
    wide = ((key >> 11) * 3).contiguous()
    return [
        ("blocked", key, 30, (offp,), {}),
        ("classic", rows, 26, (), dict(index=True, index64=True)),
        ("wide", wide, 21, (offp, (key & 2047).contiguous()), dict(index=True, base=7_000_000)),
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
        print("sort_bench: no CUDA card", file=sys.stderr)
        return 2
    from colorid_tpu_torch.ops import kernels
    from colorid_tpu_torch.ops import stream_query as sq

    name = cs.card_line()
    print(f"card: {name} ({root})", flush=True)
    print(f"build {kernels.build_all():.1f}s", flush=True)
    for line in kernels.build_log.get("radix_sort.cu", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas:", line.strip(), flush=True)
    dev = torch.device("cuda")
    ok = True
    for what, key, bits, ops, kw in cases(torch, dev):
        want = cs._sort_library(key, ops, kw)
        lib_ms = cs.cuda_ms(lambda: cs._sort_library(key, ops, kw), REPS)
        got = sq.sort_payloads(key, bits, ops, **kw)
        torch.cuda.synchronize()
        equal = len(got) == len(want) and all(torch.equal(x, y) for x, y in zip(got, want))
        ok &= equal
        del got, want
        ms = cs.cuda_ms(lambda: sq.sort_payloads(key, bits, ops, **kw), REPS)
        stages = cs._launch_ms(lambda: sq.sort_payloads(key, bits, ops, **kw))
        print(json.dumps({
            "case": what, "P": key.numel(), "bits": bits, "passes": sq.sort_passes(bits),
            "bitwise_equal": equal, "ms": round(ms, 4), "library_ms": round(lib_ms, 4),
            "launches": [(n, round(t, 4)) for n, t in stages], "card": name,
        }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
