"""Kernel D (colorid_tpu_torch/csrc/stream_tail.cu, the blocked stream's
glue) alone on the card, at the shape of chip_smoke.py's main cell, on a
seeded synthetic batch sorted as kernel E hands it over:

- real: 9,437,184 probes over 390,656 blocks (W 1, C 21, H 4, rpb 128),
  the key block << 11 | frequency (1 + a geometric draw), 960,000 padding
  probes on block 0 with frequency 0, the packed offsets, the index as the
  overflow payload; every chunk inside its window;
- big: the same with every frequency raised by 1,024 (every unique hit
  big, the overflow list past OVER_CAP);
- sparse: 300 chunks of probes spread over the whole matrix (more
  residual chunks than the list holds: n_drop > 0).

Each case runs the route's body that both designs share,
stream_chunk_plan (D1) then _stream_core_kernels (the probe kernel, D's
tail and the epilogue), and prints one JSON line: the mean of 20 calls
by CUDA events, the device time of each kernel a call (torch.profiler over
5 calls; kernel D's kernels summed), the host clock one call takes to
enqueue on an idle card (median of 20), and a digest of the accumulators
and n_drop (equal across checkouts when both are right). The card's name
and power limit and the kernel library's ptxas report come first:

    python3 tail_bench.py [--root DIR]

DIR: another checkout whose colorid_tpu_torch to time (the parent, for
turns in one call). Exits 2 without a card."""

import hashlib
import json
import os
import sys

import chip_smoke as cs

SEED = 2026
P, N_BLOCKS, PAD = 9_437_184, 390_656, 960_000
C, W, H, RPB = 21, 1, 4, 128
SPARSE_CHUNKS = 300
REPS = 20


def batch(torch, dev, case: str):
    """(blocks2, key_s, off_s, gidx_s) of one case, sorted by key."""
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=torch.int32)

    rows = rand(N_BLOCKS * 128, 0, 2**21) & rand(N_BLOCKS * 128, 0, 2**21)
    rows[torch.rand(rows.numel(), generator=g, device=dev) < 0.3] = 0
    blocks2 = rows.view(N_BLOCKS, 128)
    n = SPARSE_CHUNKS * 2048 if case == "sparse" else P
    blk = rand(n, 0, N_BLOCKS)
    u = torch.rand(n, generator=g, device=dev).clamp_min(1e-9)
    freq = (1 + torch.floor(torch.log(u) / torch.log(torch.tensor(0.5, device=dev)))).clamp(
        max=1023).to(torch.int32)
    if case == "big":
        freq += 1024
    key = (blk << 11) | freq
    if case != "sparse":
        key[torch.randperm(n, generator=g, device=dev)[:PAD]] = 0
    offp = rand(n, 0, 2**31 - 1) & 0x7F7F7F7F
    key_s, perm = torch.sort(key, stable=True)
    return blocks2, key_s, offp[perm].contiguous(), perm.to(torch.int32)


def main(argv) -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    if argv[:1] == ["--root"] and len(argv) == 2:
        root = os.path.abspath(argv[1])
    elif argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("tail_bench: no CUDA card", file=sys.stderr)
        return 2
    from colorid_tpu_torch.ops import kernels
    from colorid_tpu_torch.ops import query as tq
    from colorid_tpu_torch.ops import stream_query as sq

    print(f"card: {cs.card_line()} ({root})", flush=True)
    print(f"build {kernels.build_all():.1f}s", flush=True)
    for line in kernels.build_log.get("stream_tail.cu", "").splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print("ptxas " + line.strip(), flush=True)
    dev = torch.device("cuda")
    for case in ("real", "big", "sparse"):
        blocks2, key_s, off_s, gidx_s = batch(torch, dev, case)
        accs = tq.new_accumulators(C, W, sq.OVER_CAP + sq.RES_CAP, dev)

        def call():
            acc = [a.clone() for a in accs]
            plan = sq.stream_chunk_plan(N_BLOCKS, W, key_s=key_s, off_s=off_s,
                                        qbits=sq.QKEY_BITS)
            return sq._stream_core_kernels(*acc, blocks2, plan, gidx_s, wpad=W, num_hash=H,
                                           rpb=RPB, n_colors=C)

        out = call()
        torch.cuda.synchronize()
        digest = hashlib.sha256(b"".join(x.cpu().numpy().tobytes() for x in out)).hexdigest()
        ms = cs.cuda_ms(call, REPS)
        host_us = cs.enqueue_us(call, REPS)[0]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        by = {k: [t / 5, n / 5] for k, (t, n) in cs.device_times(prof).items()}
        d = {k: v for k, v in by.items()
             if k.endswith("_kernel") and k.removesuffix("_kernel") in cs.D_KERNELS}
        print(json.dumps({
            "case": case, "P": key_s.numel(), "n_drop": int(out[4]),
            "n_over": int(out[0][C + W + 1]), "ms_a_call": round(ms, 4),
            "kernel_d_ms": round(sum(v[0] for v in d.values()), 4),
            "kernel_d_launches": sum(v[1] for v in d.values()),
            "kernels_ms": {k: [round(v[0], 4), v[1]] for k, v in sorted(by.items())},
            "host_enqueue_us": round(host_us, 1), "digest": digest[:16],
        }), flush=True)
        del blocks2, key_s, off_s, gidx_s, accs, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
