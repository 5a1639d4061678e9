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
(torch.profiler, in launch order).

Kernel G (colorid_tpu_torch/csrc/value_sort.cu, the reads routes' value
sort of int64 keys over their 2k bits), on seeded canonical window keys
at k 31 with the cell's SENT share (chip_smoke.py::synth_window_keys):

- single: 52,002,816 keys only (the single fused dispatch's);
- chunk: a 26,000,000-key chunk of the chunked route;
- merge: 33,554,432 keys in no order with an int32 payload (the merge's
  counts), over all 64 bits as the fused merge sorts them: the LSD path's
  measure at the merge's size;
- merge route: the chunked route's own merge input, built as the route
  builds it (chip_smoke.py::synth_merge_keys: two chunks of 26,000,000
  windows, each sorted, counted and partitioned to the [fused] cell's
  cap of 16,777,216, live slots then dead ones: four sorted runs), 33,554,432
  keys with the counts, with the runs hint where the checkout's G takes
  one (the merge path), and the merge case's keys with the hint (the LSD
  path after the runs read);

each checked bitwise against torch.sort(stable) (+ the payload's
gather), timed beside it and split by launch, and the single case also
at widest digits of 8, 9 and 11 bits (8, 7 and 6 passes): the candidates
the wrapper's default was chosen from. In a checkout without kernel G
(--root of an older one) the routes' own call before it, torch.sort (+
the gather through its permutation), is timed instead.

One JSON line per case, the card's name and power limit and the kernel
libraries' ptxas reports first:

    python3 sort_bench.py [--root DIR] [--value]

DIR: another checkout whose colorid_tpu_torch to time (the parent, for
turns in one call); --value: kernel G's cases alone. Exits 2 without a
card."""

import json
import os
import sys

import chip_smoke as cs

SEED = 2026
P_BLOCKED, P_CLASSIC = 9_437_184, 34_603_008
N_BLOCKS, BLOOM = 390_625, 50_000_000
PAD_BLOCKED, PAD_ROWS, PAD_PER_ROW = 960_000, 4, 92_437
REPS = 20
P_SINGLE, P_CHUNK, P_MERGE = 52_002_816, 26_000_000, 33_554_432


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


def value_cases(torch, dev, has_runs: bool):
    """Kernel G's cases: (name, keys, payload or None, bits, runs hint)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    merge = cs.synth_window_keys(P_MERGE, cs.K, dev, seed=SEED + 2)
    qc = torch.randint(0, 6, (P_MERGE,), generator=g, device=dev, dtype=torch.int32)
    route, route_qc = cs.synth_merge_keys(2, P_CHUNK, cs.K, dev, seed=SEED + 4, cap=1 << 24)
    assert route.numel() == P_MERGE
    cases = [
        ("single", cs.synth_window_keys(P_SINGLE, cs.K, dev), None, 2 * cs.K, False),
        ("chunk", cs.synth_window_keys(P_CHUNK, cs.K, dev, seed=SEED + 1), None, 2 * cs.K, False),
        ("merge", merge, qc, 64, False),
        ("merge route", route, route_qc, 64, has_runs),
    ]
    if has_runs:
        cases.append(("merge with the hint", merge, qc, 64, True))
    return cases


def _value_library(key, payload, stable: bool = True):
    """torch.sort of the keys (+ the payload gathered through its
    permutation): stable, the library call G stands beside; not, what the
    routes called before G."""
    import torch

    key_s, perm = torch.sort(key, stable=stable)
    return key_s if payload is None else (key_s, payload[perm])


def _same_run_sums(key, a, b) -> bool:
    """The two payloads of the same sorted keys sum alike over each run of
    equal keys."""
    import torch

    ends = torch.nonzero(torch.cat([key[1:] != key[:-1], key.new_ones(1, dtype=torch.bool)]))
    ca, cb = (torch.cumsum(x, 0, dtype=torch.int64)[ends] for x in (a, b))
    return torch.equal(ca, cb)


def value_sort_bench(torch, te, name: str) -> bool:
    """Kernel G's cases (see the module's note); True if every result was
    bitwise torch.sort's."""
    import inspect

    dev = torch.device("cuda")
    has_g = hasattr(te, "value_sort")
    has_runs = has_g and "runs" in inspect.signature(te.value_sort).parameters
    ok = True
    default = getattr(te, "VALUE_SORT_DIGIT_BITS", None)
    for what, key, pay, bits, runs in value_cases(torch, dev, has_runs):
        hint = {"runs": True} if runs else {}
        variants = [default]
        if has_g and what == "single":
            variants += [d for d in (8, 9, 11) if d != default]
        lib_ms = cs.cuda_ms(lambda: _value_library(key, pay), REPS)
        want = _value_library(key, pay)
        want = want if isinstance(want, tuple) else (want,)
        for dmax in variants:
            if has_g:
                te.VALUE_SORT_DIGIT_BITS = dmax

                def fn():
                    return te.value_sort(key, pay, bits=bits, **hint)
            else:
                def fn():
                    return _value_library(key, pay, stable=False)
            got = fn()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            if has_g:
                equal = len(got) == len(want) and all(
                    torch.equal(x, y) for x, y in zip(got, want))
            else:  # an unstable sort: the keys, and the payload's sum over each run
                equal = torch.equal(got[0], want[0]) and (pay is None or _same_run_sums(
                    got[0], got[1], want[1]))
            ok &= equal
            del got
            path = None
            if hasattr(te, "value_sort_stats"):  # the path the device took, from its counts
                te.value_sort.keep_stats = True
                fn()
                counted = te.value_sort_stats(te.value_sort.last_stats)
                te.value_sort.keep_stats, te.value_sort.last_stats = False, None
                desc = counted["descents"]
                rounds = te.value_sort_merge_rounds(desc + 1, bits) if runs else 0
                path = (f"merge {rounds} rounds of {desc + 1} runs" if rounds else
                        f"lsd, SENT tails {counted['tails'][:len(te.value_sort_passes(bits))]}")
            ms = cs.cuda_ms(fn, REPS)
            stages = cs._launch_ms(fn)
            bound = cs.value_sort_bytes(key.numel(), payload=pay is not None) / cs.HBM_BYTES_PER_S
            print(json.dumps({
                "case": f"value_sort {what}", "P": key.numel(), "payload": pay is not None,
                "runs_hint": runs, "path": path,
                "route": "kernel G" if has_g else "torch.sort", "dmax": dmax,
                "bits": bits, "passes": te.value_sort_passes(bits) if has_g else None,
                "sent_share": round(float((key == te.SENT_KEY).float().mean()), 4),
                "bitwise_equal": equal, "ms": round(ms, 4), "library_ms": round(lib_ms, 4),
                "bound_ms": round(bound * 1e3, 4),
                "launches": [(n, round(t, 4)) for n, t in stages], "card": name,
            }), flush=True)
        if has_g:
            te.VALUE_SORT_DIGIT_BITS = default
        del want
    return ok


def main(argv) -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    value_only = "--value" in argv
    argv = [a for a in argv if a != "--value"]
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
    from colorid_tpu_torch.ops import extract as te
    from colorid_tpu_torch.ops import kernels
    from colorid_tpu_torch.ops import stream_query as sq

    name = cs.card_line()
    print(f"card: {name} ({root})", flush=True)
    print(f"build {kernels.build_all():.1f}s", flush=True)
    for src in ("radix_sort.cu", "value_sort.cu"):
        for line in kernels.build_log.get(src, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {src}:", line.strip(), flush=True)
    dev = torch.device("cuda")
    ok = True
    for what, key, bits, ops, kw in ([] if value_only else cases(torch, dev)):
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
    torch.cuda.empty_cache()
    ok &= value_sort_bench(torch, te, name)
    return 0 if ok else 1

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
