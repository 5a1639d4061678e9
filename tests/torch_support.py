"""Shared fixtures and synthetic inputs of the PyTorch port's tests
(tests/test_torch_*.py): random genomes and reads made from a numpy seed,
so both packages see the same bytes."""

import gzip
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

# pytest-xdist runs several workers at once; torch's default of one
# intra-op thread per core in each of them oversubscribes the CPU and slows
# the port's tests tenfold
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.zeros(256, dtype=np.uint8)
_COMP[ACGT] = np.frombuffer(b"TGCA", dtype=np.uint8)


@pytest.fixture
def cuda_device():
    """The first CUDA card; skips the test where there is none. Decided
    when the test runs, never at import, so every worker collects the same
    tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda", 0)


def t32(a: np.ndarray) -> torch.Tensor:
    """A uint32/int32 numpy array as an int32 tensor (bit view)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def classic_case(kind: str, seed: int, n_chunks: int = 3, pc: int = 4096):
    """A random uint32 block matrix [Rb, 128] (every bit may be set, so the
    byte-plane masking shows) and n_chunks * pc sorted int32 row probes over
    it: "dense" probes stay inside their chunk's window, "sparse" ones span
    far more than the window per chunk."""
    rng = np.random.default_rng(seed)
    rb = 512 if kind == "dense" else 4096
    blocks = rng.integers(0, 2**32, (rb, 128), dtype=np.uint32)
    span = rb * 128 if kind == "sparse" else 96 * 128
    lo = 0 if kind == "sparse" else 300 * 128
    rows = np.sort(rng.integers(lo, lo + span, n_chunks * pc)).astype(np.int32)
    return blocks, rows


def genomes(n: int = 4, length: int = 50_000, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [ACGT[rng.integers(0, 4, length)] for _ in range(n)]


def write_fasta(path, name: str, seq: np.ndarray, width: int = 80) -> str:
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode())
        for i in range(0, len(seq), width):
            f.write(seq[i : i + width].tobytes() + b"\n")
    return str(path)


def write_panel(tmp_path, gs: list[np.ndarray]):
    """One fasta per genome plus the build manifest. Returns (manifest
    path, {name: [fasta path]})."""
    refs = {}
    for i, g in enumerate(gs):
        name = f"genome{i}"
        refs[name] = [write_fasta(os.path.join(tmp_path, f"{name}.fasta"), name, g)]
    man = os.path.join(tmp_path, "refs.txt")
    with open(man, "w") as f:
        f.writelines(f"{name}\t{paths[0]}\n" for name, paths in refs.items())
    return man, refs


def reads(gs: list[np.ndarray], n: int, L: int, seed: int, sub_rate: float = 0.0):
    """n reads of length L from the given genomes, half reverse-complemented,
    with random substitutions at sub_rate. uint8 [n, L]."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, len(gs), n)
    starts = rng.integers(0, len(gs[0]) - L, n)
    out = np.stack(gs)[src[:, None], starts[:, None] + np.arange(L)]
    rc = rng.random(n) < 0.5
    out[rc] = _COMP[out[rc][:, ::-1]]
    sub = rng.random(out.shape) < sub_rate
    out[sub] = ACGT[rng.integers(0, 4, int(sub.sum()))]
    return out


def write_fastq_gz(path, rs: np.ndarray, prefix: str = "read") -> str:
    qual = "I" * rs.shape[1]
    with gzip.open(path, "wt") as f:
        for j, r in enumerate(rs):
            f.write(f"@{prefix}{j} extra\n{r.tobytes().decode()}\n+\n{qual}\n")
    return str(path)


def rand_blocked_matrix(rng, C: int, bloom_size: int, zero_frac: float = 0.3,
                        thin: int = 1):
    """A random uint32 [bloom, W] bit-slice matrix for C colors over
    bloom_size rows rounded up to whole 128-row groups: every color bit is
    set with probability 2^-thin (wide rows need thin ones for an AND over
    the hashes to leave single hits), no bit beyond C is set, and zero_frac
    of the rows are absent. Returns (bloom, matrix, color names)."""
    bloom = -(-bloom_size // 128) * 128
    W = (C + 31) // 32
    matrix = rng.integers(0, 2**32, (bloom, W), dtype=np.uint32)
    for _ in range(thin - 1):
        matrix &= rng.integers(0, 2**32, (bloom, W), dtype=np.uint32)
    if C % 32:
        matrix[:, W - 1] &= np.uint32((1 << (C % 32)) - 1)
    matrix[rng.integers(0, bloom, int(bloom * zero_frac))] = 0
    return bloom, matrix, [f"c{i}" for i in range(C)]


def rand_packed(rng, n: int, k: int = 31) -> np.ndarray:
    """n random 2-bit packed k-mers as (lo, hi) uint32 [n, 2]."""
    vals = rng.integers(0, 4**k, n, dtype=np.uint64)
    out = np.empty((n, 2), dtype=np.uint32)
    out[:, 0] = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[:, 1] = (vals >> np.uint64(32)).astype(np.uint32)
    return out


def probe_case(C: int, num_hash: int, seed: int, n_blocks: int = 1024,
               n_probes: int = 8192, thin: int = 1):
    """Inputs of the blocked probe kernel: a block matrix uint32
    [n_blocks, 128] for C colors and n_probes probes sorted by block, each
    with split-lane offsets (hash h in its own group of rows) packed 8 bits
    per hash, and a frequency (0 = padding). Returns (blocks, wpad, blk_s,
    off_s, qc) as numpy arrays (int32 but for the blocks)."""
    rng = np.random.default_rng(seed)
    W = (C + 31) // 32
    wpad = 1 << (W - 1).bit_length()
    rpb = 128 // wpad
    _bloom, matrix, _names = rand_blocked_matrix(rng, C, n_blocks * rpb, 0.3, thin)
    blocks = np.zeros((n_blocks * rpb, wpad), dtype=np.uint32)
    blocks[:, :W] = matrix
    grp = rpb // num_hash
    blk = np.sort(rng.integers(0, n_blocks, n_probes)).astype(np.int32)
    off = np.zeros(n_probes, dtype=np.int64)
    for h in range(num_hash):
        off |= (h * grp + rng.integers(0, grp, n_probes)) << (8 * h)
    qc = rng.integers(0, 2000, n_probes).astype(np.int32)
    return blocks.reshape(n_blocks, 128), wpad, blk, off.astype(np.int32), qc


def read_mix(gs: list[np.ndarray], n: int, seed: int, L: int = 150,
             insert: int = 500, sub_rate: float = 0.005):
    """n read pairs for the read classifier, as (r1, q1, r2, q2) lists of
    byte strings: pairs from the genomes (insert ``insert``, mate 2
    reverse-complemented, substitutions at sub_rate) mixed with junk pairs,
    chimeras (mates from two genomes), reads whose first or last 30 bases
    are random (absent k-mers early or late), N bases, low-quality bases
    (masked to N at -Q 15), first mates shorter than k, shorter mates,
    lowercase stretches and exact duplicates of the pair before."""
    rng = np.random.default_rng(seed)
    glen = len(gs[0])

    def frag(g, start, length, rc=False):
        s = gs[g][start : start + length].copy()
        return _COMP[s[::-1]] if rc else s

    def rand(length):
        return ACGT[rng.integers(0, 4, length)]

    out = []
    for i in range(n):
        if i % 31 == 30 and out:
            out.append(out[-1])
            continue
        g = int(rng.integers(0, len(gs)))
        s = int(rng.integers(0, glen - insert))
        r1 = frag(g, s, L)
        r2 = frag(g, s + insert - L, L, rc=True)
        if i % 50 == 7:  # junk
            r1, r2 = rand(L), rand(L)
        elif i % 23 == 5:  # chimera
            g2 = (g + 1) % len(gs)
            r2 = frag(g2, int(rng.integers(0, glen - L)), L, rc=True)
        for r in (r1, r2):
            sub = rng.random(L) < sub_rate
            r[sub] = ACGT[rng.integers(0, 4, int(sub.sum()))]
        if i % 19 == 3:
            r1[:30] = rand(30)
        if i % 29 == 4:
            r1[-30:] = rand(30)
        if i % 17 == 2:
            r1[rng.integers(0, L, 2)] = ord("N")
        if i % 97 == 11:
            r2[40:60] = r2[40:60] + 32  # lowercase acgt
        if i % 37 == 6:
            r2 = r2[:100]
        q1 = np.full(len(r1), ord("I"), dtype=np.uint8)
        q2 = np.full(len(r2), ord("I"), dtype=np.uint8)
        if i % 13 == 1:
            q1[rng.integers(0, len(r1), 4)] = ord("#")
        if i % 41 == 9:  # first mate shorter than k: too_short
            r1, q1 = r1[:20], q1[:20]
        out.append(tuple(x.tobytes() for x in (r1, q1, r2, q2)))
    return out


def write_pairs(d, pairs, name: str = "pairs"):
    """The pairs of read_mix as two .fastq.gz files (ids from file 1).
    Returns (path 1, path 2)."""
    paths = [os.path.join(d, f"{name}_R{m}.fastq.gz") for m in (1, 2)]
    for m, path in enumerate(paths):
        with gzip.open(path, "wb") as f:
            for j, p in enumerate(pairs):
                seq, qual = p[2 * m], p[2 * m + 1]
                f.write(b"@pair%d %d\n%s\n+\n%s\n" % (j, m + 1, seq, qual))
    return paths[0], paths[1]


def launch_two(argv_of, timeout: int = 180) -> list[str]:
    """Two processes, argv_of(rank, "host:port") each, on a free local
    port; fails unless both exit 0 within ``timeout`` seconds. Returns
    their standard outputs."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, *argv_of(r, coord)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def write_mesh_inputs(d: str, gs, K: int, L: int) -> dict:
    """The workers' inputs: k-mers and frequencies for search_keys (the
    reads' k-mers and random ones; some frequencies past FREQ_CAP), per-read
    k-mer sets in FnvHashSet order with their 2-bit packed keys, reads for
    search_reads (1,100 copies of one: the overflow list) and for
    classify_batch (ties, junk, too short, lowercase), for
    tests/torch_process_mesh_worker.py; gs as from genomes(), genome 1
    repeating genome 0's first 2 kbp."""
    from colorid_tpu_torch.core.kmers import kmer_set
    from colorid_tpu_torch.ops.blocked import pack_keys_u64
    from colorid_tpu_torch.ops.extract import pack_reads
    from colorid_tpu_torch.pipelines.read_id import _fnv_order_keys

    rng = np.random.default_rng(31)
    rd = reads(gs[:3], 300, L, seed=32, sub_rate=0.005)
    rd[:40] = rd[40:80]  # repeats: frequencies above 1
    keys = np.concatenate([kmer_set(list(rd[:120]), K), ACGT[rng.integers(0, 4, (300, K))]])
    qcounts = rng.integers(1, 5, keys.shape[0]).astype(np.int32)
    qcounts[::97] = 1100
    sets = []
    for i in range(40):
        g = gs[0] if i % 6 == 0 else gs[int(rng.integers(0, len(gs)))]
        s = int(rng.integers(0, 1850 if i % 6 == 0 else len(g) - L))
        read = g[s:s + L].copy()
        if i % 5 == 0:
            read[75:] = ACGT[rng.integers(0, 4, 75)]  # absent k-mers: the break
        sets.append(_fnv_order_keys(kmer_set([read], K)))
    sets.append(np.zeros((0, K), dtype=np.uint8))  # a read without k-mers
    v = pack_keys_u64(np.concatenate(sets))
    packed = np.stack([(v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                       (v >> np.uint64(32)).astype(np.uint32)], axis=1)
    sr = np.concatenate([rd, np.repeat(gs[2][None, 1000:1000 + L], 1100, axis=0)])
    lens = rng.integers(100, L + 1, sr.shape[0]).astype(np.int32)
    lens[300:] = L
    batch = []
    for i in range(60):
        if i % 7 == 3:
            read = ACGT[rng.integers(0, 4, 20)]  # too short
        elif i % 7 == 5:
            read = ACGT[rng.integers(0, 4, L)]  # junk
        else:
            g = gs[0] if i % 3 == 0 else gs[int(rng.integers(0, len(gs)))]
            s = int(rng.integers(0, 1850 if i % 3 == 0 else len(g) - L))
            read = g[s:s + L].copy()
        if i == 10:
            read[30:40] += 32  # lowercase
        batch.append(read)
    inp = dict(keys=keys, qcounts=qcounts, set_keys=np.concatenate(sets),
               set_lens=np.array([s.shape[0] for s in sets]), packed=packed,
               words=pack_reads(sr), lens=lens, k=np.array(K), L=np.array(L),
               batch_reads=np.concatenate(batch), batch_lens=np.array([len(r) for r in batch]))
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    inp["sets"] = sets
    inp["batch"] = [(f"r{i}", [r]) for i, r in enumerate(batch)]
    return inp


# -- inputs of the search epilogue (ops/query.py::_accumulate_tail and
# _accumulate_words_plain, csrc/epilogue.cu's twins) ----------------------------

EPI_FREQ_CAP = 1024  # ops/query.py::FREQ_CAP


def epi_andw(rng, n: int, C: int, wpad: int, high: bool = False) -> np.ndarray:
    """Per-k-mer AND words uint32 [n, wpad]: a mix of empty rows,
    single-color (uniq) rows and multi-color rows over colors < C. With
    ``high`` also bits at and above C: random ones, and the top bit in
    every row, which the global AND keeps and everything else drops."""
    kind = rng.integers(0, 4, n)
    bits = np.zeros((n, wpad * 32), dtype=bool)
    if C:
        bits[np.arange(n), rng.integers(0, C, n)] = kind == 1
        bits[:, :C] |= (rng.random((n, C)) < 0.2) & (kind >= 2)[:, None]
    if high and C < wpad * 32:
        bits[:, C:] |= rng.random((n, wpad * 32 - C)) < 0.3
        bits[:, -1] = True
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)


def epi_words(rng, n: int, C: int, H: int, p_absent: float = 0.05) -> np.ndarray:
    """Per-hash one-word rows uint32 [n, H] of the classic stream: each
    k-mer's words share an empty, one-color or several-color core over
    colors < C, plus noise bits (at and above C too, and always the top
    one where C < 32) that the AND over H mostly removes; a fraction
    p_absent of the words is zero (the k-mer is then not present)."""
    core = epi_andw(rng, n, C, 1)[:, 0]
    noise = rng.random((n, H, 32)) < 0.02 ** (1 / H)  # 2 % of a bit survive the AND
    if C < 32:
        noise[:, :, 31] = True
    nw = np.packbits(noise, axis=2, bitorder="little").view(np.uint32)[:, :, 0]
    words = core[:, None] | nw
    words[rng.random((n, H)) < p_absent] = 0
    return words


def epi_qcounts(rng, n: int, hot: bool = False) -> np.ndarray:
    """Frequencies int32 [n] (0 marks padding): with ``hot`` only 0-18, so
    the unique hits pile onto a few histogram bins, as reads at a few x
    coverage of a few genomes do; else 0-40 with frequencies straddling
    FREQ_CAP and far above it."""
    if hot:
        return rng.integers(0, 19, n).astype(np.int32)
    q = rng.integers(0, 40, n).astype(np.int32)
    big = rng.random(n) < 0.1
    q[big] = rng.integers(EPI_FREQ_CAP - 3, EPI_FREQ_CAP + 3000, int(big.sum()))
    q[rng.random(n) < 0.02] = EPI_FREQ_CAP - 1
    q[rng.random(n) < 0.02] = EPI_FREQ_CAP
    return q


def epi_accs(C: int, wpad: int, capO: int, n_over: int = 0, seed: int = 0):
    """Accumulators (stats, hist, over_col, over_freq) as numpy int32 arrays
    that a search may hold before this batch: counts, AND words with some
    bits cleared, the all-valid flag 1, a histogram with some counts, and
    n_over entries already in the overflow list (the slots beyond it
    zero)."""
    rng = np.random.default_rng(seed)
    andw = rng.integers(0, 2**32, wpad, dtype=np.uint32) | np.uint32(0xF0FFFFFF)
    stats = np.concatenate([
        rng.integers(0, 100, C).astype(np.int32),
        andw.view(np.int32) if seed else np.full(wpad, -1, np.int32),
        np.array([1, n_over], np.int32),
    ])
    hist = (rng.integers(0, 3, (C, EPI_FREQ_CAP)) * (seed > 0)).astype(np.int32)
    over_col = np.zeros(capO, np.int32)
    over_freq = np.zeros(capO, np.int32)
    m = min(n_over, capO)
    over_col[:m] = rng.integers(0, max(C, 1), m)
    over_freq[:m] = rng.integers(EPI_FREQ_CAP, 1 << 20, m)
    return stats, hist, over_col, over_freq


# -- inputs of the classic stream's sorted-words epilogue ----------------------
# (ops/query.py::_accumulate_sorted_words and its twin)

SORTED_P0 = 262144  # ops/stream_query.py::EPC_CL: one stream segment of k-mers
SORTED_CAPO = 256


def sorted_case(H: int, C: int, kind: str, seed: int, segments: int = 1):
    """A classic stream batch of segments * SORTED_P0 k-mers (k 31) for H hashes and C
    colors: (bloom_size, matrix uint32 [bloom, 1], packed uint32 [P0, 2],
    qcounts int32 [P0]). Each color bit of a row is set with a probability
    that leaves about 1.5 colors in the AND of H rows, 5 % of the rows are
    zero, and where C < 32 a third of the rows also carry bits at and above
    C (the word kernel masks them in its window, a re-read keeps them).
    The last 5 % of the slots are padding (packed 0, frequency 0); 10 % of
    the frequencies lie at or above FREQ_CAP, so the overflow list runs past
    SORTED_CAPO. ``kind`` "mixed": bloom 4.5 P0 H rows, so that a fifth of
    the chunks have probes outside their window, all of them re-read;
    "drop": 10 P0 H rows, every chunk has some and more than NCH_CL do, so
    n_drop > 0 and the rest keep the de-offset word."""
    rng = np.random.default_rng(seed)
    P0 = segments * SORTED_P0
    bloom = int((10 if kind == "drop" else 4.5) * P0 * H)
    p = (1.5 / C) ** (1 / H)
    bits = rng.random((bloom, C)) < p
    matrix = np.packbits(bits, axis=1, bitorder="little")
    matrix = np.pad(matrix, ((0, 0), (0, 4 - matrix.shape[1]))).view(np.uint32)
    if C < 32:
        high = rng.random(bloom) < 1 / 3
        noise = rng.integers(0, 2**32, bloom, dtype=np.uint32) & ~np.uint32((1 << C) - 1)
        matrix[high, 0] |= noise[high] | np.uint32(1 << 31)
    matrix[rng.random(bloom) < 0.05] = 0
    packed = rand_packed(rng, P0, 31)
    q = rng.integers(1, 40, P0).astype(np.int32)
    big = rng.random(P0) < 0.1
    q[big] = rng.integers(EPI_FREQ_CAP, EPI_FREQ_CAP + 4000, int(big.sum()))
    n_pad = P0 // 20
    packed[-n_pad:] = 0
    q[-n_pad:] = 0
    return bloom, matrix, packed, q


def sorted_words_args(blocks2, packed, q, *, H: int, C: int, bloom: int):
    """What ops/stream_query.py::stream_accumulate_classic_exact hands the
    sorted-words epilogue for these tensors (on their device), captured
    from the call itself: (accumulators, args, keywords, n_drop) with fresh
    zero accumulators of capacity SORTED_CAPO."""
    from colorid_tpu_torch.ops import query as tq
    from colorid_tpu_torch.ops import stream_query as sq

    seen = []

    def capture(*a, **kw):
        seen.append((a[4:], kw))
        return a[:4]

    accs = tq.new_accumulators(C, 1, SORTED_CAPO, blocks2.device)
    real = sq._accumulate_sorted_words
    sq._accumulate_sorted_words = capture
    try:
        n_drop = sq.stream_accumulate_classic_exact(
            *accs, blocks2, packed, q, wpad=1, k=31, num_hash=H, bloom_size=bloom,
            n_colors=C)[4]
    finally:
        sq._accumulate_sorted_words = real
    (args, kw), = seen
    return accs, args, kw, int(n_drop)


# -- batches of the blocked probe stream's glue (ops/stream_query.py, kernel
# D and kernel A's packed mode) -----------------------------------------------

STREAM_TAIL_CASES = {
    # name: (C, bloom_size, H, layout, live k-mers, slots, frequencies below,
    #        absent rows, thin, mode). "skip": every probe in its chunk's
    #        window and every frequency below hw, so the overflow list and
    #        the residual pass have nothing to do; the others leave probes
    #        outside their windows and frequencies at and above hw. thin: a
    #        color bit is set with probability 2^-thin, so that about a third
    #        of the present k-mers hit one color
    "skip": (21, 128 * 768, 4, 4, 8000, 8192, 500, 0.3, 1, "exact_key"),
    "one_chunk": (40, 64 * 1024, 2, 2, 1900, 2048, 3000, 0.3, 3, "clipped"),
    "w8_h1": (200, 60_000, 1, 2, 6000, 8192, 1500, 0.5, 8, "exact"),
    "w2_h4": (40, 64 * 4000, 4, 4, 12000, 12288, 3000, 0.3, 1, "clipped"),
    "sparse": (21, 3_000_000, 2, 4, 10000, 10240, 2000, 0.2, 2, "clipped"),
    "overflow": (21, 128 * 768, 4, 4, 14000, 14336, 3000, 0.3, 1, "exact"),
    # 220 chunks of 2,048 probes over 156,288 blocks: 152 chunks span more
    # than their window, so more than nch = 128 chunks have residual probes
    # and the chunks past the list hold some
    "past_nch": (21, 20_000_000, 2, 4, 449_000, 450_560, 2000, 0.2, 2, "clipped"),
    # 40 tiles, big probes in every one, past OVER_CAP and capO
    # (STREAM_TAIL_CAPS)
    "overflow_tiles": (21, 128 * 2048, 4, 4, 80_000, 81_920, 3000, 0.3, 1, "exact"),
    # 40 tiles, big probes only in the last one (sorted by block): its
    # look-back walks the whole batch
    "big_last_tile": (21, 128 * 4096, 4, 4, 80_000, 81_920, 1000, 0.3, 1, "exact"),
}
# the seed order: a case keeps its seed when cases are added
_TAIL_SEEDS = ("one_chunk", "overflow", "skip", "sparse", "w2_h4", "w8_h1", "past_nch",
               "overflow_tiles", "big_last_tile")
# what a test patches for a case: the residual chunk capacity (_nch), and
# OVER_CAP with the overflow list's capacity and its entries before the batch
STREAM_TAIL_CAPS = {
    "sparse": dict(nch=2),
    "overflow": dict(over_cap=300, capO=350, n_over=200),
    "overflow_tiles": dict(over_cap=2000, capO=5000, n_over=3500),
}
BIG_FREQ = 1024  # the histogram's width at these color counts: frequencies from it are big


def patch_tail_caps(name: str, monkeypatch, modules):
    """STREAM_TAIL_CAPS[name] patched into each of ``modules`` (the port's
    stream_query, and the JAX package's where a test runs both); returns
    (capO, n_over), or None where the case keeps the defaults."""
    caps = STREAM_TAIL_CAPS.get(name, {})
    for m in modules:
        if "nch" in caps:
            monkeypatch.setattr(m, "_nch", lambda wpad: caps["nch"])
        if "over_cap" in caps:
            monkeypatch.setattr(m, "OVER_CAP", caps["over_cap"])
    return (caps["capO"], caps["n_over"]) if "capO" in caps else None


def stream_tail_case(name: str):
    """One batch of STREAM_TAIL_CASES: (geometry kwargs of
    stream_accumulate_hash, blocks uint32 [n_blocks, 128], packed uint32
    [P, 2] with the live k-mers first, frequencies int32 [P] with 0 on the
    padding, mode "clipped" / "exact" / "exact_key"). In "big_last_tile"
    the probes of the last tile of 2,048 in block order (the sort the
    stream runs) get frequencies from BIG_FREQ."""
    from colorid_tpu_torch.ops.query import pack_matrix_blocks

    C, bloom_size, H, bv, n, P, fmax, absent, thin, mode = STREAM_TAIL_CASES[name]
    rng = np.random.default_rng(_TAIL_SEEDS.index(name) + 90)
    bloom, matrix, _names = rand_blocked_matrix(rng, C, bloom_size, absent, thin)
    blocks, wpad = pack_matrix_blocks(matrix)
    pk = np.zeros((P, 2), np.uint32)
    pk[:n] = rand_packed(rng, n)
    qc = np.zeros(P, np.int32)
    qc[:n] = rng.integers(1, fmax, n)
    geo = dict(wpad=wpad, k=31, num_hash=H, bloom_size=bloom, rpb=128 // wpad,
               n_colors=C, bv=bv)
    if name == "big_last_tile":
        from colorid_tpu_torch.ops import stream_query as sq

        perm = sq._sorted_probes_plain(
            t32(pk), torch.from_numpy(qc), qbits=0, qmin=None, qmax=None, k=31, num_hash=H,
            bloom_size=bloom, rpb=geo["rpb"], bv=bv)[3].numpy()
        last = perm[-2048:]
        qc[last] = np.where(qc[last] > 0, rng.integers(BIG_FREQ, 2000, 2048), 0)
    return geo, blocks, pk, qc, mode


def stream_tail_run(geo, blocks, pk, qc, mode, accs, device, kernels_route: bool,
                    base0: int = 4096):
    """stream_accumulate_hash[_exact]'s body (ops/stream_query.py::
    _stream_accumulate) on one batch of STREAM_TAIL_CASES, on ``device``:
    the card's route (kernel A's packed mode, the key sort, kernel D; its
    wrappers take their twins on the CPU) or the twins' route. accs: numpy
    accumulators, copied. Returns (stats, hist, over_col, over_freq,
    n_drop)."""
    from colorid_tpu_torch.ops import stream_query as sq

    in_key = mode != "exact" and sq._qc_in_key_ok(geo["bloom_size"], geo["rpb"])
    clipped = mode == "clipped"
    return sq._stream_accumulate(
        *(torch.from_numpy(a.copy()).to(device) for a in accs),
        t32(blocks).to(device), t32(pk).to(device), torch.from_numpy(qc).to(device),
        base0 if clipped else None, qbits=sq.QKEY_BITS if in_key else 0,
        qmin=None if clipped else 0, qmax=sq.FREQ_CAP if clipped else sq.QKEY_MASK,
        kernels_route=kernels_route, **geo,
    )


# -- batches of the streams' key sort (ops/stream_query.py::sort_payloads,
# kernel E) ---------------------------------------------------------------------

SORT_CASES = {
    # name: (P, bits, key kind, int32 operands, index, base, index64)
    "random_30": (100_000, 30, "random", 1, True, 7_000_000, False),
    "duplicates": (50_000, 12, "few", 2, False, 0, False),
    "all_equal": (20_000, 3, "equal", 1, True, 0, False),
    "descending": (30_000, 21, "descending", 0, True, 0, True),
    "bits_1": (10_000, 1, "random", 1, True, 0, False),
    "bits_31": (40_000, 31, "random", 1, False, 0, False),
    "ragged_tile": (3 * 4096 + 123, 26, "random", 0, True, 0, True),
    "few_hundred": (300, 20, "random", 2, True, 11, False),
    "qbits_0_three_operands": (16_384, 19, "random", 2, True, 4096, False),
    "index_wraps": (5_000, 16, "random", 0, True, 2**32 - 2_000, False),
    "empty": (0, 10, "random", 1, True, 0, False),
    # the skew the main cell's batches bring
    "hot_key_10pct": (200_000, 30, "hot1", 1, False, 0, False),  # the blocked padding's key
    "hot_rows_1pct": (200_000, 26, "hot4", 0, True, 0, True),  # the classic padding's rows
    "one_bucket": (100_000, 30, "one_bucket", 1, True, 0, False),  # every key's top bits equal
    "one_pass": (100_000, 4, "random", 1, True, 0, True),  # one digit is the whole sort
}


SORT_SKEWED = ("hot_key_10pct", "hot_rows_1pct", "one_bucket", "one_pass")


def sort_case(name: str):
    """One batch of SORT_CASES: (key int32 [P] in [0, 2^bits), bits, a list
    of int32 operands [P] over the whole int32 range, index, base,
    index64)."""
    P, bits, kind, n_ops, index, base, index64 = SORT_CASES[name]
    first = sorted(n for n in SORT_CASES if n not in SORT_SKEWED)
    seed = first.index(name) + 300 if name in first else SORT_SKEWED.index(name) + 400
    rng = np.random.default_rng(seed)
    if kind == "random":
        key = rng.integers(0, 2**bits, P)
    elif kind == "few":
        key = rng.integers(0, 50, P)
    elif kind == "equal":
        key = np.full(P, 5)
    elif kind in ("hot1", "hot4"):
        key = rng.integers(0, 2**bits, P)
        hot = rng.integers(0, 2**bits, 1 if kind == "hot1" else 4)
        share = P // 10 if kind == "hot1" else P // 100
        key[rng.permutation(P)[:share * len(hot)]] = np.repeat(hot, share)
    elif kind == "one_bucket":
        key = (5 << (bits - 4)) + rng.integers(0, 2**(bits - 4), P)
    else:
        key = (2**bits - 1) - np.arange(P) * 7
    ops = [rng.integers(-(2**31), 2**31, P).astype(np.int32) for _ in range(n_ops)]
    return key.astype(np.int32), bits, ops, index, base, index64


def sort_index(P: int, base: int, index64: bool) -> np.ndarray:
    """The generated index operand base + i: int32 wrapping as uint32, or
    int64."""
    idx = np.arange(P, dtype=np.int64) + base
    return idx if index64 else (idx & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


# -- kernel F (csrc/run_counts.cu): run counts over sorted keys ----------------

RUN_TILE = 4096  # keys a tile of kernel F (ops/extract.py::RUN_TILE)
SENT_KEY = 2**63 - 1  # ops/extract.py::SENT_KEY
RUN_COUNTS_CASES = ("random", "sent_run", "long_run", "tile_edges", "all_sent", "extremes",
                    "tiny", "all_kept", "kept_late")


def run_counts_case(name: str, big: bool = False):
    """Kernel F's inputs for one of RUN_COUNTS_CASES: (sorted int64 keys
    [P], int32 weights [P] in 0-3 with zeros, for its select mode with
    weights and its partition mode), P a multiple of 8 but not of the tile. ``big`` gives the card's
    sizes: about 2.5 M keys, the padding's SENT run over 1,048,576 slots,
    runs over 40 tiles.
      random: runs of mixed lengths over signed keys, a SENT tail;
      sent_run: the SENT run spans many tiles;
      long_run: runs longer than a tile, one ending where SENT begins;
      tile_edges: runs that end on a tile's last slot, and one slot either
        side of it;
      all_sent: nothing but padding;
      extremes: keys at the ends of int64 (the sign bit set, 2^63 - 2);
      tiny: eight keys, one tile;
      all_kept: every slot its own key, no SENT: at filter 0 every tile
        keeps a full tile and compact mode's zero tail is empty;
      kept_late: one run over every tile but the last few (its start the
        only kept run and, in partition mode on its counts, the only live
        slot there), then runs of 1 to 39 and a SENT tail: a look-back
        over hundreds of tiles that keep nothing, and whole tiles whose
        slots all land past a cap."""
    rng = np.random.default_rng(RUN_COUNTS_CASES.index(name) + 500)
    T = RUN_TILE
    P = (610 if big else 5) * T + 1232
    n_sent = (1 << 20) + 4 * T + 8 if big else 2 * T + 24
    if name == "random":
        vals = rng.integers(-(2**62), 2**62, P // 3)
        s = np.sort(np.concatenate([rng.choice(vals, P - P // 20), np.full(P // 20, SENT_KEY)]))
    elif name == "sent_run":
        vals = rng.integers(0, 2**40, (P - n_sent) // 2)
        s = np.concatenate([np.sort(rng.choice(vals, P - n_sent)), np.full(n_sent, SENT_KEY)])
    elif name == "long_run":
        span = (40 if big else 1) * T + 517
        vals = np.sort(rng.integers(-(2**50), 2**50, P // 8))
        s = np.sort(rng.choice(vals, P - 2 * span - 100))
        s = np.sort(np.concatenate([s, np.full(span, vals[len(vals) // 3]),
                                    np.full(span, 2**62)]))
        s = np.concatenate([s, np.full(100, SENT_KEY)])
    elif name == "tile_edges":
        # runs ending at T - 1 (a tile's last slot), 2T - 2, 2T - 1 (one
        # slot long), 2T + 1, 3T - 2, 4T - 1 (from 3T - 1: one slot in tile 2)
        lens = [T, T - 1, 1, 2, T - 3, T + 1]
        lens += [int(x) for x in rng.integers(1, 40, (P - sum(lens)) // 40)]
        lens.append(P - sum(lens))
        s = np.repeat(np.arange(len(lens), dtype=np.int64) * 1_000_003 - 5_000_000, lens)
    elif name == "all_sent":
        s = np.full(P, SENT_KEY)
    elif name == "extremes":
        ends = [-(2**63), -(2**63) + 1, -1, 0, 2**63 - 2]
        s = np.sort(np.concatenate([np.repeat(ends, P // 10),
                                    rng.integers(-(2**63), 2**63 - 1, P - 5 * (P // 10) - 64),
                                    np.full(64, SENT_KEY)]))
    elif name == "all_kept":
        s = np.unique(rng.integers(-(2**62), 2**62, P + 64))[:P]
    elif name == "kept_late":
        late = (8 if big else 2) * T + 1232
        lens = [P - late]
        while sum(lens) < P - 104:
            lens.append(int(rng.integers(1, 40)))
        lens.append(P - 64 - sum(lens))
        s = np.concatenate([np.repeat(np.arange(len(lens), dtype=np.int64) * 7919 - 10**6, lens),
                            np.full(64, SENT_KEY)])
    else:
        s = np.array([-5, -5, 3, 3, 3, 9, SENT_KEY, SENT_KEY])
    s = s.astype(np.int64)
    assert len(s) % 8 == 0 and np.all(s[1:] >= s[:-1])
    return s, rng.integers(0, 4, len(s)).astype(np.int32)


def run_counts_ref(s: np.ndarray, w, mode: str, filter_t: int = 0, rounds: int = 0,
                   cap: int = 0):
    """A numpy reference of kernel F's contract (ops/extract.py::run_counts),
    run by run: (keys, q, n)."""
    P = len(s)
    if mode == "partition":
        order = np.concatenate([np.flatnonzero(w != 0), np.flatnonzero(w == 0)])[:cap]
        return s[order], w[order], int((w != 0).sum())
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]]) if P else np.zeros(0, np.int64)
    ends = np.r_[starts[1:], P]
    cs = np.r_[0, np.cumsum(np.ones(P, np.int64) if w is None else w, dtype=np.int64)]
    tot = cs[ends] - cs[starts]
    keep = (s[starts] != SENT_KEY) & (tot > filter_t) & (tot > 0)
    kept, kt = starts[keep], tot[keep]
    if mode == "compact":
        pk = np.zeros((P, 2), np.int32)
        u = s[kept].view(np.uint64) ^ np.uint64(1 << 63)
        pk[: len(kept)] = u.view(np.int32).reshape(-1, 2)
        q = np.zeros(P, np.int32)
        q[: len(kept)] = kt.astype(np.int32)
        return pk, q, len(kept)
    q = np.zeros(P, np.int32)
    q[kept] = kt.astype(np.int32)
    G = 1 << rounds
    if G == 1:
        return s, q, len(kept)
    sel = np.arange(0, P, G)  # each group's first slot, unless a kept start follows
    grp = kept // G
    sel[grp] = np.maximum.reduceat(kept, np.r_[0, np.flatnonzero(np.diff(grp)) + 1]) if len(
        kept) else sel[grp]
    return s[sel], q[sel], len(kept)


# -- kernel H (csrc/readid.cu): the read classifier's dispatches ------------------

PAD_POS = 2**30  # ops/query.py::PAD_POS
READID_K = 31
# order-free cases: (layout, H, C, nm, d, L); C 70 packs 3 words a row into wpad 4
READID_OF_CASES = {
    "classic_h4_c21_nm2_d1": ("classic", 4, 21, 2, 1, 160),
    "classic_h1_c5_nm1_d2": ("classic", 1, 5, 1, 2, 160),
    "classic_h2_c70_nm2_d2": ("classic", 2, 70, 2, 2, 120),
    "v1_h2_c21_nm1_d1": ("v1", 2, 21, 1, 1, 160),
    "v2_h4_c70_nm2_d1": ("v2", 4, 70, 2, 1, 100),
    "v3_h3_c5_nm2_d1": ("v3", 3, 5, 2, 1, 160),
    "v4_h4_c21_nm2_d1": ("v4", 4, 21, 2, 1, 160),
    "v4_h1_c70_nm1_d2": ("v4", 1, 70, 1, 2, 160),
    "classic_h5_c21_nm2_d1": ("classic", 5, 21, 2, 1, 64),
}
# the edges of the order-free mode's launch (a block of 256 threads a read,
# a window a thread a round): (layout, H, C, nm, d, L[, matrix]) at WR 1,
# 31, 32, 33 (a warp's lanes), 256 and 257 (a block's threads: one round or
# two), 260 (the dispatch's), 320 and 321, 1,100 and 2,100 (5 and 9
# rounds), C 32 and 33 (wpad 1 -> 2) and 0, H 5 (the run-time H), and
# "one_color":
# every present row carries one color bit and read 5's k-mers are all
# absent; READID_EDGE_READS reads
READID_OF_EDGE_CASES = {
    "wr1_classic_h4_c21": ("classic", 4, 21, 1, 1, 31),
    "wr31_v4_h4_c32": ("v4", 4, 32, 1, 1, 61),
    "wr32_classic_h4_c33": ("classic", 4, 33, 2, 1, 46),
    "wr33_v4_h3_c0": ("v4", 3, 0, 1, 1, 63),
    "wr256_classic_h5_c33": ("classic", 5, 33, 2, 1, 158),
    "wr257_v2_h4_c21": ("v2", 4, 21, 1, 1, 287),
    "wr260_classic_h4_c21_one_color": ("classic", 4, 21, 2, 1, 160, "one_color"),
    "wr260_v4_h4_c32_one_color": ("v4", 4, 32, 2, 1, 160, "one_color"),
    "wr320_v4_h4_c21": ("v4", 4, 21, 2, 1, 190),
    "wr321_classic_h2_c33": ("classic", 2, 33, 1, 1, 351),
    "wr1100_v4_h4_c21": ("v4", 4, 21, 2, 1, 580),
    "wr2100_classic_h4_c70": ("classic", 4, 70, 2, 1, 1080),
}
READID_EDGE_READS = 29
# the largest window count a read that the reads route admits (mates of
# 4,096 bp, two a read): 2 * (4096 - 31 + 1) = 8,132 keys
READID_WIDEST = ("classic", 4, 21, 2, 1, 4096)
# exact replay cases: (layout, H, C, B, order, rows64); order "sorted" keeps
# each read's k-mers together, "shuffled" puts them in no order
READID_EXACT_CASES = {
    "classic_h4_c21_b0_sorted": ("classic", 4, 21, 0, "sorted", False),
    "classic_h4_c21_b3_shuffled": ("classic", 4, 21, 3, "shuffled", False),
    "classic_h1_c5_b3_sorted": ("classic", 1, 5, 3, "sorted", False),
    "blocked_h2_c70_b0_shuffled": ("blocked", 2, 70, 0, "shuffled", False),
    "blocked_h4_c21_b5_sorted": ("blocked", 4, 21, 5, "sorted", False),
    "classic_h2_c70_b3_int64": ("classic", 2, 70, 3, "shuffled", True),
    "classic_h3_c21_b0_int64": ("classic", 3, 21, 0, "sorted", True),
    # the edges of the warp's aggregation: two reads alternating k-mer by
    # k-mer, C 32 / 33 (wpad 1 -> 2) and 0, H 5 (the run-time H), and
    # "one_color" (every present row carries one color bit; read 1's k-mers
    # are all absent)
    "classic_h4_c32_b3_alternating": ("classic", 4, 32, 3, "alternating", False),
    "blocked_h4_c33_b0_alternating": ("blocked", 4, 33, 0, "alternating", False),
    "classic_h5_c0_b3_shuffled": ("classic", 5, 0, 3, "shuffled", False),
    "blocked_h4_c21_b3_one_color": ("blocked", 4, 21, 3, "sorted", False, "one_color"),
    "classic_h4_c21_b0_one_color_int64": ("classic", 4, 21, 0, "alternating", True,
                                          "one_color"),
}
_LAYOUT_BV = {"classic": 0, "v1": 1, "v2": 2, "v3": 3, "v4": 4, "blocked": 4}


def readid_matrix(layout: str, H: int, C: int, seed: int, bloom_size: int = 4096,
                  zero_frac: float = 0.004):
    """(blocks uint32 [Rb, 128], geometry dict: num_colors, wpad, num_hash,
    bloom_size, rpb, bv) of a random index for kernel H's cases."""
    from colorid_tpu_torch.ops.query import pack_matrix_blocks

    rng = np.random.default_rng(seed)
    # C 0: rows of one random word that no color reads
    bloom, matrix, _names = rand_blocked_matrix(rng, C or 32, bloom_size, zero_frac)
    blocks, wpad = pack_matrix_blocks(matrix)
    rpb = 0 if layout == "classic" else 128 // wpad
    return blocks, dict(num_colors=C, wpad=wpad, num_hash=H, bloom_size=bloom, rpb=rpb,
                        bv=max(_LAYOUT_BV[layout], 1))


def readid_mates(rng, n_reads: int, nm: int, L: int, k: int):
    """ASCII mates [n_reads * nm, L] and their lengths for the order-free
    pass, with the edge cases up front: read 0 has no window (length 0),
    read 1 mates shorter than k, read 2 all N, read 3 a homopolymer (one
    distinct k-mer), read 4 two mates alike (nm 2) or a run of N in the
    middle; the rest random at random lengths."""
    M = n_reads * nm
    seqs = ACGT[rng.integers(0, 4, (M, L))]
    lens = rng.integers(k, L + 1, M).astype(np.int32)
    lens[:nm] = 0
    lens[nm:2 * nm] = k - 1
    seqs[2 * nm:3 * nm] = ord("N")
    seqs[3 * nm:4 * nm] = ord("A")
    lens[2 * nm:4 * nm] = L
    if nm > 1:
        seqs[4 * nm + 1], lens[4 * nm + 1] = seqs[4 * nm], lens[4 * nm]
    else:
        seqs[4, L // 3:L // 3 + 5] = ord("N")
    return seqs, lens


def _one_color(blocks: np.ndarray) -> np.ndarray:
    """The matrix with every nonzero word replaced by color 2's bit alone."""
    return np.where(blocks != 0, np.uint32(1 << 2), np.uint32(0))


def _zero_rows(blocks: np.ndarray, rows: np.ndarray, geo: dict) -> None:
    """Zeroes the wpad words of each row of rows [N, H], as kernel H reads
    them (classic r * wpad; blocked the block of hash 0's row, lanes (r %
    rpb) * wpad): every such k-mer is absent."""
    rpb, wpad = geo["rpb"], geo["wpad"]
    r = rows.astype(np.int64)
    starts = r * wpad if not rpb else (r[:, :1] // rpb) * 128 + (r % rpb) * wpad
    flat = blocks.reshape(-1)
    for w in range(wpad):
        flat[starts.reshape(-1) + w] = 0


def readid_orderfree_case(layout: str, H: int, C: int, nm: int, d: int, L: int,
                          matrix: str = "random", n_reads: int = 24, seed: int = 0):
    """Inputs of query_readid_orderfree_reads: (blocks, words, valid bits,
    lens) as numpy arrays and its keyword arguments; matrix "one_color":
    every nonzero word is color 2's bit alone and read 5's k-mers are all
    absent."""
    from colorid_tpu_torch.ops.extract import pack_reads_valid, window_keys
    from colorid_tpu_torch.ops.hash_torch import device_rows

    # one_color: a larger matrix, so that read 5's rows are few of its rows
    blocks, geo = readid_matrix(layout, H, C, seed,
                                bloom_size=1 << 16 if matrix == "one_color" else 4096)
    rng = np.random.default_rng(seed + 1)
    seqs, lens = readid_mates(rng, n_reads, nm, L, READID_K)
    words, vb = pack_reads_valid(seqs)
    kw = dict(geo, num_reads=n_reads, k=READID_K, L=L, nm=nm, d=d)
    if matrix == "one_color":
        blocks = _one_color(blocks)
        m = slice(5 * nm, 6 * nm)
        keys = window_keys(t32(words[m]), torch.from_numpy(lens[m]), t32(vb[m]), k=READID_K,
                           L=L, d=d).reshape(-1)
        keys = keys[keys != torch.iinfo(torch.int64).max]
        rows = device_rows(keys, k=READID_K, num_hash=H, bloom_size=geo["bloom_size"],
                           rpb=geo["rpb"], version=geo["bv"])
        _zero_rows(blocks, rows.numpy(), geo)
    return blocks, words, vb, lens, kw


def readid_exact_case(layout: str, H: int, C: int, B: int, order: str, rows64: bool,
                      matrix: str = "random", N: int = 3000, n_reads: int = 64,
                      seed: int = 0):
    """Inputs of query_readid_batch / _firsthit: (blocks, rows [N, H] (int64
    where rows64), seg, pos) as numpy arrays and the keyword arguments.
    Reads 0..n_reads-9 hold the k-mers at positions 0.. in a random order;
    the last 8 reads none; 40 padding k-mers (PAD_POS) carry read 0, as a
    padding mate's windows do; "shuffled" puts every k-mer in no order,
    "alternating" the k-mers of reads 2m and 2m + 1 in turns. Matrix
    "one_color": every nonzero word is color 2's bit alone, and read 1's
    k-mers are all absent (on a larger matrix, so that its rows are few of
    its rows)."""
    blocks, geo = readid_matrix(layout, H, C, seed, zero_frac=0.01,
                                bloom_size=1 << 16 if matrix == "one_color" else 4096)
    rng = np.random.default_rng(seed + 2)
    seg = np.sort(rng.integers(0, n_reads - 8, N)).astype(np.int32)
    pos = np.zeros(N, dtype=np.int32)
    for r in range(n_reads - 8):
        m = seg == r
        pos[m] = rng.permutation(int(m.sum()))
    seg[N // 2:N // 2 + 40] = 0
    pos[N // 2:N // 2 + 40] = PAD_POS
    rows = rng.integers(0, geo["bloom_size"], (N, H))
    if geo["rpb"]:
        rpb = geo["rpb"]
        rows = rows[:, :1] // rpb * rpb + rng.integers(0, rpb, (N, H))
    if order == "shuffled":
        perm = rng.permutation(N)
        rows, seg, pos = rows[perm], seg[perm], pos[perm]
    elif order == "alternating":
        turn = np.zeros(N, dtype=np.int64)
        for r in range(n_reads):
            idx = np.flatnonzero(seg == r)
            turn[idx] = (r // 2) * 2 * N + 2 * np.arange(idx.size) + r % 2
        perm = np.argsort(turn, kind="stable")
        rows, seg, pos = rows[perm], seg[perm], pos[perm]
    if matrix == "one_color":
        blocks = _one_color(blocks)
        _zero_rows(blocks, rows[seg == 1], geo)
    rows = rows.astype(np.int64 if rows64 else np.int32)
    kw = dict(num_reads=n_reads, start_sample=B, num_colors=C, wpad=geo["wpad"],
              rpb=geo["rpb"])
    return blocks, rows, seg, pos, kw


# -- inputs of the generic gather (ops/query.py::_accumulate_one and its twin,
# csrc/epilogue.cu's gather mode) ---------------------------------------------

GATHER_N = 2 * 2048 + 37  # k-mers a batch: off both tiles (2,048 rows at W 1, 512 beyond)


def gather_matrix(rng, C: int, H: int, bloom: int, hot: bool = False) -> np.ndarray:
    """A random uint32 [bloom, W] matrix whose density makes the AND of H
    distinct rows hit about one color, so unique hits are common (``hot``:
    only colors 0, C // 2 and C - 1 are ever set); bits past C in the last
    word of a third of the rows (every word is read, only the counts drop
    them); 5 % of the rows all zero (their k-mers are absent)."""
    W = (C + 31) // 32
    cols = np.array(sorted({0, C // 2, C - 1})) if hot else np.arange(C)
    density = min(0.9, len(cols) ** (-1 / H) * (0.8 if H > 1 else 1.0))
    bits = np.zeros((bloom, W * 32), dtype=bool)
    bits[:, cols] = rng.random((bloom, len(cols))) < density
    if C % 32:
        high = rng.random(bloom) < 1 / 3
        bits[high, C:] = rng.random((int(high.sum()), W * 32 - C)) < 0.5
    matrix = np.packbits(bits, axis=1, bitorder="little").view(np.uint32)
    matrix[rng.random(bloom) < 0.05] = 0
    return matrix


def gather_case(C: int, H: int, layout: str, seed: int, n: int = GATHER_N,
                hot: bool = False, rows64: bool = False, bloom: int = 4096):
    """Inputs of _accumulate_one: (blocks uint32 [Rb, 128], rows [n, H]
    (int64 where rows64, else int32), mask, q, gidx, wpad, rpb) as numpy
    arrays. "classic": independent rows; "blocked": a k-mer's rows share
    one block of rpb = 128 // wpad rows (wpad <= 128). The last tenth of
    the batch is padding (mask False, q 0); frequencies straddle FREQ_CAP
    and run far past it, or with ``hot`` stay in 0-18."""
    from colorid_tpu_torch.ops.query import pack_matrix_blocks

    from colorid_tpu_torch.ops.query import row_wpad

    rng = np.random.default_rng(seed)
    # a blocked k-mer's H rows lie among the rpb rows of one block
    rpb = 128 // row_wpad((C + 31) // 32) if layout == "blocked" else 0
    blocks, wpad = pack_matrix_blocks(gather_matrix(rng, C, min(H, rpb or H), bloom, hot))
    rows = rng.integers(0, bloom, (n, H))
    if rpb:
        rows = rows[:, :1] // rpb * rpb + rng.integers(0, rpb, (n, H))
    q = epi_qcounts(rng, n, hot=hot)
    mask = np.ones(n, dtype=bool)
    mask[n - n // 10:] = False
    q[~mask] = 0
    gidx = rng.integers(0, 2**31, n).astype(np.int32)
    return (blocks, rows.astype(np.int64 if rows64 else np.int32), mask, q, gidx, wpad,
            rpb)
