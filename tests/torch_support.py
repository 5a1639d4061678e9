"""Shared fixtures and synthetic inputs of the PyTorch port's tests
(tests/test_torch_*.py): random genomes and reads made from a numpy seed,
so both packages see the same bytes."""

import gzip
import os

import numpy as np
import pytest
import torch

# pytest-xdist runs several workers at once; torch's default of one
# intra-op thread per core in each of them oversubscribes the CPU and slows
# the port's tests tenfold
torch.set_num_threads(1)

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
