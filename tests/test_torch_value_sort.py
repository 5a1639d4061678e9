"""The reads routes' value sort (colorid_tpu_torch/ops/extract.py::
value_sort, kernel G, on CPU tensors: its plain twin value_sort_plain)
against the JAX package's sort of the canonical windows (jax.lax.sort((hi,
lo), num_keys=2), as colorid_tpu/ops/extract.py and fused_reads.py sort
them, and lax.sort((hi, lo, qc), num_keys=2) of the merges) and against
torch.sort(stable) with the payload gathered through its permutation, on
the CPU: windows of numpy-seeded reads with N bases, short reads (SENT
slots), all-T, all-A and palindromic reads and heavy duplicates, at k 1,
15, 16, 17, 21, 31 and 32. Integers: tolerance 0, element for element.
The kernel runs only on a CUDA card (tests/test_torch_cuda.py)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu.ops import extract as je
from colorid_tpu_torch.ops import extract as te
from colorid_tpu_torch.ops import fused_reads as tf
from colorid_tpu_torch.parallel import sharded as tsh
from tests import torch_support as ts

KS = [1, 15, 16, 17, 21, 31, 32]
L = 96


def _revcomp(s: np.ndarray) -> np.ndarray:
    return ts._COMP[s[::-1]]


def _reads(k: int):
    """200 reads of up to L bases: random ones with N bases and true
    lengths from below k up to L; all T, all A, palindromes (a half and its
    reverse complement); and one read repeated 40 times."""
    rng = np.random.default_rng(1000 + k)
    R = 200
    seqs = ts.ACGT[rng.integers(0, 4, (R, L))]
    seqs[rng.random((R, L)) < 0.01] = ord("N")
    lens = rng.integers(max(1, k - 2), L + 1, R).astype(np.int32)
    seqs[0] = ord("T")
    seqs[1] = ord("A")
    for r in (2, 3):
        half = ts.ACGT[rng.integers(0, 4, L // 2)]
        seqs[r] = np.concatenate([half, _revcomp(half)])
    seqs[4, : L // 2] = ord("T")
    seqs[160:200] = seqs[5]
    lens[:6] = L
    lens[160:200] = L
    return seqs, lens


def _windows(k: int):
    """The JAX package's (lo, hi) uint32 limbs of every window, all ones
    where the window is not counted (extract_count's construction), and the
    port's int64 sort keys of the same windows (window_keys' twin)."""
    seqs, lens = _reads(k)
    words, vbits = te.pack_reads_valid(seqs)
    NW = L - k + 1
    lo, hi = je._window_limbs(je._unpack_codes(jnp.asarray(words), L), k, NW)
    valid = (np.arange(NW)[None, :] + k <= lens[:, None]) & np.asarray(
        je._window_valid_ok(jnp.asarray(vbits), L, k, NW))
    sent = np.uint32(0xFFFFFFFF)
    lo = np.where(valid, np.asarray(lo), sent).reshape(-1)
    hi = np.where(valid, np.asarray(hi), sent).reshape(-1)
    return lo, hi, _window_keys(k)


def _limbs(key: torch.Tensor):
    lo, hi = te._key_limbs(key)
    return lo.numpy().astype(np.uint32), hi.numpy().astype(np.uint32)


def _qc(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 7, n).astype(np.int32)


@pytest.mark.parametrize("k", KS)
def test_twin_matches_jax_lax_sort(k):
    """The twin (which a CPU tensor takes; no launch) equals lax.sort((hi,
    lo), num_keys=2) of the same windows, SENT slots last; the windows hold
    SENT slots, duplicates and, from the all-T read, the key 0."""
    lo, hi, key = _windows(k)
    s_hi, s_lo = jax.lax.sort((jnp.asarray(hi), jnp.asarray(lo)), num_keys=2)
    before = te.value_sort.launches
    got = te.value_sort(key, bits=2 * k)
    assert te.value_sort.launches == before
    g_lo, g_hi = _limbs(got)
    np.testing.assert_array_equal(g_hi, np.asarray(s_hi))
    np.testing.assert_array_equal(g_lo, np.asarray(s_lo))
    n_sent = int((key == te.SENT_KEY).sum())
    assert n_sent > 0 and bool((got[-n_sent:] == te.SENT_KEY).all())
    assert len(torch.unique(key)) < key.numel() - n_sent  # heavy duplicates
    assert bool((key == te._sort_key(torch.tensor(0), torch.tensor(0))).any())  # all T


@pytest.mark.parametrize("k", KS)
def test_twin_equals_stable_torch_sort(k):
    """Keys only and with an int32 payload: torch.sort(stable) of the keys,
    the payload gathered through its permutation, bit for bit."""
    _lo, _hi, key = _windows(k)
    q = torch.from_numpy(_qc(key.numel(), k))
    want = torch.sort(key, stable=True)
    assert torch.equal(te.value_sort(key, bits=2 * k), want.values)
    got_k, got_q = te.value_sort(key, q, bits=2 * k)
    assert got_k.dtype == torch.int64 and got_q.dtype == torch.int32
    assert torch.equal(got_k, want.values) and torch.equal(got_q, q[want.indices])


@pytest.mark.parametrize("k", KS)
def test_payload_mode_matches_the_jax_merge(k):
    """With the counts as payload: lax.sort((hi, lo, qc), num_keys=2), the
    merge's sort, gives the same keys and the same per-run sums of qc (its
    order among equal keys is not fixed), and the twin is torch.sort(stable)
    with the gather, bit for bit; the inputs are untouched."""
    lo, hi, key = _windows(k)
    qc = _qc(key.numel(), 100 + k)
    s_hi, s_lo, s_qc = jax.lax.sort((jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(qc)),
                                    num_keys=2)
    key0, q = key.clone(), torch.from_numpy(qc.copy())
    got_k, got_q = te.value_sort(key, q, bits=2 * k)
    assert torch.equal(key, key0) and np.array_equal(q.numpy(), qc)
    g_lo, g_hi = _limbs(got_k)
    np.testing.assert_array_equal(g_hi, np.asarray(s_hi))
    np.testing.assert_array_equal(g_lo, np.asarray(s_lo))
    starts = np.flatnonzero(np.r_[True, got_k.numpy()[1:] != got_k.numpy()[:-1]])
    np.testing.assert_array_equal(np.add.reduceat(got_q.numpy(), starts),
                                  np.add.reduceat(np.asarray(s_qc), starts))
    perm = torch.sort(key, stable=True).indices
    assert torch.equal(got_q, q[perm])


@pytest.mark.parametrize("k", range(1, 33))
def test_no_canonical_key_has_all_ones_in_its_low_2k_bits(k):
    """The key contract the LSD sort over 2k bits stands on: every
    canonical window's key ^ 2^63 (its 2k-bit value) is below 2^(2k) and
    not all ones there, so SENT_KEY alone sorts last; exhaustively for
    k <= 7, on the windows of random, all-T and all-A reads above."""
    if k <= 7:
        v = np.arange(4**k, dtype=np.int64)
        rc = np.zeros_like(v)
        for j in range(k):
            rc |= (3 - ((v >> (2 * j)) & 3)) << (2 * (k - 1 - j))
        canon = torch.from_numpy(np.minimum(v, rc))
    else:
        key = _window_keys(k)
        canon = key[key != te.SENT_KEY] ^ te._FLIP
    mask = (1 << (2 * k)) - 1 if k < 32 else -1
    assert bool((canon & mask == canon).all()) and not bool((canon & mask == mask).any())
    assert (te.SENT_KEY ^ te._FLIP) & mask == mask


def _window_keys(k: int):
    seqs, lens = _reads(k)
    words, vbits = te.pack_reads_valid(seqs)
    return te.window_keys(ts.t32(words), torch.from_numpy(lens), ts.t32(vbits), k=k,
                          L=L).reshape(-1)


@pytest.mark.parametrize("dmax", [8, 9, 10, 11])
def test_passes_cover_exactly_bits(monkeypatch, dmax):
    """G's digit widths for every bits of 2-64 at each widest digit the
    kernel takes: ceil(bits / dmax) digits that sum to bits, none wider than
    dmax and none two bits narrower than another. The twin sorts with
    them, so that its passes are the kernel's."""
    monkeypatch.setattr(te, "VALUE_SORT_DIGIT_BITS", dmax)
    for bits in range(2, 65):
        w = te.value_sort_passes(bits)
        assert sum(w) == bits and len(w) == -(-bits // dmax), bits
        assert max(w) <= dmax and max(w) - min(w) <= 1, bits
    _lo, _hi, key = _windows(31)
    assert torch.equal(te.value_sort_plain(key, bits=62), torch.sort(key, stable=True).values)


def test_default_passes_at_the_cells_k():
    """The default widest digit, 9 bits (sort_bench.py's fastest at k 31):
    7 passes at the cell's 62 bits, a run of 16 keys a digit in a tile."""
    assert te.value_sort_passes(62) == [9, 9, 9, 9, 9, 9, 8]
    assert len(te.value_sort_passes(30)) == 4 and len(te.value_sort_passes(54)) == 6
    assert te.VALUE_SORT_TILE >> max(te.value_sort_passes(62)) == 16
    assert te.VALUE_SORT_TILE < 2**16  # a key's place in its tile is a uint16


def test_passes_are_lsd_stable():
    """Each prefix of G's passes leaves the keys ordered by the bits sorted
    so far, ties in input order (checked through a payload that is the
    index)."""
    _lo, _hi, key = _windows(31)
    idx = torch.arange(key.numel(), dtype=torch.int32)
    shift = 0
    for w in te.value_sort_passes(62):
        shift += w
        low = ((key ^ te._FLIP) & ((1 << shift) - 1)) ^ te._FLIP  # the low bits alone
        part, pidx = te.value_sort(low, idx, bits=shift)
        v = (part ^ te._FLIP) & ((1 << shift) - 1)
        assert bool((v[1:] >= v[:-1]).all())
        ties = v[1:] == v[:-1]
        assert bool((pidx[1:][ties] > pidx[:-1][ties]).all())


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _lo, _hi, key = _windows(15)
    q = torch.from_numpy(_qc(key.numel(), 3))
    with pytest.raises(TypeError, match="int64"):
        te.value_sort(key.to(torch.int32), bits=30)
    with pytest.raises(TypeError, match="contiguous"):
        te.value_sort(key[::2], bits=30)
    with pytest.raises(ValueError, match="payload"):
        te.value_sort(key, q[1:], bits=30)
    with pytest.raises(ValueError, match="payload"):
        te.value_sort(key, q.to(torch.int64), bits=30)
    for bits in (0, 1, 65):
        with pytest.raises(ValueError, match="bits"):
            te.value_sort(key, bits=bits)
    with pytest.raises(ValueError, match="device"):
        te.value_sort(key.to("meta"), bits=30)


def test_edge_sizes_and_scratch():
    """P = 0 and 1, all SENT and one distinct key through the twin; the
    kernel's scratch: histograms, counters and the stats words (the runs
    and SENT counts, the keys by their low digits all ones, the passes' SENT
    tails, the descents' places), status words (twice as many int32 where
    wide) and the first pass's tile and chunk counts."""
    e = torch.empty(0, dtype=torch.int64)
    assert te.value_sort(e, bits=62).numel() == 0
    one = torch.tensor([5 ^ te._FLIP])
    assert torch.equal(te.value_sort(one, torch.tensor([7], dtype=torch.int32), bits=62)[0], one)
    for key in (torch.full((9000,), te.SENT_KEY), torch.full((9000,), 3 ^ te._FLIP)):
        assert torch.equal(te.value_sort(key, bits=62), key)
    T = te.VALUE_SORT_TILE
    n_tiles = 3
    head = 8 * 2048 + 8 * 32 + 352  # histograms, counters, the stats words (330, padded)
    later = (5 * 512 + 256) * n_tiles
    first = (n_tiles + 1) * 512
    assert te._value_sort_scratch(3 * T, 62, False) == head + later + first
    assert te._value_sort_scratch(3 * T, 62, True) == head + 2 * later + first
    assert head % 32 == 0  # the status words after the head start 128-byte aligned


@pytest.mark.parametrize("fn,bits", [
    (te.extract_count, "2 * k)"), (te.count_histogram, "2 * k)"),
    (tf.fused_search_reads, "2 * k)"), (tf.extract_sorted_counts, "2 * k)"),
    (tf.fused_merge_query, "64, runs=True)"), (tsh.extract_merge_datashard, "2 * k, runs=True)"),
])
def test_the_six_sites_sort_with_kernel_g(fn, bits):
    """Each of the reads routes' value sorts goes through value_sort, none
    through torch.sort: over 2k bits where the function made its keys from
    windows itself, over 64 where they come from its caller (the fused
    merge's chunk streams); the two merges, whose keys come as sorted runs,
    with the runs hint and no other site."""
    src = inspect.getsource(fn)
    assert "torch.sort" not in src and src.count("value_sort(") == 1
    assert f"bits={bits}" in src
    assert ("runs=True" in src) == ("runs=True" in bits)


@pytest.mark.parametrize("k", [15, 31])
def test_sites_call_value_sort_over_2k_bits(monkeypatch, k):
    """extract_count, count_histogram and a chunk's extract_sorted_counts
    sort their windows once each through value_sort with bits 2k, and give
    what a torch.sort of the same windows gives."""
    seqs, lens = _reads(k)
    words, vbits = te.pack_reads_valid(seqs)
    args = (ts.t32(words), torch.from_numpy(lens), ts.t32(vbits))
    calls = []
    real = te.value_sort

    def recorder(key, payload=None, *, bits):
        calls.append(bits)
        return real(key, payload, bits=bits)

    monkeypatch.setattr(te, "value_sort", recorder)
    monkeypatch.setattr(tf, "value_sort", recorder)
    pk, qc, n = te.extract_count(*args, k=k, L=L, filter_t=1)
    hist = te.count_histogram(*args, k=k, L=L, cap=64)
    s, q, _n = tf.extract_sorted_counts(*args, k=k, L=L, d=1)
    assert calls == [2 * k] * 3
    want = torch.sort(te.window_keys(*args, k=k, L=L).reshape(-1)).values
    assert torch.equal(s, want)
    assert torch.equal(pk, te.run_counts(want, mode="compact", filter_t=1)[0])
    assert int(n) > 0 and int(hist.sum()) > 0


# -- kernel G's merge mode: its twin value_merge_plain and the path rule ---------


def _lax_stable(key: torch.Tensor, qc: torch.Tensor):
    """jax.lax.sort((hi, lo, qc), num_keys=2, is_stable=True) of the keys'
    (hi, lo) limbs of key ^ 2^63: the merges' sort in the JAX package, its
    ties kept in input order. Returns (keys, qc) as numpy arrays."""
    lo, hi = _limbs(key)
    s_hi, s_lo, s_qc = jax.lax.sort((jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(qc.numpy())),
                                    num_keys=2, is_stable=True)
    k = (np.asarray(s_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(s_lo).astype(np.uint64)
    return (k ^ np.uint64(1 << 63)).view(np.int64), np.asarray(s_qc)


def _merge_holds(key, qc, bits, what):
    """value_merge_plain equals lax.sort's stable sort and value_sort_plain
    bit for bit, and value_sort with the runs hint (no launch on a CPU
    tensor) equals it; returns the runs found."""
    got_k, got_q = te.value_merge_plain(key, qc, bits=bits)
    want_k, want_q = _lax_stable(key, qc)
    np.testing.assert_array_equal(got_k.numpy(), want_k, err_msg=what)
    np.testing.assert_array_equal(got_q.numpy(), want_q, err_msg=what)
    lsd = te.value_sort_plain(key, qc, bits=bits)
    assert torch.equal(got_k, lsd[0]) and torch.equal(got_q, lsd[1]), what
    before = te.value_sort.launches
    hinted = te.value_sort(key, qc, bits=bits, runs=True)
    assert te.value_sort.launches == before
    assert torch.equal(hinted[0], got_k) and torch.equal(hinted[1], got_q), what
    assert torch.equal(te.value_merge_plain(key, bits=bits), got_k), what
    return te.value_sort_runs(key, bits)


def _chunk_rows(S: int, k: int, cap: str):
    """The chunked route's merge input on the seeded reads of _reads(k):
    S chunks of reads, each through extract_sorted_counts and
    compact_sorted (live slots in key order, then dead ones) at the
    engine's cap (a power of two of at least 2^20, so every slot) or at
    half the chunks' most distinct keys (rows of live slots only), the
    rows flattened and padded with SENT as fused_merge_query does."""
    seqs, lens = _reads(k)
    words, vbits = te.pack_reads_valid(seqs)
    Rc = -(-seqs.shape[0] // S)
    outs = [tf.extract_sorted_counts(ts.t32(words[c * Rc:(c + 1) * Rc]),
                                     torch.from_numpy(lens[c * Rc:(c + 1) * Rc]),
                                     ts.t32(vbits[c * Rc:(c + 1) * Rc]), k=k, L=L, d=1)
            for c in range(S)]
    n_max = max(int(o[2]) for o in outs)
    width = min(o[0].numel() for o in outs)
    c = min(1 << max(20, n_max.bit_length()), width) if cap == "engine" else n_max // 2
    rows = [tf.compact_sorted(s, q, cap=c) for s, q, _n in outs]
    return tf._pad_sent(torch.cat([r[0] for r in rows]), torch.cat([r[1] for r in rows]), 64)


@pytest.mark.parametrize("S", [2, 5])
@pytest.mark.parametrize("cap", ["engine", "half"])
def test_merge_twin_on_the_chunked_routes_rows(S, cap):
    """S rows of live-sorted then dead-sorted slots from compact_sorted on
    seeded reads (k 31, over all 64 bits as fused_merge_query sorts them):
    the merge twin is lax.sort's stable sort; up to 2 S runs (a row of
    live slots only, or whose dead slots are all SENT, is one run)."""
    key, qc = _chunk_rows(S, 31, cap)
    runs = _merge_holds(key, qc, 64, f"S={S} cap={cap}")
    assert S <= runs <= 2 * S and (runs > S if cap == "engine" else runs < 2 * S)


@pytest.mark.parametrize("nd", [2, 4])
def test_merge_twin_on_the_data_shard_slices(monkeypatch, nd):
    """The n_data slices that extract_merge_datashard hands kernel G (each
    its kept keys in order, then SENT; the counts as payload, over 2k
    bits), recorded from the function itself on a CPU mesh: n_data runs,
    merged as lax.sort's stable sort."""
    seqs, lens = _reads(27)
    words, _vbits = te.pack_reads_valid(seqs)
    seen = []
    real = te.value_sort

    def recorder(key, payload=None, *, bits, runs=False):
        seen.append((key.clone(), payload.clone(), bits, runs))
        return real(key, payload, bits=bits, runs=runs)

    monkeypatch.setattr(tsh, "value_sort", recorder)
    mesh = tsh.make_mesh(nd, 1, "row", devices=["cpu"])
    tsh.extract_merge_datashard(ts.t32(words), torch.from_numpy(lens), mesh=mesh, k=27, L=L,
                                filter_t=1)
    (key, qc, bits, runs), = seen
    assert bits == 54 and runs
    assert _merge_holds(key, qc, bits, f"n_data={nd}") == nd


def _sorted_runs(lengths, *, seed, bits, values=None):
    """Runs of the given lengths, each sorted under ``bits``, of seeded
    window keys at k 31 (or of ``values`` drawn at random: equal keys in
    every run), and a distinct payload."""
    rng = np.random.default_rng(seed)
    pool = _window_keys(31) if values is None else values
    parts = [te.value_sort_plain(pool[torch.from_numpy(rng.integers(0, pool.numel(), n))],
                                 bits=bits) for n in lengths]
    key = torch.cat(parts) if parts else torch.empty(0, dtype=torch.int64)
    return key, torch.from_numpy(rng.permutation(key.numel()).astype(np.int32))


@pytest.mark.parametrize("case", ["ties in every run", "a SENT tail in every run",
                                  "runs at the tile edges", "one run", "no keys",
                                  "runs of one key", "odd run count"])
@pytest.mark.parametrize("bits", [62, 64])
def test_merge_twin_edge_cases(case, bits):
    """Equal keys in every run with distinct payloads (the stable merge
    keeps run order among ties), runs that each end in SENT keys with
    distinct payloads (as the data-shard slices do), runs that meet at the
    edges of G's merge tiles and pass tiles, one run (copied through), no
    keys, runs of one key, an odd run count (a run without a partner copied
    through)."""
    T, M = te.VALUE_SORT_TILE, te.VALUE_SORT_MERGE_TILE
    few = _window_keys(31)[:5]
    lengths, values = {
        "ties in every run": ([700, 300, 900, 41], few),
        "a SENT tail in every run": ([500, 260, 333],
                                     torch.cat([few[:2], torch.tensor([te.SENT_KEY])])),
        "runs at the tile edges": ([M, T - M, M - 1, 1, T + 1], None),
        "one run": ([3 * M + 5], None),
        "no keys": ([], None),
        "runs of one key": ([1] * 9, None),
        "odd run count": ([M + 3, 17, 2 * M, 5, 999], None),
    }[case]
    key, qc = _sorted_runs(lengths, seed=hash(case) % 1000, bits=bits, values=values)
    runs = _merge_holds(key, qc, bits, case)
    # a run continues the one before it where its first key does not sort
    # below that run's last key (a run of one key, or of a few values, or by
    # chance): the runs found are one more than the descents at the joins
    u = (key.numpy().view(np.uint64) ^ np.uint64(1 << 63)) & np.uint64(2**bits - 1)
    joins = np.cumsum(lengths, dtype=np.int64)[:-1]
    want = int((u[joins] < u[joins - 1]).sum()) + 1 if key.numel() else 0
    assert runs == want <= len(lengths)
    if values is not None:  # stability: within a key, the payload in run order
        got_k, got_q = te.value_merge_plain(key, qc, bits=bits)
        src = torch.empty_like(qc)
        src[qc.long()] = torch.arange(qc.numel(), dtype=torch.int32)
        order = src[got_q.long()]
        ties = got_k[1:] == got_k[:-1]
        assert bool(ties.any()) and bool((order[1:][ties] > order[:-1][ties]).all())


def test_runs_follow_the_sorts_own_comparison():
    """The runs are found under the low ``bits`` bits of key ^ 2^63,
    unsigned, not the int64 order: keys ascending as int64 whose low 4
    bits descend are runs there, and keys whose high bits descend but low
    bits ascend are one run; the merge twin sorts as the LSD twin does."""
    up = torch.tensor([0, 16, 32, 48], dtype=torch.int64) + torch.tensor([3, 2, 1, 0])
    assert te.value_sort_runs(up, 64) == 1 and te.value_sort_runs(up, 4) == 4
    down = torch.tensor([48, 32, 16, 0], dtype=torch.int64) + torch.tensor([0, 1, 2, 3])
    assert te.value_sort_runs(down, 64) == 4 and te.value_sort_runs(down, 4) == 1
    assert te.value_sort_runs(torch.tensor([-5, -1, 0, 7]), 64) == 1
    for key in (up, down):
        for bits in (4, 5, 64):
            assert torch.equal(te.value_merge_plain(key, bits=bits),
                               te.value_sort_plain(key, bits=bits))


def test_merge_path_rule_is_pinned():
    """The path rule's twin: the most merge rounds that cost less than the
    upsweep and the passes at each bits, from the card's measured times
    (VALUE_SORT_*_MS), and the device's path for a run count: the rounds
    (at least one) or 0 for the LSD passes."""
    assert [te.value_sort_merge_max_rounds(b) for b in (2, 18, 30, 54, 62, 64)] == RULE_MAX
    mr = te.value_sort_merge_max_rounds(64)
    assert [te.value_sort_merge_rounds(r, 64) for r in (1, 2, 3, 4, 5, 6)] == [1, 1, 2, 2, 3, 3]
    assert te.value_sort_merge_rounds(2 ** mr, 64) == mr
    assert te.value_sort_merge_rounds(2 ** mr + 1, 64) == 0
    assert te.value_sort_merge_rounds(10**6, 62) == 0
    assert te.VALUE_SORT_MAX_ROUNDS == 8  # the kernel lists 255 descents
    for bits in range(2, 65):
        r = te.value_sort_merge_max_rounds(bits)
        lsd = te.VALUE_SORT_UPSWEEP_MS + len(te.value_sort_passes(bits)) * te.VALUE_SORT_PASS_MS
        assert 0 <= r <= 8 and (r == 8 or (r + 1) * te.VALUE_SORT_ROUND_MS >= lsd)
        assert r == 0 or r * te.VALUE_SORT_ROUND_MS < lsd


RULE_MAX = [1, 2, 4, 6, 8, 8]  # from the card's round and pass times (PERF.md, the path rule)


@pytest.mark.parametrize("k", [15, 31])
def test_sent_tails_rule(k):
    """value_sort_sent_tails, the twin of the rule by which kernel G's later
    passes leave the SENT keys at the tail: never the first pass; pass q
    where no key but SENT has its q low digits all ones. On the windows of
    _reads(k) the tail is pure from the second pass on (no window key has a
    first digit of all ones here), and a key with its low 18 bits all ones
    keeps it mixed through the second pass; the LSD twin's order then has
    every SENT key at the tail, and a stable sort of the rest below it."""
    key = _window_keys(k)
    bits = 2 * k
    n_sent = int((key == te.SENT_KEY).sum())
    npass = len(te.value_sort_passes(bits))
    tails = te.value_sort_sent_tails(key, bits)
    assert len(tails) == npass and tails[0] == 0 and n_sent > 0
    assert all(t in (0, n_sent) for t in tails) and tails[1] == n_sent
    assert tails == sorted(tails)  # once pure, pure in every later pass
    mixed = key.clone()
    mixed[3] = (mixed[3] | ((1 << 18) - 1)) if mixed[3] != te.SENT_KEY else mixed[3]
    mixed[7] |= (1 << 18) - 1
    first = te.value_sort_passes(bits)[0]
    cut = 1 + (18 >= first) + (18 >= sum(te.value_sort_passes(bits)[:2]))
    assert te.value_sort_sent_tails(mixed, bits)[:cut] == [0] * cut
    got = te.value_sort_plain(mixed, bits=bits)
    assert bool((got[-n_sent:] == te.SENT_KEY).all())
