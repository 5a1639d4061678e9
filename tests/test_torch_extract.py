"""The port's device k-mer extraction (colorid_tpu_torch/ops/extract.py) and
QueryEngine.search_reads / count_reads_histogram against the JAX package's
(colorid_tpu/ops/extract.py, engine.py), on the CPU: the same seeded reads
through both, every output equal (tolerance zero: integers and bit views).

Reads carry N bases (the validity bitplane), duplicates (counts > 1),
all-T reads (canonical A^k at k = 32, the key's top bit), lengths below L
and below k. search_reads runs on a classic, a blocked v1 and a blocked v4
index. Both engines answer v4 through the fused pipeline (ops/fused_reads.py;
tests/test_torch_fused.py tests it function by function), so there the
overflow list is compared in order. The JAX engine answers the other
indexes through the generic gather; the port sends a dense batch through
the classic or the blocked probe stream and a sparse one through the
generic gather. Where the routes differ the overflow list is compared as a
multiset."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu.engine import QueryEngine as JEngine
from colorid_tpu.index.bigsi import BigsiIndex as JIndex
from colorid_tpu.ops import extract as je
from colorid_tpu.pipelines.build import build_index as jbuild
from colorid_tpu_torch import convert
from colorid_tpu_torch.engine import QueryEngine as TEngine
from colorid_tpu_torch.ops import extract as te
from tests import torch_support as ts


def _reads(seed: int, R: int, L: int, k: int):
    """uint8 [R, L] reads with N bases, duplicate rows, an all-T and an
    all-A read, and int32 true lengths (some below k, some below L)."""
    rng = np.random.default_rng(seed)
    seqs = ts.ACGT[rng.integers(0, 4, (R, L))]
    seqs[3, 40] = seqs[5, 0] = seqs[6, L - 1] = ord("N")
    seqs[7:12] = seqs[12:17]
    seqs[20:24] = seqs[24]
    seqs[25] = ord("T")
    seqs[26] = ord("A")
    lens = rng.integers(L - 20, L + 1, R).astype(np.int32)
    lens[:4] = L
    lens[30] = k - 1
    return seqs, lens


def _both(R, L, k, seed):
    seqs, lens = _reads(seed, R, L, k)
    w, vb = je.pack_reads_valid(seqs)
    return (w, vb, lens), (ts.t32(w), ts.t32(vb), torch.from_numpy(lens))


def test_pack_functions_match_jax():
    seqs, _ = _reads(1, 40, 151, 31)
    seqs[9, 3] = ord("a")
    assert te.words_per_read(151) == je.words_per_read(151) == 10
    assert je.pack_reads(seqs) is None and te.pack_reads(seqs) is None
    clean = seqs[30:]
    np.testing.assert_array_equal(te.pack_reads(clean), je.pack_reads(clean))
    for name in ("pack_reads_masked", "pack_reads_valid"):
        for want, got in zip(getattr(je, name)(seqs), getattr(te, name)(seqs)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(te.pack_reads_any(seqs), je.pack_reads_any(seqs))


@pytest.mark.parametrize("L", [150, 151])
@pytest.mark.parametrize("k", [15, 27, 31, 32])
def test_window_helpers_match_jax(k, L):
    (w, vb, _), (tw, tvb, _) = _both(48, L, k, seed=k + L)
    NW = L - k + 1
    codes = te._unpack_codes(tw, L)
    want_codes = np.asarray(je._unpack_codes(jnp.asarray(w), L))
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    lo, hi = te._window_limbs(codes, k, NW)
    jlo, jhi = je._window_limbs(jnp.asarray(want_codes), k, NW)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    if k == 32:  # canonical values with the top bit set exist
        assert (hi.numpy() >= 2**31).any()
    np.testing.assert_array_equal(
        te._window_valid_ok(tvb, L, k, NW).numpy(),
        np.asarray(je._window_valid_ok(jnp.asarray(vb), L, k, NW)),
    )


@pytest.mark.parametrize("filter_t,d", [(0, 1), (1, 1), (2, 1), (1, 2)])
@pytest.mark.parametrize("k", [15, 27, 31, 32])
def test_extract_count_matches_jax(k, filter_t, d):
    L = 151
    (w, vb, lens), (tw, tvb, tlens) = _both(64, L, k, seed=7 * k)
    for valid in (True, False) if filter_t == 1 and d == 1 else (True,):
        want = je.extract_count(
            jnp.asarray(w), jnp.asarray(lens), jnp.asarray(vb) if valid else None,
            k=k, L=L, filter_t=filter_t, d=d,
        )
        got = te.extract_count(tw, tlens, tvb if valid else None, k=k, L=L,
                               filter_t=filter_t, d=d)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).view(np.int32))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert int(got[2]) == int(want[2]) > 0
    if filter_t:  # duplicates survive the strictly-greater filter
        assert got[1].numpy().max() > filter_t


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("k", [27, 32])
def test_count_histogram_matches_jax(k, d):
    L = 150
    (w, vb, lens), (tw, tvb, tlens) = _both(64, L, k, seed=k + d)
    want = je.count_histogram(jnp.asarray(w), jnp.asarray(lens), jnp.asarray(vb),
                              k=k, L=L, d=d, cap=64)
    got = te.count_histogram(tw, tlens, tvb, k=k, L=L, d=d, cap=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy()[2:].sum() > 0


# -- QueryEngine.search_reads -------------------------------------------------

K = 27


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    gs = ts.genomes(4, 50_000, seed=31)
    _man, refs = ts.write_panel(tmp_path_factory.mktemp("extract"), gs)
    return gs, refs


def _read_batch(gs, seed: int):
    """Reads of 64 bp from two genomes (some with N), and one read repeated
    1,100 times, so its k-mers pass FREQ_CAP and fill the overflow list:
    2-bit words, validity bitplane, true lengths."""
    rs = ts.reads(gs[:2], 700, 64, seed=seed, sub_rate=0.01)
    rs[::9, 30] = ord("N")
    rs = np.concatenate([rs, np.repeat(rs[:1], 1100, axis=0)])
    w, vb = je.pack_reads_valid(rs)
    lens = np.full(rs.shape[0], 64, dtype=np.int32)
    lens[::7] = 50
    return w, vb, lens


def _engines(kind: str, refs):
    """A JAX engine and the port's (chunk 2048, so a batch spans several
    chunks) over the same index."""
    if kind == "v1":
        rng = np.random.default_rng(3)
        bloom, matrix, names = ts.rand_blocked_matrix(rng, 21, 60_000, 0.05)
        jindex = JIndex(bloom, 4, K, 0, names, {n: 1 for n in names}, matrix, blocked=1)
    else:
        jindex = jbuild(refs, 375_000, 4, K, verbose=False, blocked=kind == "v4")
    jeng = JEngine(jindex, chunk=2048)
    teng = TEngine(
        convert.index_from_arrays(
            np.asarray(jindex.matrix), bloom_size=jindex.bloom_size,
            num_hash=jindex.num_hash, k_size=K, colors=jindex.colors,
            n_ref_kmers=jindex.n_ref_kmers, blocked=jindex.blocked,
        ),
        chunk=2048, device="cpu",
    )
    return jeng, teng


@pytest.mark.parametrize("filter_t", [0, 1])
@pytest.mark.parametrize("kind", ["classic", "v1", "v4"])
def test_search_reads_matches_jax(panel, kind, filter_t):
    gs, refs = panel
    jeng, teng = _engines(kind, refs)
    assert teng.bv == {"classic": 0, "v1": 1, "v4": 4}[kind]
    w, vb, lens = _read_batch(gs, seed=40 + filter_t)
    want, n_want = jeng.search_reads(w, lens, vb, k=K, L=64, filter_t=filter_t)
    got, n_got = teng.search_reads(w, lens, vb, k=K, L=64, filter_t=filter_t)
    assert n_got == n_want > (1000 if filter_t else 4 * 2048)  # several chunks
    fused = kind == "v4"  # the same route in both packages
    # filter_t 0 is dense enough for the streams, filter_t 1 is not
    streamed = teng._use_stream(n_got) or teng._use_stream_classic(n_got, K)
    assert streamed == (kind != "v1" and filter_t == 0)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.all_valid == want.all_valid
    np.testing.assert_array_equal(got.and_all, want.and_all)
    assert got.freq_stats() == want.freq_stats()
    pairs = sorted(zip(got.over_colors.tolist(), got.over_freqs.tolist()))
    assert pairs == sorted(zip(want.over_colors.tolist(), want.over_freqs.tolist()))
    if kind != "v1":  # the repeated read's k-mers overflow to its genome
        assert len(pairs) > 0 and min(f for _c, f in pairs) >= 1100
    np.testing.assert_array_equal(got.freq_hist, want.freq_hist)
    if fused or not streamed:  # same route: the same arrays
        np.testing.assert_array_equal(got.over_colors, want.over_colors)
        np.testing.assert_array_equal(got.over_freqs, want.over_freqs)
    # device-resident inputs give the same answer
    again, n_again = teng.search_reads(ts.t32(w), torch.from_numpy(lens), ts.t32(vb),
                                       k=K, L=64, filter_t=filter_t)
    assert n_again == n_got and np.array_equal(again.counts, got.counts)


@pytest.mark.parametrize("kind", ["classic", "v4"])
def test_search_reads_reruns_a_dropped_stream(panel, kind, monkeypatch):
    """A stream dispatch that reports its capacity exceeded (decodes to
    None) is answered again through the generic gather. On v4 the fused
    dispatch trips first and the counted route's stream after it."""
    gs, refs = panel
    _jeng, teng = _engines(kind, refs)
    w, vb, lens = _read_batch(gs, seed=40)
    want, n = teng.search_reads(w, lens, vb, k=K, L=64)
    if kind == "v4":
        monkeypatch.setattr(teng, "_fused_decode", lambda *a: None)
    decoded = []
    finish = teng._finish_dev

    def first_dropped(out):
        decoded.append(out[3])
        return None if len(decoded) == 1 else finish(out)

    monkeypatch.setattr(teng, "_finish_dev", first_dropped)
    got, n_got = teng.search_reads(w, lens, vb, k=K, L=64)
    assert n_got == n and len(decoded) == 2
    assert decoded[1] == -(-n // 1024) * 1024  # the generic gather's capO
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.and_all, want.and_all)
    np.testing.assert_array_equal(got.freq_hist, want.freq_hist)
    assert got.freq_stats() == want.freq_stats()
    assert sorted(zip(got.over_colors.tolist(), got.over_freqs.tolist())) == sorted(
        zip(want.over_colors.tolist(), want.over_freqs.tolist())
    )


def test_search_reads_without_kmers(panel):
    _gs, refs = panel
    _jeng, teng = _engines("classic", refs)
    w = np.zeros((4, 4), dtype=np.uint32)
    res, n = teng.search_reads(w, np.full(4, 10, dtype=np.int32), k=K, L=64)
    assert n == 0 and res.all_valid and not res.counts.any()
    with pytest.raises(ValueError, match="envelope"):
        teng.search_reads(w, np.full(4, 64, dtype=np.int32), k=33, L=64)


def test_count_reads_histogram_matches_jax(panel):
    gs, refs = panel
    jeng, teng = _engines("classic", refs)
    w, vb, lens = _read_batch(gs, seed=50)
    want = jeng.count_reads_histogram(w, lens, vb, k=K, L=64)
    got = teng.count_reads_histogram(w, lens, vb, k=K, L=64)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got[1000:].sum() > 0
