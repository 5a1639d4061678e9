"""The port's fused reads path (colorid_tpu_torch/ops/fused_reads.py and
QueryEngine.search_reads / search_reads_fused_async on a v4 index) against
the JAX package's (colorid_tpu/ops/fused_reads.py, engine.py), on the CPU:
the same seeded reads through both, every output equal (tolerance zero:
integers and bit views), the overflow list in order. The JAX side runs its
probe kernel in Pallas interpret mode.

Reads carry N bases, lengths below L, reads repeated more than FREQ_CAP
times (the overflow list) and a few-read batch whose probe stream is
sparse enough for the residual pass."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu.engine import QueryEngine as JEngine
from colorid_tpu.ops import extract as je
from colorid_tpu.ops import fused_reads as jf
from colorid_tpu.ops.query import FREQ_CAP
from colorid_tpu.ops.stream_query import OVER_CAP, RES_CAP
from colorid_tpu.pipelines.build import build_index as jbuild
from colorid_tpu_torch import convert
from colorid_tpu_torch.engine import QueryEngine as TEngine
from colorid_tpu_torch.ops import extract as te
from colorid_tpu_torch.ops import fused_reads as tf
from colorid_tpu_torch.ops.hash_torch import _v3_blkoff
from tests import torch_support as ts

K, L = 27, 64
CAPO = OVER_CAP + RES_CAP


def _port_index(jindex, **kw):
    return convert.index_from_arrays(
        np.asarray(jindex.matrix), bloom_size=jindex.bloom_size,
        num_hash=jindex.num_hash, k_size=jindex.k_size, colors=jindex.colors,
        n_ref_kmers=jindex.n_ref_kmers, blocked=jindex.blocked, **kw,
    )


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """Four random genomes, the JAX v4 index over them, and a JAX engine
    and the port's (CPU) over the same matrix."""
    gs = ts.genomes(4, 50_000, seed=71)
    _man, refs = ts.write_panel(tmp_path_factory.mktemp("fused"), gs)
    jindex = jbuild(refs, 375_000, 4, K, verbose=False, blocked=True)
    jeng = JEngine(jindex, chunk=2048)
    teng = TEngine(_port_index(jindex), chunk=2048, device="cpu")
    assert teng.bv == 4 and teng._stream
    return gs, refs, jindex, jeng, teng


def _batch(gs, seed: int, n: int = 700, n_hot: int = 6):
    """n reads of L bp from two genomes (1 % substitutions, some with an N,
    every 7th shorter) and n_hot reads repeated 1,100 times each, so their
    k-mers pass FREQ_CAP: 2-bit words, validity bitplane, true lengths."""
    rs = ts.reads(gs[:2], n, L, seed=seed, sub_rate=0.01)
    rs[::9, 30] = ord("N")
    if n_hot:
        rs = np.concatenate([rs, np.repeat(rs[:n_hot], 1100, axis=0)])
    w, vb = je.pack_reads_valid(rs)
    lens = np.full(rs.shape[0], L, dtype=np.int32)
    lens[::7] = 50
    return w, vb, lens


def _jax_acc(jeng):
    C = jeng.index.n_colors
    stats = jnp.concatenate([
        jnp.zeros(C, dtype=jnp.int32), jnp.full(jeng.wpad, -1, dtype=jnp.int32),
        jnp.array([1, 0], dtype=jnp.int32),
    ])
    return (stats, jnp.zeros((C, FREQ_CAP), dtype=jnp.int32),
            jnp.zeros(CAPO, dtype=jnp.int32), jnp.zeros(CAPO, dtype=jnp.int32))


def _geo(eng):
    return dict(wpad=eng.wpad, num_hash=eng.index.num_hash,
                bloom_size=eng.index.bloom_size, rpb=eng.rpb,
                n_colors=eng.index.n_colors, bv=eng.bv)


def _assert_outputs_equal(got, want):
    """(stats, hist, over_col, over_freq, n_drop, n_unique) of both packages:
    every buffer equal, the overflow slots in order."""
    names = ("stats", "hist", "over_col", "over_freq", "n_drop", "n_unique")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def _same_result(got, want):
    (g, ng), (w, nw) = got, want
    assert ng == nw
    for f in ("counts", "and_all", "freq_hist", "over_colors", "over_freqs"):
        np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)
    assert g.all_valid == w.all_valid
    assert g.freq_stats() == w.freq_stats()


# -- function by function -----------------------------------------------------


@pytest.mark.parametrize("filter_t", [0, 1, 3, 7])  # 0 to 3 compaction rounds
def test_fused_search_reads_matches_jax(panel, filter_t):
    gs, _refs, _jindex, jeng, teng = panel
    w, vb, lens = _batch(gs, seed=80 + filter_t)
    kw = dict(k=K, L=L, filter_t=filter_t, d=1)
    want = jf.fused_search_reads(
        *_jax_acc(jeng), jeng.blocks2, jeng._blocks_bp, jnp.asarray(w),
        jnp.asarray(lens), jnp.asarray(vb), **kw, **_geo(jeng),
    )
    got = tf.fused_search_reads(
        *teng._new_accumulators(CAPO), teng.blocks2, ts.t32(w),
        torch.from_numpy(lens), ts.t32(vb), **kw, **_geo(teng),
    )
    _assert_outputs_equal(got, want)
    n_over = int(got[0][teng.index.n_colors + teng.wpad + 1])
    assert int(got[5]) > 0 and n_over > 0  # the hot reads' k-mers overflow


@pytest.mark.parametrize("filter_t", [0, 1])
def test_chunked_dispatches_match_jax(panel, filter_t):
    """extract_sorted_counts (A) per chunk, compact_sorted (A2) to a cap
    below the chunk's window count, fused_merge_query (B) over both."""
    gs, _refs, _jindex, jeng, teng = panel
    w, vb, lens = _batch(gs, seed=90 + filter_t, n=1200, n_hot=2)
    half = w.shape[0] // 2
    chunks = [slice(0, half), slice(half, 2 * half)]
    ja, ta = [], []
    for sl in chunks:
        want = jf.extract_sorted_counts(
            jnp.asarray(w[sl]), jnp.asarray(lens[sl]), jnp.asarray(vb[sl]), k=K, L=L, d=1
        )
        got = tf.extract_sorted_counts(
            ts.t32(w[sl]), torch.from_numpy(lens[sl]), ts.t32(vb[sl]), k=K, L=L, d=1
        )
        lo, hi = te._key_limbs(got[0])
        np.testing.assert_array_equal(lo.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[2]))
        assert int(got[2]) == int(want[3]) > 0
        ja.append(want)
        ta.append(got)
    n_max = max(int(o[2]) for o in ta)
    cap = n_max + 1000
    assert cap < ta[0][0].shape[0]  # the slice drops dead slots
    jc = [jf.compact_sorted(o[0], o[1], o[2], cap=cap) for o in ja]
    tc = [tf.compact_sorted(o[0], o[1], cap=cap) for o in ta]
    for (jlo, jhi, jqc), (s, qc) in zip(jc, tc):
        lo, hi = te._key_limbs(s)
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
        np.testing.assert_array_equal(qc.numpy(), np.asarray(jqc))
    kw = dict(k=K, filter_t=filter_t)
    want = jf.fused_merge_query(
        *_jax_acc(jeng), jeng.blocks2, jeng._blocks_bp,
        jnp.stack([c[0] for c in jc]), jnp.stack([c[1] for c in jc]),
        jnp.stack([c[2] for c in jc]), **kw, **_geo(jeng),
    )
    got = tf.fused_merge_query(
        *teng._new_accumulators(CAPO), teng.blocks2,
        torch.stack([c[0] for c in tc]), torch.stack([c[1] for c in tc]),
        **kw, **_geo(teng),
    )
    _assert_outputs_equal(got, want)
    assert int(got[5]) > 0


@pytest.mark.parametrize("version", [3, 4])
def test_sentinel_places_last_at_k32(version):
    """At k = 32 a canonical value may set bit 63; the SENT_KEY padding
    still places at or after every real k-mer, so the block stream of a
    sorted key vector stays monotone (the probe kernel's window plan)."""
    rng = np.random.default_rng(version)
    vals = rng.integers(0, 2**63, 5000, dtype=np.int64).astype(np.uint64) * np.uint64(2)
    vals[:3] = [0, 2**64 - 2, 2**63]
    lo = torch.from_numpy((vals & np.uint64(0xFFFFFFFF)).astype(np.int64))
    hi = torch.from_numpy((vals >> np.uint64(32)).astype(np.int64))
    s = torch.cat([te._sort_key(lo, hi), torch.full((64,), te.SENT_KEY)])
    s = torch.sort(s).values
    blk, _offs = _v3_blkoff(*te._key_limbs(s), 32, 4, 2**20, 128, version)
    assert bool((blk[1:] >= blk[:-1]).all())
    assert int(blk[-1]) == 2**20 // 128 - 1


# -- the engine -----------------------------------------------------------------


@pytest.mark.parametrize("filter_t", [0, 1])
@pytest.mark.parametrize("max_windows", [None, "150000"])  # single, chunked
def test_search_reads_matches_jax(panel, monkeypatch, max_windows, filter_t):
    gs, _refs, _jindex, jeng, teng = panel
    w, vb, lens = _batch(gs, seed=100 + filter_t, n=2000)
    n_windows = w.shape[0] * (L - K + 1)
    if max_windows:
        monkeypatch.setenv("COLORID_FUSED_MAX_WINDOWS", max_windows)
        assert n_windows > 2 * int(max_windows)  # three chunks
    else:
        assert n_windows < 28_000_000
    calls = []
    for name in ("_search_reads_fused", "_search_reads_fused_chunked"):
        real = getattr(teng, name)
        monkeypatch.setattr(teng, name, lambda *a, _r=real, _n=name, **kw: (
            calls.append(_n), _r(*a, **kw))[1])
    want = jeng.search_reads(w, lens, vb, k=K, L=L, filter_t=filter_t)
    got = teng.search_reads(w, lens, vb, k=K, L=L, filter_t=filter_t)
    assert calls == ["_search_reads_fused_chunked" if max_windows else "_search_reads_fused"]
    _same_result(got, want)
    assert len(got[0].over_colors) > 0
    # device-resident (tensor) inputs give the same answer
    again = teng.search_reads(ts.t32(w), torch.from_numpy(lens), ts.t32(vb),
                              k=K, L=L, filter_t=filter_t)
    _same_result(again, want)


def test_search_reads_stride_and_short_reads(panel):
    """d = 3 over short reads (true lengths 28-40 of L = 64), and a batch
    of a few reads whose sparse probe stream takes the residual pass."""
    gs, _refs, _jindex, jeng, teng = panel
    w, vb, lens = _batch(gs, seed=110, n=500, n_hot=0)
    lens = np.random.default_rng(5).integers(28, 41, w.shape[0]).astype(np.int32)
    for filter_t in (0, 1):
        _same_result(
            teng.search_reads(w, lens, vb, k=K, L=L, filter_t=filter_t, d=3),
            jeng.search_reads(w, lens, vb, k=K, L=L, filter_t=filter_t, d=3),
        )
    few = slice(0, 40)
    got = teng.search_reads(w[few], lens[few], vb[few], k=K, L=L)
    _same_result(got, jeng.search_reads(w[few], lens[few], vb[few], k=K, L=L))
    assert got[1] > 0


def test_chunked_cross_chunk_filter(panel, monkeypatch):
    """A read that appears ONCE in each of two chunks: its k-mers count 2
    globally and pass filter_t = 1, though each chunk counts them once (the
    failure of a per-chunk filter). The other reads sit 200 bp apart, so
    theirs count 1."""
    gs, _refs, _jindex, jeng, teng = panel
    g = gs[0]
    rs = np.stack([g[200 * i : 200 * i + L] for i in range(240)])
    rs[230] = rs[10]  # chunks of 120 reads: one copy in each
    w = je.pack_reads(rs)
    lens = np.full(rs.shape[0], L, dtype=np.int32)
    monkeypatch.setenv("COLORID_FUSED_MAX_WINDOWS", str(120 * (L - K + 1)))
    got = teng.search_reads(w, lens, k=K, L=L, filter_t=1)
    _same_result(got, jeng.search_reads(w, lens, k=K, L=L, filter_t=1))
    assert got[1] == L - K + 1
    monkeypatch.delenv("COLORID_FUSED_MAX_WINDOWS")
    _same_result(got, teng.search_reads(w, lens, k=K, L=L, filter_t=1))


def test_fused_async_matches_sync(panel):
    """Two dispatches queued, fetched in one stacked copy, decoded: each
    equals search_reads on its half."""
    gs, _refs, _jindex, _jeng, teng = panel
    w, vb, lens = _batch(gs, seed=120, n=1000, n_hot=2)
    halves = [slice(0, w.shape[0] // 2), slice(w.shape[0] // 2, w.shape[0])]
    outs = [
        teng.search_reads_fused_async(ts.t32(w[h]), torch.from_numpy(lens[h]),
                                      ts.t32(vb[h]), k=K, L=L, filter_t=1)
        for h in halves
    ]
    host = torch.stack([o[0] for o in outs]).numpy()
    for h, row, (_vec, oc, of, capO) in zip(halves, host, outs):
        got = teng.search_reads_fused_finish(row, oc, of, capO)
        _same_result(got, teng.search_reads(w[h], lens[h], vb[h], k=K, L=L, filter_t=1))


def test_fused_falls_back_on_a_capacity_trip(panel, monkeypatch):
    """A fused dispatch that reports n_drop > 0 is answered by the counted
    route (extract_count, then the probe stream): the same answer."""
    gs, _refs, _jindex, _jeng, teng = panel
    w, vb, lens = _batch(gs, seed=130, n=800, n_hot=0)
    want = teng.search_reads(w, lens, vb, k=K, L=L)
    counted = []
    real = teng._search_reads_counted
    monkeypatch.setattr(teng, "_fused_decode", lambda *a: None)
    monkeypatch.setattr(teng, "_search_reads_counted",
                        lambda *a, **kw: counted.append(1) or real(*a, **kw))
    got = teng.search_reads(w, lens, vb, k=K, L=L)
    assert counted == [1] and got[1] == want[1]
    np.testing.assert_array_equal(got[0].counts, want[0].counts)
    assert got[0].freq_stats() == want[0].freq_stats()


def test_fused_async_refuses_what_jax_refuses(panel, monkeypatch):
    gs, refs, jindex, _jeng, teng = panel
    w, vb, lens = _batch(gs, seed=140, n=100, n_hot=0)
    args = (ts.t32(w), torch.from_numpy(lens), ts.t32(vb))
    classic = TEngine(_port_index(jbuild(refs, 375_000, 4, K, verbose=False)),
                      device="cpu")
    rng = np.random.default_rng(3)
    bloom, matrix, names = ts.rand_blocked_matrix(rng, 21, 60_000, 0.05)
    v1 = TEngine(convert.index_from_arrays(
        matrix, bloom_size=bloom, num_hash=4, k_size=K, colors=names,
        n_ref_kmers={n: 1 for n in names}, blocked=1), device="cpu")
    placed = TEngine(_port_index(jindex, place_rpb=64), device="cpu")
    assert placed._custom_place
    for eng in (classic, v1, placed):
        with pytest.raises(ValueError, match="value-addressed"):
            eng.search_reads_fused_async(*args, k=K, L=L)
    with pytest.raises(ValueError, match="envelope"):
        teng.search_reads_fused_async(*args, k=33, L=L)
    monkeypatch.setenv("COLORID_FUSED_MAX_WINDOWS", "1000")
    with pytest.raises(ValueError, match="single-dispatch guard"):
        teng.search_reads_fused_async(*args, k=K, L=L)
