"""The port's read classifier device functions (colorid_tpu_torch/ops/
query.py::query_readid_*) and QueryEngine.readid_* methods against the JAX
package's, on the CPU: the same seeded inputs through both, every output
equal (tolerance zero).

Function cases: -B 0 and 3, absent rows (a matrix with zero rows), padding
(PAD_POS positions, mate_seg -1, ranks -1 / 255), int16 and uint8 rank
planes, classic, blocked and wide (> 32 colors) rows. Engine cases: a
classic and a blocked (v4) index built from genomes, inputs prepared by
the JAX package's own read_id helpers from a read mix with junk, N bases
and ties, and a read chunk small enough that a batch spans several."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu.engine import QueryEngine as JEngine
from colorid_tpu.ops import extract as je
from colorid_tpu.ops import query as jq
from colorid_tpu.pipelines import read_id as jrid
from colorid_tpu.pipelines.build import build_index as jbuild
from colorid_tpu_torch import convert
from colorid_tpu_torch.engine import QueryEngine as TEngine
from colorid_tpu_torch.ops import query as tq
from tests import torch_support as ts

t32 = ts.t32


def _matrix(kind: str, seed: int):
    """(blocks, wpad, rpb, H, C, bloom) of a random index: "classic" rows,
    "blocked" (the blocked gather), "wide" (70 colors, wpad 4) classic or
    "wide_blocked" rows."""
    rng = np.random.default_rng(seed)
    C, H = {"classic": (21, 4), "blocked": (21, 3), "wide": (70, 2),
            "wide_blocked": (70, 2)}[kind]
    bloom, matrix, _names = ts.rand_blocked_matrix(rng, C, 4096, 0.005)
    blocks, wpad = jq.pack_matrix_blocks(matrix)
    rpb = 128 // wpad if kind in ("blocked", "wide_blocked") else 0
    return blocks, wpad, rpb, H, C, bloom


def _seg_pos(rng, N: int, n_reads: int):
    seg = np.sort(rng.integers(0, n_reads, N)).astype(np.int32)
    pos = np.zeros(N, dtype=np.int32)
    for r in range(n_reads):
        m = seg == r
        pos[m] = rng.permutation(int(m.sum()))
    pos[-20:] = jq.PAD_POS
    return seg, pos


@pytest.mark.parametrize("B", [0, 3])
@pytest.mark.parametrize("kind", ["classic", "blocked", "wide"])
def test_rows_functions_match_jax(kind, B):
    blocks, wpad, rpb, H, C, bloom = _matrix(kind, seed=B + len(kind))
    rng = np.random.default_rng(7)
    N, nr = 3000, 50
    seg, pos = _seg_pos(rng, N, nr)
    rows = rng.integers(0, bloom, (N, H))
    if rpb:
        rows = rows[:, :1] // rpb * rpb + rng.integers(0, rpb, (N, H))
    rows = rows.astype(np.int32)
    kw = dict(num_reads=64, start_sample=B, num_colors=C, wpad=wpad, rpb=rpb)
    for fn in ("query_readid_batch", "query_readid_firsthit"):
        want = getattr(jq, fn)(jnp.asarray(blocks), jnp.asarray(rows),
                               jnp.asarray(seg), jnp.asarray(pos), **kw)
        got = getattr(tq, fn)(t32(blocks), t32(rows), t32(seg), t32(pos), **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if fn == "query_readid_batch":  # absent rows broke some reads only
            assert 0 < int(got[:nr, C].sum()) < nr
    pk = ts.rand_packed(rng, N, 31)
    s16 = seg.astype(np.int16)
    p16 = np.where(pos == jq.PAD_POS, -1, pos).astype(np.int16)
    hkw = dict(kw, k=31, num_hash=H, bloom_size=bloom, bv=4 if rpb else 1)
    want = jq.query_readid_hash_batch(jnp.asarray(blocks), jnp.asarray(pk),
                                      jnp.asarray(s16), jnp.asarray(p16), **hkw)
    got = tq.query_readid_hash_batch(t32(blocks), t32(pk), torch.from_numpy(s16),
                                     torch.from_numpy(p16), **hkw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("B", [0, 3])
@pytest.mark.parametrize("kind", ["classic", "blocked", "wide_blocked"])
def test_reads_functions_match_jax(kind, B):
    blocks, wpad, rpb, H, C, bloom = _matrix(kind, seed=10 + B)
    rng = np.random.default_rng(8)
    L, k, M = 96, 21, 60
    seqs = ts.ACGT[rng.integers(0, 4, (M, L))]
    w = je.pack_reads_any(seqs)
    lens = rng.integers(20, L + 1, M).astype(np.int32)
    mseg = np.sort(rng.integers(0, 30, M)).astype(np.int16)
    mseg[-3:] = -1  # padding mates
    ranks = rng.integers(-1, 120, (M, L - k + 1)).astype(np.int16)
    kw = dict(num_reads=32, start_sample=B, num_colors=C, wpad=wpad, k=k, L=L,
              num_hash=H, bloom_size=bloom, rpb=rpb, bv=4 if rpb else 1)
    u8 = np.where(ranks < 0, 255, ranks).astype(np.uint8)
    for rk, fns in ((ranks, ("query_readid_reads_batch", "query_readid_firsthit_reads")),
                    (u8, ("query_readid_reads_batch",))):
        for fn in fns:
            want = getattr(jq, fn)(jnp.asarray(blocks), jnp.asarray(w), jnp.asarray(mseg),
                                   jnp.asarray(lens), jnp.asarray(rk), **kw)
            got = getattr(tq, fn)(t32(blocks), t32(w), torch.from_numpy(mseg),
                                  torch.from_numpy(lens), torch.from_numpy(rk), **kw)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("kind", ["classic", "blocked", "wide_blocked"])
def test_orderfree_matches_jax(kind, d):
    blocks, wpad, rpb, H, C, bloom = _matrix(kind, seed=20 + d)
    rng = np.random.default_rng(9)
    L, k, nm, nreads = 160, 31, 2, 24
    seqs = ts.ACGT[rng.integers(0, 4, (nreads * nm, L))]
    seqs[4] = seqs[5]  # a read whose mates share every k-mer
    seqs[7, 50] = ord("N")
    w, vb = je.pack_reads_valid(seqs)
    lens = rng.integers(20, L + 1, nreads * nm).astype(np.int32)
    kw = dict(num_reads=nreads, num_colors=C, wpad=wpad, k=k, L=L, nm=nm, d=d,
              num_hash=H, bloom_size=bloom, rpb=rpb, bv=4 if rpb else 1)
    want = jq.query_readid_orderfree_reads(jnp.asarray(blocks), jnp.asarray(w),
                                           jnp.asarray(lens), jnp.asarray(vb), **kw)
    got = tq.query_readid_orderfree_reads(t32(blocks), t32(w), torch.from_numpy(lens),
                                          t32(vb), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:, C].any() and got[:, C + 1].max() > 0


def test_pad_rows_matches_jax():
    rows = np.arange(12, dtype=np.int32).reshape(4, 3)
    np.testing.assert_array_equal(tq.pad_rows(rows, 7), jq.pad_rows(rows, 7))
    assert tq.pad_rows(rows, 4) is rows


# -- the engine methods --------------------------------------------------------

K = 27


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The read mix as a classify_batch batch, and per layout (classic,
    v4) a JAX engine and the port's over the same index, both with a read
    chunk of 64 reads."""
    gs = ts.genomes(4, 50_000, seed=41)
    gs[3][5000:25000] = gs[0][5000:25000]
    _man, refs = ts.write_panel(tmp_path_factory.mktemp("readid"), gs)
    pairs = ts.read_mix(gs, 300, seed=42)
    batch = [
        (f"pair{j}", [np.frombuffer(p[0], dtype=np.uint8), np.frombuffer(p[2], dtype=np.uint8)])
        for j, p in enumerate(pairs)
        if len(p[0]) >= K and not any(c in p[0] + p[2] for c in b"acgt")
    ]
    engines = {}
    for kind in ("classic", "v4"):
        jindex = jbuild(refs, 375_000, 4, K, verbose=False, blocked=kind == "v4")
        jeng = JEngine(jindex)
        teng = TEngine(
            convert.index_from_arrays(
                np.asarray(jindex.matrix), bloom_size=jindex.bloom_size,
                num_hash=4, k_size=K, colors=jindex.colors,
                n_ref_kmers=jindex.n_ref_kmers, blocked=jindex.blocked,
            ),
            device="cpu",
        )
        jeng._rid_reads = teng._rid_reads = 64
        engines[kind] = (jeng, teng)
    return batch, engines


def _keys(batch):
    """Each read's k-mer set in FnvHashSet order (read_id's host route)."""
    return [jrid._fnv_order_keys(jrid.kmer_set(m, K, d=1, minimizer=0)) for _rid, m in batch]


@pytest.mark.parametrize("B", [0, 3])
@pytest.mark.parametrize("kind", ["classic", "v4"])
def test_engine_keys_methods_match_jax(case, kind, B):
    batch, engines = case
    jeng, teng = engines[kind]
    keys = _keys(batch)
    keys[5] = keys[5][:0]  # a read without k-mers
    for name in ("readid_counts", "readid_firsthit"):
        want = getattr(jeng, name)(keys, B)
        got = getattr(teng, name)(keys, B)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert (want[:, -1] < tq.BIG).any()  # some reads broke on an absent k-mer


@pytest.mark.parametrize("B", [0, 3])
@pytest.mark.parametrize("kind", ["classic", "v4"])
def test_engine_reads_methods_match_jax(case, kind, B):
    batch, engines = case
    jeng, teng = engines[kind]
    idx = list(range(len(batch)))
    mates, mseg, mlens, ranks, maplen, Lb = jrid._prepare_reads(batch, idx, K, 1, True)
    args = (mates, mseg, mlens, ranks, len(idx), B, K, Lb)
    for name in ("readid_counts_reads", "readid_firsthit_reads"):
        want = getattr(jeng, name)(*args)
        got = getattr(teng, name)(*args)
        np.testing.assert_array_equal(got, want)
        assert np.array_equal(getattr(teng, name + "_async")(*args)(), got)


@pytest.mark.parametrize("kind", ["classic", "v4"])
def test_engine_orderfree_matches_jax(case, kind):
    batch, engines = case
    jeng, teng = engines[kind]
    words, mlens, vbits, nm, Lb = jrid._prepare_reads_orderfree(
        batch, list(range(len(batch))), K)
    for d in (1, 2):
        want = jeng.readid_counts_orderfree(words, mlens, vbits, len(batch), nm, K, Lb, d)
        got = teng.readid_counts_orderfree(words, mlens, vbits, len(batch), nm, K, Lb, d)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B", [0, 3])
@pytest.mark.parametrize("kind", ["classic", "v4"])
def test_engine_packed_and_arrays_match_jax(case, kind, B):
    batch, engines = case
    jeng, teng = engines[kind]
    idx = list(range(len(batch)))
    _, packed, seg, pos, _maplen = jrid._prepare_native(batch, idx, jeng.index, 1, True)
    want = jeng.readid_counts_packed(packed, seg, pos, len(idx), B, K)
    np.testing.assert_array_equal(teng.readid_counts_packed(packed, seg, pos, len(idx), B, K), want)
    if kind == "classic":  # host rows (blocked indexes never take this route)
        got = jrid._prepare_native(batch, idx, jeng.index, 1, False)
        assert got[0] == "rows"
        _, rows, seg, pos, _maplen = got
        want = jeng.readid_counts_arrays(rows, seg, pos, len(idx), B)
        np.testing.assert_array_equal(teng.readid_counts_arrays(rows, seg, pos, len(idx), B), want)
