"""The port's classic stream (colorid_tpu_torch/ops/stream_query.py::
stream_accumulate_classic_exact) and QueryEngine.search_keys against the
JAX package's, on synthetic genomes: the raw accumulators must be equal
element for element, and every port path (the density gate, the forced
stream, the generic gather, the device-resident dispatch) must give the JAX
engine's SearchResult field by field. The cases follow
tests/test_stream_classic.py: dense probes, sparse probes that need the
residual patch, H = 3, H = 1 and frequencies >= FREQ_CAP."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu import native as jnative
from colorid_tpu.engine import QueryEngine as JEngine
from colorid_tpu.ops import stream_query as jsq
from colorid_tpu.pipelines.build import build_index as jbuild
from colorid_tpu_torch.engine import QueryEngine as TEngine
from colorid_tpu_torch.index.bigsi import BigsiIndex
from colorid_tpu_torch.ops import stream_query as tsq
from colorid_tpu_torch.ops.hash_torch import bloom_rows_device
from colorid_tpu_torch.pipelines.build import build_index as tbuild
from tests import torch_support as ts

K = 27


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    gs = ts.genomes(4, 50_000, seed=1)
    _man, refs = ts.write_panel(tmp_path_factory.mktemp("panel"), gs)
    return gs, refs


@pytest.fixture(scope="module")
def query(panel):
    """Distinct canonical k-mers of reads from two of the genomes, packed,
    with their frequencies (16x coverage)."""
    gs, _refs = panel
    rs = ts.reads(gs[:2], 800, 2000, seed=11)
    nc = jnative.NativeCounter(K)
    assert nc.add_many(np.ascontiguousarray(rs))
    packed, qcounts = nc.dump_packed(0)
    return packed, np.maximum(qcounts, 1).astype(np.int32)


def _indexes(refs, bloom, num_hash):
    j = jbuild(refs, bloom, num_hash, K, verbose=False)
    t = tbuild(refs, bloom, num_hash, K, verbose=False)
    np.testing.assert_array_equal(t.matrix, j.matrix)
    assert (t.colors, t.n_ref_kmers, t.bloom_size, t.num_hash) == (
        j.colors, j.n_ref_kmers, j.bloom_size, j.num_hash
    )
    return j, t


@pytest.fixture(scope="module")
def jax_case(panel, query):
    """get(bloom, num_hash, big_freqs) -> (JAX engine, port index, qcounts, padded
    packed, padded qcounts, capO, raw JAX stream accumulators, the JAX
    engine's SearchResult of them). Each index pair and JAX stream
    dispatch is made once for the module: both are the slow part here."""
    _gs, refs = panel
    packed, qcounts0 = query
    n = packed.shape[0]
    indexes, cases = {}, {}

    def get(bloom, num_hash, big_freqs=False):
        key = (bloom, num_hash, big_freqs)
        if key in cases:
            return cases[key]
        if (bloom, num_hash) not in indexes:
            indexes[bloom, num_hash] = _indexes(refs, bloom, num_hash)
        jindex, tindex = indexes[bloom, num_hash]
        qcounts = qcounts0
        if big_freqs:
            rng = np.random.default_rng(5)
            big = rng.random(n) < 0.01
            qcounts = qcounts0.copy()
            qcounts[big] = rng.integers(1024, 70_000, int(big.sum()))
        jeng = JEngine(jindex, chunk=1 << 16)
        assert jeng._stream_classic
        pk, qc = _padded(packed, qcounts)
        C = tindex.n_colors
        capO = -(-n // 1024) * 1024
        acc = np.concatenate([np.zeros(C, np.int32), [-1, 1, 0]]).astype(np.int32)
        want = jsq.stream_accumulate_classic_exact(
            jnp.asarray(acc), jnp.zeros((C, 1024), jnp.int32),
            jnp.zeros(capO, jnp.int32), jnp.zeros(capO, jnp.int32),
            jeng.blocks2, jeng._blocks_bp, jnp.asarray(pk), jnp.asarray(qc),
            wpad=1, k=K, num_hash=num_hash, bloom_size=bloom, n_colors=C,
        )
        want = [np.asarray(w) for w in want]
        assert int(want[4]) == 0
        # the JAX engine's _search_keys_classic_stream on the same inputs:
        # this dispatch collected as that method collects it
        ref = jeng._collect(*want[:4], capO, qcounts=None)
        cases[key] = (jeng, tindex, qcounts, pk, qc, capO, want, ref)
        return cases[key]

    return get


def assert_same_result(got, want):
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.all_valid == want.all_valid
    np.testing.assert_array_equal(got.and_all, want.and_all)
    assert got.and_all.dtype == want.and_all.dtype
    np.testing.assert_array_equal(got.freq_hist, want.freq_hist)
    np.testing.assert_array_equal(got.over_colors, want.over_colors)
    np.testing.assert_array_equal(got.over_freqs, want.over_freqs)
    assert got.freq_stats() == want.freq_stats()


def _padded(packed, qcounts):
    n = packed.shape[0]
    P0 = -(-n // tsq.EPC_CL) * tsq.EPC_CL
    pk = np.zeros((P0, 2), dtype=np.uint32)
    pk[:n] = packed
    qc = np.zeros(P0, dtype=np.int32)
    qc[:n] = qcounts
    return pk, qc


def _n_residual(packed, num_hash, bloom, n_blocks):
    pk, _ = _padded(packed, np.ones(packed.shape[0], np.int32))
    rows = bloom_rows_device(
        torch.from_numpy(pk.view(np.int32)), k=K, num_hash=num_hash, bloom_size=bloom
    )
    row_s, _ = torch.sort(rows.reshape(-1))
    return int((~tsq.classic_plan(row_s, n_blocks)[1]).sum())


@pytest.mark.parametrize(
    "bloom,num_hash,big_freqs",
    [
        (375_000, 4, False),  # dense probes: almost everything in-window
        (3_000_000, 4, False),  # sparse: the residual patch runs
        (375_000, 3, False),  # non-power-of-two hash count
        (750_000, 1, False),
        (375_000, 4, True),  # uniq-hit frequencies >= FREQ_CAP overflow
    ],
)
def test_classic_stream_matches_jax(query, jax_case, monkeypatch, bloom, num_hash, big_freqs):
    packed, _ = query
    n = packed.shape[0]
    jeng, tindex, qcounts, pk, qc, capO, want, ref = jax_case(
        bloom, num_hash, big_freqs
    )
    teng = TEngine(tindex, chunk=1 << 16, device="cpu")
    assert teng._stream_classic
    assert teng._use_stream_classic(n, K) == jeng._use_stream_classic(n, K)
    if bloom == 3_000_000:
        assert _n_residual(packed, num_hash, bloom, teng.blocks2.shape[0]) > 0

    # raw accumulators of one stream dispatch, element for element
    C = tindex.n_colors
    acc = np.concatenate([np.zeros(C, np.int32), [-1, 1, 0]]).astype(np.int32)
    launches = tsq.classic_words.launches
    got = tsq.stream_accumulate_classic_exact(
        torch.from_numpy(acc), torch.zeros((C, 1024), dtype=torch.int32),
        torch.zeros(capO, dtype=torch.int32), torch.zeros(capO, dtype=torch.int32),
        teng.blocks2, torch.from_numpy(pk.view(np.int32)), torch.from_numpy(qc),
        wpad=1, k=K, num_hash=num_hash, bloom_size=bloom, n_colors=C,
    )
    assert tsq.classic_words.launches == launches  # CPU tensors: the twin
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert int(got[4]) == 0
    if big_freqs:
        assert int(got[0][C + 2]) > 0

    # the JAX engine's stream result is the reference for every port path
    res = teng._search_keys_classic_stream(packed, qcounts, K)
    assert res is not None
    assert_same_result(res, ref)
    assert_same_result(
        teng.search_keys(None, qcounts=qcounts, packed_all=packed, k=K), ref
    )
    monkeypatch.setenv("COLORID_STREAM", "force")
    assert_same_result(
        teng.search_keys(None, qcounts=qcounts, packed_all=packed, k=K), ref
    )
    monkeypatch.setenv("COLORID_STREAM", "0")
    generic = TEngine(tindex, chunk=1 << 16, device="cpu")
    assert not generic._stream_classic
    assert_same_result(
        generic.search_keys(None, qcounts=qcounts, packed_all=packed, k=K), ref
    )


def test_residual_capacity_reruns_generically(query, jax_case, monkeypatch):
    """More residual chunks than NCH_CL: the stream reports n_drop > 0 and
    search_keys re-runs the query through the generic gather."""
    packed, qcounts = query
    _jeng, tindex, *_, ref = jax_case(3_000_000, 4)
    teng = TEngine(tindex, chunk=1 << 16, device="cpu")
    monkeypatch.setattr(tsq, "NCH_CL", 1)
    monkeypatch.setenv("COLORID_STREAM", "force")
    assert teng._search_keys_classic_stream(packed, qcounts, K) is None
    assert_same_result(
        teng.search_keys(None, qcounts=qcounts, packed_all=packed, k=K), ref
    )


def test_device_resident_dispatch_and_keys(panel, jax_case):
    """search_keys_dev_classic_async + search_keys_dev_finish, ASCII keys
    in, and keys the 2-bit packing cannot carry (host row hashing)."""
    gs, _refs = panel
    jeng, tindex, _q, pk, qc, _capO, _want, ref = jax_case(375_000, 4)
    teng = TEngine(tindex, chunk=1 << 16, device="cpu")
    out = teng.search_keys_dev_classic_async(
        torch.from_numpy(pk.view(np.int32)), torch.from_numpy(qc), K
    )
    assert_same_result(teng.search_keys_dev_finish(out[0].numpy(), *out[1:]), ref)

    # a genome's own k-mers as ASCII rows (the perfect-search input)
    from colorid_tpu.core.kmers import count_kmers

    keys, _ = count_kmers([gs[3][:20_000]], K, skip_n=True, uppercase=True)
    assert_same_result(teng.search_keys(keys), jeng.search_keys(keys))
    # an N in every key: no 2-bit packing, rows hashed on the host
    nkeys = keys[:3000].copy()
    nkeys[:, 5] = ord("N")
    np.testing.assert_array_equal(teng.rows_for_keys(nkeys), jeng.rows_for_keys(nkeys))
    assert_same_result(teng.search_keys(nkeys), jeng.search_keys(nkeys))


def test_engine_refuses_what_is_not_ported():
    m = np.zeros((1000, 1), dtype=np.uint32)
    # a blocked index is taken now: one 512-byte block per k-mer
    blocked = TEngine(
        BigsiIndex(1000, 4, 31, 0, ["a"], {"a": 1}, m, blocked=2), device="cpu"
    )
    assert (blocked.bv, blocked.rpb, blocked._stream) == (2, 128, True)
    assert not blocked._stream_classic
    # placed for color shards narrower than the full row: taken now, hashed
    # on the host with the recorded placement and gathered row by row (its
    # streams run on the sharded engine); device-resident batches are refused
    placed = TEngine(
        BigsiIndex(1000, 4, 31, 0, ["a"], {"a": 1}, m, blocked=2, place_rpb=64),
        device="cpu",
    )
    assert (placed.bv, placed.rpb, placed.rpb_place) == (2, 0, 64)
    assert placed._custom_place and not placed._stream
    z = torch.zeros((2048, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="shard-placed"):
        placed.search_keys_dev_generic_async(z, z[:, 0].contiguous(), 31)
    with pytest.raises(ValueError, match="shard-placed"):
        placed.search_keys(None, packed_all=np.zeros((4, 2), np.uint32), k=31)
    # past int32 row addressing: a classic index is taken now, through the
    # wide route (rows split into (block, lane) pairs); a blocked one is not
    wide = TEngine(BigsiIndex(2**31, 4, 31, 0, ["a"], {"a": 1}, m), device="cpu")
    assert wide._wide and not wide._stream_classic
    with pytest.raises(ValueError, match="int32 device block addressing"):
        TEngine(BigsiIndex(2**31, 4, 31, 0, ["a"], {"a": 1}, m, blocked=2),
                device="cpu")
