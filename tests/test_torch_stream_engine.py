"""The port's QueryEngine on blocked indexes against the JAX engine: the
segment loop of search_keys with the probe stream forced and off, the
device-resident dispatches, the density gate, and the running global AND
over several streamed segments. Both engines hold the same matrix and
placement (convert.py). Integers throughout: tolerance 0."""

import jax
import numpy as np
import pytest
import torch

from colorid_tpu.engine import QueryEngine as JEngine
from colorid_tpu.index.bigsi import BigsiIndex as JIndex
from colorid_tpu_torch import convert
from colorid_tpu_torch.engine import QueryEngine as TEngine
from colorid_tpu_torch.ops import stream_query as tsq
from colorid_tpu_torch.ops.hash_torch import pack_keys_host
from tests import torch_support as ts
from tests.test_torch_engine import assert_same_result

K = 31


def _pair(rng, C, bloom_size, num_hash, blocked, zero_frac=0.3):
    """The same random blocked index for both packages."""
    bloom, matrix, names = ts.rand_blocked_matrix(rng, C, bloom_size, zero_frac)
    n_ref = {n: 1 for n in names}
    j = JIndex(bloom, num_hash, K, 0, names, n_ref, matrix, blocked=blocked)
    t = convert.index_from_arrays(
        matrix, bloom_size=bloom, num_hash=num_hash, k_size=K, colors=names,
        n_ref_kmers=n_ref, blocked=blocked,
    )
    return j, t


def _same_answers(a, b):
    """What a streamed and a generic result share (their histograms differ
    in layout when hw < FREQ_CAP; freq_stats() reads both alike)."""
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.and_all, b.and_all)
    assert a.all_valid == b.all_valid
    assert a.freq_stats() == b.freq_stats()


def _padded(packed, qcounts):
    n = packed.shape[0]
    P = -(-n // tsq.PC) * tsq.PC
    pk = np.zeros((P, 2), np.uint32)
    pk[:n] = packed
    qc = np.zeros(P, np.int32)
    qc[:n] = np.maximum(qcounts, 1)
    return pk, qc


@pytest.mark.parametrize("blocked,C,max_freq", [(2, 21, None), (4, 150, 1999)])
def test_search_keys_and_dev_match_jax(monkeypatch, blocked, C, max_freq):
    rng = np.random.default_rng(7 + blocked)
    jindex, tindex = _pair(rng, C, 100_000, 4, blocked)
    n = 20_000
    keys = rng.choice(ts.ACGT, size=(n, K))
    qcounts = rng.integers(1, 2000, n).astype(np.int32)  # straddles hw, FREQ_CAP

    monkeypatch.setenv("COLORID_STREAM", "0")
    jgen = JEngine(jindex).search_keys(keys, qcounts=qcounts)
    tgeneric = TEngine(tindex, device="cpu")
    assert not tgeneric._stream and tgeneric.bv == blocked
    tgen = tgeneric.search_keys(keys, qcounts=qcounts)
    assert_same_result(tgen, jgen)
    assert jgen.counts.sum() > 0 and len(jgen.freq_stats()) > 0

    monkeypatch.setenv("COLORID_STREAM", "force")
    jeng = JEngine(jindex)
    # the port's engine from the JAX engine's device state
    teng = convert.engine_from_jax_state(
        np.asarray(jeng.blocks2), jeng.wpad, jindex, device="cpu"
    )
    assert jeng._stream and teng._stream
    assert (teng.bv, teng.rpb, teng.wpad) == (jeng.bv, jeng.rpb, jeng.wpad)
    np.testing.assert_array_equal(
        teng.blocks2.numpy(), np.asarray(jeng.blocks2).view(np.int32)
    )
    np.testing.assert_array_equal(
        teng.rows_for_keys(keys[:500]), jeng.rows_for_keys(keys[:500])
    )
    # one streamed segment: field by field with the JAX stream, and the
    # generic path's answers
    jres = jeng.search_keys(keys, qcounts=qcounts)
    tres = teng.search_keys(keys, qcounts=qcounts)
    assert_same_result(tres, jres)
    _same_answers(tres, tgen)
    assert len(tres.over_freqs) > 0

    # device-resident dispatch (exact mode), with and without a bound
    pk, qc = _padded(pack_keys_host(keys), qcounts)
    jdev = jeng.search_keys_dev(
        jax.device_put(pk), jax.device_put(qc), k=K, max_freq=max_freq
    )
    pk_t, qc_t = torch.from_numpy(pk.view(np.int32)), torch.from_numpy(qc)
    tdev = teng.search_keys_dev(pk_t, qc_t, k=K, max_freq=max_freq)
    assert jdev is not None and tdev is not None
    assert_same_result(tdev, jdev)
    _same_answers(tdev, tgen)
    # the generic device-resident dispatch gives the host path's result
    P = pk.shape[0]
    small = TEngine(tindex, chunk=P, device="cpu")
    out = small.search_keys_dev_generic_async(pk_t, qc_t, k=K)
    tdg = small.search_keys_dev_finish(out[0].numpy(), *out[1:])
    _same_answers(tdg, tgen)
    np.testing.assert_array_equal(tdg.freq_hist, tgen.freq_hist)


def test_max_freq_that_does_not_hold_is_refused(monkeypatch):
    """The JAX engine trusts max_freq and clips silently; the port checks
    it on the device and reports the dispatch as dropped."""
    monkeypatch.setenv("COLORID_STREAM", "force")
    rng = np.random.default_rng(3)
    _j, tindex = _pair(rng, 21, 100_000, 4, 2)
    teng = TEngine(tindex, device="cpu")
    pk, qc = _padded(ts.rand_packed(rng, 4096), rng.integers(1, 3000, 4096))
    pk_t, qc_t = torch.from_numpy(pk.view(np.int32)), torch.from_numpy(qc)
    assert teng.search_keys_dev(pk_t, qc_t, k=K, max_freq=100) is None
    assert teng.search_keys_dev(pk_t, qc_t, k=K, max_freq=3000) is not None
    with pytest.raises(ValueError, match="multiple of"):
        teng.search_keys_dev(pk_t[:1000], qc_t[:1000], k=K)
    with pytest.raises(ValueError, match="int32"):
        teng.search_keys_dev(pk_t.to(torch.int64), qc_t, k=K)
    monkeypatch.setenv("COLORID_STREAM", "0")
    with pytest.raises(ValueError, match="stream-eligible"):
        TEngine(tindex, device="cpu").search_keys_dev(pk_t, qc_t, k=K)


def test_stream_auto_gate(monkeypatch):
    """tests/test_stream.py::test_stream_auto_gate, for the port."""
    rng = np.random.default_rng(17)
    jindex, tindex = _pair(rng, 10, 50_000, 4, 2)
    monkeypatch.delenv("COLORID_STREAM", raising=False)
    assert TEngine(tindex, device="cpu")._stream
    monkeypatch.setenv("COLORID_STREAM", "0")
    assert not TEngine(tindex, device="cpu")._stream
    monkeypatch.setenv("COLORID_STREAM", "1")
    eng, jeng = TEngine(tindex, device="cpu"), JEngine(jindex)
    n_blocks = tindex.bloom_size // eng.rpb
    for m in (n_blocks, 4 * n_blocks - 1, 4 * n_blocks, 10 * n_blocks):
        assert eng._use_stream(m) == jeng._use_stream(m)
    assert eng._use_stream(4 * n_blocks) and not eng._use_stream(n_blocks)
    # classic and v1 indexes never stream; nor do 3 hashes or > 1024 colors
    for blocked, num_hash in ((1, 4), (0, 4), (2, 3)):
        idx = convert.index_from_arrays(
            np.asarray(tindex.matrix), bloom_size=tindex.bloom_size,
            num_hash=num_hash, k_size=K, colors=tindex.colors,
            n_ref_kmers=tindex.n_ref_kmers, blocked=blocked,
        )
        assert not TEngine(idx, device="cpu")._stream


def test_running_and_over_several_streamed_segments(monkeypatch):
    """The global AND must remember earlier segments. With chunk=2048 the
    query runs as three streamed segments of 16,384 k-mers; only the rows of
    key 0 (in the first) lack color 0. The port's stream equals the port's
    generic path and the JAX generic path. The JAX stream rebuilds the AND
    from each segment alone and so reports color 0 as a perfect hit: that
    is pinned here as a known fault of the reference, which the port does
    not copy."""
    rng = np.random.default_rng(5)
    C, bloom, n = 5, 128 * 1000, 40_000
    matrix = np.full((bloom, 1), (1 << C) - 1, dtype=np.uint32)
    names = [f"c{i}" for i in range(C)]
    n_ref = {c: 1 for c in names}
    keys = rng.choice(ts.ACGT, size=(n, K))
    jindex = JIndex(bloom, 4, K, 0, names, n_ref, matrix, blocked=2)
    monkeypatch.setenv("COLORID_STREAM", "0")
    matrix[JEngine(jindex).rows_for_keys(keys[:1]).ravel(), 0] &= ~np.uint32(1)
    tindex = convert.index_from_arrays(
        matrix, bloom_size=bloom, num_hash=4, k_size=K, colors=names,
        n_ref_kmers=n_ref, blocked=2,
    )
    jgen = JEngine(jindex, chunk=2048).search_keys(keys)
    tgen = TEngine(tindex, chunk=2048, device="cpu").search_keys(keys)
    assert_same_result(tgen, jgen)
    assert jgen.and_all.tolist() == [30] and jgen.all_valid

    monkeypatch.setenv("COLORID_STREAM", "force")
    teng = TEngine(tindex, chunk=2048, device="cpu")
    calls = []
    real = tsq.stream_accumulate_hash
    monkeypatch.setattr(
        tsq, "stream_accumulate_hash",
        lambda *a, **kw: calls.append(a[5].shape[0]) or real(*a, **kw),
    )
    tres = teng.search_keys(keys)
    assert calls == [16384, 16384, 8192]  # three segments, the last padded
    assert_same_result(tres, tgen)
    assert tres.and_all.tolist() == [30]

    jres = JEngine(jindex, chunk=2048).search_keys(keys)
    np.testing.assert_array_equal(jres.counts, jgen.counts)
    assert jres.and_all.tolist() == [31]  # the reference's fault, not ours
