"""The window-key wrapper (colorid_tpu_torch/ops/extract.py::window_keys,
csrc/window_keys.cu's twin on the CPU) against the JAX package's window
extraction (colorid_tpu/ops/extract.py: _unpack_codes, _window_limbs,
_window_valid_ok and extract_count's key construction), with N bases,
strides d > 1, short reads and every XXH3 length class of k. Integers:
exact equality. Its refusals, and no kernel launch on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu.ops import extract as je
from colorid_tpu_torch.ops import extract as te
from tests import torch_support as ts


def _jax_keys(words, lens, vbits, k, L, d):
    """extract_count's per-window keys, before its sort, as int64 sort
    keys ((hi - 2^31) * 2^32 + lo; SENT_KEY where the window is not
    counted)."""
    NW = L - k + 1
    lo, hi = je._window_limbs(je._unpack_codes(jnp.asarray(words), L), k, NW)
    w = np.arange(NW)[None, :]
    valid = w + k <= lens[:, None]
    if d > 1:
        valid &= w % d == 0
    if vbits is not None:
        valid &= np.asarray(je._window_valid_ok(jnp.asarray(vbits), L, k, NW))
    key = (np.asarray(hi).astype(np.int64) - 2**31) * 2**32 + np.asarray(lo).astype(np.int64)
    return np.where(valid, key, te.SENT_KEY)


def _reads(seed: int, R: int, L: int):
    """Reads with N bases at random places and at both ends, true lengths
    from below k up to L."""
    rng = np.random.default_rng(seed)
    seqs = ts.ACGT[rng.integers(0, 4, (R, L))]
    seqs[rng.random((R, L)) < 0.01] = ord("N")
    seqs[0, 0] = seqs[1, L - 1] = ord("N")
    lens = rng.integers(1, L + 1, R).astype(np.int32)
    lens[:3] = L
    return seqs, lens


@pytest.mark.parametrize("k", [4, 7, 8, 9, 15, 16, 17, 27, 31, 32])
@pytest.mark.parametrize("d", [1, 3])
def test_window_keys_match_jax(k, d):
    L = 150
    seqs, lens = _reads(k * 10 + d, 64, L)
    words, vbits = te.pack_reads_valid(seqs)
    before = te.window_keys.launches
    for vb in (vbits, None):
        want = _jax_keys(words, lens, vb, k, L, d)
        got = te.window_keys(
            ts.t32(words), torch.from_numpy(lens), None if vb is None else ts.t32(vb),
            k=k, L=L, d=d,
        )
        assert got.dtype == torch.int64 and got.shape == (64, L - k + 1)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want != te.SENT_KEY).any() and (want == te.SENT_KEY).any()
    assert te.window_keys.launches == before  # the CPU takes the twin


@pytest.mark.parametrize("L", [16, 33, 64, 100])
def test_window_keys_at_read_length_edges(L):
    """Word and bitplane edges: L at and off multiples of 16 and 32, reads
    exactly k long, wider word arrays than L needs."""
    k = 16
    seqs, lens = _reads(L, 20, L)
    lens[3:6] = k
    words, vbits = te.pack_reads_valid(seqs)
    want = _jax_keys(words, lens, vbits, k, L, 1)
    got = te.window_keys(ts.t32(words), torch.from_numpy(lens), ts.t32(vbits), k=k, L=L)
    np.testing.assert_array_equal(got.numpy(), want)
    wide = np.concatenate([words, np.zeros((20, 2), np.uint32)], axis=1)
    got = te.window_keys(ts.t32(wide), torch.from_numpy(lens), ts.t32(vbits), k=k, L=L)
    np.testing.assert_array_equal(got.numpy(), want)


def test_callers_reach_the_wrapper(monkeypatch):
    """extract_count and count_histogram take their keys from the wrapper."""
    calls = []
    real = te.window_keys
    monkeypatch.setattr(te, "window_keys", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    seqs, lens = _reads(3, 8, 64)
    words, vbits = te.pack_reads_valid(seqs)
    args = (ts.t32(words), torch.from_numpy(lens), ts.t32(vbits))
    te.extract_count(*args, k=21, L=64, filter_t=0)
    te.count_histogram(*args, k=21, L=64, d=2)
    assert [c["d"] for c in calls] == [1, 2]


def test_window_keys_refuse_what_the_kernel_does_not_take():
    seqs, lens = _reads(5, 8, 64)
    words, vbits = te.pack_reads_valid(seqs)
    w, ln, vb = ts.t32(words), torch.from_numpy(lens), ts.t32(vbits)
    with pytest.raises(TypeError, match="integer lens"):
        te.window_keys(w, ln.to(torch.float32), vb, k=21, L=64)
    with pytest.raises(TypeError, match="int32"):
        te.window_keys(w.to(torch.int64), ln, vb, k=21, L=64)
    with pytest.raises(ValueError, match="contiguous"):
        te.window_keys(w.t().contiguous().t(), ln, vb, k=21, L=64)
    with pytest.raises(ValueError, match="k <= 32"):
        te.window_keys(w, ln, vb, k=33, L=64)
    with pytest.raises(ValueError, match="k <= L"):
        te.window_keys(w, ln, vb, k=21, L=20)
    with pytest.raises(ValueError, match="d >= 1"):
        te.window_keys(w, ln, vb, k=21, L=64, d=0)
    with pytest.raises(ValueError, match="ceil"):
        te.window_keys(w, ln, vb, k=21, L=65)  # 65 bases need 5 words
    with pytest.raises(ValueError, match="ceil"):
        te.window_keys(w, ln[:4], vb, k=21, L=64)
    with pytest.raises(ValueError, match="ceil"):
        te.window_keys(w, ln, vb[:, :1].contiguous(), k=21, L=64)
    with pytest.raises(ValueError, match="unsupported device"):
        te.window_keys(w.to("meta"), ln.to("meta"), None, k=21, L=64)
    with pytest.raises(ValueError, match="different devices"):
        te.window_keys(w, ln.to("meta"), None, k=21, L=64)


@pytest.mark.parametrize("dtype", [torch.int64, torch.int16, torch.uint8])
def test_window_keys_take_any_integer_lens(dtype):
    """lens of any integer type, or a strided view, is taken as int32, as
    the twin has always taken it."""
    seqs, lens = _reads(7, 16, 64)
    words, vbits = te.pack_reads_valid(seqs)
    w, vb = ts.t32(words), ts.t32(vbits)
    want = te.window_keys(w, torch.from_numpy(lens), vb, k=21, L=64)
    got = te.window_keys(w, torch.from_numpy(lens).to(dtype), vb, k=21, L=64)
    assert torch.equal(got, want)
    strided = torch.from_numpy(np.repeat(lens, 2)).to(dtype)[::2]
    assert torch.equal(te.window_keys(w, strided, vb, k=21, L=64), want)


def test_engine_reads_entries_take_int64_lens():
    """QueryEngine.search_reads and count_reads_histogram given a torch
    int64 lens answer as with int32 lens."""
    from colorid_tpu_torch import convert
    from colorid_tpu_torch.engine import QueryEngine

    rng = np.random.default_rng(11)
    bloom, matrix, names = ts.rand_blocked_matrix(rng, 21, 60_000, 0.05)
    eng = QueryEngine(
        convert.index_from_arrays(matrix, bloom_size=bloom, num_hash=4, k_size=21,
                                  colors=names, n_ref_kmers={n: 1 for n in names},
                                  blocked=1),
        chunk=2048, device="cpu",
    )
    seqs, lens = _reads(8, 300, 64)
    words, vbits = te.pack_reads_valid(seqs)
    w, vb = ts.t32(words), ts.t32(vbits)
    l32, l64 = torch.from_numpy(lens), torch.from_numpy(lens).to(torch.int64)
    want, n_want = eng.search_reads(w, l32, vb, k=21, L=64, filter_t=0)
    got, n_got = eng.search_reads(w, l64, vb, k=21, L=64, filter_t=0)
    assert n_got == n_want > 0
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.freq_hist, want.freq_hist)
    np.testing.assert_array_equal(
        eng.count_reads_histogram(w, l64, vb, k=21, L=64),
        eng.count_reads_histogram(w, l32, vb, k=21, L=64),
    )
