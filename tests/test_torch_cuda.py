"""Card-only tests of the port, marked ``cuda``: each skips where there is
no CUDA card. They import neither jax nor the JAX package (the machine with
the card has no jax), so they run there without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel (the classic word kernel, the blocked probe kernel) must equal
its plain twin bit for bit, count its launches and refuse what it cannot
take; the engine on the card must give the CPU engine's SearchResult,
through the kernels."""

import numpy as np
import pytest
import torch

from colorid_tpu_torch import native
from colorid_tpu_torch.engine import QueryEngine
from colorid_tpu_torch.ops import stream_query as sq
from colorid_tpu_torch.pipelines.build import build_index
from tests import torch_support as ts
from tests.torch_support import cuda_device  # noqa: F401 (fixture)


def _plan(blocks, rows, device):
    b2 = torch.from_numpy(blocks.view(np.int32)).to(device)
    return (b2,) + sq.classic_plan(torch.from_numpy(rows).to(device), blocks.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_kernel_matches_twin(cuda_device, kind):
    blocks, rows = ts.classic_case(kind, seed=7)
    b2, blk_s, off_s, tb, inwin2d = _plan(blocks, rows, cuda_device)
    assert (int((~inwin2d).sum()) > 0) == (kind == "sparse")
    for planes in (1, 2, 3, 4):
        want = sq.classic_words_plain(b2, blk_s, off_s, tb, planes=planes)
        before = sq.classic_words.launches
        got = sq.classic_words(b2, blk_s, off_s, tb, planes=planes)
        torch.cuda.synchronize()
        assert sq.classic_words.launches == before + 1
        assert got.device.type == "cuda" and got.dtype == torch.int32
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_refuses_mixed_devices(cuda_device):
    blocks, rows = ts.classic_case("dense", seed=1)
    b2, blk_s, off_s, tb, _ = _plan(blocks, rows, cuda_device)
    with pytest.raises(ValueError, match="different devices"):
        sq.classic_words(b2.cpu(), blk_s, off_s, tb, planes=4)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda_device, tmp_path):
    gs = ts.genomes(4, 50_000, seed=1)
    _man, refs = ts.write_panel(tmp_path, gs)
    index = build_index(refs, 375_000, 4, 27, verbose=False)
    nc = native.NativeCounter(27)
    assert nc.add_many(np.ascontiguousarray(ts.reads(gs[:2], 800, 2000, seed=11)))
    packed, qcounts = nc.dump_packed(0)
    cpu = QueryEngine(index, device="cpu")
    card = QueryEngine(index, device=cuda_device)
    assert card._use_stream_classic(packed.shape[0], 27)
    before = sq.classic_words.launches
    got = card.search_keys(None, qcounts=qcounts, packed_all=packed, k=27)
    assert sq.classic_words.launches > before
    want = cpu.search_keys(None, qcounts=qcounts, packed_all=packed, k=27)
    for field in ("counts", "and_all", "freq_hist", "over_colors", "over_freqs"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert got.all_valid == want.all_valid
    assert got.freq_stats() == want.freq_stats()


def _probe(case, device):
    blocks, wpad, blk, off, qc = case
    b2 = torch.from_numpy(blocks.view(np.int32)).to(device)
    return b2, wpad, *(torch.from_numpy(a).to(device) for a in (blk, off, qc))


@pytest.mark.cuda
@pytest.mark.parametrize("C,num_hash,thin", [
    (21, 4, 1), (21, 1, 4), (60, 2, 3), (100, 4, 1), (200, 4, 3), (512, 2, 5),
    (1024, 2, 5),
])
def test_probe_kernel_matches_twin(cuda_device, C, num_hash, thin):
    b2, wpad, blk, off, qc = _probe(ts.probe_case(C, num_hash, seed=C, thin=thin), cuda_device)
    kw = dict(num_hash=num_hash, wpad=wpad, n_colors=C)
    shape = (sq._hist_rows(C), sq._hist_w(C))
    outs = []
    for fn in (sq.stream_probe_plain, sq.stream_probe):
        counts = torch.ones(32 * wpad, dtype=torch.int32, device=cuda_device)  # added into
        hist = torch.ones(shape, dtype=torch.int32, device=cuda_device)
        before = sq.stream_probe.launches
        uniq = fn(b2, blk, off, qc, counts, hist, **kw)
        torch.cuda.synchronize()
        assert sq.stream_probe.launches == before + (fn is sq.stream_probe)
        outs.append((uniq, counts, hist))
    for got, want in zip(outs[1], outs[0]):
        assert got.dtype == torch.int32 and torch.equal(got, want)
    uniq = outs[1][0]
    assert (uniq >= 0).any() and (uniq == -1).any() and (uniq == -2).any()
    # run to run identical (integer atomics)
    counts = torch.ones(32 * wpad, dtype=torch.int32, device=cuda_device)
    hist = torch.ones(shape, dtype=torch.int32, device=cuda_device)
    again = sq.stream_probe(b2, blk, off, qc, counts, hist, **kw)
    assert torch.equal(again, uniq) and torch.equal(hist, outs[1][2])


@pytest.mark.cuda
def test_probe_kernel_refuses_mixed_devices_and_bad_blocks(cuda_device):
    b2, wpad, blk, off, qc = _probe(ts.probe_case(21, 4, seed=1), cuda_device)
    counts = torch.zeros(32, dtype=torch.int32, device=cuda_device)
    hist = torch.zeros((32, 1024), dtype=torch.int32, device=cuda_device)
    kw = dict(num_hash=4, wpad=1, n_colors=21)
    with pytest.raises(ValueError, match="different devices"):
        sq.stream_probe(b2.cpu(), blk, off, qc, counts, hist, **kw)
    # a block outside the matrix reads as absent rows, in kernel and twin
    far = torch.full_like(blk, 10**6)
    got = sq.stream_probe(b2, far, off, qc, counts, hist, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.full_like(blk, -2)) and int(counts.sum()) == 0
    want = sq.stream_probe_plain(b2, far, off, qc, counts, hist, **kw)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("blocked,C", [(2, 21), (4, 150)])
def test_blocked_engine_on_card_matches_cpu(cuda_device, monkeypatch, blocked, C):
    from colorid_tpu_torch import convert

    monkeypatch.setenv("COLORID_STREAM", "force")
    rng = np.random.default_rng(C)
    bloom, matrix, names = ts.rand_blocked_matrix(rng, C, 100_000)
    index = convert.index_from_arrays(
        matrix, bloom_size=bloom, num_hash=4, k_size=31, colors=names,
        n_ref_kmers={n: 1 for n in names}, blocked=blocked,
    )
    packed = ts.rand_packed(rng, 40_000)
    qcounts = rng.integers(1, 2000, 40_000).astype(np.int32)
    cpu = QueryEngine(index, chunk=4096, device="cpu")
    card = QueryEngine(index, chunk=4096, device=cuda_device)
    before = sq.stream_probe.launches
    got = card.search_keys(None, qcounts=qcounts, packed_all=packed, k=31)
    assert sq.stream_probe.launches == before + 2  # segments of 32,768 k-mers
    want = cpu.search_keys(None, qcounts=qcounts, packed_all=packed, k=31)
    for field in ("counts", "and_all", "freq_hist", "over_colors", "over_freqs"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert got.all_valid == want.all_valid
    assert got.freq_stats() == want.freq_stats()
    P = -(-40_000 // sq.PC) * sq.PC
    pk = np.zeros((P, 2), np.uint32)
    pk[:40_000] = packed
    qc = np.zeros(P, np.int32)
    qc[:40_000] = qcounts
    args = (torch.from_numpy(pk.view(np.int32)), torch.from_numpy(qc))
    dev = card.search_keys_dev(*(a.to(cuda_device) for a in args), k=31, max_freq=1999)
    host = cpu.search_keys_dev(*args, k=31, max_freq=1999)
    assert dev is not None and host is not None
    for field in ("counts", "and_all", "freq_hist", "over_colors", "over_freqs"):
        np.testing.assert_array_equal(getattr(dev, field), getattr(host, field))
