"""Card-only tests of the port, marked ``cuda``: each skips where there is
no CUDA card. They import neither jax nor the JAX package (the machine with
the card has no jax), so they run there without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel (the classic word kernel, the blocked probe kernel and its raw
mode) must equal its plain twin bit for bit, count its launches and refuse
what it cannot take; the engines on the card (single-device, and a (1, 4)
color and row mesh on the one card) must give the CPU's SearchResult,
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
    row_s = torch.from_numpy(rows).to(device)
    return (b2, row_s) + sq.classic_plan(row_s, blocks.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "sparse", "one_chunk"])
def test_kernel_matches_twin(cuda_device, kind):
    """Dense probes, sparse ones with out-of-window probes, and a batch of
    exactly one chunk (one tb entry)."""
    if kind == "one_chunk":
        blocks, rows = ts.classic_case("dense", seed=7, n_chunks=1)
    else:
        blocks, rows = ts.classic_case(kind, seed=7)
    b2, row_s, tb, inwin2d = _plan(blocks, rows, cuda_device)
    assert (int((~inwin2d).sum()) > 0) == (kind == "sparse")
    for planes in (1, 2, 3, 4):
        want = sq.classic_words_plain(b2, row_s, tb, planes=planes)
        before = sq.classic_words.launches
        got = sq.classic_words(b2, row_s, tb, planes=planes)
        torch.cuda.synchronize()
        assert sq.classic_words.launches == before + 1
        assert got.device.type == "cuda" and got.dtype == torch.int32
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_refuses_mixed_devices(cuda_device):
    blocks, rows = ts.classic_case("dense", seed=1)
    b2, row_s, tb, _ = _plan(blocks, rows, cuda_device)
    with pytest.raises(ValueError, match="different devices"):
        sq.classic_words(b2.cpu(), row_s, tb, planes=4)
    # the kernel loads rows as 16-byte vectors
    buf = torch.zeros(row_s.numel() + 1, dtype=torch.int32, device=cuda_device)
    buf[1:] = row_s
    with pytest.raises(ValueError, match="aligned"):
        sq.classic_words(b2, buf[1:], tb, planes=4)


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


def _run_probe_kernel(b2, wpad, blk, off, qc, C, num_hash, device):
    """The probe kernel and its twin on the same inputs, into accumulators
    that start nonzero: bitwise equal, one launch, and the same again on a
    second run (integer atomics). Returns the kernel's (uniq, counts, hist)
    less the accumulators' start."""
    kw = dict(num_hash=num_hash, wpad=wpad, n_colors=C)
    shape = (sq._hist_rows(C), sq._hist_w(C))
    outs = []
    for fn in (sq.stream_probe_plain, sq.stream_probe, sq.stream_probe):
        counts = torch.ones(32 * wpad, dtype=torch.int32, device=device)  # added into
        hist = torch.ones(shape, dtype=torch.int32, device=device)
        before = sq.stream_probe.launches
        uniq = fn(b2, blk, off, qc, counts, hist, **kw)
        torch.cuda.synchronize()
        assert sq.stream_probe.launches == before + (fn is sq.stream_probe)
        outs.append((uniq, counts, hist))
    for got in outs[1:]:
        for g, w in zip(got, outs[0]):
            assert g.dtype == torch.int32 and g.device.type == "cuda"
            assert torch.equal(g, w)
    uniq, counts, hist = outs[1]
    return uniq, counts - 1, hist - 1


# one color count per wpad (1, 2, 4, 8, 16, 32: every lane-group width of the
# gather) times every hash count
PROBE_CASES = [(C, H) for C in (21, 60, 100, 200, 512, 1024) for H in (1, 2, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("C,num_hash", PROBE_CASES)
def test_probe_kernel_matches_twin(cuda_device, C, num_hash):
    # color bits thin enough that the AND over the hashes leaves single and
    # multiple hits: about one set bit per probe
    thin = max(1, round(np.log2(C) / num_hash))
    b2, wpad, blk, off, qc = _probe(ts.probe_case(C, num_hash, seed=C, thin=thin), cuda_device)
    # the last probes' blocks lie beyond the matrix: all-zero rows
    blk[-40:] = b2.shape[0] + torch.arange(40, device=cuda_device, dtype=torch.int32)
    uniq, counts, hist = _run_probe_kernel(b2, wpad, blk, off, qc, C, num_hash, cuda_device)
    assert (uniq >= 0).any() and (uniq == -1).any() and (uniq == -2).any()
    assert (uniq[-40:] == -2).all() and (uniq[qc == 0] == -2).all()
    assert int(counts.sum()) > 0 and int(hist.sum()) > 0


def _hot_case(C, num_hash, qc_values, seed, device):
    """Most probes are unique hits on three hot colors: every row of block b
    holds the one color hot[b % 3] (5 % of the rows absent), so the AND over
    a probe's rows leaves that color; frequencies are drawn from
    qc_values, with 5 % padding."""
    rng = np.random.default_rng(seed)
    _blocks, wpad, blk, off, _qc = ts.probe_case(C, num_hash, seed=seed)
    n_rows = _blocks.shape[0] * (128 // wpad)
    hot = np.array([0, C // 3, C - 1])
    color = hot[np.arange(n_rows) // (128 // wpad) % 3]
    rows = np.zeros((n_rows, wpad), np.uint32)
    rows[np.arange(n_rows), color // 32] = np.uint32(1) << (color % 32).astype(np.uint32)
    rows[rng.random(n_rows) < 0.05] = 0
    qc = rng.choice(np.asarray(qc_values, np.int32), blk.shape[0])
    qc[rng.random(blk.shape[0]) < 0.05] = 0
    return _probe((rows.reshape(-1, 128), wpad, blk, off, qc), device)


@pytest.mark.cuda
def test_probe_kernel_hot_cells(cuda_device):
    """The main path's traffic: nearly every probe a unique hit on one of 3
    colors with a frequency in 1..18, so some 54 histogram cells take it
    all (the kernel's shared band)."""
    C, H = 21, 4
    b2, wpad, blk, off, qc = _hot_case(C, H, np.arange(1, 19), 21, cuda_device)
    uniq, counts, hist = _run_probe_kernel(b2, wpad, blk, off, qc, C, H, cuda_device)
    assert int((uniq >= 0).sum()) > 0.7 * uniq.numel()
    assert int((hist > 0).sum()) <= 3 * 18 and int(hist.sum()) == int((uniq >= 0).sum())
    assert 18 < sq._hist_band(*hist.shape)  # every cell in the band


@pytest.mark.cuda
@pytest.mark.parametrize("C", [21, 200, 1024])
def test_probe_kernel_band_edges(cuda_device, C):
    """Frequencies on both sides of the shared band's edge hf, of the
    histogram's width hw, and beyond it (counted nowhere)."""
    H = 4 if C < 1024 else 2
    hw = sq._hist_w(C)
    hf = sq._hist_band(sq._hist_rows(C), hw)
    edges = sorted({q for q in (1, hf - 1, hf, hf + 1, hw - 1, hw, hw + 1, 5000) if q > 0})
    b2, wpad, blk, off, qc = _hot_case(C, H, edges, C, cuda_device)
    uniq, _counts, hist = _run_probe_kernel(b2, wpad, blk, off, qc, C, H, cuda_device)
    for q in (q for q in edges if q < hw):
        assert int(hist[:, q].sum()) == int(((uniq >= 0) & (qc == q)).sum()) > 0
    assert int(hist.sum()) == int(((uniq >= 0) & (qc < hw)).sum())
    assert int(((uniq >= 0) & (qc >= hw)).sum()) > 0


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
    # the kernel loads rows as 16-byte vectors: a matrix that is not
    # 16-byte aligned is refused, not served by a slower path
    buf = torch.zeros(b2.numel() + 1, dtype=torch.int32, device=cuda_device)
    buf[1:] = b2.reshape(-1)
    with pytest.raises(ValueError, match="aligned"):
        sq.stream_probe(buf[1:].view(-1, 128), blk, off, qc, counts, hist, **kw)


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


# -- the raw probe kernel and the logical meshes --------------------------------


def _sparse_qc(qc):
    """Runs of qc == 0 (padding), and few counted probes between them."""
    n = qc.shape[0]
    live = (torch.arange(n, device=qc.device) // 256 % 3 != 0) & (
        torch.arange(n, device=qc.device) % 7 == 0)
    return torch.where(live, qc, 0)


# one color count per wpad (1, 2, 4, 8, 16, 32: every lane-group width of
# the raw kernel) times every hash count, and two sparse batches
RAW_CASES = [(C, H, False) for C in (21, 60, 100, 200, 512, 1024) for H in (1, 2, 4)]
RAW_CASES += [(1024, 2, True), (21, 1, True)]  # the first: the color-sharded path's shape


@pytest.mark.cuda
@pytest.mark.parametrize("C,num_hash,sparse", RAW_CASES)
def test_raw_kernel_matches_twin(cuda_device, C, num_hash, sparse):
    # color bits thin enough that the AND over the hashes leaves single
    # and multiple hits: about one set bit per probe
    thin = max(1, round(np.log2(C) / num_hash))
    b2, wpad, blk, off, qc = _probe(ts.probe_case(C, num_hash, seed=C, thin=thin), cuda_device)
    if sparse:
        qc = _sparse_qc(qc)
    # the last probes' blocks lie beyond the matrix: all-zero rows
    blk[-40:] = b2.shape[0] + torch.arange(40, device=cuda_device, dtype=torch.int32)
    kw = dict(num_hash=num_hash, wpad=wpad)
    outs = []
    for fn in (sq.stream_probe_raw_plain, sq.stream_probe_raw):
        counts = torch.ones(32 * wpad, dtype=torch.int32, device=cuda_device)  # added into
        before = sq.stream_probe_raw.launches
        facts = fn(b2, blk, off, qc, counts, **kw)
        torch.cuda.synchronize()
        assert sq.stream_probe_raw.launches == before + (fn is sq.stream_probe_raw)
        outs.append((*facts, counts))
    for got, want in zip(outs[1], outs[0]):
        assert got.dtype == torch.int32 and got.device.type == "cuda"
        assert torch.equal(got, want)
    nh, cs, pm, _counts = outs[1]
    assert (nh == 1).any() and (nh > 1).any() and (pm == (1 << num_hash) - 1).any()
    assert not (nh[qc == 0].any() or cs[qc == 0].any() or pm[qc == 0].any())
    assert not (nh[-40:].any() or pm[-40:].any())


@pytest.mark.cuda
def test_raw_kernel_refuses_mixed_devices_and_bad_blocks(cuda_device):
    b2, wpad, blk, off, qc = _probe(ts.probe_case(1024, 2, seed=1, thin=5), cuda_device)
    counts = torch.zeros(32 * wpad, dtype=torch.int32, device=cuda_device)
    kw = dict(num_hash=2, wpad=wpad)
    with pytest.raises(ValueError, match="different devices"):
        sq.stream_probe_raw(b2.cpu(), blk, off, qc, counts, **kw)
    # a block outside the matrix reads as absent rows, in kernel and twin
    far = torch.full_like(blk, 10**6)
    got = sq.stream_probe_raw(b2, far, off, qc, counts, **kw)
    torch.cuda.synchronize()
    assert not any(t.any() for t in got) and int(counts.sum()) == 0
    for g, w in zip(got, sq.stream_probe_raw_plain(b2, far, off, qc, counts, **kw)):
        assert torch.equal(g, w)
    # the kernel loads rows as 16-byte vectors: a matrix that is not
    # 16-byte aligned is refused, not served by a slower path
    buf = torch.zeros(b2.numel() + 1, dtype=torch.int32, device=cuda_device)
    buf[1:] = b2.reshape(-1)
    with pytest.raises(ValueError, match="aligned"):
        sq.stream_probe_raw(buf[1:].view(-1, 128), blk, off, qc, counts, **kw)


def _assert_same_search(got, want):
    for field in ("counts", "and_all", "freq_hist", "over_colors", "over_freqs"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert got.all_valid == want.all_valid
    assert got.freq_stats() == want.freq_stats()


@pytest.mark.cuda
def test_color_mesh_on_card_matches_cpu(cuda_device):
    """A (1, 4) color mesh on the one card: the raw kernel runs once per
    shard, and the answers are the same mesh's on the CPU."""
    from colorid_tpu_torch import ShardedQueryEngine, convert
    from colorid_tpu_torch.parallel.sharded import make_mesh

    rng = np.random.default_rng(5)
    C, R = 4096, 32768
    word = rng.integers(0, 2**32, (3, R, C // 32), dtype=np.uint32)
    matrix = np.where(rng.random((R, C // 32)) < 0.25, word[0] & word[1] & word[2],
                      np.uint32(0))
    names = [f"c{i}" for i in range(C)]
    index = convert.index_from_arrays(
        matrix, bloom_size=R, num_hash=2, k_size=31, colors=names,
        n_ref_kmers={n: 1 for n in names}, blocked=4, place_rpb=4,
    )
    keys = rng.choice(ts.ACGT, (14_000, 31))
    qc = rng.integers(1, 3000, 14_000).astype(np.int32)
    cpu = ShardedQueryEngine(index, mesh=make_mesh(1, 4, "color", devices=["cpu"]))
    card = ShardedQueryEngine(index, mesh=make_mesh(1, 4, "color", devices=[cuda_device]))
    assert card._stream and all(m.device.type == "cuda" for m in card.mat)
    before = sq.stream_probe_raw.launches
    got = card.search_keys(keys, qcounts=qc)
    assert sq.stream_probe_raw.launches == before + 4
    want = cpu.search_keys(keys, qcounts=qc)
    _assert_same_search(got, want)
    assert len(got.freq_stats()) > 10 and len(got.over_colors) > 0
    single = QueryEngine(index, chunk=1 << 14, device=cuda_device).search_keys(keys, qcounts=qc)
    np.testing.assert_array_equal(got.counts, single.counts)
    assert got.freq_stats() == single.freq_stats()


@pytest.mark.cuda
def test_row_mesh_on_card_matches_cpu(cuda_device):
    """A (1, 4) row mesh on the one card: the probe kernel runs once per
    row shard."""
    from colorid_tpu_torch import ShardedQueryEngine, convert
    from colorid_tpu_torch.parallel.sharded import make_mesh

    rng = np.random.default_rng(6)
    bloom, matrix, names = ts.rand_blocked_matrix(rng, 21, 400_000, 0.1, thin=3)
    index = convert.index_from_arrays(
        matrix, bloom_size=bloom, num_hash=4, k_size=31, colors=names,
        n_ref_kmers={n: 1 for n in names}, blocked=4,
    )
    keys = np.unique(rng.choice(ts.ACGT, (30_000, 31)), axis=0)
    qc = rng.integers(1, 2000, keys.shape[0]).astype(np.int32)
    cpu = ShardedQueryEngine(index, layout="row", mesh=make_mesh(1, 4, "row", devices=["cpu"]))
    card = ShardedQueryEngine(index, layout="row", mesh=make_mesh(1, 4, "row", devices=[cuda_device]))
    assert card._stream
    before = sq.stream_probe.launches
    got = card.search_keys(keys, qcounts=qc)
    assert sq.stream_probe.launches == before + 4
    _assert_same_search(got, cpu.search_keys(keys, qcounts=qc))
    assert got.counts.sum() > 0
