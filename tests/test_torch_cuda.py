"""Card-only tests of the port, marked ``cuda``: each skips where there is
no CUDA card. They import neither jax nor the JAX package (the machine with
the card has no jax), so they run there without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel (the classic word kernel, the blocked probe kernel and its raw
mode, the placement kernel and its packed mode, the window-key and
search-epilogue kernels (the epilogue's gather mode too: the generic
gather as one launch), the blocked stream's plan, tail and residual
kernels, the streams' key sort, and the reads routes' run counts in each
mode) must equal its
plain twin bit for bit, count its launches and refuse what it cannot take; the engines on the card (single-device, and a (1, 4)
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


# -- the reads path: device extraction and the read classifier -----------------


def _read_words(seed: int, R: int, L: int):
    """Packed reads with N bases and duplicates: (words, lens, validity
    bits) as CPU tensors, in extract_count's argument order."""
    from colorid_tpu_torch.ops.extract import pack_reads_valid

    rng = np.random.default_rng(seed)
    seqs = ts.ACGT[rng.integers(0, 4, (R, L))]
    seqs[::7, 20] = ord("N")
    seqs[10:20] = seqs[20:30]
    seqs[31] = ord("T")
    w, vb = pack_reads_valid(seqs)
    lens = rng.integers(L - 30, L + 1, R).astype(np.int32)
    return ts.t32(w), torch.from_numpy(lens), ts.t32(vb)


def _on(device, *ts_):
    return [t.to(device) for t in ts_]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [27, 32])
def test_extract_count_on_card_matches_cpu(cuda_device, k):
    from colorid_tpu_torch.ops.extract import count_histogram, extract_count

    L = 151
    cpu = _read_words(k, 512, L)
    for ft, d in ((0, 1), (1, 1), (1, 2)):
        want = extract_count(*cpu, k=k, L=L, filter_t=ft, d=d)
        got = extract_count(*_on(cuda_device, *cpu), k=k, L=L, filter_t=ft, d=d)
        for g, w in zip(got, want):
            assert g.device.type == cuda_device.type and torch.equal(g.cpu(), w)
    want = count_histogram(*cpu, k=k, L=L, cap=256)
    assert torch.equal(count_histogram(*_on(cuda_device, *cpu), k=k, L=L, cap=256).cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["classic", "blocked"])
def test_readid_functions_on_card_match_cpu(cuda_device, kind):
    from colorid_tpu_torch.ops import query as q
    from colorid_tpu_torch.ops.extract import pack_reads_any, pack_reads_valid

    rng = np.random.default_rng(5)
    C, H = 21, 4
    bloom, matrix, _names = ts.rand_blocked_matrix(rng, C, 1 << 16, 0.005)
    blocks, wpad = q.pack_matrix_blocks(matrix)
    rpb = 128 // wpad if kind == "blocked" else 0
    bv = 4 if rpb else 1
    b2 = ts.t32(blocks)
    N, nr = 20000, 300
    seg = torch.from_numpy(np.sort(rng.integers(0, nr, N)).astype(np.int32))
    pos = torch.from_numpy(rng.integers(0, 200, N).astype(np.int32))
    rows = rng.integers(0, bloom, (N, H))
    if rpb:
        rows = rows[:, :1] // rpb * rpb + rng.integers(0, rpb, (N, H))
    rows = torch.from_numpy(rows.astype(np.int32))
    pk = ts.t32(ts.rand_packed(rng, N, 31))
    L, k, M = 160, 31, 400
    seqs = ts.ACGT[rng.integers(0, 4, (M, L))]
    words, vb = pack_reads_valid(seqs)
    mates = ts.t32(pack_reads_any(seqs))
    mseg = torch.from_numpy(np.repeat(np.arange(M // 2), 2).astype(np.int16))
    lens = torch.from_numpy(rng.integers(20, L + 1, M).astype(np.int32))
    ranks = torch.from_numpy(rng.integers(-1, 200, (M, L - k + 1)).astype(np.int16))
    geo = dict(num_colors=C, wpad=wpad, k=k, num_hash=H, bloom_size=bloom, rpb=rpb, bv=bv)
    calls = []
    for B in (0, 3):
        rkw = dict(num_reads=nr, start_sample=B, num_colors=C, wpad=wpad, rpb=rpb)
        calls += [
            (q.query_readid_batch, (b2, rows, seg, pos), rkw),
            (q.query_readid_firsthit, (b2, rows, seg, pos), rkw),
            (q.query_readid_hash_batch, (b2, pk, seg.to(torch.int16), pos.to(torch.int16)),
             dict(geo, num_reads=nr, start_sample=B)),
            (q.query_readid_reads_batch, (b2, mates, mseg, lens, ranks),
             dict(geo, L=L, num_reads=M // 2, start_sample=B)),
            (q.query_readid_firsthit_reads, (b2, mates, mseg, lens, ranks),
             dict(geo, L=L, num_reads=M // 2, start_sample=B)),
        ]
    calls.append((q.query_readid_orderfree_reads, (b2, ts.t32(words), lens, ts.t32(vb)),
                  dict(geo, L=L, num_reads=M // 2, nm=2, d=1)))
    for fn, args, kw in calls:
        want = fn(*args, **kw)
        got = fn(*_on(cuda_device, *args), **kw)
        assert got.device.type == cuda_device.type, fn.__name__
        assert torch.equal(got.cpu(), want), fn.__name__


@pytest.mark.cuda
def test_search_reads_and_orderfree_on_card_match_cpu(cuda_device, tmp_path):
    from colorid_tpu_torch.ops.extract import pack_reads_valid

    gs = ts.genomes(4, 50_000, seed=2)
    _man, refs = ts.write_panel(tmp_path, gs)
    index = build_index(refs, 375_000, 4, 27, verbose=False, blocked=True)
    rs = ts.reads(gs[:2], 3000, 150, seed=3, sub_rate=0.01)
    w, vb = pack_reads_valid(rs)
    lens = np.full(rs.shape[0], 150, dtype=np.int32)
    engines = [QueryEngine(index, device=dev) for dev in ("cpu", cuda_device)]
    before = sq.stream_probe.launches
    (want, n_want), (got, n_got) = (
        e.search_reads(w, lens, vb, k=27, L=160, filter_t=1) for e in engines
    )
    assert n_got == n_want > 0
    assert sq.stream_probe.launches > before  # the dense batch is streamed
    for f in ("counts", "and_all", "freq_hist", "over_colors", "over_freqs"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.all_valid == want.all_valid
    w2, vb2 = pack_reads_valid(rs[:2000])  # 1,000 reads of two mates
    want, got = (
        e.readid_counts_orderfree(w2, np.full(2000, 150, np.int32), vb2, 1000, 2, 27, 160)
        for e in engines
    )
    assert np.array_equal(got, want) and want[:, :4].sum() > 0


# -- the fused reads path and the HTTP server -------------------------------------


@pytest.fixture
def v4_panel(tmp_path):
    """A small v4 index over four random genomes, and 3,000 reads of 150 bp
    with one read repeated 1,100 times (its k-mers pass FREQ_CAP: the
    overflow list)."""
    from colorid_tpu_torch.ops.extract import pack_reads_valid

    gs = ts.genomes(4, 50_000, seed=5)
    _man, refs = ts.write_panel(tmp_path, gs)
    index = build_index(refs, 375_000, 4, 27, verbose=False, blocked=True)
    rs = ts.reads(gs[:2], 3000, 150, seed=6, sub_rate=0.01)
    rs = np.concatenate([rs, np.repeat(rs[:1], 1100, axis=0)])
    w, vb = pack_reads_valid(rs)
    return gs, index, (w, np.full(rs.shape[0], 150, dtype=np.int32), vb)


@pytest.mark.cuda
@pytest.mark.parametrize("max_windows", [None, "150000"])  # single, chunked
def test_fused_routes_on_card_match_cpu(cuda_device, monkeypatch, v4_panel, max_windows):
    _gs, index, batch = v4_panel
    if max_windows:
        monkeypatch.setenv("COLORID_FUSED_MAX_WINDOWS", max_windows)
    engines = [QueryEngine(index, device=dev) for dev in ("cpu", cuda_device)]
    before = sq.stream_probe.launches
    (want, n_want), (got, n_got) = (
        e.search_reads(*batch, k=27, L=160, filter_t=1) for e in engines
    )
    assert sq.stream_probe.launches == before + 1  # one fused stream, on the card
    assert n_got == n_want > 0 and len(want.over_colors) > 0
    for f in ("counts", "and_all", "freq_hist", "over_colors", "over_freqs"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.all_valid == want.all_valid


@pytest.mark.cuda
def test_fused_async_on_card_matches_cpu(cuda_device, v4_panel):
    _gs, index, (w, lens, vb) = v4_panel
    halves = [slice(0, 2000), slice(2000, w.shape[0])]
    rows = []
    for dev in ("cpu", cuda_device):
        eng = QueryEngine(index, device=dev)
        outs = [eng.search_reads_fused_async(ts.t32(w[h]), torch.from_numpy(lens[h]),
                                             ts.t32(vb[h]), k=27, L=160, filter_t=1)
                for h in halves]
        host = torch.stack([o[0] for o in outs]).cpu().numpy()
        rows.append([eng.search_reads_fused_finish(r, *o[1:]) for r, o in zip(host, outs)])
    for (want, n_want), (got, n_got) in zip(*rows):
        assert n_got == n_want > 0
        for f in ("counts", "and_all", "freq_hist", "over_colors", "over_freqs"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.cuda
def test_server_on_card_matches_cpu(cuda_device, tmp_path, v4_panel):
    """/search and /classify through the server on the card and on the
    CPU: the same JSON bodies; /search launches the probe kernel."""
    import json
    import threading
    import urllib.request

    from colorid_tpu_torch import serve

    gs, index, _batch = v4_panel
    path = str(tmp_path / "v4.bxi")
    index.save(path)
    seqs = [r.tobytes().decode() for r in ts.reads(gs[:2], 500, 150, seed=8)]
    pairs = [{"id": f"p{i}", "seqs": [p[0].decode(), p[2].decode()]}
             for i, p in enumerate(ts.read_mix(gs, 40, seed=9))]
    requests = [("/search", {"sequences": seqs, "filter": 0, "p_shared": 0.01}),
                ("/classify", {"reads": pairs})]
    answers = []
    for device in ("cuda", "cpu"):
        srv = serve.make_server(path, 0, device=device)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        before = sq.stream_probe.launches
        try:
            got = []
            for route, body in requests:
                req = urllib.request.Request(url + route, json.dumps(body).encode(),
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    got.append(json.loads(r.read()))
        finally:
            srv.shutdown()
            srv.server_close()
        if device == "cuda":
            assert sq.stream_probe.launches > before
        answers.append(got)
    assert answers[0] == answers[1]
    assert answers[0][0]["rows"] and len(answers[0][1]["rows"]) == 40


@pytest.mark.cuda
def test_device_build_on_card_matches_cpu(cuda_device):
    """build_matrix_device and the row-sharded build + pack on a (1, 4) row
    mesh of the card against the CPU, for 70 colors (bit 31 of two words
    set) with repeated rows and an empty row list."""
    from colorid_tpu_torch.ops import build_ops
    from colorid_tpu_torch.parallel import sharded

    rng = np.random.default_rng(40)
    R, C = 200_003, 70
    row_lists = [rng.integers(0, R, rng.integers(1, 20_000)) for _ in range(C)]
    row_lists[3] = row_lists[3][:0]
    row_lists[31] = np.concatenate([row_lists[31], row_lists[31], [0, R - 1]])
    got = build_ops.build_matrix_device(row_lists, R, device=cuda_device)
    want = build_ops.build_matrix_device(row_lists, R, device="cpu")
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    assert int((want[:, :2] < 0).sum()) > 0  # bit 31 set
    for mult in (1, 128 * 128):
        shards = []
        for dev in (cuda_device, "cpu"):
            mesh = sharded.make_mesh(1, 4, "row", devices=[dev])
            mat, Rl = build_ops.build_matrix_rowshard(row_lists, R, mesh, row_multiple=mult)
            shards.append(build_ops.pack_blocks_rowshard(mat, mesh=mesh, Rl=Rl, W=3))
        for a, b in zip(*shards):
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_wide_functions_on_card_match_cpu(cuda_device):
    """query_accumulate_scan_wide and the wide read_id twins on a small
    block matrix fed split int64 rows: the card's outputs equal the CPU's,
    and the engine's wide route (its flag set on a small index) too."""
    from colorid_tpu_torch.index.bigsi import BigsiIndex
    from colorid_tpu_torch.ops import query as q

    rng = np.random.default_rng(41)
    R, wpad = 4096 * 32, 4
    m = rng.integers(0, 2**32, (R, 3), dtype=np.uint32)
    m &= rng.integers(0, 2**32, (R, 3), dtype=np.uint32)
    m[rng.integers(0, R, R // 4)] = 0
    blocks, _ = q.pack_matrix_blocks(m)
    rows = rng.integers(0, R, (50_000, 3)).astype(np.int64)
    blk, lane0 = q.split_rows_wide(rows, wpad)
    mask = rng.random(50_000) < 0.9
    qc = rng.integers(1, 2000, 50_000).astype(np.int32)
    seg = np.sort(rng.integers(0, 1000, 50_000)).astype(np.int32)
    pos = rng.integers(0, 60, 50_000).astype(np.int32)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        b2 = ts.t32(blocks).to(dev)
        bl = torch.from_numpy(blk).to(dev)
        l0 = torch.from_numpy(lane0).to(dev)
        acc = q.query_accumulate_scan_wide(
            *q.new_accumulators(96, wpad, 1 << 16, dev), b2, bl, l0,
            torch.from_numpy(mask).to(dev), torch.from_numpy(qc).to(dev), 0,
            wpad=wpad, chunk=1 << 14,
        )
        geo = dict(num_reads=1000, start_sample=3, num_colors=96, wpad=wpad)
        sp = (torch.from_numpy(seg).to(dev), torch.from_numpy(pos).to(dev))
        rid = (q.query_readid_batch_wide(b2, bl, l0, *sp, **geo),
               q.query_readid_firsthit_wide(b2, bl, l0, *sp, **geo))
        outs.append([t.cpu() for t in (*acc, *rid)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    names = [f"c{i}" for i in range(96)]
    index = BigsiIndex(R, 3, 31, 0, names, {n: 1 for n in names}, m)
    results = []
    for dev in ("cuda", "cpu"):
        eng = QueryEngine(index, chunk=1 << 14, device=dev)
        eng._wide = True
        results.append(eng.search_keys(None, qcounts=qc, rows_all=rows))
    a, b = results
    for f in ("counts", "and_all", "freq_hist", "over_colors", "over_freqs"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.all_valid == b.all_valid and a.counts.sum() > 0


# -- the sharded read classifier and sharded device extraction --------------------


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["color", "row"])
def test_sharded_reads_on_card_match_cpu(cuda_device, tmp_path, layout):
    """A (2, 2) mesh of either layout on the one card against the same mesh
    on the CPU: readid_counts (the arrays route), readid_counts_packed,
    readid_firsthit, classify_batch and search_reads, bitwise; every tensor
    the sharded functions return lies on the card."""
    from colorid_tpu_torch import ShardedQueryEngine
    from colorid_tpu_torch.core.kmers import kmer_set
    from colorid_tpu_torch.ops.extract import pack_reads
    from colorid_tpu_torch.parallel import sharded
    from colorid_tpu_torch.pipelines import read_id as rid

    gs = ts.genomes(40, 20_000, seed=8)
    gs[1][:4000] = gs[0][:4000]  # reads from here tie between genomes 0 and 1
    _man, refs = ts.write_panel(tmp_path, gs)
    index = build_index(refs, 500_000, 4, 27, verbose=False, blocked=True)
    rs = ts.reads(gs[:3], 600, 150, seed=9, sub_rate=0.01)
    rs[:60] = np.stack([gs[0][s:s + 150] for s in range(0, 3600, 60)])  # ties
    sets = [rid._fnv_order_keys(kmer_set([r], 27)) for r in rs[:200]]
    batch = [(f"r{i}", [r]) for i, r in enumerate(rs[:300])]
    words, lens = pack_reads(rs), np.full(rs.shape[0], 150, dtype=np.int32)

    seen = []
    names = [n for n in dir(sharded) if n.startswith(("readid_", "extract_merge",
                                                       "hash_packed", "query_batch_"))]

    def on_card(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            for t in out if isinstance(out, tuple) else (out,):
                seen.append(t.device.type)
            return out
        return wrapped

    engines = [
        ShardedQueryEngine(index, layout=layout,
                           mesh=sharded.make_mesh(2, 2, layout, devices=[dev]))
        for dev in ("cpu", cuda_device)
    ]
    outs = []
    for e in engines:
        saved = {n: getattr(sharded, n) for n in names}
        if e.mesh.home.type == "cuda":
            for n in names:
                setattr(sharded, n, on_card(saved[n]))
        try:
            prep = rid._prepare_native(batch, list(range(len(batch))), index, 1, True)
            packed = (e.readid_counts_packed(prep[1], prep[2], prep[3], len(batch), 3, 27)
                      if prep is not None and prep[0] == "packed" else None)
            outs.append((
                e.readid_counts(sets, 3), e.readid_firsthit(sets, 3), packed,
                rid.classify_batch(batch, e, 1, 1e-3, 3),
                e.search_reads(words, lens, k=27, L=150, filter_t=1),
            ))
        finally:
            for n in names:
                setattr(sharded, n, saved[n])
    assert seen and set(seen) == {"cuda"}
    (c0, f0, p0, rows0, (s0, n0)), (c1, f1, p1, rows1, (s1, n1)) = outs
    np.testing.assert_array_equal(c1, c0)
    np.testing.assert_array_equal(f1, f0)
    if p0 is not None:
        np.testing.assert_array_equal(p1, p0)
    assert rows1 == rows0 and any(r[4] == "reject" and r[5] > 1 for r in rows0)
    assert n1 == n0 > 0
    _assert_same_search(s1, s0)
    assert c0[:, :-1].max() > 50


def _mesh_panel(tmp):
    """tests/test_torch_process_mesh.py's panel: 24 seeded 3 kbp genomes,
    a classic and a v4 index of 2^16 rows, saved with the workers' inputs."""
    gs = ts.genomes(24, 3000, seed=30)
    gs[1][:2000] = gs[0][:2000]
    _man, refs = ts.write_panel(tmp, gs)
    index = {}
    for kind, kw in (("classic", {}), ("blocked", dict(blocked=True))):
        index[kind] = build_index(refs, 1 << 16, 2, 27, verbose=False, **kw)
        index[kind].save(f"{tmp}/{kind}.bxi")
    return index, ts.write_mesh_inputs(tmp, gs, 27, 150)


@pytest.mark.cuda
def test_process_mesh_on_the_card(cuda_device, tmp_path):
    """Two ranks of tests/torch_process_mesh_worker.py with their shards on
    the card (gloo with one card, both ranks on it; NCCL with two or more,
    one card each) on (1, 4) and (1, 2) row meshes: every output the same
    on both ranks and equal to the single-device engine on the card."""
    import json

    from colorid_tpu_torch.engine import flatten_keys, host_rows
    from colorid_tpu_torch.parallel.engine import _placement_rpb
    from colorid_tpu_torch.pipelines import read_id as rid

    tmp = str(tmp_path)
    index, inp = _mesh_panel(tmp)
    multi = torch.cuda.device_count() >= 2
    worker = f"{ts.ROOT}/tests/torch_process_mesh_worker.py"
    ts.launch_two(lambda r, coord: [worker, coord, str(r), tmp, tmp,
                                    f"cuda:{r if multi else 0}", "nccl" if multi else "gloo"],
                  timeout=300)
    a, b = (dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(2))
    for key in a:
        if not key.endswith((".held", "coll.mismatch", "default.home")):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert [str(o["default.home"]) for o in (a, b)] == [f"cuda:{r if multi else 0}"
                                                        for r in range(2)]
    assert a["m14.classic.held"].tolist() == [True, True, False, False]
    assert "different inputs" in str(b["coll.mismatch"]) and not a["leaked"].size
    keys, qc, sets = inp["keys"], inp["qcounts"], inp["sets"]
    for kind, t in index.items():
        single = QueryEngine(t, device=cuda_device)
        want = single.search_keys(keys, qcounts=qc)
        rows, seg, pos = flatten_keys(sets, lambda k: host_rows(t, k, _placement_rpb(t)))
        rid_want = {
            "readid_counts": single.readid_counts(sets, 3),
            "readid_counts_arrays": single.readid_counts_arrays(rows, seg, pos, len(sets), 3),
            "readid_counts_packed": single.readid_counts_packed(
                inp["packed"], seg, pos, len(sets), 3, 27),
            "readid_firsthit": single.readid_firsthit(sets, 3),
        }
        sr, n_u = single.search_reads(inp["words"], inp["lens"], k=27, L=150, filter_t=1)
        rows_want = json.loads(json.dumps(rid.classify_batch(inp["batch"], single, 1, 1e-3, 3)))
        for mesh in ("m14", "m12"):
            tag = f"{mesh}.{kind}"
            for what in ("search_keys", "born"):
                got = [a[f"{tag}.{what}.{f}"] for f in ("counts", "all_valid", "and_all")]
                np.testing.assert_array_equal(got[0], want.counts)
                assert bool(got[1]) == want.all_valid
                np.testing.assert_array_equal(got[2], want.and_all)
            for name, arr in rid_want.items():
                np.testing.assert_array_equal(a[f"{tag}.{name}"], arr, err_msg=name)
            np.testing.assert_array_equal(a[f"{tag}.search_reads.counts"], sr.counts)
            assert int(a[f"{tag}.search_reads.n_u"]) == n_u > 1000
            assert json.loads(str(a[f"{tag}.classify_batch"])) == rows_want
            assert not a[f"{tag}.stream"] and a[f"{tag}.born.equal_blocks"]


@pytest.mark.cuda
def test_a_model_shard_is_copied_down_its_column(cuda_device, tmp_path):
    """A (2, 2) row mesh over (card, cpu, cpu): shard (1, 0) reads a CPU
    copy of model shard 0 and shard (1, 1) a card copy of model shard 1,
    as JAX replicates a model shard down the data axis; search_keys,
    readid_counts and search_reads equal the single-device engine's."""
    from colorid_tpu_torch import ShardedQueryEngine
    from colorid_tpu_torch.parallel import sharded

    gs = ts.genomes(8, 20_000, seed=3)
    _man, refs = ts.write_panel(tmp_path, gs)
    index = build_index(refs, 1 << 18, 2, 27, verbose=False)
    mesh = sharded.make_mesh(2, 2, "row", devices=[cuda_device, "cpu", "cpu"])
    eng = ShardedQueryEngine(index, mesh=mesh, layout="row")
    assert [m.device.type for m in eng.mat] == ["cuda", "cpu"]
    assert {k: v.device.type for k, v in eng.mat.replicas.items()} == {
        (1, 0): "cpu", (1, 1): "cuda"}
    assert torch.equal(eng.mat.replicas[(1, 0)], eng.mat[0].cpu())
    single = QueryEngine(index, device=cuda_device)
    rd = ts.reads(gs, 400, 150, seed=4)
    keys = np.frombuffer(b"ACGT", dtype=np.uint8)[
        np.random.default_rng(5).integers(0, 4, (5000, 27))]
    keys[:2000] = rd[:, :27].repeat(5, axis=0)[:2000]
    got, want = eng.search_keys(keys), single.search_keys(keys)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.all_valid == want.all_valid and got.freq_stats() == want.freq_stats()
    from colorid_tpu_torch.core.kmers import kmer_set
    from colorid_tpu_torch.ops.extract import pack_reads

    sets = [kmer_set([r], 27) for r in rd[:50]]
    np.testing.assert_array_equal(eng.readid_counts(sets, 3), single.readid_counts(sets, 3))
    lens = np.full(rd.shape[0], 150, dtype=np.int32)
    (s0, n0), (s1, n1) = (e.search_reads(pack_reads(rd), lens, k=27, L=150)
                          for e in (eng, single))
    assert n0 == n1 > 0
    np.testing.assert_array_equal(s0.counts, s1.counts)


@pytest.mark.cuda
def test_placement_over_several_cards(cuda_device, tmp_path):
    """A (2, 2) row mesh over every card of the machine (two or more):
    shard (d, m) on card d * 2 + m (modulo the count), model shards copied
    down their columns; the v4 index's stream per row shard and the
    classic index's generic gather equal the single-device engine."""
    from colorid_tpu_torch import ShardedQueryEngine
    from colorid_tpu_torch.parallel import sharded

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    gs = ts.genomes(8, 20_000, seed=3)
    _man, refs = ts.write_panel(tmp_path, gs)
    keys = np.frombuffer(b"ACGT", dtype=np.uint8)[
        np.random.default_rng(5).integers(0, 4, (5000, 27))]
    keys[:2000] = ts.reads(gs, 2000, 27, seed=4)
    cards = [f"cuda:{i}" for i in range(min(n, 4))]
    for kw in ({}, dict(blocked=True)):
        index = build_index(refs, 1 << 18, 2, 27, verbose=False, **kw)
        eng = ShardedQueryEngine(index, layout="row",
                                 mesh=sharded.make_mesh(2, 2, "row", devices=cards))
        for d in range(2):
            for m in range(2):
                want = (d * 2 + m) % len(cards)
                assert eng.mesh.device(m, d).index == want
                assert sharded._shard(eng.mat, m, d).device.index == want
        assert eng._stream == bool(kw)
        got = eng.search_keys(keys)
        want = QueryEngine(index, device=cuda_device).search_keys(keys)
        np.testing.assert_array_equal(got.counts, want.counts)
        assert got.all_valid == want.all_valid and got.freq_stats() == want.freq_stats()


# -- the placement and window-key kernels -------------------------------------

GRID_K = [4, 7, 8, 9, 15, 16, 17, 27, 31, 32]  # each XXH3 length class and its edges


def _placements(H: int):
    """(rpb, version, blkoff) of every placement the kernel takes at H."""
    out = [(0, 1, False)]
    for version in (1, 2, 3, 4):
        for rpb in (128, 64, 8):
            if version == 1 or H <= rpb:
                out += [(rpb, version, False), (rpb, version, True)]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("k", GRID_K)
def test_placement_kernel_matches_twin(cuda_device, k):
    """Every placement (classic rows, v1-v4 rows and block/offsets) at H 1,
    2, 3 (the loop instance), 4 and 8 and bloom sizes up to 2^31 - 1, from
    packed k-mers and from sort keys with sentinels among them: the kernel
    equals the plain twin on the card bit for bit, twice."""
    from colorid_tpu_torch.ops import extract as te
    from colorid_tpu_torch.ops import hash_torch as ht

    keys = np.random.default_rng(k).choice(ts.ACGT, size=(5000, k))
    pk = ts.t32(ht.pack_keys_host(keys)).to(cuda_device)
    p64 = pk.to(torch.int64) & 0xFFFFFFFF
    sk = te._sort_key(p64[:, 0], p64[:, 1])
    sk[::97] = te.SENT_KEY
    for src in (pk, sk):
        for H in (1, 2, 3, 4, 8):
            for bloom in (1_000_003, 2**31 - 1):
                for rpb, version, blkoff in _placements(H):
                    kw = dict(k=k, num_hash=H, bloom_size=bloom, rpb=rpb,
                              version=version, blkoff=blkoff)
                    before = ht.placement.launches
                    got = [ht.placement(src, **kw) for _ in range(2)]
                    assert ht.placement.launches == before + 2
                    want = ht.placement_plain(src, **kw)
                    if blkoff:
                        got = [torch.cat([b[None], torch.stack(o)]) for b, o in got]
                        want = torch.cat([want[0][None], torch.stack(want[1])])
                    for g in got:
                        assert g.device.type == "cuda" and g.dtype == want.dtype
                        assert torch.equal(g, want), (src.dtype, H, bloom, kw)


@pytest.mark.cuda
def test_placement_kernel_refuses_misaligned_and_counts_only_launches(cuda_device):
    from colorid_tpu_torch.ops import hash_torch as ht

    buf = torch.zeros(2 * 64 + 1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        ht.placement(buf[1:].view(64, 2), k=31, num_hash=4, bloom_size=1000)
    before = ht.placement.launches
    empty = ht.placement(buf[:0].view(0, 2), k=31, num_hash=4, bloom_size=1000)
    assert empty.shape == (0, 4) and ht.placement.launches == before


def _window_reads(seed: int, R: int, L: int):
    """Packed reads with N bases (also at the ends) and true lengths from 1
    to L: (words, lens, validity bits) as CPU tensors."""
    from colorid_tpu_torch.ops.extract import pack_reads_valid

    rng = np.random.default_rng(seed)
    seqs = ts.ACGT[rng.integers(0, 4, (R, L))]
    seqs[rng.random((R, L)) < 0.01] = ord("N")
    seqs[0, 0] = seqs[1, L - 1] = ord("N")
    w, vb = pack_reads_valid(seqs)
    lens = rng.integers(1, L + 1, R).astype(np.int32)
    lens[:3] = L
    return ts.t32(w), torch.from_numpy(lens), ts.t32(vb)


@pytest.mark.cuda
@pytest.mark.parametrize("k", GRID_K)
def test_window_keys_kernel_matches_twin(cuda_device, k):
    """The kernel against the twin on the CPU, bit for bit: read lengths at
    and off the word and bitplane edges, with and without the bitplane,
    strides 1 and 3, twice."""
    from colorid_tpu_torch.ops import extract as te

    for L in sorted({max(k, 16), 33, 150, 160}):
        if L < k:
            continue
        cpu = _window_reads(k * 1000 + L, 700, L)
        dev = _on(cuda_device, *cpu)
        for d in (1, 3):
            for valid in (True, False):
                vb = (cpu[2], dev[2]) if valid else (None, None)
                want = te._window_keys(cpu[0], cpu[1], vb[0], k, L, d)
                before = te.window_keys.launches
                for _ in range(2):
                    got = te.window_keys(dev[0], dev[1], vb[1], k=k, L=L, d=d)
                    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
                assert te.window_keys.launches == before + 2


@pytest.mark.cuda
def test_window_keys_kernel_refuses_mixed_devices(cuda_device):
    from colorid_tpu_torch.ops import extract as te

    w, lens, vb = _window_reads(1, 16, 64)
    with pytest.raises(ValueError, match="different devices"):
        te.window_keys(w.to(cuda_device), lens, None, k=21, L=64)
    empty = te.window_keys(*_on(cuda_device, w[:0], lens[:0], vb[:0]), k=21, L=64)
    assert empty.shape == (0, 44)


# -- the search epilogue kernel -----------------------------------------------

# wpad 1, 2, 4, 8, 16, 32, 64, 128 and the wide tier; 9000: counts past shared memory
EPI_COLORS = [1, 20, 21, 32, 33, 70, 200, 500, 1000, 2000, 4000, 4200, 9000]


def _epi_inputs(C: int, hot: bool, seed: int):
    """AND-words-mode inputs (N not a multiple of the kernel's 512-row
    tile): (wpad, andw, present, mask, q) numpy arrays; ``hot`` puts the
    hits on 3 colors at frequencies 0-18."""
    from colorid_tpu_torch.ops import query as tq

    rng = np.random.default_rng(seed)
    n = 3 * 4096 + 37 if C < 1000 else 4 * 512 + 37
    wpad = tq.row_wpad((C + 31) // 32)
    andw = ts.epi_andw(rng, n, min(C, 3) if hot else C, wpad, high=not hot)
    present = rng.random(n) < 0.85
    q = ts.epi_qcounts(rng, n, hot=hot)
    return wpad, andw, present, q > 0, q


def _epi_on(dev, accs):
    return tuple(torch.from_numpy(a.copy()).to(dev) for a in accs)


def _epi_kernel_calls(monkeypatch, fn, accs, args, kw, n_calls=2):
    """fn on the card n_calls times from the same accumulators, with the
    twin made unreachable: each call launches once; returns the results."""
    from colorid_tpu_torch.ops import query as tq

    def unreachable(*a, **k):
        raise AssertionError("a CUDA call reached _accumulate_tail_plain")

    monkeypatch.setattr(tq, "_accumulate_tail_plain", unreachable)
    outs = []
    for _ in range(n_calls):
        before = fn.launches
        out = fn(*_epi_on("cuda", accs), *args, **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        outs.append(out)
    monkeypatch.undo()
    return outs


def _epi_equal(got, want):
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == torch.int32
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("C", EPI_COLORS)
def test_epilogue_kernel_matches_twins(cuda_device, monkeypatch, C, hot):
    """AND-words mode: the kernel equals the twin on the card and on the
    CPU bit for bit, twice, with bits at and above C, an overflow list that
    starts at 20 and runs past capO, the k-mer index payload from a nonzero
    base_idx and a given payload; rows of 1 to 128 words and the wide tier
    (C 4200, 9000); C 1-55 keep the histogram in shared memory, wider C take
    the global-atomic branch, C 9000 also the global counts."""
    from colorid_tpu_torch.ops import query as tq

    wpad, andw, present, mask, q = _epi_inputs(C, hot, 10 * C + hot)
    accs = ts.epi_accs(C, wpad, 40, n_over=20, seed=C)
    gidx = np.random.default_rng(C).integers(0, 2**31, q.shape[0]).astype(np.int32)
    for base_idx, g in ((123_456_789, None), (0, gidx)):
        args_cpu = (ts.t32(andw), torch.from_numpy(present), torch.from_numpy(mask),
                    torch.from_numpy(q), wpad, base_idx)
        gk = None if g is None else torch.from_numpy(g)
        want = tq._accumulate_tail(*_epi_on("cpu", accs), *args_cpu, gidx=gk)
        args = tuple(a.to(cuda_device) if torch.is_tensor(a) else a for a in args_cpu)
        gc = None if gk is None else gk.to(cuda_device)
        twin = tq._accumulate_tail_plain(*_epi_on(cuda_device, accs), *args, gidx=gc)
        _epi_equal(twin, want)
        for got in _epi_kernel_calls(monkeypatch, tq._accumulate_tail, accs, args,
                                     dict(gidx=gc)):
            _epi_equal(got, want)
        assert int(want[0][C + wpad + 1]) > 40 or hot


# every wpad from 1 to 128 in both layouts and the wide tier (C 4200: 256
# words; a blocked index holds at most 4,096 colors, engine.py)
GATHER_CASES = [(C, layout) for C in (21, 33, 100, 200, 500, 1000, 2000, 4000)
                for layout in ("classic", "blocked")] + [(4200, "classic")]


@pytest.mark.cuda
@pytest.mark.parametrize("C,layout", GATHER_CASES)
def test_gather_mode_matches_twins(cuda_device, monkeypatch, C, layout):
    """The gather mode (_accumulate_one on the card: the rows read, ANDed
    and tested in the kernel) equals _accumulate_one_plain on the card and
    on the CPU bit for bit, twice, at H 1-4 with int32 and int64 rows in
    turns, from accumulators that hold counts and an overflow list that runs
    past capO, the k-mer index from a nonzero base_idx and a given payload,
    bits past C in the last word, padding and N off the tiles; at H 2 the
    hits pile onto three colors at frequencies 0-18 (hot histogram bins)."""
    from colorid_tpu_torch.ops import query as tq

    for H in (1, 2, 3, 4):
        hot = H == 2
        blocks, rows, mask, q, gidx, wpad, rpb = ts.gather_case(
            C, H, layout, seed=10 * C + H, hot=hot, rows64=H % 2 == 1,
            n=ts.GATHER_N if C < 2000 else 4 * 512 + 37, bloom=4096 if C < 2000 else 1024)
        accs = ts.epi_accs(C, wpad, 40, n_over=20, seed=C + H)
        for base_idx, g in ((123_456_789, None), (0, gidx)):
            args_cpu = (ts.t32(blocks), torch.from_numpy(rows), torch.from_numpy(mask),
                        torch.from_numpy(q), wpad, base_idx, rpb)
            gk = None if g is None else torch.from_numpy(g)
            want = tq._accumulate_one_plain(*_epi_on("cpu", accs), *args_cpu, gidx=gk)
            args = tuple(a.to(cuda_device) if torch.is_tensor(a) else a for a in args_cpu)
            gc = None if gk is None else gk.to(cuda_device)
            twin = tq._accumulate_one_plain(*_epi_on(cuda_device, accs), *args, gidx=gc)
            _epi_equal(twin, want)
            monkeypatch.setattr(tq, "_accumulate_one_plain", _unreachable)
            for got in _epi_kernel_calls(monkeypatch, tq._accumulate_one, accs, args,
                                         dict(gidx=gc)):
                _epi_equal(got, want)
            monkeypatch.undo()
            assert int(want[0][C + wpad + 1]) > 40 or hot
            assert int(want[0][C + wpad]) == 0  # a real k-mer was absent


def _unreachable(*a, **k):
    raise AssertionError("a CUDA call reached _accumulate_one_plain")


@pytest.mark.cuda
def test_gather_mode_refuses_and_skips(cuda_device):
    """Rows of another type, more than 32 rows a k-mer, an rpb that is not a
    power of two and a matrix on another device are refused; N = 0
    launches nothing and changes nothing."""
    from colorid_tpu_torch.ops import query as tq

    accs = _epi_on(cuda_device, ts.epi_accs(33, 2, 16, seed=1))
    b2 = torch.zeros((512, 128), dtype=torch.int32, device=cuda_device)
    rows = torch.zeros((64, 4), dtype=torch.int32, device=cuda_device)
    q = torch.ones(64, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="int64 rows"):
        tq._accumulate_one(*accs, b2, rows.to(torch.int16), q > 0, q, 2, 0)
    with pytest.raises(ValueError, match="1 <= H <= 32"):
        tq._accumulate_one(*accs, b2, torch.zeros((64, 33), dtype=torch.int32,
                                                  device=cuda_device), q > 0, q, 2, 0)
    with pytest.raises(ValueError, match="power of two"):
        tq._accumulate_one(*accs, b2, rows, q > 0, q, 2, 0, 48)
    with pytest.raises(ValueError, match="contiguous on the rows' device"):
        tq._accumulate_one(*accs, b2.cpu(), rows, q > 0, q, 2, 0)
    before = tq._accumulate_one.launches
    snap = [a.clone() for a in accs]
    tq._accumulate_one(*accs, b2, rows[:0], q[:0] > 0, q[:0], 2, 0)
    assert tq._accumulate_one.launches == before
    _epi_equal(accs, snap)


SORTED_CASES = [(H, C, "mixed") for H in (1, 2, 3, 4) for C in (5, 12, 21, 32)] + [
    (4, 21, "drop"), (3, 32, "drop")]


@pytest.mark.cuda
@pytest.mark.parametrize("H,C,kind", SORTED_CASES)
def test_epilogue_sorted_mode_matches_twins(cuda_device, monkeypatch, H, C, kind):
    """The sorted-words mode (the classic stream's words in row order, H 1,
    2 and 4 by shifts, 3 by division) on what the stream hands it: equal to
    _accumulate_sorted_words_plain on the card and on the CPU, twice, with
    re-read chunks, padding and an overflow list past capO; "drop" leaves
    more than NCH_CL residual chunks, the rest on the de-offset word."""
    _sorted_mode_case(cuda_device, monkeypatch, H, C, kind)


@pytest.mark.cuda
def test_epilogue_sorted_mode_in_passes(cuda_device, monkeypatch):
    """A batch whose per-k-mer arrays (5 bytes a k-mer) pass half the L2
    runs the first pass over ranges of k-mers: 24 segments, 6,291,456
    k-mers, two passes on an H100's 50 MB; its 1,536 chunks also leave
    more than NCH_CL with residual probes (n_drop > 0)."""
    assert _sorted_mode_case(cuda_device, monkeypatch, 1, 12, "mixed", 24) > 0


def _sorted_mode_case(cuda_device, monkeypatch, H, C, kind, segments=1):
    """The kernel against both twins on sorted_case's batch; returns n_drop."""
    from colorid_tpu_torch.ops import query as tq

    bloom, matrix, packed, q = ts.sorted_case(H, C, kind, seed=10 * H + C, segments=segments)
    blocks, _ = tq.pack_matrix_blocks(matrix)
    b2 = ts.t32(blocks)
    pk, qt = ts.t32(packed), torch.from_numpy(q)
    accs, args, kw, n_drop = ts.sorted_words_args(
        b2.to(cuda_device), pk.to(cuda_device), qt.to(cuda_device), H=H, C=C, bloom=bloom)
    assert bool(args[4].any())
    assert (n_drop > 0) == (kind == "drop") or segments > 1
    accs = [a.cpu().numpy() for a in accs]
    want = tq._accumulate_sorted_words_plain(
        *_epi_on("cpu", accs), *[a.cpu() if torch.is_tensor(a) else a for a in args],
        **{k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()})
    assert int(want[0][C + 2]) > ts.SORTED_CAPO
    _epi_equal(tq._accumulate_sorted_words_plain(*_epi_on(cuda_device, accs), *args, **kw),
               want)
    for got in _epi_kernel_calls(monkeypatch, tq._accumulate_sorted_words, accs, args, kw):
        _epi_equal(got, want)
    return n_drop


@pytest.mark.cuda
def test_epilogue_kernel_refuses_and_skips(cuda_device):
    """Misaligned sorted words and mixed devices are refused; P = 0 and N =
    0 launch nothing and change nothing."""
    from colorid_tpu_torch.ops import query as tq

    accs = _epi_on(cuda_device, ts.epi_accs(21, 1, 16, seed=1))
    buf = torch.zeros(4 * 64 + 4, dtype=torch.int32, device=cuda_device)
    rows = torch.arange(256, dtype=torch.int32, device=cuda_device)
    perm = torch.arange(256, device=cuda_device)
    tb = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    b2 = torch.zeros((512, 128), dtype=torch.int32, device=cuda_device)
    q = torch.ones(64, dtype=torch.int32, device=cuda_device)
    kw = dict(num_hash=4, tile_rows=16384, nt=2)
    with pytest.raises(ValueError, match="aligned"):
        tq._accumulate_sorted_words(*accs, buf[1:257], rows, perm, tb, tb > 0, b2, q > 0, q,
                                    0, **kw)
    with pytest.raises(ValueError, match="different devices"):
        tq._accumulate_sorted_words(*accs, buf[:256], rows, perm, tb, tb > 0, b2,
                                    (q > 0).cpu(), q, 0, **kw)
    before = (tq._accumulate_tail.launches, tq._accumulate_sorted_words.launches)
    snap = [a.clone() for a in accs]
    tq._accumulate_sorted_words(*accs, buf[:0], rows[:0], perm[:0], tb[:0], tb[:0] > 0, b2,
                                q[:0] > 0, q[:0], 0, **kw)
    tq._accumulate_tail(*accs, buf[:0].view(0, 1), q[:0] > 0, q[:0] > 0, q[:0], 1, 0)
    assert (tq._accumulate_tail.launches, tq._accumulate_sorted_words.launches) == before
    _epi_equal(accs, snap)


@pytest.mark.cuda
def test_classic_engine_ends_in_the_epilogue_kernel(cuda_device, monkeypatch, tmp_path):
    """search_keys on the card through the classic stream launches the
    epilogue's sorted-words mode and no indexed gather or scatter (the
    residual patch and the un-sort live in the kernel), and the generic
    gather (COLORID_STREAM=0) its gather mode; both give the CPU's
    SearchResult."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from colorid_tpu_torch.ops import query as tq

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    stream_ops = Ops()
    stream_fn = sq.stream_accumulate_classic_exact

    def recorded(*a, **kw):
        with stream_ops:
            return stream_fn(*a, **kw)

    monkeypatch.setattr(sq, "stream_accumulate_classic_exact", recorded)

    gs = ts.genomes(4, 50_000, seed=2)
    _man, refs = ts.write_panel(tmp_path, gs)
    index = build_index(refs, 375_000, 4, 27, verbose=False)
    nc = native.NativeCounter(27)
    assert nc.add_many(np.ascontiguousarray(ts.reads(gs[:2], 800, 2000, seed=12)))
    packed, qcounts = nc.dump_packed(0)
    want = QueryEngine(index, device="cpu").search_keys(
        None, qcounts=qcounts, packed_all=packed, k=27)
    indexed = {"index", "index_put", "index_put_"}
    assert indexed & stream_ops.names  # the CPU twin's un-sort, seen
    card = QueryEngine(index, device=cuda_device)
    assert card._use_stream_classic(packed.shape[0], 27)
    monkeypatch.setenv("COLORID_STREAM", "0")
    generic = QueryEngine(index, device=cuda_device)
    for fn, engine in ((tq._accumulate_sorted_words, card), (tq._accumulate_one, generic)):
        before, sorts = fn.launches, sq.sort_payloads.launches
        stream_ops.names.clear()
        got = engine.search_keys(None, qcounts=qcounts, packed_all=packed, k=27)
        assert fn.launches > before
        assert (sq.sort_payloads.launches > sorts) == (engine is card)  # kernel E's rows
        assert not indexed & stream_ops.names, stream_ops.names
        for field in ("counts", "and_all", "freq_hist", "over_colors", "over_freqs"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


@pytest.mark.cuda
@pytest.mark.parametrize("blocked", [False, True])
def test_generic_gather_is_one_kernel_launch(cuda_device, monkeypatch, tmp_path, blocked):
    """The generic gather on the card (search_keys with COLORID_STREAM=0,
    from packed k-mers and from host-hashed rows, and the device-resident
    search_keys_dev_generic_async) is kernel A's placement and one gather-
    mode launch of kernel C a chunk: no index, gather, element-wise AND or
    any / all op runs in it (a TorchDispatchMode records them), and the
    SearchResult is the CPU's."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from colorid_tpu_torch import engine as te
    from colorid_tpu_torch.ops import query as tq

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    ops = Ops()
    for name in ("query_accumulate_hash_scan", "query_accumulate_hash_scan_exact",
                 "query_accumulate_scan"):
        real = getattr(te, name)

        def recorded(*a, _real=real, **kw):
            with ops:
                return _real(*a, **kw)

        monkeypatch.setattr(te, name, recorded)
    monkeypatch.setenv("COLORID_STREAM", "0")
    gs = ts.genomes(3, 40_000, seed=5)
    _man, refs = ts.write_panel(tmp_path, gs)
    index = build_index(refs, 300_000, 4, 27, verbose=False, blocked=blocked)
    nc = native.NativeCounter(27)
    assert nc.add_many(np.ascontiguousarray(ts.reads(gs[:2], 600, 2000, seed=13)))
    packed, qcounts = nc.dump_packed(0)
    want = QueryEngine(index, device="cpu").search_keys(
        None, qcounts=qcounts, packed_all=packed, k=27)
    card = QueryEngine(index, device=cuda_device)
    forbidden = {"index", "index_put", "index_put_", "gather", "bitwise_and", "bitwise_and_",
                 "any", "all", "ne"}
    v = packed[:, 0].astype(np.uint64) | (packed[:, 1].astype(np.uint64) << np.uint64(32))
    keys = ts.ACGT[(v[:, None] >> (2 * np.arange(26, -1, -1)).astype(np.uint64)) & np.uint64(3)]
    rows = card.rows_for_keys(keys)
    for run in (lambda: card.search_keys(None, qcounts=qcounts, packed_all=packed, k=27),
                lambda: card.search_keys(None, qcounts=qcounts, rows_all=rows)):
        before = tq._accumulate_one.launches
        ops.names.clear()
        got = run()
        assert tq._accumulate_one.launches > before
        assert ops.names and not forbidden & ops.names, ops.names
        for field in ("counts", "and_all", "freq_hist", "over_colors", "over_freqs"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    n = packed.shape[0]
    pk = ts.t32(packed).to(cuda_device)
    qc = torch.from_numpy(np.maximum(qcounts, 1).astype(np.int32)).to(cuda_device)
    before = tq._accumulate_one.launches
    ops.names.clear()
    dev = card.search_keys_dev_finish(
        *[(x.cpu().numpy() if i == 0 else x) for i, x in enumerate(
            card.search_keys_dev_generic_async(pk, qc, 27, capO=-(-n // 1024) * 1024))])
    assert tq._accumulate_one.launches == before + 1  # one chunk
    assert not forbidden & ops.names, ops.names
    for field in ("counts", "and_all", "freq_hist"):
        np.testing.assert_array_equal(getattr(dev, field), getattr(want, field))


# -- kernel A's packed mode and kernel D (the blocked stream's glue) ----------


@pytest.mark.cuda
@pytest.mark.parametrize("k", [9, 16, 31])
def test_placement_keyoff_matches_twin(cuda_device, k):
    """Kernel A's packed mode (the sort key and the packed offsets) on v1-v4
    at H 1-4, from packed k-mers and from sort keys with sentinels: the key
    as the block, with a clipped or exact frequency in its low 11 bits
    (negative frequencies too), equal to the twin, twice; a frequency in
    the key of a matrix past 2^20 blocks is refused."""
    from colorid_tpu_torch.ops import extract as te
    from colorid_tpu_torch.ops import hash_torch as ht

    rng = np.random.default_rng(k)
    keys = rng.choice(ts.ACGT, size=(5000, k))
    pk = ts.t32(ht.pack_keys_host(keys)).to(cuda_device)
    p64 = pk.to(torch.int64) & 0xFFFFFFFF
    sk = te._sort_key(p64[:, 0], p64[:, 1])
    sk[::97] = te.SENT_KEY
    q = torch.from_numpy(rng.integers(-5, 5000, 5000).astype(np.int32)).to(cuda_device)
    modes = [dict(), dict(qbits=11, qmax=1024), dict(qbits=11, qmin=0, qmax=2047)]
    for src in (pk, sk):
        for H in (1, 2, 3, 4):
            for bloom in (1_000_003, 2**27 + 5, 2**31 - 1):
                for version in (1, 2, 3, 4):
                    for rpb in (128, 8):
                        if version > 1 and H > rpb:
                            continue
                        for m in modes:
                            kw = dict(k=k, num_hash=H, bloom_size=bloom, rpb=rpb,
                                      version=version, **m)
                            qq = q if m else None
                            if m and -(-bloom // rpb) << 11 > 2**31:
                                with pytest.raises(ValueError, match="fit int32"):
                                    ht.placement_keyoff(src, qq, **kw)
                                continue
                            before = ht.placement.launches
                            got = [ht.placement_keyoff(src, qq, **kw) for _ in range(2)]
                            assert ht.placement.launches == before + 2
                            want = ht.placement_keyoff_plain(src, qq, **kw)
                            for g in got:
                                for x, y in zip(g, want):
                                    assert x.device.type == "cuda" and x.dtype == y.dtype
                                    assert torch.equal(x, y), (src.dtype, H, bloom, kw)


_TAIL_WRAPPERS = ("stream_chunk_plan", "stream_tail")


def _capture_tail(monkeypatch):
    """Record each kernel D wrapper's arguments as it is called (tensors
    cloned first: the tail adds into the accumulators)."""
    seen = {}

    def clone(x):
        return x.clone() if torch.is_tensor(x) else x

    for name in _TAIL_WRAPPERS:
        real = getattr(sq, name)

        def rec(*a, _real=real, _name=name, **kw):
            seen[_name] = ([clone(x) for x in a], {k: clone(v) for k, v in kw.items()})
            return _real(*a, **kw)

        rec.launches = real.launches  # the wrapper counts on its module name
        monkeypatch.setattr(sq, name, rec)
    return seen


def _tensors_equal(got, want, what):
    for i, (x, y) in enumerate(zip(got, want)):
        if x is None or y is None:
            assert x is None and y is None, (what, i)
            continue
        assert x.device.type == "cuda" and x.dtype == y.dtype, (what, i, x.dtype, y.dtype)
        assert torch.equal(x, y), (what, i)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ts.STREAM_TAIL_CASES))
def test_stream_tail_kernels_match_twins(cuda_device, monkeypatch, name):
    """Each batch of STREAM_TAIL_CASES through the card's route: every
    accumulator and n_drop equal to the twins' route on the card and on the
    CPU (from accumulators that already hold counts, a histogram and an
    overflow list); two launches of kernel D a batch (its plan and its tail
    with the residual gather); and each kernel D entry point on the inputs
    the route handed it equal to its twin, the accumulators included: the
    skip paths ('skip'), residual chunks past the capacity ('sparse' at 2,
    'past_nch' at 128: n_drop > 0), big probes past OVER_CAP and an overflow
    list past capO ('overflow', and over 40 tiles 'overflow_tiles'), big
    probes only in the last tile, one chunk, W 1 / 2 / 8 and H 1 / 2 / 4."""
    from colorid_tpu_torch.ops import query as tq

    geo, blocks, pk, qc, mode = ts.stream_tail_case(name)
    C, W = geo["n_colors"], geo["wpad"]
    capO, n_over = ts.patch_tail_caps(name, monkeypatch, (sq,)) or (pk.shape[0], 30)
    accs = ts.epi_accs(C, W, capO, n_over, seed=3)
    want = ts.stream_tail_run(geo, blocks, pk, qc, mode, accs, "cpu", False)
    plain = ts.stream_tail_run(geo, blocks, pk, qc, mode, accs, cuda_device, False)
    _tensors_equal(plain, [w.to(cuda_device) for w in want], "twins' route on the card")
    before = [getattr(sq, n).launches for n in _TAIL_WRAPPERS]
    epi, sorts = tq._accumulate_tail.launches, sq.sort_payloads.launches
    seen = _capture_tail(monkeypatch)
    got = ts.stream_tail_run(geo, blocks, pk, qc, mode, accs, cuda_device, True)
    torch.cuda.synchronize()
    assert [getattr(sq, n).launches for n in _TAIL_WRAPPERS] == [b + 1 for b in before]
    assert tq._accumulate_tail.launches == epi + 1
    assert sq.sort_payloads.launches == sorts + 1  # kernel E sorted the int32 key
    _tensors_equal(got, [w.to(cuda_device) for w in want], "the card's route")
    if name in ("sparse", "past_nch", "overflow", "overflow_tiles"):
        assert int(got[4]) > 0
    for fn_name in _TAIL_WRAPPERS:
        a, kw = seen[fn_name]
        twin = getattr(sq, fn_name + "_plain")
        outs = []
        for fn in (getattr(sq, fn_name), twin):
            args = [x.clone() if torch.is_tensor(x) else x for x in a]
            res = fn(*args, **kw)
            res = res if isinstance(res, tuple) else (res,)
            outs.append(list(res) + (args[:4] if fn_name == "stream_tail" else []))
        _tensors_equal(outs[0], outs[1], fn_name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["past_nch", "overflow_tiles", "big_last_tile", "sparse"])
def test_stream_tail_look_backs_hold_over_twenty_runs(cuda_device, monkeypatch, name):
    """The cases whose outputs rest on a look-back (the plan's chunk list
    past nch and at a capacity of 2, the overflow list over 40 tiles and
    from the last tile alone): each entry point run 20 times on the inputs
    the route handed it, each run on fresh outputs and scratch, equal to
    its twin every time, so that an ordering race between the blocks
    shows."""
    geo, blocks, pk, qc, mode = ts.stream_tail_case(name)
    capO, n_over = ts.patch_tail_caps(name, monkeypatch, (sq,)) or (pk.shape[0], 30)
    accs = ts.epi_accs(geo["n_colors"], geo["wpad"], capO, n_over, seed=6)
    seen = _capture_tail(monkeypatch)
    ts.stream_tail_run(geo, blocks, pk, qc, mode, accs, cuda_device, True)
    torch.cuda.synchronize()
    for fn_name in _TAIL_WRAPPERS:
        a, kw = seen[fn_name]
        fn, twin = getattr(sq, fn_name), getattr(sq, fn_name + "_plain")

        def run(f):
            args = [x.clone() if torch.is_tensor(x) else x for x in a]
            res = f(*args, **kw)
            return list(res) + (args[:4] if fn_name == "stream_tail" else [])

        want = run(twin)
        for i in range(20):
            _tensors_equal(run(fn), want, f"{fn_name} run {i}")


@pytest.mark.cuda
def test_fused_probe_on_card_matches_cpu(cuda_device, monkeypatch):
    """The fused reads path's _probe on sorted keys with SENT_KEY padding:
    kernel A's packed mode and kernel D's plan on probes sorted already,
    equal to the CPU's twins."""
    from colorid_tpu_torch.ops import extract as te
    from colorid_tpu_torch.ops import fused_reads as tfr

    geo, blocks, pk, _qc, _mode = ts.stream_tail_case("w2_h4")
    C, W = geo["n_colors"], geo["wpad"]
    p = torch.from_numpy(pk.astype(np.int64))
    keys = te._sort_key(p[:, 0], p[:, 1])
    keys[-1000:] = te.SENT_KEY
    s = torch.sort(keys).values
    qc = torch.from_numpy(np.random.default_rng(7).integers(0, 3000, s.shape[0]).astype(np.int32))
    qc[-1000:] = 0
    accs = ts.epi_accs(C, W, s.shape[0], 10, seed=4)
    kw = dict(k=31, wpad=W, num_hash=geo["num_hash"], bloom_size=geo["bloom_size"],
              rpb=geo["rpb"], n_colors=C, bv=4)
    outs = []
    for dev in ("cpu", cuda_device):
        acc = [torch.from_numpy(a.copy()).to(dev) for a in accs]
        nd = tfr._probe(*acc, ts.t32(blocks).to(dev), s.to(dev), qc.to(dev), **kw)
        outs.append([x.to(cuda_device) for x in (*acc, nd)])
    before = sq.stream_chunk_plan.launches
    seen = _capture_tail(monkeypatch)
    acc = [torch.from_numpy(a.copy()).to(cuda_device) for a in accs]
    tfr._probe(*acc, ts.t32(blocks).to(cuda_device), s.to(cuda_device), qc.to(cuda_device), **kw)
    assert sq.stream_chunk_plan.launches == before + 1
    _tensors_equal(outs[1], outs[0], "fused _probe")
    a, kw2 = seen["stream_chunk_plan"]
    _tensors_equal(sq.stream_chunk_plan(*a, **kw2), sq.stream_chunk_plan_plain(*a, **kw2),
                   "stream_chunk_plan, sorted probes")


# -- kernel E (the streams' key sort with its payloads) -------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ts.SORT_CASES))
def test_sort_kernel_matches_twin(cuda_device, name):
    """Kernel E against its twin, twice, bit for bit: random 30-bit keys
    with an operand and the index from a base, duplicates, all keys equal,
    keys descending with the index widened to int64, bits 1 and 31, P not a
    multiple of the tile, a P of a few hundred, the qbits == 0 batch's three
    operands, an index that wraps past 2^32, P = 0 (no launch), and the
    skew of the main cell's batches: a key with 10 % of the probes, four
    with 1 % each, every key with the same top bits, and bits <= 10 (one
    pass, the index written as int64 there). The inputs stay as they
    were."""
    key, bits, ops, index, base, index64 = ts.sort_case(name)
    k = torch.from_numpy(key).to(cuda_device)
    o = [torch.from_numpy(a).to(cuda_device) for a in ops]
    kw = dict(index=index, base=base, index64=index64)
    want = sq.sort_payloads_plain(k, bits, o, **kw)
    snap = [k.clone()] + [x.clone() for x in o]
    for _ in range(2):
        before = sq.sort_payloads.launches
        got = sq.sort_payloads(k, bits, o, **kw)
        torch.cuda.synchronize()
        assert sq.sort_payloads.launches == before + (key.shape[0] > 0)
        _tensors_equal(got, want, f"sort_payloads {name}")
    _tensors_equal([k] + o, snap, "the sort's inputs")


@pytest.mark.cuda
def test_sort_kernel_at_a_dispatch_size(cuda_device):
    """A blocked dispatch's size (2,359,296 probes, 30 bits, the packed
    offsets and the index) and a classic one's (1,048,576 rows, 26 bits,
    the index as int64): equal to torch.sort(stable) with the gathers."""
    g = torch.Generator(device=cuda_device).manual_seed(16)
    for P, bits, n_ops, index64 in ((2_359_296, 30, 1, False), (1 << 20, 26, 0, True)):
        key = torch.randint(0, 2**bits, (P,), generator=g, device=cuda_device,
                            dtype=torch.int32)
        ops = [torch.randint(-(2**31), 2**31 - 1, (P,), generator=g, device=cuda_device,
                             dtype=torch.int32) for _ in range(n_ops)]
        got = sq.sort_payloads(key, bits, ops, index=True, index64=index64)
        key_s, perm = torch.sort(key, stable=True)
        want = [key_s] + [x[perm] for x in ops] + [perm if index64 else perm.to(torch.int32)]
        _tensors_equal(got, want, f"sort_payloads P={P}")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hot_key", "hot_rows", "one_bucket", "one_pass", "one_digit"])
def test_sort_kernel_skewed_at_a_million(cuda_device, kind):
    """Kernel E against its twin on the card, bit for bit, at 2,000,000
    keys with the skew the main cell's batches bring: a key with 10 % of the
    probes (the blocked padding: one digit's run spans every tile), four
    keys with 1 % each as 26-bit rows with the index as int64 (the classic
    padding), every key with the same top bits, bits <= 10 (one pass, the
    index written as int64 there), and a low digit that is 0 in every key
    (a pass whose tiles hold one digit each)."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    P = 2_000_000

    def rand(n, hi, lo=0):
        return torch.randint(lo, hi, (n,), generator=g, device=cuda_device, dtype=torch.int32)

    bits, kw = 30, dict(index=True, base=123)
    if kind == "hot_key":
        key = rand(P, 2**30)
        key[torch.randperm(P, generator=g, device=cuda_device)[:P // 10]] = 987_654_321
    elif kind == "hot_rows":
        bits, kw = 26, dict(index=True, index64=True)
        key = rand(P, 2**26)
        pick = torch.randperm(P, generator=g, device=cuda_device)[:4 * (P // 100)]
        key[pick] = rand(4, 2**26).repeat_interleave(P // 100)
    elif kind == "one_bucket":
        key = rand(P, 2**22) + (3 << 27)
    elif kind == "one_pass":
        bits, kw = 8, dict(index=True, index64=True)
        key = rand(P, 2**8)
    else:
        key = rand(P, 2**20) << 10
    assert (len(sq.sort_passes(bits)) == 1) == (kind == "one_pass")
    ops = [rand(P, 2**31 - 1, -(2**31))]
    want = sq.sort_payloads_plain(key, bits, ops, **kw)
    before = sq.sort_payloads.launches
    got = sq.sort_payloads(key, bits, ops, **kw)
    torch.cuda.synchronize()
    assert sq.sort_payloads.launches == before + 1
    _tensors_equal(got, want, f"sort_payloads {kind}")


@pytest.mark.cuda
def test_sort_kernel_adds_no_host_sync(cuda_device):
    """At the blocked batch's shape (9,437,184 probes, 30 bits, the packed
    offsets) kernel E runs with torch's sync debug mode set to raise: the
    wrapper and every launch of its passes, sized on the host, wait for
    nothing on the device."""
    g = torch.Generator(device=cuda_device).manual_seed(18)
    P = 9_437_184
    key = torch.randint(0, 2**30, (P,), generator=g, device=cuda_device, dtype=torch.int32)
    key[: P // 10] = 5  # the padding's hot key
    offp = torch.randint(-(2**31), 2**31 - 1, (P,), generator=g, device=cuda_device,
                         dtype=torch.int32)
    sq.sort_payloads(key, 30, [offp])  # the build and the first launch outside the mode
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sq.sort_payloads(key, 30, [offp])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    key_s, perm = torch.sort(key, stable=True)
    _tensors_equal(got, [key_s, offp[perm]], "sort_payloads under the sync debug mode")


@pytest.mark.cuda
def test_sort_kernel_refuses(cuda_device):
    k = torch.arange(64, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="different devices"):
        sq.sort_payloads(k, 8, [k.cpu()])
    with pytest.raises(ValueError, match="at most"):
        sq.sort_payloads(k, 8, [k, k, k], index=True)
    with pytest.raises(TypeError, match="int32"):
        sq.sort_payloads(k.to(torch.int64), 8)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["w2_h4", "skip"])
def test_plan_on_sorted_key_matches_presorted_mode(cuda_device, name):
    """Kernel D1 on the key sorted with its payloads by kernel E against D1
    on the same probes handed over sorted already (the key's bits unpacked
    by torch ops), on the same batch: blk_s, off_s, qc_s, qcw, tb and the
    chunk counts equal, and each equal to its twin."""
    from colorid_tpu_torch.ops.hash_torch import placement_keyoff

    geo, blocks, pk, qc, _mode = ts.stream_tail_case(name)
    q = torch.from_numpy(qc).to(cuda_device)
    key, offp = placement_keyoff(
        ts.t32(pk).to(cuda_device), q, k=geo["k"], num_hash=geo["num_hash"],
        bloom_size=geo["bloom_size"], rpb=geo["rpb"], version=geo["bv"], qbits=sq.QKEY_BITS,
        qmin=0, qmax=sq.QKEY_MASK)
    n_blocks, W = blocks.shape[0], geo["wpad"]
    bits = sq.blocked_key_bits(geo["bloom_size"], geo["rpb"], sq.QKEY_BITS)
    key_s, off_s = sq.sort_payloads(key, bits, [offp])
    free = dict(key_s=key_s, off_s=off_s, qbits=sq.QKEY_BITS)
    presorted = dict(blk_s=key_s >> sq.QKEY_BITS, off_s=off_s, qc_s=key_s & sq.QKEY_MASK)
    before = sq.stream_chunk_plan.launches
    got = sq.stream_chunk_plan(n_blocks, W, **free)
    want = sq.stream_chunk_plan(n_blocks, W, **presorted)
    torch.cuda.synchronize()
    assert sq.stream_chunk_plan.launches == before + 2
    assert got[1] is off_s
    _tensors_equal(got, want, "plan: sorted key vs presorted")
    _tensors_equal(got, sq.stream_chunk_plan_plain(n_blocks, W, **free), "plan twin")


@pytest.mark.cuda
def test_card_route_past_2_20_blocks(cuda_device, monkeypatch):
    """Past 2^20 blocks (forced: the frequency out of the key) kernel E
    sorts the block alone with the offsets, the frequencies and the index,
    one launch; the twins' route's answers."""
    geo, blocks, pk, qc, _mode = ts.stream_tail_case("w2_h4")
    monkeypatch.setattr(sq, "_qc_in_key_ok", lambda bloom_size, rpb: False)
    accs = ts.epi_accs(geo["n_colors"], geo["wpad"], pk.shape[0], 0, seed=5)
    want = ts.stream_tail_run(geo, blocks, pk, qc, "clipped", accs, "cpu", False)
    before = sq.sort_payloads.launches
    got = ts.stream_tail_run(geo, blocks, pk, qc, "clipped", accs, cuda_device, True)
    torch.cuda.synchronize()
    assert sq.sort_payloads.launches == before + 1
    _tensors_equal(got, [w.to(cuda_device) for w in want], "frequency out of the key")


# -- kernel F (the reads routes' run counts, filter and compactions) -----------


def _run_counts_calls(s, w):
    """(mode, weights, keywords) of each mode of kernel F on keys s: select
    at filter_t 0, 1, 3, 7, 15 (0-3 rounds), with no filter, and with
    weights at filter_t 1; compact at 0 and 3; partition of the counts with
    cap 0, a third of the live count, below, at and above it, and P (every
    dead slot written)."""
    from colorid_tpu_torch.ops.extract import run_counts_plain

    calls = [("select", None, dict(filter_t=ft, rounds=min(3, (ft + 1).bit_length() - 1)))
             for ft in (0, 1, 3, 7, 15)]
    calls += [("select", None, {}), ("select", w, dict(filter_t=1)),
              ("compact", None, dict(filter_t=0)), ("compact", None, dict(filter_t=3))]
    qc = run_counts_plain(s, mode="select")[1]
    n = int((qc != 0).sum())
    calls += [("partition", qc, dict(cap=cap))
              for cap in (0, n // 3, max(n - 1000, 0), n, n + 1000, s.numel())]
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("name", ts.RUN_COUNTS_CASES)
def test_run_counts_kernel_matches_twin(cuda_device, name):
    """Every mode on the card's sizes (a SENT run past 1,048,576 slots, runs
    over 40 tiles, runs ending on a tile's last slot, P not a multiple of
    the tile), twice: bit for bit the twin's, one launch a call."""
    from colorid_tpu_torch.ops.extract import run_counts, run_counts_plain

    s, w = (torch.from_numpy(a).to(cuda_device) for a in ts.run_counts_case(name, big=True))
    for mode, ww, kw in _run_counts_calls(s, w):
        want = run_counts_plain(s, ww, mode=mode, **kw)
        for _ in range(2):
            before = run_counts.launches
            got = run_counts(s, ww, mode=mode, **kw)
            torch.cuda.synchronize()
            assert run_counts.launches == before + 1
            for g, x in zip(got, want):
                assert g.device == s.device and g.dtype == x.dtype, (mode, kw)
                assert torch.equal(g, x), (name, mode, kw)


def _keys_past_2_31_bytes(dev):
    """180,000,000 sorted keys, runs of about 1, the last 3,000,000 SENT:
    compact mode's limbs and counts (2.16 GB) pass 2^31 bytes."""
    from colorid_tpu_torch.ops.extract import SENT_KEY

    P = 180_000_000
    g = torch.Generator(device=dev).manual_seed(19)
    s = torch.sort(torch.randint(-(2**40), 2**40, (P,), device=dev, generator=g) // 2**17
                   ).values
    s[-3_000_000:] = SENT_KEY
    return s


@pytest.mark.cuda
def test_run_counts_compact_past_2_31_bytes(cuda_device):
    """compact mode on 180,000,000 keys: its limbs and counts (2.16 GB)
    pass 2^31 bytes, the zero tail included."""
    from colorid_tpu_torch.ops.extract import run_counts, run_counts_plain

    s = _keys_past_2_31_bytes(cuda_device)
    got = run_counts(s, mode="compact", filter_t=1)
    want = run_counts_plain(s, mode="compact", filter_t=1)
    assert int(got[2]) == int(want[2]) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kept_late", "all_kept", "past_2_31_bytes"])
def test_run_counts_look_backs_hold_over_twenty_runs(cuda_device, name):
    """compact and partition, whose tiles take their places by a look-back
    over the tiles before them (every slot kept; a long chain of tiles with
    nothing kept or live; compact past 2^31 bytes): each call 20 times, each
    run on fresh scratch and on outputs that the run before filled with
    junk once it was checked, equal to the twin every time, so that an
    ordering race between the blocks shows."""
    from colorid_tpu_torch.ops.extract import run_counts, run_counts_plain

    if name == "past_2_31_bytes":
        s = _keys_past_2_31_bytes(cuda_device)
        calls = [("compact", None, dict(filter_t=1))]
    else:
        s, w = (torch.from_numpy(a).to(cuda_device) for a in ts.run_counts_case(name, big=True))
        calls = [c for c in _run_counts_calls(s, w) if c[0] != "select"]
    for mode, ww, kw in calls:
        want = run_counts_plain(s, ww, mode=mode, **kw)
        for i in range(20):
            got = run_counts(s, ww, mode=mode, **kw)
            torch.cuda.synchronize()
            for g, x in zip(got, want):
                assert torch.equal(g, x), (name, mode, kw, i)
            for g in got:
                g.fill_(-7)
            del got


@pytest.mark.cuda
def test_run_counts_adds_no_host_sync_and_refuses(cuda_device):
    from colorid_tpu_torch.ops.extract import run_counts

    s, w = (torch.from_numpy(a) for a in ts.run_counts_case("random"))
    calls = [(mode, None if ww is None else ww.to(cuda_device), kw)
             for mode, ww, kw in _run_counts_calls(s, w)]
    s, w = s.to(cuda_device), w.to(cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for mode, ww, kw in calls:
            run_counts(s, ww, mode=mode, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    bad = (
        (s.to(torch.int32), None, dict(mode="select")),
        (s[::2], None, dict(mode="select")),
        (s, None, dict(mode="compact", rounds=1)),
        (s, w, dict(mode="select", rounds=1)),
        (s, w, dict(mode="compact")),
        (s, None, dict(mode="partition")),
        (s, w.cpu(), dict(mode="select")),
        (s[:-1], None, dict(mode="select", rounds=3)),
        (s, w, dict(mode="partition", cap=-1)),
        (s, None, dict(mode="pairs")),
        (s, None, dict(mode="sort")),
    )
    for keys, ww, kw in bad:
        with pytest.raises(ValueError):
            run_counts(keys, ww, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["single", "chunked", "counted"])
def test_reads_routes_run_kernel_f_on_card(cuda_device, monkeypatch, v4_panel, route):
    """search_reads through the single fused dispatch (select with the
    filter), the chunked route (select, partition, select with weights) and
    the counted route (compact), and count_histogram (select): the card's
    answers equal the CPU's, overflow lists in order, through kernel F; no
    twin of F runs on the card."""
    from colorid_tpu_torch.ops import extract as te

    _gs, index, batch = v4_panel
    if route == "chunked":
        monkeypatch.setenv("COLORID_FUSED_MAX_WINDOWS", "150000")
    real = te.run_counts_plain

    def cpu_only(s, *a, **kw):
        assert s.device.type == "cpu", "kernel F's twin ran on the card"
        return real(s, *a, **kw)

    monkeypatch.setattr(te, "run_counts_plain", cpu_only)
    outs = []
    for dev in ("cpu", cuda_device):
        eng = QueryEngine(index, device=dev)
        before = te.run_counts.launches
        if route == "counted":
            out = eng._search_reads_counted(*(eng._to_dev(x) for x in batch), k=27, L=160,
                                            filter_t=1, d=1)
        else:
            out = eng.search_reads(*batch, k=27, L=160, filter_t=1)
        launched = te.run_counts.launches - before
        assert launched == 0 if dev == "cpu" else launched >= (3 if route == "chunked" else 1)
        outs.append(out)
    (want, n_want), (got, n_got) = outs
    assert n_got == n_want > 0 and len(want.over_colors) > 0
    for f in ("counts", "and_all", "freq_hist", "over_colors", "over_freqs"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.all_valid == want.all_valid
    if route == "counted":
        from colorid_tpu_torch.ops.extract import count_histogram

        args = [torch.from_numpy(np.ascontiguousarray(x).view(np.int32)) for x in batch]
        want_h = count_histogram(*args, k=27, L=160, cap=2048)
        got_h = count_histogram(*(a.to(cuda_device) for a in args), k=27, L=160, cap=2048)
        assert torch.equal(got_h.cpu(), want_h) and int(want_h[1:].sum()) > 0


# -- kernel G (the reads routes' value sort) -------------------------------------


def _value_sort_cases(k, dev):
    """Kernel G's inputs at k: seeded canonical window keys with the cell's
    SENT share (chip_smoke.py::synth_window_keys) cut to P = 0, 1, a tile
    and one either side, three tiles and a part, 40 tiles and a part; all
    SENT; one distinct key; the keys with their first half SENT."""
    import chip_smoke as cs
    from colorid_tpu_torch.ops.extract import SENT_KEY, VALUE_SORT_TILE as T

    keys = cs.synth_window_keys(40 * T + 1234, k, dev, seed=k)
    cases = {f"P={P}": keys[:P].contiguous() for P in (0, 1, T - 1, T, T + 1, 3 * T + 517,
                                                      keys.numel())}
    cases["all SENT"] = torch.full((5 * T + 3,), SENT_KEY, dtype=torch.int64, device=dev)
    cases["one distinct key"] = keys[:1].repeat(5 * T + 3)
    half = keys.clone()
    half[: half.numel() // 2] = SENT_KEY
    cases["first half SENT"] = half
    return cases


def _payload_of(keys):
    g = torch.Generator(device=keys.device).manual_seed(keys.numel())
    return torch.randint(-(2**31), 2**31 - 1, keys.shape, generator=g, device=keys.device,
                         dtype=torch.int32)


def _value_sort_check(keys, payload, k, what):
    """Kernel G on keys (and payload) against its twin on the card, bitwise,
    one launch where P > 0, the inputs untouched; both equal
    torch.sort(stable) (and the payload gathered through it)."""
    from colorid_tpu_torch.ops import extract as te

    ins = [keys.clone()] + ([] if payload is None else [payload.clone()])
    want = te.value_sort_plain(keys, payload, bits=2 * k)
    before = te.value_sort.launches
    got = te.value_sort(keys, payload, bits=2 * k)
    torch.cuda.synchronize()
    assert te.value_sort.launches == before + (keys.numel() > 0), what
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    assert len(got) == len(want) == len(ins)
    lib = torch.sort(keys, stable=True)
    for g, w, x, ref in zip(got, want, ins, (lib.values, None if payload is None else
                                             payload[lib.indices])):
        assert g.device == keys.device and g.dtype == w.dtype, what
        assert torch.equal(g, w), what
        assert torch.equal(g, ref), what
    assert torch.equal(keys, ins[0]) and (payload is None or torch.equal(payload, ins[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [15, 31, 32])
@pytest.mark.parametrize("payload", [False, True])
def test_value_sort_kernel_matches_twin(cuda_device, k, payload):
    """Kernel G at k 15 (3 passes), 31 (6) and 32 (the sign bit's digit),
    keys only and with an int32 payload, on every case of
    _value_sort_cases, twice: bit for bit the twin's and torch.sort's."""
    for what, keys in _value_sort_cases(k, cuda_device).items():
        pay = _payload_of(keys) if payload else None
        for _ in range(2):
            _value_sort_check(keys, pay, k, f"k={k} {what}")


@pytest.mark.cuda
@pytest.mark.parametrize("dmax", [8, 9, 10, 11])
def test_value_sort_digit_widths(cuda_device, monkeypatch, dmax):
    """Every widest digit the kernel takes (what sort_bench.py times against
    each other), with and without a payload, and with the 64-bit status
    words of more than 2^30 keys forced on."""
    from colorid_tpu_torch.ops import extract as te

    monkeypatch.setattr(te, "VALUE_SORT_DIGIT_BITS", dmax)
    cases = _value_sort_cases(31, cuda_device)
    for what in ("P=1", f"P={3 * te.VALUE_SORT_TILE + 517}", "first half SENT"):
        keys = cases[what]
        for wide in (False, True):
            monkeypatch.setattr(te, "VALUE_SORT_STATUS32_KEYS", 0 if wide else 2**30 - 1)
            for pay in (None, _payload_of(keys)):
                _value_sort_check(keys, pay, 31, f"dmax {dmax} wide={wide} {what}")


@pytest.mark.cuda
def test_value_sort_at_the_single_routes_size(cuda_device):
    """52,002,816 keys, the single fused dispatch's (400,000 reads x 130
    windows padded with SENT), keys only and with a payload."""
    import chip_smoke as cs

    keys = cs.synth_window_keys(52_002_816, 31, cuda_device)
    _value_sort_check(keys, None, 31, "52,002,816 keys")
    _value_sort_check(keys, _payload_of(keys), 31, "52,002,816 keys with a payload")


@pytest.mark.cuda
@pytest.mark.parametrize("payload", [False, True])
def test_value_sort_look_backs_hold_over_twenty_runs(cuda_device, payload):
    """Kernel G's later passes place each tile by a look-back over the tiles
    before it: 4,000,000 keys 20 times, each on fresh scratch, equal to the
    twin every time, so that an ordering race between the blocks shows."""
    import chip_smoke as cs
    from colorid_tpu_torch.ops import extract as te

    keys = cs.synth_window_keys(4_000_000, 31, cuda_device, seed=20)
    pay = _payload_of(keys) if payload else None
    want = te.value_sort_plain(keys, pay, bits=62)
    for i in range(20):
        got = te.value_sort(keys, pay, bits=62)
        torch.cuda.synchronize()
        for g, w in zip(*((x if isinstance(x, tuple) else (x,)) for x in (got, want))):
            assert torch.equal(g, w), i
        del got


@pytest.mark.cuda
def test_value_sort_adds_no_host_sync_and_refuses(cuda_device):
    from colorid_tpu_torch.ops import extract as te

    keys = _value_sort_cases(31, cuda_device)[f"P={3 * te.VALUE_SORT_TILE + 517}"]
    pay = _payload_of(keys)
    torch.cuda.set_sync_debug_mode("error")
    try:
        te.value_sort(keys, bits=62)
        te.value_sort(keys, pay, bits=62)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    bad = ((keys.to(torch.int32), None, 62), (keys[::2], None, 62), (keys, pay[1:], 62),
           (keys, pay.to(torch.int64), 62), (keys, pay.cpu(), 62), (keys, None, 1),
           (keys, None, 65))
    for kk, pp, bits in bad:
        with pytest.raises((TypeError, ValueError)):
            te.value_sort(kk, pp, bits=bits)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["single", "chunked", "counted"])
def test_reads_routes_sort_through_kernel_g_on_card(cuda_device, monkeypatch, v4_panel, route):
    """search_reads through the single fused dispatch, the chunked route
    (chunk sorts and the merge with its payload) and the counted route, and
    count_histogram: the card's answers equal the CPU's through kernel G;
    no twin of G runs on the card."""
    from colorid_tpu_torch.ops import extract as te

    _gs, index, batch = v4_panel
    if route == "chunked":
        monkeypatch.setenv("COLORID_FUSED_MAX_WINDOWS", "150000")
    real = te.value_sort_plain

    def cpu_only(key, *a, **kw):
        assert key.device.type == "cpu", "kernel G's twin ran on the card"
        return real(key, *a, **kw)

    monkeypatch.setattr(te, "value_sort_plain", cpu_only)
    outs = []
    for dev in ("cpu", cuda_device):
        eng = QueryEngine(index, device=dev)
        before = te.value_sort.launches
        if route == "counted":
            out = eng._search_reads_counted(*(eng._to_dev(x) for x in batch), k=27, L=160,
                                            filter_t=1, d=1)
        else:
            out = eng.search_reads(*batch, k=27, L=160, filter_t=1)
        launched = te.value_sort.launches - before
        assert launched == 0 if dev == "cpu" else launched >= (3 if route == "chunked" else 1)
        outs.append(out)
    (want, n_want), (got, n_got) = outs
    assert n_got == n_want > 0
    for f in ("counts", "and_all", "freq_hist", "over_colors", "over_freqs"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.all_valid == want.all_valid
    if route == "counted":
        args = [torch.from_numpy(np.ascontiguousarray(x).view(np.int32)) for x in batch]
        before = te.value_sort.launches
        got_h = te.count_histogram(*(a.to(cuda_device) for a in args), k=27, L=160, cap=2048)
        assert te.value_sort.launches == before + 1
        assert torch.equal(got_h.cpu(), te.count_histogram(*args, k=27, L=160, cap=2048))


# -- kernel G's merge mode and its SENT keys out of the later passes ------------


def _g_stats(keys, payload, bits, runs):
    """Kernel G on keys with the call's stats kept: (outputs as a tuple,
    descents found, value_sort_stats of the call)."""
    from colorid_tpu_torch.ops import extract as te

    te.value_sort.keep_stats = True
    try:
        got = te.value_sort(keys, payload, bits=bits, runs=runs)
        counted = te.value_sort_stats(te.value_sort.last_stats)
    finally:
        te.value_sort.keep_stats = False
        te.value_sort.last_stats = None
    return (got if isinstance(got, tuple) else (got,)), counted["descents"], counted


def _merge_check(keys, payload, bits, what, *, path=None):
    """Kernel G with the merge hint against value_merge_plain and
    value_sort_plain (on the card), bitwise; the path the device took is
    value_sort_merge_rounds' for the runs found (``path``: "merge" or
    "lsd", where the case fixes it); the inputs untouched."""
    from colorid_tpu_torch.ops import extract as te

    ins = [keys.clone()] + ([] if payload is None else [payload.clone()])
    got, desc, _sent = _g_stats(keys, payload, bits, True)
    runs = te.value_sort_runs(keys, bits)
    merged = te.value_sort_merge_rounds(max(1, runs), bits) > 0
    assert desc + 1 == runs or (not merged and desc + 1 >= 2 ** te.value_sort_merge_max_rounds(
        bits)), (what, desc, runs)
    if path is not None:
        assert merged == (path == "merge"), (what, runs)
    for twin in (te.value_merge_plain, te.value_sort_plain):
        want = twin(keys, payload, bits=bits)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype and torch.equal(g, w), (what, twin.__name__)
        del want
    assert all(torch.equal(a, b) for a, b in zip(ins, (keys, payload)))
    return merged


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 3])
def test_value_sort_merge_at_the_routes_size(cuda_device, S):
    """The chunked route's merge input as the route builds it
    (chip_smoke.synth_merge_keys: S rows of live-then-dead slots cut at
    the [fused] cell's cap of 2^24 for two chunks, 33,554,432 keys with the
    counts as payload, 4 and 6 runs) takes the merge path and equals both
    twins bit for bit."""
    import chip_smoke as cs

    keys, qc = cs.synth_merge_keys(S, 52_000_000 // S, 31, cuda_device, cap=33_554_432 // S)
    assert keys.numel() == 33_554_432
    assert _merge_check(keys, qc, 64, f"S={S}", path="merge")


@pytest.mark.cuda
def test_value_sort_merge_past_2_30_keys(cuda_device):
    """Two runs of 2^29 + 1 keys each, every key once in each run, a
    distinct payload: 2^30 + 2 keys (64-bit status words for the LSD
    launches that exit). The stable merge puts run A's key before run B's
    equal key: keys 0, 0, 1, 1, ... and the payload 0, 1, 2, ...; checked
    in slices."""
    from colorid_tpu_torch.ops import extract as te

    N = 2**29 + 1
    v = torch.arange(N, dtype=torch.int64, device=cuda_device)
    keys = torch.cat([v, v]) ^ te._FLIP
    del v
    pay = torch.cat([torch.arange(0, 2 * N, 2, dtype=torch.int32, device=cuda_device),
                     torch.arange(1, 2 * N, 2, dtype=torch.int32, device=cuda_device)])
    assert keys.numel() > te.VALUE_SORT_STATUS32_KEYS
    (got_k, got_p), desc, _sent = _g_stats(keys, pay, 62, True)
    assert desc == 1
    del keys, pay
    step = 1 << 27
    for a in range(0, 2 * N, step):
        b = min(a + step, 2 * N)
        i = torch.arange(a, b, dtype=torch.int64, device=cuda_device)
        assert torch.equal(got_k[a:b], (i >> 1) ^ te._FLIP), a
        assert torch.equal(got_p[a:b], i.to(torch.int32)), a


@pytest.mark.cuda
@pytest.mark.parametrize("payload", [False, True])
def test_value_sort_merge_hint_on_random_keys_takes_lsd(cuda_device, monkeypatch, payload):
    """Keys in no order with the merge hint: the device takes the LSD
    passes (and with 64-bit status words forced on), bitwise both twins;
    and with runs fewer than the rule allows, the merge."""
    from colorid_tpu_torch.ops import extract as te

    cases = _value_sort_cases(31, cuda_device)
    for what in (f"P={te.VALUE_SORT_TILE + 1}", f"P={3 * te.VALUE_SORT_TILE + 517}",
                 "first half SENT"):
        keys = cases[what]
        pay = _payload_of(keys) if payload else None
        for wide in (False, True):
            monkeypatch.setattr(te, "VALUE_SORT_STATUS32_KEYS", 0 if wide else 2**30 - 1)
            _merge_check(keys, pay, 62, f"{what} wide={wide}", path="lsd")
            _merge_check(keys, pay, 64, f"{what} wide={wide} 64 bits", path="lsd")


def _runs_case(lengths, dev, *, seed, bits, tie=False):
    """Runs of the given lengths, each sorted under ``bits``: seeded window
    keys (with their SENT share), or with ``tie`` the same few keys in
    every run; a distinct payload."""
    import chip_smoke as cs
    from colorid_tpu_torch.ops import extract as te

    P = sum(lengths)
    g = torch.Generator(device=dev).manual_seed(seed)
    if tie:
        base = cs.synth_window_keys(64, 31, dev, seed=seed)
        keys = base[torch.randint(0, 64, (P,), generator=g, device=dev)]
    else:
        keys = cs.synth_window_keys(max(P, 1), 31, dev, seed=seed)[:P].contiguous()
    parts, a = [], 0
    for n in lengths:
        parts.append(te.value_sort_plain(keys[a:a + n].contiguous(), bits=bits))
        a += n
    keys = torch.cat(parts) if parts else keys
    return keys, torch.randperm(P, generator=g, device=dev).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [62, 64])
def test_value_sort_merge_small_cases(cuda_device, bits):
    """One run (copied through), two to nine runs, the rule's most runs and
    one more (the LSD path), runs that meet at the merge tiles' and the
    passes' edges, runs of one key, equal keys in every run with distinct
    payloads (stability), keys only and with the payload, each twice."""
    from colorid_tpu_torch.ops import extract as te

    T, M = te.VALUE_SORT_TILE, te.VALUE_SORT_MERGE_TILE
    most = 2 ** te.value_sort_merge_max_rounds(bits)
    cases = {
        "one run": [5 * M + 3],
        "two runs": [M, M + 1],
        "three runs": [3 * M - 1, 1, 2 * M + 1],
        "nine runs": [M - 1, M, M + 1, 2 * M, 1, 7, T - 1, T + 1, 3],
        "runs at tile edges": [T, M, T - M, 2 * T + 1, M - 1],
        f"{most} runs": [97] * most,
        f"{most + 1} runs": [97] * (most + 1),
    }
    for i, (what, lengths) in enumerate(cases.items()):
        for tie in (False, True):
            keys, pay = _runs_case(lengths, cuda_device, seed=100 + i, bits=bits, tie=tie)
            if te.value_sort_runs(keys, bits) != len(lengths):
                continue  # two runs that happen to join: another case's count
            for p in (None, pay):
                for _ in range(2):
                    _merge_check(keys, p, bits, f"{what} tie={tie} payload={p is not None}",
                                 path="merge" if len(lengths) <= most else "lsd")


def _sent_cases(dev):
    """SENT keys out of the later passes, at k 31: seeded window keys with
    no SENT, all SENT, SENT only in the last tile, SENT across tile edges
    (runs that start a few keys before an edge and end after the next),
    SENT every other key; and with keys that are not SENT but whose low 9,
    18 or 45 bits are all ones (the first, two or five digits: the tail is
    not pure until a later pass)."""
    import chip_smoke as cs
    from colorid_tpu_torch.ops.extract import SENT_KEY, VALUE_SORT_TILE as T

    keys = cs.synth_window_keys(9 * T + 77, 31, dev, seed=7)
    live = keys[keys != SENT_KEY]
    out = {"no SENT": live.contiguous(),
           "all SENT": torch.full((4 * T + 5,), SENT_KEY, dtype=torch.int64, device=dev)}
    last = live[: 5 * T + 300].clone()
    last[-200:] = SENT_KEY
    out["SENT only in the last tile"] = last
    edges = live[: 6 * T + 11].clone()
    for t in (1, 2, 4):
        edges[t * T - 37: (t + 1) * T + 5] = SENT_KEY
    out["SENT across tile edges"] = edges
    alt = live[: 3 * T + 9].clone()
    alt[::2] = SENT_KEY
    out["SENT every other key"] = alt
    for low in (9, 18, 45):
        mixed = keys.clone()
        mixed[5::97] |= (1 << low) - 1  # not SENT: bit 61 of a canonical value is 0
        out[f"keys with their low {low} bits all ones"] = mixed
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("payload", [False, True])
def test_value_sort_sent_keys_skip_the_later_passes(cuda_device, payload):
    """The later passes leave the SENT keys at the tail, in input order with
    their payloads, once the passes before have put them there (copied to
    the outputs where the last pass to sort them wrote the scratch buffer):
    every case of _sent_cases, keys only and with a payload, bitwise the
    twin's and torch.sort's, the SENT count and each pass's tail the call
    kept equal to value_sort_sent_tails'."""
    from colorid_tpu_torch.ops import extract as te

    skipped = 0
    for what, keys in _sent_cases(cuda_device).items():
        pay = _payload_of(keys) if payload else None
        _value_sort_check(keys, pay, 31, what)
        _got, desc, counted = _g_stats(keys, pay, 62, False)
        n_sent = int((keys == te.SENT_KEY).sum())
        want = te.value_sort_sent_tails(keys.cpu(), 62)
        assert desc == 0 and counted["sent"] == n_sent, what
        assert counted["tails"][:len(want)] == want, (what, counted["tails"], want)
        skipped += n_sent > 0 and want[-1] == n_sent
    assert skipped >= 5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["merge", "merge keys only", "lsd with the hint", "sent"])
def test_value_sort_new_paths_hold_over_twenty_runs(cuda_device, case):
    """Each new path 20 times, its outputs and scratch filled with junk in
    between (a freed tensor of -1 of their size that the allocator hands
    out again), equal to the twin every time."""
    import chip_smoke as cs
    from colorid_tpu_torch.ops import extract as te

    if case.startswith("merge"):
        keys, pay = cs.synth_merge_keys(3, 1_500_000, 31, cuda_device, cap=1_100_000)
        bits, runs = 64, True
        if case == "merge keys only":
            pay = None
    else:
        keys = cs.synth_window_keys(4_000_000, 31, cuda_device, seed=21)
        pay = _payload_of(keys)
        bits, runs = 62, case != "sent"
    want = te.value_sort_plain(keys, pay, bits=bits)
    want = want if isinstance(want, tuple) else (want,)
    for i in range(20):
        junk = torch.full((keys.numel() * 6,), -1, dtype=torch.int64, device=cuda_device)
        del junk
        got = te.value_sort(keys, pay, bits=bits, runs=runs)
        torch.cuda.synchronize()
        for g, w in zip((got if isinstance(got, tuple) else (got,)), want, strict=True):
            assert torch.equal(g, w), i
        del got


@pytest.mark.cuda
def test_value_sort_merge_adds_no_host_sync(cuda_device):
    import chip_smoke as cs
    from colorid_tpu_torch.ops import extract as te

    keys, pay = cs.synth_merge_keys(2, 200_000, 31, cuda_device, cap=150_000)
    torch.cuda.set_sync_debug_mode("error")
    try:
        te.value_sort(keys, pay, bits=64, runs=True)
        te.value_sort(keys, bits=64, runs=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)


# -- kernel H: the read classifier's dispatches ------------------------------------

_GEO = ("num_colors", "wpad", "k", "num_hash", "bloom_size", "rpb", "bv")


def _orderfree_keys(case, device):
    """(keys int64 [R, WR] on device, blocks2 on device, geometry) of an
    order-free case: kernel B's window keys, as query_readid_orderfree_reads
    hands them to kernel H."""
    from colorid_tpu_torch.ops.extract import window_keys

    blocks, words, vb, lens, kw = case
    R, WR = kw["num_reads"], kw["nm"] * (kw["L"] - kw["k"] + 1)
    keys = window_keys(*_on(device, ts.t32(words), torch.from_numpy(lens), ts.t32(vb)),
                       k=kw["k"], L=kw["L"], d=kw["d"]).reshape(R, WR)
    return keys, ts.t32(blocks).to(device), {n: kw[n] for n in _GEO}


def _readid_of_case(name):
    if name == "widest":  # 2 x 4,096 bp mates: a set of 16,384 slots in shared memory
        case = ts.readid_orderfree_case(*ts.READID_WIDEST, n_reads=40)
        case[3][:] = ts.READID_WIDEST[5]
    elif name == "global_set":  # 3 x 4,096 bp mates: the set in device memory
        layout, H, C, _nm, d, L = ts.READID_WIDEST
        case = ts.readid_orderfree_case(layout, H, C, 3, d, L, n_reads=300)
    elif name == "counts_in_row":  # C too wide for shared memory: counts in the output row
        case = ts.readid_orderfree_case("classic", 2, 52_000, 2, 1, 64, n_reads=12)
    elif name in ts.READID_OF_EDGE_CASES:
        case = ts.readid_orderfree_case(*ts.READID_OF_EDGE_CASES[name],
                                        n_reads=ts.READID_EDGE_READS)
    else:
        case = ts.readid_orderfree_case(*ts.READID_OF_CASES[name])
    return case


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ts.READID_OF_CASES)
                         + ["widest", "global_set", "counts_in_row"]
                         + sorted(ts.READID_OF_EDGE_CASES))
def test_readid_orderfree_kernel_matches_twin(cuda_device, name):
    from colorid_tpu_torch.ops import query as q

    keys, b2, geo = _orderfree_keys(_readid_of_case(name), cuda_device)
    want = q._orderfree_plain(keys.cpu(), b2.cpu(), **geo)
    g = torch.Generator(device=cuda_device).manual_seed(7)
    perm = torch.argsort(torch.rand(keys.shape, generator=g, device=cuda_device), dim=1)
    shuffled = keys.gather(1, perm).contiguous()
    before = q.readid_launches["orderfree"]
    for order in (keys, keys, shuffled):
        got = q.readid_orderfree(order, b2, **geo)
        torch.cuda.synchronize()
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want), name
    assert q.readid_launches["orderfree"] == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ts.READID_EXACT_CASES))
def test_readid_exact_kernel_matches_twin(cuda_device, name):
    from colorid_tpu_torch.ops import query as q

    blocks, rows, seg, pos, kw = ts.readid_exact_case(*ts.READID_EXACT_CASES[name])
    cpu = (ts.t32(blocks), torch.from_numpy(rows), torch.from_numpy(seg), torch.from_numpy(pos))
    card = _on(cuda_device, *cpu)
    for firsthit in (False, True):
        mode = "firsthit" if firsthit else "replay"
        want = q.readid_exact(*cpu, **kw, firsthit=firsthit)
        before = q.readid_launches[mode]
        for _ in range(2):
            got = q.readid_exact(*card, **kw, firsthit=firsthit)
            torch.cuda.synchronize()
            assert got.device.type == "cuda" and torch.equal(got.cpu(), want), (name, mode)
        assert q.readid_launches[mode] == before + 2


def _readid_dispatch_case(layout, device):
    """The [reads] dispatch's shape on a 50,000,000-row index: order-free
    (keys, blocks2, geometry) of 8,192 pairs of 160 bp mates (2,129,920
    windows), and the replay's (blocks2, rows, seg, pos) of 2,000,000 k-mers
    of 8,192 reads in no order."""
    from colorid_tpu_torch.ops.extract import pack_reads_valid

    blocks, geo = ts.readid_matrix(layout, 4, 21, seed=11, bloom_size=50_000_000)
    rng = np.random.default_rng(12)
    seqs, lens = ts.readid_mates(rng, 8192, 2, 160, 31)
    words, vb = pack_reads_valid(seqs)
    case = (blocks, words, vb, lens, dict(geo, num_reads=8192, k=31, L=160, nm=2, d=1))
    keys, b2, g = _orderfree_keys(case, device)
    N, R = 2_000_000, 8192
    rows = rng.integers(0, geo["bloom_size"], (N, 4))
    if geo["rpb"]:
        rows = rows[:, :1] // geo["rpb"] * geo["rpb"] + rng.integers(0, geo["rpb"], (N, 4))
    args = (b2, torch.from_numpy(rows.astype(np.int32)).to(device),
            torch.from_numpy(rng.integers(0, R, N).astype(np.int32)).to(device),
            torch.from_numpy(rng.integers(0, 200, N).astype(np.int32)).to(device))
    return (keys, b2, g), args, dict(num_reads=R, num_colors=21, wpad=geo["wpad"],
                                     rpb=geo["rpb"])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["classic", "v4"])
def test_readid_kernel_holds_over_twenty_runs(cuda_device, layout):
    """Kernel H's shared-memory hash set and the exact mode's
    warp-aggregated atomics must not race: at the dispatch's size each
    mode, 20 times, gives its twin's outputs, each run's output overwritten
    with junk after its check."""
    from colorid_tpu_torch.ops import query as q

    (keys, b2, g), args, kw = _readid_dispatch_case(layout, cuda_device)
    runs = [(lambda: q.readid_orderfree(keys, b2, **g), q._orderfree_plain(keys, b2, **g))]
    for twin, firsthit in ((q._readid_core_plain, False), (q._readid_firsthit_core_plain, True)):
        ekw = dict(kw, start_sample=3)
        runs.append((lambda f=firsthit, e=ekw: q.readid_exact(*args, **e, firsthit=f),
                     twin(*args, **ekw)))
    for run, want in runs:
        for i in range(20):
            got = run()
            torch.cuda.synchronize()
            assert torch.equal(got, want), (layout, i)
            got.fill_(-7)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["classic", "v4"])
def test_readid_kernel_at_the_dispatch_size(cuda_device, layout):
    """The [reads] dispatch's shape: 8,192 pairs of 160 bp mates (2,129,920
    windows) on a 50,000,000-row index, order-free; and the replay and first
    hit on 2,000,000 k-mers of 8,192 reads in no order, B 0 and 3."""
    from colorid_tpu_torch.ops import query as q
    from colorid_tpu_torch.ops.extract import pack_reads_valid

    blocks, geo = ts.readid_matrix(layout, 4, 21, seed=11, bloom_size=50_000_000)
    rng = np.random.default_rng(12)
    seqs, lens = ts.readid_mates(rng, 8192, 2, 160, 31)
    words, vb = pack_reads_valid(seqs)
    case = (blocks, words, vb, lens, dict(geo, num_reads=8192, k=31, L=160, nm=2, d=1))
    keys, b2, g = _orderfree_keys(case, cuda_device)
    want = q._orderfree_plain(keys, b2, **g)  # the twin on the card's tensors
    for _ in range(2):
        assert torch.equal(q.readid_orderfree(keys, b2, **g), want)
    N, R = 2_000_000, 8192
    rows = rng.integers(0, geo["bloom_size"], (N, 4))
    if geo["rpb"]:
        rows = rows[:, :1] // geo["rpb"] * geo["rpb"] + rng.integers(0, geo["rpb"], (N, 4))
    args = (b2, torch.from_numpy(rows.astype(np.int32)).to(cuda_device),
            torch.from_numpy(rng.integers(0, R, N).astype(np.int32)).to(cuda_device),
            torch.from_numpy(rng.integers(0, 200, N).astype(np.int32)).to(cuda_device))
    for B in (0, 3):
        kw = dict(num_reads=R, start_sample=B, num_colors=21, wpad=geo["wpad"], rpb=geo["rpb"])
        for twin, firsthit in ((q._readid_core_plain, False),
                               (q._readid_firsthit_core_plain, True)):
            want = twin(*args, **kw)
            for _ in range(2):
                assert torch.equal(q.readid_exact(*args, **kw, firsthit=firsthit), want)


@pytest.mark.cuda
def test_readid_kernel_refuses_what_it_cannot_take(cuda_device):
    from colorid_tpu_torch.ops import query as q

    blocks, rows, seg, pos, kw = ts.readid_exact_case(*ts.READID_EXACT_CASES[
        "classic_h4_c21_b0_sorted"])
    b2, r, s, p = _on(cuda_device, ts.t32(blocks), torch.from_numpy(rows),
                      torch.from_numpy(seg), torch.from_numpy(pos))
    with pytest.raises(ValueError, match="seg_ids must be int32"):
        q.readid_exact(b2, r, s.to(torch.int16), p, **kw)
    with pytest.raises(ValueError, match="contiguous on one device"):
        q.readid_exact(b2, r, s, p.cpu(), **kw)
    with pytest.raises(ValueError, match="num_colors"):
        q.readid_exact(b2, r, s, p, **dict(kw, num_colors=40))
    keys, b2, geo = _orderfree_keys(_readid_of_case("v4_h4_c21_nm2_d1"), cuda_device)
    with pytest.raises(ValueError, match="contiguous int64"):
        q.readid_orderfree(keys[:, ::2], b2, **geo)
    with pytest.raises(ValueError, match="exceed the matrix"):
        q.readid_orderfree(keys, b2, **dict(geo, bloom_size=4 * b2.numel()))
