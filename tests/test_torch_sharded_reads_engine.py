"""ShardedQueryEngine's read classifier and search_reads
(colorid_tpu_torch/parallel/engine.py) against the JAX package's sharded
engine and the port's single-device QueryEngine, on the 8 virtual CPU
devices of tests/conftest.py: a classic, a blocked (v4) and a
shard-placed (build --color-shards 4) index built from seeded genomes, on
both layouts; readid_counts, readid_counts_arrays, readid_counts_packed,
readid_firsthit, search_reads (the overflow list in order, n_u), and
pipelines/read_id.py's classify_batch and read_id through the sharded
engines, tied reads included (byte-identical files). Integers throughout:
tolerance 0.

The JAX engine is left out where it answers wrong (ROADMAP.md §3): on a
shard-placed index it hashes on the device with the full-width placement
group instead of the recorded one (readid_counts_packed, search_reads),
and on a row mesh whose shard-local block is narrower than the placement
group its single-fetch gather reads other rows. There the port is held
against its single-device engine."""

import os
import types

import numpy as np
import pytest
import torch

from colorid_tpu.index.bigsi import BigsiIndex as JIndex
from colorid_tpu.parallel import sharded as jsh
from colorid_tpu.parallel.engine import ShardedQueryEngine as JSharded
from colorid_tpu.pipelines import read_id as jrid
from colorid_tpu_torch.engine import QueryEngine as TEngine
from colorid_tpu_torch.ops import extract as te
from colorid_tpu_torch.parallel.engine import ShardedQueryEngine as TSharded
from colorid_tpu_torch.pipelines import read_id as trid
from colorid_tpu_torch.pipelines.build import build_index
from tests import torch_support as ts
from tests.test_torch_engine import assert_same_result
from tests.test_torch_sharded_reads import H, K, _cpu_mesh

t32 = ts.t32


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """70 seeded 10 kbp genomes (genome 1 repeats genome 0's first 3 kbp, so
    reads from there tie between them), built by the port as a classic, a
    blocked v4 and a shard-placed (4 color shards) v4 index; each index in
    both packages (the JAX one over the same arrays)."""
    tmp = tmp_path_factory.mktemp("panel")
    gs = ts.genomes(70, 10_000, seed=41)
    gs[1][:3000] = gs[0][:3000]
    _man, refs = ts.write_panel(tmp, gs)
    out = {}
    for kind, kw in (("classic", {}), ("blocked", dict(blocked=True)),
                     ("placed", dict(blocked=True, color_shards=4))):
        t = build_index(refs, 400_000, H, K, verbose=False, **kw)
        j = JIndex(t.bloom_size, t.num_hash, t.k_size, t.m_size, list(t.colors),
                   dict(t.n_ref_kmers), t.matrix, blocked=t.blocked, place_rpb=t.place_rpb)
        out[kind] = (j, t)
    assert out["placed"][1].place_rpb and not out["blocked"][1].place_rpb
    return types.SimpleNamespace(dir=tmp, genomes=gs, index=out)


def _keysets(gs, k, n_reads=40, seed=12):
    """Per-read k-mer sets in FnvHashSet order: reads from the genomes, a
    fifth with a random second half (absent k-mers: the break), a few from
    the shared region (ties)."""
    from colorid_tpu_torch.core.kmers import kmer_set

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_reads):
        g = gs[int(rng.integers(0, len(gs)))] if i % 6 else gs[0]
        s = int(rng.integers(0, 2800 if i % 6 == 0 else len(g) - 150))
        read = g[s:s + 150].copy()
        if i % 5 == 0:
            read[75:] = ts.ACGT[rng.integers(0, 4, 75)]
        out.append(trid._fnv_order_keys(kmer_set([read], k)))
    out.append(np.zeros((0, k), dtype=np.uint8))  # a read without k-mers
    return out


def _engines(panel, kind, layout, nd, nm):
    """(JAX sharded engine, the port's, the port's single-device engine).
    The JAX one is None for the shard-placed index on a row mesh: its
    shard-local block (32 rows) is narrower than the placement group (128
    rows), and the JAX engine's single-fetch gather then reads other rows
    (ROADMAP.md §3); the port gathers row by row there."""
    j, t = panel.index[kind]
    teng = TSharded(t, mesh=_cpu_mesh(nd, nm, layout), layout=layout)
    jeng = None
    if not (kind == "placed" and layout == "row"):
        jeng = JSharded(j, mesh=jsh.make_mesh(nd, nm, layout), layout=layout)
        assert (teng.wpad, teng.rpb) == (jeng.wpad, jeng.rpb)
    else:
        assert teng.rpb == 0
    return jeng, teng, TEngine(t, device="cpu")


@pytest.mark.parametrize("layout", ["color", "row"])
@pytest.mark.parametrize("kind", ["classic", "blocked", "placed"])
def test_engine_readid_matches_jax_and_single_device(panel, kind, layout):
    """readid_counts (the arrays route), readid_firsthit and
    readid_counts_packed on a (2, 4) mesh."""
    jeng, teng, single = _engines(panel, kind, layout, 2, 4)
    ks = _keysets(panel.genomes, K)
    for B in (0, 3):
        got = teng.readid_counts(ks, B)
        if jeng is not None:
            np.testing.assert_array_equal(got, jeng.readid_counts(ks, B))
        np.testing.assert_array_equal(got, single.readid_counts(ks, B))
        assert 0 < int(got[:, -1].sum()) < len(ks) and got[:, :-1].max() > 50
    got = teng.readid_firsthit(ks, 3)
    if jeng is not None:
        np.testing.assert_array_equal(got, jeng.readid_firsthit(ks, 3))
    np.testing.assert_array_equal(got, single.readid_firsthit(ks, 3))
    # the packed route: the read classifier's own preparation of the reads
    from colorid_tpu_torch import native

    reads = [[r] for r in _reads_of(panel.genomes, 30)]
    batch = [(f"r{i}", r) for i, r in enumerate(reads)]
    prep = trid._prepare_native(batch, list(range(len(batch))), teng.index, 1, True)
    if native.available():
        assert prep[0] == "packed"
    if prep is None or prep[0] != "packed":
        return
    _, packed, seg, pos, _maplen = prep
    got = teng.readid_counts_packed(packed, seg, pos, len(batch), 3, K)
    want_single = single.readid_counts_packed(packed, seg, pos, len(batch), 3, K) \
        if not single._custom_place else None
    rows = teng._rows(_packed_keys(packed))
    arrays = teng.readid_counts_arrays(rows, seg.astype(np.int32), pos.astype(np.int32),
                                       len(batch), 3)
    np.testing.assert_array_equal(got, arrays)
    if want_single is not None:
        np.testing.assert_array_equal(got, want_single)
    if kind != "placed":
        np.testing.assert_array_equal(
            got, jeng.readid_counts_packed(packed, seg, pos, len(batch), 3, K))


def _reads_of(gs, n, L=150, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        g = gs[int(rng.integers(0, len(gs)))]
        s = int(rng.integers(0, len(g) - L))
        out.append(g[s:s + L].copy())
    return out


def _packed_keys(packed):
    """ASCII k-mers [N, K] of (lo, hi) packed keys."""
    v = packed[:, 0].astype(np.uint64) | (packed[:, 1].astype(np.uint64) << np.uint64(32))
    shifts = np.uint64(2) * np.arange(K - 1, -1, -1, dtype=np.uint64)
    return ts.ACGT[((v[:, None] >> shifts) & np.uint64(3)).astype(np.intp)]


@pytest.mark.parametrize("kind,layout,nd,nm,filter_t", [
    ("classic", "color", 2, 4, 1), ("classic", "color", 1, 8, 1), ("classic", "row", 4, 2, 0),
    ("blocked", "row", 2, 4, 1), ("blocked", "color", 2, 4, 0),
    ("placed", "color", 2, 4, 1), ("placed", "row", 2, 4, 0),
])
def test_search_reads_matches_jax_and_single_device(panel, kind, layout, nd, nm, filter_t):
    """ShardedQueryEngine.search_reads: the JAX sharded engine's
    SearchResult, overflow list in order, and n_u; the single-device
    engine's answers (on the shard-placed index, whose device hashing the
    single-device engine refuses, search_keys over the same counted
    k-mers)."""
    jeng, teng, single = _engines(panel, kind, layout, nd, nm)
    rng = np.random.default_rng(23)
    L = 150
    reads = np.stack(_reads_of(panel.genomes[:3], 301, seed=23))
    reads[:40] = reads[40:80]  # repeats: frequencies above 1
    # 1,100 copies of a read of genome 2 alone: frequencies past FREQ_CAP,
    # the overflow list
    reads = np.concatenate([reads, np.repeat(panel.genomes[2][None, 5000:5150], 1100, axis=0)])
    words = te.pack_reads(reads)
    lens = rng.integers(100, L + 1, reads.shape[0]).astype(np.int32)
    lens[301:] = L
    got, n_u = teng.search_reads(words, lens, k=K, L=L, filter_t=filter_t)
    if kind != "placed":
        want, want_n = jeng.search_reads(words, lens, k=K, L=L, filter_t=filter_t)
        assert n_u == want_n
        assert_same_result(got, want)
        ref, ref_n = single.search_reads(words, lens, k=K, L=L, filter_t=filter_t)
    else:
        with pytest.raises(ValueError, match="shard-placed"):
            single.search_reads(words, lens, k=K, L=L, filter_t=filter_t)
        pk, qc, ref_n = te.extract_count(t32(words), torch.from_numpy(lens), k=K, L=L,
                                         filter_t=filter_t)
        ref_n = int(ref_n)
        ref = single.search_keys(_packed_keys(pk[:ref_n].numpy().view(np.uint32)),
                                 qcounts=qc[:ref_n].numpy())
    assert n_u == ref_n > 1000
    np.testing.assert_array_equal(got.counts, ref.counts)
    assert got.all_valid == ref.all_valid
    np.testing.assert_array_equal(got.and_all, ref.and_all)
    assert got.freq_stats() == ref.freq_stats() and len(ref.freq_stats()) >= 3
    assert len(got.over_colors) > 50 and set(got.over_freqs.tolist()) >= {1100}


def test_search_reads_guards(panel):
    _j, t = panel.index["classic"]
    teng = TSharded(t, mesh=_cpu_mesh(2, 4, "row"), layout="row")
    words = np.zeros((4, 10), dtype=np.uint32)
    with pytest.raises(ValueError, match="envelope"):
        teng.search_reads(words, np.full(4, 150, np.int32), k=33, L=150)
    big = types.SimpleNamespace(shape=(2**24, 10))
    with pytest.raises(ValueError, match="int32 device indexing"):
        teng.search_reads(big, None, k=31, L=160)
    empty, n_u = teng.search_reads(words, np.full(4, 20, np.int32), k=K, L=150)
    assert n_u == 0 and empty.all_valid and not empty.counts.any()


def _classify_batch(panel, n=96, seed=77):
    """Reads for classify_batch: from the panel, from the shared region
    (tied tops), junk, too short, lowercase."""
    rng = np.random.default_rng(seed)
    gs = panel.genomes
    batch = []
    for i in range(n):
        if i % 7 == 3:
            read = ts.ACGT[rng.integers(0, 4, 20)]  # too_short
        elif i % 7 == 5:
            read = ts.ACGT[rng.integers(0, 4, 150)]
        elif i % 3 == 0:
            s = int(rng.integers(0, 2850))
            read = gs[0][s:s + 150].copy()
        else:
            g = gs[int(rng.integers(0, len(gs)))]
            s = int(rng.integers(0, len(g) - 150))
            read = g[s:s + 150].copy()
        if i == 10:
            read[30:40] += 32  # lowercase
        batch.append((f"r{i}", [read]))
    return batch


@pytest.mark.parametrize("kind,layout", [("classic", "color"), ("blocked", "row"),
                                         ("placed", "color"), ("placed", "row")])
def test_classify_batch_matches_jax(panel, monkeypatch, kind, layout):
    """classify_batch with a sharded engine: the JAX sharded engine's rows
    and the port's single-device engine's, ties included; the packed route
    on an index without a recorded placement, the arrays route with one,
    and the first-hit fixup for the tied reads."""
    jeng, teng, single = _engines(panel, kind, layout, 2, 4)
    batch = _classify_batch(panel)
    calls = {}
    for name in ("readid_counts_packed", "readid_counts_arrays", "readid_firsthit"):
        fn = getattr(teng, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(teng, name, counted)
    got = trid.classify_batch(batch, teng, 1, 1e-3, 3)
    if jeng is not None:
        assert got == jrid.classify_batch(batch, jeng, 1, 1e-3, 3)
    assert got == trid.classify_batch(batch, single, 1, 1e-3, 3)
    ties = [r for r in got if r[4] == "reject" and r[5] > 1]
    assert len(ties) >= 3 and calls.get("readid_firsthit")
    from colorid_tpu_torch import native

    if native.available():
        route = "readid_counts_arrays" if kind == "placed" else "readid_counts_packed"
        assert calls.get(route), calls


@pytest.mark.parametrize("kind,layout", [("blocked", "row"), ("placed", "color")])
def test_read_id_files_match_jax(panel, tmp_path, kind, layout):
    """pipelines/read_id.py::read_id through both packages' sharded engines
    and the port's single-device engine: _reads.txt and _counts.txt byte
    for byte."""
    jeng, teng, single = _engines(panel, kind, layout, 2, 4)
    pairs = ts.read_mix(panel.genomes[:4], 400, seed=9)
    files = list(ts.write_pairs(str(tmp_path), pairs))
    outs = {}
    for name, run, eng in (("jax", jrid.read_id, jeng), ("port", trid.read_id, teng),
                           ("single", trid.read_id, single)):
        prefix = os.path.join(str(tmp_path), name)
        run(files, eng, prefix, b=150, threads=1)
        outs[name] = [open(prefix + s, "rb").read() for s in ("_reads.txt", "_counts.txt")]
    assert outs["port"] == outs["jax"] == outs["single"]
    assert outs["port"][0].count(b"\n") == 400 and b"accept" in outs["port"][0]
