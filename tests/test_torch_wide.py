"""Indexes past int32 row addressing (bloom_size >= 2^31) in the port
(colorid_tpu_torch/ops/query.py's wide functions and QueryEngine's wide
route) against the JAX package's, function by function on a small seeded
block matrix fed int64 rows split into (block, lane) pairs, and the
engine's routing on a small index with its wide flag set: the port's wide
route is the generic gather over int64 rows. A real 3e9-row
index (12 GB of matrix) runs only on the card, in chip_smoke.py's [wide]
phase; the engine's guards here take a bloom_size past 2^31 over a small
matrix, so nothing large is allocated. Integers throughout: tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu.engine import QueryEngine as JEngine
from colorid_tpu.index.bigsi import BigsiIndex as JIndex
from colorid_tpu.ops import query as jq
from colorid_tpu_torch import ShardedQueryEngine as TSharded
from colorid_tpu_torch.engine import QueryEngine as TEngine
from colorid_tpu_torch.engine import host_rows
from colorid_tpu_torch.index.bigsi import BigsiIndex as TIndex
from colorid_tpu_torch.ops import query as tq
from colorid_tpu_torch.parallel import sharded as tsh
from tests import torch_support as ts
from tests.test_torch_engine import assert_same_result

WPADS = [1, 2, 4, 8, 16, 32, 64, 128]


@pytest.mark.parametrize("wpad", WPADS)
def test_split_rows_wide_matches_jax(wpad):
    """Rows up to 3e9 and up to the last row the split can address at this
    width (bloom_size * wpad < 2^38)."""
    rng = np.random.default_rng(wpad)
    top = (1 << 38) // wpad - 1
    wide = min(3_000_000_000 - 1, top)
    rows = np.concatenate([
        rng.integers(0, wide + 1, 600),
        rng.integers(min(2**31, top), top + 1, 300),
        [0, 1, 2**31 - 1, min(2**31, top), wide, top],
    ]).astype(np.int64).reshape(-1, 3)
    blk, lane0 = tq.split_rows_wide(rows, wpad)
    jblk, jlane0 = jq.split_rows_wide(rows, wpad)
    assert blk.dtype == lane0.dtype == np.int32
    np.testing.assert_array_equal(blk, jblk)
    np.testing.assert_array_equal(lane0, jlane0)
    # the pair addresses the row's first word: blk * 128 + lane0 = row * wpad
    np.testing.assert_array_equal(
        blk.astype(np.int64) * 128 + lane0, rows * wpad)
    assert blk.min() >= 0 and lane0.min() >= 0 and lane0.max() + wpad <= 128


def _case(wpad: int, seed: int, n: int = 3000, H: int = 3):
    """A seeded block matrix of rows of wpad words (a quarter of the rows
    absent; thin words so that ANDs leave single hits) and n k-mers' int64
    rows over it, split."""
    rng = np.random.default_rng(seed)
    R = 4096 * (128 // wpad)  # 4096 blocks
    W = wpad if wpad <= 2 else wpad // 2 + 1  # row_wpad(W) == wpad
    m = rng.integers(0, 2**32, (R, W), dtype=np.uint32)
    m &= rng.integers(0, 2**32, (R, W), dtype=np.uint32)
    m &= rng.integers(0, 2**32, (R, W), dtype=np.uint32)
    m[rng.integers(0, R, R // 4)] = 0
    blocks, wp = tq.pack_matrix_blocks(m)
    assert wp == wpad
    rows = rng.integers(0, R, (n, H)).astype(np.int64)
    blk, lane0 = tq.split_rows_wide(rows, wpad)
    return blocks, W * 32, rows, blk, lane0, rng


@pytest.mark.parametrize("wpad", [1, 4, 32])
def test_query_accumulate_scan_wide_matches_jax_and_narrow(wpad):
    blocks, C, rows, blk, lane0, rng = _case(wpad, seed=wpad)
    n = rows.shape[0]
    chunk = 1000
    mask = rng.random(n) < 0.9
    qc = rng.integers(1, 60, n).astype(np.int32)
    qc[rng.random(n) < 0.05] = 2000  # the overflow list
    capO = 1024
    jstate = (
        jnp.concatenate([jnp.zeros(C, jnp.int32), jnp.full(wpad, -1, jnp.int32),
                         jnp.array([1, 0], jnp.int32)]),
        jnp.zeros((C, tq.FREQ_CAP), jnp.int32),
        jnp.zeros(capO, jnp.int32), jnp.zeros(capO, jnp.int32),
    )
    want = jq.query_accumulate_scan_wide(
        *jstate, jnp.asarray(blocks), jnp.asarray(blk), jnp.asarray(lane0),
        jnp.asarray(mask), jnp.asarray(qc.astype(np.uint16)), jnp.int32(7),
        wpad=wpad, chunk=chunk,
    )
    b2 = ts.t32(blocks)
    got = tq.query_accumulate_scan_wide(
        *tq.new_accumulators(C, wpad, capO, "cpu"), b2,
        torch.from_numpy(blk), torch.from_numpy(lane0), torch.from_numpy(mask),
        torch.from_numpy(qc), 7, wpad=wpad, chunk=chunk,
    )
    narrow = tq.query_accumulate_scan(
        *tq.new_accumulators(C, wpad, capO, "cpu"), b2,
        torch.from_numpy(rows.astype(np.int32)), torch.from_numpy(mask),
        torch.from_numpy(qc), 7, wpad=wpad, chunk=chunk,
    )
    for name, g, w, a in zip(("stats", "hist", "over_col", "over_freq"),
                             got, want, narrow):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).view(np.int32), err_msg=name)
        assert torch.equal(g, a), name
    stats = got[0].numpy()
    assert stats[:C].sum() > 0 and stats[C + wpad + 1] > 0


@pytest.mark.parametrize("start_sample", [0, 3])
@pytest.mark.parametrize("wpad", [1, 2])
def test_readid_wide_functions_match_jax_and_narrow(wpad, start_sample):
    """query_readid_batch_wide and query_readid_firsthit_wide on 200 reads
    (k-mers in insertion order, padding at PAD_POS)."""
    blocks, C, rows, blk, lane0, rng = _case(wpad, seed=10 + wpad, n=4000, H=2)
    n = rows.shape[0]
    seg = np.sort(rng.integers(0, 200, n)).astype(np.int32)
    pos = np.zeros(n, dtype=np.int32)
    for r in range(200):
        sel = seg == r
        pos[sel] = np.arange(int(sel.sum()))
    pos[rng.random(n) < 0.05] = tq.PAD_POS
    geo = dict(num_reads=200, start_sample=start_sample, num_colors=C, wpad=wpad)
    b2 = ts.t32(blocks)
    targs = (b2, torch.from_numpy(blk), torch.from_numpy(lane0),
             torch.from_numpy(seg), torch.from_numpy(pos))
    jargs = (jnp.asarray(blocks), jnp.asarray(blk), jnp.asarray(lane0),
             jnp.asarray(seg), jnp.asarray(pos))
    narrow_args = (b2, torch.from_numpy(rows.astype(np.int32)),
                   torch.from_numpy(seg), torch.from_numpy(pos))
    for wide, jfn, narrow in (
        (tq.query_readid_batch_wide, jq.query_readid_batch_wide, tq.query_readid_batch),
        (tq.query_readid_firsthit_wide, jq.query_readid_firsthit_wide,
         tq.query_readid_firsthit),
    ):
        got = wide(*targs, **geo)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jfn(*jargs, **geo)))
        assert torch.equal(got, narrow(*narrow_args, **geo))
    report = tq.query_readid_batch_wide(*targs, **geo).numpy()
    assert report[:, :C].sum() > 0 and report[:, C].sum() > 0  # hits and no_hits


# -- the engine ------------------------------------------------------------------------


def _meta(bloom_size, W, blocked=0, R=1024):
    names = [f"g{i}" for i in range(32 * W)]
    return TIndex(bloom_size, 2, 31, 0, names, {n: 1 for n in names},
                  np.zeros((R, W), dtype=np.uint32), blocked=blocked)


def test_engine_guards_past_int32_rows():
    """A bloom_size past 2^31 over a small matrix (the guards read only the
    geometry): a blocked index and rows wider than one block refuse it; a
    classic index takes the wide route up to bloom_size * wpad < 2^38; the
    sharded engine refuses it and names the single-device wide path. The
    device-hash entries keep the JAX package's bloom_size < 2^31."""
    with pytest.raises(ValueError, match="int32 device block addressing"):
        TEngine(_meta(2**31, 1, blocked=4), device="cpu")
    with pytest.raises(ValueError, match="int32 device block addressing"):
        TEngine(_meta(2**30, 129), device="cpu")  # wpad 256: 2^31 blocks
    with pytest.raises(ValueError, match="2\\^38"):
        TEngine(_meta(2**35, 5), device="cpu")  # wpad 8
    eng = TEngine(_meta(2**35 - 1, 5), device="cpu")
    assert eng._wide and not eng._stream_classic
    eng = TEngine(_meta(3_000_000_000, 1), device="cpu")
    assert eng._wide and not eng._stream_classic and not eng._stream
    assert not TEngine(_meta(2**31 - 1, 1), device="cpu")._wide
    pk, qc = torch.zeros((1, 2), dtype=torch.int32), torch.ones(1, dtype=torch.int32)
    one = np.zeros(1, dtype=np.int32)
    mates = np.zeros((1, 5), dtype=np.uint32)
    for call in (
        lambda: eng.search_keys_dev_generic_async(pk, qc, 27),
        lambda: eng.readid_counts_packed(np.zeros((1, 2), np.uint32), one, one, 1, 0, 27),
        lambda: eng.readid_counts_reads_async(mates, one, one + 150, one, 1, 0, 27, 150),
        lambda: eng.readid_firsthit_reads_async(mates, one, one + 150, one, 1, 0, 27, 150),
    ):
        with pytest.raises(ValueError, match="bloom_size < 2\\^31"):
            call()
    with pytest.raises(ValueError, match="int32.*wide path"):
        TSharded(_meta(3_000_000_000, 1), layout="row",
                 mesh=tsh.make_mesh(1, 4, "row", devices=["cpu"]))


def test_host_rows_keep_int64_past_int32():
    """The host hashes of a wide index stay int64 (the native hasher's
    uint32 rows through 2^32, numpy's beyond), equal to the reference's
    XXH3 rows; below 2^31 they are int32."""
    from colorid_tpu_torch.hashing.xxh3 import bloom_rows_batch

    rng = np.random.default_rng(3)
    keys = rng.choice(ts.ACGT, (500, 27))
    for bloom in (3_000_000_000, 2**32 + 12345, 2**36):
        rows = host_rows(_meta(bloom, 1), keys, 0)
        assert rows.dtype == np.int64 and rows.max() >= 2**31
        np.testing.assert_array_equal(rows, bloom_rows_batch(keys, 2, bloom).astype(np.int64))
    assert host_rows(_meta(2**31 - 1, 1), keys, 0).dtype == np.int32


@pytest.fixture(scope="module")
def engines():
    """The same small classic index in both packages (65 colors: wpad 4),
    and each package's engine with its wide flag set after construction, so
    that rows_all reaches the wide routes of both."""
    rng = np.random.default_rng(21)
    R, W, C = 60_000, 3, 65
    m = rng.integers(0, 2**32, (R, W), dtype=np.uint32)
    m &= rng.integers(0, 2**32, (R, W), dtype=np.uint32)
    m &= rng.integers(0, 2**32, (R, W), dtype=np.uint32)
    m[:, 2] &= np.uint32(1)
    m[rng.integers(0, R, R // 5)] = 0
    names = [f"g{i:02d}" for i in range(C)]
    nref = {n: 1000 for n in names}
    jidx = JIndex(R, 3, 27, 0, names, nref, m)
    tidx = TIndex(R, 3, 27, 0, names, nref, m)
    jw, tw = JEngine(jidx, chunk=1 << 12), TEngine(tidx, chunk=1 << 12, device="cpu")
    jw._wide = tw._wide = True
    narrow = TEngine(tidx, chunk=1 << 12, device="cpu")
    keys = np.unique(rng.choice(ts.ACGT, (20_000, 27)), axis=0)
    qc = rng.integers(1, 3000, keys.shape[0]).astype(np.int32)
    return jw, tw, narrow, keys, qc


def test_engine_wide_search_matches_jax(engines, monkeypatch):
    jw, tw, narrow, keys, qc = engines
    calls = []
    real = tq.query_accumulate_scan

    def counted(*a, **kw):
        assert a[5].dtype == torch.int64
        calls.append(a[5].shape[0])
        return real(*a, **kw)

    import colorid_tpu_torch.engine as tengine

    monkeypatch.setattr(tengine, "query_accumulate_scan", counted)
    rows = tw.rows_for_keys(keys).astype(np.int64)
    got = tw.search_keys(None, qcounts=qc, rows_all=rows)
    monkeypatch.undo()
    assert sum(calls) == keys.shape[0]  # every k-mer's int64 rows scanned
    assert_same_result(got, jw.search_keys(None, qcounts=qc, rows_all=rows))
    assert_same_result(got, narrow.search_keys(None, qcounts=qc, rows_all=rows))
    assert_same_result(got, narrow.search_keys(keys, qcounts=qc))
    assert got.counts.sum() > 0 and len(got.over_colors) > 0 and not got.all_valid


def test_engine_wide_readid_matches_jax(engines):
    """readid_counts_arrays and readid_firsthit on 300 reads of 40 k-mers
    each through the wide routes of both packages (int64 rows in the
    port), and the port's narrow route."""
    jw, tw, narrow, keys, _qc = engines
    rng = np.random.default_rng(4)
    per_read = [keys[rng.integers(0, keys.shape[0], 40)] for _ in range(300)]
    per_read[5] = keys[:0]  # a read without k-mers
    for start_sample in (0, 3):
        got = tw.readid_counts(per_read, start_sample)
        np.testing.assert_array_equal(got, jw.readid_counts(per_read, start_sample))
        np.testing.assert_array_equal(got, narrow.readid_counts(per_read, start_sample))
        fh = tw.readid_firsthit(per_read, start_sample)
        np.testing.assert_array_equal(fh, jw.readid_firsthit(per_read, start_sample))
        np.testing.assert_array_equal(fh, narrow.readid_firsthit(per_read, start_sample))
    assert got[:, :-1].sum() > 0 and got[:, -1].sum() > 0


def test_pipelines_take_the_wide_routes(tmp_path, monkeypatch):
    """CLI search's counting, the server's /search and read_id's classifier
    on an index of 3e9 rows reach the scan and the read_id batch with int64
    rows past 2^31 through their own bloom_size gates (host hashing). The
    matrix here is small and the scan and read_id batch are recorders that
    only check what they get, so nothing is gathered."""
    from colorid_tpu_torch import serve
    from colorid_tpu_torch.pipelines.read_id import classify_batch
    from colorid_tpu_torch.pipelines.search import batch_search

    import colorid_tpu_torch.engine as tengine

    eng = TEngine(_meta(3_000_000_000, 1), device="cpu")
    got = {"scan": [], "readid": []}

    def scan(stats, hist, oc, of, blocks2, rows, mask, qc, base0, **kw):
        got["scan"].append(rows)
        return stats, hist, oc, of

    def readid(blocks2, rows, seg, pos, *, num_reads, num_colors, **kw):
        got["readid"].append(rows)
        return torch.zeros((num_reads, num_colors + 1), dtype=torch.int32)

    monkeypatch.setattr(tengine, "query_accumulate_scan", scan)
    monkeypatch.setattr(tq, "query_readid_batch", readid)
    gs = ts.genomes(2, 5_000, seed=8)
    fq = ts.write_fastq_gz(tmp_path / "q.fastq.gz", ts.reads(gs, 200, 150, seed=9))
    batch_search([fq], [], eng, filter_t=0, cov=0.35, gene_search=False, qual_offset=15)
    n_search = len(got["scan"])
    monkeypatch.setattr(serve._State, "engine", eng)
    serve._search_payload({"sequences": [g[:2000].tobytes().decode() for g in gs],
                           "filter": 0})
    n_serve = len(got["scan"]) - n_search
    pairs = ts.read_mix(gs, 30, seed=10)
    classify_batch([(f"p{i}", [np.frombuffer(p[0], np.uint8), np.frombuffer(p[2], np.uint8)])
                    for i, p in enumerate(pairs)], eng, 1, 3.0, 3)
    assert n_search > 0 and n_serve > 0 and got["readid"]
    for rows in got["scan"] + got["readid"]:
        assert rows.dtype == torch.int64 and int(rows.min()) >= 0
        assert int(rows.max()) < 3_000_000_000
    assert max(int(r.max()) for r in got["scan"]) >= 2**31
    assert max(int(r.max()) for r in got["readid"]) >= 2**31
