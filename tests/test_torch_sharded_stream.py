"""The port's ShardedQueryEngine (colorid_tpu_torch/parallel/engine.py) and
its two sharded streams against the JAX package's on the 8 virtual CPU
devices, and against the port's own single-device QueryEngine on the same
index. Color layout: the cases of tests/test_stream_colorshard.py (a
4096-color shard-placed index; the raw probe kernel's plain twin runs per
color shard). Row layout: a seeded v4 index on (2,4) and (1,8) meshes.
Integers throughout: tolerance 0."""

import numpy as np
import pytest
import torch

from colorid_tpu.index.bigsi import BigsiIndex as JIndex
from colorid_tpu.parallel import sharded as jsh
from colorid_tpu.parallel.engine import ShardedQueryEngine as JSharded
from colorid_tpu_torch import ShardedQueryEngine as TSharded
from colorid_tpu_torch import convert
from colorid_tpu_torch.engine import QueryEngine as TEngine
from colorid_tpu_torch.ops.blocked import pack_keys_u64, rows_per_block, v3_block_offsets
from colorid_tpu_torch.ops.query import FREQ_CAP, row_wpad
from colorid_tpu_torch.parallel import sharded as tsh
from tests import torch_support as ts
from tests.test_torch_engine import assert_same_result

K = 31


def _pair(matrix, R, num_hash, place_rpb=0):
    C = matrix.shape[1] * 32
    colors = [f"c{i}" for i in range(C)]
    n_ref = {c: 1000 for c in colors}
    j = JIndex(R, num_hash, K, 0, colors, n_ref, matrix, blocked=4, place_rpb=place_rpb)
    t = convert.index_from_arrays(
        matrix, bloom_size=R, num_hash=num_hash, k_size=K, colors=colors,
        n_ref_kmers=n_ref, blocked=4, place_rpb=place_rpb,
    )
    return j, t


def _mk_pair(C, R, num_hash, n_shards, seed=0):
    """A shard-placed index as `build --color-shards n_shards` lays it out,
    for both packages: a quarter of the words nonzero with about 4 bits
    each (an AND over the hashes leaves single hits), 5 % of the rows
    absent."""
    rng = np.random.default_rng(seed)
    W = (C + 31) // 32
    place = rows_per_block(row_wpad(-(-W // n_shards)))
    word = rng.integers(0, 2**32, (3, R, W), dtype=np.uint32)
    matrix = np.where(rng.random((R, W)) < 0.25, word[0] & word[1] & word[2],
                      np.uint32(0))
    matrix[rng.integers(0, R, R // 20)] = 0
    return _pair(matrix, R, num_hash, place)


def _mk_keys(n, seed=1):
    rng = np.random.default_rng(seed)
    keys = rng.choice(ts.ACGT, (n, K))
    qc = rng.integers(1, 60, n).astype(np.int32)
    big = rng.random(n) < 0.02
    qc[big] = rng.integers(1024, 50_000, int(big.sum()))
    return keys, qc


def _same_answers(a, b):
    np.testing.assert_array_equal(a.counts, b.counts)
    assert a.all_valid == b.all_valid
    np.testing.assert_array_equal(a.and_all, b.and_all)
    assert a.freq_stats() == b.freq_stats()


def _record(monkeypatch, name):
    """Wrap the JAX package's sharded.<name> so that a test sees what the
    JAX engine handed it and what came back."""
    calls = []
    fn = getattr(jsh, name)

    def recorded(*a, **kw):
        out = fn(*a, **kw)
        calls.append((a, kw, out))
        return out

    monkeypatch.setattr(jsh, name, recorded)
    return calls


def _u2i(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _cpu_mesh(nd, nm, axis):
    return tsh.make_mesh(nd, nm, axis, devices=["cpu"])


# -- color layout -------------------------------------------------------------------


def _check_colorshard_call(call, teng):
    """The port's stream_batch_colorshard on the JAX call's own arguments:
    every output, field by field. Returns the port's outputs and whether
    the histograms agreed as they are (see below)."""
    (jmat, _planes, blk, offp, qc), kw, want = call
    kw = {k: v for k, v in kw.items() if k != "mesh"}
    probes = [ts.t32(np.array(x)) for x in (blk, offp, qc)]
    got = tsh.stream_batch_colorshard(teng.mat, *probes, mesh=teng.mesh, **kw)
    S, nd = teng.mesh.n_model, teng.mesh.n_data
    Cl, cp, cap = kw["Cl"], kw["cp"], kw["cap"]
    counts32, and_b, ok, hist, ndrop, n_over, oc, of = (_u2i(w) for w in want)
    np.testing.assert_array_equal(got[0].numpy(), counts32.reshape(S, -1)[:, :Cl])
    np.testing.assert_array_equal(got[1].numpy(), and_b.reshape(S, -1))
    assert int(got[2]) == int(ok) and int(got[4]) == int(ndrop)
    # row Cl of the JAX histogram collects the probes that are no one's
    # unique hit (the engine slices it away); the port leaves it empty
    jhist = hist.reshape(S, cp, FREQ_CAP)[:, :Cl]
    assert not got[3][:, Cl:].any()
    hist_same = np.array_equal(got[3].numpy()[:, :Cl], jhist)
    if nd == 1:
        assert hist_same
    else:
        # the JAX body never sums the histogram over the data axis: what
        # comes back is the first data slice's alone. The port sums it (and
        # so equals the single-device engine); its first slice is the JAX
        # package's whole answer.
        assert not hist_same
        first = tsh.stream_batch_colorshard(
            teng.mat, *(p[: p.shape[0] // nd] for p in probes),
            mesh=_cpu_mesh(1, S, "color"), **kw,
        )
        np.testing.assert_array_equal(first[3].numpy()[:, :Cl], jhist)
    np.testing.assert_array_equal(got[5].numpy(), n_over.reshape(nd, S))
    np.testing.assert_array_equal(got[6].numpy(), oc.reshape(nd, S, cap))
    np.testing.assert_array_equal(got[7].numpy(), of.reshape(nd, S, cap))
    return got, hist_same


@pytest.mark.parametrize(
    "num_hash,n_data,n_shards",
    [
        (2, 1, 4),  # 4096 colors on a (1, 4) mesh: 1024-color shards, wpad 32
        (2, 2, 4),  # data x color
        (4, 1, 8),  # H = 4 needs 512-color shards (split-lane group >= 2)
    ],
)
def test_colorshard_stream_matches_jax_and_single_device(
    monkeypatch, num_hash, n_data, n_shards
):
    C, R = 4096, 32768
    jindex, tindex = _mk_pair(C, R, num_hash, n_shards)
    keys, qc = _mk_keys(14_000)
    single = TEngine(tindex, chunk=1 << 14, device="cpu")
    assert single._custom_place and not single._stream and single.rpb == 0
    ref = single.search_keys(keys, qcounts=qc)

    calls = _record(monkeypatch, "stream_batch_colorshard")
    jeng = JSharded(jindex, mesh=jsh.make_mesh(n_data, n_shards, "color"), layout="color")
    want = jeng._try_stream_keys(keys, qc)
    assert want is not None and len(calls) == 1

    teng = TSharded(tindex, mesh=_cpu_mesh(n_data, n_shards, "color"), layout="color")
    assert teng._stream and (teng.wpad, teng.Wl, teng.rpb) == (jeng.wpad, jeng.Wl, jeng.rpb)
    got = teng._try_stream_keys(keys, qc)
    assert got is not None, "the stream fell back"
    out, hist_same = _check_colorshard_call(calls[0], teng)
    if num_hash == 2:  # frequencies >= FREQ_CAP reach the overflow lists
        assert int(out[5].sum()) > 0
    if hist_same:
        assert_same_result(got, want)
    else:  # n_data > 1: the JAX histogram is one data slice's, see above
        got_but_hist = type(got)(**{**vars(got), "freq_hist": want.freq_hist})
        assert_same_result(got_but_hist, want)
        assert got.freq_hist.sum() > want.freq_hist.sum()
    _same_answers(got, ref)
    assert len(ref.freq_stats()) > 10 and ref.counts.sum() > 0
    if (n_data, n_shards) == (1, 4):
        # the public entry takes the stream and agrees too
        _same_answers(teng.search_keys(keys, qcounts=qc), ref)


def test_colorshard_stream_sparse_residuals(monkeypatch):
    """A sparse probe batch leaves out-of-window probes in most chunks; the
    chunk-granular raw residual patch keeps the results exact."""
    C, R = 4096, 131072
    jindex, tindex = _mk_pair(C, R, 2, 4, seed=3)
    keys, qc = _mk_keys(4_000, seed=4)
    ref = TEngine(tindex, chunk=1 << 14, device="cpu").search_keys(keys, qcounts=qc)
    calls = _record(monkeypatch, "stream_batch_colorshard")
    want = JSharded(jindex, mesh=jsh.make_mesh(1, 4, "color"))._try_stream_keys(keys, qc)
    teng = TSharded(tindex, mesh=_cpu_mesh(1, 4, "color"))
    got = teng._try_stream_keys(keys, qc)
    assert want is not None and got is not None
    assert _check_colorshard_call(calls[0], teng)[1]
    assert_same_result(got, want)
    _same_answers(got, ref)
    # most probes lie outside their chunk's 256-block window
    blk, _ = v3_block_offsets(pack_keys_u64(keys), K, 2, R, teng.rpb, version=4)
    blk_s = np.sort(blk)
    first = np.repeat(blk_s[:: 2048], 2048)[: blk_s.shape[0]]
    assert (blk_s - first // 128 * 128 >= 256).mean() > 0.5


def test_colorshard_drops_fall_back_to_the_generic_path(monkeypatch):
    """More residual chunks than the capacity: n_drop > 0, the stream
    answers None and search_keys reruns generically, with the same answers."""
    from colorid_tpu_torch.ops import stream_query as tsq

    monkeypatch.setattr(tsq, "_nch", lambda wpad: 1)
    _jindex, tindex = _mk_pair(2048, 65536, 2, 2, seed=8)
    keys, qc = _mk_keys(5_000, seed=9)
    teng = TSharded(tindex, mesh=_cpu_mesh(1, 2, "color"))
    assert teng._stream and teng._try_stream_keys(keys, qc) is None
    ref = TEngine(tindex, chunk=1 << 14, device="cpu").search_keys(keys, qcounts=qc)
    _same_answers(teng.search_keys(keys, qcounts=qc), ref)


def test_colorshard_generic_matches_jax(monkeypatch):
    """COLORID_STREAM=0: the generic sharded path on a shard-placed index
    (placement-aware row hashing in _rows), on a (2, 2) mesh."""
    C, R = 2048, 32768
    jindex, tindex = _mk_pair(C, R, 2, 2, seed=5)
    keys, qc = _mk_keys(12_000, seed=6)
    ref = TEngine(tindex, chunk=1 << 14, device="cpu").search_keys(keys, qcounts=qc)
    monkeypatch.setenv("COLORID_STREAM", "0")
    want = JSharded(jindex, mesh=jsh.make_mesh(2, 2, "color")).search_keys(keys, qcounts=qc)
    teng = TSharded(tindex, mesh=_cpu_mesh(2, 2, "color"))
    assert teng._try_stream_keys(keys, qc) is None
    got = teng.search_keys(keys, qcounts=qc)
    assert_same_result(got, want)
    _same_answers(got, ref)
    assert len(got.over_colors) > 0 and len(got.freq_stats()) > 100


def test_colorshard_mesh_must_match_the_placement():
    """An index placed for 4 shards streams on 4 color shards only; any
    other mesh takes the generic path and still answers right."""
    _jindex, tindex = _mk_pair(4096, 32768, 2, 4, seed=12)
    keys, qc = _mk_keys(3_000, seed=13)
    ref = TEngine(tindex, chunk=1 << 14, device="cpu").search_keys(keys, qcounts=qc)
    for nm, streams in ((4, True), (2, False), (8, False)):
        teng = TSharded(tindex, mesh=_cpu_mesh(1, nm, "color"))
        assert teng._stream == streams
        _same_answers(teng.search_keys(keys, qcounts=qc), ref)
    with pytest.raises(ValueError, match="model axis"):
        TSharded(tindex, mesh=_cpu_mesh(1, 4, "row"), layout="color")


# -- row layout ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def v4_pair():
    """A seeded 21-color v4 index of 750,080 rows (wpad 1: 128 rows per
    block; 8 row shards of 768 blocks) in which every row is present, bit 0
    is set everywhere and bit 3 in the first half only, so that the
    and-words of the row shards differ and the k-mers of the second half
    are mostly unique hits."""
    rng = np.random.default_rng(17)
    R = 750_080
    _bloom, matrix, _names = ts.rand_blocked_matrix(rng, 21, R, 0.0, thin=3)
    matrix = matrix[:R]
    matrix |= np.uint32(0b1)
    matrix[: R // 2] |= np.uint32(0b1000)
    return _pair(matrix, R, 4)


def _row_query(n=30_000, seed=2):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.choice(ts.ACGT, (n, K)), axis=0)
    qc = rng.integers(1, 2000, keys.shape[0]).astype(np.int32)
    return keys, qc


@pytest.mark.parametrize("nd,nr", [(2, 4), (1, 8)])
def test_rowshard_stream_matches_jax_and_single_device(monkeypatch, v4_pair, nd, nr):
    jindex, tindex = v4_pair
    keys, qc = _row_query()
    monkeypatch.setenv("COLORID_STREAM", "0")
    ref = TEngine(tindex, device="cpu").search_keys(keys, qcounts=qc)
    monkeypatch.delenv("COLORID_STREAM")

    calls = _record(monkeypatch, "stream_batch_rowshard")
    jeng = JSharded(jindex, mesh=jsh.make_mesh(nd, nr, "row"), layout="row", n_data=nd)
    want = jeng.search_keys(keys, qcounts=qc)
    assert len(calls) == 1, "the JAX engine did not stream"

    teng = TSharded(tindex, mesh=_cpu_mesh(nd, nr, "row"), layout="row")
    assert teng._stream and (teng.wpad, teng.Rl, teng.rpb) == (jeng.wpad, jeng.Rl, jeng.rpb)
    for a, b in zip(teng.mat, convert.shards_from_jax_state(
            np.asarray(jeng.mat), jeng.wpad, teng.mesh)):
        assert torch.equal(a, b)
    got = teng._try_stream_keys(keys, qc)
    assert got is not None, "the stream fell back"
    assert_same_result(got, want)
    _same_answers(got, ref)
    assert ref.all_valid and int(ref.and_all[0]) == 0b1 and len(ref.over_colors) > 0
    assert ref.freq_stats()[0][2] > 10_000  # the second half's unique hits

    # stream_batch_rowshard on the JAX call's own arguments, field by field
    (_jm, _planes, blk, offp, q3), kw, jout = calls[0]
    kw = {k: v for k, v in kw.items() if k != "mesh"}
    out = tsh.stream_batch_rowshard(
        teng.mat, *(ts.t32(np.array(x)) for x in (blk, offp, q3)),
        mesh=teng.mesh, **kw,
    )
    for name, g, w in zip(
        ("counts", "and", "ok", "hist", "n_drop", "n_over", "oc", "of"), out, jout
    ):
        np.testing.assert_array_equal(g.numpy(), _u2i(w), err_msg=name)

    # the shards' and-words differ: the k-mers of the first half alone keep
    # bit 3, which the merge over all shards drops
    blk_all, _ = v3_block_offsets(
        pack_keys_u64(keys), K, 4, tindex.bloom_size, teng.rpb, version=4
    )
    first = blk_all < (tindex.bloom_size // 2) // teng.rpb
    half = teng._try_stream_keys(keys[first], qc[first])
    assert half is not None and int(half.and_all[0]) == 0b1001


def test_rowshard_stream_disabled_env(monkeypatch, v4_pair):
    """COLORID_STREAM=0 routes the sharded engine to the generic row-sharded
    path, with identical results (the rerun taken when a stream drops)."""
    jindex, tindex = v4_pair
    keys, qc = _row_query(n=6000, seed=9)
    teng = TSharded(tindex, mesh=_cpu_mesh(2, 4, "row"), layout="row")
    got_s = teng.search_keys(keys, qcounts=qc)
    monkeypatch.setenv("COLORID_STREAM", "0")
    assert teng._try_stream_keys(keys, qc) is None
    got_g = teng.search_keys(keys, qcounts=qc)
    _same_answers(got_s, got_g)
    want = JSharded(jindex, mesh=jsh.make_mesh(2, 4, "row"), layout="row", n_data=2) \
        .search_keys(keys, qcounts=qc)
    assert_same_result(got_g, want)


def test_sharded_engine_defaults_to_the_card():
    _jindex, tindex = _mk_pair(64, 1024, 2, 1, seed=1)
    if torch.cuda.is_available():
        assert TSharded(tindex).mesh.home.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TSharded(tindex)
    eng = TSharded(tindex, device="cpu", n_data=1)
    assert eng.mesh.shape == {"data": 1, "color": 1} and eng.mat[0].device.type == "cpu"
    res = eng.search_keys(np.zeros((0, K), dtype=np.uint8))
    assert res.all_valid and res.counts.shape == (64,)
