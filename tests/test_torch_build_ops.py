"""The port's index construction on a device (colorid_tpu_torch/ops/
build_ops.py, build_index(device=...), CLI build --device-build) against the
JAX package's, on seeded row lists and synthetic genomes: the scatter-OR
column by column, the whole matrix, the index files byte for byte, the
row-sharded build and its packing on the 8 virtual CPU devices of
tests/conftest.py, and ShardedQueryEngine over a matrix born sharded
(index.matrix None). Integers throughout: tolerance 0."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu.cli import main as jmain
from colorid_tpu.index.bigsi import BigsiIndex as JIndex
from colorid_tpu.ops import build_ops as jbo
from colorid_tpu.parallel import sharded as jsh
from colorid_tpu.parallel.engine import ShardedQueryEngine as JSharded
from colorid_tpu.pipelines.build import build_index as jbuild
from colorid_tpu_torch import ShardedQueryEngine as TSharded
from colorid_tpu_torch import convert
from colorid_tpu_torch.cli import main as tmain
from colorid_tpu_torch.engine import QueryEngine as TEngine
from colorid_tpu_torch.index.bigsi import BigsiIndex as TIndex
from colorid_tpu_torch.ops import build_ops as tbo
from colorid_tpu_torch.ops.query import row_wpad
from colorid_tpu_torch.parallel import sharded as tsh
from colorid_tpu_torch.pipelines import build as tbuild_mod
from colorid_tpu_torch.pipelines.build import build_index as tbuild
from tests import torch_support as ts

R = 10_000


def _row_lists(C: int, R: int, seed: int):
    """C seeded row lists over [0, R): repeats within a list, every seventh
    list empty, the first and last row in some."""
    rng = np.random.default_rng(seed)
    out = []
    for c in range(C):
        if c % 7 == 6:
            out.append(np.zeros(0, dtype=np.int32))
            continue
        rl = rng.integers(0, R, rng.integers(1, 600)).astype(np.int32)
        rl = np.concatenate([rl, rl[: len(rl) // 3]])  # repeats
        if c % 5 == 0:
            rl = np.concatenate([rl, [0, R - 1]]).astype(np.int32)
        out.append(rng.permutation(rl))
    return out


def _host_matrix(row_lists, R):
    W = (len(row_lists) + 31) // 32
    m = np.zeros((R, W), dtype=np.uint32)
    for c, rl in enumerate(row_lists):
        m[np.asarray(rl, dtype=np.int64), c // 32] |= np.uint32(1 << (c % 32))
    return m


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


# -- the scatter-OR ------------------------------------------------------------------


@pytest.mark.parametrize("bit", [0, 7, 30, 31])
def test_scatter_or_column_matches_jax(bit):
    """One column that starts from random words, rows with repeats; the JAX
    function gets the same rows padded with its dropped index R."""
    rng = np.random.default_rng(bit)
    acc = rng.integers(0, 2**32, R, dtype=np.uint32)
    rows = rng.integers(0, R, 3000).astype(np.int32)
    rows = np.concatenate([rows, rows[:500]])
    padded = np.concatenate([rows, np.full(596, R, dtype=np.int32)])
    want = np.asarray(jbo.scatter_or_column(
        jnp.asarray(acc), jnp.asarray(padded), jnp.int32(bit)))
    got = tbo.scatter_or_column(ts.t32(acc.copy()), torch.from_numpy(rows), bit)
    np.testing.assert_array_equal(_u32(got), want)
    # in place, and only the OR of the bit
    assert not (_u32(got) & ~(acc | np.uint32(1 << bit))).any()


@pytest.mark.parametrize("C", [1, 31, 32, 33, 64, 70])
def test_build_matrix_device_matches_jax(C):
    """1-70 colors (W up to 3, bit 31 of each full word set), repeats and
    empty row lists, on the CPU against the JAX build and the host one."""
    row_lists = _row_lists(C, R, seed=C)
    got = tbo.build_matrix_device(row_lists, R, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (R, (C + 31) // 32)
    want = np.asarray(jbo.build_matrix_device(row_lists, R, pad_to=1024))
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(want, _host_matrix(row_lists, R))
    if C >= 32:
        assert (want[:, 0] >> 31).any()


def test_rows_outside_the_matrix_are_refused():
    for bad in ([0, R], [-1, 3]):
        with pytest.raises(ValueError, match="Bloom rows"):
            tbo.build_matrix_device([np.array(bad)], R, device="cpu")
    mesh = tsh.make_mesh(1, 4, "row", devices=["cpu"])
    with pytest.raises(ValueError, match="Bloom rows"):
        tbo.build_matrix_rowshard([np.array([R])], R, mesh, row_multiple=1)
    with pytest.raises(ValueError, match="row mesh"):
        tbo.build_matrix_rowshard([np.array([1])], R,
                                  tsh.make_mesh(1, 4, "color", devices=["cpu"]),
                                  row_multiple=1)


# -- build_index and the CLI ---------------------------------------------------------


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    d = tmp_path_factory.mktemp("devbuild")
    gs = ts.genomes(35, 6_000, seed=31)  # 35 colors: two words, bit 31 set
    man, refs = ts.write_panel(d, gs)
    return d, man, refs


@pytest.mark.parametrize("blocked", [False, True])
def test_build_index_device_matches_jax_and_host(panel, blocked, monkeypatch):
    _d, _man, refs = panel
    args = (refs, 60_000, 3, 21)
    kw = dict(verbose=False, blocked=blocked)
    want = jbuild(*args, device=True, **kw)
    calls = []
    real = tbo.scatter_or_column

    def counted(acc, rows, bit):
        calls.append(bit)
        return real(acc, rows, bit)

    monkeypatch.setattr(tbo, "scatter_or_column", counted)
    got = tbuild(*args, device="cpu", **kw)
    monkeypatch.undo()
    assert calls == [c % 32 for c in range(len(refs))]  # one per accession
    host = tbuild(*args, **kw)
    np.testing.assert_array_equal(got.matrix, np.asarray(want.matrix))
    np.testing.assert_array_equal(got.matrix, host.matrix)
    assert got.matrix.dtype == np.uint32 and (got.matrix[:, 0] >> 31).any()
    assert got.n_ref_kmers == want.n_ref_kmers == host.n_ref_kmers
    assert (got.bloom_size, got.blocked) == (want.bloom_size, want.blocked)


def test_device_build_with_threads_checkpoints_and_color_shards(panel, tmp_path, monkeypatch):
    """--threads, --checkpoint (a resumed build counts nothing) and
    --blocked --color-shards give the host build's matrix."""
    _d, _man, refs = panel
    args = (refs, 50_000, 2, 21)
    host = tbuild(*args, verbose=False, blocked=True, color_shards=2)
    ck = str(tmp_path / "ck")
    got = tbuild(*args, verbose=False, blocked=True, color_shards=2,
                 device="cpu", threads=3, checkpoint_dir=ck)
    np.testing.assert_array_equal(got.matrix, host.matrix)
    assert got.place_rpb == host.place_rpb > 0

    def boom(*a, **k):
        raise AssertionError("re-counted despite checkpoint")

    monkeypatch.setattr(tbuild_mod, "accession_kmers", boom)
    again = tbuild(*args, verbose=False, blocked=True, color_shards=2,
                   device="cpu", checkpoint_dir=ck)
    np.testing.assert_array_equal(again.matrix, host.matrix)
    assert again.n_ref_kmers == host.n_ref_kmers


def test_device_build_asks_for_the_card_before_counting(panel, monkeypatch):
    """device=True means the card: without one it raises at once, and it
    never quietly builds on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the build would run on it")
    _d, _man, refs = panel

    def boom(*a, **k):
        raise AssertionError("counted before the device was resolved")

    monkeypatch.setattr(tbuild_mod, "accession_kmers", boom)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tbuild(refs, 50_000, 2, 21, verbose=False, device=True)


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("blocked", [False, True])
def test_cli_device_build_writes_the_jax_bytes(panel, blocked):
    d, man, _refs = panel
    name = "blocked" if blocked else "classic"
    build = ["build", "-k", "21", "-n", "3", "-s", "70000", "-r", man, "-t", "2"]
    build += ["--blocked"] if blocked else []
    jout = _cli(jmain, build + ["--device-build", "-b", str(d / f"jax_{name}")])
    tout = _cli(tmain, build + ["--device-build", "--device", "cpu",
                                "-b", str(d / f"torch_{name}")])
    _cli(tmain, build + ["-b", str(d / f"host_{name}")])
    assert tout.replace("torch_", "jax_") == jout
    with open(d / f"jax_{name}.bxi", "rb") as f:
        want = f.read()
    for who in ("torch", "host"):
        with open(d / f"{who}_{name}.bxi", "rb") as f:
            assert f.read() == want, who


# -- the row-sharded build -----------------------------------------------------------

BLOOM_RS, C_RS = 5000, 40


@pytest.fixture(scope="module")
def rs_lists():
    return _row_lists(C_RS, BLOOM_RS, seed=11)


@pytest.mark.parametrize("nd,nr", [(1, 8), (2, 4)])
def test_rowshard_build_and_pack_match_jax(rs_lists, nd, nr):
    jmesh = jsh.make_mesh(nd, nr, "row")
    jmat, jRl = jbo.build_matrix_rowshard(rs_lists, BLOOM_RS, jmesh, pad_to=1024)
    mesh = tsh.make_mesh(nd, nr, "row", devices=["cpu"])
    shards, Rl = tbo.build_matrix_rowshard(rs_lists, BLOOM_RS, mesh, row_multiple=1)
    assert Rl == jRl and len(shards) == nr
    np.testing.assert_array_equal(
        np.concatenate([_u32(s) for s in shards]), np.asarray(jmat))
    host = _host_matrix(rs_lists, BLOOM_RS)
    np.testing.assert_array_equal(np.concatenate([_u32(s) for s in shards])[:BLOOM_RS], host)
    W = host.shape[1]
    blocks = tbo.pack_blocks_rowshard(shards, mesh=mesh, Rl=Rl, W=W)
    jblocks = np.asarray(jbo.pack_blocks_rowshard(jmat, mesh=jmesh, Rl=jRl, W=W))
    ref, wpad, Rl2 = tsh.device_put_rowshard(host, mesh)
    assert Rl2 == Rl and wpad == row_wpad(W)
    for r in range(nr):
        np.testing.assert_array_equal(_u32(blocks[r]), jblocks[r])
        assert torch.equal(blocks[r], ref[r])


@pytest.mark.parametrize("mult", [128, 16384])
def test_rowshard_build_with_a_row_multiple_matches_device_put(rs_lists, mult):
    """Rows per shard rounded as the sharded engine needs them: the same
    shards as device_put_rowshard of the host matrix (the JAX build has no
    rounding)."""
    mesh = tsh.make_mesh(1, 4, "row", devices=["cpu"])
    shards, Rl = tbo.build_matrix_rowshard(rs_lists, BLOOM_RS, mesh, row_multiple=mult)
    assert Rl % mult == 0 and Rl * 4 >= BLOOM_RS
    host = _host_matrix(rs_lists, BLOOM_RS)
    blocks = tbo.pack_blocks_rowshard(shards, mesh=mesh, Rl=Rl, W=host.shape[1])
    ref, _wpad, Rl2 = tsh.device_put_rowshard(host, mesh, row_multiple=mult)
    assert Rl2 == Rl
    for a, b in zip(blocks, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shards"):
        tbo.pack_blocks_rowshard(shards[:3], mesh=mesh, Rl=Rl, W=host.shape[1])


# -- ShardedQueryEngine over a born-sharded matrix -----------------------------------


def _same_answers(a, b):
    np.testing.assert_array_equal(a.counts, b.counts)
    assert a.all_valid == b.all_valid
    np.testing.assert_array_equal(a.and_all, b.and_all)
    assert a.freq_stats() == b.freq_stats()


def _columns(matrix, C):
    return [np.nonzero((matrix[:, c // 32] >> np.uint32(c % 32)) & 1)[0] for c in range(C)]


def _queries(n, k, seed):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.choice(ts.ACGT, (n, k)), axis=0)
    qc = rng.integers(1, 2000, keys.shape[0]).astype(np.int32)
    return keys, qc


def test_born_sharded_classic_engine_matches_host_and_jax():
    """A classic 40-color index (W 2) on (1, 8) and (2, 4) row meshes: the
    port's engine over build_matrix_rowshard's packed shards, with no host
    matrix, against the host-matrix row engine, the single-device engine
    and the JAX engine over its own born-sharded matrix."""
    rng = np.random.default_rng(5)
    C, H, K = 40, 3, 21
    matrix = rng.integers(0, 2**32, (BLOOM_RS, 2), dtype=np.uint32)
    matrix &= rng.integers(0, 2**32, (BLOOM_RS, 2), dtype=np.uint32)
    matrix[:, 1] &= np.uint32((1 << 8) - 1)
    matrix[rng.integers(0, BLOOM_RS, 1000)] = 0
    names = [f"g{i}" for i in range(C)]
    nref = {n: 100 for n in names}
    full = TIndex(BLOOM_RS, H, K, 0, names, nref, matrix)
    meta = TIndex(BLOOM_RS, H, K, 0, names, nref, None)
    keys, qc = _queries(1500, K, seed=6)
    single = TEngine(full, device="cpu").search_keys(keys, qcounts=qc)
    row_lists = _columns(matrix, C)
    for nd, nr in [(1, 8), (2, 4)]:
        mesh = tsh.make_mesh(nd, nr, "row", devices=["cpu"])
        assert TSharded.row_multiple(meta) == 1
        shards, Rl = tbo.build_matrix_rowshard(
            row_lists, BLOOM_RS, mesh, row_multiple=TSharded.row_multiple(meta))
        blocks = tbo.pack_blocks_rowshard(shards, mesh=mesh, Rl=Rl, W=2)
        eng = TSharded(meta, mesh=mesh, layout="row", chunk=1024,
                       sharded_matrix=(blocks, row_wpad(2), Rl))
        host = TSharded(full, mesh=mesh, layout="row", chunk=1024)
        assert (eng.rpb, eng._stream) == (host.rpb, host._stream) == (0, False)
        got = eng.search_keys(keys, qcounts=qc)
        _same_answers(got, host.search_keys(keys, qcounts=qc))
        _same_answers(got, single)
        jmesh = jsh.make_mesh(nd, nr, "row")
        jmat, jRl = jbo.build_matrix_rowshard(row_lists, BLOOM_RS, jmesh, pad_to=1024)
        jblocks = jbo.pack_blocks_rowshard(jmat, mesh=jmesh, Rl=jRl, W=2)
        jmeta = JIndex(BLOOM_RS, H, K, 0, names, nref, None)
        jeng = JSharded(jmeta, mesh=jmesh, layout="row", n_data=nd, chunk=1024,
                        sharded_matrix=(jblocks, row_wpad(2), jRl))
        _same_answers(got, jeng.search_keys(keys, qcounts=qc))
    assert single.counts.sum() > 0 and not single.all_valid


def test_born_sharded_v4_engine_streams_per_row_shard(monkeypatch):
    """A seeded 21-color v4 index of 131,072 rows on a (1, 4) row mesh:
    built with the engine's row multiple, the born-sharded engine takes the
    probe stream per row shard as the host-matrix engine does, with the
    same SearchResult; the JAX engine over its born-sharded matrix (generic
    gather there) gives the same answers."""
    rng = np.random.default_rng(17)
    R, C, H, K = 131_072, 21, 4, 31
    _bloom, matrix, names = ts.rand_blocked_matrix(rng, C, R, 0.0, thin=3)
    matrix |= np.uint32(0b1)
    nref = {n: 1000 for n in names}
    full = convert.index_from_arrays(matrix, bloom_size=R, num_hash=H, k_size=K,
                                     colors=names, n_ref_kmers=nref, blocked=4)
    meta = TIndex(R, H, K, 0, names, nref, None, blocked=4)
    mesh = tsh.make_mesh(1, 4, "row", devices=["cpu"])
    mult = TSharded.row_multiple(meta)
    assert mult == TSharded.row_multiple(full) == 128 * 128
    row_lists = _columns(matrix, C)
    shards, Rl = tbo.build_matrix_rowshard(row_lists, R, mesh, row_multiple=mult)
    blocks = tbo.pack_blocks_rowshard(shards, mesh=mesh, Rl=Rl, W=1)
    eng = TSharded(meta, mesh=mesh, layout="row", sharded_matrix=(blocks, 1, Rl))
    host = TSharded(full, mesh=mesh, layout="row")
    assert eng._stream and (eng.rpb, eng.Rl) == (host.rpb, host.Rl) == (128, Rl)
    for a, b in zip(eng.mat, host.mat):
        assert torch.equal(a, b)
    keys, qc = _queries(8000, K, seed=2)
    calls = []
    real = tsh.stream_batch_rowshard

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tsh, "stream_batch_rowshard", counted)
    got = eng._try_stream_keys(keys, qc)
    assert got is not None and calls == [1]
    from tests.test_torch_engine import assert_same_result

    assert_same_result(got, host._try_stream_keys(keys, qc))
    _same_answers(got, eng.search_keys(keys, qcounts=qc))
    _same_answers(got, TEngine(full, device="cpu").search_keys(keys, qcounts=qc))
    jmesh = jsh.make_mesh(1, 4, "row")
    jmat, jRl = jbo.build_matrix_rowshard(row_lists, R, jmesh, pad_to=1024)
    jblocks = jbo.pack_blocks_rowshard(jmat, mesh=jmesh, Rl=jRl, W=1)
    jmeta = JIndex(R, H, K, 0, names, nref, None, blocked=4)
    jeng = JSharded(jmeta, mesh=jmesh, layout="row", sharded_matrix=(jblocks, 1, jRl))
    _same_answers(got, jeng.search_keys(keys, qcounts=qc))
    assert got.freq_stats() and got.counts.sum() > 0


def test_born_sharded_engine_checks_its_matrix():
    names = [f"g{i}" for i in range(21)]
    meta = TIndex(100_096, 4, 31, 0, names, {n: 1 for n in names}, None, blocked=4)
    mesh = tsh.make_mesh(1, 4, "row", devices=["cpu"])
    shards, Rl = tbo.build_matrix_rowshard([np.array([5])] * 21, 100_096, mesh,
                                         row_multiple=1)
    blocks = tbo.pack_blocks_rowshard(shards, mesh=mesh, Rl=Rl, W=1)
    with pytest.raises(ValueError, match="multiple of 16384"):
        TSharded(meta, mesh=mesh, layout="row", sharded_matrix=(blocks, 1, Rl))
    with pytest.raises(ValueError, match="layout='row'"):
        TSharded(meta, mesh=tsh.make_mesh(1, 4, "color", devices=["cpu"]),
                 layout="color", sharded_matrix=(blocks, 1, Rl))
