"""The port's logical mesh (colorid_tpu_torch/parallel/sharded.py) against
the JAX package's shard_map bodies on the 8 virtual CPU devices: shard
packing, query_batch_colorshard and query_batch_rowshard on (2,4), (1,8)
and (4,2) meshes, and `build --color-shards` through both CLIs. Integers
throughout: tolerance 0."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu.cli import main as jmain
from colorid_tpu.parallel import sharded as jsh
from colorid_tpu_torch import convert
from colorid_tpu_torch.cli import main as tmain
from colorid_tpu_torch.index.bigsi import BigsiIndex as TIndex
from colorid_tpu_torch.ops.blocked import blocked_rows_host
from colorid_tpu_torch.parallel import sharded as tsh
from tests import torch_support as ts

MESHES = [(2, 4), (1, 8), (4, 2)]
C, BLOOM, H, N = 200, 20_000, 4, 4096


@pytest.fixture(scope="module")
def case():
    """One random 200-color matrix (30 % absent rows), blocked-placed rows
    for N k-mers (all of a k-mer's rows in one 16-row group) and a mask
    with some padding."""
    rng = np.random.default_rng(11)
    bloom, matrix, _names = ts.rand_blocked_matrix(rng, C, BLOOM, 0.3, thin=4)
    keys = rng.choice(ts.ACGT, size=(N, 31))
    rows = blocked_rows_host(keys, H, bloom, 16, version=2).astype(np.int32)
    mask = rng.random(N) < 0.9
    return matrix, rows, mask


def _cpu_mesh(nd, nm, axis):
    return tsh.make_mesh(nd, nm, axis, devices=["cpu"])


def _assert_same_batch(got, want):
    for name, g, w in zip(("counts", "uniq", "valid", "and_all", "all_valid"),
                          got, want):
        w = np.asarray(w)
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("nd,nm", MESHES)
def test_query_batch_colorshard_matches_jax(case, nd, nm):
    matrix, rows, mask = case
    jmesh = jsh.make_mesh(nd, nm, "color")
    jmat, jwpad, jWl = jsh.device_put_colorshard(matrix, jmesh)
    mesh = _cpu_mesh(nd, nm, "color")
    mat, wpad, Wl = tsh.device_put_colorshard(matrix, mesh)
    assert (wpad, Wl) == (jwpad, jWl)
    # shard packing against shard packing
    for a, b in zip(mat, convert.shards_from_jax_state(np.asarray(jmat), jwpad, mesh)):
        assert torch.equal(a, b)
    # rpb > 0: the blocked single-fetch gather, on one mesh
    for rpb in (0, 128 // wpad) if (nd, nm) == (2, 4) else (0,):
        want = jsh.query_batch_colorshard(
            jmat, jnp.asarray(rows), jnp.asarray(mask),
            mesh=jmesh, wpad=jwpad, Wl=jWl, rpb=rpb,
        )
        got = tsh.query_batch_colorshard(
            mat, torch.from_numpy(rows), torch.from_numpy(mask),
            mesh=mesh, wpad=wpad, Wl=Wl, rpb=rpb,
        )
        _assert_same_batch(got, want)
    counts, uniq, valid, _aw, all_valid = got
    assert int(counts.sum()) > 0 and (uniq >= 0).any() and not bool(all_valid)
    assert 0 < int(valid.sum()) < int(mask.sum())
    assert int(uniq.max()) >= 32 * Wl  # a hit owned by a later shard


@pytest.mark.parametrize("nd,nm", MESHES)
def test_query_batch_rowshard_matches_jax(case, nd, nm):
    matrix, rows, mask = case
    W = matrix.shape[1]
    jmesh = jsh.make_mesh(nd, nm, "row")
    jmat, jwpad, jRl = jsh.device_put_rowshard(matrix, jmesh, row_multiple=128)
    mesh = _cpu_mesh(nd, nm, "row")
    mat, wpad, Rl = tsh.device_put_rowshard(matrix, mesh, row_multiple=128)
    assert (wpad, Rl) == (jwpad, jRl) and Rl % 128 == 0
    for a, b in zip(mat, convert.shards_from_jax_state(np.asarray(jmat), jwpad, mesh)):
        assert torch.equal(a, b)
    for rpb in (0, 128 // wpad) if (nd, nm) == (2, 4) else (0,):
        want = jsh.query_batch_rowshard(
            jmat, jnp.asarray(rows), jnp.asarray(mask),
            mesh=jmesh, wpad=jwpad, Rl=jRl, W=W, rpb=rpb,
        )
        got = tsh.query_batch_rowshard(
            mat, torch.from_numpy(rows), torch.from_numpy(mask),
            mesh=mesh, wpad=wpad, Rl=Rl, W=W, rpb=rpb,
        )
        _assert_same_batch(got, want)
    counts, uniq, valid, _aw, all_valid = got
    assert int(counts.sum()) > 0 and (uniq >= 0).any() and not bool(all_valid)
    assert 0 < int(valid.sum()) < int(mask.sum())


def test_all_valid_and_global_and_over_shards():
    """Every row present and color 5 set everywhere: all_valid holds and the
    global AND keeps bit 5, on both layouts (the AND merges over shards and
    data slices, and padding does not spoil it)."""
    rng = np.random.default_rng(3)
    bloom, matrix, _names = ts.rand_blocked_matrix(rng, 70, 4096, 0.0, thin=2)
    matrix[:, 0] |= np.uint32(1 << 5)
    rows = rng.integers(0, bloom, (1024, 2)).astype(np.int32)
    mask = np.arange(1024) < 1000
    for axis in ("color", "row"):
        mesh = _cpu_mesh(2, 2, axis)
        if axis == "color":
            mat, wpad, Wl = tsh.device_put_colorshard(matrix, mesh)
            out = tsh.query_batch_colorshard(
                mat, torch.from_numpy(rows), torch.from_numpy(mask),
                mesh=mesh, wpad=wpad, Wl=Wl,
            )
        else:
            mat, wpad, Rl = tsh.device_put_rowshard(matrix, mesh)
            out = tsh.query_batch_rowshard(
                mat, torch.from_numpy(rows), torch.from_numpy(mask),
                mesh=mesh, wpad=wpad, Rl=Rl, W=matrix.shape[1],
            )
        counts, _uniq, valid, and_all, all_valid = out
        assert bool(all_valid) and torch.equal(valid, torch.from_numpy(mask))
        assert int(and_all[0]) & (1 << 5) and int(counts[5]) == 1000


def test_mesh_defaults_to_the_card_and_checks_its_arguments():
    if torch.cuda.is_available():
        assert tsh.make_mesh(1, 4, "color").home.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tsh.make_mesh(1, 4, "color")
    mesh = _cpu_mesh(2, 3, "row")
    assert mesh.shape == {"data": 2, "row": 3} and mesh.home.type == "cpu"
    assert [mesh.device(m).type for m in range(3)] == ["cpu"] * 3
    with pytest.raises(ValueError, match="model_axis"):
        tsh.make_mesh(1, 2, "model", devices=["cpu"])
    with pytest.raises(ValueError, match="at least one"):
        tsh.make_mesh(0, 2, "row", devices=["cpu"])
    with pytest.raises(ValueError, match="does not split"):
        tsh.query_batch_rowshard(
            [], torch.zeros((5, 2), dtype=torch.int32), torch.zeros(5, dtype=torch.bool),
            mesh=mesh, wpad=1, Rl=128, W=1,
        )
    with pytest.raises(ValueError, match="uint32"):
        convert.shards_from_jax_state(np.zeros((2, 512, 128), np.uint32), 1, mesh)


# -- build --color-shards through both CLIs ---------------------------------------


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def shard_placed(tmp_path_factory):
    """40 small genomes (2 color words) built with --blocked --color-shards 2
    by both CLIs: the placement group follows ONE shard's word (128 rows per
    block), not the full row's two (64)."""
    d = tmp_path_factory.mktemp("colorshards")
    gs = ts.genomes(40, 4_000, seed=21)
    man, _refs = ts.write_panel(d, gs)
    fq = ts.write_fastq_gz(d / "q.fastq.gz", ts.reads(gs[:3], 600, 150, seed=22))
    build = ["build", "--blocked", "--color-shards", "2", "-k", "27", "-n", "4",
             "-s", "60000", "-r", man]
    _cli(jmain, build + ["-b", str(d / "jax")])
    _cli(tmain, build + ["-b", str(d / "torch")])
    return d, fq


def test_build_color_shards_writes_the_jax_bytes(shard_placed):
    d, _fq = shard_placed
    with open(d / "jax.bxi", "rb") as fj, open(d / "torch.bxi", "rb") as ft:
        assert fj.read() == ft.read()
    idx = TIndex.load(str(d / "torch.bxi"))
    assert (idx.blocked, idx.place_rpb, idx.words_per_row) == (4, 128, 2)
    # one shard only: the placement is the full row's, and none is recorded
    _cli(tmain, ["build", "--blocked", "--color-shards", "1", "-k", "27", "-n", "4",
                 "-s", "60000", "-r", str(d / "refs.txt"), "-b", str(d / "one")])
    assert TIndex.load(str(d / "one.bxi")).place_rpb == 0


def test_cli_search_on_a_shard_placed_index_matches_jax(shard_placed):
    d, fq = shard_placed
    search = ["search", "-b", str(d / "torch.bxi"), "-q", fq, "-f", "1"]
    want = _cli(jmain, search)
    got = _cli(tmain, search + ["--device", "cpu"])
    assert got == want
    rows = [l.split("\t") for l in got.splitlines() if "\t" in l]
    assert {r[2] for r in rows[:3]} == {"genome0", "genome1", "genome2"}
