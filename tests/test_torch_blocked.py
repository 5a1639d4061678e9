"""Blocked ("turbo") layouts in the port against the JAX package: the
placement on the host (ops/blocked.py) and on the device
(ops/hash_torch.py), the blocked gather, the generic engine path on a
blocked index, and the CLI (build --blocked, search, info). Integers and
bytes throughout: tolerance 0."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu.cli import main as jmain
from colorid_tpu.engine import QueryEngine as JEngine
from colorid_tpu.index.bigsi import BigsiIndex as JIndex
from colorid_tpu.ops import blocked as jblocked
from colorid_tpu.ops import query as jquery
from colorid_tpu_torch import convert, native
from colorid_tpu_torch.cli import main as tmain
from colorid_tpu_torch.engine import QueryEngine as TEngine
from colorid_tpu_torch.hashing.xxh3 import xxh3_64_batch
from colorid_tpu_torch.index.bigsi import BigsiIndex as TIndex
from colorid_tpu_torch.ops import blocked as tblocked
from colorid_tpu_torch.ops import query as tquery
from colorid_tpu_torch.ops.hash_torch import device_blkoff, device_rows, pack_keys_host
from colorid_tpu_torch.pipelines.build import build_index as tbuild
from tests import torch_support as ts
from tests.test_torch_engine import assert_same_result


# -- placement -----------------------------------------------------------------


@pytest.mark.parametrize("version", [1, 2, 3, 4])
@pytest.mark.parametrize("num_hash,rpb,k", [(4, 128, 31), (2, 8, 27), (1, 4, 32), (4, 32, 13)])
def test_blocked_rows_host_matches_jax(version, num_hash, rpb, k):
    rng = np.random.default_rng(version * 10 + num_hash)
    keys = rng.choice(ts.ACGT, size=(3000, k))
    bloom = rpb * 7919
    want = jblocked.blocked_rows_host(keys, num_hash, bloom, rpb, version=version)
    got = tblocked.blocked_rows_host(keys, num_hash, bloom, rpb, version=version)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    # all rows of a k-mer share a block, and the device placement agrees
    assert ((got // rpb) == (got[:, :1] // rpb)).all()
    dev = device_rows(
        ts.t32(pack_keys_host(keys)), k=k, num_hash=num_hash, bloom_size=bloom,
        rpb=rpb, version=version,
    )
    np.testing.assert_array_equal(dev.numpy(), want)


def test_geometry_helpers_match_jax():
    for wpad in (1, 2, 4, 8, 16, 32, 64, 128):
        assert tblocked.rows_per_block(wpad) == jblocked.rows_per_block(wpad)
        for num_hash in (1, 2, 3, 4, 8):
            assert tblocked.v2_supported(wpad, num_hash) == jblocked.v2_supported(wpad, num_hash)
            for k in (3, 4, 31, 32, 33):
                assert tblocked.v3_supported(wpad, num_hash, k) == jblocked.v3_supported(wpad, num_hash, k)
    for s in (1, 127, 128, 129, 50_000_000):
        assert tblocked.pad_bloom_size(s) == jblocked.pad_bloom_size(s)


def test_raw_hashes_native_matches_numpy():
    rng = np.random.default_rng(2)
    keys = rng.choice(ts.ACGT, size=(500, 31))
    want = np.stack([xxh3_64_batch(keys, seed=i) for i in range(4)], axis=1)
    np.testing.assert_array_equal(tblocked._raw_hashes(keys, 4), want)
    if native.available():
        got = native.xxh3_hash64(keys, 4)
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("version", [3, 4])
@pytest.mark.parametrize("k", [31, 32, 16])
def test_value_placement_on_device_matches_numpy_on_a_million(version, k):
    """The int64-carried limb arithmetic (fmix64, the 128-bit square and
    product) against numpy uint64 on 10^6 values, the extremes and values
    whose complement squares carry."""
    rng = np.random.default_rng(100 * version + k)
    top = 4**k - 1
    vals = rng.integers(0, top, 1_000_000, dtype=np.uint64, endpoint=True)
    edge = [0, 1, 2, 3, top, top - 1, top >> 1, (top >> 1) + 1, 2**32 - 1,
            2**32, 2**32 + 1, 2**31, 2**62 - 1, 2**62 - 2**31, 0x5555555555555555,
            0x00000000FFFFFFFF, 0xFFFFFFFF00000000]
    edge = [e & top for e in edge]
    edge += [(~e) & top for e in edge]
    vals[: len(edge)] = edge
    packed = np.stack(
        [(vals & np.uint64(0xFFFFFFFF)).astype(np.uint32),
         (vals >> np.uint64(32)).astype(np.uint32)], axis=1,
    )
    for num_hash, rpb, bloom in ((4, 128, 50_000_000), (2, 4, 2**31 - 128)):
        bloom = tblocked.pad_bloom_size(bloom)
        blk, offs = tblocked.v3_block_offsets(vals, k, num_hash, bloom, rpb, version)
        b2, o2 = device_blkoff(
            ts.t32(packed), k=k, num_hash=num_hash, bloom_size=bloom, rpb=rpb,
            version=version,
        )
        np.testing.assert_array_equal(b2.numpy(), blk)
        np.testing.assert_array_equal(torch.stack(o2, dim=1).numpy(), offs)
        assert blk.max() < bloom // rpb and (np.diff(blk[np.argsort(vals)]) >= 0).all()


@pytest.mark.parametrize("wpad,num_hash", [(1, 4), (4, 3), (32, 2)])
def test_blocked_gather_matches_jax(wpad, num_hash):
    rng = np.random.default_rng(wpad)
    rpb = 128 // wpad
    blocks = rng.integers(0, 2**32, (512, 128), dtype=np.uint32)
    blk = rng.integers(0, 512, 4096)
    rows = (blk[:, None] * rpb + rng.integers(0, rpb, (4096, num_hash))).astype(np.int32)
    want = jquery._gather_rows_blocked(jnp.asarray(blocks), jnp.asarray(rows), wpad, rpb)
    got = tquery._gather_rows_blocked(ts.t32(blocks), torch.from_numpy(rows), wpad, rpb)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


# -- the generic engine path on a blocked index ---------------------------------


@pytest.mark.parametrize("blocked,C,num_hash", [(1, 21, 3), (1, 70, 4), (2, 40, 2)])
def test_generic_engine_on_blocked_index_matches_jax(monkeypatch, blocked, C, num_hash):
    monkeypatch.setenv("COLORID_STREAM", "0")
    rng = np.random.default_rng(C)
    bloom, matrix, names = ts.rand_blocked_matrix(rng, C, 60_000)
    n_ref = {n: 1 for n in names}
    jeng = JEngine(JIndex(bloom, num_hash, 31, 0, names, n_ref, matrix, blocked=blocked))
    teng = TEngine(
        convert.index_from_arrays(
            matrix, bloom_size=bloom, num_hash=num_hash, k_size=31, colors=names,
            n_ref_kmers=n_ref, blocked=blocked,
        ),
        chunk=1 << 12, device="cpu",
    )
    assert (teng.bv, teng.rpb) == (jeng.bv, jeng.rpb) and not teng._stream
    keys = rng.choice(ts.ACGT, size=(9000, 31))
    qcounts = rng.integers(1, 3000, 9000).astype(np.int32)
    want = jeng.search_keys(keys, qcounts=qcounts)
    assert want.counts.sum() > 0
    assert_same_result(teng.search_keys(keys, qcounts=qcounts), want)
    # precomputed rows, and keys the 2-bit packing cannot carry
    rows = teng.rows_for_keys(keys)
    np.testing.assert_array_equal(rows, jeng.rows_for_keys(keys))
    assert_same_result(teng.search_keys(None, qcounts=qcounts, rows_all=rows), want)
    nkeys = keys[:2000].copy()
    nkeys[:, 7] = ord("N")
    assert_same_result(teng.search_keys(nkeys), jeng.search_keys(nkeys))


def test_blocked_index_wider_than_a_block_is_refused():
    m = np.zeros((1024, 129), dtype=np.uint32)
    names = [f"c{i}" for i in range(129 * 32)]
    wide = TIndex(1024, 2, 31, 0, names, {}, m, blocked=1)
    with pytest.raises(ValueError, match="4096 colors"):
        TEngine(wide, device="cpu")


# -- build --blocked and the CLI -------------------------------------------------

K = 27
BUILD = ["-k", str(K), "-n", "4", "-s", "375000", "--blocked"]


def _run(main, argv, capsys) -> str:
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    d = tmp_path_factory.mktemp("blocked_cli")
    gs = ts.genomes(4, 50_000, seed=3)
    man, refs = ts.write_panel(d, gs)
    rs = ts.reads(gs[:2], 1200, 150, seed=4, sub_rate=0.005)
    out = {"dir": d, "man": man, "refs": refs,
           "fq": ts.write_fastq_gz(d / "reads.fastq.gz", rs)}
    for name, main in (("jax", jmain), ("torch", tmain)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["build", *BUILD, "-b", str(d / name), "-r", man])
        out[name] = str(d / f"{name}.bxi")
        out[name + "_stdout"] = buf.getvalue()
    return out


def test_build_blocked_writes_the_jax_packages_bytes(panel):
    assert panel["torch_stdout"].replace("torch", "jax") == panel["jax_stdout"]
    with open(panel["jax"], "rb") as fj, open(panel["torch"], "rb") as ft:
        assert fj.read() == ft.read()
    idx = TIndex.load(panel["torch"])
    assert idx.blocked == 4 and idx.bloom_size == 375040 and idx.place_rpb == 0
    j = JIndex.load(panel["jax"])
    assert (j.blocked, j.bloom_size) == (4, 375040)


@pytest.mark.parametrize("num_hash,k,want", [(3, 27, 1), (4, 33, 2), (8, 27, 4)])
def test_build_picks_the_jax_packages_layout_version(panel, num_hash, k, want):
    """v4 needs a power-of-two hash count and k <= 32; v2 the first only;
    anything else is v1."""
    from colorid_tpu.pipelines.build import build_index as jbuild

    refs = {n: panel["refs"][n] for n in ("genome0", "genome1")}
    j = jbuild(refs, 100_000, num_hash, k, verbose=False, blocked=True)
    t = tbuild(refs, 100_000, num_hash, k, verbose=False, blocked=True)
    assert t.blocked == j.blocked == want
    assert t.bloom_size == j.bloom_size == 100_096
    np.testing.assert_array_equal(t.matrix, j.matrix)


@pytest.mark.parametrize("stream", ["force", "0"])
@pytest.mark.parametrize("query", ["inexact", "perfect"])
def test_search_on_blocked_index_matches_jax(panel, capsys, monkeypatch, stream, query):
    monkeypatch.setenv("COLORID_STREAM", stream)
    monkeypatch.setenv("COLORID_SEARCH_READS", "0")  # the JAX CLI counts on the host
    q = {"inexact": ["-q", panel["fq"], "-f", "1"],
         "perfect": ["-s", "-q", panel["refs"]["genome3"][0]]}[query]
    want = _run(jmain, ["search", "-b", panel["jax"], *q], capsys)
    got = _run(tmain, ["search", "-b", panel["torch"], *q, "--device", "cpu"], capsys)
    assert got == want
    rows = [l.split("\t") for l in got.splitlines()]
    if query == "inexact":
        assert {r[2] for r in rows[:2]} == {"genome0", "genome1"}
    else:
        assert [r[1] for r in rows] == ["genome3"]


@pytest.mark.parametrize("filt", [["-f", "1"], []])
def test_device_counted_search_on_blocked_index_matches_jax(panel, capsys, monkeypatch, filt):
    """Both CLIs count the .fastq.gz's k-mers on the device: the JAX
    package through its fused reads pipeline on this v4 index, the port
    through extraction and the engine's own query dispatch; the TSV is the
    same."""
    monkeypatch.setenv("COLORID_SEARCH_READS", "1")
    q = ["-q", panel["fq"], *filt]
    want = _run(jmain, ["search", "-b", panel["jax"], *q], capsys)
    got = _run(tmain, ["search", "-b", panel["torch"], *q, "--device", "cpu"], capsys)
    assert got == want
    assert {r.split("\t")[2] for r in got.splitlines()[:2]} == {"genome0", "genome1"}


def test_info_on_blocked_index_matches_jax(panel, capsys):
    want = _run(jmain, ["info", "-b", panel["jax"]], capsys)
    got = _run(tmain, ["info", "-b", panel["torch"]], capsys)
    assert got == want and got.strip()


def test_what_build_still_refuses(panel):
    refs = {"genome0": panel["refs"]["genome0"]}
    # --color-shards is taken now: one color, so one word per shard and the
    # full row's own placement group, recorded as such
    placed = tbuild(refs, 100_000, 4, K, verbose=False, blocked=True, color_shards=2)
    assert (placed.blocked, placed.place_rpb) == (4, 128)
    with pytest.raises(SystemExit, match="incompatible"):
        tmain(["build", *BUILD, "--ref-format", "-b", str(panel["dir"] / "x"),
               "-r", panel["man"]])
    # --device-build is taken now (ops/build_ops.py), on the card unless
    # --device cpu: without a card it raises, it never builds on the host
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tbuild(refs, 100_000, 4, K, verbose=False, device=True)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tmain(["build", *BUILD, "--device-build", "-b",
                   str(panel["dir"] / "x"), "-r", panel["man"]])
