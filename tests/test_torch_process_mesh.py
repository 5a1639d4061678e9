"""ShardedQueryEngine on a row mesh whose shards live in two processes
(colorid_tpu_torch/parallel/distributed.py, sharded.py, engine.py), on the
CPU with the gloo backend.

Two worker processes (tests/torch_process_mesh_worker.py) run every route
on a (1, 4) row mesh (two shards per rank) and a (1, 2) one, over a
classic and a v4 index built from seeded genomes: search_keys, the four
readid_* methods, search_reads, classify_batch and the born-sharded build.
Every output must be the same on both ranks, equal to the JAX package's
ShardedQueryEngine on a (1, 4) row mesh of tests/conftest.py's 8 virtual
CPU devices and to the port's single-device QueryEngine. Integers
throughout: tolerance 0.

One launch of the JAX package on two processes pins what it completes
across processes and where it fails (a fetch of an array that spans other
processes' devices): the port refuses those meshes up front and gathers
generically where the JAX row stream fails. The (d, m) placement table and
the replicas of a model shard are checked in this process."""

import json
import os
import textwrap
import types

import numpy as np
import pytest
import torch

from colorid_tpu.index.bigsi import BigsiIndex as JIndex
from colorid_tpu.ops import build_ops as jbo
from colorid_tpu.parallel import sharded as jsh
from colorid_tpu.parallel.engine import ShardedQueryEngine as JSharded
from colorid_tpu.pipelines import read_id as jrid
from colorid_tpu_torch.engine import QueryEngine as TEngine
from colorid_tpu_torch.engine import SearchResult, flatten_keys
from colorid_tpu_torch.ops.query import row_wpad
from colorid_tpu_torch.parallel import sharded as tsh
from colorid_tpu_torch.parallel.engine import ShardedQueryEngine as TSharded
from colorid_tpu_torch.pipelines import read_id as trid
from colorid_tpu_torch.pipelines.build import build_index
from tests import torch_support as ts
from tests.test_torch_engine import assert_same_result

WORKER = os.path.join(ts.ROOT, "tests", "torch_process_mesh_worker.py")
K, H, BLOOM, L, B = 27, 2, 1 << 16, 150, 3
MESHES = ("m14", "m12")
KINDS = ("classic", "blocked")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """24 seeded 3 kbp genomes (genome 1 repeats genome 0's first 2 kbp:
    ties), a classic and a v4 index of 2^16 rows built by the port, the
    JAX package's engine on a (1, 4) row mesh and the port's single-device
    engine over each, and both ranks' outputs."""
    tmp = str(tmp_path_factory.mktemp("pmesh"))
    gs = ts.genomes(24, 3000, seed=30)
    gs[1][:2000] = gs[0][:2000]
    _man, refs = ts.write_panel(tmp, gs)
    index, jax, single = {}, {}, {}
    for kind, kw in (("classic", {}), ("blocked", dict(blocked=True))):
        t = build_index(refs, BLOOM, H, K, verbose=False, **kw)
        t.save(os.path.join(tmp, f"{kind}.bxi"))
        j = JIndex(t.bloom_size, t.num_hash, t.k_size, t.m_size, list(t.colors),
                   dict(t.n_ref_kmers), t.matrix, blocked=t.blocked, place_rpb=t.place_rpb)
        index[kind] = (j, t)
        jax[kind] = JSharded(j, mesh=jsh.make_mesh(1, 4, "row"), layout="row")
        single[kind] = TEngine(t, device="cpu")
    inp = ts.write_mesh_inputs(tmp, gs, K, L)
    ts.launch_two(lambda r, coord: [WORKER, coord, str(r), tmp, tmp, "cpu", "gloo"])
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(2)]
    return types.SimpleNamespace(index=index, jax=jax, single=single, inp=inp, ranks=ranks,
                                 memo={})


def memo(case, key, fn):
    if key not in case.memo:
        case.memo[key] = fn()
    return case.memo[key]


def result(out: dict, prefix: str) -> SearchResult:
    return SearchResult(*(out[f"{prefix}.{f}"] for f in (
        "counts", "all_valid", "and_all", "freq_hist", "over_colors", "over_freqs")))


def same_answers(got, want) -> None:
    """What the report prints: counts, all_valid, the AND words and the
    uniq-hit frequency statistics (a stream's overflow list may list the
    same entries in another order)."""
    np.testing.assert_array_equal(got.counts, want.counts)
    assert bool(got.all_valid) == bool(want.all_valid)
    np.testing.assert_array_equal(got.and_all, want.and_all)
    assert got.freq_stats() == want.freq_stats()


def as_json(rows) -> list:
    return json.loads(json.dumps([[x.item() if isinstance(x, np.generic) else x for x in r]
                                  for r in rows]))


def test_ranks_agree_on_every_output(case):
    a, b = case.ranks
    assert a.keys() == b.keys() and len(a) > 100
    for key in a:
        if key in ("coll.mismatch", "m14.classic.held", "m14.blocked.held",
                   "m12.classic.held", "m12.blocked.held"):
            continue
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert not a["leaked"].size and not b["leaked"].size


def test_each_rank_holds_its_own_shards(case):
    """Two shards per rank on (1, 4), contiguous as jax.devices() orders
    two processes of two devices; one each on (1, 2)."""
    for kind in KINDS:
        held = [r[f"m14.{kind}.held"].tolist() for r in case.ranks]
        assert held == [[True, True, False, False], [False, False, True, True]]
        held = [r[f"m12.{kind}.held"].tolist() for r in case.ranks]
        assert held == [[True, False], [False, True]]


def test_collectives(case):
    xs = [np.array([[r + 1, -1 - 2 * r], [0x0F0F << r, 7]]) for r in range(2)]
    for out in case.ranks:
        np.testing.assert_array_equal(out["coll.sum"], xs[0] + xs[1])
        np.testing.assert_array_equal(out["coll.min"], np.minimum(xs[0], xs[1]))
        np.testing.assert_array_equal(out["coll.cat"], np.concatenate(xs))
        np.testing.assert_array_equal(out["coll.and"], xs[0] & xs[1])


def test_a_collective_over_other_shapes_fails_every_rank(case):
    for r, out in enumerate(case.ranks):
        msg = str(out["coll.mismatch"])
        assert f"rank {r} passes a tensor of shape [{r + 1}]" in msg, msg
        assert "different inputs" in msg


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", KINDS)
def test_search_keys(case, monkeypatch, mesh, kind):
    """The generic route on both indexes: the SearchResult of the JAX
    package's row mesh and of the port's own in-process row mesh with the
    stream off (COLORID_STREAM=0, the route the JAX package completes
    across processes), field by field; the single-device answers."""
    inp = case.inp
    got = result(case.ranks[0], f"{mesh}.{kind}.search_keys")
    monkeypatch.setenv("COLORID_STREAM", "0")
    want = memo(case, ("jax.search_keys", kind),
                lambda: case.jax[kind].search_keys(inp["keys"], qcounts=inp["qcounts"]))
    assert_same_result(got, want)
    t = case.index[kind][1]
    local = TSharded(t, mesh=tsh.make_mesh(1, 4, "row", devices=["cpu"]), layout="row")
    assert local._stream == (kind == "blocked")
    assert_same_result(got, local.search_keys(inp["keys"], qcounts=inp["qcounts"]))
    monkeypatch.delenv("COLORID_STREAM")
    same_answers(got, case.single[kind].search_keys(inp["keys"], qcounts=inp["qcounts"]))
    assert got.counts.sum() > 1000 and len(got.over_colors) and len(got.freq_stats()) >= 3


def test_a_v4_index_gathers_generically_across_processes(case):
    for out in case.ranks:
        for mesh in MESHES:
            assert not out[f"{mesh}.blocked.stream"]
            assert not out[f"{mesh}.classic.stream"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", KINDS)
def test_readid_methods(case, mesh, kind):
    inp = case.inp
    sets, n = inp["sets"], len(inp["sets"])
    out = case.ranks[0]
    jeng, single = case.jax[kind], case.single[kind]

    def refs():
        rows, seg, pos = flatten_keys(sets, jeng._rows)
        return {
            "readid_counts": (jeng.readid_counts(sets, B), single.readid_counts(sets, B)),
            "readid_counts_arrays": (
                jeng.readid_counts_arrays(rows, seg, pos, n, B),
                single.readid_counts_arrays(rows, seg, pos, n, B)),
            "readid_counts_packed": (
                jeng.readid_counts_packed(inp["packed"], seg, pos, n, B, K),
                single.readid_counts_packed(inp["packed"], seg, pos, n, B, K)),
            "readid_firsthit": (jeng.readid_firsthit(sets, B), single.readid_firsthit(sets, B)),
        }

    for name, (want_jax, want_single) in memo(case, ("readid", kind), refs).items():
        got = out[f"{mesh}.{kind}.{name}"]
        np.testing.assert_array_equal(got, want_jax, err_msg=name)
        np.testing.assert_array_equal(got, want_single, err_msg=name)
    counts = out[f"{mesh}.{kind}.readid_counts"]
    assert 0 < int(counts[:, -1].sum()) < n and counts[:, :-1].max() > 50


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", KINDS)
def test_search_reads(case, mesh, kind):
    inp = case.inp
    out = case.ranks[0]
    got = result(out, f"{mesh}.{kind}.search_reads")
    n_u = int(out[f"{mesh}.{kind}.search_reads.n_u"])
    args = (inp["words"], inp["lens"])
    kw = dict(k=K, L=L, filter_t=1)
    want, want_n = memo(case, ("jax.search_reads", kind),
                        lambda: case.jax[kind].search_reads(*args, **kw))
    assert n_u == want_n > 1000
    assert_same_result(got, want)
    ref, ref_n = case.single[kind].search_reads(*args, **kw)
    assert n_u == ref_n
    same_answers(got, ref)
    assert len(got.over_colors) > 20 and got.over_freqs.min() >= 1100


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", KINDS)
def test_classify_batch(case, mesh, kind):
    batch = case.inp["batch"]
    got = json.loads(str(case.ranks[0][f"{mesh}.{kind}.classify_batch"]))
    want = memo(case, ("jax.classify", kind),
                lambda: as_json(jrid.classify_batch(batch, case.jax[kind], 1, 1e-3, B)))
    assert got == want
    assert got == as_json(trid.classify_batch(batch, case.single[kind], 1, 1e-3, B))
    assert len(got) == 60 and sum(1 for r in got if r[4] == "reject" and r[5] > 1) >= 3


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", KINDS)
def test_born_sharded_build(case, monkeypatch, mesh, kind):
    """build_matrix_rowshard + pack_blocks_rowshard across the ranks: each
    rank's shards equal device_put_rowshard's, and the engine over them
    (no host matrix) gives the JAX package's born-sharded engine's
    SearchResult and the single-device answers."""
    inp = case.inp
    out = case.ranks[0]
    assert out[f"{mesh}.{kind}.born.equal_blocks"]
    got = result(out, f"{mesh}.{kind}.born")
    j, t = case.index[kind]

    def jax_born():
        cols = [np.nonzero((t.matrix[:, c // 32] >> np.uint32(c % 32)) & np.uint32(1))[0]
                for c in range(t.n_colors)]
        jmesh = jsh.make_mesh(1, 4, "row")
        jmat, jRl = jbo.build_matrix_rowshard(cols, t.bloom_size, jmesh, pad_to=1 << 14)
        jblocks = jbo.pack_blocks_rowshard(jmat, mesh=jmesh, Rl=jRl, W=t.words_per_row)
        meta = JIndex(t.bloom_size, t.num_hash, t.k_size, t.m_size, list(t.colors),
                      dict(t.n_ref_kmers), None, blocked=t.blocked, place_rpb=t.place_rpb)
        eng = JSharded(meta, mesh=jmesh, layout="row",
                       sharded_matrix=(jblocks, row_wpad(t.words_per_row), jRl))
        return eng.search_keys(inp["keys"], qcounts=inp["qcounts"])

    assert_same_result(got, memo(case, ("jax.born", kind), jax_born))
    same_answers(got, case.single[kind].search_keys(inp["keys"], qcounts=inp["qcounts"]))


def test_the_color_layout_and_n_data_are_refused_across_processes(case):
    for out in case.ranks:
        assert "colorid_tpu/parallel/engine.py:170" in str(out["refuse.color"])
        assert "colorid_tpu/parallel/engine.py:185, :552, :592" in str(out["refuse.n_data"])
        assert out["default.shape"].tolist() == [1, 2] and str(out["default.home"]) == "cpu"


def test_mesh_refusals_in_process():
    """The same refusals on a mesh whose devices two ranks own (no group
    needed to build one), and none in one process."""
    cpu = (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="engine.py:170"):
        tsh.Mesh(1, 4, "color", cpu, ranks=(0, 0, 1, 1))
    with pytest.raises(ValueError, match=r"engine.py:185, :552, :592"):
        tsh.Mesh(2, 2, "row", cpu, ranks=(0, 0, 1, 1))
    assert not tsh.Mesh(2, 2, "color", cpu).spans_processes
    assert not tsh.Mesh(2, 2, "color", cpu, ranks=(1, 1, 1, 1), rank=1).spans_processes


@pytest.mark.parametrize("nd,nm", [(1, 8), (2, 4), (4, 2), (2, 2)])
def test_placement_follows_the_jax_mesh(nd, nm):
    """Shard (d, m) on device d * n_model + m of the list, as
    jax.devices()[:nd * nm].reshape(nd, nm) lays them out; round-robin
    over a shorter list; one device for every shard of a one-card mesh."""
    want = np.arange(nd * nm).reshape(nd, nm)
    devs = tuple(torch.device("cuda", i) for i in range(nd * nm))
    mesh = tsh.Mesh(nd, nm, "row", devs)
    table = np.array([[mesh.device(m, d).index for m in range(nm)] for d in range(nd)])
    np.testing.assert_array_equal(table, want)
    mesh = tsh.Mesh(nd, nm, "row", devs[:3])
    table = np.array([[mesh.device(m, d).index for m in range(nm)] for d in range(nd)])
    np.testing.assert_array_equal(table, want % 3)
    assert mesh.home == devs[0] and all(mesh.owns(m, d) for m in range(nm) for d in range(nd))
    one = tsh.make_mesh(nd, nm, "row", devices=["cpu"])
    assert {one.device(m, d) for m in range(nm) for d in range(nd)} == {torch.device("cpu")}


@pytest.mark.parametrize("rank", [0, 1])
def test_placement_on_a_simulated_two_rank_device_list(rank):
    """Two processes of two cards each (distributed.global_devices: rank
    0's devices, then rank 1's): a (1, 4) mesh puts shards 0 and 1 on rank
    0's cards and 2 and 3 on rank 1's, the JAX order; each rank owns its
    own and merges on its first card."""
    devs = tuple(torch.device("cuda", i) for i in (0, 1, 0, 1))
    mesh = tsh.Mesh(1, 4, "row", devs, ranks=(0, 0, 1, 1), rank=rank)
    assert mesh.spans_processes
    np.testing.assert_array_equal([mesh.device(m).index for m in range(4)],
                                  np.arange(4).reshape(1, 4)[0] % 2)
    assert [mesh.owns(m) for m in range(4)] == [m // 2 == rank for m in range(4)]
    assert mesh.home == torch.device("cuda", 0)
    one_each = tsh.Mesh(1, 2, "row", devs[:1] * 2, ranks=(0, 1), rank=rank)
    assert [one_each.owns(m) for m in range(2)] == [m == rank for m in range(2)]


def test_a_model_shard_is_copied_to_every_device_of_its_column():
    """device_put_rowshard on a (2, 2) mesh over (cpu, cpu, meta): shard
    (1, 0) sits on the meta device and gets its own copy of model shard 0;
    shard (1, 1) shares its column's CPU copy."""
    mesh = tsh.Mesh(2, 2, "row", (torch.device("cpu"), torch.device("cpu"),
                                  torch.device("meta")))
    matrix = np.random.default_rng(3).integers(0, 2**32, (4096, 2), dtype=np.uint32)
    mat, _wpad, _Rl = tsh.device_put_rowshard(matrix, mesh)
    assert [m.device.type for m in mat] == ["cpu", "cpu"]
    assert set(mat.replicas) == {(1, 0)}
    copy = tsh._shard(mat, 0, 1)
    assert copy.device.type == "meta" and copy.shape == mat[0].shape
    assert tsh._shard(mat, 1, 1) is mat[1] and tsh._shard(mat, 0, 0) is mat[0]
    plain = [torch.zeros(2), torch.ones(2)]
    assert tsh._shard(plain, 1, 1) is plain[1]


JAX_WORKER = textwrap.dedent(
    """
    import json, os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    from colorid_tpu.parallel import distributed
    coord, pid = sys.argv[1], int(sys.argv[2])
    distributed.initialize(coord, num_processes=2, process_id=pid)
    import jax
    import numpy as np
    from colorid_tpu.engine import QueryEngine
    from colorid_tpu.index.bigsi import BigsiIndex
    from colorid_tpu.ops import build_ops
    from colorid_tpu.ops.extract import pack_reads
    from colorid_tpu.parallel import sharded
    from colorid_tpu.parallel.engine import ShardedQueryEngine
    from colorid_tpu.ops.query import row_wpad
    assert len(jax.devices()) == 4 and jax.process_count() == 2
    rng = np.random.default_rng(5)
    R, C, K = 1 << 15, 40, 27
    m = rng.integers(0, 2**32, (R, 2), dtype=np.uint32)
    m &= rng.integers(0, 2**32, (R, 2), dtype=np.uint32)
    m[:, 1] &= np.uint32((1 << 8) - 1)
    names = [f"c{i}" for i in range(C)]
    classic = BigsiIndex(R, 2, K, 0, names, {n: 1 for n in names}, m)
    v4 = BigsiIndex(R, 2, K, 0, names, {n: 1 for n in names}, m, blocked=4)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    keys = acgt[rng.integers(0, 4, (3000, K))]
    sets = [keys[i * 50:(i + 1) * 50] for i in range(20)]
    words = pack_reads(acgt[rng.integers(0, 4, (64, 150))])
    lens = np.full(64, 150, np.int32)

    def same(a, b):
        return bool((a.counts == b.counts).all() and a.all_valid == b.all_valid
                    and (a.and_all == b.and_all).all() and a.freq_stats() == b.freq_stats())

    def engine(index, nd, nm, layout, **kw):
        return ShardedQueryEngine(index, mesh=sharded.make_mesh(nd, nm, layout),
                                  layout=layout, n_data=nd, **kw)

    single = {"classic": QueryEngine(classic), "v4": QueryEngine(v4)}

    def born():
        cols = [np.nonzero((m[:, c // 32] >> np.uint32(c % 32)) & np.uint32(1))[0]
                for c in range(C)]
        mesh = sharded.make_mesh(1, 4, "row")
        mat, Rl = build_ops.build_matrix_rowshard(cols, R, mesh, pad_to=1 << 14)
        blocks = build_ops.pack_blocks_rowshard(mat, mesh=mesh, Rl=Rl, W=2)
        meta = BigsiIndex(R, 2, K, 0, names, {n: 1 for n in names}, None)
        return ShardedQueryEngine(meta, mesh=mesh, layout="row",
                                  sharded_matrix=(blocks, row_wpad(2), Rl))

    cases = {
        "row14 search_keys": lambda: same(engine(classic, 1, 4, "row").search_keys(keys),
                                          single["classic"].search_keys(keys)),
        "row14 readid_counts": lambda: bool((engine(classic, 1, 4, "row").readid_counts(sets, 3)
                                             == single["classic"].readid_counts(sets, 3)).all()),
        "row14 readid_firsthit": lambda: bool(
            (engine(classic, 1, 4, "row").readid_firsthit(sets, 3)
             == single["classic"].readid_firsthit(sets, 3)).all()),
        "row14 search_reads": lambda: same(
            engine(classic, 1, 4, "row").search_reads(words, lens, k=K, L=150)[0],
            single["classic"].search_reads(words, lens, k=K, L=150)[0]),
        "row14 born-sharded": lambda: same(born().search_keys(keys),
                                           single["classic"].search_keys(keys)),
        "row14 v4 search_keys": lambda: same(engine(v4, 1, 4, "row").search_keys(keys),
                                             single["v4"].search_keys(keys)),
        "color14 search_keys": lambda: same(engine(classic, 1, 4, "color").search_keys(keys),
                                            single["classic"].search_keys(keys)),
        "row22 search_keys": lambda: same(engine(classic, 2, 2, "row").search_keys(keys),
                                          single["classic"].search_keys(keys)),
        "row22 readid_firsthit": lambda: bool(
            (engine(classic, 2, 2, "row").readid_firsthit(sets, 3)
             == single["classic"].readid_firsthit(sets, 3)).all()),
        "row22 search_reads": lambda: same(
            engine(classic, 2, 2, "row").search_reads(words, lens, k=K, L=150)[0],
            single["classic"].search_reads(words, lens, k=K, L=150)[0]),
    }
    out = {}
    for name, fn in cases.items():
        try:
            out[name] = "equal" if fn() else "differs"
        except RuntimeError as e:
            out[name] = str(e)
    os.environ["COLORID_STREAM"] = "0"
    out["row14 v4 search_keys, COLORID_STREAM=0"] = (
        "equal" if same(engine(v4, 1, 4, "row").search_keys(keys), single["v4"].search_keys(keys))
        else "differs")
    print("RESULT " + json.dumps(out), flush=True)
    """
)


def test_the_jax_package_across_two_processes(tmp_path):
    """What the JAX package completes on two processes of two CPU devices
    each, and where it fails: every failure is the fetch of an array that
    spans the other process's devices, the meshes and routes the port
    refuses or leaves out across processes."""
    script = tmp_path / "jax_worker.py"
    script.write_text(JAX_WORKER)
    outs = ts.launch_two(lambda r, coord: [str(script), coord, str(r)])
    results = [json.loads(o.split("RESULT ", 1)[1]) for o in outs]
    assert results[0] == results[1]
    fetch = "spans non-addressable (non process local) devices"
    completes = ["row14 search_keys", "row14 readid_counts", "row14 readid_firsthit",
                 "row14 search_reads", "row14 born-sharded",
                 "row14 v4 search_keys, COLORID_STREAM=0"]
    fails = ["row14 v4 search_keys", "color14 search_keys", "row22 search_keys",
             "row22 readid_firsthit", "row22 search_reads"]
    assert sorted(results[0]) == sorted(completes + fails)
    for name in completes:
        assert results[0][name] == "equal", (name, results[0][name])
    for name in fails:
        assert fetch in results[0][name], (name, results[0][name])
