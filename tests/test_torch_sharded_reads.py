"""The port's sharded read classifier and sharded device extraction
(colorid_tpu_torch/parallel/sharded.py: readid_batch_*, readid_firsthit_*,
the packed readid_batch_*, extract_merge_datashard, hash_packed_datashard)
and ops/query.py::query_batch against the JAX package's, on the 8 virtual
CPU devices of tests/conftest.py: meshes (2, 4), (1, 8) and (4, 2) on both
layouts, -B 0 and 3, classic rows and the blocked gather, a k-mer run that
straddles a data slice boundary. The engines over these functions:
tests/test_torch_sharded_reads_engine.py. Integers throughout: tolerance
0."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu.ops import query as jq
from colorid_tpu.parallel import sharded as jsh
from colorid_tpu.parallel.engine import ShardedQueryEngine as JSharded
from colorid_tpu_torch.ops import extract as te
from colorid_tpu_torch.ops import query as tq
from colorid_tpu_torch.ops.blocked import blocked_rows_host
from colorid_tpu_torch.parallel import sharded as tsh
from colorid_tpu_torch.parallel.engine import ShardedQueryEngine as TSharded
from colorid_tpu_torch.pipelines import read_id as trid
from tests import torch_support as ts

MESHES = [(2, 4), (1, 8), (4, 2)]
C, BLOOM, H, K = 200, 20_000, 4, 31
t32 = ts.t32


def _np(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _cpu_mesh(nd, nm, axis):
    return tsh.make_mesh(nd, nm, axis, devices=["cpu"])


def _same(got, want, what=""):
    if isinstance(got, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
        return
    np.testing.assert_array_equal(got.numpy(), _np(want), err_msg=what)


# -- functions ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def case():
    """A random 200-color matrix (1 % absent rows, wpad 8), blocked-placed
    rows for 3,000 k-mers of 60 reads (all of a k-mer's rows in one 16-row
    group), their reads and set ranks, and the same k-mers 2-bit packed."""
    rng = np.random.default_rng(31)
    bloom, matrix, _names = ts.rand_blocked_matrix(rng, C, BLOOM, 0.01, thin=2)
    N, n_reads = 3000, 60
    packed = ts.rand_packed(rng, N, K)
    keys = rng.choice(ts.ACGT, size=(N, K))
    rows = blocked_rows_host(keys, H, bloom, 16, version=2).astype(np.int32)
    seg = np.sort(rng.integers(0, n_reads, N)).astype(np.int32)
    seg[seg == 7] = 8  # a read without k-mers
    pos = np.zeros(N, dtype=np.int32)
    for r in range(n_reads):
        m = seg == r
        pos[m] = rng.permutation(int(m.sum()))
    return types.SimpleNamespace(
        bloom=bloom, matrix=matrix, rows=rows, packed=packed, seg=seg, pos=pos,
        n_reads=n_reads, mask=rng.random(N) < 0.9)


def _partition(mesh_t, jmesh, per_kmer, seg, pos, n_reads):
    """Both engines' _partition_reads on the same arrays: equal outputs."""
    got = TSharded._partition_reads(types.SimpleNamespace(mesh=mesh_t), per_kmer, seg, pos, n_reads)
    want = JSharded._partition_reads(types.SimpleNamespace(mesh=jmesh), per_kmer, seg, pos, n_reads)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    return got


@pytest.mark.parametrize("rpb", [0, 16])
def test_query_batch_matches_jax(case, rpb):
    blocks, wpad = jq.pack_matrix_blocks(case.matrix)
    rows = case.rows if rpb else case.rows[:, ::-1].copy()
    want = jq.query_batch(jnp.asarray(blocks), jnp.asarray(rows), jnp.asarray(case.mask),
                          wpad=wpad, rpb=128 // wpad if rpb else 0)
    got = tq.query_batch(t32(blocks), t32(rows), torch.from_numpy(case.mask),
                         wpad=wpad, rpb=128 // wpad if rpb else 0)
    _same(got, want)
    counts, uniq, valid, _aw, all_valid = got
    assert int(counts.sum()) > 0 and (uniq >= 0).any() and not bool(all_valid)
    assert 0 < int(valid.sum()) < int(case.mask.sum())


@pytest.mark.parametrize("layout", ["color", "row"])
@pytest.mark.parametrize("nd,nm", MESHES)
def test_readid_functions_match_jax(case, layout, nd, nm):
    """readid_batch_*, readid_firsthit_* and the packed readid_batch_*
    (device hashing, classic and v4 placement) on one mesh."""
    jmesh = jsh.make_mesh(nd, nm, layout)
    mesh = _cpu_mesh(nd, nm, layout)
    if layout == "color":
        jmat, wpad, Wl = jsh.device_put_colorshard(case.matrix, jmesh)
        mat = tsh.device_put_colorshard(case.matrix, mesh)[0]
        geo = dict(wpad=wpad, Wl=Wl)
        sfx = "colorshard"
    else:
        jmat, wpad, Rl = jsh.device_put_rowshard(case.matrix, jmesh, row_multiple=128)
        mat = tsh.device_put_rowshard(case.matrix, mesh, row_multiple=128)[0]
        geo = dict(wpad=wpad, Rl=Rl, W=case.matrix.shape[1])
        sfx = "rowshard"
    rows3, seg2, pos2, nrl = _partition(mesh, jmesh, case.rows, case.seg, case.pos, case.n_reads)
    jin = [jnp.asarray(a) for a in (rows3, seg2, pos2)]
    tin = [t32(a) for a in (rows3, seg2, pos2)]
    blocked = 128 // wpad if (nd, nm) == (2, 4) else 0
    for fn, B, rpb in (("readid_batch", 0, 0), ("readid_batch", 3, blocked),
                       ("readid_firsthit", 3, 0), ("readid_firsthit", 0, blocked)):
        kw = dict(geo, start_sample=B, n_reads_l=nrl, rpb=rpb)
        want = getattr(jsh, f"{fn}_{sfx}")(jmat, *jin, mesh=jmesh, **kw)
        got = getattr(tsh, f"{fn}_{sfx}")(mat, *tin, mesh=mesh, **kw)
        _same(got, want, f"{fn} B={B} rpb={rpb}")
        assert got[0].shape[0] == nd * nrl
        if fn == "readid_batch":  # absent rows broke some reads, not all
            assert 0 < int(got[1].sum()) < case.n_reads
            assert int(got[0].sum()) > 0
    # device hashing: classic rows on the color layout, the v4 placement
    # (the blocked gather) on the row layout
    pk3 = _partition(mesh, jmesh, case.packed, case.seg, case.pos, case.n_reads)[0]
    rpb_place, bv = (0, 1) if layout == "color" else (16, 4)
    kw = dict(geo, start_sample=3, n_reads_l=nrl, rpb=128 // wpad if bv > 1 else 0,
              k=K, num_hash=H, bloom_size=case.bloom, rpb_place=rpb_place, bv=bv)
    want = getattr(jsh, f"readid_batch_{sfx}_packed")(jmat, jnp.asarray(pk3), *jin[1:],
                                                      mesh=jmesh, **kw)
    got = getattr(tsh, f"readid_batch_{sfx}_packed")(mat, t32(pk3), *tin[1:], mesh=mesh, **kw)
    _same(got, want, "packed")


@pytest.mark.parametrize("nd,rpb_place,bv", [(2, 0, 1), (4, 16, 4), (8, 32, 2)])
def test_hash_packed_matches_jax(case, nd, rpb_place, bv):
    kw = dict(k=K, num_hash=H, bloom_size=case.bloom, rpb_place=rpb_place, bv=bv)
    want = jsh.hash_packed_datashard(jnp.asarray(case.packed),
                                     mesh=jsh.make_mesh(nd, 8 // nd, "row"), **kw)
    got = tsh.hash_packed_datashard(t32(case.packed), mesh=_cpu_mesh(nd, 8 // nd, "row"), **kw)
    _same(got, want)


def _read_batch(nd: int, n: int = 96, L: int = 64, seed: int = 3):
    """2-bit packed reads: 80 copies of one sequence (its windows' runs
    in the sorted merge are longer than the gaps between slice boundaries)
    and random reads; 90 % of them of full length, the rest 20 to L."""
    rng = np.random.default_rng(seed)
    seqs = ts.ACGT[rng.integers(0, 4, (n, L))]
    seqs[rng.permutation(n)[:80]] = seqs[0]
    lens = np.full(n, L, dtype=np.int32)
    short = rng.random(n) < 0.1
    lens[short] = rng.integers(20, L + 1, int(short.sum()))
    return te.pack_reads(seqs), lens


@pytest.mark.parametrize("nd,filter_t,d", [(1, 0, 1), (2, 1, 1), (4, 1, 2), (8, 0, 1)])
def test_extract_merge_matches_jax(nd, filter_t, d):
    L = 64
    words, lens = _read_batch(nd)
    jmesh = jsh.make_mesh(nd, 8 // nd, "color")
    mesh = _cpu_mesh(nd, 8 // nd, "color")
    want = jsh.extract_merge_datashard(jnp.asarray(words), jnp.asarray(lens), mesh=jmesh,
                                       k=K, L=L, filter_t=filter_t, d=d)
    got = tsh.extract_merge_datashard(t32(words), torch.from_numpy(lens), mesh=mesh,
                                      k=K, L=L, filter_t=filter_t, d=d)
    _same(got, want)
    keys, qc, n_own = got
    T = keys.shape[0] // nd
    assert keys.shape[0] == words.shape[0] * (L - K + 1)
    own = n_own.tolist()
    assert sum(own) > 0 and all(int(qc[s * T + n]) == 0 for s, n in enumerate(own) if n < T)
    # a global unique set: every key once, the totals those of one batch
    flat = te.extract_count(t32(words), torch.from_numpy(lens), k=K, L=L,
                            filter_t=filter_t, d=d)
    n_u = int(flat[2])
    assert sum(own) == n_u
    got_keys = torch.cat([keys[s * T: s * T + n] for s, n in enumerate(own)])
    got_qc = torch.cat([qc[s * T: s * T + n] for s, n in enumerate(own)])
    assert torch.equal(got_keys, flat[0][:n_u]) and torch.equal(got_qc, flat[1][:n_u])


def test_extract_merge_run_straddles_a_slice_boundary():
    """Four copies of one 64 bp read, one per data slice: each of its 34
    k-mers appears once per slice, so the sorted merge holds runs of 4 and
    the slice boundary at T = 34 cuts the ninth run in two. The run totals
    are taken before the cut: slice 0 owns that k-mer with all 4 counts."""
    rng = np.random.default_rng(4)
    L = 64
    words = te.pack_reads(np.repeat(ts.ACGT[rng.integers(0, 4, (1, L))], 4, axis=0))
    lens = np.full(4, L, dtype=np.int32)
    want = jsh.extract_merge_datashard(jnp.asarray(words), jnp.asarray(lens),
                                       mesh=jsh.make_mesh(4, 2, "row"), k=K, L=L, filter_t=3)
    got = tsh.extract_merge_datashard(t32(words), torch.from_numpy(lens),
                                      mesh=_cpu_mesh(4, 2, "row"), k=K, L=L, filter_t=3)
    _same(got, want)
    keys, qc, n_own = got
    T = L - K + 1
    assert n_own.tolist() == [9, 8, 9, 8]
    flat = te.extract_count(t32(words[:1]), torch.from_numpy(lens[:1]), k=K, L=L, filter_t=0)
    assert torch.equal(keys[8], flat[0][8])  # the run cut at entry 34 = 4 * 8 + 2
    assert qc.view(4, T)[:, :9].tolist() == [[4] * 9, [4] * 8 + [0], [4] * 9, [4] * 8 + [0]]


def test_prepare_native_takes_a_full_group_packed():
    """A group of exactly 32,768 reads (int16 read ids 0..32767) takes the
    packed route, which is what a sharded engine's read_id runs."""
    from colorid_tpu_torch import native

    if not native.available():
        pytest.skip("the port's native library is not built here")
    index = types.SimpleNamespace(k_size=K, m_size=0, bloom_size=1 << 20, blocked=0,
                                  num_hash=H)
    rng = np.random.default_rng(2)
    batch = [(f"r{i}", [ts.ACGT[rng.integers(0, 4, K + 1)]]) for i in range(32768)]
    prep = trid._prepare_native(batch, list(range(32768)), index, 1, True)
    assert prep[0] == "packed" and int(prep[2].max()) == 32767
