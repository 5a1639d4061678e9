"""Kernel F's twin (colorid_tpu_torch/ops/extract.py::run_counts_plain, the
reads routes' run counts, -f filter and compactions) against the JAX
package's code it replaces, on the CPU: each mode through the port's own
callers, on the same seeded reads or keys as the JAX function, tolerance
zero (integers and bit views). Where the JAX package computes a mode inside
a larger function (fused_search_reads, fused_merge_query), that function
runs unjitted with its placement and probe stream replaced by recorders
that keep the stream they are handed; the port's _probe is recorded the
same way. Every mode also holds against a numpy reference on keys cut at
kernel F's tile edges (tests/torch_support.py::run_counts_case)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu.ops import extract as je
from colorid_tpu.ops import fused_reads as jf
from colorid_tpu_torch.ops import extract as te
from colorid_tpu_torch.ops import fused_reads as tf
from tests import torch_support as ts

K, L = 21, 48
GEO = dict(wpad=1, num_hash=4, bloom_size=1 << 20, rpb=128, n_colors=3, bv=4)


def _reads(kind: str):
    """(words, lens, validity bits) numpy: "mixed" reads with N bases,
    shorter lengths and three reads repeated 150 times; "deep" one read
    4,200 times (its k-mers' runs are longer than kernel F's tile) beside 50
    others; "all_sent" 64 reads of length 0 (no window counts)."""
    gs = ts.genomes(2, 20_000, seed=91)
    if kind == "deep":
        rs = ts.reads(gs, 50, L, seed=2, sub_rate=0.01)
        rs = np.concatenate([rs, np.repeat(rs[:1], 4200, axis=0)])
    else:
        rs = ts.reads(gs, 400 if kind == "mixed" else 64, L, seed=3, sub_rate=0.01)
    lens = np.full(rs.shape[0], L, dtype=np.int32)
    if kind == "mixed":
        rs[::9, 20] = ord("N")
        rs = np.concatenate([rs, np.repeat(rs[:3], 150, axis=0)])
        lens = np.full(rs.shape[0], L, dtype=np.int32)
        lens[::7] = 40
    elif kind == "all_sent":
        lens[:] = 0
    w, vb = je.pack_reads_valid(rs)
    return w, lens, vb


def _torch(w, lens, vb):
    return ts.t32(w), torch.from_numpy(lens), ts.t32(vb)


def _limbs(keys) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) uint32 of the port's int64 sort keys."""
    u = np.asarray(keys, dtype=np.int64).view(np.uint64) ^ np.uint64(1 << 63)
    return (u & np.uint64(0xFFFFFFFF)).astype(np.uint32), (u >> np.uint64(32)).astype(np.uint32)


def _keys(lo, hi) -> torch.Tensor:
    """The port's int64 sort keys of JAX (lo, hi) uint32 limbs."""
    u = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)
    return torch.from_numpy((u ^ np.uint64(1 << 63)).view(np.int64))


def _record_jax_stream(monkeypatch) -> dict:
    """Run the JAX fused functions' placement and probe stream as recorders
    of the stream they are handed (lo, hi, qc)."""
    seen = {}

    def blkoff(lo, hi, *a, **kw):
        seen.update(lo=np.asarray(lo), hi=np.asarray(hi))
        return lo, [lo]

    def core(stats, hist, over_col, over_freq, blocks2, blocks_bp, blk, offp, qc, qc2, **kw):
        seen["qc"] = np.asarray(qc)
        return stats, hist, over_col, over_freq, jnp.int32(0)

    monkeypatch.setattr(jf, "_v3_blkoff", blkoff)
    monkeypatch.setattr(jf, "pack_offsets", lambda offs: offs)
    monkeypatch.setattr(jf, "_stream_core", core)
    return seen


def _record_port_stream(monkeypatch) -> dict:
    seen = {}

    def probe(stats, hist, over_col, over_freq, blocks2, s, qc, **kw):
        seen.update(s=s.numpy().copy(), qc=qc.numpy().copy())
        return torch.zeros((), dtype=torch.int32)

    monkeypatch.setattr(tf, "_probe", probe)
    return seen


def _assert_stream(port: dict, jax: dict):
    lo, hi = _limbs(port["s"])
    np.testing.assert_array_equal(lo, jax["lo"])
    np.testing.assert_array_equal(hi, jax["hi"])
    np.testing.assert_array_equal(port["qc"], jax["qc"])


# -- each mode through its caller, against the JAX package ------------------------


@pytest.mark.parametrize("kind,filter_t", [
    ("mixed", 0), ("mixed", 1), ("mixed", 3), ("mixed", 7), ("mixed", 15),  # 0-3 rounds
    ("deep", 1), ("deep", 15), ("all_sent", 1),
])
def test_pairs_mode_matches_jax_single_route(monkeypatch, kind, filter_t):
    """fused_search_reads: run counts, the filter and min(3, ...) pairwise
    rounds, the probe stream slot for slot, and n_unique."""
    w, lens, vb = _reads(kind)
    jseen = _record_jax_stream(monkeypatch)
    jout = jf.fused_search_reads.__wrapped__(
        None, None, None, None, None, None, jnp.asarray(w), jnp.asarray(lens), jnp.asarray(vb),
        k=K, L=L, filter_t=filter_t, d=1, **GEO)
    tseen = _record_port_stream(monkeypatch)
    tout = tf.fused_search_reads(None, None, None, None, None, *_torch(w, lens, vb), k=K, L=L,
                                 filter_t=filter_t, d=1, **GEO)
    _assert_stream(tseen, jseen)
    assert int(tout[5]) == int(jout[5])
    assert (int(tout[5]) > 0) == (kind != "all_sent")


@pytest.mark.parametrize("kind", ["mixed", "deep", "all_sent"])
def test_counts_mode_matches_jax_chunk_a(kind):
    """extract_sorted_counts: the sorted keys, the counts at run starts (no
    filter) and n_unique."""
    w, lens, vb = _reads(kind)
    lo, hi, qc, n = jf.extract_sorted_counts(jnp.asarray(w), jnp.asarray(lens),
                                             jnp.asarray(vb), k=K, L=L, d=1)
    s, tqc, tn = tf.extract_sorted_counts(*_torch(w, lens, vb), k=K, L=L, d=1)
    tlo, thi = _limbs(s.numpy())
    np.testing.assert_array_equal(tlo, np.asarray(lo))
    np.testing.assert_array_equal(thi, np.asarray(hi))
    np.testing.assert_array_equal(tqc.numpy(), np.asarray(qc))
    assert int(tn) == int(n) and tqc.dtype == torch.int32


def _chunk_a(kind: str, n_chunks: int = 2):
    """JAX dispatch A on n_chunks slices of the reads: [(lo, hi, qc, n)]."""
    w, lens, vb = _reads(kind)
    R = w.shape[0] // n_chunks
    return [jf.extract_sorted_counts(jnp.asarray(w[i * R:(i + 1) * R]),
                                     jnp.asarray(lens[i * R:(i + 1) * R]),
                                     jnp.asarray(vb[i * R:(i + 1) * R]), k=K, L=L, d=1)
            for i in range(n_chunks)]


@pytest.mark.parametrize("where", ["below", "at", "above", "edges_below", "edges_above"])
def test_partition_mode_matches_jax_compact(where):
    """compact_sorted: the live entries then the dead, each in key order, cut
    to a cap below, at and above the live count (the merge's probe stream
    holds the dead ones too); also on keys cut at kernel F's tile edges."""
    if where.startswith("edges"):
        s, _w = ts.run_counts_case("tile_edges")
        qc = te.run_counts_plain(torch.from_numpy(s), mode="select")[1].numpy()
        lo, hi = _limbs(s)
        n = int((qc != 0).sum())
    else:
        lo, hi, qc, n = (np.array(x) for x in _chunk_a("mixed", 1)[0])
        n = int(n)
    cap = {"below": n - 100, "at": n, "above": n + 100, "edges_below": n // 2,
           "edges_above": n + 5000}[where]
    jlo, jhi, jqc = jf.compact_sorted(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(qc), cap=cap)
    ts_, tqc = tf.compact_sorted(_keys(lo, hi), torch.from_numpy(qc), cap=cap)
    tlo, thi = _limbs(ts_.numpy())
    np.testing.assert_array_equal(tlo, np.asarray(jlo))
    np.testing.assert_array_equal(thi, np.asarray(jhi))
    np.testing.assert_array_equal(tqc.numpy(), np.asarray(jqc))
    assert len(tqc) == min(cap, len(qc))


def _split_sum_chunks():
    """Two chunk streams of 16 slots: k-mer 10 once in each (total 2: it
    passes -f 1 only summed), 20 once in one (dropped), 30 twice in one,
    40 three times in the other, every other slot dead (SENT, 0)."""
    S = ts.SENT_KEY
    s = np.full((2, 16), S, dtype=np.int64)
    qc = np.zeros((2, 16), dtype=np.int32)
    s[0, :3], qc[0, :3] = (10, 20, 30), (1, 1, 2)
    s[1, :2], qc[1, :2] = (10, 40), (1, 3)
    return s, qc


@pytest.mark.parametrize("case,filter_t", [
    ("chunks", 0), ("chunks", 1), ("chunks", 3), ("split_sum", 1), ("tile_edges", 1),
])
def test_totals_mode_matches_jax_merge(monkeypatch, case, filter_t):
    """fused_merge_query: each k-mer's partial counts summed across chunks,
    the global filter, the probe stream slot for slot and n_unique; a group
    split across chunks whose total passes the filter only summed."""
    if case == "chunks":
        outs = _chunk_a("mixed")
        cap = max(int(o[3]) for o in outs) + 64
        comps = [jf.compact_sorted(o[0], o[1], o[2], cap=cap) for o in outs]
        lo_c, hi_c, qc_c = (np.stack([np.asarray(c[i]) for c in comps]) for i in range(3))
    else:
        if case == "split_sum":
            s, qc_c = _split_sum_chunks()
        else:
            s, w = ts.run_counts_case("tile_edges")
            s, qc_c = s.reshape(2, -1), w.reshape(2, -1)
        lo_c, hi_c = _limbs(s)
        lo_c, hi_c = lo_c.reshape(s.shape), hi_c.reshape(s.shape)
    jseen = _record_jax_stream(monkeypatch)
    jout = jf.fused_merge_query.__wrapped__(
        None, None, None, None, None, None, jnp.asarray(lo_c), jnp.asarray(hi_c),
        jnp.asarray(qc_c), k=K, filter_t=filter_t, **GEO)
    tseen = _record_port_stream(monkeypatch)
    keys = _keys(lo_c.reshape(-1), hi_c.reshape(-1)).reshape(lo_c.shape)
    tout = tf.fused_merge_query(None, None, None, None, None, keys,
                                torch.from_numpy(np.ascontiguousarray(qc_c)), k=K,
                                filter_t=filter_t, **GEO)
    _assert_stream(tseen, jseen)
    assert int(tout[5]) == int(jout[5])
    if case == "split_sum":
        kept = {int(k): int(q) for k, q in zip(tseen["s"], tseen["qc"]) if q}
        assert kept == {10: 2, 30: 2, 40: 3}


@pytest.mark.parametrize("kind,filter_t", [
    ("mixed", 0), ("mixed", 1), ("mixed", 3), ("deep", 1), ("all_sent", 0),
])
def test_compact_mode_matches_jax_extract_count(kind, filter_t):
    """extract_count: the kept k-mers' limbs and counts first, in key order,
    then a zero tail to N, and n_unique."""
    w, lens, vb = _reads(kind)
    jpk, jqc, jn = je.extract_count(jnp.asarray(w), jnp.asarray(lens), jnp.asarray(vb), k=K,
                                    L=L, filter_t=filter_t)
    pk, qc, n = te.extract_count(*_torch(w, lens, vb), k=K, L=L, filter_t=filter_t)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jpk).view(np.int32))
    np.testing.assert_array_equal(qc.numpy(), np.asarray(jqc))
    assert int(n) == int(jn)
    assert not pk[int(n):].any() and not qc[int(n):].any()  # the zero tail
    assert (int(n) > 0) == (kind != "all_sent")


@pytest.mark.parametrize("cap", [64, 8192])
def test_count_histogram_on_deep_runs_matches_jax(cap):
    """count_histogram with runs past kernel F's tile (4,201 copies of the
    repeated read's k-mers), clipped into the top bin at cap 64 and counted
    apart at 8,192."""
    w, lens, vb = _reads("deep")
    want = je.count_histogram(jnp.asarray(w), jnp.asarray(lens), jnp.asarray(vb), k=K, L=L,
                              cap=cap)
    got = te.count_histogram(*_torch(w, lens, vb), k=K, L=L, cap=cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[min(4201, cap - 1)]) > 0


# -- every mode on kernel F's edge cases, against a numpy reference ----------------


@pytest.mark.parametrize("name", ts.RUN_COUNTS_CASES)
def test_twin_matches_reference_on_edge_cases(name):
    """Every mode on keys whose runs cross tiles, end on a tile's last slot,
    span many tiles as SENT, or sit at the ends of int64, where every slot
    is kept or hundreds of tiles keep nothing, partition at caps from 0 to
    P: run_counts on CPU
    tensors (the twin, no launch) equals tests/torch_support.py::
    run_counts_ref."""
    s, w = ts.run_counts_case(name)
    st, wt = torch.from_numpy(s), torch.from_numpy(w)
    qc = te.run_counts_plain(st, mode="select")[1]
    n = int((qc != 0).sum())
    calls = [("select", None, dict(filter_t=ft, rounds=min(3, (ft + 1).bit_length() - 1)))
             for ft in (0, 1, 3, 7, 15)]
    calls += [("select", None, {}), ("select", wt, dict(filter_t=1)),
              ("select", wt, dict(filter_t=6)), ("compact", None, dict(filter_t=0)),
              ("compact", None, dict(filter_t=3))]
    calls += [("partition", qc, dict(cap=c))
              for c in (0, n // 3, max(n - 7, 0), n, n + 9, len(s))]
    before = te.run_counts.launches
    for mode, ww, kw in calls:
        got = te.run_counts(st, ww, mode=mode, **kw)
        want = ts.run_counts_ref(s, None if ww is None else ww.numpy(), mode, **kw)
        np.testing.assert_array_equal(got[0].numpy(), want[0], err_msg=f"{mode} {kw}")
        np.testing.assert_array_equal(got[1].numpy(), want[1], err_msg=f"{mode} {kw}")
        assert int(got[2]) == want[2] and got[2].dtype == torch.int32, (mode, kw)
    assert te.run_counts.launches == before


def test_callers_reach_kernel_f(monkeypatch):
    """Each caller of the reads routes hands its sorted keys to run_counts in
    its mode: fused_search_reads select with the filter and its rounds,
    extract_sorted_counts select with no filter, compact_sorted partition,
    fused_merge_query select with the partial counts as weights,
    extract_count compact, count_histogram select with no filter."""
    calls = []
    real = te.run_counts

    def rec(s, w=None, **kw):
        calls.append((kw["mode"], w is not None, kw.get("filter_t", 0), kw.get("rounds", 0)))
        return real(s, w, **kw)

    monkeypatch.setattr(te, "run_counts", rec)
    monkeypatch.setattr(tf, "run_counts", rec)
    _record_port_stream(monkeypatch)
    args = _torch(*_reads("mixed"))
    tf.fused_search_reads(None, None, None, None, None, *args, k=K, L=L, filter_t=1, d=1, **GEO)
    s, qc, _n = tf.extract_sorted_counts(*args, k=K, L=L, d=1)
    s, qc = tf.compact_sorted(s, qc, cap=4096)
    tf.fused_merge_query(None, None, None, None, None, s[None], qc[None], k=K, filter_t=1, **GEO)
    te.extract_count(*args, k=K, L=L, filter_t=1)
    te.count_histogram(*args, k=K, L=L)
    assert calls == [("select", False, 1, 1), ("select", False, 0, 0),
                     ("partition", True, 0, 0), ("select", True, 1, 0), ("compact", False, 1, 0),
                     ("select", False, 0, 0)]


def test_run_counts_refuses_what_the_kernel_does_not_take():
    s, w = (torch.from_numpy(a) for a in ts.run_counts_case("tiny"))
    bad = (
        (s.to(torch.int32), None, dict(mode="select")),
        (s[::2], None, dict(mode="select")),
        (s, None, dict(mode="compact", rounds=1)),
        (s, w, dict(mode="select", rounds=1)),
        (s, w, dict(mode="compact")),
        (s, None, dict(mode="partition")),
        (s, w.to(torch.int64), dict(mode="select")),
        (s[:-1], None, dict(mode="select", rounds=3)),
        (s, w, dict(mode="partition", cap=-1)),
        (s, None, dict(mode="pairs")),
        (s, None, dict(mode="sort")),
    )
    for keys, ww, kw in bad:
        with pytest.raises(ValueError):
            te.run_counts(keys, ww, **kw)
