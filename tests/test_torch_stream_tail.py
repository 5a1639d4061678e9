"""The blocked probe stream's glue (colorid_tpu_torch/ops/stream_query.py:
stream_accumulate_hash[_exact], _stream_core and the fused reads path's
_probe) against the JAX package's (stream_accumulate_hash[_exact],
_stream_core, with its Pallas kernel in interpret mode) on the same seeded
inputs, on the CPU. Both routes of the port run: the twins' route
(_stream_core_plain, which a CPU tensor takes) and the card's route
(kernel A's packed mode, kernel E's sort of the key with its payloads,
kernel D's plan on the sorted streams, the probe kernel, the rest of
kernel D and the epilogue) with every wrapper on its plain twin. Everything is an integer:
tolerance 0, element for element, the overflow list in order, n_drop
included. The kernels themselves run only on a CUDA card
(tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu.ops import stream_query as jsq
from colorid_tpu.ops.hash_jax import _v3_blkoff as j_v3_blkoff
from colorid_tpu_torch.ops import fused_reads as tfr
from colorid_tpu_torch.ops import stream_query as tsq
from colorid_tpu_torch.ops.extract import _sort_key
from colorid_tpu_torch.ops.hash_torch import placement_keyoff
from tests import torch_support as ts

NAMES = ("stats", "hist", "over_col", "over_freq", "n_drop")


def _accs(C, wpad, capO, n_over):
    # the AND words start all ones: the JAX package replaces them where the
    # port ANDs into them (test_torch_stream_engine.py pins that)
    return ts.epi_accs(C, wpad, capO, n_over, seed=0)


def _jax(geo, blocks, pk, qc, mode, accs, base0):
    jb = jnp.asarray(blocks)
    args = (*(jnp.asarray(a) for a in accs), jb, jsq.byte_plane_blocks(jb), jnp.asarray(pk))
    if mode == "clipped":
        return jsq.stream_accumulate_hash(
            *args, jnp.asarray(qc.astype(np.uint16)), jnp.int32(base0), **geo)
    return jsq.stream_accumulate_hash_exact(
        *args, jnp.asarray(qc), qc_in_key=mode == "exact_key", **geo)


def _same(got, want):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def _residual_counts(geo, blocks, pk, qc):
    """Per chunk, its counted probes outside the chunk's window."""
    blk_s, _off_s, qc_s, _perm = tsq._sorted_probes_plain(
        ts.t32(pk), torch.from_numpy(qc), qbits=0, qmin=None, qmax=None, k=geo["k"],
        num_hash=geo["num_hash"], bloom_size=geo["bloom_size"], rpb=geo["rpb"], bv=geo["bv"])
    _tb, inwin2d = tsq.stream_plan(blk_s, blocks.shape[0], geo["wpad"])
    return (~inwin2d & (qc_s.view(-1, tsq.PC) > 0)).sum(dim=1, dtype=torch.int32), qc_s


@pytest.mark.parametrize("name", sorted(ts.STREAM_TAIL_CASES))
def test_both_routes_match_jax(name, monkeypatch):
    """Each case through the JAX package, the port's public function (the
    twins' route) and the card's route with its twins: every accumulator
    and n_drop equal. 'skip' has no residual and no big probe; 'sparse'
    has more residual chunks than the capacity (patched to 2), so n_drop >
    0; 'past_nch' more than the real capacity of 128; 'overflow' has more
    big probes than OVER_CAP (patched to 300) from an overflow list that
    starts at 200 and runs past capO; 'overflow_tiles' big probes in 40
    tiles past OVER_CAP (patched to 2,000) from 3,500 of capO 5,000;
    'big_last_tile' big probes only in the last tile."""
    geo, blocks, pk, qc, mode = ts.stream_tail_case(name)
    C, W = geo["n_colors"], geo["wpad"]
    capO, n_over, base0 = pk.shape[0], 0, 4096
    caps = ts.patch_tail_caps(name, monkeypatch, (tsq, jsq))
    if caps:
        capO, n_over = caps
    accs = _accs(C, W, capO, n_over)
    want = _jax(geo, blocks, pk, qc, mode, accs, base0)
    plain = tsq.stream_accumulate_hash(
        *(torch.from_numpy(a.copy()) for a in accs), ts.t32(blocks), ts.t32(pk),
        torch.from_numpy(qc), base0, **geo,
    ) if mode == "clipped" else tsq.stream_accumulate_hash_exact(
        *(torch.from_numpy(a.copy()) for a in accs), ts.t32(blocks), ts.t32(pk),
        torch.from_numpy(qc), qc_in_key=mode == "exact_key", **geo,
    )
    _same(plain, want)
    launches = (tsq.stream_chunk_plan.launches, tsq.stream_tail.launches)
    _same(ts.stream_tail_run(geo, blocks, pk, qc, mode, accs, "cpu", True, base0), want)
    assert launches == (tsq.stream_chunk_plan.launches,
                        tsq.stream_tail.launches)  # CPU tensors: the twins

    stats = plain[0].numpy()
    n_res, qc_s = _residual_counts(geo, blocks, pk, qc)
    n_big_before = int(stats[C + W + 1]) - n_over
    if name == "skip":
        assert int(n_res.sum()) == 0 and n_big_before == 0 and int(plain[4]) == 0
        # absent rows among the counted probes: n_valid < n_real
        assert stats[C + W] == 0
    else:
        assert n_big_before > 0
        dense = ("overflow", "overflow_tiles", "big_last_tile")
        assert (int(n_res.sum()) > 0) == (name not in dense)
    if name == "sparse":
        assert int((n_res > 0).sum()) > 2 and int(plain[4]) > 0
    if name == "past_nch":
        has = (n_res > 0).nonzero().view(-1)
        assert has.numel() > 128 and int(n_res[has[128:]].sum()) == int(plain[4]) > 0
    if name == "overflow":
        # n_over advanced by OVER_CAP, the big probes beyond it in n_drop
        assert n_big_before == 300 and int(plain[4]) > 0
        assert int(stats[C + W + 1]) > capO  # the list ran past capO
    if name == "overflow_tiles":
        big_tiles = (qc_s.view(-1, 2048) >= ts.BIG_FREQ).any(dim=1)
        assert int(big_tiles.sum()) == big_tiles.numel() == 40
        assert n_big_before == 2000 and int(plain[4]) > 0
        assert int(stats[C + W + 1]) > capO
    if name == "big_last_tile":
        big = (qc_s >= ts.BIG_FREQ).nonzero().view(-1)
        assert int(big.min()) >= qc_s.numel() - 2048 and int(plain[4]) == 0
    if name == "one_chunk":
        assert pk.shape[0] == tsq.PC


@pytest.mark.parametrize("name", ["past_nch", "sparse", "w2_h4"])
def test_plan_list_matches_the_jax_formulas(name):
    """Kernel D1's list (its twin here) against the JAX package's own
    formulas on each chunk's residual probes (colorid_tpu/ops/
    stream_query.py: covered = has_res & cumsum(has_res) <= nch, the list
    jnp.nonzero(has_res, size=nch), n_drop_res = n_res - n_proc), at the
    real capacity: cidx (-1 where the JAX list holds its fill value
    n_chunks), n_cov and the residual probes past the list; n_real the
    probes in their window."""
    geo, blocks, pk, qc, _mode = ts.stream_tail_case(name)
    n_res, _qc_s = _residual_counts(geo, blocks, pk, qc)
    blk_s, off_s, qc_s, _perm = tsq._sorted_probes_plain(
        ts.t32(pk), torch.from_numpy(qc), qbits=0, qmin=None, qmax=None, k=geo["k"],
        num_hash=geo["num_hash"], bloom_size=geo["bloom_size"], rpb=geo["rpb"], bv=geo["bv"])
    W = geo["wpad"]
    plan = tsq.stream_chunk_plan(blocks.shape[0], W, blk_s=blk_s, off_s=off_s, qc_s=qc_s)
    cidx, meta = plan[4].numpy(), plan[5].numpy()
    nch, n_chunks = jsq._nch(W), n_res.shape[0]
    chunk_res = jnp.asarray(n_res.numpy())
    has_res = chunk_res > 0
    covered = has_res & (jnp.cumsum(has_res.astype(jnp.int32)) <= nch)
    n_proc = jnp.sum(chunk_res * covered.astype(jnp.int32))
    jlist = np.asarray(jnp.nonzero(has_res, size=nch, fill_value=n_chunks)[0])
    n_cov = int(covered.sum())
    np.testing.assert_array_equal(cidx, np.where(jlist < n_chunks, jlist, -1)[:len(cidx)])
    assert list(meta) == [int((plan[3] > 0).sum()), n_cov, int(chunk_res.sum() - n_proc)]
    assert (meta[2] > 0) == (name == "past_nch")  # 'sparse' fits 128 chunks


def test_fused_probe_matches_jax():
    """The fused reads path's _probe (kernel A's packed mode on sorted int64
    keys, the block as the key, then _stream_core) on key-sorted slots with
    repeats and SENT_KEY padding, against JAX's _v3_blkoff and _stream_core:
    through the twins' route and through the card's with its twins."""
    geo, blocks, pk, _qc, _mode = ts.stream_tail_case("w2_h4")
    geo = dict(geo, bv=4)
    C, W = geo["n_colors"], geo["wpad"]
    rng = np.random.default_rng(7)
    p = torch.from_numpy(pk.astype(np.int64))
    keys = _sort_key(p[:, 0], p[:, 1])
    keys[-1000:] = tfr.SENT_KEY
    s = torch.sort(keys).values
    qc = torch.from_numpy(rng.integers(0, 3000, s.shape[0]).astype(np.int32))
    qc[-1000:] = 0
    capO = s.shape[0]
    accs = _accs(C, W, capO, 0)
    kw = dict(k=31, wpad=W, num_hash=geo["num_hash"], bloom_size=geo["bloom_size"],
              rpb=geo["rpb"], n_colors=C, bv=4)
    got = [torch.from_numpy(a.copy()) for a in accs]
    n_drop = tfr._probe(*got, ts.t32(blocks), s, qc, **kw)

    lo = (s & 0xFFFFFFFF).numpy().astype(np.uint32)
    hi = ((s >> 32) + 2**31).numpy().astype(np.uint32)
    blk, offs = j_v3_blkoff(jnp.asarray(lo), jnp.asarray(hi), 31, geo["num_hash"],
                            geo["bloom_size"], geo["rpb"], version=4)
    jb = jnp.asarray(blocks)
    jq = jnp.asarray(qc.numpy())
    want = jsq._stream_core(
        *(jnp.asarray(a) for a in accs), jb, jsq.byte_plane_blocks(jb), blk,
        jsq.pack_offsets(offs), jq, jq, wpad=W, num_hash=geo["num_hash"],
        rpb=geo["rpb"], n_colors=C,
    )
    _same((*got, n_drop), want)
    assert int(got[0][C + W + 1]) > 0

    blk_s, off_s = placement_keyoff(s, None, k=31, num_hash=geo["num_hash"],
                                    bloom_size=geo["bloom_size"], rpb=geo["rpb"], version=4)
    plan = tsq.stream_chunk_plan(blocks.shape[0], W, blk_s=blk_s, off_s=off_s, qc_s=qc)
    acc2 = [torch.from_numpy(a.copy()) for a in accs]
    out = tsq._stream_core_kernels(*acc2, ts.t32(blocks), plan, qc, wpad=W,
                                   num_hash=geo["num_hash"], rpb=geo["rpb"], n_colors=C)
    _same(out, want)


@pytest.mark.parametrize("n_blocks", [1 << 20, (1 << 20) + 1])
def test_int32_key_gives_the_int64_keys_permutation(n_blocks):
    """Kernel A's packed key at the int32 guard's edge (rpb 128, v4 H 4, the
    largest k-mer value in the last block): at 2^20 blocks the int32 key
    holds the int64 key block << 11 | qc, so kernel E's sort (its twin
    here) gives the int64 keys' stable permutation; at 2^20 + 1 the guard
    takes the frequency out of the key, kernel A refuses it in the key (an
    int32 key would wrap negative and sort first), and the block alone,
    sorted with the offsets and the frequencies as operands, gives the same
    blocks and, inside each block, the k-mer order."""
    rng = np.random.default_rng(n_blocks % 97)
    n = 20_000
    pk = ts.rand_packed(rng, n)
    pk[-1] = (0xFFFFFFFF, 0x3FFFFFFF)  # 4^31 - 1: the last block
    qc = torch.from_numpy(rng.integers(0, 3000, n).astype(np.int32))
    geo = dict(k=31, num_hash=4, bloom_size=n_blocks * 128, rpb=128, version=4)
    kw = dict(geo, qbits=tsq.QKEY_BITS, qmin=None, qmax=tsq.FREQ_CAP)
    blk, off = placement_keyoff(ts.t32(pk), None, **geo)
    assert int(blk[-1]) == n_blocks - 1
    key64 = (blk.to(torch.int64) << tsq.QKEY_BITS) | qc.clamp(max=tsq.FREQ_CAP)
    perm64 = torch.sort(key64, stable=True).indices
    ok = tsq._qc_in_key_ok(n_blocks * 128, 128)
    assert ok == (n_blocks == 1 << 20)
    bits = tsq.blocked_key_bits(n_blocks * 128, 128, tsq.QKEY_BITS if ok else 0)
    if ok:
        key32, off32 = placement_keyoff(ts.t32(pk), qc, **kw)
        assert key32.dtype == torch.int32 and torch.equal(off32, off)
        assert torch.equal(key32.to(torch.int64), key64) and bits == 31
        key_s, off_s = tsq.sort_payloads(key32, bits, [off32])
        assert torch.equal(key_s.to(torch.int64), key64[perm64])
        assert torch.equal(off_s, off[perm64])
    else:
        with pytest.raises(ValueError, match="fit int32"):
            placement_keyoff(ts.t32(pk), qc, **kw)
        assert bits == 21
        blk_s, off_s, qc_s = tsq.sort_payloads(blk, bits, [off, qc])
        perm = torch.sort(blk, stable=True).indices
        assert torch.equal(blk_s, blk[perm]) and torch.equal(off_s, off[perm])
        assert torch.equal(qc_s, qc[perm])
        assert torch.equal(blk_s.to(torch.int64), key64[perm64] >> tsq.QKEY_BITS)


def test_frequency_out_of_the_key_with_a_global_index_matches_jax(monkeypatch):
    """Where the frequency does not fit the key (``_qc_in_key_ok`` false,
    patched in both packages), clipped mode sorts the block with three
    operands (offsets, frequencies, the index from base0): the card's route
    with its twins and the twins' route equal the JAX package's
    stream_accumulate_hash."""
    geo, blocks, pk, qc, _mode = ts.stream_tail_case("w2_h4")
    P = 5 * tsq.PC  # a batch shape no other test traces
    pk, qc = pk[:P], qc[:P]
    for m in (tsq, jsq):
        monkeypatch.setattr(m, "_qc_in_key_ok", lambda bloom_size, rpb: False)
    calls = []
    real = tsq.sort_payloads

    def recorded(*a, **kw):
        calls.append((a[1], len(a[2]), kw))
        return real(*a, **kw)

    monkeypatch.setattr(tsq, "sort_payloads", recorded)
    accs = _accs(geo["n_colors"], geo["wpad"], P, 0)
    want = _jax(geo, blocks, pk, qc, "clipped", accs, 4096)
    _same(ts.stream_tail_run(geo, blocks, pk, qc, "clipped", accs, "cpu", True), want)
    _same(ts.stream_tail_run(geo, blocks, pk, qc, "clipped", accs, "cpu", False), want)
    bits = tsq.blocked_key_bits(geo["bloom_size"], geo["rpb"], 0)
    assert calls == [(bits, 2, dict(index=True, base=4096))]


@pytest.mark.parametrize("key64", [False, True])
def test_key_width_gives_the_same_answers(key64, monkeypatch):
    """Past 2^20 blocks (``_qc_in_key_ok`` false, patched in the port only:
    key64) the port sorts the block alone where the JAX package's int64 key
    still carries the frequency; on the 'w2_h4' batch in clipped mode both
    of the port's routes give the JAX package's answers either way."""
    geo, blocks, pk, qc, _mode = ts.stream_tail_case("w2_h4")
    monkeypatch.setattr(tsq, "_qc_in_key_ok", lambda bloom_size, rpb: not key64)
    assert jsq._qc_in_key_ok(geo["bloom_size"], geo["rpb"])
    accs = _accs(geo["n_colors"], geo["wpad"], pk.shape[0], 0)
    want = _jax(geo, blocks, pk, qc, "clipped", accs, 4096)
    _same(ts.stream_tail_run(geo, blocks, pk, qc, "clipped", accs, "cpu", False), want)
    _same(ts.stream_tail_run(geo, blocks, pk, qc, "clipped", accs, "cpu", True), want)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    geo, blocks, pk, qc, _mode = ts.stream_tail_case("one_chunk")
    z = torch.zeros(tsq.PC, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of"):
        tsq.stream_chunk_plan(1024, 2, blk_s=z[:100], off_s=z[:100], qc_s=z[:100])
    with pytest.raises(TypeError, match="int32"):
        tsq.stream_chunk_plan(1024, 2, blk_s=z.to(torch.int64), off_s=z, qc_s=z)
    with pytest.raises(ValueError, match="qbits"):
        tsq.stream_chunk_plan(1024, 2, key_s=z, off_s=z, qbits=0)
    with pytest.raises(ValueError, match="num_hash"):
        placement_keyoff(ts.t32(pk), None, k=31, num_hash=8, bloom_size=65536, rpb=64,
                         version=2)
    with pytest.raises(ValueError, match="qcounts"):
        placement_keyoff(ts.t32(pk), None, k=31, num_hash=2, bloom_size=65536, rpb=64,
                         version=2, qbits=11)
    accs = [torch.from_numpy(a) for a in _accs(40, 2, 64, 0)]
    blk_s, off_s, qc_s, qcw, cidx, meta = tsq.stream_chunk_plan(blocks.shape[0], 2, blk_s=z,
                                                                off_s=z, qc_s=z)
    tail = (torch.zeros(64, dtype=torch.int32), torch.zeros((64, 1024), dtype=torch.int32),
            blk_s, off_s, qc_s, qcw, z, cidx, meta)
    b = ts.t32(blocks)
    kw = dict(wpad=2, num_hash=2, rpb=64, n_colors=40)
    with pytest.raises(ValueError, match="out of shape"):  # counts of one word
        tsq.stream_tail(*accs, b, z, tail[0][:32], *tail[1:], **kw)
    with pytest.raises(ValueError, match="out of shape"):  # a list of another capacity
        tsq.stream_tail(*accs, b, z, *tail[:7], cidx[:0], meta, **kw)
    out = tsq.stream_tail(*accs, b, z, *tail, **kw)  # the twin on what the plan gave
    assert out[0].shape == (tsq.PC, 2) and int(out[5]) == 0
