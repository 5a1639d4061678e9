"""Kernel H (colorid_tpu_torch/csrc/readid.cu) on the CPU: the plain twins
that CPU tensors take (ops/query.py::_orderfree_plain, _readid_core_plain,
_readid_firsthit_core_plain) against the JAX package's functions, integer
outputs with no tolerance, and the wrappers' routing and contract checks.

Order-free cases (torch_support.READID_OF_CASES): classic and v1-v4
indexes, H 1-5, C 5 / 21 / 70 (wpad 1 and 4), one and two mates a read,
strides 1 and 2, reads with no window, mates shorter than k, all N, a
homopolymer and mates alike; each read's keys in a shuffled order (every
output is a function of the read's key set); the widest read the reads
route admits; the launch's edges (READID_OF_EDGE_CASES: window counts
about a warp and a block, C 0 / 32 / 33, one color bit, a read all absent)
and its plan (readid_orderfree_plan). Replay and first-hit cases
(READID_EXACT_CASES): B 0 and > 0, padding k-mers on read 0, k-mers in no
order or two reads alternating, C 0 / 32 / 33, H 5, one color bit with a
read all absent, int32 and int64 rows; the
reads route's padding mates (seg -1 -> 0) in the middle of the batch with
int16 and uint8 rank planes. Card tests of the kernel itself:
tests/test_torch_cuda.py -k readid."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu.ops import query as jq
from colorid_tpu_torch.ops import query as tq
from colorid_tpu_torch.ops.extract import pack_reads_any, window_keys
from tests import torch_support as ts

t32 = ts.t32


def _jax_orderfree(blocks, words, vb, lens, kw):
    return np.asarray(jq.query_readid_orderfree_reads(
        jnp.asarray(blocks), jnp.asarray(words), jnp.asarray(lens), jnp.asarray(vb), **kw))


def _torch_orderfree(blocks, words, vb, lens, kw):
    return tq.query_readid_orderfree_reads(t32(blocks), t32(words), torch.from_numpy(lens),
                                           t32(vb), **kw)


@pytest.mark.parametrize("name", sorted(ts.READID_OF_CASES))
def test_orderfree_twin_matches_jax(name):
    blocks, words, vb, lens, kw = ts.readid_orderfree_case(*ts.READID_OF_CASES[name])
    before = dict(tq.readid_launches)
    got = _torch_orderfree(blocks, words, vb, lens, kw)
    assert tq.readid_launches == before  # CPU tensors take the twin
    assert got.dtype == torch.int32 and got.shape == (kw["num_reads"], kw["num_colors"] + 3)
    np.testing.assert_array_equal(got.numpy(), _jax_orderfree(blocks, words, vb, lens, kw))
    C = kw["num_colors"]
    D = got[:, C + 1]
    assert (D[:3] == 0).all() and D[3] == 1 and (got[:3, :C] == 0).all()
    assert D[4:].min() > 1 and got[:, C].any() and not got[:, C].all()


@pytest.mark.parametrize("name", ["classic_h4_c21_nm2_d1", "v4_h4_c21_nm2_d1",
                                  "v2_h4_c70_nm2_d1"])
def test_orderfree_shuffled_windows_give_the_same_outputs(name):
    """The order-free contract: each read's keys in another order (kernel H
    dedups them in a hash set, the twin sorts them) give the JAX outputs."""
    blocks, words, vb, lens, kw = ts.readid_orderfree_case(*ts.READID_OF_CASES[name])
    want = _jax_orderfree(blocks, words, vb, lens, kw)
    R, nm, k, L, d = kw["num_reads"], kw["nm"], kw["k"], kw["L"], kw["d"]
    keys = window_keys(t32(words), torch.from_numpy(lens), t32(vb), k=k, L=L, d=d)
    keys = keys.reshape(R, nm * (L - k + 1))
    g = torch.Generator().manual_seed(3)
    shuffled = torch.stack([row[torch.randperm(row.numel(), generator=g)] for row in keys])
    assert not torch.equal(shuffled, keys)
    geo = {n: kw[n] for n in ("num_colors", "wpad", "k", "num_hash", "bloom_size", "rpb", "bv")}
    for order in (keys, shuffled, shuffled.flip(1)):
        got = tq.readid_orderfree(order.contiguous(), t32(blocks), **geo)
        np.testing.assert_array_equal(got.numpy(), want)


def test_orderfree_widest_read_the_route_admits():
    """Mates of 4,096 bp, two a read: 8,132 windows a read (kernel H's hash
    set of 16,384 slots still fits shared memory at this width)."""
    layout, H, C, nm, d, L = ts.READID_WIDEST
    blocks, words, vb, lens, kw = ts.readid_orderfree_case(layout, H, C, nm, d, L,
                                                           n_reads=6)
    assert nm * (L - kw["k"] + 1) == 8132
    lens[10:] = L  # read 5: both mates whole
    got = _torch_orderfree(blocks, words, vb, lens, kw)
    np.testing.assert_array_equal(got.numpy(), _jax_orderfree(blocks, words, vb, lens, kw))
    assert got[5, C + 1] > 8000


@pytest.mark.parametrize("name", sorted(ts.READID_OF_EDGE_CASES))
def test_orderfree_twin_matches_jax_at_the_launch_edges(name):
    """The order-free launch's edges (window counts about a warp's lanes
    and a block's threads, reads of one round and of several, C 0 / 32 /
    33, H 5, every present row one color bit with a read all absent): the
    twin against the JAX package."""
    case = ts.READID_OF_EDGE_CASES[name]
    blocks, words, vb, lens, kw = ts.readid_orderfree_case(*case, n_reads=ts.READID_EDGE_READS)
    got = _torch_orderfree(blocks, words, vb, lens, kw)
    np.testing.assert_array_equal(got.numpy(), _jax_orderfree(blocks, words, vb, lens, kw))
    C = kw["num_colors"]
    if case[6:] == ("one_color",):  # read 5 all absent; every count on color 2
        assert got[5, C] == 1 and got[5, C + 1] > 100 and not got[5, :C].any()
        assert got[:, 2].sum() > 0 and got[:, :C].sum() == got[:, 2].sum()


# -- the order-free launch plan (ops/query.py::readid_orderfree_plan) ------------

SMEM_MAX = 232_448  # dynamic shared memory a block may take on an H100
PLAN_WR = (1, 31, 32, 33, 256, 257, 260, 320, 321, 1100, 2100, 4096, 8132, 8192, 8193,
           12198, 1 << 20)


@pytest.mark.parametrize("WR", PLAN_WR)
def test_orderfree_plan_fits_the_card(WR):
    """Every plan: a set of 2^s >= 2 WR slots (the least such), at most
    READID_SMEM (and the card's 232,448 bytes) of shared memory a block, the
    set in device memory exactly past READID_SET_SMEM, counts in the output
    row exactly where they do not fit beside the set, a block a read (the
    grid covers every read, or holds a set for each resident block), and
    a round of windows for each READID_THREADS of them."""
    for C in (0, 21, 32, 33, 70, 52_000):
        for R in (1, 29, 8192):
            plan = tq.readid_orderfree_plan(R, WR, C, 132)
            s = plan["set_log2"]
            assert 2 * WR <= 1 << s and (s == 1 or 1 << s < 4 * WR)
            assert plan["gset"] == (WR > 8192) == (8 << s > tq.READID_SET_SMEM)
            smem = 0 if plan["gset"] else 8 << s
            assert plan["cnt_global"] == (smem + 4 * C > tq.READID_SMEM)
            smem += 0 if plan["cnt_global"] else 4 * C
            assert plan["smem"] == smem <= tq.READID_SMEM <= SMEM_MAX
            assert plan["grid"] == (min(R, 2 * 132) if plan["gset"] else R)
            assert plan["rounds"] == -(-WR // tq.READID_THREADS)


def test_orderfree_plan_at_the_dispatch():
    """The [reads] dispatch (8,192 pairs, 2 x 130 windows, C 21): a block a
    read (260 windows: two rounds of 256 threads), 8,276 bytes of shared
    memory, so that six such blocks leave most of an SM's 256 KB to L1."""
    plan = tq.readid_orderfree_plan(8192, 260, 21, 132)
    assert plan["grid"] == 8192 and plan["rounds"] == 2 and plan["set_log2"] == 10
    assert not plan["gset"] and not plan["cnt_global"]
    assert plan["smem"] == 8192 + 84 and 6 * (plan["smem"] + 1024) < 64 * 1024


def test_orderfree_plan_widest_read_the_route_admits():
    """Mates of 4,096 bp, two a read (8,132 windows): its set of 16,384 slots
    stays in shared memory (32 rounds of 256 threads); a third mate puts it
    in device memory."""
    layout, H, C, nm, d, L = ts.READID_WIDEST
    plan = tq.readid_orderfree_plan(6, nm * (L - ts.READID_K + 1), C, 132)
    assert plan["set_log2"] == 14 and plan["rounds"] == 32
    assert not plan["gset"] and not plan["cnt_global"] and plan["smem"] <= SMEM_MAX
    third = tq.readid_orderfree_plan(6, 3 * (L - ts.READID_K + 1), C, 132)
    assert third["gset"] and third["smem"] == 4 * C


def test_orderfree_plan_counts_in_the_row():
    """52,000 colors: their counts (208,000 bytes) do not fit beside a read's
    set, so they live in the output row."""
    plan = tq.readid_orderfree_plan(12, 68, 52_000, 132)
    assert plan["cnt_global"] and plan["smem"] == 8 << plan["set_log2"]


def _exact_args(blocks, rows, seg, pos):
    return t32(blocks), torch.from_numpy(rows), torch.from_numpy(seg), torch.from_numpy(pos)


@pytest.mark.parametrize("name", sorted(ts.READID_EXACT_CASES))
def test_replay_and_firsthit_twins_match_jax(name):
    blocks, rows, seg, pos, kw = ts.readid_exact_case(*ts.READID_EXACT_CASES[name])
    before = dict(tq.readid_launches)
    args = _exact_args(blocks, rows, seg, pos)
    jargs = [jnp.asarray(a) for a in (blocks, rows, seg, pos)]
    if rows.dtype == np.int64:  # the wide twins: the JAX package's (block, lane) split
        blk, lane0 = tq.split_rows_wide(rows, kw["wpad"])
        jargs = [jnp.asarray(blocks), jnp.asarray(blk), jnp.asarray(lane0), jargs[2], jargs[3]]
        targs = (args[0], torch.from_numpy(blk), torch.from_numpy(lane0), *args[2:])
        wkw = {n: v for n, v in kw.items() if n != "rpb"}
        pairs = ((tq.query_readid_batch_wide, jq.query_readid_batch_wide),
                 (tq.query_readid_firsthit_wide, jq.query_readid_firsthit_wide))
        calls = [(tf, jf, targs, wkw) for tf, jf in pairs]
        # and the int64 rows straight into the functions the wide twins call
        calls += [(tq.query_readid_batch, jq.query_readid_batch_wide, args, kw),
                  (tq.query_readid_firsthit, jq.query_readid_firsthit_wide, args, kw)]
    else:
        calls = [(tq.query_readid_batch, jq.query_readid_batch, args, kw),
                 (tq.query_readid_firsthit, jq.query_readid_firsthit, args, kw)]
    for tf, jf, targs, tkw in calls:
        jkw = {n: v for n, v in tkw.items() if n != "rpb"} if "wide" in jf.__name__ else tkw
        want = np.asarray(jf(*jargs, **jkw))
        got = tf(*targs, **tkw)
        assert got.dtype == torch.int32, tf.__name__
        np.testing.assert_array_equal(got.numpy(), want, err_msg=tf.__name__)
    assert tq.readid_launches == before
    C = kw["num_colors"]
    # some reads broke on an absent k-mer, not all; the empty reads never did
    report = tq.query_readid_batch(*args, **kw).numpy()
    assert 0 < report[:, C].sum() < kw["num_reads"] - 8 and not report[-8:].any()


@pytest.mark.parametrize("B", [0, 4])
@pytest.mark.parametrize("rank_dtype", ["int16", "uint8"])
@pytest.mark.parametrize("layout", ["classic", "v4"])
def test_reads_route_padding_mates_in_the_middle(layout, rank_dtype, B):
    """query_readid_reads_batch and query_readid_firsthit_reads with padding
    mates (seg -1, clamped to read 0) between live mates: the seg that the
    replay sees is not sorted."""
    blocks, geo = ts.readid_matrix(layout, 4, 21, seed=5, zero_frac=0.01)
    rng = np.random.default_rng(6)
    L, k, M = 96, 21, 60
    seqs = ts.ACGT[rng.integers(0, 4, (M, L))]
    seqs[9, 30:34] = ord("N")
    w = pack_reads_any(seqs)
    lens = rng.integers(k - 1, L + 1, M).astype(np.int32)
    mseg = np.repeat(np.arange(M // 2), 2).astype(np.int16)
    mseg[20:24] = -1  # padding mates mid-batch: their windows carry read 0
    ranks = rng.integers(-1, 120, (M, L - k + 1)).astype(np.int16)
    if rank_dtype == "uint8":
        ranks = np.where(ranks < 0, 255, ranks).astype(np.uint8)
    kw = dict(geo, num_reads=M // 2, start_sample=B, k=k, L=L)
    before = dict(tq.readid_launches)
    for fn in ("query_readid_reads_batch", "query_readid_firsthit_reads"):
        want = getattr(jq, fn)(jnp.asarray(blocks), jnp.asarray(w), jnp.asarray(mseg),
                               jnp.asarray(lens), jnp.asarray(ranks), **kw)
        got = getattr(tq, fn)(t32(blocks), t32(w), torch.from_numpy(mseg),
                              torch.from_numpy(lens), torch.from_numpy(ranks), **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=fn)
    assert tq.readid_launches == before


def test_hash_batch_twin_matches_jax_on_unsorted_seg():
    """query_readid_hash_batch (int16 seg and pos, -1 = padding) with its
    k-mers in no order."""
    blocks, geo = ts.readid_matrix("classic", 4, 21, seed=7, zero_frac=0.01)
    rng = np.random.default_rng(8)
    N, nr = 2000, 40
    pk = ts.rand_packed(rng, N, 31)
    seg = rng.integers(0, nr, N).astype(np.int16)
    pos = rng.integers(-1, 60, N).astype(np.int16)
    kw = dict(num_reads=nr, start_sample=3, num_colors=21, wpad=geo["wpad"], k=31,
              num_hash=4, bloom_size=geo["bloom_size"])
    want = jq.query_readid_hash_batch(jnp.asarray(blocks), jnp.asarray(pk), jnp.asarray(seg),
                                      jnp.asarray(pos), **kw)
    got = tq.query_readid_hash_batch(t32(blocks), t32(pk), torch.from_numpy(seg),
                                     torch.from_numpy(pos), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the wrappers' routing and contracts ----------------------------------------


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    blocks, rows, seg, pos, kw = ts.readid_exact_case(*ts.READID_EXACT_CASES[
        "classic_h4_c21_b0_sorted"])
    meta = [t.to("meta") for t in _exact_args(blocks, rows, seg, pos)]
    with pytest.raises(ValueError, match="unsupported device"):
        tq.readid_exact(*meta, **kw)
    keys = torch.zeros((4, 8), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tq.readid_orderfree(keys, meta[0], num_colors=21, wpad=1, k=31, num_hash=4,
                            bloom_size=4096)


def _exact_breach(name):
    """(arguments, keywords) of a replay call that breaks kernel H's contract
    in one way."""
    blocks, rows, seg, pos, kw = ts.readid_exact_case(*ts.READID_EXACT_CASES[
        "classic_h4_c21_b0_sorted"])
    b2, r, s, p = _exact_args(blocks, rows, seg, pos)
    kw = dict(kw)
    if name == "int16_seg":
        s = s.to(torch.int16)
    elif name == "short_pos":
        p = p[:-1]
    elif name == "int16_rows":
        r = r.to(torch.int16)
    elif name == "strided_rows":
        r = torch.cat([r, r], dim=1)[:, ::2]
    elif name == "narrow_matrix":
        b2 = b2.reshape(-1, 64)
    elif name == "colors_past_wpad":
        kw["num_colors"] = 33
    elif name == "rpb_past_block":
        kw["rpb"] = 256
    elif name == "negative_reads":
        kw["num_reads"] = -1
    elif name == "hashes_past_32":
        r = r[:, :1].repeat(1, 33)
    return (b2, r, s, p), kw


EXACT_BREACHES = ("int16_seg", "short_pos", "int16_rows", "strided_rows", "narrow_matrix",
                  "colors_past_wpad", "rpb_past_block", "negative_reads", "hashes_past_32")


@pytest.mark.parametrize("name", EXACT_BREACHES)
def test_replay_contract_check_names_the_breach(name):
    (b2, r, s, p), kw = _exact_breach(name)
    kw.pop("start_sample")
    with pytest.raises(ValueError, match="readid_exact"):
        tq._check_exact(b2, r, s, p, **kw)


def _orderfree_breach(name):
    blocks, words, vb, lens, kw = ts.readid_orderfree_case(*ts.READID_OF_CASES[
        "v4_h4_c21_nm2_d1"])
    R, WR = kw["num_reads"], kw["nm"] * (kw["L"] - kw["k"] + 1)
    keys = window_keys(t32(words), torch.from_numpy(lens), t32(vb), k=kw["k"], L=kw["L"])
    keys = keys.reshape(R, WR)
    b2 = t32(blocks)
    geo = {n: kw[n] for n in ("num_colors", "wpad", "k", "num_hash", "bloom_size", "rpb", "bv")}
    if name == "int32_keys":
        keys = keys.to(torch.int32)
    elif name == "strided_keys":
        keys = keys[:, ::2]
    elif name == "no_windows":
        keys = keys[:, :0]
    elif name == "hashes_past_32":
        geo.update(num_hash=33, rpb=0, bv=1)
    elif name == "k_past_32":
        geo["k"] = 33
    elif name == "rows_past_matrix":
        geo["bloom_size"] = 2 * b2.numel()
    elif name == "colors_past_wpad":
        geo["num_colors"] = 40
    return keys, b2, geo


ORDERFREE_BREACHES = ("int32_keys", "strided_keys", "no_windows", "hashes_past_32",
                      "k_past_32", "rows_past_matrix", "colors_past_wpad")


@pytest.mark.parametrize("name", ORDERFREE_BREACHES)
def test_orderfree_contract_check_names_the_breach(name):
    keys, b2, geo = _orderfree_breach(name)
    with pytest.raises(ValueError, match="readid_orderfree|k in 4..32"):
        tq._check_orderfree(keys, b2, **geo)


def test_contract_checks_pass_the_routes_own_inputs():
    """The checks take what the read classifier's callers hand the kernel."""
    for name in sorted(ts.READID_EXACT_CASES):
        blocks, rows, seg, pos, kw = ts.readid_exact_case(*ts.READID_EXACT_CASES[name])
        kw.pop("start_sample")
        tq._check_exact(*_exact_args(blocks, rows, seg, pos), **kw)
    keys, b2, geo = _orderfree_breach("none")
    tq._check_orderfree(keys, b2, **geo)
