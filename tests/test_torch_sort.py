"""The streams' key sort with its payload operands (colorid_tpu_torch/ops/
stream_query.py::sort_payloads, kernel E, on CPU tensors: its plain twin
sort_payloads_plain) against the JAX package's multi-operand sort
(jax.lax.sort((key, *operands), num_keys=1, is_stable=True), as
colorid_tpu/ops/stream_query.py sorts its streams) and against torch.sort
with the operands gathered through its permutation, on the CPU. Integers:
tolerance 0, element for element. The kernel runs only on a CUDA card
(tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu_torch.ops import stream_query as sq
from tests import torch_support as ts


def _args(name):
    key, bits, ops, index, base, index64 = ts.sort_case(name)
    return key, bits, ops, dict(index=index, base=base, index64=index64)


@pytest.mark.parametrize("name", sorted(ts.SORT_CASES))
def test_twin_matches_jax_and_torch_sort(name):
    """The twin (which a CPU tensor takes; no launch) equals lax.sort of the
    key with its operands and the generated index, and torch.sort(stable)
    with the operands gathered: the key, every operand, the index's dtype
    and values."""
    key, bits, ops, kw = _args(name)
    P = key.shape[0]
    before = sq.sort_payloads.launches
    got = sq.sort_payloads(torch.from_numpy(key), bits, [torch.from_numpy(o) for o in ops],
                           **kw)
    assert sq.sort_payloads.launches == before
    idx = ts.sort_index(P, kw["base"], kw["index64"]) if kw["index"] else None
    streams = [key, *ops] + ([idx] if idx is not None else [])
    assert len(got) == len(streams)
    want = jax.lax.sort(tuple(jnp.asarray(a) for a in streams), num_keys=1, is_stable=True)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.from_numpy(streams[i]).dtype, i
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"stream {i}")
    perm = torch.sort(torch.from_numpy(key), stable=True).indices
    for i, (g, a) in enumerate(zip(got, streams)):
        np.testing.assert_array_equal(g.numpy(), a[perm.numpy()], err_msg=f"stream {i}")


@pytest.mark.parametrize("bits", range(1, 32))
def test_passes_cover_the_key(bits):
    """The digit widths E takes: ceil(bits / 10) digits that sum to bits,
    none wider than 10 and none two bits narrower than another."""
    w = sq.sort_passes(bits)
    assert sum(w) == bits and len(w) == -(-bits // sq.SORT_DIGIT_BITS)
    assert max(w) <= sq.SORT_DIGIT_BITS and max(w) - min(w) <= 1


@pytest.mark.parametrize("bits", [21, 26, 30])
def test_digit_runs_fill_a_sector(bits):
    """At the main cell's keys (30 bits blocked, 26 the classic rows, 21
    past 2^20 blocks) a digit's run in a tile of _SORT_TILE uniform keys
    averages 8 keys or more, a 32-byte sector of int32: the width the tile
    was sized for; and the tile's 16-bit places and the kernel's 30-bit
    counts hold."""
    for w in sq.sort_passes(bits):
        assert sq._SORT_TILE >> w >= 8
    assert sq._SORT_TILE < 2**16 and sq.SORT_MAX_KEYS < 2**30


@pytest.mark.parametrize("bloom_size,rpb,qbits,want", [
    (50_000_000, 128, 11, 30),  # the main cell's blocked key: 390,625 blocks << 11
    (50_000_000, 128, 0, 19),  # its block alone
    (50_000_000, 0, None, 26),  # the main cell's classic rows
    (128 * (1 << 20), 128, 11, 31),  # the int32 guard's edge: 2^20 blocks
    (128 * ((1 << 20) + 1), 128, 0, 21),  # past it: the block alone
    (128, 128, 0, 1),  # one block: a key of 0 still takes a pass
])
def test_key_bits_at_the_cells_geometry(bloom_size, rpb, qbits, want):
    if qbits is None:
        assert sq.classic_key_bits(bloom_size) == want
    else:
        assert sq.blocked_key_bits(bloom_size, rpb, qbits) == want
        # the frequency rides in the key where that key fits int32
        assert sq._qc_in_key_ok(bloom_size, rpb) == (want <= (31 if qbits else 20))
    if want in (26, 30):
        # both main-cell keys: three passes, where torch.sort makes four over 32 bits
        assert len(sq.sort_passes(want)) == 3


@pytest.mark.parametrize("digits", [[10, 10, 10], [9, 9, 8]])
def test_passes_are_lsd_stable(digits):
    """Each pass leaves the keys ordered by the digits sorted so far, with
    ties in input order: the stability the next pass relies on, checked
    pass by pass on keys with many ties in every digit."""
    rng = np.random.default_rng(sum(digits))
    bits = sum(digits)
    key = torch.from_numpy(rng.integers(0, 2**bits, 60_000).astype(np.int32) & ~0x3C3C3C3C)
    assert sq.sort_passes(bits) == digits
    idx = torch.arange(key.shape[0], dtype=torch.int32)
    shift = 0
    for w in digits:
        shift += w
        part, pidx = sq.sort_payloads(key & ((1 << shift) - 1), shift, [idx])
        low = part.to(torch.int64)
        assert bool((low[1:] >= low[:-1]).all())
        ties = low[1:] == low[:-1]
        assert bool((pidx[1:][ties] > pidx[:-1][ties]).all())


def test_wrapper_refuses_what_the_kernel_does_not_take():
    k = torch.arange(64, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        sq.sort_payloads(k.to(torch.int64), 8)
    with pytest.raises(ValueError, match="bits"):
        sq.sort_payloads(k, 32)
    with pytest.raises(ValueError, match="outside"):
        sq.sort_payloads(k, 5)  # 63 >= 2^5
    with pytest.raises(ValueError, match="outside"):
        sq.sort_payloads(k - 1, 8)  # a negative key
    with pytest.raises(ValueError, match="at most"):
        sq.sort_payloads(k, 8, [k, k, k], index=True)
    with pytest.raises(ValueError, match="index64"):
        sq.sort_payloads(k, 8, [k], index64=True)
    with pytest.raises(ValueError, match="index64"):
        sq.sort_payloads(k, 8, index=True, base=2**31 - 10, index64=True)
    with pytest.raises(ValueError, match=r"\[P\]"):
        sq.sort_payloads(k, 8, [k[:10]])
