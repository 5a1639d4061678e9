"""The placement wrapper (colorid_tpu_torch/ops/hash_torch.py::placement,
csrc/placement.cu's twin on the CPU) against the JAX package: the classic
rows of its host XXH3 for every k in 4..32 and bloom sizes up to 2^31 - 1,
and of hash_jax.bloom_rows_device on each XXH3 length class; the blocked
placements v1-v4 of ops/blocked.py (blocked_rows_host, v3_block_offsets);
from packed k-mers and from sort keys. Integers throughout: exact
equality. Its refusals, and no kernel launch on the CPU."""

import numpy as np
import pytest
import torch

from colorid_tpu.hashing import xxh3 as jxxh3
from colorid_tpu.ops import blocked as jblocked
from colorid_tpu.ops import hash_jax
from colorid_tpu_torch.ops import extract as te
from colorid_tpu_torch.ops import hash_torch as ht
from tests import torch_support as ts

BLOOMS = (1_000_003, 50_000_000, 2**31 - 1)


def _keys(k: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).choice(ts.ACGT, size=(n, k))


def _packed(keys: np.ndarray) -> torch.Tensor:
    return ts.t32(ht.pack_keys_host(keys))


def _sort_keys(keys: np.ndarray) -> torch.Tensor:
    """The same k-mers as ops/extract.py's int64 sort keys."""
    p = torch.from_numpy(ht.pack_keys_host(keys).astype(np.int64))
    return te._sort_key(p[:, 0], p[:, 1])


GRID_K = [4, 7, 8, 9, 15, 16, 17, 27, 31, 32]  # each XXH3 length class and its edges


@pytest.mark.parametrize("k", range(4, 33))
def test_classic_rows_match_jax_host_hasher(k):
    """Every k against the JAX package's host XXH3 (hashing/xxh3.py, the
    hasher its device rows are held against), at each bloom size."""
    keys = _keys(k, 300, seed=k)
    before = ht.placement.launches
    for bloom in BLOOMS:
        want = jxxh3.bloom_rows_batch(keys, 4, bloom).astype(np.int32)
        for H in (1, 2, 4):
            got = ht.placement(_packed(keys), k=k, num_hash=H, bloom_size=bloom)
            assert got.dtype == torch.int32 and got.shape == (300, H)
            np.testing.assert_array_equal(got.numpy(), want[:, :H])
    assert ht.placement.launches == before  # the CPU takes the twin


@pytest.mark.parametrize("k", GRID_K)
def test_classic_rows_match_jax_device_hasher(k):
    """hash_jax.bloom_rows_device at bloom_size 2^31 - 1, from packed
    k-mers and from sort keys."""
    keys = _keys(k, 300, seed=50 + k)
    bloom = 2**31 - 1
    want = np.asarray(hash_jax.bloom_rows_device(
        ht.pack_keys_host(keys), k=k, num_hash=4, bloom_size=bloom))
    for src in (_packed(keys), _sort_keys(keys)):
        got = ht.placement(src, k=k, num_hash=4, bloom_size=bloom)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", GRID_K)
@pytest.mark.parametrize("version", [1, 2, 3, 4])
def test_blocked_placement_matches_jax_host(k, version):
    keys = _keys(k, 400, seed=100 * version + k)
    for H in (1, 2, 4, 8):
        for bloom, rpb in ((375_000, 128), (2**31 - 1, 64)):
            want = jblocked.blocked_rows_host(keys, H, bloom, rpb, version=version)
            for src in (_packed(keys), _sort_keys(keys)):
                kw = dict(k=k, num_hash=H, bloom_size=bloom, rpb=rpb, version=version)
                rows = ht.placement(src, **kw)
                assert rows.dtype == torch.int32 and rows.shape == (400, H)
                np.testing.assert_array_equal(rows.numpy(), want)
                block, offs = ht.placement(src, blkoff=True, **kw)
                assert block.dtype == torch.int64 and len(offs) == H
                got = block.numpy()[:, None] * rpb + torch.stack(offs, 1).numpy()
                np.testing.assert_array_equal(got, want)
                if version >= 3:
                    jb, jo = jblocked.v3_block_offsets(
                        jblocked.pack_keys_u64(keys), k, H, bloom, rpb, version=version)
                    np.testing.assert_array_equal(block.numpy(), jb)
                    np.testing.assert_array_equal(torch.stack(offs, 1).numpy(), jo)


def test_entries_reach_the_wrapper(monkeypatch):
    """bloom_rows_device, device_blkoff and device_rows are the wrapper."""
    calls = []
    real = ht.placement
    monkeypatch.setattr(ht, "placement", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    pk = _packed(_keys(31, 64, seed=1))
    ht.bloom_rows_device(pk, k=31, num_hash=4, bloom_size=1000)
    ht.device_blkoff(pk, k=31, num_hash=4, bloom_size=128_000, rpb=128, version=4)
    ht.device_rows(pk, k=31, num_hash=4, bloom_size=128_000, rpb=128, version=2)
    assert [c.get("blkoff", False) for c in calls] == [False, True, False]


def test_placement_refuses_what_the_kernel_does_not_take():
    pk = _packed(_keys(31, 16, seed=2))
    kw = dict(k=31, num_hash=4, bloom_size=1000)
    with pytest.raises(TypeError, match="packed int32"):
        ht.placement(pk.to(torch.int64), **kw)
    with pytest.raises(TypeError, match="packed int32"):
        ht.placement(torch.zeros((16, 3), dtype=torch.int32), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ht.placement(torch.zeros((2, 16), dtype=torch.int32).t(), **kw)
    with pytest.raises(ValueError, match="k in 4..32"):
        ht.placement(pk, k=33, num_hash=4, bloom_size=1000)
    with pytest.raises(ValueError, match="k in 4..32"):
        ht.placement(pk, k=3, num_hash=4, bloom_size=1000)
    with pytest.raises(ValueError, match="2\\^31"):
        ht.placement(pk, k=31, num_hash=4, bloom_size=2**31)
    with pytest.raises(ValueError, match="num_hash"):
        ht.placement(pk, k=31, num_hash=0, bloom_size=1000)
    with pytest.raises(ValueError, match="power of two"):
        ht.placement(pk, k=31, num_hash=4, bloom_size=128_000, rpb=96)
    with pytest.raises(ValueError, match="version"):
        ht.placement(pk, k=31, num_hash=4, bloom_size=128_000, rpb=128, version=5)
    with pytest.raises(ValueError, match="num_hash <= rpb"):
        ht.placement(pk, k=31, num_hash=8, bloom_size=128_000, rpb=4, version=2)
    with pytest.raises(ValueError, match="blkoff"):
        ht.placement(pk, blkoff=True, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        ht.placement(torch.empty((16, 2), dtype=torch.int32, device="meta"), **kw)


def test_empty_batch():
    pk = torch.zeros((0, 2), dtype=torch.int32)
    assert ht.placement(pk, k=31, num_hash=4, bloom_size=1000).shape == (0, 4)
    block, offs = ht.placement(pk, k=31, num_hash=2, bloom_size=128_000, rpb=128,
                               version=4, blkoff=True)
    assert block.shape == (0,) and len(offs) == 2
