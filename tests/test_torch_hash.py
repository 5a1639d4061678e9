"""The port's device XXH3 rows (colorid_tpu_torch/ops/hash_torch.py) against
the JAX package's host hasher and its device hasher: exact equality."""

import numpy as np
import pytest
import torch

from colorid_tpu.hashing.xxh3 import bloom_rows_batch
from colorid_tpu.ops import hash_jax
from colorid_tpu_torch.ops import hash_torch

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _keys(k: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice(ACGT, size=(n, k))


def _port_rows(packed: np.ndarray, k: int, num_hash: int, bloom: int) -> np.ndarray:
    pk = torch.from_numpy(packed.view(np.int32))
    return hash_torch.bloom_rows_device(
        pk, k=k, num_hash=num_hash, bloom_size=bloom
    ).numpy()


@pytest.mark.parametrize("num_hash", [1, 3, 4])
@pytest.mark.parametrize("k", [4, 16, 17, 27, 31, 32])
def test_device_rows_match_both_packages(k, num_hash):
    keys = _keys(k, 400, seed=k * 10 + num_hash)
    packed = hash_torch.pack_keys_host(keys)
    np.testing.assert_array_equal(packed, hash_jax.pack_keys_host(keys))
    for bloom in (375_000, 50_000_000):
        want = bloom_rows_batch(keys, num_hash, bloom).astype(np.int32)
        got = _port_rows(packed, k, num_hash, bloom)
        np.testing.assert_array_equal(got, want)
        if bloom == 50_000_000:
            # seed h's row does not depend on num_hash: one jit per k
            jax_rows = np.asarray(
                hash_jax.bloom_rows_device(
                    packed, k=k, num_hash=4, bloom_size=bloom
                )
            )
            np.testing.assert_array_equal(got, jax_rows[:, :num_hash])


@pytest.mark.parametrize("bloom", [1 << 30, (3 << 29) + 12345, (1 << 31) - 9])
def test_device_rows_wide_bloom(bloom):
    """bloom_size in [2^30, 2^31), as tests/test_hash_jax.py covers it."""
    keys = _keys(31, 300, seed=11)
    packed = hash_torch.pack_keys_host(keys)
    want = bloom_rows_batch(keys, 4, bloom).astype(np.int32)
    got = _port_rows(packed, 31, 4, bloom)
    np.testing.assert_array_equal(got, want)
    if bloom == (1 << 31) - 9:  # one jit of the JAX device hasher
        jax_rows = np.asarray(
            hash_jax.bloom_rows_device(packed, k=31, num_hash=4, bloom_size=bloom)
        )
        np.testing.assert_array_equal(got, jax_rows)


def test_limbs_match_jax():
    keys = _keys(27, 256, seed=3)
    packed = hash_torch.pack_keys_host(keys)
    p = torch.from_numpy(packed.astype(np.int64))
    got = hash_torch._limbs_from_packed(p[:, 0], p[:, 1], 27)
    want = hash_jax._limbs_from_packed(packed[:, 0], packed[:, 1], 27)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_mod_matches_barrett():
    rng = np.random.default_rng(9)
    lo = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    hi = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    h = (hi << np.uint64(32)) | lo
    t = (torch.from_numpy(lo.astype(np.int64)), torch.from_numpy(hi.astype(np.int64)))
    for m in [3, 375_000, 50_000_000, (1 << 30) - 1, 1 << 30, (1 << 31) - 1]:
        want = (h % np.uint64(m)).astype(np.int64)
        np.testing.assert_array_equal(hash_torch._mod_u64(t, m).numpy(), want)
        jax_r = hash_jax._mod_barrett(
            (lo.astype(np.uint32), hi.astype(np.uint32)), m
        )
        np.testing.assert_array_equal(np.asarray(jax_r).astype(np.int64), want)
    with pytest.raises(ValueError):
        hash_torch._mod_u64(t, 1 << 31)


def test_pack_rejects_non_acgt():
    assert hash_torch.pack_keys_host(np.frombuffer(b"ACGN", dtype=np.uint8)[None]) is None
    assert hash_torch.pack_keys_host(np.frombuffer(b"acgt", dtype=np.uint8)[None]) is None
    assert hash_torch.pack_keys_host(_keys(33, 2, seed=1)) is None


@pytest.mark.parametrize("seed", [0, 7])
def test_scalar_xxh3_matches_jax(seed):
    """The scalar hash (core/bloom.py's) over every length class 0..240."""
    from colorid_tpu.hashing.xxh3 import xxh3_64 as jxxh3
    from colorid_tpu_torch.hashing.xxh3 import xxh3_64

    rng = np.random.default_rng(seed)
    for n in list(range(0, 33)) + [64, 65, 96, 97, 128, 129, 200, 240]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert xxh3_64(data, seed) == jxxh3(data, seed)
    with pytest.raises(ValueError):
        xxh3_64(bytes(241))


def test_bloom_filter_matches_jax():
    from colorid_tpu.core.bloom import BloomFilter as JBloom
    from colorid_tpu_torch.core.bloom import BloomFilter

    keys = [bytes(k) for k in _keys(21, 200, seed=3)]
    bf, jbf = BloomFilter(250_000, 4), JBloom(250_000, 4)
    for key in keys[:100]:
        bf.insert(key)
        jbf.insert(key)
    bf.insert("ATGC")
    jbf.insert("ATGC")
    np.testing.assert_array_equal(bf.bits, jbf.bits)
    assert all(bf.contains(key) for key in keys[:100]) and bf.contains("ATGC")
    assert [bf.contains(key) for key in keys[100:]] == [jbf.contains(key) for key in keys[100:]]
