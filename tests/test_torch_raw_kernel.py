"""The raw mode of the port's probe kernel (colorid_tpu_torch/ops/
stream_query.py: stream_probe_raw_plain, stream_raw_local) against the JAX
package's (_stream_call_raw in interpret mode, stream_raw_local) on the
same seeded inputs. Everything is an integer: tolerance 0, every element of
every output. The CUDA kernel itself runs only on a card
(tests/test_torch_cuda.py); here its plain twin stands in."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu.ops import stream_query as jsq
from colorid_tpu_torch.ops import stream_query as tsq
from colorid_tpu_torch.ops.hash_torch import device_blkoff
from colorid_tpu_torch.ops.query import pack_matrix_blocks
from tests import torch_support as ts

K = 31
SHAPES = [(21, 4, 1), (100, 4, 4), (512, 2, 16), (1024, 2, 32)]


@functools.lru_cache(maxsize=None)
def _case(C, H, wpad):
    """One random shard matrix of 1024 blocks and 2 chunks of sorted probes
    with frequencies (zeros: padding) for a (C, H, wpad) shape; the JAX
    side's byte planes are made once per shape."""
    rng = np.random.default_rng(1000 + C)
    rpb = 128 // wpad
    thin = 1 if C <= 128 else 3 if C <= 256 else 5
    bloom, matrix, _names = ts.rand_blocked_matrix(rng, C, 1024 * rpb, 0.3, thin)
    blocks, wp = pack_matrix_blocks(matrix)
    assert wp == wpad
    P = 2 * tsq.PC
    blk, offs = device_blkoff(
        ts.t32(ts.rand_packed(rng, P)), k=K, num_hash=H, bloom_size=bloom,
        rpb=rpb, version=2,
    )
    blk_s, perm = torch.sort(blk.to(torch.int32), stable=True)
    off_s = tsq.pack_offsets(offs)[perm].contiguous()
    qc = torch.from_numpy(rng.integers(0, 2000, P).astype(np.int32))
    jb = jnp.asarray(blocks)
    return blocks, jb, jsq.byte_plane_blocks(jb), blk_s, off_s, qc


def _j(t):
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("C,H,wpad", SHAPES)
def test_raw_twin_matches_jax_kernel(C, H, wpad):
    """stream_probe_raw (on CPU tensors: its plain twin) against
    _stream_call_raw: nhits, colorsum, presmask and the counts."""
    blocks, _jb, jbp, blk_s, off_s, qc = _case(C, H, wpad)
    tb, inwin2d = tsq.stream_plan(blk_s, blocks.shape[0], wpad)
    qcw = torch.where(inwin2d.view(-1), qc, 0).to(torch.int32)
    counts = torch.zeros(32 * wpad, dtype=torch.int32)
    launches = tsq.stream_probe_raw.launches
    nh, cs, pm = tsq.stream_probe_raw(
        ts.t32(blocks), blk_s, off_s, qcw, counts, num_hash=H, wpad=wpad
    )
    assert tsq.stream_probe_raw.launches == launches  # CPU tensors: the twin

    jnh, jcs, jpm, jcounts = jsq._stream_call_raw(
        jbp, _j(blk_s), jnp.asarray(off_s.numpy().view(np.uint32)), _j(qcw),
        _j(tb), num_hash=H, wpad=wpad, n_colors=C,
    )
    np.testing.assert_array_equal(nh.numpy(), np.asarray(jnh))
    np.testing.assert_array_equal(cs.numpy(), np.asarray(jcs))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jpm))
    jc = np.asarray(jcounts)[0]  # [CGP]: the color-bit capacity, 128-padded
    np.testing.assert_array_equal(counts.numpy(), jc[: 32 * wpad])
    assert not jc[32 * wpad:].any()
    # the case means something: single and multiple hits, rows absent in part
    # and in full, zeros where qc == 0
    full = (1 << H) - 1
    assert (nh == 1).any() and (nh > 1).any() and ((nh == 0) & (qcw > 0)).any()
    assert ((pm > 0) & (pm < full)).any() and (pm == full).any()
    assert not (nh[qcw == 0].any() or cs[qcw == 0].any() or pm[qcw == 0].any())
    # colorsum is the SUM of the set bits' indices, by numpy on the matrix
    rows = (blk_s.numpy().astype(np.int64) * 128)[:, None] + np.stack(
        [((off_s.numpy() >> (8 * h)) & 0xFF) * wpad for h in range(H)], axis=1
    )  # [P, H] first word of each row
    words = blocks.reshape(-1)[rows[:, :, None] + np.arange(wpad)]  # [P, H, W]
    bits = np.unpackbits(
        np.bitwise_and.reduce(words, axis=1).view(np.uint8), axis=1,
        bitorder="little",
    ) * (qcw.numpy() > 0)[:, None]
    np.testing.assert_array_equal(nh.numpy(), bits.sum(axis=1))
    np.testing.assert_array_equal(cs.numpy(), bits @ np.arange(32 * wpad))


def test_raw_wrapper_refuses_what_the_kernel_does_not_take():
    blocks, _jb, _jbp, _blk, _off, _qc = _case(21, 4, 1)
    z = torch.zeros(tsq.PC, dtype=torch.int32)
    counts = torch.zeros(32, dtype=torch.int32)
    b2 = ts.t32(blocks)
    kw = dict(num_hash=4, wpad=1)
    nh, cs, pm = tsq.stream_probe_raw(b2, z, z, z, counts, **kw)
    assert not (nh.any() or cs.any() or pm.any() or counts.any())
    with pytest.raises(TypeError, match="int32"):
        tsq.stream_probe_raw(b2, z.to(torch.int64), z, z, counts, **kw)
    with pytest.raises(ValueError, match="multiple of"):
        tsq.stream_probe_raw(b2, z[:100], z[:100], z[:100], counts, **kw)
    with pytest.raises(ValueError, match="num_hash"):
        tsq.stream_probe_raw(b2, z, z, z, counts, num_hash=3, wpad=1)
    with pytest.raises(ValueError, match="wpad"):
        tsq.stream_probe_raw(
            b2, z, z, z, torch.zeros(96, dtype=torch.int32), num_hash=4, wpad=3
        )
    with pytest.raises(ValueError, match="counts"):
        tsq.stream_probe_raw(b2, z, z, z, torch.zeros(64, dtype=torch.int32), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tsq.stream_probe_raw(
            b2, z, torch.zeros(2 * tsq.PC, dtype=torch.int32)[::2], z, counts, **kw
        )
    with pytest.raises(ValueError, match="blocks2"):
        tsq.stream_probe_raw(b2.view(-1, 64), z, z, z, counts, **kw)


def _raw_local_both(C, H, wpad, qc=None):
    blocks, jb, jbp, blk_s, off_s, qc0 = _case(C, H, wpad)
    qc = qc0 if qc is None else qc
    geo = dict(wpad=wpad, num_hash=H, rpb=128 // wpad, n_colors=C)
    got = tsq.stream_raw_local(ts.t32(blocks), blk_s, off_s, qc, **geo)
    want = jsq.stream_raw_local(
        jb, jbp, _j(blk_s), jnp.asarray(off_s.numpy().view(np.uint32)), _j(qc),
        **geo,
    )
    for name, g, w in zip(("counts", "nhits", "colorsum", "presmask", "n_drop"),
                          got, want):
        w = np.asarray(w)
        if name == "counts":
            assert not w[32 * wpad:].any()
            w = w[: 32 * wpad]
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    _tb, inwin2d = tsq.stream_plan(blk_s, blocks.shape[0], wpad)
    n_res = int((~inwin2d.view(-1) & (qc > 0)).sum())
    return got, n_res


@pytest.mark.parametrize("C,H,wpad", SHAPES)
def test_stream_raw_local_matches_jax(C, H, wpad):
    """The window plan, the raw probe and the residual patch: every shape
    leaves probes outside their chunk's window (2048 probes span half of
    the 1024 blocks), and the patch OVERWRITES their facts."""
    (counts, nh, cs, pm, n_drop), n_res = _raw_local_both(C, H, wpad)
    assert int(n_drop) == 0 and int(counts.sum()) > 0
    assert n_res > 0
    assert int(counts.sum()) == int(nh.sum())


def test_stream_raw_local_sparse_batch():
    """A batch that is mostly padding (runs of qc == 0): the residual list
    holds the few counted probes outside the window; padding stays zero."""
    C, H, wpad = 1024, 2, 32
    qc0 = _case(C, H, wpad)[5]
    rng = np.random.default_rng(5)
    keep = torch.from_numpy(rng.random(qc0.shape[0]) < 0.05)
    runs = torch.from_numpy((np.arange(qc0.shape[0]) // 256) % 3 == 0)
    qc = torch.where(keep & ~runs, qc0, 0).to(torch.int32)
    (counts, nh, cs, pm, n_drop), n_res = _raw_local_both(C, H, wpad, qc)
    assert 0 < n_res < 200 and int(n_drop) == 0
    assert not (nh[qc == 0].any() or cs[qc == 0].any() or pm[qc == 0].any())


def test_stream_raw_local_reports_drops_as_jax_does(monkeypatch):
    """More residual chunks than the capacity: the chunks beyond it keep
    the kernel's zeros and their probes are counted in n_drop."""
    monkeypatch.setattr(tsq, "_nch", lambda wpad: 1)
    monkeypatch.setattr(jsq, "_nch", lambda wpad: 1)
    (_counts, _nh, _cs, _pm, n_drop), n_res = _raw_local_both(512, 2, 16)
    assert 0 < int(n_drop) < n_res
