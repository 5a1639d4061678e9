"""The port's blocked probe stream (colorid_tpu_torch/ops/stream_query.py:
stream_probe_plain, stream_accumulate_hash, stream_accumulate_hash_exact)
against the JAX package's (_stream_call in interpret mode,
stream_accumulate_hash[_exact]) on the same seeded inputs. Everything is an
integer: tolerance 0, element for element. The probe kernel itself runs only
on a CUDA card (tests/test_torch_cuda.py); here its plain twin stands in."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu.ops import stream_query as jsq
from colorid_tpu_torch.ops import stream_query as tsq
from colorid_tpu_torch.ops.hash_torch import device_blkoff
from colorid_tpu_torch.ops.query import FREQ_CAP, pack_matrix_blocks
from tests import torch_support as ts

K = 31


def _blocks(rng, C, bloom_size, zero_frac=0.3):
    # thin wide matrices, so that an AND over the hashes leaves single hits
    thin = 1 if C <= 128 else 3 if C <= 256 else 5
    bloom, matrix, _names = ts.rand_blocked_matrix(
        rng, C, bloom_size, zero_frac, thin
    )
    blocks, wpad = pack_matrix_blocks(matrix)
    return bloom, blocks, wpad


# -- the kernel module ---------------------------------------------------------


@pytest.mark.parametrize(
    "C,H,wpad", [(21, 4, 1), (100, 4, 4), (512, 2, 16), (1024, 2, 32)]
)
def test_probe_twin_matches_jax_kernel(C, H, wpad):
    """stream_probe (on CPU tensors: its plain twin) against _stream_call:
    uniq, the per-color counts and the histogram rows of the colors."""
    rng = np.random.default_rng(C)
    rpb = 128 // wpad
    bloom, blocks, wp = _blocks(rng, C, 1024 * rpb)
    assert wp == wpad
    P = 2 * tsq.PC
    packed = ts.rand_packed(rng, P)
    blk, offs = device_blkoff(
        ts.t32(packed), k=K, num_hash=H, bloom_size=bloom, rpb=rpb, version=2
    )
    blk_s, perm = torch.sort(blk.to(torch.int32), stable=True)
    off_s = tsq.pack_offsets(offs)[perm].contiguous()
    qc = rng.integers(0, 2000, P).astype(np.int32)  # zeros: padding
    tb, inwin2d = tsq.stream_plan(blk_s, blocks.shape[0], wpad)
    qcw = torch.where(inwin2d.view(-1), torch.from_numpy(qc), 0).to(torch.int32)
    assert wpad <= 4 or int((~inwin2d).sum()) > 0  # narrow windows cut probes

    cp, hw = tsq._hist_rows(C), tsq._hist_w(C)
    counts = torch.zeros(32 * wpad, dtype=torch.int32)
    hist = torch.zeros((cp, hw), dtype=torch.int32)
    launches = tsq.stream_probe.launches
    uniq = tsq.stream_probe(
        ts.t32(blocks), blk_s, off_s, qcw, counts, hist,
        num_hash=H, wpad=wpad, n_colors=C,
    )
    assert tsq.stream_probe.launches == launches  # CPU tensors: the twin

    juniq, jcounts, jhist = jsq._stream_call(
        jsq.byte_plane_blocks(jnp.asarray(blocks)), jnp.asarray(blk_s.numpy()),
        jnp.asarray(off_s.numpy().view(np.uint32)), jnp.asarray(qcw.numpy()),
        jnp.asarray(tb.numpy()), num_hash=H, wpad=wpad, n_colors=C, cp=cp,
    )
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(juniq))
    np.testing.assert_array_equal(counts.numpy()[:C], np.asarray(jcounts)[0, :C])
    np.testing.assert_array_equal(hist.numpy()[:C], np.asarray(jhist)[:C])
    assert (uniq >= 0).any() and (uniq == -1).any() and (uniq == -2).any()
    assert int(hist.sum()) > 0


def test_probe_wrapper_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(0)
    _bloom, blocks, _ = _blocks(rng, 21, 1024 * 128)
    P = tsq.PC
    z = torch.zeros(P, dtype=torch.int32)
    counts = torch.zeros(32, dtype=torch.int32)
    hist = torch.zeros((32, 1024), dtype=torch.int32)
    kw = dict(num_hash=4, wpad=1, n_colors=21)
    b2 = ts.t32(blocks)
    tsq.stream_probe(b2, z, z, z, counts, hist, **kw)
    with pytest.raises(TypeError, match="int32"):
        tsq.stream_probe(b2, z.to(torch.int64), z, z, counts, hist, **kw)
    with pytest.raises(ValueError, match="multiple of"):
        tsq.stream_probe(b2, z[:100], z[:100], z[:100], counts, hist, **kw)
    with pytest.raises(ValueError, match="num_hash"):
        tsq.stream_probe(b2, z, z, z, counts, hist, num_hash=3, wpad=1, n_colors=21)
    with pytest.raises(ValueError, match="wpad"):
        tsq.stream_probe(
            b2, z, z, z, torch.zeros(96, dtype=torch.int32), hist,
            num_hash=4, wpad=3, n_colors=21,
        )
    with pytest.raises(ValueError, match="hist"):
        tsq.stream_probe(b2, z, z, z, counts, hist[:, :256].contiguous(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tsq.stream_probe(b2, z, z, z, counts, hist.t().contiguous().t(), **kw)


def test_hist_band_fits_its_budget_for_every_color_count():
    """The probe kernel's shared histogram band: a power of two hf <= hw,
    the largest whose [cp, hf] int32 cells fit HIST_BAND_BYTES."""
    for C in range(1, 1025):
        cp, hw = tsq._hist_rows(C), tsq._hist_w(C)
        assert cp >= 32 * ((C + 31) // 32)  # a row for every bit of an and-word
        hf = tsq._hist_band(cp, hw)
        assert 1 <= hf <= hw and hf & (hf - 1) == 0, C
        assert cp * hf * 4 <= tsq.HIST_BAND_BYTES, C
        assert hf == hw or cp * 2 * hf * 4 > tsq.HIST_BAND_BYTES, C


@pytest.mark.parametrize("C,hf", [(21, 128), (60, 32), (200, 16), (1024, 2)])
def test_hist_band_at_each_histogram_shape(C, hf):
    """C 21 is the main path's (its real query's frequencies are 1-18, all
    in the band); wide color counts keep a narrow band."""
    assert tsq._hist_band(tsq._hist_rows(C), tsq._hist_w(C)) == hf


# -- _stream_core through its two callers ---------------------------------------


def _accumulators(C, wpad, capO):
    stats = np.concatenate(
        [np.zeros(C, np.int32), np.full(wpad, -1, np.int32), [1, 0]]
    ).astype(np.int32)
    return stats, np.zeros((C, FREQ_CAP), np.int32), np.zeros(capO, np.int32), \
        np.zeros(capO, np.int32)


CASES = {
    # name: (C, bloom, H, bv, n, max freq, zero_frac)
    "narrow_v2": (21, 100_000, 4, 2, 20_000, 3000, 0.3),
    "narrow_v4": (21, 100_000, 4, 4, 20_000, 3000, 0.3),
    "wide_hw256": (200, 60_000, 4, 2, 16_384, 1500, 0.5),
    "sparse_residual": (40, 3_000_000, 4, 2, 16_384, 2000, 0.2),
}


@pytest.fixture(scope="module")
def case():
    """get(name) -> (geometry kwargs, blocks, padded packed, padded
    frequencies): one random blocked matrix and query per case, made once."""
    made = {}

    def get(name):
        if name not in made:
            C, bloom_size, H, bv, n, fmax, zero_frac = CASES[name]
            rng = np.random.default_rng(sorted(CASES).index(name) + 40)
            bloom, blocks, wpad = _blocks(rng, C, bloom_size, zero_frac)
            P = -(-n // tsq.PC) * tsq.PC
            pk = np.zeros((P, 2), np.uint32)
            pk[:n] = ts.rand_packed(rng, n)
            qc = np.zeros(P, np.int32)
            qc[:n] = rng.integers(1, fmax, n)
            geo = dict(wpad=wpad, k=K, num_hash=H, bloom_size=bloom,
                       rpb=128 // wpad, n_colors=C, bv=bv)
            made[name] = (geo, blocks, pk, qc)
        return made[name]

    return get


def _assert_same_accumulators(got, want, C, wpad):
    names = ("stats", "hist", "over_col", "over_freq", "n_drop")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_accumulate_hash_matches_jax(case, name):
    """Clipped mode (the host path's): the overflow list carries global
    k-mer indices, offset by base0."""
    geo, blocks, pk, qc = case(name)
    C, wpad = geo["n_colors"], geo["wpad"]
    capO, base0 = pk.shape[0], 4096
    qc16 = np.minimum(qc, 65535).astype(np.uint16)
    jb = jnp.asarray(blocks)
    want = jsq.stream_accumulate_hash(
        *(jnp.asarray(a) for a in _accumulators(C, wpad, capO)),
        jb, jsq.byte_plane_blocks(jb), jnp.asarray(pk), jnp.asarray(qc16),
        jnp.int32(base0), **geo,
    )
    got = tsq.stream_accumulate_hash(
        *(torch.from_numpy(a) for a in _accumulators(C, wpad, capO)),
        ts.t32(blocks), ts.t32(pk), torch.from_numpy(qc16.astype(np.int32)), base0,
        **geo,
    )
    _assert_same_accumulators(got, want, C, wpad)
    n_over = int(got[0][C + wpad + 1])
    assert n_over > 0  # frequencies straddle the kernel histogram's width
    assert int(got[1].sum()) > 0
    assert int(got[4]) == 0
    # the sparse case and the wide one (a 2-tile window) leave probes outside
    # their chunk's window, for the residual pass to pick up
    assert (_n_residual(geo, blocks, pk, qc) > 0) == (
        name in ("sparse_residual", "wide_hw256")
    )


def _n_residual(geo, blocks, pk, qc):
    blk, _offs = device_blkoff(
        ts.t32(pk), k=K, num_hash=geo["num_hash"], bloom_size=geo["bloom_size"],
        rpb=geo["rpb"], version=geo["bv"],
    )
    blk_s, perm = torch.sort(blk.to(torch.int32), stable=True)
    _tb, inwin2d = tsq.stream_plan(blk_s, blocks.shape[0], geo["wpad"])
    return int((~inwin2d.view(-1) & (torch.from_numpy(qc)[perm] > 0)).sum())


def test_residual_capacity_reports_drops_as_jax_does(case, monkeypatch):
    """More residual chunks than the capacity: the chunks beyond it are
    left out and counted in n_drop (the caller then re-runs generically)."""
    monkeypatch.setattr(tsq, "_nch", lambda wpad: 2)
    monkeypatch.setattr(jsq, "_nch", lambda wpad: 2)
    geo, blocks, pk, qc = case("sparse_residual")
    pk, qc = pk[: 6 * tsq.PC], qc[: 6 * tsq.PC]  # a shape no other case traced
    C, wpad = geo["n_colors"], geo["wpad"]
    capO = pk.shape[0]
    jb = jnp.asarray(blocks)
    want = jsq.stream_accumulate_hash(
        *(jnp.asarray(a) for a in _accumulators(C, wpad, capO)),
        jb, jsq.byte_plane_blocks(jb), jnp.asarray(pk),
        jnp.asarray(qc.astype(np.uint16)), jnp.int32(0), **geo,
    )
    got = tsq.stream_accumulate_hash(
        *(torch.from_numpy(a) for a in _accumulators(C, wpad, capO)),
        ts.t32(blocks), ts.t32(pk), torch.from_numpy(qc), 0, **geo,
    )
    _assert_same_accumulators(got, want, C, wpad)
    assert 0 < int(got[4]) < _n_residual(geo, blocks, pk, qc)


@pytest.mark.parametrize("name,qc_in_key", [
    ("narrow_v2", False), ("narrow_v2", True), ("wide_hw256", True),
])
def test_stream_accumulate_hash_exact_matches_jax(case, name, qc_in_key):
    """Exact mode (the device-resident path's): the overflow list carries
    the frequency itself; with qc_in_key it rides in the sort key."""
    geo, blocks, pk, qc = case(name)
    C, wpad = geo["n_colors"], geo["wpad"]
    if qc_in_key:
        qc = np.minimum(qc, tsq.QKEY_MASK)
    capO = tsq.OVER_CAP + tsq.RES_CAP
    jb = jnp.asarray(blocks)
    want = jsq.stream_accumulate_hash_exact(
        *(jnp.asarray(a) for a in _accumulators(C, wpad, capO)),
        jb, jsq.byte_plane_blocks(jb), jnp.asarray(pk), jnp.asarray(qc),
        qc_in_key=qc_in_key, **geo,
    )
    got = tsq.stream_accumulate_hash_exact(
        *(torch.from_numpy(a) for a in _accumulators(C, wpad, capO)),
        ts.t32(blocks), ts.t32(pk), torch.from_numpy(qc), qc_in_key=qc_in_key, **geo,
    )
    _assert_same_accumulators(got, want, C, wpad)
    n_over = int(got[0][C + wpad + 1])
    assert n_over > 0 and int(got[4]) == 0
    # the payload is a frequency at or above the kernel histogram's width
    assert int(got[3][:n_over].min()) >= tsq._hist_w(C)


def test_stream_batch_must_be_padded_and_int32(case):
    geo, blocks, pk, qc = case("narrow_v2")
    C, wpad = geo["n_colors"], geo["wpad"]
    acc = [torch.from_numpy(a) for a in _accumulators(C, wpad, 1024)]
    with pytest.raises(ValueError, match="multiple of"):
        tsq.stream_accumulate_hash(
            *acc, ts.t32(blocks), ts.t32(pk[:1000]), torch.from_numpy(qc[:1000]), 0, **geo
        )
    with pytest.raises(TypeError, match="int32"):
        tsq.stream_accumulate_hash_exact(
            *acc, ts.t32(blocks), ts.t32(pk), torch.from_numpy(qc.astype(np.int64)), **geo
        )
