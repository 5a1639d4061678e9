"""The classic word kernel's plain PyTorch twin
(colorid_tpu_torch/ops/stream_query.py::classic_words on CPU tensors)
against the JAX package's Pallas kernel (_classic_call, interpret mode on
the CPU): bit for bit, on dense and sparse sorted probes, for every byte
plane count; and the classic route around it, whose rows kernel E
sorts (its twin here), against the JAX package's
stream_accumulate_classic_exact. The CUDA kernels are held against their
twins in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu.ops import stream_query as jsq
from colorid_tpu.ops.query import _device_rows
from colorid_tpu_torch.ops import query as tq
from colorid_tpu_torch.ops import stream_query as sq
from tests import torch_support as ts


def _port_plan(blocks, rows):
    b2, row_s = torch.from_numpy(blocks.view(np.int32)), torch.from_numpy(rows)
    return (b2, row_s) + sq.classic_plan(row_s, blocks.shape[0])


@pytest.mark.parametrize("planes", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_twin_matches_jax_kernel(kind, planes):
    blocks, rows = ts.classic_case(kind, seed=planes)
    b2, row_s, tb, inwin2d = _port_plan(blocks, rows)
    # the chunk windows follow the JAX stream's formula exactly
    firsts = (rows >> 7).reshape(-1, sq.PC_CL)[:, 0]
    want_tb = np.clip(firsts // sq.T, 0, blocks.shape[0] // sq.T - 2)
    np.testing.assert_array_equal(tb.numpy(), want_tb)
    n_out = int((~inwin2d).sum())
    if kind == "sparse":
        assert n_out > 0
    else:
        assert n_out == 0
    before = sq.classic_words.launches
    got = sq.classic_words(b2, row_s, tb, planes=planes).numpy()
    assert sq.classic_words.launches == before  # the twin is no launch
    # the JAX kernel takes each row as its block and lane
    want = np.asarray(
        jsq._classic_call(
            jsq.byte_plane_blocks(blocks), rows >> 7, rows & 127,
            tb.numpy(), planes=planes, nt=2, pc=jsq.PC_CL,
        )
    )
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # in-window words are the matrix words' low 8*planes bits; the rest
    # carry the de-offset constant the residual patch overwrites
    inwin = inwin2d.numpy().reshape(-1)
    flat = blocks.reshape(-1)
    mask = np.uint32(0xFFFFFFFF if planes == 4 else (1 << (8 * planes)) - 1)
    np.testing.assert_array_equal(
        got[inwin].view(np.uint32), flat[rows[inwin]] & mask
    )
    assert (got[~inwin] == jsq._deoffset(planes)).all()


def test_constants_match_jax():
    assert (sq.T, sq.PC_CL, sq.NCH_CL, sq.EPC_CL) == (
        jsq.T, jsq.PC_CL, jsq.NCH_CL, jsq.EPC_CL
    )
    for c in (1, 8, 9, 17, 25, 32):
        assert sq._n_planes(c) == jsq._n_planes(1, c)
    for p in (1, 2, 3, 4):
        assert sq._deoffset(p) == int(jsq._deoffset(p))


def test_wrapper_rejects_bad_inputs():
    blocks, rows = ts.classic_case("dense", seed=0)
    b2, row_s, tb, _ = _port_plan(blocks, rows)
    with pytest.raises(TypeError):
        sq.classic_words(b2, row_s.to(torch.int64), tb, planes=1)
    with pytest.raises(ValueError):
        sq.classic_words(b2, row_s[:-1], tb, planes=1)
    with pytest.raises(ValueError):
        sq.classic_words(b2, row_s, tb[:-1], planes=1)
    with pytest.raises(ValueError):
        sq.classic_words(b2.t(), row_s, tb, planes=1)
    with pytest.raises(ValueError):
        sq.classic_words(b2, row_s, tb, planes=5)



def _jax_classic(blocks, packed, q, *, H, C, bloom):
    b2 = jnp.asarray(blocks)
    acc = np.concatenate([np.zeros(C, np.int32), [-1, 1, 0]]).astype(np.int32)
    cap = ts.SORTED_CAPO
    return jsq.stream_accumulate_classic_exact(
        jnp.asarray(acc), jnp.zeros((C, 1024), jnp.int32), jnp.zeros(cap, jnp.int32),
        jnp.zeros(cap, jnp.int32), b2, jsq.byte_plane_blocks(b2), jnp.asarray(packed),
        jnp.asarray(q), wpad=1, k=31, num_hash=H, bloom_size=bloom, n_colors=C)


@pytest.mark.parametrize("H,C,kind", [(2, 12, "mixed"), (4, 21, "drop")])
def test_classic_route_with_the_sort_twin_matches_jax(monkeypatch, H, C, kind):
    """stream_accumulate_classic_exact on CPU tensors (kernel E's twin sorts
    the H * P rows with their probe index, widened to int64; the word and
    epilogue twins follow) against the JAX package's classic stream
    (interpret mode): the four accumulators and n_drop equal, with re-read
    chunks ("mixed") and more residual chunks than NCH_CL ("drop"); the
    sort took the rows' own bits and gave JAX's stable lax.sort of (rows,
    gidx)."""
    bloom, matrix, packed, q = ts.sorted_case(H, C, kind, seed=40 + H + C)
    blocks, _ = tq.pack_matrix_blocks(matrix)
    want = _jax_classic(blocks, packed, q, H=H, C=C, bloom=bloom)
    cap = ts.SORTED_CAPO
    seen = []
    real = sq.sort_payloads

    def recorded(*a, **kw):
        out = real(*a, **kw)
        seen.append((a, kw, out))
        return out

    before = real.launches
    monkeypatch.setattr(sq, "sort_payloads", recorded)
    accs = tq.new_accumulators(C, 1, cap, "cpu")
    got = sq.stream_accumulate_classic_exact(
        *accs, ts.t32(blocks), ts.t32(packed), torch.from_numpy(q), wpad=1, k=31,
        num_hash=H, bloom_size=bloom, n_colors=C)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert (int(got[4]) > 0) == (kind == "drop")
    assert real.launches == before  # CPU tensors: the twin
    (a, kw, (row_s, gidx_s)), = seen
    assert a[1] == sq.classic_key_bits(bloom) and kw == dict(index=True, index64=True)
    rows = _device_rows(jnp.asarray(packed[:, 0]), jnp.asarray(packed[:, 1]), 31, H, bloom, 0)
    flat = rows.reshape(-1).astype(jnp.int32)
    j_rows, j_gidx = jax.lax.sort((flat, jnp.arange(flat.shape[0], dtype=jnp.int32)),
                                  num_keys=1, is_stable=True)
    np.testing.assert_array_equal(row_s.numpy(), np.asarray(j_rows))
    assert gidx_s.dtype == torch.int64
    np.testing.assert_array_equal(gidx_s.numpy(), np.asarray(j_gidx))


def test_classic_route_past_the_sort_limit_runs_in_pieces(monkeypatch):
    """A batch of more rows than kernel E sorts at once (SORT_MAX_KEYS,
    lowered here to H * EPC_CL rows) runs as EPC_CL-aligned pieces into the
    same accumulators: the four accumulators and n_drop equal the JAX
    package's classic stream over the whole batch, and no sort took more
    rows than the limit. Two "mixed" batches over one matrix, so that each
    piece re-reads some chunks and none drops."""
    H, C = 2, 12
    bloom, matrix, pk0, q0 = ts.sorted_case(H, C, "mixed", seed=71)
    pk1, q1 = ts.sorted_case(H, C, "mixed", seed=72)[2:]
    packed, q = np.concatenate([pk0, pk1]), np.concatenate([q0, q1])
    assert packed.shape[0] == 2 * sq.EPC_CL
    blocks, _ = tq.pack_matrix_blocks(matrix)
    want = _jax_classic(blocks, packed, q, H=H, C=C, bloom=bloom)
    sizes = []
    real = sq.sort_payloads

    def recorded(key, *a, **kw):
        sizes.append(key.shape[0])
        return real(key, *a, **kw)

    monkeypatch.setattr(sq, "sort_payloads", recorded)
    monkeypatch.setattr(sq, "SORT_MAX_KEYS", H * sq.EPC_CL)
    accs = tq.new_accumulators(C, 1, ts.SORTED_CAPO, "cpu")
    got = sq.stream_accumulate_classic_exact(
        *accs, ts.t32(blocks), ts.t32(packed), torch.from_numpy(q), wpad=1, k=31,
        num_hash=H, bloom_size=bloom, n_colors=C)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert int(got[4]) == 0 and int(got[0][C + 2]) > 0
    assert sizes == [H * sq.EPC_CL] * 2
