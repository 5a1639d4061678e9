"""The classic word kernel's plain PyTorch twin
(colorid_tpu_torch/ops/stream_query.py::classic_words on CPU tensors)
against the JAX package's Pallas kernel (_classic_call, interpret mode on
the CPU): bit for bit, on dense and sparse sorted probes, for every byte
plane count. The CUDA kernel is held against the twin in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from colorid_tpu.ops import stream_query as jsq
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

