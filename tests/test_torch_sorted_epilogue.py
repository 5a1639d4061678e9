"""The classic stream's epilogue in its sorted-words mode
(colorid_tpu_torch/ops/query.py::_accumulate_sorted_words, csrc/epilogue.cu's
twin _accumulate_sorted_words_plain on the CPU) against the JAX package's
stream_accumulate_classic_exact (its Pallas word kernel in interpret mode,
as tests/test_stream_classic.py runs it here): the same seeded numpy batch
(tests/torch_support.py::sorted_case) gives exactly the same four
accumulators and n_drop, at H 1, 2 and 4 and C 5, 12, 21 and 32 (one to
four byte planes: at C 32 no bit of a word is spare), with chunks whose
out-of-window probes are re-read, padding slots and an overflow list that
runs past capO; and with more residual chunks than NCH_CL, where the rest
keep the de-offset word and n_drop > 0. Integers throughout: exact
equality. On the CPU no kernel is launched."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu.ops import stream_query as jsq
from colorid_tpu_torch.ops import query as tq
from colorid_tpu_torch.ops import stream_query as tsq
from tests import torch_support as ts

CASES = [(H, C, "mixed") for H in (1, 2, 4) for C in (5, 12, 21, 32)] + [(4, 21, "drop")]


def _jax_stream(blocks, packed, q, H, C, bloom):
    """The JAX classic stream from fresh accumulators (capO SORTED_CAPO)."""
    b2 = jnp.asarray(blocks)
    acc = np.concatenate([np.zeros(C, np.int32), [-1, 1, 0]]).astype(np.int32)
    cap = ts.SORTED_CAPO
    out = jsq.stream_accumulate_classic_exact(
        jnp.asarray(acc), jnp.zeros((C, 1024), jnp.int32), jnp.zeros(cap, jnp.int32),
        jnp.zeros(cap, jnp.int32), b2, jsq.byte_plane_blocks(b2), jnp.asarray(packed),
        jnp.asarray(q), wpad=1, k=31, num_hash=H, bloom_size=bloom, n_colors=C,
    )
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("H,C,kind", CASES)
def test_sorted_words_twin_matches_jax_classic_stream(H, C, kind):
    bloom, matrix, packed, q = ts.sorted_case(H, C, kind, seed=10 * H + C)
    blocks, wpad = tq.pack_matrix_blocks(matrix)
    assert wpad == 1
    want = _jax_stream(blocks, packed, q, H, C, bloom)

    b2 = ts.t32(blocks)
    pk, qt = ts.t32(packed), torch.from_numpy(q)
    accs, args, kw, n_drop = ts.sorted_words_args(b2, pk, qt, H=H, C=C, bloom=bloom)
    words_s, row_s, gidx_s, tb, reread = args[:5]
    _tb, inwin2d = tsq.classic_plan(row_s, b2.shape[0])
    res = ~inwin2d
    assert torch.equal(tb, _tb)
    assert n_drop == int(want[4])
    if kind == "drop":
        assert n_drop > 0 and int(res.any(dim=1).sum()) > tsq.NCH_CL
        assert bool((res.any(dim=1) & ~reread).any())  # chunks left unpatched
    else:
        assert n_drop == 0 and 0 < int(reread.sum()) <= tsq.NCH_CL
    assert torch.equal(reread, res.any(dim=1) & (torch.cumsum(res.any(dim=1), 0)
                                                 <= tsq.NCH_CL))
    assert int((qt == 0).sum()) > 0  # padding slots

    before = tq._accumulate_sorted_words.launches
    got = tq._accumulate_sorted_words_plain(*[a.clone() for a in accs], *args, **kw)
    for g, w in zip(got, want[:4]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert int(got[0][C + 2]) > ts.SORTED_CAPO  # the overflow list ran past capO
    assert got[1].sum() > 0

    # the stream itself, through the wrapper (CPU tensors: the twin)
    full = tsq.stream_accumulate_classic_exact(
        *accs, b2, pk, qt, wpad=1, k=31, num_hash=H, bloom_size=bloom, n_colors=C)
    for g, w in zip(full, want):
        np.testing.assert_array_equal(np.asarray(g), w)
    assert tq._accumulate_sorted_words.launches == before


@pytest.mark.parametrize("kind", ["dense", "sparse", "one_chunk"])
def test_classic_residuals_match_classic_plan(kind):
    """One binary search a chunk counts the probes outside its window as
    classic_plan's per-probe mask does, with the same tb."""
    if kind == "one_chunk":
        blocks, rows = ts.classic_case("dense", seed=3, n_chunks=1)
    else:
        blocks, rows = ts.classic_case(kind, seed=3)
    row_s = torch.from_numpy(rows)
    tb, inwin2d = tsq.classic_plan(row_s, blocks.shape[0])
    tb2, chunk_res = tsq.classic_residuals(row_s, blocks.shape[0])
    assert torch.equal(tb2, tb)
    assert chunk_res.dtype == torch.int32
    assert torch.equal(chunk_res, (~inwin2d).sum(dim=1, dtype=torch.int32))
    assert (int(chunk_res.sum()) > 0) == (kind == "sparse")


def test_sorted_words_twin_edge_cases():
    """An empty batch changes nothing; a reread chunk without residual
    probes and a chunk of residual probes without reread keep the word
    kernel's words: the twin equals _accumulate_words_plain on the
    un-sorted words."""
    C, H, capO = 12, 2, 32
    rng = np.random.default_rng(4)
    start = [torch.from_numpy(a) for a in ts.epi_accs(C, 1, capO, n_over=5, seed=2)]
    z32, z64 = torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.int64)
    kw = dict(num_hash=H, tile_rows=16384, nt=2)
    got = tq._accumulate_sorted_words_plain(
        *[a.clone() for a in start], z32, z32, z64, z32, torch.zeros(0, dtype=torch.bool),
        torch.zeros((512, 128), dtype=torch.int32), torch.zeros(0, dtype=torch.bool), z32,
        0, **kw)
    for g, w in zip(got, start):
        assert torch.equal(g, w)

    n, pc = 2048, 1024  # four chunks of H n probes
    words = ts.t32(ts.epi_words(rng, n, C, H).reshape(-1))
    row_s = torch.from_numpy(np.sort(rng.integers(0, 3 * 16384, H * n)).astype(np.int32))
    perm = torch.from_numpy(rng.permutation(H * n))
    tb = torch.zeros(H * n // pc, dtype=torch.int32)
    reread = torch.tensor([True, False, False, False])
    blocks = ts.t32(rng.integers(0, 2**32, (384, 128), dtype=np.uint32))
    q = torch.from_numpy(ts.epi_qcounts(rng, n))
    assert int((row_s[:pc] >= 2 * 16384).sum()) == 0  # chunk 0: nothing to re-read
    assert int((row_s[pc:] >= 2 * 16384).sum()) > 0  # later chunks: kept as they are
    got = tq._accumulate_sorted_words_plain(
        *[a.clone() for a in start], words, row_s, perm, tb, reread, blocks, q > 0, q, 0,
        gidx=q, **kw)
    words_u = torch.empty_like(words)
    words_u[perm] = words
    want = tq._accumulate_words_plain(*[a.clone() for a in start], words_u.view(n, H),
                                      q > 0, q, 0, gidx=q)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
