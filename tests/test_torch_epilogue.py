"""The search epilogue's wrappers (colorid_tpu_torch/ops/query.py::
_accumulate_tail and _accumulate_sorted_words, csrc/epilogue.cu's twins on
the CPU) against the JAX package: the same random inputs, made with numpy,
give exactly the same accumulators (stats, histogram and overflow arrays
element for element). _accumulate_words_plain, the sorted-words twin's last
step, against the JAX classic stream's AND over the H hash words, its
presence test and jq._accumulate_tail (colorid_tpu/ops/stream_query.py,
stream_accumulate_classic_exact; the whole sorted-words mode is in
test_torch_sorted_epilogue.py);
_accumulate_tail on what test_torch_query.py does not cover: bits at and
above C, an all-padding batch, an empty one, an overflow list that starts
past zero and runs past capO, the k-mer index payload from a nonzero
base_idx. Integers throughout: exact equality. On the CPU no kernel is
launched."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu.ops import query as jq
from colorid_tpu_torch.ops import query as tq
from tests import torch_support as ts


def _assert_acc_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _both(accs):
    return (tuple(jnp.asarray(a) for a in accs),
            tuple(torch.from_numpy(a.copy()) for a in accs))


def _jax_words(wordsH: np.ndarray, q: np.ndarray, jacc):
    """The JAX classic stream's recombination of per-hash words: the AND
    over H, presence (every word nonzero), then the shared epilogue in
    exact mode (the overflow payload is the frequency)."""
    w = jnp.asarray(wordsH.view(np.int32))
    andw_i = w[:, 0]
    for h in range(1, w.shape[1]):
        andw_i = andw_i & w[:, h]
    andw = andw_i.view(jnp.uint32)[:, None]
    present = (w != 0).all(axis=1)
    qj = jnp.asarray(q)
    return jq._accumulate_tail(*jacc, andw, present, qj > 0, qj, 1,
                               jnp.int32(0), gidx=qj)


@pytest.mark.parametrize("C", [21, 32])
@pytest.mark.parametrize("H", [1, 2, 4])
def test_accumulate_words_matches_jax_classic(H, C):
    rng = np.random.default_rng(100 * H + C)
    n, capO = 3000, 40
    jacc, tacc = _both(ts.epi_accs(C, 1, capO, seed=H))
    for call in range(2):  # running accumulators; the second overflows capO
        wordsH = ts.epi_words(rng, n, C, H)
        q = ts.epi_qcounts(rng, n, hot=call == 0)
        if call == 1:
            q[-400:] = 0  # padding tail
        jacc = _jax_words(wordsH, q, jacc)
        qt = torch.from_numpy(q)
        tacc = tq._accumulate_words_plain(*tacc, ts.t32(wordsH), qt > 0, qt, 0, gidx=qt)
        _assert_acc_equal(tacc, jacc)
    stats = tacc[0].numpy()
    assert stats[C + 2] > capO  # the overflow list did overflow
    assert tacc[1].sum() > ts.epi_accs(C, 1, capO, seed=H)[1].sum()
    assert stats[C] & np.int32(-(2**31)) or C == 32  # the AND kept the top bit >= C


def _edge_case(case: str, rng):
    """(C, wpad, capO, n_over, n, andw, present, mask, q, base_idx, gidx)."""
    C, wpad, capO, n_over, n = 20, 1, 200, 0, 2500
    base_idx, use_gidx = 0, False
    if case == "high_bits_c70":
        C, wpad = 70, 4
    elif case == "over_before_past_capo":
        n_over, capO = 150, 190
    elif case == "base_idx":
        base_idx = 7_000_000
    elif case == "empty":
        n = 0
    elif case == "gidx":
        use_gidx = True
    andw = ts.epi_andw(rng, n, C, wpad, high=case.startswith("high_bits") or case == "gidx")
    present = rng.random(n) < 0.85
    mask = np.ones(n, dtype=bool) if case != "all_padding" else np.zeros(n, dtype=bool)
    q = ts.epi_qcounts(rng, n)
    q[~mask] = 0
    gidx = rng.integers(0, 2**31, n).astype(np.int32) if use_gidx else None
    return C, wpad, capO, n_over, n, andw, present, mask, q, base_idx, gidx


EDGE_CASES = ("high_bits_c20", "high_bits_c70", "all_padding", "empty",
              "over_before_past_capo", "base_idx", "gidx")


@pytest.mark.parametrize("case", EDGE_CASES)
def test_accumulate_tail_edge_cases_match_jax(case):
    rng = np.random.default_rng(EDGE_CASES.index(case))
    C, wpad, capO, n_over, n, andw, present, mask, q, base_idx, gidx = _edge_case(case, rng)
    start = ts.epi_accs(C, wpad, capO, n_over=n_over, seed=3)
    jacc, tacc = _both(start)
    if n:
        jacc = jq._accumulate_tail(
            *jacc, jnp.asarray(andw), jnp.asarray(present), jnp.asarray(mask),
            jnp.asarray(q), wpad, jnp.int32(base_idx),
            gidx=None if gidx is None else jnp.asarray(gidx),
        )
    else:
        jacc = start  # the JAX epilogue's empty batch: nothing to add
    tacc = tq._accumulate_tail(
        *tacc, ts.t32(andw.reshape(n, wpad)), torch.from_numpy(present),
        torch.from_numpy(mask), torch.from_numpy(q), wpad, base_idx,
        gidx=None if gidx is None else torch.from_numpy(gidx),
    )
    _assert_acc_equal(tacc, jacc)
    stats = tacc[0].numpy()
    if case in ("all_padding", "empty"):
        _assert_acc_equal(tacc, start)  # nothing changes
    if case == "over_before_past_capo":
        assert stats[C + wpad + 1] > capO > n_over
        np.testing.assert_array_equal(tacc[2].numpy()[:n_over], start[2][:n_over])
    if case == "base_idx":
        filled = tacc[3].numpy()[: min(int(stats[C + wpad + 1]), capO)]
        assert filled.min() >= base_idx
    if case.startswith("high_bits"):
        assert stats[C + wpad - 1] < 0  # the top bit (>= C) stays in the AND


def test_empty_batch_in_jax_is_a_no_op():
    """The edge-case test compares an empty batch with the accumulators as
    they were; the JAX epilogue agrees when it is given one."""
    C, wpad, capO = 20, 1, 50
    start = ts.epi_accs(C, wpad, capO, n_over=7, seed=5)
    jacc = tuple(jnp.asarray(a) for a in start)
    z = np.zeros(0, dtype=bool)
    got = jq._accumulate_tail(
        *jacc, jnp.zeros((0, wpad), jnp.uint32), jnp.asarray(z), jnp.asarray(z),
        jnp.zeros(0, jnp.int32), wpad, jnp.int32(0),
    )
    for g, w in zip(got, start):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_cpu_tensors_take_the_twins_and_launch_nothing(monkeypatch):
    calls = []
    plain = tq._accumulate_tail_plain

    def recorded(*a, **kw):
        calls.append(a[4].device.type)
        return plain(*a, **kw)

    monkeypatch.setattr(tq, "_accumulate_tail_plain", recorded)
    rng = np.random.default_rng(9)
    C, capO = 21, 64
    before = (tq._accumulate_tail.launches, tq._accumulate_sorted_words.launches)
    acc = tuple(torch.from_numpy(a) for a in ts.epi_accs(C, 1, capO))
    q = torch.from_numpy(ts.epi_qcounts(rng, 600))
    tq._accumulate_tail(*acc, ts.t32(ts.epi_andw(rng, 600, C, 1)),
                        torch.ones(600, dtype=torch.bool), q > 0, q, 1, 0)
    words = ts.t32(ts.epi_words(rng, 600, C, 4).reshape(-1))
    row_s = torch.arange(2400, dtype=torch.int32)
    tb = torch.zeros(600, dtype=torch.int32)
    tq._accumulate_sorted_words(
        *acc, words, row_s, torch.arange(2400), tb, tb > 0,
        torch.zeros((512, 128), dtype=torch.int32), q > 0, q, 0, gidx=q, num_hash=4,
        tile_rows=16384, nt=2)
    assert calls == ["cpu", "cpu"]  # the sorted-words twin ends in the tail twin
    assert (tq._accumulate_tail.launches, tq._accumulate_sorted_words.launches) == before


def test_other_devices_are_refused():
    meta = torch.device("meta")
    acc = tuple(torch.zeros(s, dtype=torch.int32, device=meta)
                for s in ((21 + 3,), (21, ts.EPI_FREQ_CAP), (8,), (8,)))
    q = torch.zeros(16, dtype=torch.int32, device=meta)
    m = torch.zeros(16, dtype=torch.bool, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tq._accumulate_tail(*acc, torch.zeros((16, 1), dtype=torch.int32, device=meta),
                            m, m, q, 1, 0)
    w = torch.zeros(64, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tq._accumulate_sorted_words(
            *acc, w, w, w.long(), w[:16], m, torch.zeros((512, 128), dtype=torch.int32,
                                                         device=meta),
            m, q, 0, num_hash=4, tile_rows=16384, nt=2)
