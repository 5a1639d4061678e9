"""The generic gather (colorid_tpu_torch/ops/query.py::_accumulate_one,
csrc/epilogue.cu's gather mode on the card) against the JAX package's
(colorid_tpu/ops/query.py): on the CPU the wrapper takes its twin
_accumulate_one_plain (the gather of each k-mer's H rows, their AND and
presence, then _accumulate_tail_plain), and both must equal the JAX
_accumulate_one element for element on every accumulator (stats,
histogram, overflow list), and the port's scans (query_accumulate_scan,
query_accumulate_hash_scan[_exact], query_accumulate_scan_wide) the JAX
scans. Row widths of 2, 8 and 32 words (C 33, 256 and 1,000: a last word
with bits past C), H 1-4, classic and blocked rows, padding, N off the
kernel's tiles, a nonzero base_idx and a given payload, an overflow list
that starts past zero and runs past capO. Integers throughout: exact
equality. On the CPU no kernel is launched."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colorid_tpu.ops import query as jq
from colorid_tpu_torch.ops import hash_torch
from colorid_tpu_torch.ops import query as tq
from tests import torch_support as ts

K = 31
N = 2 * 512 + 276  # k-mers a batch: off the kernel's tiles (2,048 rows at W 1, 512 beyond)
# H 1-4 over each layout and each width, two a case
H_OF = {(33, "classic"): (1, 2), (33, "blocked"): (3, 4), (256, "classic"): (3, 4),
        (256, "blocked"): (1, 2), (1000, "classic"): (2, 4), (1000, "blocked"): (1, 3)}
_jax_one = jax.jit(jq._accumulate_one, static_argnums=(8, 10))
CAPO = 100  # below the batch's big k-mers: the overflow list runs past it
N_OVER = 25  # entries already in the list


def _accs(C: int, wpad: int):
    """The same accumulators for both packages: counts, AND words, a
    histogram and N_OVER overflow entries already there."""
    a = ts.epi_accs(C, wpad, CAPO, n_over=N_OVER, seed=C + wpad)
    return (tuple(jnp.asarray(x) for x in a), tuple(torch.from_numpy(x.copy()) for x in a))


def _equal(got, want):
    for name, g, w in zip(("stats", "hist", "over_col", "over_freq"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).view(np.int32), err_msg=name)


@pytest.mark.parametrize("layout", ["classic", "blocked"])
@pytest.mark.parametrize("C", [33, 256, 1000])
def test_accumulate_one_matches_jax(C, layout):
    """Two of H 1-4 a case, from running accumulators: the twin and the CPU
    route of the wrapper equal the JAX _accumulate_one, with the k-mer index
    from a nonzero base_idx and then a given payload."""
    n_over = []
    for H in H_OF[C, layout]:
        blocks, rows, mask, q, gidx, wpad, rpb = ts.gather_case(C, H, layout, seed=C + H, n=N)
        assert wpad == {33: 2, 256: 8, 1000: 32}[C]
        jacc, tacc = _accs(C, wpad)
        for base, g in ((123_457, None), (0, gidx)):
            want = _jax_one(
                *jacc, jnp.asarray(blocks), jnp.asarray(rows), jnp.asarray(mask),
                jnp.asarray(q), wpad, jnp.int32(base), rpb,
                gidx=None if g is None else jnp.asarray(g))
            args = (ts.t32(blocks), torch.from_numpy(rows), torch.from_numpy(mask),
                    torch.from_numpy(q), wpad, base, rpb)
            gt = None if g is None else torch.from_numpy(g)
            plain = tq._accumulate_one_plain(*[a.clone() for a in tacc], *args, gidx=gt)
            got = tq._accumulate_one(*tacc, *args, gidx=gt)
            _equal(plain, want)
            _equal(got, want)
            jacc = want
        stats = tacc[0].numpy()
        n_over.append(stats[C + wpad + 1])
        assert stats[C + wpad] == 0  # some real k-mer was absent
        assert tacc[1].numpy().sum() > 0
    assert min(n_over) > N_OVER and max(n_over) > CAPO  # the list ran past capO


@pytest.mark.parametrize("C,H", [(33, 2), (256, 4)])
def test_scans_match_jax(C, H):
    """query_accumulate_scan (rows given, classic and blocked), its wide
    adapter on the (block, lane) split and query_accumulate_hash_scan[_exact]
    (rows hashed from packed k-mers) against the JAX scans, chunks of 1,024
    k-mers over a padded batch."""
    chunk, n = 1024, 2 * 1024
    for layout in ("classic", "blocked"):
        blocks, rows, mask, q, _g, wpad, rpb = ts.gather_case(C, H, layout, seed=7 * C, n=n)
        q16 = np.minimum(q, 65535).astype(np.uint16)
        jacc, tacc = _accs(C, wpad)
        want = jq.query_accumulate_scan(
            *jacc, jnp.asarray(blocks), jnp.asarray(rows), jnp.asarray(mask), jnp.asarray(q16),
            jnp.int32(11), wpad=wpad, chunk=chunk, rpb=rpb)
        got = tq.query_accumulate_scan(
            *tacc, ts.t32(blocks), torch.from_numpy(rows), torch.from_numpy(mask),
            torch.from_numpy(q16.astype(np.int32)), 11, wpad=wpad, chunk=chunk, rpb=rpb)
        _equal(got, want)
        if layout == "classic":
            blk, lane0 = tq.split_rows_wide(rows.astype(np.int64), wpad)
            jacc, tacc = _accs(C, wpad)
            want = jq.query_accumulate_scan_wide(
                *jacc, jnp.asarray(blocks), jnp.asarray(blk), jnp.asarray(lane0),
                jnp.asarray(mask), jnp.asarray(q16), jnp.int32(11), wpad=wpad, chunk=chunk)
            got = tq.query_accumulate_scan_wide(
                *tacc, ts.t32(blocks), torch.from_numpy(blk), torch.from_numpy(lane0),
                torch.from_numpy(mask), torch.from_numpy(q16.astype(np.int32)), 11,
                wpad=wpad, chunk=chunk)
            _equal(got, want)
            # the wide route's int64 rows through the same wrapper
            jacc, tacc = _accs(C, wpad)
            got = tq.query_accumulate_scan(
                *tacc, ts.t32(blocks), torch.from_numpy(rows.astype(np.int64)),
                torch.from_numpy(mask), torch.from_numpy(q16.astype(np.int32)), 11,
                wpad=wpad, chunk=chunk)
            _equal(got, want)
    blocks, _rows, _mask, q, _g, wpad, _rpb = ts.gather_case(C, H, "classic", seed=C, n=n)
    rng = np.random.default_rng(C)
    packed = ts.rand_packed(rng, n)
    bloom = 4096
    for exact in (False, True):
        jacc, tacc = _accs(C, wpad)
        kw = dict(wpad=wpad, chunk=chunk, k=K, num_hash=H, bloom_size=bloom)
        if exact:
            want = jq.query_accumulate_hash_scan_exact(
                *jacc, jnp.asarray(blocks), jnp.asarray(packed), jnp.asarray(q), **kw)
            got = tq.query_accumulate_hash_scan_exact(
                *tacc, ts.t32(blocks), ts.t32(packed), torch.from_numpy(q), **kw)
        else:
            q16 = np.minimum(q, 65535).astype(np.uint16)
            want = jq.query_accumulate_hash_scan(
                *jacc, jnp.asarray(blocks), jnp.asarray(packed), jnp.asarray(q16),
                jnp.int32(5), **kw)
            got = tq.query_accumulate_hash_scan(
                *tacc, ts.t32(blocks), ts.t32(packed), torch.from_numpy(q16.astype(np.int32)),
                5, **kw)
        _equal(got, want)
        assert int(got[0][C + wpad + 1]) > N_OVER


def test_cpu_tensors_launch_nothing_and_other_devices_are_refused(monkeypatch):
    """A CPU batch takes _accumulate_one_plain and launches nothing; a
    tensor on another device is refused, never handed to the twin."""
    calls = []
    plain = tq._accumulate_one_plain

    def recorded(*a, **kw):
        calls.append(a[5].device.type)
        return plain(*a, **kw)

    monkeypatch.setattr(tq, "_accumulate_one_plain", recorded)
    blocks, rows, mask, q, _g, wpad, rpb = ts.gather_case(33, 4, "blocked", seed=3, n=600)
    _jacc, tacc = _accs(33, wpad)
    before = (tq._accumulate_one.launches, tq._accumulate_tail.launches)
    tq._accumulate_one(*tacc, ts.t32(blocks), torch.from_numpy(rows), torch.from_numpy(mask),
                       torch.from_numpy(q), wpad, 0, rpb)
    tq.query_accumulate_hash_scan(
        *tacc, ts.t32(blocks), ts.t32(ts.rand_packed(np.random.default_rng(1), 600)),
        torch.from_numpy(q), 0, wpad=wpad, chunk=256, k=K, num_hash=4, bloom_size=4096,
        rpb=rpb, bv=1)
    assert calls == ["cpu"] * 4  # once, then one a chunk of the scan
    assert (tq._accumulate_one.launches, tq._accumulate_tail.launches) == before
    meta = torch.device("meta")
    acc = tuple(torch.zeros(s, dtype=torch.int32, device=meta)
                for s in ((33 + 2 + 2,), (33, ts.EPI_FREQ_CAP), (8,), (8,)))
    m = torch.zeros(16, dtype=torch.bool, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tq._accumulate_one(*acc, torch.zeros((512, 128), dtype=torch.int32, device=meta),
                           torch.zeros((16, 4), dtype=torch.int32, device=meta), m,
                           m.int(), 2, 0)
    assert calls == ["cpu"] * 4


def test_padding_only_and_empty_batches_change_nothing_but_the_flag():
    """An all-padding batch leaves every accumulator as it was (padding
    never counts, and a padding k-mer's absent rows do not clear the
    all-valid flag); an empty one too: the JAX package agrees."""
    blocks, rows, _mask, q, _g, wpad, _rpb = ts.gather_case(256, 3, "classic", seed=4, n=N)
    jacc, tacc = _accs(256, wpad)
    start = [a.clone() for a in tacc]
    none = np.zeros(N, dtype=bool)
    want = _jax_one(*jacc, jnp.asarray(blocks), jnp.asarray(rows), jnp.asarray(none),
                    jnp.asarray(q * 0), wpad, jnp.int32(0), 0)
    got = tq._accumulate_one(*tacc, ts.t32(blocks), torch.from_numpy(rows),
                             torch.from_numpy(none), torch.from_numpy(q * 0), wpad, 0)
    _equal(got, want)
    _equal(got, start)
    got = tq._accumulate_one(*got, ts.t32(blocks), torch.from_numpy(rows[:0]),
                             torch.from_numpy(none[:0]), torch.from_numpy(q[:0]), wpad, 0)
    _equal(got, start)
