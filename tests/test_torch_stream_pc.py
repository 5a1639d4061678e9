"""COLORID_STREAM_PC, the probe stream's chunk size, read at import by both
packages (colorid_tpu/ops/stream_query.py and the port's): in a fresh
interpreter with a value other than the default 2048, the port's stream
batch equals the JAX package's field by field (the overflow list in order,
n_drop with a small residual capacity) and the engines' SearchResults
agree; the same batch at the default chunk size gives another n_drop, so
the variable is really read. The probe wrappers refuse a chunk size that
the kernels cannot take."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from colorid_tpu_torch.ops import stream_query as tsq
from tests import torch_support as ts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PC_SET = 1024

_SCRIPT = textwrap.dedent("""
    import os, sys
    import jax.numpy as jnp
    import numpy as np
    import torch
    from colorid_tpu.engine import QueryEngine as JEngine
    from colorid_tpu.ops import stream_query as jsq
    from colorid_tpu_torch import convert
    from colorid_tpu_torch.ops import stream_query as tsq
    from tests.test_torch_engine import assert_same_result
    from tests.test_torch_stream_engine import _pair
    from tests import torch_pc_batch as batch
    from tests import torch_support as ts

    pc = int(os.environ["COLORID_STREAM_PC"])
    assert tsq.PC == jsq.PC == pc and tsq.RES_CAP == jsq.RES_CAP == 256 * pc

    # the engines, the probe stream forced: the same SearchResult
    rng = np.random.default_rng(7)
    jindex, _t = _pair(rng, 21, 100_000, 4, 2)
    keys = rng.choice(ts.ACGT, size=(20_000, 31))
    qcounts = rng.integers(1, 2000, 20_000).astype(np.int32)
    jeng = JEngine(jindex)
    teng = convert.engine_from_jax_state(
        np.asarray(jeng.blocks2), jeng.wpad, jindex, device="cpu")
    assert jeng._stream and teng._stream
    res = teng.search_keys(keys, qcounts=qcounts)
    assert_same_result(res, jeng.search_keys(keys, qcounts=qcounts))
    assert len(res.over_freqs) > 0

    # one exact-mode stream batch with a residual capacity of 2 chunks
    tsq._nch = jsq._nch = lambda wpad: 2
    geo, blocks, pk, qc, acc = batch.inputs()
    jb = jnp.asarray(blocks)
    want = jsq.stream_accumulate_hash_exact(
        *(jnp.asarray(a) for a in acc), jb, jsq.byte_plane_blocks(jb),
        jnp.asarray(pk), jnp.asarray(qc), **geo)
    got = batch.port(geo, blocks, pk, qc, acc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[4]) > 0
    np.savez(sys.argv[1], *[g.numpy() for g in got])
""")


def test_stream_pc_set_matches_jax_in_both_packages(tmp_path, monkeypatch):
    out = tmp_path / "pc.npz"
    env = dict(os.environ, COLORID_STREAM_PC=str(PC_SET), JAX_PLATFORMS="cpu",
               COLORID_STREAM="force", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    r = subprocess.run([sys.executable, "-c", _SCRIPT, str(out)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    set_pc = [v for _k, v in sorted(np.load(out).items(), key=lambda kv: int(kv[0][4:]))]
    # the same batch here, at the default chunk size
    from tests import torch_pc_batch as batch

    assert tsq.PC == 2048 != PC_SET
    monkeypatch.setattr(tsq, "_nch", lambda wpad: 2)
    default = [g.numpy() for g in batch.port(*batch.inputs())]
    assert int(default[4]) != int(set_pc[4])  # n_drop follows the chunk size


@pytest.mark.parametrize("pc", [0, 1000, -32])
def test_probe_wrappers_refuse_a_chunk_the_kernels_cannot_take(monkeypatch, pc):
    monkeypatch.setattr(tsq, "PC", pc)
    b2 = torch.zeros((4, 128), dtype=torch.int32)
    z = torch.zeros(2048, dtype=torch.int32)
    with pytest.raises(ValueError, match="COLORID_STREAM_PC"):
        tsq.stream_probe(b2, z, z, z, torch.zeros(32, dtype=torch.int32),
                         torch.zeros((32, 1024), dtype=torch.int32),
                         num_hash=4, wpad=1, n_colors=21)
    with pytest.raises(ValueError, match="COLORID_STREAM_PC"):
        tsq.stream_probe_raw(b2, z, z, z, torch.zeros(32, dtype=torch.int32),
                             num_hash=4, wpad=1)
