"""One seeded blocked stream batch for tests/test_torch_stream_pc.py (made
in the test process and in its subprocess alike): a sparse 40-color v2
matrix whose probes leave many chunks with out-of-window probes."""

import numpy as np
import torch

from colorid_tpu_torch.ops import stream_query as tsq
from tests import torch_support as ts
from tests.test_torch_stream import _accumulators, _blocks


def inputs():
    rng = np.random.default_rng(44)
    C, n = 40, 16_384
    bloom, blocks, wpad = _blocks(rng, C, 3_000_000, 0.2)
    pk = ts.rand_packed(rng, n)
    qc = rng.integers(1, 2000, n).astype(np.int32)
    geo = dict(wpad=wpad, k=31, num_hash=4, bloom_size=bloom, rpb=128 // wpad,
               n_colors=C, bv=2)
    return geo, blocks, pk, qc, _accumulators(C, wpad, tsq.OVER_CAP + tsq.RES_CAP)


def port(geo, blocks, pk, qc, acc):
    return tsq.stream_accumulate_hash_exact(
        *(torch.from_numpy(a.copy()) for a in acc), ts.t32(blocks), ts.t32(pk),
        torch.from_numpy(qc), **geo,
    )
