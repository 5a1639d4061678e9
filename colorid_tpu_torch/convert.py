"""Carry index state between the JAX package and the port.

The index matrix plays the role that weights play in a model: both packages
hold the same uint32 [bloom_size, W] bit-slice matrix, on disk in the same
CXI and bincode formats, and on the device in the same [Rb, 128] block
layout. These helpers take the numpy form of either and build the port's
objects from it, without importing the JAX package.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .engine import QueryEngine
from .index.bigsi import BigsiIndex
from .ops.query import row_wpad


def index_from_arrays(
    matrix_u32: np.ndarray,
    *,
    bloom_size: int,
    num_hash: int,
    k_size: int,
    colors: list[str],
    n_ref_kmers: Mapping[str, int],
    m_size: int = 0,
    blocked: int = 0,
    place_rpb: int = 0,
) -> BigsiIndex:
    """The port's BigsiIndex over a uint32 [bloom_size, W] matrix, classic
    or (``blocked`` = the layout version, ``place_rpb`` as recorded)
    blocked."""
    matrix = np.asarray(matrix_u32)
    W = (len(colors) + 31) // 32
    if matrix.dtype != np.uint32 or matrix.shape != (bloom_size, W):
        raise ValueError(
            f"matrix must be uint32 [{bloom_size}, {W}]; got {matrix.dtype} "
            f"{list(matrix.shape)}"
        )
    return BigsiIndex(
        bloom_size=bloom_size,
        num_hash=num_hash,
        k_size=k_size,
        m_size=m_size,
        colors=list(colors),
        n_ref_kmers={c: int(n) for c, n in n_ref_kmers.items()},
        matrix=matrix,
        blocked=int(blocked),
        place_rpb=int(place_rpb),
    )


def engine_from_jax_state(
    blocks2_np: np.ndarray,
    wpad: int,
    index_meta,
    device: str | torch.device = "cuda",
) -> QueryEngine:
    """A port QueryEngine from the numpy form of a JAX engine's ``blocks2``
    (uint32 [Rb, 128], row width ``wpad``) and its index metadata (any
    object with the BigsiIndex fields bloom_size, num_hash, k_size, m_size,
    colors, n_ref_kmers and, for a blocked index, blocked and place_rpb).
    The matrix rows are read back out of the block layout, so the port's
    engine re-packs exactly the same blocks and hashes with the same
    placement."""
    blocks = np.asarray(blocks2_np)
    R = index_meta.bloom_size
    W = (len(index_meta.colors) + 31) // 32
    if wpad != row_wpad(W) or blocks.dtype != np.uint32 or blocks.ndim != 2 \
            or blocks.shape[1] != 128 or blocks.size < R * wpad:
        raise ValueError("blocks2 does not hold an index of this shape")
    matrix = blocks.reshape(-1)[: R * wpad].reshape(R, wpad)[:, :W]
    index = index_from_arrays(
        np.ascontiguousarray(matrix),
        bloom_size=R,
        num_hash=index_meta.num_hash,
        k_size=index_meta.k_size,
        colors=index_meta.colors,
        n_ref_kmers=index_meta.n_ref_kmers,
        m_size=index_meta.m_size,
        blocked=getattr(index_meta, "blocked", 0),
        place_rpb=getattr(index_meta, "place_rpb", 0),
    )
    return QueryEngine(index, device=device)


def shards_from_jax_state(mat_np: np.ndarray, wpad: int, mesh) -> list[torch.Tensor]:
    """The port's per-shard matrix tensors from the numpy form of a JAX
    ShardedQueryEngine's ``mat`` (uint32 [S, nb, 128], one packed block
    matrix of row width ``wpad`` per model shard, color or row layout):
    int32 bit views, shard s on the mesh's device for s, as
    parallel/sharded.py::device_put_colorshard / device_put_rowshard lay
    them out. Pass them to the ``parallel.sharded`` functions beside the
    JAX engine's ``wpad`` and ``Wl`` (color) or ``Rl`` (row)."""
    mat = np.asarray(mat_np)
    if mat.dtype != np.uint32 or mat.ndim != 3 or mat.shape[2] != 128 \
            or mat.shape[0] != mesh.n_model:
        raise ValueError(
            f"mat must be uint32 [{mesh.n_model}, nb, 128]; got {mat.dtype} "
            f"{list(mat.shape)}"
        )
    if wpad != row_wpad(wpad) or (mat.shape[1] * 128) % wpad:
        raise ValueError(f"{wpad} is not a packed row width of these blocks")
    return [
        torch.from_numpy(np.array(mat[s]).view(np.int32)).to(mesh.device(s))
        for s in range(mesh.n_model)
    ]
